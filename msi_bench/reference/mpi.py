"""Stereo Magnification's multiplane image (Zhou, Tucker, Flynn, Fyffe and
Snavely, SIGGRAPH 2018) in the form MatryODShka trains it on RealEstate10K
(brownvc/matryodshka `--input_type REALESTATE_PP --coord_net true`): one
view of one example, plain PyTorch, float32.

1. The net input [3 + 6P, H, W]: the ref image, then the plane sweeps of
   the ref and the src image at the psv depths, each at pose @ inv(ref_pose)
   (`msi.py:1024-1059`); images in [-1, 1].
2. The coord U-Net (`unet.forward`, variant "coord") -> [2P, H, W] tanh.
3. blend_psv's layers: plane p's colour w fg + (1 - w) bg, w = (pred[p] +
   1) / 2, alpha (pred[P + p] + 1) / 2.
4. Each layer warped into the target camera at tgt_pose @ inv(ref_pose) by
   its plane's homography, plane p at msi depth p (far to near), and
   composited back to front with the over operator, the farthest layer's
   alpha taken as 1.

Departures from Zhou et al., each the MatryODShka port's:
- fg is the net input's channels [0, 3P) and bg [3P, 6P) (`msi.py:97, 103`):
  the ref image and the ref sweep's first P-1 planes, then the ref sweep's
  last plane and the src sweep's first P-1, not the two sweeps' own planes;
- pixel centres at integer coordinates, the half-pixel offset that
  `projector.py:336-342` documents as a known bug, kept for parity
  (`homography.py`);
- the program computes in bfloat16 where the upstream runs float32; this
  reference runs float32, and `q`, where given, rounds what the program
  stores in its compute dtype (the net input, the net's own stores as in
  `unet.forward`, and the layers) for the control.
"""

from __future__ import annotations

import torch

from msi_bench.reference import exact, unet
from msi_bench.reference.homography import plane_sweep, warp_layer


def net_input(ref, src, ref_pose, src_pose, k, psv_depths):
    """ref, src [H, W, 3] in [0, 1] -> [3 + 6P, H, W] in [-1, 1]."""
    ref_inv = torch.linalg.inv(ref_pose)
    ref, src = ref.float() * 2.0 - 1.0, src.float() * 2.0 - 1.0
    return torch.cat([ref.permute(2, 0, 1),
                      plane_sweep(ref, psv_depths, ref_pose @ ref_inv, k),
                      plane_sweep(src, psv_depths, src_pose @ ref_inv, k)])


def layers(vol, pred):
    """vol [3 + 6P, H, W], pred [2P, H, W] -> RGBA layers [P, H, W, 4]."""
    p = pred.shape[0] // 2
    h, w = vol.shape[1:]
    fg = vol[:3 * p].float().reshape(p, 3, h, w)
    bg = vol[3 * p:6 * p].float().reshape(p, 3, h, w)
    wgt = ((pred[:p].float() + 1.0) / 2.0)[:, None]
    alpha = ((pred[p:2 * p].float() + 1.0) / 2.0)[:, None]
    return torch.cat([wgt * fg + (1.0 - wgt) * bg, alpha], 1).permute(
        0, 2, 3, 1)


def render(rgba, pose, k, msi_depths):
    """RGBA layers [P, H, W, 4] (layer p at msi_depths[p], far to near)
    seen at pose [4, 4] from the layers' camera -> [H, W, 3]."""
    out = None
    for p in range(rgba.shape[0]):
        lay = warp_layer(rgba[p], k, pose, float(msi_depths[p]))
        if out is None:
            out = lay[..., :3]
        else:
            a = lay[..., 3:]
            out = lay[..., :3] * a + out * (1.0 - a)
    return out


def mpi_view(tree, ngf: int, ref, src, ref_pose, src_pose, tgt_pose,
             intrinsics, psv_depths, msi_depths, q=None):
    """One view [H, W, 3] in [-1, 1]: ref, src [H, W, 3] in [0, 1]; the
    poses [4, 4] (world to camera); intrinsics [3, 3] in pixels; the
    flax-layout weight tree of the coord net (195 inputs at P = 32)."""
    q = q or (lambda t: t)
    with exact():
        vol = q(net_input(ref, src, ref_pose, src_pose, intrinsics,
                          psv_depths))
        pred = unet.forward(tree, vol[None], "coord", ngf, q)[0]
        return render(q(layers(vol, pred)),
                      tgt_pose @ torch.linalg.inv(ref_pose), intrinsics,
                      msi_depths)
