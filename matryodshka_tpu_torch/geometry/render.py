"""MSI novel-view rendering: over-compositing, the gather render and the
entry of the blend-fused render.

Counterpart of `matryodshka_tpu/geometry/render.py` (`over_composite`,
`render_equirect_view`, `render_equirect_view_fused_blend`). Layer 0 is the
farthest shell and its alpha is taken as 1.
"""

from __future__ import annotations

import torch

from matryodshka_tpu_torch.geometry import intersect
from matryodshka_tpu_torch.ops.resample import resample_layers


def over_composite(rgba):
    """Back-to-front over-composite of [..., P, 4] layers -> [..., 3]:
    sum_i rgb_i a_i T_i with T_i = prod_{j>i} (1 - a_j) and a_0 = 1."""
    rgb = rgba[..., :3]
    alpha = rgba[..., 3:]
    rcp = torch.flip(torch.cumprod(torch.flip(1.0 - alpha, [-2]), dim=-2),
                     [-2])
    trans = torch.cat([rcp[..., 1:, :], torch.ones_like(rcp[..., :1, :])],
                      dim=-2)
    eff_alpha = torch.cat([torch.ones_like(alpha[..., :1, :]),
                           alpha[..., 1:, :]], dim=-2)
    return torch.sum(rgb * eff_alpha * trans, dim=-2)


def render_equirect_view(rgba_layers, tgt_pose, tgt_pos, radii):
    """Gather render of one view: rgba_layers [H, W, P, 4], tgt_pose
    [4, 4], tgt_pos [3], radii [P] -> [H, W, 3] float32."""
    h, w = rgba_layers.shape[0], rgba_layers.shape[1]
    uv = intersect.intersect_sphere(tgt_pose, tgt_pos, radii, w, h)
    proj = resample_layers(rgba_layers.permute(2, 0, 1, 3), uv)
    return over_composite(proj.permute(1, 2, 0, 3))


def uv_tables(tgt_pose, tgt_pos, radii, height: int, width: int):
    """Per-shell lookup tables of a batch of target views: tgt_pose
    [B, 4, 4], tgt_pos [B, 3] -> (u, v), each [B, P, H, W] float32."""
    uvs = [intersect.intersect_sphere_uv(tgt_pose[i], tgt_pos[i], radii,
                                         width, height)
           for i in range(tgt_pose.shape[0])]
    return (torch.stack([t[0] for t in uvs]).float().contiguous(),
            torch.stack([t[1] for t in uvs]).float().contiguous())


def render_equirect_view_fused_blend(vol, pred, tgt_pose, tgt_pos, radii):
    """The blend-fused render of a batch, straight from the sweep volume
    vol [B, 2*P*3, H, W] and the net prediction pred [B, 2P, H, W]:
    tgt_pose [B, 4, 4], tgt_pos [B, 3] -> [B, H, W, 3] float32. Any pose."""
    # Imported here: ops.render takes over_composite from this module.
    from matryodshka_tpu_torch.ops import render as render_ops
    u, v = uv_tables(tgt_pose, tgt_pos, radii, vol.shape[2], vol.shape[3])
    return render_ops.render_blend(vol, pred.contiguous(), u, v)
