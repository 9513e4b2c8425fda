"""Blend-fused MPI render: the kernel wrapper and its plain version.

The kernel is `csrc/mpi_render.cu`, which replaces no TPU kernel (the JAX
package renders an MPI with XLA gathers, geometry/homography.py): it
computes assemble_rgba("blend_psv") followed by mpi_render_view in one
launch, each plane warped by its homography, blended at the taps and
composited in registers, with no layer stack; its source note gives the
bound and the design. Inputs are the sweep's net input vol [B, C, H, W]
(C >= 6P: fg the channels [0, 3P), bg [3P, 6P), so the 195-channel
REALESTATE_PP volume is read as it is), the net's tanh prediction pred
[B, 2P, H, W] float32 (blend weights then alphas), the target pose
relative to the layers' frame [B, 4, 4] (msi.mpi_view_pose), the
intrinsics [B, 3, 3] and the plane depths [P]; the output is the view
[B, H, W, 3] float32.
"""

from __future__ import annotations

import torch

from matryodshka_tpu_torch.geometry import homography
from matryodshka_tpu_torch.ops import _build
from matryodshka_tpu_torch.ops.render import blend_layers

#: Launches of the kernel in this process.
launches = 0


def render_mpi_blend_plain(vol, pred, tgt_pose, intrinsics, depths):
    """Plain version of the kernel: blend at source pixels in float32
    (render.blend_layers on the volume's first 6P channels), then
    homography.mpi_render_view (a warp a plane, the over-composite)."""
    p = depths.shape[0]
    layers = blend_layers(vol[:, :6 * p], pred[:, :2 * p])
    return homography.mpi_render_view(layers.permute(0, 3, 4, 1, 2),
                                      tgt_pose, depths, intrinsics)


def render_mpi_blend(vol, pred, tgt_pose, intrinsics, depths):
    """The render: CPU tensors take the plain route; CUDA tensors one launch
    of the kernel, which computes the planes' homographies itself, in the
    steps of homography.mpi_homographies, from K^-1 taken on the card by
    torch.linalg.inv_ex (which reads nothing back to the host, as
    torch.linalg.inv's error check does); any other device raises.
    tgt_pose [B, 4, 4] (row-major at any batch stride), intrinsics
    [B, 3, 3] contiguous."""
    if vol.device.type == "cpu":
        return render_mpi_blend_plain(vol, pred, tgt_pose, intrinsics,
                                      depths)
    global launches
    b, c, h, w = vol.shape
    p = depths.shape[0]
    dev = vol.device
    req = _build.require
    req(vol.is_cuda, lambda: f"render_mpi_blend: unsupported device {dev}")
    req(c >= 6 * p and vol.dtype in (torch.float32, torch.bfloat16)
        and vol.is_contiguous(),
        lambda: f"render_mpi_blend: vol {vol.dtype} {tuple(vol.shape)} for "
                f"{p} planes")
    req(pred.dtype == torch.float32 and pred.is_contiguous()
        and pred.device == dev and tuple(pred.shape) == (b, 2 * p, h, w),
        lambda: f"render_mpi_blend: pred {pred.dtype} {tuple(pred.shape)} "
                f"(blend_psv: exactly 2P channels)")
    req(tgt_pose.device == dev and tgt_pose.dtype == torch.float32
        and tuple(tgt_pose.shape) == (b, 4, 4)
        and tgt_pose.stride()[1:] == (4, 1),
        lambda: f"render_mpi_blend: tgt_pose {tgt_pose.dtype} "
                f"{tuple(tgt_pose.shape)} strides {tgt_pose.stride()}")
    req(intrinsics.device == dev and intrinsics.dtype == torch.float32
        and tuple(intrinsics.shape) == (b, 3, 3)
        and intrinsics.is_contiguous(),
        lambda: f"render_mpi_blend: intrinsics {intrinsics.dtype} "
                f"{tuple(intrinsics.shape)}")
    req(depths.device == dev and depths.dtype == torch.float32
        and depths.dim() == 1 and depths.is_contiguous(),
        lambda: f"render_mpi_blend: depths {depths.dtype} "
                f"{tuple(depths.shape)}")
    # inv_ex returns column-major matrices; the kernel reads row-major
    k_inv = torch.linalg.inv_ex(intrinsics).inverse.contiguous()
    out = torch.empty((b, h, w, 3), dtype=torch.float32, device=dev)
    _build.launch("matry_mpi_render", vol.data_ptr(), pred.data_ptr(),
                  tgt_pose.data_ptr(), tgt_pose.stride(0),
                  intrinsics.data_ptr(), k_inv.data_ptr(), depths.data_ptr(),
                  out.data_ptr(), b, c, p, h, w,
                  int(vol.dtype == torch.bfloat16), _build.stream_ptr(dev))
    launches += 1
    return out
