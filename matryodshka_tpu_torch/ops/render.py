"""Blend-fused MSI render: the kernel wrapper, its plain version (lookup
tables, then the taps and the composite) and the uv instrument.

The kernel is `csrc/render.cu`, which replaces
`matryodshka_tpu/ops/pallas_render.py:_render_kernel_ftbb`, the per-shell
uv fields and the XLA pole caps beside it: it projects each pixel's ray
onto each shell it visits (`csrc/project.cuh`), so a render is one
launch; its source note gives the bound and the design. Inputs are the
sweep's net input vol [B, 2*P*3, H, W] (ref eye = fg, src eye = bg), the
net's tanh prediction pred [B, 2P, H, W] float32 (blend weights then
alphas), the target poses [B, 4, 4], positions [B, 3] and the shell radii
[P]; the output is the ERP view [B, H, W, 3] float32. depth=True is K3's
depth mode: the depth proxy from the alphas alone.
"""

from __future__ import annotations

import torch

from matryodshka_tpu_torch.geometry import grids
from matryodshka_tpu_torch.geometry.render import (over_composite,
                                                   over_composite_depth,
                                                   uv_tables)
from matryodshka_tpu_torch.ops import _build
from matryodshka_tpu_torch.ops.resample import resample_layers_uv

#: Early ray termination threshold on the transmittance (K3's FTB_EPS).
EPS = 1e-6

#: Launches of the render kernel in this process: colour and depth mode;
#: and of the uv instrument (uv_project).
launches = 0
depth_launches = 0
uv_launches = 0


def blend_layers(vol, pred):
    """blend_psv assembly at source pixels, channels first:
    -> RGBA layers [B, P, 4, H, W] float32."""
    b, c2, h, w = vol.shape
    p = c2 // 6
    v6 = vol.float().reshape(b, 2, p, 3, h, w)
    wgt = ((pred[:, :p].float() + 1.0) / 2.0)[:, :, None]
    alpha = (pred[:, p:2 * p].float() + 1.0) / 2.0
    rgb = wgt * v6[:, 0] + (1.0 - wgt) * v6[:, 1]
    return torch.cat([rgb, alpha[:, :, None]], dim=2)


def render_blend_plain(vol, pred, u, v, depth: bool = False):
    """Plain version of the kernel: blend at source pixels, gather-sample
    each shell, back-to-front closed-form over-composite (no early
    termination); over_composite_depth for depth."""
    layers = blend_layers(vol, pred)
    composite = over_composite_depth if depth else over_composite
    outs = []
    for i in range(vol.shape[0]):
        proj = resample_layers_uv(layers[i].permute(0, 2, 3, 1), u[i], v[i])
        outs.append(composite(proj.permute(1, 2, 0, 3)))
    return torch.stack(outs)


def render_blend(vol, pred, tgt_pose, tgt_pos, radii, depth: bool = False):
    """The render: CPU tensors take the plain route (uv_tables,
    render_blend_plain); CUDA tensors one launch of the kernel, which
    projects its own lookups; any other device raises. tgt_pose [B, 4, 4]
    (a batch stride of 0, one pose for the batch, is read as it is),
    tgt_pos [B, 3], radii [P]."""
    b, c2, h, w = vol.shape
    if vol.device.type == "cpu":
        u, v = uv_tables(tgt_pose, tgt_pos, radii, h, w)
        return render_blend_plain(vol, pred, u, v, depth)
    global launches, depth_launches
    p = c2 // 6
    dev = vol.device
    req = _build.require
    req(vol.is_cuda, f"render_blend: unsupported device {dev}")
    req(c2 == 6 * p and vol.dtype in (torch.float32, torch.bfloat16)
        and vol.is_contiguous(),
        f"render_blend: vol {vol.dtype} {tuple(vol.shape)}")
    req(pred.dtype == torch.float32 and pred.is_contiguous()
        and pred.device == dev and tuple(pred.shape) == (b, 2 * p, h, w),
        f"render_blend: pred {pred.dtype} {tuple(pred.shape)} (blend_psv: "
        f"exactly 2P channels)")
    req(radii.shape == (p,), f"render_blend: radii {tuple(radii.shape)} for "
                             f"{p} shells")
    geo = _build.geometry_args("render_blend", tgt_pose, tgt_pos, radii,
                               b, dev)
    lat, lon = grids.lat_long_vectors(h, w, dev)
    out = torch.empty((b, h, w, 3), dtype=torch.float32, device=dev)
    err = _build.lib().matry_render(
        vol.data_ptr(), pred.data_ptr(), *geo, lat.data_ptr(),
        lon.data_ptr(), out.data_ptr(), b, p, h, w,
        int(vol.dtype == torch.bfloat16), int(depth), EPS,
        _build.stream_ptr(dev))
    _build.check(err, "matry_render")
    if depth:
        depth_launches += 1
    else:
        launches += 1
    return out


def uv_project(tgt_pose, tgt_pos, radii, height: int, width: int):
    """The per-shell lookups the render kernels compute (this module's and
    ops/render_layers.py's, through the same csrc/project.cuh), as
    uv_tables' (u, v), each [B, P, H, W] float32: an instrument that lets
    the projection and each render be checked apart. CPU tensors: uv_tables;
    CUDA tensors: one launch of the kernel's own projection
    (csrc/render.cu:matry_uv_project)."""
    if radii.device.type == "cpu":
        return uv_tables(tgt_pose, tgt_pos, radii, height, width)
    global uv_launches
    dev = radii.device
    _build.require(radii.is_cuda, f"uv_project: unsupported device {dev}")
    b, p = tgt_pose.shape[0], radii.shape[0]
    geo = _build.geometry_args("uv_project", tgt_pose, tgt_pos, radii, b,
                               dev)
    lat, lon = grids.lat_long_vectors(height, width, dev)
    u = torch.empty((b, p, height, width), dtype=torch.float32, device=dev)
    v = torch.empty_like(u)
    err = _build.lib().matry_uv_project(
        *geo, lat.data_ptr(), lon.data_ptr(), u.data_ptr(), v.data_ptr(), b,
        p, height, width, _build.stream_ptr(dev))
    _build.check(err, "matry_uv_project")
    uv_launches += 1
    return u, v
