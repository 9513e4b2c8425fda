"""MSI novel-view rendering: over-compositing, the gather renders and the
entries of the two kernel renders.

Counterpart of `matryodshka_tpu/geometry/render.py` (`over_composite`,
`over_composite_depth`, `render_equirect_view`, `render_equirect_depth`,
`render_ods_view`, `render_perspective_view`,
`render_equirect_view_prepared`, `render_equirect_view_fused_blend`), and
`uv_tables`, the per-shell lookup tables of the plain routes.
Layer 0 is the farthest shell and its alpha is taken as 1.
"""

from __future__ import annotations

import torch

import math

from matryodshka_tpu_torch import trace
from matryodshka_tpu_torch.geometry import cameras, intersect
from matryodshka_tpu_torch.ops.resample import resample_layers


def _transmittance(alpha):
    """T_i = prod_{j > i} (1 - a_j) along axis -2 (T_{P-1} = 1)."""
    rcp = torch.flip(torch.cumprod(torch.flip(1.0 - alpha, [-2]), dim=-2),
                     [-2])
    return torch.cat([rcp[..., 1:, :], torch.ones_like(rcp[..., :1, :])],
                     dim=-2)


def over_composite(rgba):
    """Back-to-front over-composite of [..., P, 4] layers -> [..., 3]:
    sum_i rgb_i a_i T_i with T_i = prod_{j>i} (1 - a_j) and a_0 = 1."""
    rgb = rgba[..., :3]
    alpha = rgba[..., 3:]
    eff_alpha = torch.cat([torch.ones_like(alpha[..., :1, :]),
                           alpha[..., 1:, :]], dim=-2)
    return torch.sum(rgb * eff_alpha * _transmittance(alpha), dim=-2)


def partial_composite(rgba):
    """One block of shells' partial over-composite
    (parallel/sharded_render.py): rgba [..., P_local, 4] back to front ->
    (C [..., 3], every local alpha applied; T [..., 1] = prod(1 - a))."""
    rgb = rgba[..., :3]
    alpha = rgba[..., 3:]
    c = torch.sum(rgb * alpha * _transmittance(alpha), dim=-2)
    return c, torch.prod(1.0 - alpha, dim=-2)


def over_composite_depth(rgba):
    """Depth-proxy composite of [..., P, 4] layers -> [..., 3]: layer i
    carries the value i/P, layer 0 contributes 0 (projector.py:225-244);
    only the alphas are read. The value is broadcast to 3 channels."""
    p = rgba.shape[-2]
    alpha = rgba[..., 3:]
    vals = (torch.arange(p, dtype=alpha.dtype, device=alpha.device)
            / p)[:, None]
    out = torch.sum((vals * alpha * _transmittance(alpha))[..., 1:, :],
                    dim=-2)
    return out.expand(*out.shape[:-1], 3)


def render_equirect_view(rgba_layers, tgt_pose, tgt_pos, radii):
    """Gather render of one view: rgba_layers [H, W, P, 4], tgt_pose
    [4, 4], tgt_pos [3], radii [P] -> [H, W, 3] float32."""
    h, w = rgba_layers.shape[0], rgba_layers.shape[1]
    uv = intersect.intersect_sphere(tgt_pose, tgt_pos, radii, w, h)
    proj = resample_layers(rgba_layers.permute(2, 0, 1, 3), uv)
    return over_composite(proj.permute(1, 2, 0, 3))


def render_equirect_depth(rgba_layers, tgt_pose, tgt_pos, radii):
    """Gather depth-proxy render of one view (msi.py:384-405):
    [H, W, P, 4] -> [H, W, 3] float32."""
    h, w = rgba_layers.shape[0], rgba_layers.shape[1]
    uv = intersect.intersect_sphere(tgt_pose, tgt_pos, radii, w, h)
    proj = resample_layers(rgba_layers.permute(2, 0, 1, 3), uv)
    return over_composite_depth(proj.permute(1, 2, 0, 3))


def render_at(rgba_layers, uv):
    """Gather each shell of [H, W, P, 4] at its field uv [P, h, w, 2] and
    composite back to front -> [h, w, 3] float32."""
    proj = resample_layers(rgba_layers.permute(2, 0, 1, 3), uv)
    return over_composite(proj.permute(1, 2, 0, 3))


def render_ods_view(rgba_layers, order: int, pose, tgt_pos, radii,
                    intrinsics):
    """Re-render an ODS eye from the MSI (JAX render.py:411,
    msi.py:502-525): rgba_layers [H, W, P, 4], order +1 (left) / -1
    (right), pose [4, 4] (the jitter pose; identity when not jittering),
    radii [P], intrinsics [3, 3] -> [H, W, 3] float32; tgt_pos is not read
    (intersect_ods). No TPU kernel exists for it: the gather, as in the
    JAX package."""
    h, w = rgba_layers.shape[0], rgba_layers.shape[1]
    return render_at(rgba_layers, intersect.intersect_ods(
        pose, tgt_pos, order, intrinsics, radii, w, h))


def perspective_window_pose(viewing_window: int, device=None):
    """The perspective crop's pose: a yaw of viewing_window * 90 degrees
    (projector.py:79-85), float32 [4, 4]."""
    pose = torch.eye(4, device=device)
    pose[:3, :3] = cameras.rotation_from_euler(torch.tensor(
        [0.0, viewing_window * math.pi / 2.0, 0.0], device=device))
    return pose


def render_perspective_view(rgba_layers, tgt_pos, radii,
                            viewing_window: int = 3, psp_height: int = 320,
                            psp_width: int = 640):
    """Perspective crop render (JAX render.py:424, msi.py:475-500):
    rgba_layers [H, W, P, 4], tgt_pos [3] -> [psp_height, psp_width, 3]
    float32, the window yawed by viewing_window * 90 degrees (window 3 is
    the central view). The gather, as in the JAX package."""
    h, w = rgba_layers.shape[0], rgba_layers.shape[1]
    pose = perspective_window_pose(viewing_window, rgba_layers.device)
    return render_at(rgba_layers, intersect.intersect_perspective(
        pose, tgt_pos, radii, w, h, psp_width, psp_height))


#: Elements of one [shells, H, W] slab of the uv computation: the tables
#: are built this many at a time, so each float32 temporary of
#: intersect_sphere_uv holds at most 64 MiB (2 shells at 4096x2048, where
#: all 32 at once would make each 1 GiB); 640x320x32 is one slab.
UV_SLAB = 1 << 24

#: uv_tables builds in this process: the plain routes build them, the
#: card's kernel routes do not (each kernel projects its own lookups).
uv_builds = 0


def uv_tables(tgt_pose, tgt_pos, radii, height: int, width: int):
    """Per-shell lookup tables of a batch of target views: tgt_pose
    [B, 4, 4], tgt_pos [B, 3] -> (u, v), each [B, P, H, W] float32."""
    global uv_builds
    uv_builds += 1
    b, p = tgt_pose.shape[0], radii.shape[0]
    u = torch.empty((b, p, height, width), dtype=torch.float32,
                    device=radii.device)
    v = torch.empty_like(u)
    step = max(1, UV_SLAB // (height * width))
    for i in range(b):
        for p0 in range(0, p, step):
            ui, vi = intersect.intersect_sphere_uv(
                tgt_pose[i], tgt_pos[i], radii[p0:p0 + step], width, height)
            u[i, p0:p0 + step] = ui
            v[i, p0:p0 + step] = vi
    return u, v


# The kernel entries below import their ops modules when called: those
# modules take uv_tables (and ops.render over_composite) from this one.

def render_equirect_view_prepared(layers, tgt_pose, tgt_pos, radii,
                                  ftb: bool = False, depth: bool = False):
    """The layer-stack render of a batch: layers [B, P, H, W, 4] (the
    prepared assembly's stack, models/msi.py), tgt_pose [B, 4, 4], tgt_pos
    [B, 3] -> [B, H, W, 3] float32, any pose. ftb composites front to back
    with early termination; depth renders the depth proxy. On the card one
    kernel launch, which makes its own lookups (no uv_tables)."""
    from matryodshka_tpu_torch.ops import render_layers as rl_ops
    return rl_ops.render_layers(layers, tgt_pose, tgt_pos, radii, ftb=ftb,
                                depth=depth)


def render_equirect_view_prepared_both(layers, tgt_pose, tgt_pos, radii,
                                       ftb: bool = False):
    """render_equirect_view_prepared's image and depth proxy together ->
    (rgb, depth), each [B, H, W, 3] float32: on the card one kernel launch
    that writes both; on the CPU one uv_tables build and the plain version
    twice."""
    from matryodshka_tpu_torch.ops import render_layers as rl_ops
    with trace.span("render.render_equirect_view_prepared_both"):
        return rl_ops.render_layers_both(layers, tgt_pose, tgt_pos, radii,
                                         ftb=ftb)


def render_equirect_view_fused_blend(vol, pred, tgt_pose, tgt_pos, radii,
                                     depth: bool = False):
    """The blend-fused render of a batch, straight from the sweep volume
    vol [B, 2*P*3, H, W] and the net prediction pred [B, 2P, H, W]:
    tgt_pose [B, 4, 4], tgt_pos [B, 3] -> [B, H, W, 3] float32. Any pose;
    depth renders the depth proxy from the alphas. On the card one kernel
    launch, which makes its own lookups (no uv_tables)."""
    from matryodshka_tpu_torch.ops import render as render_ops
    return render_ops.render_blend(vol, pred.contiguous(), tgt_pose, tgt_pos,
                                   radii, depth=depth)
