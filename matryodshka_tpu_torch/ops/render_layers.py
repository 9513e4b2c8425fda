"""MSI render from a prepared layer stack: kernel wrapper and its plain
version.

The kernel is `csrc/render_layers.cu`, which replaces three kernels of
`matryodshka_tpu/ops/pallas_render.py`: `_render_kernel_tiled` (K4) and
`_render_kernel` (K5, also the high-res row chunks) as its back-to-front
mode, `_render_kernel_ftb` (K6) as its front-to-back mode. It projects each
pixel's ray onto each shell it visits (`csrc/project.cuh`, the bits of the
uv instrument `ops/render.py:uv_project`), so a render is one launch and
builds no lookup tables; one launch writes the image, the depth proxy or
both. Its partial mode (`render_layers_partial`) renders one block of a
shell-sharded stack and also writes the block's transmittance
(parallel/sharded_render.py). Its source note gives the bound and the
design. Inputs are the layer stack [B, P, H, W, 4], interleaved with the
channels r, g, b, alpha innermost, so that a tap is one vector load
(`models/msi.py:assemble_rgba_prepared` / `assemble_hres_prepared`, or
on the high-res path `ops/sweep.py:sweep_assembled`), the target poses
[B, 4, 4], positions [B, 3] and the shell radii [P]; each output is an ERP
view [B, H, W, 3] float32.
"""

from __future__ import annotations

import torch

from matryodshka_tpu_torch.geometry import grids
from matryodshka_tpu_torch.geometry.render import partial_composite, \
    uv_tables
from matryodshka_tpu_torch.ops import _build
from matryodshka_tpu_torch.ops.resample import resample_layers_uv

#: Early ray termination threshold on the transmittance (K6's FTB_EPS).
EPS = 1e-6

#: Launches of the kernel in this process: back to front (K4/K5) and
#: front to back (K6), whatever the outputs; and of those, the launches
#: that wrote image and depth together (render_layers_both); and of the
#: partial mode (render_layers_partial), counted apart from these.
launches = 0
ftb_launches = 0
both_launches = 0
partial_launches = 0


def render_layers_plain(layers, u, v, depth: bool = False):
    """Plain version of the kernel, fed per-shell lookup tables u, v
    [B, P, H, W] (uv_tables, or the kernel's own from uv_project): sample
    one shell at a time and composite it in, nearest shell first
    (out += rgb*a*T, T *= 1 - a, shell 0's alpha taken as 1; no early
    termination), as the JAX package's shell-streamed high-res render does
    (geometry/render.py:gather_hres), so memory stays at one shell at any
    resolution. depth: rgb is p/P. Same result as over_composite
    (over_composite_depth) of all sampled shells."""
    b, p, h, w, _ = layers.shape
    outs = []
    for i in range(b):
        out = torch.zeros((h, w, 3), dtype=torch.float32,
                          device=layers.device)
        trans = torch.ones((h, w, 1), dtype=torch.float32,
                           device=layers.device)
        for s in range(p - 1, -1, -1):
            shell = layers[i, s, ..., 3:] if depth else layers[i, s]
            img = resample_layers_uv(shell[None], u[i, s][None],
                                     v[i, s][None])[0]
            rgb = s / p if depth else img[..., :3]
            a = img[..., -1:] if s > 0 else 1.0
            out = out + rgb * a * trans
            trans = trans * (1.0 - a)
        outs.append(out)
    return torch.stack(outs)


def render_layers(layers, tgt_pose, tgt_pos, radii, ftb: bool = False,
                  depth: bool = False):
    """The render: CPU tensors take the plain route (uv_tables,
    render_layers_plain); CUDA tensors one launch of the kernel; any other
    device raises. tgt_pose [B, 4, 4] (a batch stride of 0, one pose for
    the batch, is read as it is), tgt_pos [B, 3], radii [P]. ftb selects
    the front-to-back early-termination mode (K6); depth renders the depth
    proxy in place of the image."""
    if layers.device.type == "cpu":
        u, v = uv_tables(tgt_pose, tgt_pos, radii, *layers.shape[2:4])
        return render_layers_plain(layers, u, v, depth)
    rgb, dep = _launch(layers, tgt_pose, tgt_pos, radii, ftb, not depth,
                       depth)
    return dep if depth else rgb


def render_layers_both(layers, tgt_pose, tgt_pos, radii, ftb: bool = False):
    """(image, depth proxy), each [B, H, W, 3] float32: what render_layers
    gives with depth=False and with depth=True. CPU tensors: one uv_tables
    build and render_layers_plain twice; CUDA tensors: one launch that
    composites both in one pass over the shells."""
    if layers.device.type == "cpu":
        u, v = uv_tables(tgt_pose, tgt_pos, radii, *layers.shape[2:4])
        return (render_layers_plain(layers, u, v),
                render_layers_plain(layers, u, v, depth=True))
    return _launch(layers, tgt_pose, tgt_pos, radii, ftb, True, True)


def render_layers_partial_plain(layers, u, v, p0: int, p_total: int):
    """Plain version of the partial mode, fed the block's lookup tables u,
    v [B, P, H, W]: gather every shell of the block and composite it with
    geometry/render.partial_composite, global shell 0's alpha taken as 1,
    colour and depth (p0 + p) / p_total -> (rgb, depth, trans): [B, H, W,
    3], [B, H, W, 3], [B, H, W, 1] float32."""
    b, p, h, w, _ = layers.shape
    proj = torch.stack([resample_layers_uv(layers[i], u[i], v[i])
                        for i in range(b)])
    proj = proj.permute(0, 2, 3, 1, 4)                       # [B, H, W, P, 4]
    alpha = proj[..., 3:]
    if p0 == 0:
        alpha = torch.cat([torch.ones_like(alpha[..., :1, :]),
                           alpha[..., 1:, :]], dim=-2)
    rgb, trans = partial_composite(torch.cat([proj[..., :3], alpha], -1))
    vals = ((p0 + torch.arange(p, device=layers.device)) / p_total).to(
        alpha.dtype)[:, None].expand(p, 3)
    depth, _ = partial_composite(torch.cat(
        [vals.expand(*alpha.shape[:-1], 3), alpha], -1))
    return rgb, depth, trans


def render_layers_partial(layers, tgt_pose, tgt_pos, radii, p0: int,
                          p_total: int):
    """The partial mode: layers [B, P, H, W, 4] are global shells p0 ..
    p0+P-1 of p_total, radii [P] theirs -> (rgb, depth, trans) as
    render_layers_partial_plain returns them. CPU tensors take the plain
    route (uv_tables, render_layers_partial_plain); CUDA tensors one launch
    of the kernel's partial mode; any other device raises."""
    global partial_launches
    b, p, h, w, _ = layers.shape
    if layers.device.type == "cpu":
        u, v = uv_tables(tgt_pose, tgt_pos, radii, h, w)
        return render_layers_partial_plain(layers, u, v, p0, p_total)
    dev = layers.device
    _check_stack("render_layers_partial", layers)
    req = _build.require
    req(radii.shape == (p,) and 0 <= p0 and p0 + p <= p_total,
        f"render_layers_partial: radii {tuple(radii.shape)}, shells "
        f"{p0}..{p0 + p - 1} of {p_total}")
    geo = _build.geometry_args("render_layers_partial", tgt_pose, tgt_pos,
                               radii, b, dev)
    lat, lon = grids.lat_long_vectors(h, w, dev)
    rgb, dep = (torch.empty((b, h, w, 3), dtype=torch.float32, device=dev)
                for _ in range(2))
    trans = torch.empty((b, h, w, 1), dtype=torch.float32, device=dev)
    err = _build.lib().matry_render_layers_partial(
        layers.data_ptr(), *geo, lat.data_ptr(), lon.data_ptr(),
        rgb.data_ptr(), dep.data_ptr(), trans.data_ptr(), b, p, h, w, p0,
        p_total, int(layers.dtype == torch.bfloat16), _build.stream_ptr(dev))
    _build.check(err, "matry_render_layers_partial")
    partial_launches += 1
    return rgb, dep, trans


def _launch(layers, tgt_pose, tgt_pos, radii, ftb, want_rgb, want_depth):
    """One launch of the kernel -> (rgb or None, depth or None)."""
    global launches, ftb_launches, both_launches
    b, p, h, w, _ = layers.shape
    dev = layers.device
    _check_stack("render_layers", layers)
    req = _build.require
    req(radii.shape == (p,), f"render_layers: radii {tuple(radii.shape)} "
                             f"for {p} shells")
    geo = _build.geometry_args("render_layers", tgt_pose, tgt_pos, radii, b,
                               dev)
    lat, lon = grids.lat_long_vectors(h, w, dev)
    rgb, dep = (torch.empty((b, h, w, 3), dtype=torch.float32, device=dev)
                if want else None for want in (want_rgb, want_depth))
    err = _build.lib().matry_render_layers(
        layers.data_ptr(), *geo, lat.data_ptr(), lon.data_ptr(),
        None if rgb is None else rgb.data_ptr(),
        None if dep is None else dep.data_ptr(), b, p, h, w,
        int(layers.dtype == torch.bfloat16), int(ftb), EPS,
        _build.stream_ptr(dev))
    _build.check(err, "matry_render_layers")
    if ftb:
        ftb_launches += 1
    else:
        launches += 1
    if want_rgb and want_depth:
        both_launches += 1
    return rgb, dep


def _check_stack(what, layers):
    """The kernel reads a contiguous [B, P, H, W, 4] stack on the card in
    f32 or bf16, each texel one aligned vector load."""
    req = _build.require
    req(layers.is_cuda, f"{what}: unsupported device {layers.device}")
    req(layers.dim() == 5 and layers.shape[-1] == 4
        and layers.dtype in (torch.float32, torch.bfloat16)
        and layers.is_contiguous() and layers.data_ptr() % 16 == 0,
        f"{what}: layers {layers.dtype} {tuple(layers.shape)} (a "
        f"contiguous, 16-byte aligned [B, P, H, W, 4] f32 or bf16 stack)")
