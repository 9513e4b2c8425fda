"""MSI render from a prepared layer stack: kernel wrapper and its plain
version.

The kernel is `csrc/render_layers.cu`, which replaces three kernels of
`matryodshka_tpu/ops/pallas_render.py`: `_render_kernel_tiled` (K4) and
`_render_kernel` (K5, also the high-res row chunks) as its back-to-front
mode, `_render_kernel_ftb` (K6) as its front-to-back mode; its source note
gives the bound and the design. Inputs are the layer stack
[B, P, 4, H, W] (`models/msi.py:assemble_rgba_prepared` /
`assemble_hres_prepared`) and per-shell lookup tables u, v [B, P, H, W];
the output is the ERP view [B, H, W, 3] float32.
"""

from __future__ import annotations

import torch

from matryodshka_tpu_torch.ops import _build
from matryodshka_tpu_torch.ops.resample import resample_layers_uv

#: Early ray termination threshold on the transmittance (K6's FTB_EPS).
EPS = 1e-6

#: Launches of the kernel in this process: back to front (K4/K5) and
#: front to back (K6).
launches = 0
ftb_launches = 0


def render_layers_plain(layers, u, v, depth: bool = False):
    """Plain version of the kernel: sample one shell at a time and
    composite it in, nearest shell first (out += rgb*a*T, T *= 1 - a,
    shell 0's alpha taken as 1; no early termination), as the JAX
    package's shell-streamed high-res render does
    (geometry/render.py:gather_hres), so memory stays at one shell at any
    resolution. depth: rgb is p/P. Same result as over_composite
    (over_composite_depth) of all sampled shells."""
    b, p, _, h, w = layers.shape
    outs = []
    for i in range(b):
        out = torch.zeros((h, w, 3), dtype=torch.float32,
                          device=layers.device)
        trans = torch.ones((h, w, 1), dtype=torch.float32,
                           device=layers.device)
        for s in range(p - 1, -1, -1):
            shell = layers[i, s, 3:] if depth else layers[i, s]
            img = resample_layers_uv(shell.permute(1, 2, 0)[None],
                                     u[i, s][None], v[i, s][None])[0]
            rgb = s / p if depth else img[..., :3]
            a = img[..., -1:] if s > 0 else 1.0
            out = out + rgb * a * trans
            trans = trans * (1.0 - a)
        outs.append(out)
    return torch.stack(outs)


def render_layers(layers, u, v, ftb: bool = False, depth: bool = False):
    """The render: the CUDA kernel for CUDA tensors, the plain version for
    CPU tensors. ftb selects the front-to-back early-termination mode
    (K6); depth renders the depth proxy."""
    if layers.device.type == "cpu":
        return render_layers_plain(layers, u, v, depth)
    global launches, ftb_launches
    b, p, c, h, w = layers.shape
    req = _build.require
    req(layers.is_cuda, f"render_layers: unsupported device {layers.device}")
    req(c == 4 and layers.dtype in (torch.float32, torch.bfloat16)
        and layers.is_contiguous(),
        f"render_layers: layers {layers.dtype} {tuple(layers.shape)}")
    for name, t in (("u", u), ("v", v)):
        req(t.dtype == torch.float32 and t.is_contiguous()
            and t.device == layers.device and tuple(t.shape) == (b, p, h, w),
            f"render_layers: {name} {t.dtype} {tuple(t.shape)}")
    out = torch.empty((b, h, w, 3), dtype=torch.float32,
                      device=layers.device)
    err = _build.lib().matry_render_layers(
        layers.data_ptr(), u.data_ptr(), v.data_ptr(), out.data_ptr(), b, p,
        h, w, int(layers.dtype == torch.bfloat16), int(ftb), int(depth), EPS,
        _build.stream_ptr(layers.device))
    _build.check(err, "matry_render_layers")
    if ftb:
        ftb_launches += 1
    else:
        launches += 1
    return out
