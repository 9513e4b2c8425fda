"""Blend-fused MSI render: kernel wrapper and its plain version.

The kernel is `csrc/render.cu`, which replaces
`matryodshka_tpu/ops/pallas_render.py:_render_kernel_ftbb` and the XLA
pole caps beside it; its source note gives the bound and the design.
Inputs are the sweep's net input vol [B, 2*P*3, H, W] (ref eye = fg, src
eye = bg), the net's tanh prediction pred [B, 2P, H, W] float32 (blend
weights then alphas) and per-shell lookup tables u, v [B, P, H, W]; the
output is the ERP view [B, H, W, 3] float32.
"""

from __future__ import annotations

import torch

from matryodshka_tpu_torch.geometry.render import over_composite
from matryodshka_tpu_torch.ops import _build
from matryodshka_tpu_torch.ops.resample import resample_layers_uv

#: Early ray termination threshold on the transmittance (K3's FTB_EPS).
EPS = 1e-6

#: Launches of the render kernel in this process.
launches = 0


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


def render_blend_plain(vol, pred, u, v):
    """Plain version of the kernel: blend at source pixels, gather-sample
    each shell, back-to-front closed-form over-composite (no early
    termination)."""
    layers = blend_layers(vol, pred)
    outs = []
    for i in range(vol.shape[0]):
        proj = resample_layers_uv(layers[i].permute(0, 2, 3, 1), u[i], v[i])
        outs.append(over_composite(proj.permute(1, 2, 0, 3)))
    return torch.stack(outs)


def render_blend(vol, pred, u, v):
    """The render: the CUDA kernel for CUDA tensors, the plain version for
    CPU tensors."""
    if vol.device.type == "cpu":
        return render_blend_plain(vol, pred, u, v)
    global launches
    b, c2, h, w = vol.shape
    p = c2 // 6
    req = _build.require
    req(vol.is_cuda, f"render_blend: unsupported device {vol.device}")
    req(c2 == 6 * p and vol.dtype in (torch.float32, torch.bfloat16)
        and vol.is_contiguous(),
        f"render_blend: vol {vol.dtype} {tuple(vol.shape)}")
    req(pred.dtype == torch.float32 and pred.is_contiguous()
        and pred.device == vol.device and pred.shape[0] == b
        and tuple(pred.shape) == (b, 2 * p, h, w),
        f"render_blend: pred {pred.dtype} {tuple(pred.shape)} (blend_psv: "
        f"exactly 2P channels)")
    for name, t in (("u", u), ("v", v)):
        req(t.dtype == torch.float32 and t.is_contiguous()
            and t.device == vol.device and tuple(t.shape) == (b, p, h, w),
            f"render_blend: {name} {t.dtype} {tuple(t.shape)}")
    out = torch.empty((b, h, w, 3), dtype=torch.float32, device=vol.device)
    err = _build.lib().matry_render(
        vol.data_ptr(), pred.data_ptr(), u.data_ptr(), v.data_ptr(),
        out.data_ptr(), b, p, h, w, int(vol.dtype == torch.bfloat16), EPS,
        _build.stream_ptr(vol.device))
    _build.check(err, "matry_render")
    launches += 1
    return out
