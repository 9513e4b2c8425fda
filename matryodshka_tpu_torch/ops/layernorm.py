"""Spatial layer norm + ReLU: kernel wrapper and its plain version.

The kernel is `csrc/layernorm.cu` (the LN+ReLU stage of
`matryodshka_tpu/ops/pallas_net.py:_build_kernel`); its source note gives
the bound and the design. Semantics are `models/unet.py:SpatialLayerNorm`
then ReLU: statistics over (C, H, W) per example in float32 from the
stored tensor, eps 1e-12, per-channel gamma/beta, output in x's dtype.
"""

from __future__ import annotations

import torch

from matryodshka_tpu_torch.ops import _build

EPS = 1e-12
#: Elements per block of the kernel's two passes (chunks are capped at
#: 1024 per example, so the apply pass folds at most 1024 partials).
_CHUNK = 8192

#: Launches of the layer-norm kernel (stats + apply count once).
launches = 0


def layer_norm_relu_plain(x, gamma, beta, eps: float = EPS,
                          relu: bool = True):
    """Plain version of the kernel (and the net's SpatialLayerNorm with
    relu=False): float32 statistics, one rounding to x's dtype."""
    x32 = x.float()
    mean = x32.mean(dim=(1, 2, 3), keepdim=True)
    var = (x32 - mean).square().mean(dim=(1, 2, 3), keepdim=True)
    y = ((x32 - mean) * torch.rsqrt(var + eps) * gamma.float()[:, None, None]
         + beta.float()[:, None, None])
    if relu:
        y = torch.relu(y)
    return y.to(x.dtype)


def layer_norm_relu(x, gamma, beta, eps: float = EPS, relu: bool = True):
    """x [B, C, H, W] -> same shape and dtype: the CUDA kernel for CUDA
    tensors, the plain version for CPU tensors."""
    if x.device.type == "cpu":
        return layer_norm_relu_plain(x, gamma, beta, eps, relu)
    global launches
    b, c, h, w = x.shape
    req = _build.require
    req(x.is_cuda, f"layer_norm_relu: unsupported device {x.device}")
    req(x.dtype in (torch.float32, torch.bfloat16) and x.is_contiguous(),
        f"layer_norm_relu: x must be contiguous float32/bfloat16, "
        f"got {x.dtype}")
    for name, t in (("gamma", gamma), ("beta", beta)):
        req(t.dtype == torch.float32 and t.is_contiguous()
            and t.device == x.device and tuple(t.shape) == (c,),
            f"layer_norm_relu: {name} {t.dtype} {tuple(t.shape)}")
    n = c * h * w
    nblk = max(1, min(1024, -(-n // _CHUNK)))
    partial = torch.empty((b, nblk, 2), dtype=torch.float64, device=x.device)
    out = torch.empty_like(x)
    err = _build.lib().matry_layernorm(
        x.data_ptr(), partial.data_ptr(), gamma.data_ptr(), beta.data_ptr(),
        out.data_ptr(), b, c, h * w, nblk, eps, int(relu),
        int(x.dtype == torch.float32), _build.stream_ptr(x.device))
    _build.check(err, "matry_layernorm")
    launches += 1
    return out
