"""Spatial layer norm + ReLU: kernel wrapper and its plain version.

The kernel is `csrc/layernorm.cu` (the LN+ReLU stage of
`matryodshka_tpu/ops/pallas_net.py:_build_kernel`); its source note gives
the bound and the design. Semantics are `models/unet.py:SpatialLayerNorm`
then ReLU: statistics over (C, H, W) per example in float32 from the
stored tensor, eps 1e-12, per-channel gamma/beta, output in x's dtype.

The kernel has two forms, chosen by the shape (`ln_plan`): "onchip", one
cooperative launch that holds the example in shared memory across the
card's SMs (one example whose share per SM fits), and "two_pass", a
statistics launch and an apply launch that each stream x from device
memory (a batch above 1, or a tensor too large for the card's shared
memory).
"""

from __future__ import annotations

import functools

import torch

from matryodshka_tpu_torch.ops import _build

EPS = 1e-12
#: Shared memory a block of the on-chip form may fill with its share of
#: the example: an H100 block's opt-in limit (232,448 bytes) less 1 KiB
#: for the kernel's static scratch.
SMEM_SHARE = 232_448 - 1024
#: The two-pass form's chunk: about this many elements per block, with at
#: most 1024 blocks per example (so its apply launch folds at most 1024
#: partials); larger examples take larger chunks.
_CHUNK = 8192
_MAX_BLOCKS = 1024
#: Elements per chunk are a multiple of this (16 bytes of bfloat16), so
#: every chunk starts on a 16-byte vector.
_ALIGN = 8

#: Launches of the layer-norm kernel: one per call, in either form (the
#: two-pass form's stats and apply launches count once).
launches = 0


def ln_plan(b: int, c: int, h: int, w: int, itemsize: int, sms: int = 132):
    """(form, blocks, share) of the kernel for x [b, c, h, w] of itemsize
    bytes on a card with `sms` SMs. "onchip": b == 1 and a share of
    ceil(n / sms) elements (n = c*h*w, rounded up to 8) fits SMEM_SHARE;
    one block per SM, block k takes elements [k*share, (k+1)*share).
    "two_pass" otherwise: grid (blocks, b), block k of each example takes
    elements [k*share, (k+1)*share)."""
    n = c * h * w
    share = -(-n // sms)
    share = -(-share // _ALIGN) * _ALIGN
    if b == 1 and share * itemsize <= SMEM_SHARE:
        return "onchip", sms, share
    nblk = max(1, min(_MAX_BLOCKS, -(-n // _CHUNK)))
    chunk = -(-n // nblk)
    chunk = -(-chunk // _ALIGN) * _ALIGN
    return "two_pass", -(-n // chunk), chunk


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def plan_for(x):
    """ln_plan for a CUDA tensor x on its own card."""
    b, c, h, w = x.shape
    return ln_plan(b, c, h, w, x.element_size(), _sm_count(x.device.index
                                                          or 0))


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
    form, nblk, share = plan_for(x)
    req(nblk * share < 2 ** 31,
        f"layer_norm_relu: {c * h * w} elements per example is too many")
    partial = torch.empty((b, nblk, 2), dtype=torch.float64, device=x.device)
    out = torch.empty_like(x)
    err = _build.lib().matry_layernorm(
        x.data_ptr(), partial.data_ptr(), gamma.data_ptr(), beta.data_ptr(),
        out.data_ptr(), b, c, h * w, nblk, share, eps, int(relu),
        int(x.dtype == torch.float32), int(form == "onchip"),
        _build.stream_ptr(x.device))
    _build.check(err, "matry_layernorm")
    launches += 1
    return out
