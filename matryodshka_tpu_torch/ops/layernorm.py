"""Spatial layer norm + ReLU: the plain version of the K2 stage's LN+ReLU.

Semantics are `models/unet.py:SpatialLayerNorm` then ReLU (the LN+ReLU
stage of `matryodshka_tpu/ops/pallas_net.py:_build_kernel`): statistics over
(C, H, W) per example in float32 from the stored tensor, eps 1e-12,
per-channel gamma/beta, output in x's dtype.

On the card it has no kernel of its own: the conv kernel (`ops/conv.py`,
`csrc/conv.cu`) sums each output's statistics in its epilogue and its
consumer applies the normalization and the ReLU to its input as it stages
it. This function is what the CPU route runs and what the card's gates
hold that fused path to.
"""

from __future__ import annotations

import torch

EPS = 1e-12


def layer_norm_relu_plain(x, gamma, beta, eps: float = EPS,
                          relu: bool = True):
    """x [B, C, H, W] -> same shape and dtype (the net's SpatialLayerNorm
    with relu=False): float32 statistics, one rounding to x's dtype."""
    x32 = x.float()
    mean = x32.mean(dim=(1, 2, 3), keepdim=True)
    var = (x32 - mean).square().mean(dim=(1, 2, 3), keepdim=True)
    y = ((x32 - mean) * torch.rsqrt(var + eps) * gamma.float()[:, None, None]
         + beta.float()[:, None, None])
    if relu:
        y = torch.relu(y)
    return y.to(x.dtype)
