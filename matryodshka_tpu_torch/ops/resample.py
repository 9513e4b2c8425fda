"""Bilinear resampling, with wrap-around or zeros outside the image.

Counterpart of `matryodshka_tpu/ops/resample.py` (`bilinear_wrap_resample`,
`resample_layers_uv`, `bilinear_zero_resample`, `resample_stack`). In the
wrap form taps wrap mod W horizontally and mod H vertically (the
reference's `tf.mod` on both axes); it is the plain reference that the
sweep and render kernels are held against. In the zero form (the
homography path's `tf.contrib.resampler`) each tap counts only inside
[0, W-1] x [0, H-1]. Weights are applied in float32.
"""

from __future__ import annotations

import torch


def _floor_frac(x, y, h: int, w: int):
    x = x.float()
    y = y.float()
    x0f = torch.floor(x)
    y0f = torch.floor(y)
    x0 = torch.remainder(x0f.long(), w)
    y0 = torch.remainder(y0f.long(), h)
    return x0, y0, x - x0f, y - y0f


def _sample(image_flat, x0, y0, fx, fy, h: int, w: int):
    """image_flat [H*W, C]; index/weight tensors of a common shape."""
    x1 = torch.remainder(x0 + 1, w)
    y1 = torch.remainder(y0 + 1, h)

    def tap(yi, xi):
        return image_flat[yi * w + xi]

    wa = ((1.0 - fy) * (1.0 - fx))[..., None]
    wb = ((1.0 - fy) * fx)[..., None]
    wc = (fy * (1.0 - fx))[..., None]
    wd = (fy * fx)[..., None]
    return (wa * tap(y0, x0) + wb * tap(y0, x1)
            + wc * tap(y1, x0) + wd * tap(y1, x1))


def bilinear_wrap_resample(image, coords):
    """image [H, W, C], coords [..., 2] (x, y) pixels -> [..., C] float32."""
    h, w, c = image.shape
    x0, y0, fx, fy = _floor_frac(coords[..., 0], coords[..., 1], h, w)
    return _sample(image.reshape(h * w, c).float(), x0, y0, fx, fy, h, w)


def resample_layers_uv(layers, u, v):
    """Sample layer p at its own field: layers [P, H, W, C], u, v [P, ...]
    -> [P, ..., C] float32."""
    p, h, w, c = layers.shape
    x0, y0, fx, fy = _floor_frac(u, v, h, w)
    return torch.stack([
        _sample(layers[i].reshape(h * w, c).float(), x0[i], y0[i], fx[i],
                fy[i], h, w)
        for i in range(p)])


def resample_layers(layers, coords):
    """As resample_layers_uv with coords [P, ..., 2]."""
    return resample_layers_uv(layers, coords[..., 0], coords[..., 1])


def bilinear_zero_resample(image, coords):
    """Bilinear sample whose taps outside [0, W-1] x [0, H-1] contribute
    zero (tf.contrib.resampler, geometry/sampling.py:32-54). image
    [*L, H, W, C], coords [*L, *S, 2] (x, y) pixels, where the leading
    dims L (none, or e.g. a batch and a plane axis) pair each image with
    its own coordinates -> [*L, *S, C] float32, in one gather."""
    *lead, h, w, c = image.shape
    n = 1
    for d in lead:
        n *= d
    flat = image.reshape(n * h * w, c).float()
    x = coords[..., 0].float()
    y = coords[..., 1].float()
    x0f = torch.floor(x)
    y0f = torch.floor(y)
    fx = x - x0f
    fy = y - y0f
    x0 = x0f.long()
    y0 = y0f.long()
    base = (torch.arange(n, device=image.device) * (h * w)).reshape(
        *lead, *([1] * (x.dim() - len(lead))))

    def tap(yi, xi, wgt):
        inside = (xi >= 0) & (xi <= w - 1) & (yi >= 0) & (yi <= h - 1)
        idx = (base + torch.clamp(yi, 0, h - 1) * w
               + torch.clamp(xi, 0, w - 1))
        return (wgt * inside)[..., None] * flat[idx]

    return (tap(y0, x0, (1 - fy) * (1 - fx)) + tap(y0, x0 + 1, (1 - fy) * fx)
            + tap(y0 + 1, x0, fy * (1 - fx)) + tap(y0 + 1, x0 + 1, fy * fx))


def resample_stack(image, coords, wrap: bool = True):
    """One image [H, W, C] sampled at a coordinate stack [P, H', W', 2]
    -> [P, H', W', C] float32, with wrap-around or zeros outside."""
    if wrap:
        return bilinear_wrap_resample(image, coords)
    return bilinear_zero_resample(image, coords)
