"""Bilinear resampling with wrap-around on both axes.

Counterpart of `matryodshka_tpu/ops/resample.py` (`bilinear_wrap_resample`,
`resample_layers_uv`). Taps wrap mod W horizontally and mod H vertically
(the reference's `tf.mod` on both axes); weights are applied in float32.
This is the plain reference that the sweep and render kernels are held
against.
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
