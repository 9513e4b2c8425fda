"""Pixel loss and spherical attention weighting.

Counterpart of `matryodshka_tpu/losses/basic.py` (`l2_loss`,
`spherical_weights`):

* the reference's "pixel" loss is tf.reduce_mean(tf.nn.l2_loss(p - y))
  (msi.py:662), and tf.nn.l2_loss is sum(t^2)/2, a scalar, so the loss is
  HALF THE SUM of squared errors, not a mean;
* spherical weights (msi.py:1132-1143): a per-pixel solid-angle factor
  1/|cos(phi) - cos(phi + delta)| * |dtheta| from two shifted lat/long
  grids, here computed in float64 and stored as float32 (near the equator
  the cosine difference cancels in float32).
"""

from __future__ import annotations

import math

import numpy as np
import torch

PI = math.pi


def l2_loss(pred, target, weights=None):
    """0.5 * sum((pred - target)^2), with per-pixel weights multiplied into
    BOTH images first when given (msi.py:656-662)."""
    if weights is not None:
        pred = pred * weights
        target = target * weights
    return 0.5 * torch.sum(torch.square(pred - target))


def spherical_weights(height: int, width: int, epsilon: float = 1e-12,
                      device=None):
    """[H, W] float32 latitude weighting map (msi.py:1132-1143)."""
    theta = np.linspace(-PI + epsilon, PI + epsilon, width)
    phi = np.linspace(-PI / 2 + epsilon, PI / 2 + epsilon, height)
    delta = PI / height
    theta_s = np.linspace(-PI + delta, PI + delta, width)
    phi_s = np.linspace(-PI / 2 + delta / 2, PI / 2 + delta / 2, height)
    th, ph = np.meshgrid(theta, phi)
    th_s, ph_s = np.meshgrid(theta_s, phi_s)
    w = 1.0 / np.abs(np.cos(ph) - np.cos(ph_s)) * np.abs(th_s - th)
    return torch.from_numpy(w.astype(np.float32)).to(device)
