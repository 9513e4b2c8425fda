"""Equirectangular pixel grids and angle <-> pixel conversions.

Counterpart of `matryodshka_tpu/geometry/grids.py`: pixel centres sit half
a pixel in from the domain edges, so longitude j is
-pi + pi/W + j (2pi - 2pi/W)/(W-1) and latitude i is
-pi/2 + pi/(2H) + i (pi - pi/H)/(H-1).
"""

from __future__ import annotations

import math

import torch

PI = math.pi


def lat_long_grid(shape, device=None, dtype=torch.float32):
    """(S, T): [H, W] longitudes (varying along W) and latitudes (along H)."""
    h, w = shape
    s = torch.linspace(-PI + PI / w, PI - PI / w, w, device=device,
                       dtype=dtype)
    t = torch.linspace(-PI / 2 + PI / (2 * h), PI / 2 - PI / (2 * h), h,
                       device=device, dtype=dtype)
    T, S = torch.meshgrid(t, s, indexing="ij")
    return S, T


def theta_phi_to_pixels_uv(theta, phi, width: int, height: int):
    """Angles -> fractional ERP pixel coordinates (u in [0, W-1] for theta in
    [-pi, pi], v in [0, H-1] for phi in [-pi/2, pi/2])."""
    u = (theta + PI - PI / width) / (2 * PI - 2 * PI / width) * (width - 1)
    v = ((phi + 0.5 * PI - 0.5 * PI / height)
         / (PI - PI / height) * (height - 1))
    return u, v


def theta_phi_to_pixels(theta, phi, width: int, height: int):
    """As theta_phi_to_pixels_uv, stacked on a last axis of 2: [..., 2]."""
    return torch.stack(theta_phi_to_pixels_uv(theta, phi, width, height),
                       dim=-1)


def spherical_ray_dirs(S, T):
    """Unit ray (cos S cos T, sin T, sin S cos T) in the RUB frame."""
    cos_t = torch.cos(T)
    return torch.cos(S) * cos_t, torch.sin(T), torch.sin(S) * cos_t
