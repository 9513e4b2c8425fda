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


def uv_grid(shape, device=None, dtype=torch.float32):
    """(U, V): [H, W] normalized (-1, 1) coordinates with half-pixel
    offsets, U varying along W and V along H (JAX grids.py:45)."""
    h, w = shape
    u = torch.linspace(-1.0 + 1.0 / w, 1.0 - 1.0 / w, w, device=device,
                       dtype=dtype)
    v = torch.linspace(-1.0 + 1.0 / h, 1.0 - 1.0 / h, h, device=device,
                       dtype=dtype)
    V, U = torch.meshgrid(v, u, indexing="ij")
    return U, V


def theta_y_grid(shape, device=None, dtype=torch.float32):
    """(TH, Y): [H, W] cylindrical grid, theta in [-pi, pi] (along W) and
    y in [-1, 1] (along H), with no half-pixel offset (JAX grids.py:54)."""
    h, w = shape
    th = torch.linspace(-PI, PI, w, device=device, dtype=dtype)
    y = torch.linspace(-1.0, 1.0, h, device=device, dtype=dtype)
    Y, TH = torch.meshgrid(y, th, indexing="ij")
    return TH, Y


_VECTORS = {}


def lat_long_vectors(height: int, width: int, device):
    """(lat [H], lon [W]) float32: lat_long_grid's two vectors, which the
    sweep and render kernels read. Built once per (H, W, device) and
    kept, so a frame spends no launches on them."""
    key = (height, width, torch.device(device))
    if key not in _VECTORS:
        S, T = lat_long_grid((height, width), device=device)
        _VECTORS[key] = (T[:, 0].contiguous(), S[0].contiguous())
    return _VECTORS[key]


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


#: The f32 noise bound of a lookup position (the sweep's row parameters,
#: the render's per-shell uv), in pixels of a 64 x 32 grid:
#: max(NOISE_PX, NOISE_PX_PER_M * depth or radius), the bound
#: tests/test_torch_sweep.py holds f32 projections to at that size (the
#: tangent quadratic's cancellation grows with the depth).
NOISE_PX = 1e-4
NOISE_PX_PER_M = 4e-5


def lookup_error(u, v, u_ref, v_ref, scale_m, height: int, width: int):
    """How far lookup positions (u, v) lie from a reference (u_ref, v_ref),
    against the noise bound at H x W: the same angle as at 64 x 32, so
    the bound is W/64 times the 64 x 32 one in u and H/32 times in v; a
    u error counts times cos(latitude of v_ref), its length on the sphere
    (u is singular at the poles, where a longitude step is no distance).
    Distances are circular (mod W, mod H). scale_m broadcasts against the
    positions: the depth or radius of each. Returns a dict of the worst u
    and v errors in pixels ('u_px', 'v_px', unweighted) and as fractions
    of the bound ('u', 'v')."""
    def circ(a, b, n):
        d = torch.remainder(a.double() - b.double(), n)
        return torch.minimum(d, n - d)

    v_ref = v_ref.double()
    lat = (v_ref / (height - 1) * (PI - PI / height)
           - (PI / 2 - PI / (2 * height)))
    du, dv = circ(u, u_ref, width), circ(v, v_ref, height)
    tol = torch.clamp(NOISE_PX_PER_M * torch.as_tensor(scale_m).double(),
                      min=NOISE_PX)
    return {"u_px": du.max().item(), "v_px": dv.max().item(),
            "u": (du * torch.cos(lat).abs() / (tol * width / 64)).max().item(),
            "v": (dv / (tol * height / 32)).max().item()}
