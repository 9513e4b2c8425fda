"""Equirectangular grids, the ODS eye projection and ray/shell lookups.

Pixel centres sit half a pixel in from the domain edges: longitude j is
-pi + pi/W + j (2pi - 2pi/W)/(W-1), latitude i is
-pi/2 + pi/(2H) + i (pi - pi/H)/(H-1). Rays are (cos S cos T, sin T,
sin S cos T) in the MSI's RUB frame. The ODS projection finds the tangent
ray of the viewing circle of radius r through a point (the MatryODShka
paper, section 3; the upstream `spherical.py`).
"""

from __future__ import annotations

import math

import torch

PI = math.pi


def inv_depths(near: float, far: float, n: int):
    """n depths uniform in inverse depth from near to far, both included,
    sorted far to near (shell 0 is the farthest)."""
    depths = [near, far]
    for i in range(1, n - 1):
        frac = i / (n - 1)
        depths.append(1.0 / (1.0 / near + (1.0 / far - 1.0 / near) * frac))
    return sorted(depths)[::-1]


def lat_long_grid(h: int, w: int, device=None, dtype=torch.float32):
    """(S, T): [H, W] longitudes (along W) and latitudes (along H)."""
    s = torch.linspace(-PI + PI / w, PI - PI / w, w, device=device,
                       dtype=dtype)
    t = torch.linspace(-PI / 2 + PI / (2 * h), PI / 2 - PI / (2 * h), h,
                       device=device, dtype=dtype)
    T, S = torch.meshgrid(t, s, indexing="ij")
    return S, T


def ray_dirs(S, T):
    cos_t = torch.cos(T)
    return torch.cos(S) * cos_t, torch.sin(T), torch.sin(S) * cos_t


def angles_to_pixels(theta, phi, w: int, h: int):
    """Angles -> fractional pixel coordinates (u along W, v along H)."""
    u = (theta + PI - PI / w) / (2 * PI - 2 * PI / w) * (w - 1)
    v = (phi + 0.5 * PI - 0.5 * PI / h) / (PI - PI / h) * (h - 1)
    return u, v


def project_ods(x, y, z, order: int, r, w: int, h: int):
    """Pixel coordinates (u, v) of points in the ODS eye of order +1
    (left) or -1 (right) of a rig of radius r. Where no tangent ray exists
    the point is parked at pixel (1, 1). The tangency quadratic is solved
    with x and z swapped where |z| > |x|, for conditioning."""
    f = r * r - (x * x + z * z)
    zx = torch.abs(z) > torch.abs(x)
    px = torch.where(zx, x, z)
    pz = torch.where(zx, z, x)
    pz2 = pz * pz
    a = 1.0 + px * px / pz2
    b = -2.0 * f * px / pz2
    c = f + f * f / pz2
    disc = b * b - 4.0 * a * c
    s = -order * torch.sign(pz) * torch.sqrt(torch.clamp(disc, min=0.0))
    s = torch.where(zx, s, -s)
    dx = (-b + s) / (2.0 * a)
    dz = (f - px * dx) / pz
    dx, dz = torch.where(zx, -dx, -dz), torch.where(zx, -dz, -dx)
    theta = -torch.atan2(dz, dx)
    phi = torch.atan2(y, torch.sqrt(dx * dx + dz * dz))
    phi = torch.where(torch.isnan(phi), torch.ones_like(phi), phi)
    phi = torch.clamp(phi, -PI / 2, PI / 2)
    u, v = angles_to_pixels(theta, phi, w, h)
    ok = disc >= 0.0
    one = torch.ones_like(u)
    return torch.where(ok, u, one), torch.where(ok, v, one)


def shell_lookup(rot, pos, radii, h: int, w: int):
    """Where each pixel of an ERP view from position pos [3] (rig frame),
    turned by rot [4, 4], meets each shell of radii [P]: (u, v), each
    [P, H, W] float32 pixel coordinates into the MSI. The position is
    swizzled (z, y, x) from the rig's RDF frame into the MSI's RUB frame."""
    S, T = lat_long_grid(h, w, radii.device, radii.dtype)
    R, t = rot[:3, :3], rot[:3, 3]
    dx, dy, dz = ray_dirs(S, T)
    rx = R[0, 0] * dx + R[0, 1] * dy + R[0, 2] * dz
    ry = R[1, 0] * dx + R[1, 1] * dy + R[1, 2] * dz
    rz = R[2, 0] * dx + R[2, 1] * dy + R[2, 2] * dz
    p = pos.reshape(-1)
    c0, c1, c2 = p[2], p[1], p[0]
    cx = R[0, 0] * c0 + R[0, 1] * c1 + R[0, 2] * c2 + t[0]
    cy = R[1, 0] * c0 + R[1, 1] * c1 + R[1, 2] * c2 + t[1]
    cz = R[2, 0] * c0 + R[2, 1] * c1 + R[2, 2] * c2 + t[2]
    rad = radii[:, None, None]
    a = rx * rx + ry * ry + rz * rz
    b = 2.0 * (rx * cx + ry * cy + rz * cz)
    c = cx * cx + cy * cy + cz * cz - rad * rad
    tt = (-b + torch.sqrt(torch.clamp(b * b - 4.0 * a * c, min=0.0))) \
        / (2.0 * a)
    x, y, z = cx + tt * rx, cy + tt * ry, cz + tt * rz
    theta = -torch.atan2(z, x)
    phi = torch.atan2(y, torch.sqrt(x * x + z * z))
    return angles_to_pixels(theta, phi, w, h)


def bilinear(layers, u, v):
    """Sample layer p of layers [P, H, W, C] at its own (u[p], v[p]),
    each [P, ...], taps wrapping mod W and mod H -> [P, ..., C] float32."""
    p, h, w, c = layers.shape
    x0f, y0f = torch.floor(u.float()), torch.floor(v.float())
    fx, fy = (u.float() - x0f)[..., None], (v.float() - y0f)[..., None]
    x0 = torch.remainder(x0f.long(), w)
    y0 = torch.remainder(y0f.long(), h)
    x1, y1 = torch.remainder(x0 + 1, w), torch.remainder(y0 + 1, h)
    out = []
    for i in range(p):
        flat = layers[i].reshape(h * w, c).float()

        def tap(yy, xx, i=i, flat=flat):
            return flat[yy[i] * w + xx[i]]

        out.append((1 - fy[i]) * (1 - fx[i]) * tap(y0, x0)
                   + (1 - fy[i]) * fx[i] * tap(y0, x1)
                   + fy[i] * (1 - fx[i]) * tap(y1, x0)
                   + fy[i] * fx[i] * tap(y1, x1))
    return torch.stack(out)
