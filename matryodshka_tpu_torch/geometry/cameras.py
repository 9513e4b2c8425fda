"""Backprojection, pose application and ODS / spherical projection.

Counterpart of `matryodshka_tpu/geometry/cameras.py`; every function works
on tensors of any common shape (typically [P, H, W]).
"""

from __future__ import annotations

import torch

from matryodshka_tpu_torch.geometry.grids import (PI, spherical_ray_dirs,
                                                  theta_phi_to_pixels)


def backproject_spherical(S, T, depths):
    """Points on spheres of radius depths[p] through ERP pixel (S, T).

    S, T: [H, W]; depths: [P]. Returns (x, y, z), each [P, H, W].
    """
    rx, ry, rz = spherical_ray_dirs(S, T)
    d = depths[:, None, None]
    return d * rx[None], d * ry[None], d * rz[None]


def apply_pose(points, pose):
    """Rigidly transform (x, y, z) by a 4x4 pose."""
    x, y, z = points
    R = pose[:3, :3]
    t = pose[:3, 3]
    return (R[0, 0] * x + R[0, 1] * y + R[0, 2] * z + t[0],
            R[1, 0] * x + R[1, 1] * y + R[1, 2] * z + t[1],
            R[2, 0] * x + R[2, 1] * y + R[2, 2] * z + t[2])


def rotate_dirs(dirs, pose):
    """Rotate (x, y, z) directions by the rotation part of a 4x4 pose."""
    x, y, z = dirs
    R = pose[:3, :3]
    return (R[0, 0] * x + R[0, 1] * y + R[0, 2] * z,
            R[1, 0] * x + R[1, 1] * y + R[1, 2] * z,
            R[2, 0] * x + R[2, 1] * y + R[2, 2] * z)


def project_ods(points, order: int, intrinsics, width: int, height: int):
    """Project points into an ODS eye image: [..., 2] pixel coordinates.

    Finds the tangent ray of the viewing circle of radius
    r = intrinsics[0, 0] through each point, for eye order +1 (left) or
    -1 (right), solving the tangency quadratic with x and z swapped where
    |z| > |x|. A point with no tangent ray (disc < 0) is parked at pixel
    (1, 1); a NaN latitude becomes 1 and latitudes are clamped to
    [-pi/2, pi/2], as in the reference.
    """
    x, y, z = points
    r = intrinsics[0, 0]
    f = r * r - (x * x + z * z)
    z_larger_x = torch.abs(z) > torch.abs(x)
    px = torch.where(z_larger_x, x, z)
    pz = torch.where(z_larger_x, z, x)

    pz_sq = pz * pz
    a = 1.0 + px * px / pz_sq
    b = -2.0 * f * px / pz_sq
    c = f + f * f / pz_sq
    disc = b * b - 4.0 * a * c

    s = -order * torch.sign(pz) * torch.sqrt(torch.clamp(disc, min=0.0))
    s = torch.where(z_larger_x, s, -s)

    dx = (-b + s) / (2.0 * a)
    dz = (f - px * dx) / pz
    dx, dz = (torch.where(z_larger_x, -dx, -dz),
              torch.where(z_larger_x, -dz, -dx))

    theta = -torch.atan2(dz, dx)
    phi = torch.atan2(y, torch.sqrt(dx * dx + dz * dz))
    phi = torch.where(torch.isnan(phi), torch.ones_like(phi), phi)
    phi = torch.clamp(phi, -PI / 2, PI / 2)

    uv = theta_phi_to_pixels(theta, phi, width, height)
    valid = disc >= 0.0
    return torch.where(valid[..., None], uv, torch.ones_like(uv))


def project_spherical(points, width: int, height: int):
    """Project points into a centred ERP camera: [..., 2] pixel coords."""
    x, y, z = points
    theta = -torch.atan2(z, x)
    phi = torch.atan2(y, torch.sqrt(x * x + z * z))
    return theta_phi_to_pixels(theta, phi, width, height)
