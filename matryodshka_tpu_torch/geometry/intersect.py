"""Ray / MSI-shell intersections for ERP novel-view rendering.

Counterpart of `matryodshka_tpu/geometry/intersect.py`
(`sphere_intersections`, `intersect_sphere`, `intersect_sphere_uv`). The
target centre is swizzled (z, y, x) to go from the capture rig's RDF frame
into the MSI's RUB frame, as the reference does.
"""

from __future__ import annotations

import torch

from matryodshka_tpu_torch.geometry.cameras import apply_pose, rotate_dirs
from matryodshka_tpu_torch.geometry.grids import (lat_long_grid,
                                                  spherical_ray_dirs,
                                                  theta_phi_to_pixels_uv)


def sphere_intersections(rays, centers, radius):
    """Forward (+ root) intersection of rays (dir r, origin c) with
    origin-centred spheres; radius broadcasts against the rays."""
    rx, ry, rz = rays
    cx, cy, cz = centers
    a = rx * rx + ry * ry + rz * rz
    b = 2.0 * (rx * cx + ry * cy + rz * cz)
    c = cx * cx + cy * cy + cz * cz - radius * radius
    disc = b * b - 4.0 * a * c
    t = (-b + torch.sqrt(torch.clamp(disc, min=0.0))) / (2.0 * a)
    return cx + t * rx, cy + t * ry, cz + t * rz


def intersect_sphere_uv(pose, center, radii, width: int, height: int):
    """ERP target view -> per-shell lookup coordinates into the MSI.

    pose [4, 4] target pose; center [3] target position (rig frame);
    radii [P]. Returns (u, v), each [P, height, width] float32 pixels.
    """
    center = center.reshape(-1)
    S, T = lat_long_grid((height, width), device=radii.device,
                         dtype=radii.dtype)
    rx, ry, rz = rotate_dirs(spherical_ray_dirs(S, T), pose)
    cx, cy, cz = apply_pose((center[2], center[1], center[0]), pose)
    x, y, z = sphere_intersections(
        (rx[None], ry[None], rz[None]), (cx, cy, cz), radii[:, None, None])
    theta = -torch.atan2(z, x)
    phi = torch.atan2(y, torch.sqrt(x * x + z * z))
    return theta_phi_to_pixels_uv(theta, phi, width, height)


def intersect_sphere(pose, center, radii, width: int, height: int):
    """As intersect_sphere_uv, stacked: [P, height, width, 2]."""
    return torch.stack(intersect_sphere_uv(pose, center, radii, width,
                                           height), dim=-1)
