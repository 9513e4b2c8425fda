"""Ray / MSI-shell intersections for ERP novel-view rendering.

Counterpart of `matryodshka_tpu/geometry/intersect.py`
(`sphere_intersections`, `intersect_sphere`, `intersect_sphere_uv`,
`intersect_ods`, `intersect_perspective`). The ERP target centre is
swizzled (z, y, x) to go from the capture rig's RDF frame into the MSI's
RUB frame, as the reference does; the perspective window's centre
(x, y, -z) (spherical.py:390-392).
"""

from __future__ import annotations

import torch

from matryodshka_tpu_torch.geometry.cameras import (apply_pose,
                                                    project_spherical,
                                                    rotate_dirs)
from matryodshka_tpu_torch.geometry.grids import (lat_long_grid,
                                                  spherical_ray_dirs,
                                                  theta_phi_to_pixels_uv,
                                                  uv_grid)


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


def intersect_ods(pose, center, order: int, intrinsics, radii, width: int,
                  height: int):
    """Lookup coordinates that re-render an ODS eye from the MSI (JAX
    intersect.py:114): each ERP pixel's ray starts on the viewing circle
    of radius intrinsics[0, 0], for eye order +1 (left) or -1 (right),
    both rotated and moved by pose [4, 4]; its hits on the shells radii [P]
    project through the centred ERP camera. Returns [P, height, width, 2].
    center is not read, as in the JAX function."""
    del center
    S, T = lat_long_grid((height, width), device=radii.device,
                         dtype=radii.dtype)
    baseline = intrinsics[0, 0]
    cos_t = torch.cos(T)
    rays = rotate_dirs((torch.cos(S) * cos_t, torch.sin(T),
                        -torch.sin(S) * cos_t), pose)
    centers = apply_pose((-torch.sin(S) * baseline * order,
                          torch.zeros_like(S),
                          -torch.cos(S) * baseline * order), pose)
    pts = sphere_intersections(tuple(r[None] for r in rays),
                               tuple(c[None] for c in centers),
                               radii[:, None, None])
    return project_spherical(pts, width, height)


def intersect_perspective(pose, center, radii, width: int, height: int,
                          tgt_width: int, tgt_height: int):
    """Lookup coordinates of a perspective crop of the MSI (JAX
    intersect.py:141): a pinhole window with the reference's constants
    (spherical.py:383-387), ray (0.1 u, 0.05 v, -0.05) over the +-1 uv
    grid of tgt_height x tgt_width, centred at center [3] swizzled
    (x, y, -z), both rotated and moved by pose [4, 4]. Returns
    [P, tgt_height, tgt_width, 2] indexing the height x width ERP."""
    center = center.reshape(-1)
    U, V = uv_grid((tgt_height, tgt_width), device=radii.device,
                   dtype=radii.dtype)
    rays = rotate_dirs((U * 0.1, V * 0.05, -torch.ones_like(U) * 0.05),
                       pose)
    cx, cy, cz = apply_pose((center[0], center[1], -center[2]), pose)
    pts = sphere_intersections(tuple(r[None] for r in rays), (cx, cy, cz),
                               radii[:, None, None])
    return project_spherical(pts, width, height)
