"""Backprojection, pose application, ODS / spherical / pinhole
projection, the regularizer's jitter pose, and quaternion pose
interpolation.

Counterpart of `matryodshka_tpu/geometry/cameras.py`; the point functions
work on tensors of any common shape (typically [P, H, W]).
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


def project_ods(points, order: int, intrinsics, width: int, height: int,
                negate_y: bool = False):
    """Project points into an ODS eye image: [..., 2] pixel coordinates.

    Finds the tangent ray of the viewing circle of radius
    r = intrinsics[0, 0] through each point, for eye order +1 (left) or
    -1 (right), solving the tangency quadratic with x and z swapped where
    |z| > |x|. A point with no tangent ray (disc < 0) is parked at pixel
    (1, 1); a NaN latitude becomes 1 and latitudes are clamped to
    [-pi/2, pi/2], as in the reference. negate_y: the reference negates y
    when the points arrive as one packed tensor (spherical.py:172-175), as
    the GCN's vertex sweep gives them (JAX cameras.py:109-133).
    """
    x, y, z = points
    if negate_y:
        y = -y
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


# ---------------------------------------------------------------------------
# Poses.
# ---------------------------------------------------------------------------

def rotation_from_euler(angles):
    """3x3 rotation from XYZ Euler angles [ax, ay, az]: R = Rz @ Ry @ Rx
    (JAX cameras.py:198-208, tfg's from_euler), in angles' dtype."""
    c, s = torch.cos(angles), torch.sin(angles)
    one, zero = torch.ones_like(c[0]), torch.zeros_like(c[0])

    def mat(rows):
        return torch.stack([torch.stack(r) for r in rows])

    rx = mat([[one, zero, zero], [zero, c[0], -s[0]], [zero, s[0], c[0]]])
    ry = mat([[c[1], zero, s[1]], [zero, one, zero], [-s[1], zero, c[1]]])
    rz = mat([[c[2], -s[2], zero], [s[2], c[2], zero], [zero, zero, one]])
    return rz @ ry @ rx


def pose_from_offset(offset):
    """[3] translation -> 4x4 [I | t] pose in offset's dtype and device
    (JAX cameras.py:230, data_loader.py:177-180)."""
    pose = torch.eye(4, dtype=offset.dtype, device=offset.device)
    pose[:3, 3] = offset
    return pose


def random_jitter_pose(generator=None, rot_factor: float = 1.0,
                       tr_factor: float = 1.0, angle_range=(-0.03, 0.03),
                       offset_range=(-0.01, 0.01), device="cpu"):
    """The transform-inverse regularizer's jitter (JAX cameras.py:211-228,
    spherical.py:21-40): a 4x4 float32 pose, its XYZ Euler angles uniform
    in angle_range * rot_factor rad and its translation uniform in
    offset_range * tr_factor. Draws from `generator` (a CPU
    torch.Generator; the global one when None): the three angles first,
    then the three offsets."""
    lo_a, hi_a = angle_range[0] * rot_factor, angle_range[1] * rot_factor
    lo_t, hi_t = offset_range[0] * tr_factor, offset_range[1] * tr_factor
    angles = torch.rand(3, generator=generator) * (hi_a - lo_a) + lo_a
    tr = torch.rand(3, generator=generator) * (hi_t - lo_t) + lo_t
    pose = torch.eye(4)
    pose[:3, :3] = rotation_from_euler(angles)
    pose[:3, 3] = tr
    return pose.to(device)


# ---------------------------------------------------------------------------
# Planar and cylindrical cameras (the PP / RealEstate path).
# ---------------------------------------------------------------------------

def backproject_planar(S, T, depths, intrinsics):
    """Points on fronto-parallel planes at depth depths[p] through the
    normalized UV grid (S, T) [H, W] (grids.uv_grid); intrinsics [3, 3]
    (fx, fy, cx, cy). Returns (x, y, z), each [P, H, W]."""
    fx, fy = intrinsics[0, 0], intrinsics[1, 1]
    cx, cy = intrinsics[0, 2], intrinsics[1, 2]
    d = depths[:, None, None]
    return (d * (S * cx / fx)[None], d * (T * cy / fy)[None],
            d * torch.ones_like(S)[None])


def backproject_cylindrical(S, T, depths, intrinsics):
    """Points on cylinders of radius depths[p] through (theta, y) grid
    (S, T) [H, W]; intrinsics [3, 3] (fy, cy). Returns (x, y, z), each
    [P, H, W]."""
    fy, cy = intrinsics[1, 1], intrinsics[1, 2]
    d = depths[:, None, None]
    return (d * torch.cos(S)[None], d * (T * cy / fy)[None],
            d * torch.sin(S)[None])


def project_perspective(points, intrinsics, pose=None):
    """Pinhole projection (K @ pose) of (x, y, z) -> [..., 2] pixel
    coordinates (u / w, v / w); K [3, 3] embedded in a zero 4x4 as the
    reference does (projector.py:145-147), pose [4, 4] (identity when
    None)."""
    x, y, z = points
    k4 = torch.zeros((4, 4), dtype=x.dtype, device=x.device)
    k4[:3, :3] = intrinsics
    m = k4 if pose is None else k4 @ pose
    u = m[0, 0] * x + m[0, 1] * y + m[0, 2] * z + m[0, 3]
    v = m[1, 0] * x + m[1, 1] * y + m[1, 2] * z + m[1, 3]
    w = m[2, 0] * x + m[2, 1] * y + m[2, 2] * z + m[2, 3]
    return torch.stack([u / w, v / w], dim=-1)


# ---------------------------------------------------------------------------
# Quaternions and pose interpolation (matryodshka/utils.py:55-74).
# ---------------------------------------------------------------------------

def quaternion_from_rotation(R):
    """Unit quaternion (x, y, z, w) [4] of a 3x3 rotation: Shepperd's
    method, the candidate formula with the largest pivot
    (1 + tr, 1 + R00 - R11 - R22, ...)."""
    tr = R[0, 0] + R[1, 1] + R[2, 2]
    piv = torch.stack([1.0 + tr, 1.0 + R[0, 0] - R[1, 1] - R[2, 2],
                       1.0 - R[0, 0] + R[1, 1] - R[2, 2],
                       1.0 - R[0, 0] - R[1, 1] + R[2, 2]])
    case = int(torch.argmax(piv))
    s = torch.sqrt(torch.clamp(piv[case], min=1e-12)) * 2.0
    if case == 0:
        q = [(R[2, 1] - R[1, 2]) / s, (R[0, 2] - R[2, 0]) / s,
             (R[1, 0] - R[0, 1]) / s, 0.25 * s]
    elif case == 1:
        q = [0.25 * s, (R[0, 1] + R[1, 0]) / s, (R[0, 2] + R[2, 0]) / s,
             (R[2, 1] - R[1, 2]) / s]
    elif case == 2:
        q = [(R[0, 1] + R[1, 0]) / s, 0.25 * s, (R[1, 2] + R[2, 1]) / s,
             (R[0, 2] - R[2, 0]) / s]
    else:
        q = [(R[0, 2] + R[2, 0]) / s, (R[1, 2] + R[2, 1]) / s, 0.25 * s,
             (R[1, 0] - R[0, 1]) / s]
    q = torch.stack(q)
    return q / torch.linalg.norm(q)


def rotation_from_quaternion(q):
    """3x3 rotation of a unit quaternion (x, y, z, w)."""
    x, y, z, w = q[0], q[1], q[2], q[3]
    return torch.stack([
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - z * w),
                     2 * (x * z + y * w)]),
        torch.stack([2 * (x * y + z * w), 1 - 2 * (x * x + z * z),
                     2 * (y * z - x * w)]),
        torch.stack([2 * (x * z - y * w), 2 * (y * z + x * w),
                     1 - 2 * (x * x + y * y)])])


def slerp(q0, q1, t: float):
    """Spherical linear interpolation of two unit quaternions along the
    shorter arc; a lerp where sin(theta) <= 1e-6 (nearly parallel)."""
    dot = torch.sum(q0 * q1)
    if dot < 0:
        q1, dot = -q1, -dot
    theta = torch.arccos(torch.clamp(dot, -1.0, 1.0))
    sin_theta = torch.sin(theta)
    if sin_theta > 1e-6:
        w0 = torch.sin((1 - t) * theta) / sin_theta
        w1 = torch.sin(t * theta) / sin_theta
    else:
        w0, w1 = 1.0 - t, t
    q = w0 * q0 + w1 * q1
    return q / torch.linalg.norm(q)


def interpolate_pose(ref_pose, src_pose, t: float = 0.5):
    """The pose at t between two [4, 4] poses: the rotations slerped, the
    translations lerped (the PP path's reference frame)."""
    q = slerp(quaternion_from_rotation(ref_pose[:3, :3]),
              quaternion_from_rotation(src_pose[:3, :3]), t)
    out = torch.eye(4, dtype=ref_pose.dtype, device=ref_pose.device)
    out[:3, :3] = rotation_from_quaternion(q)
    out[:3, 3] = (1 - t) * ref_pose[:3, 3] + t * src_pose[:3, 3]
    return out
