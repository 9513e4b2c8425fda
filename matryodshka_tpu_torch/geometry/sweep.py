"""Sweep volumes by gather: the ODS sphere sweep (the general-pose
reference path), the GCN's sweep at icosphere vertices, the perspective
plane sweep of the PP input and the RealEstate input's homography plane
sweeps.

Counterpart of `matryodshka_tpu/geometry/sweep.py`. Channel layout: a
sweep of a 3-channel image over P planes is [B, H, W, P*3] with plane-major
RGB triples; the double sweep concatenates the ref eye's volume then the
src eye's. The identity-pose ODS hot path is `ops/sweep.py`.

The perspective sweep applies its pose once: the JAX package's
`perspective_plane_sweep` moves the points by the pose and then projects
them with K @ pose, applying it twice, while its MPI render and its
RealEstate sweep apply the same pose chain once; the port follows those
(a reference fault not inherited, ROADMAP Queue 3).
"""

from __future__ import annotations

import torch

from matryodshka_tpu_torch.geometry import cameras, grids, homography
from matryodshka_tpu_torch.ops.resample import (bilinear_wrap_resample,
                                                resample_layers,
                                                resample_stack)


def inv_depths(start_depth: float, end_depth: float, num_depths: int):
    """Inverse-depth-uniform samples, both endpoints included, sorted far to
    near. Returns a list of floats."""
    inv_start = 1.0 / start_depth
    inv_end = 1.0 / end_depth
    depths = [start_depth, end_depth]
    for i in range(1, num_depths - 1):
        fraction = float(i) / float(num_depths - 1)
        depths.append(1.0 / (inv_start + (inv_end - inv_start) * fraction))
    return sorted(depths)[::-1]


def ods_sweep_coords(h: int, w: int, order: int, depths, pose, intrinsics):
    """Lookup coordinates of one example's sweep: [P, H, W, 2]."""
    S, T = grids.lat_long_grid((h, w), device=depths.device)
    points = cameras.backproject_spherical(S, T, depths)
    points = cameras.apply_pose(points, pose)
    return cameras.project_ods(points, order, intrinsics, w, h)


def centered_sweep_coords(h: int, w: int, depths, pose):
    """Lookup coordinates of one example's centred sphere sweep
    [P, H, W, 2]: the sphere points moved by pose, projected into a
    centred ERP camera (cameras.project_spherical)."""
    S, T = grids.lat_long_grid((h, w), device=depths.device)
    points = cameras.backproject_spherical(S, T, depths)
    return cameras.project_spherical(cameras.apply_pose(points, pose), w, h)


def _sphere_sweep(image, depths, coords):
    """image [B, H, W, C] resampled at coords(i) [P, H, W, 2] of each
    example i -> [B, H, W, P*C] float32."""
    b, h, w, c = image.shape
    p = depths.shape[0]
    vols = []
    for i in range(b):
        vol = resample_layers(image[i][None].expand(p, h, w, c), coords(i))
        vols.append(vol.permute(1, 2, 0, 3).reshape(h, w, p * c))
    return torch.stack(vols)


def ods_sphere_sweep(image, order: int, depths, pose, intrinsics):
    """ODS sphere sweep of a batch: image [B, H, W, C], depths [P],
    pose [B, 4, 4], intrinsics [B, 3, 3] -> [B, H, W, P*C] float32."""
    _, h, w, _ = image.shape
    return _sphere_sweep(image, depths, lambda i: ods_sweep_coords(
        h, w, order, depths, pose[i], intrinsics[i]))


def ods_centered_sphere_sweep(image, order: int, depths, pose, intrinsics):
    """Sphere sweep with a centred (non-ODS) spherical projection (JAX
    sweep.py:77-85, projector.py:213-215; the reference's sweep_ref): the
    arguments of ods_sphere_sweep, of which the projection reads neither
    order nor intrinsics -> [B, H, W, P*C] float32. A gather, as in the
    JAX package with use_pallas=False."""
    del order, intrinsics
    _, h, w, _ = image.shape
    return _sphere_sweep(image, depths, lambda i: centered_sweep_coords(
        h, w, depths, pose[i]))


def perspective_sweep_coords(h: int, w: int, depths, pose, intrinsics):
    """Lookup coordinates of one example's perspective sweep [P, H, W, 2]:
    fronto-parallel planes through the UV grid, moved by pose, projected
    by K (the pose applied once)."""
    U, V = grids.uv_grid((h, w), device=depths.device)
    points = cameras.backproject_planar(U, V, depths, intrinsics)
    return cameras.project_perspective(cameras.apply_pose(points, pose),
                                       intrinsics)


def perspective_plane_sweep(image, depths, pose, intrinsics):
    """Fronto-parallel plane sweep of a batch with pinhole projection
    (projector.py:221-223), resampled with wrap-around as the JAX package
    resamples it: image [B, H, W, C], depths [P], pose [B, 4, 4],
    intrinsics [B, 3, 3] -> [B, H, W, P*C] float32. Each example's P
    planes are one gather."""
    b, h, w, c = image.shape
    p = depths.shape[0]
    vols = [bilinear_wrap_resample(image[i], perspective_sweep_coords(
        h, w, depths, pose[i], intrinsics[i])) for i in range(b)]
    return torch.stack(vols).permute(0, 2, 3, 1, 4).reshape(b, h, w, p * c)


def gcn_sphere_sweep(image, order: int, depths, coords, intrinsics):
    """The sphere sweep sampled at icosphere vertices (JAX sweep.py:99-130,
    projector.py:172-207): image [B, H, W, C], depths [P], coords [V, 3]
    unit vertex positions, intrinsics [B, 3, 3] -> [B, V, P*C] float32,
    plane-major per vertex. As in the JAX function the vertices are not
    moved by the eye's pose (its project_ods does not read the pose), and
    y is negated as the reference does for packed vertex tensors."""
    b, h, w, c = image.shape
    p = depths.shape[0]
    pts = depths[:, None, None] * coords.T[None]              # [P, 3, V]
    vols = []
    for i in range(b):
        uv = cameras.project_ods((pts[:, 0, :, None], pts[:, 1, :, None],
                                  pts[:, 2, :, None]), order, intrinsics[i],
                                 w, h, negate_y=True)         # [P, V, 1, 2]
        vol = resample_stack(image[i], uv, wrap=True)         # [P, V, 1, C]
        vols.append(vol[:, :, 0, :].permute(1, 0, 2).reshape(-1, p * c))
    return torch.stack(vols)


#: format_network_input and format_realestate_network_input calls in this
#: process (the gather sweeps: the trainer's jittered forward makes one a
#: step, and every PP or RealEstate forward one).
gather_sweeps = 0


def format_network_input(ref_image, src_image, ref_pose, src_pose,
                         ref_pose_inv, depths, intrinsics,
                         input_type: str = "ODS", jitter_pose_inv=None):
    """Double sweep: ref (ODS eye order +1) then src (order -1), each with
    sweep pose pose @ ref_pose_inv, or pose @ ref_pose_inv @
    jitter_pose_inv [B, 4, 4] for the transform-inverse regularizer's
    jittered forward (JAX sweep.py:143-145); the ODS sphere sweep, or for
    input_type PP the perspective plane sweep. Returns [B, H, W, 2*P*3]."""
    global gather_sweeps
    gather_sweeps += 1
    if jitter_pose_inv is not None:
        ref_pose_inv = torch.einsum("bij,bjk->bik", ref_pose_inv,
                                    jitter_pose_inv)
    vols = []
    for img, pose, order in ((ref_image, ref_pose, 1),
                             (src_image, src_pose, -1)):
        cur_pose = torch.einsum("bij,bjk->bik", pose, ref_pose_inv)
        if input_type == "ODS":
            vols.append(ods_sphere_sweep(img, order, depths, cur_pose,
                                         intrinsics))
        else:
            vols.append(perspective_plane_sweep(img, depths, cur_pose,
                                                intrinsics))
    return torch.cat(vols, dim=-1)


def format_realestate_network_input(ref_image, src_image, ref_pose,
                                    src_pose, depths, intrinsics,
                                    jitter_pose_inv=None):
    """RealEstate10K MPI input (msi.py:1024-1059): the ref image, then the
    homography plane sweeps of ref and src at pose @ inv(ref_pose)
    [@ jitter_pose_inv] -> [B, H, W, 3 + 2*P*3]. As in the JAX package,
    the inverse is taken here; the batch's ref_pose_inv is not read."""
    global gather_sweeps
    gather_sweeps += 1
    ref_pose_inv = torch.linalg.inv(ref_pose)
    if jitter_pose_inv is not None:
        ref_pose_inv = torch.einsum("bij,bjk->bik", ref_pose_inv,
                                    jitter_pose_inv)
    parts = [ref_image.float()]
    for pose, img in ((ref_pose, ref_image), (src_pose, src_image)):
        cur_pose = torch.einsum("bij,bjk->bik", pose, ref_pose_inv)
        parts.append(homography.plane_sweep(img, depths, cur_pose,
                                            intrinsics))
    return torch.cat(parts, dim=-1)
