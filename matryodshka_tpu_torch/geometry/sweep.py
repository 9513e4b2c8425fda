"""ODS sphere-sweep volumes by gather (the general-pose reference path).

Counterpart of `matryodshka_tpu/geometry/sweep.py`. Channel layout: a
sweep of a 3-channel image over P planes is [B, H, W, P*3] with plane-major
RGB triples; the double sweep concatenates the ref eye's volume then the
src eye's. The identity-pose hot path is `ops/sweep.py`.
"""

from __future__ import annotations

import torch

from matryodshka_tpu_torch.geometry import cameras, grids
from matryodshka_tpu_torch.ops.resample import resample_layers


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


def ods_sphere_sweep(image, order: int, depths, pose, intrinsics):
    """ODS sphere sweep of a batch: image [B, H, W, C], depths [P],
    pose [B, 4, 4], intrinsics [B, 3, 3] -> [B, H, W, P*C] float32."""
    b, h, w, c = image.shape
    p = depths.shape[0]
    vols = []
    for i in range(b):
        uv = ods_sweep_coords(h, w, order, depths, pose[i], intrinsics[i])
        vol = resample_layers(image[i][None].expand(p, h, w, c), uv)
        vols.append(vol.permute(1, 2, 0, 3).reshape(h, w, p * c))
    return torch.stack(vols)


#: format_network_input calls in this process (the gather sweeps; the
#: trainer's jittered forward makes one a step).
gather_sweeps = 0


def format_network_input(ref_image, src_image, ref_pose, src_pose,
                         ref_pose_inv, depths, intrinsics,
                         jitter_pose_inv=None):
    """Double ODS sweep: ref eye (order +1) then src eye (order -1), each
    with sweep pose pose @ ref_pose_inv, or pose @ ref_pose_inv @
    jitter_pose_inv [B, 4, 4] for the transform-inverse regularizer's
    jittered forward (JAX sweep.py:143-145). Returns [B, H, W, 2*P*3]."""
    global gather_sweeps
    gather_sweeps += 1
    if jitter_pose_inv is not None:
        ref_pose_inv = torch.einsum("bij,bjk->bik", ref_pose_inv,
                                    jitter_pose_inv)
    vols = []
    for img, pose, order in ((ref_image, ref_pose, 1),
                             (src_image, src_pose, -1)):
        cur_pose = torch.einsum("bij,bjk->bik", pose, ref_pose_inv)
        vols.append(ods_sphere_sweep(img, order, depths, cur_pose,
                                     intrinsics))
    return torch.cat(vols, dim=-1)
