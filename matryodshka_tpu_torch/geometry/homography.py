"""The planar homography path of the PP and RealEstate10K inputs: the
plane-sweep volume by inverse warps and the MPI render by forward
homographies.

Counterpart of `matryodshka_tpu/geometry/homography.py` (the
stereo-magnification legacy of the reference: geometry/homography.py:35-157
and projector.py:343-499). Pixel centres sit at integer coordinates over
[0, W-1] x [0, H-1], the half-pixel convention the reference documents as a
known bug (projector.py:336-342), kept for parity. Sampling is bilinear
with zeros outside the image (`ops/resample.bilinear_zero_resample`).

Every function takes leading batch dimensions where the JAX one takes one
example, so a batch of P planes (or B examples of P planes) is one set of
matrix products and one gather; no loop runs over depths.
"""

from __future__ import annotations

import torch

from matryodshka_tpu_torch.geometry.render import over_composite
from matryodshka_tpu_torch.ops.resample import bilinear_zero_resample


def _divide_safe(num, den, eps: float = 1e-8):
    """num / den, with eps added to the denominators that are exactly 0."""
    return num / (den + eps * (den == 0.0).to(num.dtype))


def inv_homography(k_s, k_t_inv, rot, t, n_hat, a):
    """The homography from target to source pixels through the plane
    n_hat . x + a = 0: k_s [..., 3, 3], k_t_inv [..., 3, 3], rot
    [..., 3, 3], t [..., 3, 1], n_hat [..., 1, 3], a [..., 1, 1] (any
    broadcast-common batch) -> [..., 3, 3]."""
    rot_t = rot.transpose(-1, -2)
    denom = a - n_hat @ rot_t @ t
    numerator = rot_t @ t @ n_hat @ rot_t
    return k_s @ (rot_t + _divide_safe(numerator, denom)) @ k_t_inv


def transform_points(points, homography):
    """[..., H, W, 3] homogeneous points through [..., 3, 3] homographies
    (one per leading index) -> [..., H, W, 3]."""
    batch = homography.shape[:-2]
    out = points.reshape(*batch, -1, 3) @ homography.transpose(-1, -2)
    return out.reshape(points.shape)


def normalize_homogeneous(points):
    """[..., 3] -> [..., 2]: (u, v) / w, a zero w divided as 1e-8."""
    return _divide_safe(points[..., :-1], points[..., -1:])


def meshgrid_abs(height: int, width: int, device=None,
                 dtype=torch.float32):
    """[3, H, W] homogeneous pixel grid (x, y, 1), centres at integers
    (projector.py:478-499)."""
    ys = torch.linspace(0.0, height - 1.0, height, device=device,
                        dtype=dtype)
    xs = torch.linspace(0.0, width - 1.0, width, device=device, dtype=dtype)
    Y, X = torch.meshgrid(ys, xs, indexing="ij")
    return torch.stack([X, Y, torch.ones_like(X)])


def planar_transform(imgs, k_s, k_t_inv, rot, t, n_hat, a):
    """Warp layer p of imgs [..., P, H, W, C] into the target frame by the
    homography of its plane: k_s, k_t_inv, rot [..., 3, 3], t [..., 3, 1],
    n_hat [..., P, 1, 3], a [..., P, 1, 1] -> [..., P, H, W, C] float32."""
    h, w = imgs.shape[-3], imgs.shape[-2]
    hom = inv_homography(k_s[..., None, :, :], k_t_inv[..., None, :, :],
                         rot[..., None, :, :], t[..., None, :, :], n_hat, a)
    grid = meshgrid_abs(h, w, imgs.device, hom.dtype).permute(1, 2, 0)
    grid = grid.expand(*hom.shape[:-2], h, w, 3)
    return bilinear_zero_resample(
        imgs, normalize_homogeneous(transform_points(grid, hom)))


def projective_forward_homography(src_images, intrinsics, intrinsics_inv,
                                  pose, depths):
    """Forward-warp MPI layers src_images [..., P, H, W, C] into the view
    at pose [..., 4, 4] (source to target), plane p at depth depths[p]
    (n_hat = +z, a = -depth; projector.py:343-373)."""
    p = depths.shape[0]
    n_hat = torch.tensor([[0.0, 0.0, 1.0]], dtype=depths.dtype,
                         device=depths.device).expand(p, 1, 3)
    return planar_transform(src_images, intrinsics, intrinsics_inv,
                            pose[..., :3, :3], pose[..., :3, 3:], n_hat,
                            -depths.reshape(p, 1, 1))


def inverse_warp_coords(height: int, width: int, depths, pose, intrinsics,
                        intrinsics_inv):
    """Source pixel coordinates of the target pixels backprojected to
    depths [P] and moved by pose [..., 4, 4] (target to source):
    [..., P, H, W, 2] (projector.py:397-433, pixel2cam / cam2pixel)."""
    grid = meshgrid_abs(height, width, depths.device,
                        intrinsics_inv.dtype).reshape(3, -1)
    cam = (intrinsics_inv @ grid)[..., None, :, :] * depths[:, None, None]
    cam_h = torch.cat([cam, torch.ones_like(cam[..., :1, :])], dim=-2)
    k4 = torch.zeros(*intrinsics.shape[:-2], 4, 4,
                     dtype=intrinsics.dtype, device=intrinsics.device)
    k4[..., :3, :3] = intrinsics
    k4[..., 3, 3] = 1.0
    pix = (k4 @ pose)[..., None, :, :] @ cam_h
    uv = pix[..., 0:2, :] / (pix[..., 2:3, :] + 1e-10)
    return uv.transpose(-1, -2).reshape(*uv.shape[:-2], height, width, 2)


def projective_inverse_warp(img, depth, pose, intrinsics, intrinsics_inv):
    """Inverse-warp one source image img [H, W, C] to the target's plane
    at depth (a scalar) -> [H, W, C] float32; pose [4, 4] target to
    source."""
    h, w = img.shape[0], img.shape[1]
    depth = torch.as_tensor(depth, dtype=torch.float32,
                            device=img.device).reshape(1)
    coords = inverse_warp_coords(h, w, depth, pose, intrinsics,
                                 intrinsics_inv)[0]
    return bilinear_zero_resample(img, coords)


def plane_sweep(image, depths, pose, intrinsics):
    """Plane-sweep volume of a batch by inverse homography warps: image
    [B, H, W, C], depths [P], pose [B, 4, 4] target to source, intrinsics
    [B, 3, 3] -> [B, H, W, P*C] float32, plane-major (projector.py:375-395)."""
    b, h, w, c = image.shape
    p = depths.shape[0]
    coords = inverse_warp_coords(h, w, depths, pose, intrinsics,
                                 torch.linalg.inv(intrinsics))
    vol = bilinear_zero_resample(image, coords)            # [B, P, H, W, C]
    return vol.permute(0, 2, 3, 1, 4).reshape(b, h, w, p * c)


def mpi_render_view(rgba_layers, tgt_pose, depths, intrinsics):
    """Perspective view of an MPI (msi.py:527-548): rgba_layers
    [..., H, W, P, 4], tgt_pose [..., 4, 4] (the layers' frame to the
    target's), depths [P], intrinsics [..., 3, 3] -> [..., H, W, 3]."""
    layers = rgba_layers.movedim(-2, -4)
    proj = projective_forward_homography(
        layers, intrinsics, torch.linalg.inv(intrinsics), tgt_pose, depths)
    return over_composite(proj.movedim(-4, -2))
