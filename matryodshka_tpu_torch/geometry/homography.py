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


def _mat3(a, b):
    """a @ b for [..., 3, 3] matrices as three products summed in order,
    (a_0 b_0 + a_1 b_1) + a_2 b_2: each operation rounds once, so a
    kernel that takes the same steps gets the same bits."""
    return (a[..., :, 0:1] * b[..., 0:1, :] + a[..., :, 1:2] * b[..., 1:2, :]
            + a[..., :, 2:3] * b[..., 2:3, :])


def mpi_homographies(intrinsics, intrinsics_inv, pose, depths):
    """The forward homographies of MPI planes at depths [P] into the view at
    pose [..., 4, 4] (source to target) -> [..., P, 3, 3]: the JAX
    package's inv_homography with n_hat = +z and a = -depth
    (projector.py:343-373),
    K (R^T + (R^T t)(n R^T) / (a - n R^T t)) K^-1, where n R^T is R's
    last column and n R^T t the last entry of R^T t. Every step is one
    elementwise operation in a fixed order (no matmul, whose sums have no
    fixed order), the steps of csrc/mpi_render.cu's homography_entry,
    so that the kernel and this plain route warp by the same matrices bit
    for bit."""
    rot, t = pose[..., :3, :3], pose[..., :3, 3]
    rtt = (rot[..., 0, :] * t[..., 0:1] + rot[..., 1, :] * t[..., 1:2]
           + rot[..., 2, :] * t[..., 2:3])                    # [..., 3]
    den = -depths - rtt[..., 2:3]                             # [..., P]
    num = rtt[..., :, None] * rot[..., None, :, 2]            # [..., 3, 3]
    m = (rot.transpose(-1, -2)[..., None, :, :]
         + _divide_safe(num[..., None, :, :], den[..., None, None]))
    return _mat3(_mat3(intrinsics[..., None, :, :], m),
                 intrinsics_inv[..., None, :, :])


def projective_forward_homography(src_images, intrinsics, intrinsics_inv,
                                  pose, depths):
    """Forward-warp MPI layers src_images [..., P, H, W, C] into the view
    at pose [..., 4, 4] (source to target), plane p at depth depths[p]
    (mpi_homographies) -> [..., P, H, W, C] float32."""
    hom = mpi_homographies(intrinsics, intrinsics_inv, pose, depths)
    h, w = src_images.shape[-3], src_images.shape[-2]
    grid = meshgrid_abs(h, w, src_images.device, hom.dtype).permute(1, 2, 0)
    grid = grid.expand(*hom.shape[:-2], h, w, 3)
    return bilinear_zero_resample(
        src_images, normalize_homogeneous(transform_points(grid, hom)))


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
