"""Stereo Magnification's planar geometry (Zhou et al., SIGGRAPH 2018; the
upstream `geometry/homography.py` and `geometry/projector.py`): the plane
sweep by inverse warps and the warp of an MPI layer by its plane-induced
homography. One example at a time, float32.

Pixel centres sit at integer coordinates over [0, W-1] x [0, H-1]: the
upstream documents this half-pixel offset as a known bug
(projector.py:336-342) and keeps it, and so does this reference, for
parity. Sampling is bilinear, each of the four taps counted only where it
lies inside the image (zeros outside), as `tf.contrib.resampler` does.
"""

from __future__ import annotations

import torch


def pixel_grid(h: int, w: int, device=None):
    """[3, H*W] homogeneous pixel centres (x, y, 1), row by row."""
    y, x = torch.meshgrid(torch.arange(h, device=device, dtype=torch.float32),
                          torch.arange(w, device=device, dtype=torch.float32),
                          indexing="ij")
    return torch.stack([x.reshape(-1), y.reshape(-1),
                        torch.ones(h * w, device=device)])


def sample_zero(img, x, y):
    """img [H, W, C] sampled bilinearly at (x, y), each [N] pixels, taps
    outside the image counting zero -> [N, C] float32."""
    h, w, c = img.shape
    flat = img.reshape(h * w, c).float()
    x0, y0 = torch.floor(x), torch.floor(y)
    out = torch.zeros((x.shape[0], c), device=img.device)
    for dx, dy in ((0, 0), (1, 0), (0, 1), (1, 1)):
        xi, yi = x0 + dx, y0 + dy
        wgt = (1.0 - (x - xi).abs()) * (1.0 - (y - yi).abs())
        inside = (xi >= 0) & (xi <= w - 1) & (yi >= 0) & (yi <= h - 1)
        idx = (yi.clamp(0, h - 1) * w + xi.clamp(0, w - 1)).long()
        out += torch.where(inside, wgt, torch.zeros_like(wgt))[:, None] \
            * flat[idx]
    return out


def sweep_plane(img, depth: float, pose, k):
    """The inverse warp of img [H, W, C] onto the target camera's
    fronto-parallel plane at depth: each target pixel is lifted to depth
    along its ray (K^-1 [x, y, 1] depth), moved by pose [4, 4] (target to
    source) and projected by k [3, 3] into img (the upstream's
    pixel2cam / cam2pixel, 1e-10 added to the projected depth) ->
    [H, W, C]."""
    h, w, c = img.shape
    cam = torch.linalg.inv(k) @ pixel_grid(h, w, img.device) * depth
    src = k @ (pose[:3, :3] @ cam + pose[:3, 3:])
    x = src[0] / (src[2] + 1e-10)
    y = src[1] / (src[2] + 1e-10)
    return sample_zero(img, x, y).reshape(h, w, c)


def plane_sweep(img, depths, pose, k):
    """The plane-sweep volume of img [H, W, 3] at depths [P]: [P*3, H, W],
    plane p's colour in channels [3p, 3p + 3)."""
    return torch.cat([sweep_plane(img, float(d), pose, k).permute(2, 0, 1)
                      for d in depths])


def plane_homography(k, pose, depth: float):
    """The homography from target to source pixels through the source
    camera's plane z = depth (n = (0, 0, 1), a = -depth), with pose [4, 4]
    from source to target and the same k [3, 3] for both cameras
    (geometry/homography.py:35-58):
    K (R^T + R^T t n R^T / (a - n R^T t)) K^-1."""
    rot_t = pose[:3, :3].T
    t = pose[:3, 3:]
    n = torch.tensor([[0.0, 0.0, 1.0]], device=pose.device)
    denom = -depth - (n @ rot_t @ t)
    return k @ (rot_t + (rot_t @ t @ n @ rot_t) / denom) @ torch.linalg.inv(k)


def warp_layer(layer, k, pose, depth: float):
    """The MPI layer [H, W, C] at depth seen from the target camera at pose
    (source to target): each target pixel's source pixel by the plane's
    homography -> [H, W, C]."""
    h, w, c = layer.shape
    src = plane_homography(k, pose, depth) @ pixel_grid(h, w, layer.device)
    return sample_zero(layer, src[0] / src[2], src[1] / src[2]).reshape(
        h, w, c)
