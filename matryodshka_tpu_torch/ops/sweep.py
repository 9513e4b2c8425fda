"""Identity-pose dual-eye ODS sweep: row parameters, kernel wrapper and its
plain version.

Counterpart of `matryodshka_tpu/ops/pallas_sweep.py` (`_row_params`,
`_ods_sweep_dual_stack`, `ods_sweep_identity_planar`). The kernel is
`csrc/sweep.cu`, which replaces `pallas_sweep._sweep_kernel`; its source
note gives the bound and the design. The output is the net's input,
channels first and unflipped: [B, 2*P*3, H, W], channel (eye*P + p)*3 + c.
"""

from __future__ import annotations

import torch

from matryodshka_tpu_torch.geometry import cameras, grids
from matryodshka_tpu_torch.ops import _build

#: Launches of the sweep kernel in this process.
launches = 0


def _probe_columns(width: int):
    """Columns at which the exact projection is evaluated per row: the four
    quarter columns first, then twelve more spread ones."""
    cols = [0, width // 4, width // 2, (3 * width) // 4]
    cols += [(2 * k + 1) * width // 8 for k in range(4)]
    cols += [(2 * k + 1) * width // 16 for k in range(8)]
    return list(dict.fromkeys(c % width for c in cols))


def row_params(order: int, depths, intrinsics, height: int, width: int):
    """Per-(plane, row) sweep parameters, each [P, H].

    v and u0 come from cameras.project_ods at a few probe columns, taking
    the first column that is not parked at (1, 1): f32 cancellation in the
    tangent quadratic can park single pixels of a valid row ("park-flip
    noise"), and u0 = u(c) + c (mod W) holds at any column c. Validity is
    the analytic rho = depth * cos(lat) >= r. Returns int32 y0, y1, x0
    (vertical taps and the horizontal base: column j samples
    x0 - j (mod W) and the next one), float32 fy, fx, and int32 valid.
    """
    S, T = grids.lat_long_grid((height, width), device=depths.device)
    cols = _probe_columns(width)
    pts = cameras.backproject_spherical(S[:, cols], T[:, cols], depths)
    uv = cameras.project_ods(pts, order, intrinsics, width, height)
    uc, vc = uv[..., 0], uv[..., 1]
    parked = (uc == 1.0) & (vc == 1.0)
    colv = torch.tensor(cols, dtype=uc.dtype, device=uc.device)
    u0c = torch.remainder(uc + colv, width)
    idx = torch.argmax((~parked).to(torch.int32), dim=-1, keepdim=True)
    u0 = torch.gather(u0c, -1, idx)[..., 0]
    v = torch.gather(vc, -1, idx)[..., 0]

    rho = depths[:, None] * torch.cos(T[None, :, 0])
    valid = rho >= intrinsics[0, 0]

    y0f = torch.floor(v)
    x0f = torch.floor(u0)
    y0 = torch.remainder(y0f.to(torch.int32), height)
    return {"y0": y0.to(torch.int32),
            "y1": torch.remainder(y0 + 1, height).to(torch.int32),
            "fy": (v - y0f).float(),
            "x0": torch.remainder(x0f.to(torch.int32), width).to(torch.int32),
            "fx": (u0 - x0f).float(),
            "valid": valid.to(torch.int32)}


def dual_row_params(depths, intrinsics, height: int, width: int):
    """Both eyes' parameters for a batch: intrinsics [B, 3, 3] -> dict of
    [B, 2, P, H] (eye 0 = ref, order +1; eye 1 = src, order -1)."""
    per_b = []
    for k in intrinsics:
        eyes = [row_params(o, depths, k, height, width) for o in (1, -1)]
        per_b.append({n: torch.stack([e[n] for e in eyes]) for n in eyes[0]})
    return {n: torch.stack([d[n] for d in per_b]).contiguous()
            for n in per_b[0]}


def ods_sweep_plain(images, params, out_dtype=torch.float32):
    """Plain version of the kernel. images [B, 2, 3, H, W] float32, params
    from dual_row_params -> [B, 2*P*3, H, W] out_dtype."""
    b, _, c, h, w = images.shape
    p = params["y0"].shape[2]
    j = torch.arange(w, device=images.device)
    xa = torch.remainder(params["x0"].long()[..., None] - j, w)
    xb = torch.remainder(xa + 1, w)
    ya = params["y0"].long()[..., None].expand_as(xa)
    yb = params["y1"].long()[..., None].expand_as(xa)
    flat = images.float().reshape(b, 2, c, h * w)

    def tap(y, x):                                   # -> [B, 2, P, C, H, W]
        idx = (y * w + x).reshape(b, 2, 1, -1).expand(-1, -1, c, -1)
        got = torch.gather(flat, 3, idx).reshape(b, 2, c, p, h, w)
        return got.transpose(2, 3)

    fy = params["fy"][:, :, :, None, :, None]
    fx = params["fx"][:, :, :, None, :, None]
    va = (1.0 - fy) * tap(ya, xa) + fy * tap(yb, xa)
    vb = (1.0 - fy) * tap(ya, xb) + fy * tap(yb, xb)
    out = (1.0 - fx) * va + fx * vb
    park = images[:, :, None, :, 1:2, 1:2].float()   # [B, 2, 1, C, 1, 1]
    valid = params["valid"][:, :, :, None, :, None] > 0
    out = torch.where(valid, out, park)
    return out.reshape(b, 2 * p * c, h, w).to(out_dtype)


def ods_sweep(images, params, out_dtype=torch.float32):
    """The dual-eye sweep: the CUDA kernel for CUDA tensors, the plain
    version for CPU tensors. Shapes as ods_sweep_plain."""
    if images.device.type == "cpu":
        return ods_sweep_plain(images, params, out_dtype)
    global launches
    req = _build.require
    req(images.is_cuda, f"ods_sweep: unsupported device {images.device}")
    b, e, c, h, w = images.shape
    p = params["y0"].shape[2]
    req(e == 2 and c == 3, f"ods_sweep: images {tuple(images.shape)}")
    req(images.dtype == torch.float32 and images.is_contiguous(),
        "ods_sweep: images must be contiguous float32")
    req(out_dtype in (torch.float32, torch.bfloat16),
        f"ods_sweep: out_dtype {out_dtype}")
    for name in ("y0", "y1", "x0", "fy", "fx", "valid"):
        t = params[name]
        want = torch.float32 if name in ("fy", "fx") else torch.int32
        req(t.device == images.device and t.dtype == want
            and t.is_contiguous() and tuple(t.shape) == (b, 2, p, h),
            f"ods_sweep: param {name} {t.dtype} {tuple(t.shape)}")
    out = torch.empty((b, 2 * p * c, h, w), dtype=out_dtype,
                      device=images.device)
    err = _build.lib().matry_sweep(
        images.data_ptr(), params["y0"].data_ptr(), params["y1"].data_ptr(),
        params["fy"].data_ptr(), params["x0"].data_ptr(),
        params["fx"].data_ptr(), params["valid"].data_ptr(), out.data_ptr(),
        b, p, h, w, int(out_dtype == torch.bfloat16),
        _build.stream_ptr(images.device))
    _build.check(err, "matry_sweep")
    launches += 1
    return out


def sweep_inputs(ref_image, src_image, depths, intrinsics):
    """The kernel's operands from preprocessed images ([B, H, W, 3] in
    [-1, 1]): (images [B, 2, 3, H, W] float32, dual_row_params)."""
    _, h, w, _ = ref_image.shape
    images = torch.stack([ref_image, src_image], dim=1)     # [B, 2, H, W, 3]
    images = images.permute(0, 1, 4, 2, 3).float().contiguous()
    return images, dual_row_params(depths, intrinsics, h, w)


def sweep_volume(ref_image, src_image, depths, intrinsics,
                 out_dtype=torch.float32):
    """Both eyes' identity-pose sweeps -> the net input [B, 2*P*3, H, W]."""
    images, params = sweep_inputs(ref_image, src_image, depths, intrinsics)
    return ods_sweep(images, params, out_dtype)
