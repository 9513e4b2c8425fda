"""The identity-pose dual-eye ODS sphere sweep: the net's input.

For each shell depth d and eye (ref = order +1, src = order -1), every
pixel of the ERP grid is put on the sphere of radius d and sampled from the
eye's ODS image through its tangent ray, bilinearly with wrap-around. With
identity poses a row's samples are one horizontal shift of the image row:
u(col) = u0 - col (mod W) and v is constant along the row, so each (plane,
row) needs one projection, taken at the first of a few probe columns whose
projection is not parked by float32 cancellation. Where the sphere lies
inside the viewing circle (d cos(lat) < r) the point has no tangent ray and
takes the image's pixel (1, 1), as the upstream parks it.

Output: [B, 2*P*3, H, W], channel (eye*P + p)*3 + c.
"""

from __future__ import annotations

import torch

from msi_bench.reference.geometry import lat_long_grid, project_ods, ray_dirs


def _probe_columns(w: int):
    cols = [0, w // 4, w // 2, (3 * w) // 4]
    cols += [(2 * k + 1) * w // 8 for k in range(4)]
    cols += [(2 * k + 1) * w // 16 for k in range(8)]
    return list(dict.fromkeys(c % w for c in cols))


def row_params(order: int, depths, r, h: int, w: int):
    """Per (plane, row): integer taps y0, y1, x0 and weights fy, fx, and
    valid (the sphere reaches outside the viewing circle)."""
    S, T = lat_long_grid(h, w, depths.device, depths.dtype)
    cols = _probe_columns(w)
    dx, dy, dz = ray_dirs(S[:, cols], T[:, cols])
    d = depths[:, None, None]
    u, v = project_ods(d * dx, d * dy, d * dz, order, r, w, h)
    parked = (u == 1.0) & (v == 1.0)
    colv = torch.tensor(cols, dtype=u.dtype, device=u.device)
    u0c = torch.remainder(u + colv, w)
    first = torch.argmax((~parked).to(torch.int32), dim=-1, keepdim=True)
    u0 = torch.gather(u0c, -1, first)[..., 0]
    v = torch.gather(v, -1, first)[..., 0]
    valid = depths[:, None] * torch.cos(T[None, :, 0]) >= r
    y0f, x0f = torch.floor(v), torch.floor(u0)
    y0 = torch.remainder(y0f.long(), h)
    return {"y0": y0, "y1": torch.remainder(y0 + 1, h), "fy": v - y0f,
            "x0": torch.remainder(x0f.long(), w), "fx": u0 - x0f,
            "valid": valid}


def sweep(ref, src, depths, r):
    """ref, src [B, H, W, 3] float32 in [0, 1]; depths [P]; r the rig
    radius (metres) -> float32 [B, 2*P*3, H, W] in [-1, 1]."""
    b, h, w, c = ref.shape
    p = depths.shape[0]
    r = torch.as_tensor(r, dtype=torch.float32, device=ref.device)
    outs = []
    for i in range(b):
        eyes = []
        for img, order in ((ref[i], 1), (src[i], -1)):
            img = img.float() * 2.0 - 1.0                  # [H, W, 3]
            prm = row_params(order, depths, r, h, w)
            j = torch.arange(w, device=img.device)
            xa = torch.remainder(prm["x0"][..., None] - j, w)   # [P, H, W]
            xb = torch.remainder(xa + 1, w)
            ya = prm["y0"][..., None].expand_as(xa)
            yb = prm["y1"][..., None].expand_as(xa)
            flat = img.reshape(h * w, c)

            def tap(yy, xx, flat=flat):
                return flat[yy * w + xx]                    # [P, H, W, 3]

            fy = prm["fy"][..., None, None]
            fx = prm["fx"][..., None, None]
            va = (1.0 - fy) * tap(ya, xa) + fy * tap(yb, xa)
            vb = (1.0 - fy) * tap(ya, xb) + fy * tap(yb, xb)
            val = (1.0 - fx) * va + fx * vb
            val = torch.where(prm["valid"][..., None, None], val, img[1, 1])
            eyes.append(val.permute(0, 3, 1, 2))            # [P, 3, H, W]
        outs.append(torch.stack(eyes).reshape(2 * p * c, h, w))
    return torch.stack(outs)
