"""The high-res re-render (the test CLI's `--test_type high_res_only`; the
upstream `test.py` high-res path): a 4096x2048 view from a 640x320
prediction.

Shell by shell, nearest first: both eyes' sweep at the shell's depth at the
high resolution (`sweep.sweep`), the low-res blend weight and alpha upsampled
bilinearly with aligned corners, blend_psv's colour w fg + (1 - w) bg with
that alpha, the shell sampled where the target's rays meet it, and the
front-to-back composite of the colour and of the depth proxy (shell i
carries i / P; the farthest shell's alpha is taken as 1). The radii are the
sweep's depths. `q`, where given, rounds the shell's RGBA as the program
stores its layer stack.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from msi_bench.reference.geometry import bilinear, shell_lookup
from msi_bench.reference.sweep import sweep


def hres_render(ref, src, blend, alphas, depths, r, pos, q=None):
    """ref, src [Hh, Wh, 3] in [0, 1]; blend, alphas [h, w, P] in (0, 1);
    depths [P]; r the rig radius; pos [3] -> (rgb [Hh, Wh, 3] in [0, 1],
    depth [Hh, Wh, 3]), float32."""
    hh, hw, _ = ref.shape
    p = depths.shape[0]
    q = q or (lambda t: t)
    eye = torch.eye(4, device=ref.device)
    rgb = torch.zeros((hh, hw, 3), device=ref.device)
    dep = torch.zeros((hh, hw, 1), device=ref.device)
    trans = torch.ones((hh, hw, 1), device=ref.device)
    for s in range(p - 1, -1, -1):
        d = depths[s:s + 1]
        vol = sweep(ref[None], src[None], d, r)[0]         # [6, Hh, Wh]
        low = torch.stack([blend[..., s], alphas[..., s]])[None].float()
        up = F.interpolate(low, size=(hh, hw), mode="bilinear",
                           align_corners=True)[0]          # [2, Hh, Wh]
        wgt = up[:1]
        col = wgt * vol[:3] + (1.0 - wgt) * vol[3:]
        layer = q(torch.cat([col, up[1:]]).permute(1, 2, 0))  # [Hh, Wh, 4]
        u, v = shell_lookup(eye, pos, d, hh, hw)
        smp = bilinear(layer[None], u, v)[0]
        a = smp[..., 3:] if s > 0 else torch.ones_like(trans)
        rgb += smp[..., :3] * a * trans
        dep += (s / p) * a * trans
        trans *= 1.0 - a
    return (rgb + 1.0) / 2.0, dep.expand(hh, hw, 3)
