"""blend_psv's render of a novel view from the sweep volume and the net's
prediction (the video request's last stage).

The MSI's shell p holds colour w fg + (1 - w) bg, with fg and bg the ref and
src eyes' sweeps at that shell, w = (pred[p] + 1) / 2 the blend weight and
alpha (pred[P + p] + 1) / 2. The view samples every shell where its rays
meet it (bilinear, wrapping) and composites back to front: sum_i c_i a_i T_i
with T_i = prod_{j > i} (1 - a_j) and the farthest shell's alpha taken as 1.
"""

from __future__ import annotations

import torch

from msi_bench.reference.geometry import bilinear, shell_lookup


def blend_layers(vol, pred):
    """vol [2*P*3, H, W], pred [2P, H, W] -> RGBA shells [P, H, W, 4]."""
    _, h, w = vol.shape
    p = pred.shape[0] // 2
    v6 = vol.float().reshape(2, p, 3, h, w)
    wgt = ((pred[:p].float() + 1.0) / 2.0)[:, None]
    alpha = (pred[p:2 * p].float() + 1.0) / 2.0
    rgb = wgt * v6[0] + (1.0 - wgt) * v6[1]
    return torch.cat([rgb, alpha[:, None]], dim=1).permute(0, 2, 3, 1)


def transmittance(alpha):
    """T_i = prod_{j > i} (1 - a_j) over axis 0 (T_{P-1} = 1)."""
    rev = torch.cumprod(torch.flip(1.0 - alpha, [0]), dim=0)
    t = torch.flip(rev, [0])
    return torch.cat([t[1:], torch.ones_like(t[:1])], dim=0)


def composite(proj):
    """Back-to-front over-composite of [P, H, W, 4] -> [H, W, 3]."""
    alpha = proj[..., 3:]
    eff = torch.cat([torch.ones_like(alpha[:1]), alpha[1:]], dim=0)
    return torch.sum(proj[..., :3] * eff * transmittance(alpha), dim=0)


def render_view(vol, pred, rot, pos, radii):
    """One view [H, W, 3] float32 in [-1, 1] from vol [2*P*3, H, W], pred
    [2P, H, W], rot [4, 4], pos [3], radii [P]."""
    _, h, w = vol.shape
    u, v = shell_lookup(rot, pos, radii, h, w)
    return composite(bilinear(blend_layers(vol, pred), u, v))
