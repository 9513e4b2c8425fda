"""The blend-fused render's work on these inputs. Compositing front to
back stops once the transmittance falls below EPS, so a (pixel, shell)
sample is needed only where the nearer shells, sampled at their own
lookups, leave at least EPS of the ray: `visited` counts those on the
stage's own prediction. Per needed sample: the ray's hit on the shell and
its angles (~40 f32 operations), four taps of 8 values (6 volume channels,
the blend weight and the alpha) weighted and summed (64), the blend (9) and
the composite (8). Bytes: the needed share of the volume and of the
prediction read once, the view written once. A batch's share is the mean
of its views'."""

import torch

from msi_bench.reference.geometry import bilinear, shell_lookup

EPS = 1e-6
OPS_PER_SAMPLE = 40 + 64 + 9 + 8


def visited(alpha, rot, pos, radii):
    """Share of (pixel, shell) samples front-to-back compositing needs:
    alpha [P, H, W] at source pixels, shell P-1 the nearest."""
    p, h, w = alpha.shape
    u, v = shell_lookup(rot, pos, radii, h, w)
    a = bilinear(alpha[..., None].float(), u, v)[..., 0].flip(0)
    trans = torch.cumprod(1.0 - a, dim=0)
    reached = torch.cat([torch.ones_like(trans[:1]),
                         (trans[:-1] >= EPS).float()])
    return reached.mean().item()


def count(ctx):
    io = ctx.driver.stage_io
    vol, pred = io["vol"], io["pred"]
    b, _, h, w = vol.shape
    p = pred.shape[1] // 2
    share = sum(visited((pred[i, p:2 * p] + 1.0) / 2.0, io["rot"][i],
                        io["pos"][i], io["msi_depths"])
                for i in range(b)) / b
    nbytes = (share * (vol.numel() * vol.element_size()
                       + pred.numel() * pred.element_size())
              + b * h * w * 3 * 4)
    return share * OPS_PER_SAMPLE * b * p * h * w, nbytes, "f32"
