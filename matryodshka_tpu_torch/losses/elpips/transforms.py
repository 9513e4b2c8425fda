"""E-LPIPS random input-transformation ensemble.

Counterpart of `matryodshka_tpu/losses/elpips/transforms.py` (the
reference's elpips/elpips/elpips.py:59-238), in eager torch on NCHW
images:

  * offset: random translate-by-pad (reflect) up to offset_max, per sample
  * scale: random downscale by box-averaging after reflect-padding to a
    multiple of the scale level (level drawn from a 1/i^2 prior)
  * flips / transpose: per-sample flip among {x, y, xy, none}; global swap
  * color permutation and color multiplication, per sample (stratified
    across the batch)

The draws come from an explicit torch.Generator on the CPU, so every
sampled value is a host value and a transform never waits on the card.
One seed gives other draws than jax.random; the tests replay the JAX
package's draws through `EnsembleParams`.
"""

from __future__ import annotations

import itertools
from typing import NamedTuple, Tuple

import numpy as np
import torch
import torch.nn.functional as F


class EnsembleParams(NamedTuple):
    offset_xy: torch.Tensor        # [N, 2] int64 in [0, offset_max]
    flips: torch.Tensor            # [N] int64 in {0, 1, 2, 3}
    swap_xy: int                   # 0 or 1
    color_factors: torch.Tensor    # [N, 3] float32
    permutations: torch.Tensor     # [N, 3] int64 colour permutation
    scale_offset_xy: torch.Tensor  # [2] int64 in [0, scale_level)
    scale_level: int               # in [1, num_scales]


def _randint(generator, high: int, size=()) -> torch.Tensor:
    return torch.randint(0, high, size, generator=generator)


def sample_ensemble(generator: torch.Generator, batch_size: int,
                    offset_max: int, scale_probabilities: Tuple[float, ...],
                    static_scale: int | None = None) -> EnsembleParams:
    """Sample one random transform set (elpips.py:59-118) from a CPU
    generator, with the JAX package's distributions: scale ~ the
    categorical of scale_probabilities, swap ~ Bernoulli(0.5), flips the
    stratified `arange % 4` permuted, colours stratified `(u + i) / n`
    permuted per channel and scaled to 0.2 + 0.8 c, permutations the six
    of range(3) tiled and permuted. static_scale, when given, replaces the
    drawn level (the other draws are the same either way)."""
    n = batch_size
    offset_xy = _randint(generator, offset_max + 1, (n, 2))

    cumsum = np.cumsum(np.asarray(scale_probabilities, np.float64))
    u = float(cumsum[-1]) * float(torch.rand((), generator=generator))
    level = 1 + int(np.sum(u >= cumsum[:-1]))
    scale_level = (min(max(level, 1), len(scale_probabilities))
                   if static_scale is None else int(static_scale))
    scale_offset_xy = _randint(generator, max(scale_level, 1), (2,))

    flips = torch.arange((n + 3) // 4 * 4) % 4
    flips = flips[torch.randperm(len(flips), generator=generator)][:n]

    swap_xy = int(_randint(generator, 2))

    def sample_colors():
        c = (torch.rand(n, generator=generator) + torch.arange(n)) / n
        return c[torch.randperm(n, generator=generator)]

    colors = torch.stack([sample_colors() for _ in range(3)], dim=-1)
    color_factors = 0.2 + 0.8 * colors

    perms = torch.tensor(list(itertools.permutations(range(3))))
    perms = perms.repeat((n + len(perms) - 1) // len(perms), 1)
    perms = perms[torch.randperm(len(perms), generator=generator)][:n]

    return EnsembleParams(offset_xy, flips, swap_xy, color_factors, perms,
                          scale_offset_xy, scale_level)


def sample_scale_swap_host(rng: np.random.RandomState, config) -> tuple:
    """(scale, swap) drawn on the host with the distribution of the
    ensemble's own draw: scale ~ categorical(scale_probabilities), swap ~
    Bernoulli(0.5) (the JAX package's `api.sample_scale_swap_host`).
    `sample_ensemble` draws both itself; this serves callers that pick
    the level apart from the other transforms."""
    if not config.enable_scale:
        scale = 1
    else:
        p = np.asarray(config.scale_probabilities, dtype=np.float64)
        scale = 1 + int(rng.choice(len(p), p=p / p.sum()))
    swap = bool(rng.randint(2)) if config.enable_swap else False
    return scale, swap


def downscale(x: torch.Tensor, scale: int,
              scale_offset_xy: torch.Tensor) -> torch.Tensor:
    """Reflect-pad by scale - 1, take the window of a multiple of `scale`
    starting at scale - 1 - scale_offset_xy (clamped into the padded
    image, as lax.dynamic_slice clamps), then box-average (elpips.py:
    132-171, pad branch). x: [N, C, H, W]. The average sums each box in
    row-major order and multiplies by 1 / scale^2, the order in which
    XLA's mean rounds on the CPU, so the two packages agree bit for
    bit."""
    if scale == 1:
        return x
    n, c, h, w = x.shape
    s = scale - 1
    full_h = (s + h + s) // scale * scale
    full_w = (s + w + s) // scale * scale
    xp = F.pad(x, (s, s, s, s), mode="reflect")
    off_y, off_x = (int(v) for v in scale_offset_xy)
    y0 = min(max(s - off_y, 0), h + 2 * s - full_h)
    x0 = min(max(s - off_x, 0), w + 2 * s - full_w)
    win = xp[:, :, y0:y0 + full_h, x0:x0 + full_w].reshape(
        n, c, full_h // scale, scale, full_w // scale, scale)
    total = win[:, :, :, 0, :, 0]
    for k in range(1, scale * scale):
        total = total + win[:, :, :, k // scale, :, k % scale]
    return total * (1.0 / (scale * scale))


def apply_offset(x: torch.Tensor, offset_xy: torch.Tensor,
                 offset_max: int) -> torch.Tensor:
    """Per-sample reflect-pad translation (elpips.py:174-197): sample i is
    the window at offset_xy[i] of its reflect-padded copy. Output is
    [N, C, H + offset_max, W + offset_max]."""
    h, w = x.shape[2:]
    xp = F.pad(x, (offset_max,) * 4, mode="reflect")
    return torch.stack([xp[i, :, oy:oy + h + offset_max,
                           ox:ox + w + offset_max]
                        for i, (oy, ox) in enumerate(offset_xy.tolist())])


#: Image dims each flip code reverses: 0 flips x, 1 flips y, 2 both,
#: 3 none.
_FLIP_DIMS = {0: (2,), 1: (1,), 2: (1, 2), 3: ()}


def apply_flips_swap_color(x: torch.Tensor, params: EnsembleParams,
                           swap: bool) -> torch.Tensor:
    """Per-sample flip, then the transpose of H and W when swap, then each
    sample's colour permutation (channel c <- channel perm[c]) and colour
    factors (elpips.py:199-238)."""
    out = []
    for i, code in enumerate(params.flips.tolist()):
        t = x[i]
        if _FLIP_DIMS[code]:
            t = torch.flip(t, _FLIP_DIMS[code])
        if swap:
            t = t.transpose(1, 2)
        t = t[params.permutations[i].to(t.device)]
        out.append(t * params.color_factors[i].to(t).view(3, 1, 1))
    return torch.stack(out)


def apply_ensemble(x: torch.Tensor, params: EnsembleParams, scale: int,
                   offset_max: int, enable_offset: bool = True,
                   enable_scale: bool = True,
                   swap: bool = False) -> torch.Tensor:
    """The full sampled ensemble at (scale, swap)."""
    if enable_scale:
        x = downscale(x, scale, params.scale_offset_xy)
    if enable_offset:
        x = apply_offset(x, params.offset_xy, offset_max)
    return apply_flips_swap_color(x, params, swap)
