"""The control's rounding: float8 e4m3 with one scale a tensor.

The configurations state bfloat16 storage; the nearest precision below it is
fp8. A tensor is scaled so that its largest magnitude maps to e4m3's largest
finite value (448), rounded to e4m3 and scaled back, as an fp8 path with
per-tensor scales stores it.
"""

from __future__ import annotations

import torch

E4M3_MAX = 448.0


def fp8(t):
    t = t.float()
    scale = E4M3_MAX / t.abs().amax().clamp(min=1e-30)
    return (t * scale).to(torch.float8_e4m3fn).float() / scale
