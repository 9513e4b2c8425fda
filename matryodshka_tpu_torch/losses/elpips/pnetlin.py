"""LPIPS core: feature differences weighted by learned 1x1 linear layers.

Counterpart of `matryodshka_tpu/losses/elpips/pnetlin.py` (the
reference's elpips/elpips/pnetlin.py:29-181), on NCHW images:
  * inputs standardized by the LPIPS shift/scale constants
  * per-tap unit-normalization along channels
  * squared differences against the reference image
  * spatial mean, then the learned per-channel linear weight, summed over
    channels and taps.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch
from torch import nn

from matryodshka_tpu_torch.losses.elpips.networks import Dropout

SHIFT = np.asarray([-0.030, -0.088, -0.188], np.float32)
SCALE = np.asarray([0.458, 0.448, 0.450], np.float32)


def normalize_tensor(feat: torch.Tensor, eps: float = 1e-10
                     ) -> torch.Tensor:
    """feat / (its L2 norm over channels + eps); feat [N, C, H, W]."""
    norm = torch.sqrt(torch.sum(torch.square(feat), dim=1, keepdim=True))
    return feat / (norm + eps)


class PNetLin(nn.Module):
    """net: a feature tower (networks.py); lin_weights: {'lin{i}.model.1.
    weight': [C_i] (or the reference's [1, 1, C_i, 1])} per tap."""

    def __init__(self, net: nn.Module, lin_weights: Dict[str, np.ndarray]):
        super().__init__()
        self.net = net
        self.n_taps = len(lin_weights)
        for i in range(self.n_taps):
            w = torch.as_tensor(np.asarray(
                lin_weights[f"lin{i}.model.1.weight"], np.float32))
            self.register_buffer(f"lin{i}", w.reshape(-1))
        self.register_buffer("shift",
                             torch.from_numpy(SHIFT).view(1, 3, 1, 1))
        self.register_buffer("scale",
                             torch.from_numpy(SCALE).view(1, 3, 1, 1))

    def forward(self, in0: Tuple[torch.Tensor, ...], in1: torch.Tensor,
                dropout: Dropout = None) -> Tuple[torch.Tensor, ...]:
        """in0: tuple of [N, 3, H, W] candidates; in1: [N, 3, H, W]
        reference. Returns a tuple of [N] distances."""
        xs = tuple((x - self.shift) / self.scale for x in in0 + (in1,))
        taps = self.net(xs, dropout)
        vals = [torch.zeros(in1.shape[0], device=in1.device)
                for _ in in0]
        for i, tap in enumerate(taps):
            normed = tuple(normalize_tensor(t) for t in tap)
            w = getattr(self, f"lin{i}")
            for j in range(len(in0)):
                mean = torch.square(normed[j] - normed[-1]).mean(dim=(2, 3))
                vals[j] = vals[j] + torch.sum(mean * w, dim=-1)
        return tuple(vals)
