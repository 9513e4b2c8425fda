"""The subset of `MatryConfig` that the ported inference path reads.

Field names and defaults are those of `matryodshka_tpu/config.py`, so a
configuration moves between the two packages by keyword.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

#: Colour-prediction schemes the port accepts. The other three of the
#: reference (blend_bg, blend_bg_psv, alpha_only) are not ported yet.
COLOR_PREDS = ("blend_psv",)


@dataclass(frozen=True)
class MatryConfig:
    height: int = 320
    width: int = 640
    batch_size: int = 1
    ngf: int = 64
    min_depth: float = 1.0
    max_depth: float = 100.0
    num_psv_planes: int = 32
    num_msi_planes: int = 32
    which_color_pred: str = "blend_psv"
    compute_dtype: str = "bfloat16"

    @property
    def torch_compute_dtype(self) -> torch.dtype:
        return getattr(torch, self.compute_dtype)

    def num_net_outputs(self) -> int:
        """Net channels for the colour scheme: P blend weights + P alphas."""
        if self.which_color_pred == "blend_psv":
            return 2 * self.num_msi_planes
        raise ValueError(
            f"which_color_pred {self.which_color_pred!r} is not ported; "
            f"supported: {COLOR_PREDS}")

    def num_net_inputs(self) -> int:
        """Channels of the double sphere-sweep volume (ODS input)."""
        return 2 * self.num_psv_planes * 3

    def validate(self) -> "MatryConfig":
        if self.which_color_pred not in COLOR_PREDS:
            raise ValueError(
                f"which_color_pred {self.which_color_pred!r} is not ported; "
                f"supported: {COLOR_PREDS}")
        if self.compute_dtype not in ("bfloat16", "float32"):
            raise ValueError(f"compute_dtype {self.compute_dtype!r}")
        if self.height % 8 or self.width % 8:
            raise ValueError("U-Net has 3 stride-2 stages; H and W must be "
                             "multiples of 8")
        return self
