"""The subset of `MatryConfig` that the ported inference and training
paths read.

Field names and defaults are those of `matryodshka_tpu/config.py`, so a
configuration moves between the two packages by keyword, and the test and
train CLIs take the same `--<field>` flags. `validate` refuses the values
whose code is not ported yet, naming the ROADMAP item that brings it.
"""

from __future__ import annotations

import argparse
import dataclasses
from dataclasses import dataclass, field
from typing import Optional

import torch

#: Colour-prediction schemes (the reference's scheme table,
#: matryodshka/msi.py:108-118).
COLOR_PREDS = ("blend_psv", "blend_bg", "blend_bg_psv", "alpha_only")
#: Input types the port accepts. PP and REALESTATE_PP need the MPI render
#: and the homography path (ROADMAP Queue 1 item 5).
INPUT_TYPES = ("ODS",)
LOSSES = ("pixel", "elpips")


@dataclass(frozen=True)
class MatryConfig:
    # --- i/o (the CLIs) ---------------------------------------------------
    cameras_glob: str = "glob/train/ods/*.txt"
    image_dir: str = "train_640x320"
    hres_image_dir: str = "train_4096x2048"
    checkpoint_dir: str = "checkpoints"
    experiment_name: str = ""
    output_root: str = "./test"
    shuffle_seq_length: int = 3
    random_seed: int = 8964

    # --- training hyper-parameters ------------------------------------------
    learning_rate: float = 2e-4
    beta1: float = 0.9
    max_steps: int = 10_000_000
    summary_freq: int = 50
    save_latest_freq: int = 2000
    continue_train: bool = False

    # --- image geometry -----------------------------------------------------
    height: int = 320
    width: int = 640
    hres_height: int = 2048
    hres_width: int = 4096
    batch_size: int = 1

    # --- model --------------------------------------------------------------
    input_type: str = "ODS"
    which_color_pred: str = "blend_psv"
    #: The U-Net variant: False is the wrap net (ERP wrap padding), True
    #: the coord net of the released checkpoints (SAME zero padding and an
    #: |sin(lat)| channel before every conv).
    coord_net: bool = False
    ngf: int = 64
    min_depth: float = 1.0
    max_depth: float = 100.0
    num_psv_planes: int = 32
    num_msi_planes: int = 32
    transform_inverse_reg: bool = False

    # --- loss ---------------------------------------------------------------
    which_loss: str = "pixel"           # pixel | elpips
    spherical_attention: bool = False
    wreg: bool = False
    supervision: str = "tgt"            # '_'-joined: tgt, ref, src, hrestgt
    rot_factor: float = 1.0
    tr_factor: float = 1.0

    # --- GCN variant ----------------------------------------------------------
    gcn: bool = False

    # --- elpips ---------------------------------------------------------------
    elpips_weight_path: Optional[str] = field(default=None, metadata={
        "help": "npz with the E-LPIPS conv ('net/...', HWIO) and linear "
                "('lin/...') weights; without one the features are random "
                "and every metrics record says elpips_calibrated: false"})
    elpips_average_over: int = 1
    elpips_host_scale: bool = field(default=False, metadata={
        "help": "parsed for the JAX package's flags and ignored: the "
                "port's E-LPIPS draws (scale, swap) on the host at every "
                "step and evaluates that level alone"})

    # --- numerics / parallelism -------------------------------------------------
    compute_dtype: str = "bfloat16"
    remat_network: bool = False
    shard_shells: bool = False

    @property
    def supervise_tgt(self) -> bool:
        return "tgt" in self.supervision

    @property
    def torch_compute_dtype(self) -> torch.dtype:
        return getattr(torch, self.compute_dtype)

    @property
    def net_variant(self) -> str:
        return "coord" if self.coord_net else "wrap"

    def num_net_outputs(self) -> int:
        """Net channels for the colour scheme (msi.py:108-118): P blend
        weights and P alphas (blend_psv), plus a background RGB (blend_bg),
        plus P background blend weights (blend_bg_psv); P alphas only
        (alpha_only)."""
        p = self.num_msi_planes
        return {"blend_psv": 2 * p, "blend_bg": 2 * p + 3,
                "blend_bg_psv": 3 * p + 3,
                "alpha_only": p}[self.which_color_pred]

    def num_net_inputs(self) -> int:
        """Channels of the double sphere-sweep volume (ODS input)."""
        return 2 * self.num_psv_planes * 3

    def validate(self) -> "MatryConfig":
        if self.which_color_pred not in COLOR_PREDS:
            raise ValueError(
                f"which_color_pred {self.which_color_pred!r}; known: "
                f"{COLOR_PREDS}")
        if self.input_type not in INPUT_TYPES:
            raise ValueError(
                f"input_type {self.input_type!r} is not ported (PP and "
                f"REALESTATE_PP wait for the MPI render and the homography "
                f"path, ROADMAP Queue 1 item 5); supported: {INPUT_TYPES}")
        if self.num_msi_planes != self.num_psv_planes:
            raise ValueError("the port's renders pair shell p with sweep "
                             "plane p: num_msi_planes must equal "
                             "num_psv_planes")
        if self.compute_dtype not in ("bfloat16", "float32"):
            raise ValueError(f"compute_dtype {self.compute_dtype!r}")
        if self.height % 8 or self.width % 8:
            raise ValueError("U-Net has 3 stride-2 stages; H and W must be "
                             "multiples of 8")
        if self.which_loss not in LOSSES:
            raise ValueError(f"which_loss {self.which_loss!r}; known: "
                             f"{LOSSES}")
        if self.elpips_average_over < 1:
            raise ValueError("elpips_average_over must be at least 1")
        check_trainable(self)
        return self


def check_trainable(cfg: MatryConfig) -> None:
    """Raise NotImplementedError, naming the ROADMAP item, for a training
    option whose code is not ported yet."""
    parts = cfg.supervision.split("_")
    unported = [
        (cfg.gcn, "gcn: the GCN is ROADMAP Queue 1 item 8"),
        ("hrestgt" in parts, "supervision hrestgt: the high-res target "
         "render in training is left of ROADMAP Queue 1 item 6"),
        ("src" in parts or "ref" in parts, "supervision src/ref: the ODS "
         "eye re-render (render_ods_view) is left of ROADMAP Queue 1 item "
         "6"),
        (cfg.transform_inverse_reg, "transform_inverse_reg is left of "
         "ROADMAP Queue 1 item 6"),
        (cfg.rot_factor != 1.0 or cfg.tr_factor != 1.0, "rot_factor and "
         "tr_factor scale transform_inverse_reg's pose jitter, left of "
         "ROADMAP Queue 1 item 6"),
        (cfg.remat_network, "remat_network is left of ROADMAP Queue 1 item "
         "6"),
    ]
    for bad, msg in unported:
        if bad:
            raise NotImplementedError(msg)


def add_config_args(parser: argparse.ArgumentParser) -> None:
    """Register one --flag per MatryConfig field."""
    for f in dataclasses.fields(MatryConfig):
        help_ = f.metadata.get("help")
        if isinstance(f.default, bool):
            parser.add_argument(
                "--" + f.name, metavar="BOOL", default=f.default,
                type=lambda s: s.lower() in ("1", "true", "yes"), help=help_)
        else:
            parser.add_argument(
                "--" + f.name, default=f.default, help=help_,
                type=str if f.default is None else type(f.default))


def config_from_args(args: argparse.Namespace) -> MatryConfig:
    names = {f.name for f in dataclasses.fields(MatryConfig)}
    return MatryConfig(**{k: v for k, v in vars(args).items()
                          if k in names}).validate()
