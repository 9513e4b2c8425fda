"""The subset of `MatryConfig` that the ported inference and training
paths read.

Field names and defaults are those of `matryodshka_tpu/config.py`, so a
configuration moves between the two packages by keyword, and the test and
train CLIs take the same `--<field>` flags. `validate` refuses the values
whose code is not ported yet, naming the ROADMAP item that brings it, and
the combinations that the JAX trainer cannot run either, naming why.
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
#: Input types: ODS stereo pairs (sphere sweep, MSI render), Replica
#: perspective pairs (PP: perspective plane sweep, MPI render) and
#: RealEstate10K clips (REALESTATE_PP: the ref image and homography plane
#: sweeps, MPI render).
INPUT_TYPES = ("ODS", "PP", "REALESTATE_PP")
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
    operation: str = "train"            # train | export
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
    #: The GCN head on an icosphere of subdiv subdivisions (models/gcn.py)
    #: in place of the U-Net; its mesh is cached under mesh_dir.
    gcn: bool = False
    subdiv: int = 7
    mesh_dir: str = "glob/train/gcn"

    # --- elpips ---------------------------------------------------------------
    elpips_weight_path: Optional[str] = field(default=None, metadata={
        "help": "npz with the E-LPIPS conv ('net/...', HWIO) and linear "
                "('lin/...') weights; without one the features are random "
                "and every metrics record says elpips_calibrated: false"})
    elpips_average_over: int = 1
    elpips_host_scale: bool = field(default=False, metadata={
        "help": "parsed for the JAX package's flags and ignored: the "
                "port's E-LPIPS draws (scale, swap) on the host at every "
                "step, each of the chained steps of --steps_per_call "
                "included, and evaluates that level alone"})

    # --- numerics / parallelism -------------------------------------------------
    compute_dtype: str = "bfloat16"
    #: The trainer's parameter dtype, and so its Adam moments' (JAX
    #: training/state.py:35).
    param_dtype: str = "float32"
    #: False takes the routes the JAX package takes without Pallas: the
    #: gather sweep and PyTorch convs in the trainer, the gather sweep,
    #: the plain net and the gather renders in the test CLI; none of the
    #: port's kernels runs.
    use_pallas: bool = True
    #: Recompute the U-Net's activations in the backward pass
    #: (torch.utils.checkpoint; JAX step.py:76-81).
    remat_network: bool = False
    #: Data-parallel ranks of the trainer (parallel/dp.py: one process a
    #: rank, the gradients summed over ranks); batch_size is the global
    #: batch and must divide evenly across them.
    num_data_shards: int = 1
    #: The test CLI's high-res re-render split into contiguous shell
    #: blocks over the ranks of a process group (parallel/sharded_render.py);
    #: ignored in a single process, as the JAX CLI ignores it on one device.
    shard_shells: bool = False

    # --- export -------------------------------------------------------------
    net_only: bool = False
    #: Nearest 2x upsampling and a 4x4 conv in place of each transposed
    #: conv (models/unet.py; JAX training/state.py:30 passes it).
    smoothed: bool = False

    @property
    def supervise_tgt(self) -> bool:
        return "tgt" in self.supervision

    @property
    def supervise_hrestgt(self) -> bool:
        return "hrestgt" in self.supervision

    @property
    def supervise_src(self) -> bool:
        return "src" in self.supervision

    @property
    def supervise_ref(self) -> bool:
        return "ref" in self.supervision

    @property
    def torch_compute_dtype(self) -> torch.dtype:
        return getattr(torch, self.compute_dtype)

    @property
    def torch_param_dtype(self) -> torch.dtype:
        return getattr(torch, self.param_dtype)

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
        """Channels of the net input: the double sweep volume, after the
        ref image's 3 channels for REALESTATE_PP (msi.py:1024-1059)."""
        if self.input_type == "REALESTATE_PP":
            return 3 + 2 * self.num_psv_planes * 3
        return 2 * self.num_psv_planes * 3

    def validate(self) -> "MatryConfig":
        if self.which_color_pred not in COLOR_PREDS:
            raise ValueError(
                f"which_color_pred {self.which_color_pred!r}; known: "
                f"{COLOR_PREDS}")
        if self.input_type not in INPUT_TYPES:
            raise ValueError(f"input_type {self.input_type!r}; known: "
                             f"{INPUT_TYPES}")
        if self.num_msi_planes != self.num_psv_planes:
            raise ValueError("the port's renders pair shell p with sweep "
                             "plane p: num_msi_planes must equal "
                             "num_psv_planes")
        for name in ("compute_dtype", "param_dtype"):
            if getattr(self, name) not in ("bfloat16", "float32"):
                raise ValueError(f"{name} {getattr(self, name)!r}; known: "
                                 f"bfloat16, float32")
        if self.height % 8 or self.width % 8:
            raise ValueError("U-Net has 3 stride-2 stages; H and W must be "
                             "multiples of 8")
        if self.which_loss not in LOSSES:
            raise ValueError(f"which_loss {self.which_loss!r}; known: "
                             f"{LOSSES}")
        if self.elpips_average_over < 1:
            raise ValueError("elpips_average_over must be at least 1")
        if self.supervise_hrestgt and self.spherical_attention:
            raise ValueError(
                "spherical_attention with hrestgt supervision: the JAX train "
                "step forms the latitude map at (height, width) "
                "(step.py:58-59) and multiplies the (hres_height, "
                "hres_width) render by it (step.py:130-134), which does not "
                "broadcast; the JAX package has no high-res latitude map")
        if self.supervise_hrestgt and self.input_type != "ODS":
            raise ValueError(
                f"hrestgt supervision with input_type {self.input_type}: "
                f"the high-res target is an ODS render (JAX step.py:130), "
                f"and the PP and RealEstate loaders read no high-res images")
        if self.num_data_shards < 1 or self.batch_size % self.num_data_shards:
            raise ValueError(
                f"batch_size {self.batch_size} must divide evenly across "
                f"num_data_shards {self.num_data_shards} data shards (JAX "
                f"cli/train.py:253-254)")
        if self.gcn:
            check_gcn(self)
        return self


def check_gcn(cfg: MatryConfig) -> None:
    """Raise ValueError for what the GCN cannot train, as the JAX package
    cannot either: the transform-inverse regularizer (JAX step.py:84-87:
    the reference jitters only the CNN path), the high-res target (JAX
    infer_gcn_msi makes no high-res layers) and input other than ODS (the
    GCN's vertex sweep projects ODS eyes)."""
    if cfg.transform_inverse_reg:
        raise ValueError("gcn with transform_inverse_reg: the GCN path does "
                         "not support the transform-inverse regularizer "
                         "(JAX training/step.py:84-87; the reference "
                         "jitters only the CNN path)")
    if cfg.supervise_hrestgt:
        raise ValueError("gcn with hrestgt supervision: JAX infer_gcn_msi "
                         "makes no high-res layers")
    if cfg.input_type != "ODS":
        raise ValueError(f"gcn with input_type {cfg.input_type}: the GCN's "
                         f"vertex sweep projects ODS eyes")


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
