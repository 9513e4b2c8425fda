"""Export entry point (the reference's export.py), net only.

    python -m matryodshka_tpu_torch.cli.export --coord_net true \
        --net_only true [--experiment_name NAME] [--export_dir DIR] \
        [--export_name NAME] [--platform cuda|cpu] [--clip_to_fp16]

Counterpart of `matryodshka_tpu/cli/export.py`, which serialises the
net-only function as StableHLO with `jax.export`. Here the same function,
`plane_sweep_input` [1, H, W, 2P*3] (NHWC, float32: the reference's frozen
graph interface, nets.py:310) -> `msi_output`, the 8-row channel atlas of
the first min(64, K) prediction channels (models/unet.py:atlas_pack), is
serialised with `torch.export` to `{export_dir}/{export_name}.pt2`, beside
`{export_name}.meta.json` (the JAX CLI's keys: step, net_only, platform,
interface, config). `torch.export.load` reads it back without this package;
`matryodshka_tpu_torch/tools/consume_export.py` does so.

The weights are the latest checkpoint under
<checkpoint_dir>/<experiment_name> (the trainer's); with none, a warning
and seeded weights (weights.seeded_init(cfg, 0)), as the JAX CLI exports
fresh ones. `--platform` is the device the program is exported for:
`cuda` (the default; without a card that raises) or `cpu`.

The exported net is the plain MSIUNet (cuDNN convs on the card), not the
conv.cu kernel route: the JAX export runs `model.apply` with
use_pallas_conv=False (JAX training/state.py:31-33), so its program holds
no Pallas kernel either, and the kernels, launched through ctypes, could
not enter a serialised graph that loads without the port. The
full-pipeline export (`--net_only false`) and `--with_preprocess` raise
NotImplementedError: on the card the pipeline's sweep is the K1 kernel,
which a serialised program would have to carry as a registered custom op
(ROADMAP Queue 1 item 10b).
"""

from __future__ import annotations

import argparse
import json
import os
import warnings

import numpy as np
import torch
from torch import nn

from matryodshka_tpu_torch import weights
from matryodshka_tpu_torch.config import (MatryConfig, add_config_args,
                                          config_from_args)
from matryodshka_tpu_torch.models.unet import MSIUNet, atlas_pack
from matryodshka_tpu_torch.training.checkpoint import CheckpointManager

FP16_MAX = float(np.finfo(np.float16).max)


def clip_params_to_fp16(tree):
    """Clip every leaf of a flax parameter tree into the fp16 range
    (export.py:311-321, for runtimes that run the net in fp16)."""
    if isinstance(tree, dict):
        return {k: clip_params_to_fp16(v) for k, v in tree.items()}
    return np.clip(tree, -FP16_MAX, FP16_MAX)


class NetOnly(nn.Module):
    """plane_sweep_input [1, H, W, 2P*3] float32 -> msi_output atlas
    [1, 8H, (C/8) W] float32, C = min(64, cfg.num_net_outputs())."""

    def __init__(self, cfg: MatryConfig, net: MSIUNet):
        super().__init__()
        self.net = net
        self.height, self.width = cfg.height, cfg.width
        self.channels = min(64, cfg.num_net_outputs())

    def forward(self, plane_sweep_input):
        pred = self.net(plane_sweep_input.permute(0, 3, 1, 2))
        return atlas_pack(pred.permute(0, 2, 3, 1), self.height, self.width,
                          self.channels)


def build_net_only_fn(cfg: MatryConfig, tree, device="cuda") -> NetOnly:
    """The net-only function of cfg's plain net with the flax parameter
    tree's weights, on device, in eval mode (JAX export.py:93-104)."""
    net = MSIUNet(cfg.num_net_inputs(), cfg.num_net_outputs(), cfg.ngf,
                  dtype=cfg.torch_compute_dtype, variant=cfg.net_variant)
    net.load_state_dict(weights.from_flax(tree))
    return NetOnly(cfg, net).to(device).eval()


def interface(cfg: MatryConfig):
    """The meta.json interface of the net-only program."""
    return {"inputs": {"plane_sweep_input":
                       [1, cfg.height, cfg.width, cfg.num_net_inputs()]},
            "outputs": {"msi_output": "8-row channel atlas"}}


def export_net_only(cfg: MatryConfig, tree, device="cuda"):
    """torch.export of build_net_only_fn on a float32 input of the
    interface's shape, without that example input."""
    fn = build_net_only_fn(cfg, tree, device)
    x = torch.zeros(interface(cfg)["inputs"]["plane_sweep_input"],
                    device=device)
    with torch.no_grad():
        program = torch.export.export(fn, (x,))
    # the program would keep its example input (157 MB at the flagship)
    program.example_inputs = None
    return program


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="matryodshka export (torch)")
    add_config_args(parser)
    parser.add_argument("--export_dir", type=str, default="export")
    parser.add_argument("--export_name", type=str, default="msi_model")
    parser.add_argument("--platform", type=str, default="cuda",
                        choices=["cuda", "cpu"],
                        help="the device the program is exported for")
    # the JAX CLI's input-processing options (export.py:33-115); they
    # serve the full-pipeline export, which is not ported
    parser.add_argument("--with_preprocess", action="store_true")
    parser.add_argument("--rgba", action="store_true")
    parser.add_argument("--flip_y", action="store_true")
    parser.add_argument("--flip_channels", action="store_true")
    parser.add_argument("--remap_ref", type=str, default=None)
    parser.add_argument("--remap_src", type=str, default=None)
    parser.add_argument("--padx", type=int, default=0)
    parser.add_argument("--pady", type=int, default=0)
    parser.add_argument("--pose1", type=str, default="")
    parser.add_argument("--pose2", type=str, default="")
    parser.add_argument("--clip_to_fp16", action="store_true")
    return parser


def main(argv=None):
    args = build_parser().parse_args(argv)
    cfg = config_from_args(args)
    if args.with_preprocess or not cfg.net_only:
        raise NotImplementedError(
            "the full-pipeline export (--net_only false) and "
            "--with_preprocess: the card's sweep kernel would have to enter "
            "the serialised program as a registered custom op (ROADMAP "
            "Queue 1 item 10b)")
    ckpt_dir = os.path.join(cfg.checkpoint_dir, cfg.experiment_name)
    try:
        if not os.path.isdir(ckpt_dir):
            raise FileNotFoundError(ckpt_dir)
        tree, step = CheckpointManager(ckpt_dir).restore_params()
        print(f"[export] restored checkpoint @ step {step}")
    except FileNotFoundError:
        tree, step = weights.seeded_init(cfg, 0), 0
        warnings.warn("[export] no checkpoint found; exporting seeded "
                      "weights")
    if args.clip_to_fp16:
        tree = clip_params_to_fp16(tree)

    program = export_net_only(cfg, tree, torch.device(args.platform))
    os.makedirs(args.export_dir, exist_ok=True)
    path = os.path.join(args.export_dir, f"{args.export_name}.pt2")
    torch.export.save(program, path)
    meta = {"step": int(step), "net_only": cfg.net_only,
            "platform": args.platform, "interface": interface(cfg),
            "config": {"height": cfg.height, "width": cfg.width,
                       "num_psv_planes": cfg.num_psv_planes,
                       "num_msi_planes": cfg.num_msi_planes,
                       "which_color_pred": cfg.which_color_pred,
                       "coord_net": cfg.coord_net}}
    with open(os.path.join(args.export_dir,
                           f"{args.export_name}.meta.json"), "w") as fh:
        json.dump(meta, fh, indent=2)
    print(f"[export] wrote {path} ({os.path.getsize(path)} bytes)")
    return path


if __name__ == "__main__":
    main()
