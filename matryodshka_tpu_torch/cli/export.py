"""Export entry point (the reference's export.py).

    python -m matryodshka_tpu_torch.cli.export --coord_net true \
        [--net_only true] [--experiment_name NAME] [--export_dir DIR] \
        [--export_name NAME] [--platform cuda|cpu] [--clip_to_fp16] \
        [--with_preprocess [--rgba] [--flip_y] [--flip_channels] \
         [--remap_ref F.npy] [--remap_src F.npy] [--padx N] [--pady N] \
         [--pose1 '12 values'] [--pose2 '12 values']]

Counterpart of `matryodshka_tpu/cli/export.py`, which serialises its
functions as StableHLO with `jax.export`. Here the same functions are
serialised with `torch.export` to `{export_dir}/{export_name}.pt2`, beside
`{export_name}.meta.json` (the JAX CLI's keys: step, net_only, platform,
interface, config):

* `--net_only true`: `plane_sweep_input` [1, H, W, 2P*3] (NHWC, float32:
  the reference's frozen graph interface, nets.py:310) -> `msi_output`,
  the 8-row channel atlas of the first min(64, K) prediction channels
  (models/unet.py:atlas_pack);
* `--net_only false` (the full pipeline, JAX export.py:106-121, 220-236):
  ref/src images [1, H, W, 3] float32 in [0, 1], ref/src poses and the
  inverse ref pose [1, 4, 4], intrinsics [1, 3, 3] -> `rgba_layers`
  [1, H, W, P, 4] in the compute dtype: the sweep, the net and the
  assembly;
* `--with_preprocess` (with `--net_only false`, JAX export.py:167-208):
  the full pipeline behind two flat uint8 buffers [H*W*C] (C = 4 with
  `--rgba`), each decoded by `make_image_processor` (RGB slice, the
  optional `.npy` remap warp, the flips, the padding, a crop to a multiple
  of 16), with the fixed flag poses (`pose_from_flag`) and the ODS
  intrinsics baked in.

Every program loads without this package:
`matryodshka_tpu_torch/tools/consume_export.py` reads it importing
neither package. The full pipeline's sweep is K1 (csrc/sweep.cu), which
enters the program as the custom op `matry::sweep_volume`, registered in
C++ (csrc/sweep_op.cpp) in the op library `ops/_build.op_library()`
builds: on the card one launch a call, on the CPU its plain version. main
copies that library beside the `.pt2`, and the program's meta.json adds
`custom_ops` (the ops it carries) and `op_library` (the library's file
name, relative to the `.pt2`'s directory): the process that loads the
program loads that library first (`torch.ops.load_library`), and needs
no module of the port. The sweep is the identity-pose
ODS sweep, as the JAX package's Pallas route runs it (JAX
sweep.py:147-158): the full program accepts the JAX interface's poses and
does not read them, and `--with_preprocess` refuses flag poses whose
relative pose pose2 @ inv(pose1) is not the identity.

The weights are the latest checkpoint under
<checkpoint_dir>/<experiment_name> (the trainer's); with none, a warning
and seeded weights (weights.seeded_init(cfg, 0)), as the JAX CLI exports
fresh ones. `--platform` is the device the program is exported for:
`cuda` (the default; without a card that raises) or `cpu`.

The exported net is the plain MSIUNet in the compute dtype (cuDNN convs
on the card), not the conv.cu kernel route: the JAX export runs
`model.apply` with use_pallas_conv=False (JAX training/state.py:31-33), so
its program holds no net kernel either; the assembly is the plain
assemble_rgba, as in JAX infer_msi.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import warnings

import numpy as np
import torch
from torch import nn

from matryodshka_tpu_torch import weights
from matryodshka_tpu_torch.config import (MatryConfig, add_config_args,
                                          config_from_args)
from matryodshka_tpu_torch.geometry.sweep import inv_depths
from matryodshka_tpu_torch.models import msi as msi_lib
from matryodshka_tpu_torch.models.unet import MSIUNet, atlas_pack
from matryodshka_tpu_torch.ops import _build
from matryodshka_tpu_torch.ops import sweep as sweep_ops
from matryodshka_tpu_torch.ops.resample import bilinear_zero_resample
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


def _plain_net(cfg: MatryConfig, tree) -> MSIUNet:
    net = MSIUNet(cfg.num_net_inputs(), cfg.num_net_outputs(), cfg.ngf,
                  dtype=cfg.torch_compute_dtype, variant=cfg.net_variant,
                  smoothed=cfg.smoothed)
    net.load_state_dict(weights.from_flax(tree))
    return net


def build_net_only_fn(cfg: MatryConfig, tree, device="cuda") -> NetOnly:
    """The net-only function of cfg's plain net with the flax parameter
    tree's weights, on device, in eval mode (JAX export.py:93-104)."""
    return NetOnly(cfg, _plain_net(cfg, tree)).to(device).eval()


class FullPipeline(nn.Module):
    """ref/src images [B, H, W, 3] float32 in [0, 1] + poses + intrinsics
    -> rgba_layers [B, H, W, P, 4] in the compute dtype (JAX
    export.py:106-121: infer_msi). The sweep is the custom op
    matry::sweep_volume (K1) at the PSV depths, the net the plain MSIUNet,
    the assembly assemble_rgba. The poses are those of the JAX interface;
    the identity-pose sweep does not read them."""

    def __init__(self, cfg: MatryConfig, net: MSIUNet):
        super().__init__()
        self.net = net
        self.which_color_pred = cfg.which_color_pred
        self.num_planes = cfg.num_msi_planes
        self.out_dtype = cfg.torch_compute_dtype
        self.register_buffer("psv_depths", torch.tensor(
            inv_depths(cfg.min_depth, cfg.max_depth, cfg.num_psv_planes),
            dtype=torch.float32))

    def forward(self, ref_image, src_image, ref_pose, src_pose,
                ref_pose_inv, intrinsics):
        del ref_pose, src_pose, ref_pose_inv
        vol = sweep_ops.sweep_volume_op(
            ref_image.contiguous(), src_image.contiguous(), self.psv_depths,
            intrinsics.contiguous(), self.out_dtype)
        pred = self.net(vol)
        return msi_lib.assemble_rgba(
            self.which_color_pred, pred.permute(0, 2, 3, 1),
            vol.permute(0, 2, 3, 1), self.num_planes)["rgba_layers"]


def build_full_fn(cfg: MatryConfig, tree, device="cuda") -> FullPipeline:
    """The full pipeline with the flax parameter tree's weights, on
    device, in eval mode."""
    return FullPipeline(cfg, _plain_net(cfg, tree)).to(device).eval()


def crop_to_multiple(image, size: int):
    """Crop [H, W, C] to multiples of size, the odd pixel of the margin
    taken on the right and bottom (JAX export.py:34-41)."""
    h, w = image.shape[0], image.shape[1]
    left = (w % size) // 2
    top = (h % size) // 2
    return image[top:top + h - (h % size), left:left + w - (w % size), :]


class ImageProcessor(nn.Module):
    """A flat uint8 buffer [H*W*C] -> the image [H', W', 3] float32 in
    [0, 1] (JAX export.py:43-73): the RGB channels, the remap warp
    (bilinear_zero_resample at a [H', W', 2] (x, y) field), the y and
    channel flips, the padding, the crop to a multiple of 16."""

    def __init__(self, height: int, width: int, channels: int, padx: int,
                 pady: int, flip_y: bool, flip_channels: bool, remap=None):
        super().__init__()
        self.shape = (height, width, channels)
        self.padx, self.pady = padx, pady
        self.flip_y, self.flip_channels = flip_y, flip_channels
        self.register_buffer("remap", None if remap is None else
                             torch.as_tensor(remap, dtype=torch.float32))

    def forward(self, raw):
        img = raw.reshape(self.shape)[:, :, :3].float() / 255.0
        if self.remap is not None:
            img = bilinear_zero_resample(img, self.remap)
        if self.flip_y:
            img = img.flip(0)
        if self.flip_channels:
            img = img.flip(2)
        img = nn.functional.pad(img, (0, 0, self.padx, self.padx, self.pady,
                                      self.pady))
        return crop_to_multiple(img, 16)


def make_image_processor(cfg: MatryConfig, height: int, width: int,
                         channels: int, padx: int, pady: int, flip_y: bool,
                         flip_channels: bool,
                         remap_file=None) -> ImageProcessor:
    """JAX make_image_processor's arguments; remap_file: an .npy [H', W',
    2] coordinate field (e.g. fisheye -> ERP), or None."""
    del cfg
    remap = (None if not remap_file
             else np.load(remap_file).astype(np.float32))
    return ImageProcessor(height, width, channels, padx, pady, flip_y,
                          flip_channels, remap)


def pose_from_flag(flag: str) -> np.ndarray:
    """12 comma- or space-separated values -> a 4x4 float32 pose, the
    identity for an empty flag (JAX export.py:75-84)."""
    if flag:
        vals = [float(x) for x in flag.replace(",", " ").split()]
        if len(vals) != 12:
            raise ValueError(f"pose flag needs 12 values, got {len(vals)}")
        return np.asarray(vals + [0.0, 0.0, 0.0, 1.0],
                          np.float32).reshape(4, 4)
    return np.eye(4, dtype=np.float32)


#: The ODS intrinsics the preprocessed program bakes in (JAX export.py:
#: 185-187): the 0.032 m viewing-circle radius.
ODS_INTRINSICS = [[0.032, 0.0, 0.0], [0.0, 1.0, 0.0], [0.0, 0.0, 1.0]]


class PreprocessedPipeline(nn.Module):
    """Two flat uint8 buffers -> rgba_layers [1, H', W', P, 4]: each
    buffer through its ImageProcessor, then the full pipeline at the flag
    poses and the ODS intrinsics."""

    def __init__(self, proc_ref: ImageProcessor, proc_src: ImageProcessor,
                 inner: FullPipeline, pose1, pose2):
        super().__init__()
        self.proc_ref, self.proc_src, self.inner = proc_ref, proc_src, inner
        pose1 = torch.as_tensor(pose1, dtype=torch.float32)[None]
        self.register_buffer("pose1", pose1)
        self.register_buffer("pose2", torch.as_tensor(
            pose2, dtype=torch.float32)[None])
        self.register_buffer("pose1_inv",
                             torch.linalg.inv(pose1).contiguous())
        self.register_buffer("intrinsics", torch.tensor(ODS_INTRINSICS)[None])

    def forward(self, ref_raw, src_raw):
        return self.inner(self.proc_ref(ref_raw)[None],
                          self.proc_src(src_raw)[None], self.pose1,
                          self.pose2, self.pose1_inv, self.intrinsics)


def build_preprocessed_fn(cfg: MatryConfig, tree, args,
                          device="cuda") -> PreprocessedPipeline:
    """The --with_preprocess program's function from the CLI's args (rgba,
    padx, pady, flip_y, flip_channels, remap_ref, remap_src, pose1,
    pose2), on device, in eval mode."""
    channels = 4 if args.rgba else 3
    pose1, pose2 = pose_from_flag(args.pose1), pose_from_flag(args.pose2)
    rel = pose2.astype(np.float64) @ np.linalg.inv(pose1.astype(np.float64))
    if not np.allclose(rel, np.eye(4), rtol=0, atol=1e-6):
        raise ValueError(
            "--pose1/--pose2: the full pipeline's sweep is the identity-pose "
            "ODS sweep (K1), which reads no pose; flag poses whose relative "
            "pose pose2 @ inv(pose1) is not the identity would be ignored")
    procs = [make_image_processor(cfg, cfg.height, cfg.width, channels,
                                  args.padx, args.pady, args.flip_y,
                                  args.flip_channels, remap)
             for remap in (args.remap_ref, args.remap_src)]
    fn = PreprocessedPipeline(*procs, FullPipeline(cfg, _plain_net(cfg,
                                                                   tree)),
                              pose1, pose2)
    return fn.to(device).eval()


def processed_size(cfg: MatryConfig, args):
    """(H', W') of the preprocessed images: the remap field's size (or
    the buffer's), padded, cropped to multiples of 16."""
    h, w = cfg.height, cfg.width
    if args.remap_ref:
        h, w = np.load(args.remap_ref, mmap_mode="r").shape[:2]
    h, w = h + 2 * args.pady, w + 2 * args.padx
    return h - h % 16, w - w % 16


def interface(cfg: MatryConfig, args=None):
    """The meta.json interface of the program main exports for cfg (and,
    for --with_preprocess, args): the JAX CLI's, export.py:167-236; the
    preprocessed program's also names its inputs' dtype and its output's
    shape."""
    if args is not None and args.with_preprocess and not cfg.net_only:
        n_in = cfg.height * cfg.width * (4 if args.rgba else 3)
        h, w = processed_size(cfg, args)
        return {"inputs": {"ref_image": [n_in], "src_image": [n_in]},
                "input_dtypes": {"ref_image": "uint8", "src_image": "uint8"},
                "outputs": {"rgba_layers": [1, h, w, cfg.num_msi_planes,
                                            4]}}
    if cfg.net_only:
        return {"inputs": {"plane_sweep_input":
                           [1, cfg.height, cfg.width, cfg.num_net_inputs()]},
                "outputs": {"msi_output": "8-row channel atlas"}}
    image = [1, cfg.height, cfg.width, 3]
    return {"inputs": {"ref_image": image, "src_image": image,
                       "ref_pose": [1, 4, 4], "src_pose": [1, 4, 4],
                       "ref_pose_inv": [1, 4, 4], "intrinsics": [1, 3, 3]},
            "outputs": {"rgba_layers": [1, cfg.height, cfg.width,
                                        cfg.num_msi_planes, 4]}}


def _export(fn, example):
    with torch.no_grad():
        program = torch.export.export(fn, example)
    # the program would keep its example inputs (157 MB for the net-only
    # program at the flagship)
    program.example_inputs = None
    return program


def export_net_only(cfg: MatryConfig, tree, device="cuda"):
    """torch.export of build_net_only_fn on a float32 input of the
    interface's shape, without that example input."""
    x = torch.zeros(interface(cfg)["inputs"]["plane_sweep_input"],
                    device=device)
    return _export(build_net_only_fn(cfg, tree, device), (x,))


def export_full(cfg: MatryConfig, tree, device="cuda"):
    """torch.export of build_full_fn on float32 inputs of the interface's
    shapes."""
    example = tuple(torch.zeros(s, device=device)
                    for s in interface(cfg)["inputs"].values())
    return _export(build_full_fn(cfg, tree, device), example)


def export_preprocessed(cfg: MatryConfig, tree, args, device="cuda"):
    """torch.export of build_preprocessed_fn on two uint8 buffers."""
    example = tuple(torch.zeros(s, dtype=torch.uint8, device=device)
                    for s in interface(cfg, args)["inputs"].values())
    return _export(build_preprocessed_fn(cfg, tree, args, device), example)


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="matryodshka export (torch)")
    add_config_args(parser)
    parser.add_argument("--export_dir", type=str, default="export")
    parser.add_argument("--export_name", type=str, default="msi_model")
    parser.add_argument("--platform", type=str, default="cuda",
                        choices=["cuda", "cpu"],
                        help="the device the program is exported for")
    # the JAX CLI's input-processing options (export.py:33-115), read by
    # the full pipeline's --with_preprocess program
    parser.add_argument("--with_preprocess", action="store_true",
                        help="bake the uint8 -> image preprocessing into "
                             "the exported full pipeline (--net_only "
                             "false)")
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

    device = torch.device(args.platform)
    if cfg.net_only:
        program = export_net_only(cfg, tree, device)
    elif args.with_preprocess:
        program = export_preprocessed(cfg, tree, args, device)
    else:
        program = export_full(cfg, tree, device)
    os.makedirs(args.export_dir, exist_ok=True)
    path = os.path.join(args.export_dir, f"{args.export_name}.pt2")
    torch.export.save(program, path)
    meta = {"step": int(step), "net_only": cfg.net_only,
            "platform": args.platform, "interface": interface(cfg, args),
            "config": {"height": cfg.height, "width": cfg.width,
                       "num_psv_planes": cfg.num_psv_planes,
                       "num_msi_planes": cfg.num_msi_planes,
                       "which_color_pred": cfg.which_color_pred,
                       "coord_net": cfg.coord_net}}
    if not cfg.net_only:
        library = _build.op_library()
        # a new file renamed into place: a process that has a library of
        # this name loaded (a consumer of an earlier export into this
        # directory) keeps its own
        tmp = os.path.join(args.export_dir, f".{library.name}.{os.getpid()}")
        shutil.copy2(library, tmp)
        os.replace(tmp, os.path.join(args.export_dir, library.name))
        meta.update(custom_ops=[sweep_ops.OP_NAME], op_library=library.name)
    with open(os.path.join(args.export_dir,
                           f"{args.export_name}.meta.json"), "w") as fh:
        json.dump(meta, fh, indent=2)
    print(f"[export] wrote {path} ({os.path.getsize(path)} bytes)")
    return path


if __name__ == "__main__":
    main()
