"""Training entry point (the reference's train.py, flags included).

Counterpart of `matryodshka_tpu/cli/train.py` for the ODS trainer with
tgt supervision and the PP and RealEstate10K trainers (`--input_type PP`
or `REALESTATE_PP`: the MPI render of the target view; pixel or E-LPIPS
loss, optional spherical attention, weight regularization and the
transform-inverse regularizer, either net). Example, on the synthetic
fixture (`python -m matryodshka_tpu_torch.data.synthetic /tmp/fix`):

  python -m matryodshka_tpu_torch.cli.train --device cpu \
      --image_dir /tmp/fix/images --cameras_glob '/tmp/fix/cams/*.txt' \
      --height 64 --width 128 --num_psv_planes 4 --num_msi_planes 4 \
      --ngf 8 --max_steps 3 --summary_freq 1 --checkpoint_dir /tmp/ckpt

The released recipe (scripts/train/ods-wotemp-elpips-coord.sh) adds
`--which_loss elpips --coord_net true [--elpips_weight_path W.npz]`;
without weights E-LPIPS runs on random conv features, and every record of
metrics.jsonl carries `"elpips_calibrated": false`.

The PP and RealEstate recipes (scripts/train/pp-wotemp-elpips-coord.sh,
realestate-wotemp-elpips-coord.sh) run as they are, their data paths
aside; `data/synthetic.make_perspective_fixture` and
`make_realestate_fixture` write fixtures for them (the module's
`--realestate --frames 91`: the training loader admits clips of at least
91 frames).

Every option of the JAX trainer: `--gcn true` (the GCN head on an
icosphere of `--subdiv` subdivisions, its mesh generated into, or read
from, `--mesh_dir`), `--num_data_shards K` (K data-parallel ranks, the
gradients summed over ranks; started here as K processes, gloo on the
CPU and NCCL on cards, one card a rank, or joined from `torchrun`'s
environment), `--steps_per_call K`,
`--supervision` with `src`, `ref` and `hrestgt` (the last reads the
4096x2048 images from `--hres_image_dir`; a fixture's `--image_dir` does,
the loader resizes), `--remat_network`, `--param_dtype bfloat16`,
`--use_pallas false` (none of the port's kernels runs), and:

  --profile_steps a,b   torch.profiler over steps a..b, the Chrome trace
                        under <checkpoint_dir>/<experiment_name>/profile/;
  --dry_run             no training: the first batch's tgt/src/ref images
                        (hres_* too under hrestgt) and every plane of its
                        sweep volume (formatInput_<i>.png) under
                        dryrun/<experiment_name>/ (JAX cli/train.py:128-192);
  --dry_run_inference   also restores the latest checkpoint and writes its
                        layers (msi_alpha_XX.png, msi_rgb_XX.png) and, for
                        ODS, the target view and depth (tgt_rendered.png,
                        depth_rendered.png).

`--device` is `cuda` by default; without a card that raises rather than
running on the CPU. The checkpoint's `<checkpoint_dir>/<experiment_name>/
<step>/params.npz` is what the test CLI's `--params` reads.
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile

import numpy as np
import torch

from matryodshka_tpu_torch import entry
from matryodshka_tpu_torch.config import add_config_args, config_from_args
from matryodshka_tpu_torch.data.images import write_image
from matryodshka_tpu_torch.data.loader import device_prefetch, make_loader
from matryodshka_tpu_torch.geometry import render as render_lib
from matryodshka_tpu_torch.geometry import sweep as sweep_lib
from matryodshka_tpu_torch.models import msi as msi_lib
from matryodshka_tpu_torch.parallel import dp, mesh
from matryodshka_tpu_torch.training.checkpoint import CheckpointManager
from matryodshka_tpu_torch.training import loop as loop_lib
from matryodshka_tpu_torch.training import state as state_lib
from matryodshka_tpu_torch.training.step import build_elpips, \
    make_loss_fn, make_train_step


def make_image_summary_fn(cfg, net, elpips=None):
    """(state, batch) -> {name: HxWxC numpy image}: the current render and
    three MSI layers' colour and alpha, and the target (the reference's
    TensorBoard image summaries, msi.py:735-774). elpips: the step's
    metric, passed so that no second one is built."""
    loss_fn = make_loss_fn(cfg, net, elpips=elpips)

    @torch.no_grad()
    def fn(state, batch):
        vol = loss_fn.sweep(batch)
        aux = loss_fn.render(vol, state.net(vol), batch)
        view = aux["output_image"] if "output_image" in aux else \
            loss_fn.view(aux["rgba_layers"], batch)
        rgba = aux["rgba_layers"][0].float()
        imgs = {"output_image": msi_lib.deprocess_image(view[0])}
        for i in (0, rgba.shape[2] // 2, rgba.shape[2] - 1):
            imgs[f"rgb_layer_{i}"] = msi_lib.deprocess_image(rgba[:, :, i, :3])
            imgs[f"alpha_layer_{i}"] = rgba[:, :, i, 3:]
        imgs["tgt_image"] = batch["tgt_image"][0]
        return {k: v.float().cpu().numpy() for k, v in imgs.items()}

    return fn


def _png(path, img):
    """Write a [0, 255]-scaled image tensor (H x W or H x W x C)."""
    write_image(path, img.float().cpu().numpy())


@torch.no_grad()
def run_dry_run(cfg, loader, with_inference: bool, device,
                dryrun_dir=None):
    """Sanity-check dumps (JAX cli/train.py:run_dry_run; the reference's
    msi.py:776-967) of the loader's first batch under dryrun_dir
    (dryrun/<experiment_name> by default): tgt.png, src.png, ref.png
    (hres_*.png too under hrestgt) and formatInput_<i>.png, the 2P planes
    of its sweep volume (sweep_stage: K1 on the card); with_inference
    also restores the latest checkpoint under <checkpoint_dir>/
    <experiment_name> and writes the net's layers, msi_alpha_XX.png and
    msi_rgb_XX.png, and for ODS input the target view and its depth
    proxy, tgt_rendered.png and depth_rendered.png. On the card the net
    runs through its kernels (ops/net.py) and the view and depth through
    one layer-stack render launch; with use_pallas false the gather
    sweep, the plain net and the gather renders."""
    dryrun_dir = dryrun_dir or os.path.join("dryrun", cfg.experiment_name)
    os.makedirs(dryrun_dir, exist_ok=True)
    np_batch = next(loader.batches())
    batch = {k: torch.from_numpy(v).to(device) for k, v in np_batch.items()
             if isinstance(v, np.ndarray)}
    for name in ("tgt", "src", "ref"):
        _png(f"{dryrun_dir}/{name}.png", batch[f"{name}_image"][0] * 255.0)
        if cfg.supervise_hrestgt:
            _png(f"{dryrun_dir}/hres_{name}.png",
                 batch[f"hres_{name}_image"][0] * 255.0)

    psv_depths, msi_depths = (torch.tensor(
        sweep_lib.inv_depths(cfg.min_depth, cfg.max_depth, n),
        dtype=torch.float32, device=device)
        for n in (cfg.num_psv_planes, cfg.num_msi_planes))
    vol = msi_lib.sweep_stage(cfg, batch, psv_depths)
    psv = vol[0].float()
    for i in range(2 * cfg.num_psv_planes):
        _png(f"{dryrun_dir}/formatInput_{i}.png",
             (psv[i * 3:(i + 1) * 3].permute(1, 2, 0) + 1) / 2 * 255)

    if with_inference:
        tree, step = CheckpointManager(os.path.join(
            cfg.checkpoint_dir, cfg.experiment_name)).restore_params()
        print(f"[dry_run] restored checkpoint @ step {step}")
        params = entry.make_params(cfg, flax_params=tree, device=device)
        pred = (msi_lib.net_stage(params.stages, vol) if cfg.use_pallas
                else params.net(vol))
        rgba = msi_lib.assemble_rgba(
            cfg.which_color_pred, pred.permute(0, 2, 3, 1),
            vol.permute(0, 2, 3, 1), cfg.num_msi_planes)["rgba_layers"]
        layers = rgba[0].float()
        for i in range(cfg.num_msi_planes):
            _png(f"{dryrun_dir}/msi_alpha_{i:02d}.png",
                 layers[:, :, i, 3] * 255.0)
            _png(f"{dryrun_dir}/msi_rgb_{i:02d}.png",
                 (layers[:, :, i, :3] + 1) / 2 * 255.0)
        if cfg.input_type == "ODS":
            eye = torch.eye(4, device=device).expand(vol.shape[0], 4, 4)
            if cfg.use_pallas:
                stack = msi_lib.assemble_rgba_prepared(
                    cfg.which_color_pred, pred, vol, cfg.num_msi_planes,
                    cfg.torch_compute_dtype)
                img, depth = render_lib.render_equirect_view_prepared_both(
                    stack, eye, batch["tgt_pose"], msi_depths)
            else:
                img = msi_lib.render_equirect_view(
                    rgba, eye, batch["tgt_pose"], msi_depths)
                depth = msi_lib.render_equirect_depth(
                    rgba, eye, batch["tgt_pose"], msi_depths)
            _png(f"{dryrun_dir}/tgt_rendered.png",
                 msi_lib.deprocess_image(img[0]) * 255.0)
            _png(f"{dryrun_dir}/depth_rendered.png", depth[0] * 255.0)
    print(f"[dry_run] wrote sanity dumps to {dryrun_dir}")


def build_parser() -> argparse.ArgumentParser:
    """The JAX trainer's flags (one per config field), plus --device."""
    parser = argparse.ArgumentParser(description="matryodshka training "
                                                 "(torch)")
    add_config_args(parser)
    parser.add_argument("--device", type=str, default="cuda")
    parser.add_argument("--dry_run", action="store_true")
    parser.add_argument("--dry_run_inference", action="store_true")
    parser.add_argument("--profile_steps", type=str, default=None,
                        help="'start,stop' step window for torch.profiler")
    parser.add_argument("--steps_per_call", type=int, default=1,
                        help="K train steps a call on K stacked batches "
                             "(a loop of single steps; the same result as "
                             "K calls)")
    return parser


def main(argv=None):
    argv = sys.argv[1:] if argv is None else list(argv)
    args = build_parser().parse_args(argv)
    cfg = config_from_args(args)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda: no CUDA device here (pass "
                           "--device cpu to train on the CPU)")
    dry = args.dry_run or args.dry_run_inference
    if cfg.num_data_shards > 1 and not dry:
        rank_device = mesh.init_from_env(device.type)
        if rank_device is None:
            # not started as a rank: start num_data_shards of them here
            with tempfile.TemporaryDirectory() as d:
                mesh.run_ranks(_train_rank, cfg.num_data_shards,
                               os.path.join(d, "store"), device.type,
                               args=(argv,), timeout=None)
            return
        _, world = mesh.rank_and_size()
        if world != cfg.num_data_shards:
            raise ValueError(f"num_data_shards {cfg.num_data_shards} in a "
                             f"process group of {world} ranks")
        device = rank_device
    run(cfg, args, device)


def _train_rank(rank, world, argv):
    """One data-parallel rank of main (parallel/mesh.run_ranks)."""
    args = build_parser().parse_args(argv)
    run(config_from_args(args), args,
        mesh.rank_device(torch.device(args.device).type, rank))


def run(cfg, args, device):
    """Train cfg on device: the single-device step, or in a process group
    of cfg.num_data_shards ranks this rank's data-parallel step on its
    shard of each global batch (training/step.make_train_step); with
    --steps_per_call K > 1 K steps a call (training/loop.train)."""
    loader = make_loader(cfg, training=True)
    print(f"[train] {len(loader.sequences)} sequences on {device}")
    if args.dry_run or args.dry_run_inference:
        run_dry_run(cfg, loader, args.dry_run_inference, device)
        return
    profile_steps = None
    if args.profile_steps:
        a, b = args.profile_steps.split(",")
        profile_steps = (int(a), int(b))
    state = state_lib.init_state(cfg, cfg.random_seed, device)
    elpips, static_log_fields = None, None
    if cfg.which_loss == "elpips":
        elpips = build_elpips(cfg, device)
        # training on random conv features runs, but its loss values are
        # not comparable with calibrated E-LPIPS numbers
        static_log_fields = {"elpips_calibrated": bool(elpips.calibrated)}
        if not elpips.calibrated:
            print("[train] WARNING: E-LPIPS running with RANDOM conv "
                  "features (no elpips_weight_path) — loss values are "
                  "not the calibrated perceptual distance; metrics "
                  "records carry elpips_calibrated=false")
    rank, world = mesh.rank_and_size()
    k = max(1, args.steps_per_call)
    step_fn = make_train_step(cfg, state.net, elpips=elpips,
                              gcn_inputs=state.gcn_inputs)
    if world > 1 or k > 1:
        print(f"[train] {k} step(s) a call, data-parallel over {world} "
              f"rank(s)")
    batches = (dp.shard_batch(b, rank, world) for b in loader.batches())
    # as the JAX trainer, no image summaries for the GCN
    image_fn = None if cfg.gcn else make_image_summary_fn(cfg, state.net,
                                                          elpips)
    loop_lib.train(cfg, state, step_fn,
                   device_prefetch(batches, size=2, device=device),
                   image_summary_fn=image_fn,
                   profile_steps=profile_steps,
                   steps_per_call=k,
                   static_log_fields=static_log_fields)


if __name__ == "__main__":
    main()
