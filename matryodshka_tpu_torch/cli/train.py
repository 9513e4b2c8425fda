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

`--device` is `cuda` by default; without a card that raises rather than
running on the CPU. The checkpoint's `<checkpoint_dir>/<experiment_name>/
<step>/params.npz` is what the test CLI's `--params` reads. `--dry_run`,
`--dry_run_inference` and `--profile_steps` are not ported (ROADMAP Queue
1 item 6), nor `--steps_per_call > 1` (item 9).
"""

from __future__ import annotations

import argparse

import torch

from matryodshka_tpu_torch.config import add_config_args, config_from_args
from matryodshka_tpu_torch.data.loader import device_prefetch, make_loader
from matryodshka_tpu_torch.models import msi as msi_lib
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
        rgba = aux["rgba_layers"][0].float()
        imgs = {"output_image": msi_lib.deprocess_image(
            aux["output_image"][0])}
        for i in (0, rgba.shape[2] // 2, rgba.shape[2] - 1):
            imgs[f"rgb_layer_{i}"] = msi_lib.deprocess_image(rgba[:, :, i, :3])
            imgs[f"alpha_layer_{i}"] = rgba[:, :, i, 3:]
        imgs["tgt_image"] = batch["tgt_image"][0]
        return {k: v.float().cpu().numpy() for k, v in imgs.items()}

    return fn


def build_parser() -> argparse.ArgumentParser:
    """The JAX trainer's flags (one per config field), plus --device."""
    parser = argparse.ArgumentParser(description="matryodshka training "
                                                 "(torch)")
    add_config_args(parser)
    parser.add_argument("--device", type=str, default="cuda")
    parser.add_argument("--dry_run", action="store_true")
    parser.add_argument("--dry_run_inference", action="store_true")
    parser.add_argument("--profile_steps", type=str, default=None)
    parser.add_argument("--steps_per_call", type=int, default=1)
    return parser


def main(argv=None):
    args = build_parser().parse_args(argv)
    cfg = config_from_args(args)
    if args.dry_run or args.dry_run_inference or args.profile_steps:
        raise NotImplementedError("--dry_run, --dry_run_inference and "
                                  "--profile_steps are left of ROADMAP "
                                  "Queue 1 item 6")
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda: no CUDA device here (pass "
                           "--device cpu to train on the CPU)")

    loader = make_loader(cfg, training=True)
    print(f"[train] {len(loader.sequences)} sequences on {device}")
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
    step_fn = make_train_step(cfg, state.net, elpips=elpips)
    loop_lib.train(cfg, state, step_fn,
                   device_prefetch(loader.batches(), size=2, device=device),
                   image_summary_fn=make_image_summary_fn(cfg, state.net,
                                                          elpips),
                   steps_per_call=args.steps_per_call,
                   static_log_fields=static_log_fields)


if __name__ == "__main__":
    main()
