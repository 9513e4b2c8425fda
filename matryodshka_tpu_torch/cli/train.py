"""Training entry point (the reference's train.py, flags included).

Counterpart of `matryodshka_tpu/cli/train.py` for the default ODS trainer
(pixel loss, tgt supervision, optional spherical attention and weight
regularization, either net). Example, on the synthetic fixture
(`python -m matryodshka_tpu_torch.data.synthetic /tmp/fix`):

  python -m matryodshka_tpu_torch.cli.train --device cpu \
      --image_dir /tmp/fix/images --cameras_glob '/tmp/fix/cams/*.txt' \
      --height 64 --width 128 --num_psv_planes 4 --num_msi_planes 4 \
      --ngf 8 --max_steps 3 --summary_freq 1 --checkpoint_dir /tmp/ckpt

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
from matryodshka_tpu_torch.training.step import make_loss_fn, \
    make_train_step


def make_image_summary_fn(cfg, net):
    """(state, batch) -> {name: HxWxC numpy image}: the current render and
    three MSI layers' colour and alpha, and the target (the reference's
    TensorBoard image summaries, msi.py:735-774)."""
    loss_fn = make_loss_fn(cfg, net)

    @torch.no_grad()
    def fn(state, batch):
        vol = loss_fn.sweep(batch)
        _, aux = loss_fn.tail(batch, vol, state.net(vol))
        rgba = aux["rgba_layers"][0].float()
        imgs = {"output_image": msi_lib.deprocess_image(
            aux["output_image"][0])}
        for i in (0, rgba.shape[2] // 2, rgba.shape[2] - 1):
            imgs[f"rgb_layer_{i}"] = msi_lib.deprocess_image(rgba[:, :, i, :3])
            imgs[f"alpha_layer_{i}"] = rgba[:, :, i, 3:]
        imgs["tgt_image"] = batch["tgt_image"][0]
        return {k: v.float().cpu().numpy() for k, v in imgs.items()}

    return fn


def main(argv=None):
    parser = argparse.ArgumentParser(description="matryodshka training "
                                                 "(torch)")
    add_config_args(parser)
    parser.add_argument("--device", type=str, default="cuda")
    parser.add_argument("--dry_run", action="store_true")
    parser.add_argument("--dry_run_inference", action="store_true")
    parser.add_argument("--profile_steps", type=str, default=None)
    parser.add_argument("--steps_per_call", type=int, default=1)
    args = parser.parse_args(argv)
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
    step_fn = make_train_step(cfg, state.net)
    loop_lib.train(cfg, state, step_fn,
                   device_prefetch(loader.batches(), size=2, device=device),
                   image_summary_fn=make_image_summary_fn(cfg, state.net),
                   steps_per_call=args.steps_per_call)


if __name__ == "__main__":
    main()
