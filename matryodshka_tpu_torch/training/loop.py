"""The training loop: step pacing, summaries, checkpoints.

Counterpart of `matryodshka_tpu/training/loop.py` (MSI.train,
msi.py:971-1022): per-step timing logged every summary_freq steps,
a checkpoint every save_latest_freq (max_to_keep=10), resume from the
latest with continue_train. Observability is a metrics JSONL (scalars,
with the JAX package's keys and `sec_per_step`) plus, when the caller
gives an image summary function, PNG dumps every summary_freq steps.
Chaining several steps per call (`steps_per_call > 1`) and the profiler
window are not ported (ROADMAP Queue 1 items 9 and 6).
"""

from __future__ import annotations

import json
import os
import time
from typing import Callable, Dict, Iterator, Optional

import numpy as np
import torch

from matryodshka_tpu_torch.data.images import write_image
from matryodshka_tpu_torch.training.checkpoint import CheckpointManager
from matryodshka_tpu_torch.training.state import param_count


class SummaryWriter:
    """Scalars to JSONL + images to PNG under a log dir."""

    def __init__(self, log_dir: str, static_fields: Optional[Dict] = None):
        self.log_dir = log_dir
        # Stamped into every scalar record: {"elpips_calibrated": false}
        # when the perceptual loss runs on random conv features, so no
        # metrics.jsonl carries a random-feature score unmarked.
        self.static_fields = dict(static_fields or {})
        os.makedirs(log_dir, exist_ok=True)
        self._fh = open(os.path.join(log_dir, "metrics.jsonl"), "a")

    def scalars(self, step: int, metrics: Dict[str, float]) -> None:
        rec = {"step": step}
        rec.update(self.static_fields)
        rec.update({k: float(v) for k, v in metrics.items()})
        self._fh.write(json.dumps(rec) + "\n")
        self._fh.flush()

    def image(self, step: int, name: str, img: np.ndarray) -> None:
        write_image(os.path.join(self.log_dir, f"{name}_{step:08d}.png"), img)

    def close(self):
        self._fh.close()


def train(cfg, state, train_step: Callable, batches: Iterator[Dict],
          image_summary_fn: Optional[Callable] = None,
          steps_per_call: int = 1,
          static_log_fields: Optional[Dict] = None):
    """Run the training loop until cfg.max_steps; returns the state.

    Args:
      train_step: (state, batch) -> (state, metrics of 0-d tensors), from
        training/step.py:make_train_step.
      batches: iterator of batch dicts on the net's device (tensors; other
        entries such as scene ids are dropped before the step).
      image_summary_fn: optional (state, batch) -> {name: HxWxC array},
        called every summary_freq steps.
      static_log_fields: fields written into every metrics record.
    """
    if steps_per_call != 1:
        raise NotImplementedError("steps_per_call > 1: chained steps per "
                                  "call are ROADMAP Queue 1 item 9")
    ckpt_dir = os.path.join(cfg.checkpoint_dir, cfg.experiment_name)
    manager = CheckpointManager(ckpt_dir, max_to_keep=10)
    writer = SummaryWriter(os.path.join(ckpt_dir, "logs"),
                           static_log_fields)
    try:
        if cfg.continue_train:
            latest = manager.latest_step()
            if latest is not None:
                state = manager.restore(state, latest)
                print(f"[train] resumed from step {latest}")
            else:
                print("[train] no checkpoint to resume from; starting fresh")

        print(f"[train] parameter count: {param_count(state.net):,}")
        t0 = time.time()
        for step_i, batch in enumerate(batches, start=state.step + 1):
            if step_i > cfg.max_steps:
                break
            arrays = {k: v for k, v in batch.items() if torch.is_tensor(v)}
            state, metrics = train_step(state, arrays)

            if step_i % cfg.summary_freq == 0:
                metrics = {k: float(v) for k, v in metrics.items()}
                dt = (time.time() - t0) / cfg.summary_freq
                t0 = time.time()
                writer.scalars(step_i, {**metrics, "sec_per_step": dt})
                print(f"[step {step_i:8d}] loss={metrics['total_loss']:.5f} "
                      f"{dt:.4f}s/it")
                if image_summary_fn is not None:
                    for name, img in image_summary_fn(state, arrays).items():
                        writer.image(step_i, name, np.asarray(img))

            if step_i % cfg.save_latest_freq == 0:
                manager.save(state)
                print(f"[train] saved checkpoint @ {step_i}")

        manager.save(state)
    finally:
        writer.close()
    return state
