"""The training loop: step pacing, summaries, checkpoints.

Counterpart of `matryodshka_tpu/training/loop.py` (MSI.train,
msi.py:971-1022): per-step timing logged every summary_freq steps,
a checkpoint every save_latest_freq (max_to_keep=10), resume from the
latest with continue_train. Observability is a metrics JSONL (scalars,
with the JAX package's keys and `sec_per_step`) plus, when the caller
gives an image summary function, PNG dumps every summary_freq steps, and
a `torch.profiler` trace of a window of steps (`profile_steps`, the JAX
loop's jax.profiler window, loop.py:114-127). `steps_per_call > 1` takes
K batches a call and runs K steps on them (JAX loop.py:149-204), a plain
loop of single steps on the card.
"""

from __future__ import annotations

import json
import os
import time
from typing import Callable, Dict, Iterator, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from matryodshka_tpu_torch.data.images import write_image
from matryodshka_tpu_torch.training.checkpoint import CheckpointManager
from matryodshka_tpu_torch.training.state import param_count


class StepProfiler:
    """torch.profiler over steps [start, stop] (both included): started
    before step `start`, stopped after step `stop` once the device has
    finished it; the trace is written as Chrome trace JSON to
    <log_dir>/trace_<start>_<stop>.json. Device activity is recorded when
    the net is on a CUDA device."""

    def __init__(self, log_dir: str, start: int, stop: int, cuda: bool):
        self.path = os.path.join(log_dir, f"trace_{start}_{stop}.json")
        self.start, self.stop = start, stop
        self.activities = [torch.profiler.ProfilerActivity.CPU]
        if cuda:
            self.activities.append(torch.profiler.ProfilerActivity.CUDA)
        self.prof = None

    def before(self, step: int) -> None:
        if step == self.start:
            os.makedirs(os.path.dirname(self.path), exist_ok=True)
            self.prof = torch.profiler.profile(activities=self.activities)
            self.prof.__enter__()

    def after(self, step: int) -> None:
        if step == self.stop and self.prof is not None:
            if torch.profiler.ProfilerActivity.CUDA in self.activities:
                torch.cuda.synchronize()
            self.prof.__exit__(None, None, None)
            self.prof.export_chrome_trace(self.path)
            print(f"[train] profile of steps {self.start}-{self.stop} "
                  f"written to {self.path}")
            self.prof = None


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
          profile_steps: Optional[Tuple[int, int]] = None,
          steps_per_call: int = 1,
          static_log_fields: Optional[Dict] = None):
    """Run the training loop until cfg.max_steps; returns the state.

    Args:
      train_step: (state, batch) -> (state, metrics of 0-d tensors), from
        training/step.py:make_train_step (data-parallel when built in a
        process group).
      batches: iterator of batch dicts on the net's device (tensors; other
        entries such as scene ids are dropped before the step).
      image_summary_fn: optional (state, batch) -> {name: HxWxC array},
        called every summary_freq steps.
      profile_steps: optional (start, stop) step numbers of a
        torch.profiler trace written under <checkpoint_dir>/
        <experiment_name>/profile/ (StepProfiler).
      steps_per_call: K steps a call, train_step on each of the call's K
        batches in turn. Summaries fire for every step of a call that
        hits summary_freq (that step's metrics), checkpoints at the end
        of a call whose steps crossed save_latest_freq; training stops at
        the last full call <= max_steps (JAX loop.py:149-204).
      static_log_fields: fields written into every metrics record.

    In a process group (parallel/mesh.py) only rank 0 writes summaries,
    images and checkpoints.
    """
    primary = not dist.is_initialized() or dist.get_rank() == 0
    ckpt_dir = os.path.join(cfg.checkpoint_dir, cfg.experiment_name)
    manager = CheckpointManager(ckpt_dir, max_to_keep=10)
    writer = SummaryWriter(os.path.join(ckpt_dir, "logs"),
                           static_log_fields) if primary else None
    k = max(1, int(steps_per_call))
    try:
        if cfg.continue_train:
            latest = manager.latest_step()
            if latest is not None:
                state = manager.restore(state, latest)
                print(f"[train] resumed from step {latest}")
            else:
                print("[train] no checkpoint to resume from; starting fresh")

        print(f"[train] parameter count: {param_count(state.net):,}")
        profiler = None
        if profile_steps is not None and primary:
            profiler = StepProfiler(
                os.path.join(ckpt_dir, "profile"), *profile_steps,
                cuda=next(state.net.parameters()).is_cuda)
        t0, last_logged = time.time(), state.step
        it = iter(batches)
        while state.step + k <= cfg.max_steps:
            window = []
            for batch in it:
                window.append({kk: v for kk, v in batch.items()
                               if torch.is_tensor(v)})
                if len(window) == k:
                    break
            if len(window) < k:
                if k > 1 and window:
                    print(f"[train] data iterator exhausted mid-call @ "
                          f"{state.step}; stopping")
                break
            first = state.step + 1
            steps = range(first, first + k)
            if profiler is not None:
                for s in steps:
                    profiler.before(s)
            rows = []
            for b in window:
                state, metrics = train_step(state, b)
                rows.append(metrics)
            if profiler is not None:
                for s in steps:
                    profiler.after(s)

            logged = [(s, row) for s, row in zip(steps, rows)
                      if s % cfg.summary_freq == 0]
            if logged and primary:
                dt = (time.time() - t0) / (state.step - last_logged)
                t0, last_logged = time.time(), state.step
                for s, row in logged:
                    row = {kk: float(v) for kk, v in row.items()}
                    writer.scalars(s, {**row, "sec_per_step": dt})
                    print(f"[step {s:8d}] loss={row['total_loss']:.5f} "
                          f"{dt:.4f}s/it")
                if image_summary_fn is not None:
                    for name, img in image_summary_fn(state,
                                                      window[-1]).items():
                        writer.image(state.step, name, np.asarray(img))

            if primary and any(s % cfg.save_latest_freq == 0 for s in steps):
                manager.save(state)
                print(f"[train] saved checkpoint @ {state.step}")

        if primary:
            manager.save(state)
    finally:
        if writer is not None:
            writer.close()
    return state
