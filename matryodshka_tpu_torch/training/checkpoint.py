"""Checkpoints of the trainer, and the parameter files the CLIs read.

Counterpart of `matryodshka_tpu/training/checkpoint.py` (`CheckpointManager`:
save every save_latest_freq, max_to_keep=10, resume from the latest;
msi.py:983-1002). The JAX package writes orbax checkpoints; neither orbax
nor tensorstore is available where the port runs. So a checkpoint of step
s is a directory `<directory>/<s>/` holding

* `params.npz`: the flax parameter tree (`weights.net_to_flax`: the
  U-Net's or the GCN's), keys the `/`-joined tree paths
  (`params/conv1_1/kernel`, `params/conv1_1/weights_0`, ...) and a scalar
  `step`,
  the file that `restore_params` and the test CLI's `--params` read
  (`python -m matryodshka_tpu_torch.tf_import` writes the same layout from
  a reference TF-v1 checkpoint);
* `train_state.pt`: the step, the optimizer's state and the state of the
  loss's generator (`torch.save`).
"""

from __future__ import annotations

import os
import shutil
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from matryodshka_tpu_torch import weights

PARAMS = "params.npz"
TRAIN_STATE = "train_state.pt"


def restore_params(path: str) -> Tuple[Dict, int]:
    """Read (flax parameter tree of numpy arrays, step) from an .npz.
    step is 0 when the file holds none."""
    tree: Dict = {}
    step = 0
    with np.load(path) as data:
        for key in data.files:
            if key == "step":
                step = int(data[key])
                continue
            node = tree
            *parents, leaf = key.split("/")
            for name in parents:
                node = node.setdefault(name, {})
            node[leaf] = data[key]
    return tree, step


def save_params(path: str, params: Dict, step: int = 0) -> None:
    """Write a flax parameter tree {"params": {layer: {leaf: array}}} and
    its step as the .npz that restore_params reads (float32 leaves)."""
    flat = {f"params/{layer}/{leaf}": np.ascontiguousarray(value,
                                                           np.float32)
            for layer, leaves in params["params"].items()
            for leaf, value in leaves.items()}
    flat["step"] = np.asarray(step, np.int64)
    np.savez(path, **flat)


class CheckpointManager:
    def __init__(self, directory: str, max_to_keep: int = 10):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        os.makedirs(self.directory, exist_ok=True)

    def _dir(self, step: int) -> str:
        return os.path.join(self.directory, str(step))

    def steps(self) -> List[int]:
        """Steps with a complete checkpoint, ascending."""
        return sorted(int(d) for d in os.listdir(self.directory)
                      if d.isdigit()
                      and os.path.exists(os.path.join(self._dir(int(d)),
                                                     TRAIN_STATE)))

    def save(self, state) -> None:
        """Write state's checkpoint (replacing one of the same step), then
        keep only the newest max_to_keep."""
        step = int(state.step)
        tmp = self._dir(step) + ".tmp"
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        save_params(os.path.join(tmp, PARAMS),
                    weights.net_to_flax(state.net), step)
        torch.save({"step": step,
                    "optimizer": state.optimizer.state_dict(),
                    "generator": state.generator.get_state()},
                   os.path.join(tmp, TRAIN_STATE))
        shutil.rmtree(self._dir(step), ignore_errors=True)
        os.replace(tmp, self._dir(step))
        for old in self.steps()[:-self.max_to_keep]:
            shutil.rmtree(self._dir(old))

    def latest_step(self) -> Optional[int]:
        steps = self.steps()
        return steps[-1] if steps else None

    def restore_params(self, step: Optional[int] = None) -> Tuple[Dict, int]:
        """(flax parameter tree, step) of a checkpoint (the latest by
        default), without an optimizer: the test CLI's restore."""
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {self.directory}")
        tree, _ = restore_params(os.path.join(self._dir(step), PARAMS))
        return tree, step

    def restore(self, state, step: Optional[int] = None):
        """Load a checkpoint (the latest by default) into state's net,
        optimizer and generator, in place; returns state."""
        tree, step = self.restore_params(step)
        state.net.load_state_dict(weights.net_from_flax(state.net, tree))
        device = next(state.net.parameters()).device
        saved = torch.load(os.path.join(self._dir(step), TRAIN_STATE),
                           map_location=device, weights_only=True)
        state.optimizer.load_state_dict(saved["optimizer"])
        state.generator.set_state(saved["generator"].cpu())
        state.step = int(saved["step"])
        return state
