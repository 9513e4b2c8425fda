"""Restoring the net's parameters for the inference CLI.

The JAX package restores orbax checkpoints
(`matryodshka_tpu/training/checkpoint.py:restore_params`); neither orbax
nor tensorstore is available where the port runs. So the port reads the
flax parameter tree from a `.npz` whose keys are the `/`-joined tree paths
(`params/conv1_1/kernel`, ...), with an optional scalar `step`, and hands
it to `weights.from_flax`. `python -m matryodshka_tpu_torch.tf_import`
writes such a file from a reference TF-v1 checkpoint; reading orbax
checkpoints is not ported.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np


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
