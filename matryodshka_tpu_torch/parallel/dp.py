"""Data-parallel training: the counterpart of
`matryodshka_tpu/parallel/dp.py`.

The step itself is training/step.make_train_step, which is data-parallel
when it is built in a process group (parallel/mesh.py): each rank runs
its shard of the global batch (shard_batch) through the single-device
loss with n_shards = the rank count, and one all-reduce SUMS the
gradients and the scalar metrics over the ranks before the replicated
Adam update, as the JAX step psums them (JAX dp.py:73-76); the ranks draw
from generators seeded from (seed, step, rank) (rank_generator). This
module keeps the JAX module's names for it: make_dp_train_step,
make_dp_train_multi_step (steps_per_call steps on stacked batches,
`stack_batches`, metrics stacked [K]: on a card a plain loop of single
steps, equal to K calls of the single step), shard_batch.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence

import numpy as np
import torch

from matryodshka_tpu_torch.training.step import (make_train_step,
                                                 rank_generator)

__all__ = ["make_dp_train_step", "make_dp_train_multi_step", "shard_batch",
           "stack_batches", "rank_generator"]

#: JAX's name for the step: training/step.make_train_step, data-parallel
#: in a process group.
make_dp_train_step = make_train_step


def shard_batch(batch: Dict, rank: int, world: int) -> Dict:
    """This rank's shard of a global batch: axis 0 of each array or tensor
    split into world equal parts (entries of another type are dropped)."""
    out = {}
    for k, v in batch.items():
        if isinstance(v, (np.ndarray, torch.Tensor)):
            n = v.shape[0] // world
            out[k] = v[rank * n:(rank + 1) * n]
    return out


def stack_batches(batches: Sequence[Dict]) -> Dict:
    """K batch dicts -> one whose tensors carry a leading [K] axis, the
    input of make_dp_train_multi_step."""
    return {k: torch.stack([torch.as_tensor(b[k]) for b in batches])
            for k in batches[0] if torch.is_tensor(batches[0][k])
            or isinstance(batches[0][k], np.ndarray)}


def make_dp_train_multi_step(cfg, net, sweep: Optional[Callable] = None,
                             elpips: Optional[Callable] = None,
                             gcn_inputs=None, steps_per_call: int = 1,
                             group=None) -> Callable:
    """multi_step(state, stacked) -> (state, metrics): steps_per_call
    steps of make_dp_train_step, step i on stacked[k][i] (stack_batches);
    each metric stacked [steps_per_call]."""
    step = make_train_step(cfg, net, sweep, elpips, gcn_inputs, group)

    def multi_step(state, stacked):
        rows = []
        for i in range(steps_per_call):
            state, m = step(state, {k: v[i] for k, v in stacked.items()})
            rows.append(m)
        return state, {k: torch.stack([m[k] for m in rows]) for k in rows[0]}

    return multi_step
