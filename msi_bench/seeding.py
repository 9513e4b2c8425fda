"""Weights from the seed, made on the device in one draw.

Every leaf of the flax-layout tree comes from one `torch.randn` on the
run's device, drawn from the run's generator: conv kernels with variance
1 / fan_in (fan_in = KH * KW * Cin), rounded to bfloat16, the type the
program serves them in; biases and layer-norm offsets 0.1 N(0, 1); layer-norm
scales 1 + 0.1 N(0, 1). The released checkpoints are not in the repository.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def generator(seed: int, device) -> torch.Generator:
    gen = torch.Generator(device=device)
    gen.manual_seed(seed % (1 << 63))
    return gen


def weight_tree(shapes, gen, device):
    """shapes {layer: {leaf: shape}} -> {layer: {leaf: float32 tensor}}."""
    total = sum(math.prod(s) for leaves in shapes.values()
                for s in leaves.values())
    z = torch.randn(total, generator=gen, device=device)
    tree, off = {}, 0
    for layer, leaves in shapes.items():
        tree[layer] = {}
        for leaf, shape in leaves.items():
            n = math.prod(shape)
            x = z[off:off + n].view(shape)
            off += n
            if leaf == "kernel":
                fan_in = math.prod(shape[:-1])
                x = (x / math.sqrt(fan_in)).bfloat16().float()
            elif leaf == "gamma":
                x = 1.0 + 0.1 * x
            else:
                x = 0.1 * x
            tree[layer][leaf] = x
    return tree


def to_numpy(tree):
    """The tree as the port's `entry.make_params(flax_params=)` takes it:
    {"params": {layer: {leaf: numpy float32}}}, in one copy to the host."""
    leaves = [(layer, leaf, t) for layer, d in tree.items()
              for leaf, t in d.items()]
    flat = torch.cat([t.reshape(-1) for _, _, t in leaves]).cpu().numpy()
    out, off = {}, 0
    for layer, leaf, t in leaves:
        out.setdefault(layer, {})[leaf] = np.ascontiguousarray(
            flat[off:off + t.numel()].reshape(tuple(t.shape)))
        off += t.numel()
    return {"params": out}
