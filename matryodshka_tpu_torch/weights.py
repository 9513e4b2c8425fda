"""Parameters for the port's MSIUNet: the flax bridge and a seeded init.

`from_flax` maps a flax MSIUNet parameter tree of either variant, given as
numpy arrays, to the torch state_dict: conv kernels [KH, KW, Cin, Cout]
(the 3x3 convs, the coord net's with Cin + 1 input channels, the 4x4
transposed convs and the 1x1 `color_pred` head) become `weight`
[Cout, Cin, KH, KW]; biases and the `*_ln` gamma/beta carry over; `to_flax`
maps back (the trainer's checkpoints hold that tree). `seeded_init` draws
a tree of flax's shapes for cfg's variant with flax's initializers
(lecun_normal kernels, zero biases, unit gamma, zero beta) from a numpy
seed, for machines without JAX. `elpips_from_jax` maps the JAX package's
E-LPIPS feature weights (HWIO) to the port's (OIHW).
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Dict

import numpy as np
import torch

from matryodshka_tpu_torch.ops.net import kernel_cin, unet_plan

#: flax's truncated-normal stddev correction for truncation at +-2 sigma.
_TRUNC_STD = 0.87962566103423978


def from_flax(params) -> "OrderedDict[str, torch.Tensor]":
    """flax tree ({"params": {layer: {leaf: array}}} or the inner dict) ->
    state_dict. Raises on any leaf it does not map."""
    tree = params["params"] if "params" in params else params
    out = OrderedDict()
    for layer, leaves in tree.items():
        for leaf, value in leaves.items():
            arr = torch.from_numpy(np.array(value, dtype=np.float32))
            if leaf == "kernel" and arr.ndim == 4:
                out[f"{layer}.weight"] = arr.permute(3, 2, 0, 1).contiguous()
            elif leaf in ("bias", "gamma", "beta") and arr.ndim == 1:
                out[f"{layer}.{leaf}"] = arr
            else:
                raise KeyError(f"from_flax: unmapped leaf {layer}/{leaf} "
                               f"{tuple(arr.shape)}")
    return out


def to_flax(state_dict) -> Dict:
    """The inverse of from_flax: a state_dict (`<layer>.weight` [Cout, Cin,
    KH, KW], `<layer>.bias`, `<layer>.gamma`, `<layer>.beta`) -> the flax
    tree {"params": {layer: {leaf: float32 numpy array}}}."""
    tree: Dict = {}
    for key, value in state_dict.items():
        layer, leaf = key.rsplit(".", 1)
        arr = value.detach().float().cpu().numpy()
        if leaf == "weight" and arr.ndim == 4:
            tree.setdefault(layer, {})["kernel"] = np.ascontiguousarray(
                arr.transpose(2, 3, 1, 0))
        elif leaf in ("bias", "gamma", "beta") and arr.ndim == 1:
            tree.setdefault(layer, {})[leaf] = arr
        else:
            raise KeyError(f"to_flax: unmapped entry {key} "
                           f"{tuple(arr.shape)}")
    return {"params": tree}


def _lecun_normal(rng: np.random.RandomState, shape):
    """flax.linen.initializers.lecun_normal(): truncated normal (+-2) with
    variance 1 / fan_in, fan_in = prod(shape[:-1])."""
    fan_in = int(np.prod(shape[:-1]))
    std = np.sqrt(1.0 / fan_in) / _TRUNC_STD
    z = rng.standard_normal(shape)
    bad = np.abs(z) > 2.0
    while bad.any():
        z[bad] = rng.standard_normal(int(bad.sum()))
        bad = np.abs(z) > 2.0
    return (z * std).astype(np.float32)


def seeded_init(cfg, seed: int) -> Dict:
    """A flax-layout parameter tree {"params": {...}} of numpy arrays for
    cfg's net (its variant from cfg.coord_net), drawn from
    np.random.RandomState(seed)."""
    rng = np.random.RandomState(seed)
    tree = {}
    for (name, kind, _, cins, cout, _, _, _) in unet_plan(
            cfg.ngf, cfg.num_net_inputs(), cfg.num_net_outputs()):
        k = {"deconv": 4, "head": 1}.get(kind, 3)
        cin = kernel_cin(kind, cins, cfg.net_variant)
        tree[name] = {"kernel": _lecun_normal(rng, (k, k, cin, cout)),
                      "bias": np.zeros((cout,), np.float32)}
        if kind != "head":
            tree[name + "_ln"] = {"beta": np.zeros((cout,), np.float32),
                                  "gamma": np.ones((cout,), np.float32)}
    return {"params": tree}


def elpips_from_jax(net_w) -> Dict[str, torch.Tensor]:
    """The JAX package's E-LPIPS feature weights {'<torch_idx>.weight':
    [KH, KW, Cin, Cout], '<torch_idx>.bias': [Cout]} (numpy) -> the port's
    {'<torch_idx>.weight': [Cout, Cin, KH, KW], ...} float32 tensors."""
    out = {}
    for key, value in net_w.items():
        arr = torch.from_numpy(np.array(value, dtype=np.float32))
        if arr.ndim == 4:
            arr = arr.permute(3, 2, 0, 1).contiguous()
        elif arr.ndim != 1:
            raise KeyError(f"elpips_from_jax: unmapped {key} "
                           f"{tuple(arr.shape)}")
        out[key] = arr
    return out
