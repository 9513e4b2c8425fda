"""Parameters for the port's nets: the flax bridges and a seeded init.

`from_flax` maps a flax MSIUNet parameter tree of either variant, given as
numpy arrays, to the torch state_dict: conv kernels [KH, KW, Cin, Cout]
(the 3x3 convs, the coord net's with Cin + 1 input channels, the 4x4
transposed convs and the 1x1 `color_pred` head) become `weight`
[Cout, Cin, KH, KW]; biases and the `*_ln` gamma/beta carry over; `to_flax`
maps back (the trainer's checkpoints hold that tree). `seeded_init` draws
a tree of flax's shapes for cfg's variant with flax's initializers
(lecun_normal kernels, zero biases, unit gamma, zero beta) from a numpy
seed, for machines without JAX. `gcn_from_flax` / `gcn_to_flax` bridge
the GCN's tree (`conv1_1/weights_0`, ...), unchanged values both ways;
`net_to_flax` / `net_from_flax` pick the bridge of a net's family.
`elpips_from_jax` maps the JAX package's
E-LPIPS feature weights (HWIO) to the port's (OIHW).
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Dict

import numpy as np
import torch

from matryodshka_tpu_torch.models.gcn import GCNNet, glorot_range, \
    layer_shapes
from matryodshka_tpu_torch.ops.net import kernel_cin, unet_plan

#: Supports of the GCN (icosphere.support_matrices: identity, adjacency).
GCN_SUPPORTS = 2

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


def gcn_from_flax(params) -> "OrderedDict[str, torch.Tensor]":
    """A flax GCNNet tree ({"params": {layer: {"weights_<i>": [in, out],
    "bias": [out]}}} or the inner dict) -> the port GCNNet's state_dict.
    The values are copied unchanged: both keep flax's uncentred weights
    (models/gcn.py). Raises on any leaf it does not map."""
    tree = params["params"] if "params" in params else params
    out = OrderedDict()
    for layer, leaves in tree.items():
        for leaf, value in leaves.items():
            arr = torch.from_numpy(np.array(value, dtype=np.float32))
            if not ((leaf.startswith("weights_") and arr.ndim == 2)
                    or (leaf == "bias" and arr.ndim == 1)):
                raise KeyError(f"gcn_from_flax: unmapped leaf {layer}/{leaf} "
                               f"{tuple(arr.shape)}")
            out[f"{layer}.{leaf}"] = arr
    return out


def gcn_to_flax(state_dict) -> Dict:
    """The inverse of gcn_from_flax: a GCNNet state_dict -> {"params":
    {layer: {leaf: float32 numpy array}}}, bit for bit."""
    tree: Dict = {}
    for key, value in state_dict.items():
        layer, leaf = key.rsplit(".", 1)
        tree.setdefault(layer, {})[leaf] = \
            value.detach().float().cpu().numpy()
    return {"params": tree}


def net_to_flax(net) -> Dict:
    """The flax tree of a trainer's net: a GCNNet's (gcn_to_flax) or an
    MSIUNet's (to_flax)."""
    bridge = gcn_to_flax if isinstance(net, GCNNet) else to_flax
    return bridge(net.state_dict())


def net_from_flax(net, tree) -> "OrderedDict[str, torch.Tensor]":
    """The state_dict of a flax tree for net's family (gcn_from_flax or
    from_flax)."""
    return (gcn_from_flax if isinstance(net, GCNNet) else from_flax)(tree)


def seeded_init(cfg, seed: int) -> Dict:
    """A flax-layout parameter tree {"params": {...}} of numpy arrays for
    cfg's net (the GCN with cfg.gcn, else the U-Net of cfg.coord_net's
    variant), drawn from np.random.RandomState(seed)."""
    rng = np.random.RandomState(seed)
    if cfg.gcn:
        return _seeded_gcn(rng, cfg)
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


def _seeded_gcn(rng: np.random.RandomState, cfg) -> Dict:
    """flax GraphConv's initializers: each weights_<i> uniform in [0, 2r)
    (stored uncentred, models/gcn.py), zero biases."""
    tree = {}
    for name, cin, cout in layer_shapes(cfg.num_net_inputs(),
                                        cfg.num_net_outputs(), cfg.ngf):
        r = glorot_range(cin, cout)
        tree[name] = {f"weights_{i}": (rng.random_sample((cin, cout))
                                       * (2 * r)).astype(np.float32)
                      for i in range(GCN_SUPPORTS)}
        tree[name]["bias"] = np.zeros((cout,), np.float32)
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
