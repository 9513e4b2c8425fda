"""The MSI U-Net run stage by stage through the conv and layer-norm kernels.

Counterpart of `matryodshka_tpu/ops/pallas_net.py` (`unet_plan`,
`prepare_params`, `unet_forward`). On the TPU the whole net is one kernel
because every custom-call boundary cost XLA its cross-layer pipelining; on
the GPU each stage is one conv launch (`ops/conv.py`) and, except for the
head, one layer-norm launch (`ops/layernorm.py`). Skip concats are a
`torch.cat` of the two sources. Activations are [B, C, H, W] in the
compute dtype; the head writes float32.
"""

from __future__ import annotations

from typing import Dict, List

import torch

from matryodshka_tpu_torch.ops import conv as conv_ops
from matryodshka_tpu_torch.ops import layernorm as ln_ops


def unet_plan(ngf: int, cin0: int, num_outputs: int):
    """The wrap-variant topology, one row per stage:
    (name, kind, srcs, cin_each, cout, in_div, out_div, rate)."""
    g = ngf
    return [
        ("conv1_1", "conv", ["x"], [cin0], g, 1, 1, 1),
        ("conv1_2", "down", ["conv1_1"], [g], 2 * g, 1, 2, 1),
        ("conv2_1", "conv", ["conv1_2"], [2 * g], 2 * g, 2, 2, 1),
        ("conv2_2", "down", ["conv2_1"], [2 * g], 4 * g, 2, 4, 1),
        ("conv3_1", "conv", ["conv2_2"], [4 * g], 4 * g, 4, 4, 1),
        ("conv3_2", "conv", ["conv3_1"], [4 * g], 4 * g, 4, 4, 1),
        ("conv3_3", "down", ["conv3_2"], [4 * g], 8 * g, 4, 8, 1),
        ("conv4_1", "conv", ["conv3_3"], [8 * g], 8 * g, 8, 8, 2),
        ("conv4_2", "conv", ["conv4_1"], [8 * g], 8 * g, 8, 8, 2),
        ("conv4_3", "conv", ["conv4_2"], [8 * g], 8 * g, 8, 8, 2),
        ("conv6_1", "deconv", ["conv4_3", "conv3_3"], [8 * g, 8 * g],
         4 * g, 8, 4, 1),
        ("conv6_2", "conv", ["conv6_1"], [4 * g], 4 * g, 4, 4, 1),
        ("conv6_3", "conv", ["conv6_2"], [4 * g], 4 * g, 4, 4, 1),
        ("conv7_1", "deconv", ["conv6_3", "conv2_2"], [4 * g, 4 * g],
         2 * g, 4, 2, 1),
        ("conv7_2", "conv", ["conv7_1"], [2 * g], 2 * g, 2, 2, 1),
        ("conv8_1", "deconv", ["conv7_2", "conv1_2"], [2 * g, 2 * g],
         g, 2, 1, 1),
        ("conv8_2", "conv", ["conv8_1"], [g], g, 1, 1, 1),
        ("color_pred", "head", ["conv8_2"], [g], num_outputs, 1, 1, 1),
    ]


def conv_args(kind: str, rate: int) -> Dict:
    """Keyword arguments of ops.conv.conv for a stage kind."""
    if kind == "conv":
        return dict(kh=3, kw=3, stride=1, dil=rate, pad=rate)
    if kind == "down":
        return dict(kh=3, kw=3, stride=2, dil=1, pad=1)
    if kind == "deconv":
        return dict(kh=2, kw=2, npar=4)
    return dict(kh=1, kw=1, tanh=True, out_dtype=torch.float32)


def prepare(model, dtype) -> List[Dict]:
    """Kernel operands from an MSIUNet's own parameters: per stage the
    packed weight (compute dtype), the bias and the LN gamma/beta (f32).
    Call again after the model's parameters change."""
    stages = []
    for (name, kind, srcs, _, _, _, _, rate) in model.plan:
        layer = getattr(model, name)
        pack = (conv_ops.pack_deconv if kind == "deconv"
                else conv_ops.pack_conv)
        st = {"name": name, "srcs": srcs,
              "args": conv_args(kind, rate),
              "w": pack(layer.weight.detach(), dtype),
              "b": layer.bias.detach().float().contiguous()}
        if kind != "head":
            ln = getattr(model, name + "_ln")
            st["gamma"] = ln.gamma.detach().float().contiguous()
            st["beta"] = ln.beta.detach().float().contiguous()
        stages.append(st)
    return stages


def unet_forward(stages: List[Dict], x) -> torch.Tensor:
    """x [B, Cin, H, W] in the compute dtype -> tanh prediction
    [B, K, H, W] float32."""
    acts = {"x": x}
    y = x
    for st in stages:
        srcs = [acts[s] for s in st["srcs"]]
        inp = srcs[0] if len(srcs) == 1 else torch.cat(srcs, dim=1)
        y = conv_ops.conv(inp, st["w"], st["b"], **st["args"])
        if "gamma" in st:
            y = ln_ops.layer_norm_relu(y, st["gamma"], st["beta"])
        acts[st["name"]] = y
    return y
