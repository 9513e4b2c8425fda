"""The MSI prediction U-Net (the MatryODShka paper's Fig. 3; the upstream
`nets.py`), both variants, from a flax-layout weight tree.

The tree maps each layer name to {"kernel": [KH, KW, Cin, Cout], "bias":
[Cout]} and each normed layer's name + "_ln" to {"gamma", "beta"} [Cout].
Every conv but the head is followed by a layer norm over (C, H, W) per
example (eps 1e-12) and a ReLU; the 1x1 head ends in tanh.

wrap (the trainer's default): each 3x3 conv wraps `rate` columns
horizontally and zero-pads `rate` rows; each 4x4 stride-2 transposed conv is
flax's VALID ConvTranspose of the 2-wrap-padded input, cropped 5 a side.
coord (the released checkpoints): each 3x3 conv and stride-2 down sees its
input with an |sin(lat)| channel appended last and pads as flax's SAME; each
transposed conv is flax's SAME ConvTranspose, which does not flip its kernel.

`q`, where given, rounds what the program stores in its compute dtype: the
net input, each conv's weight and input, and each conv's raw output but
the head's (the head writes float32).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def plan(ngf: int, cin0: int, nout: int):
    """(name, kind, sources, cout, rate) per stage, in order."""
    g = ngf
    return [
        ("conv1_1", "conv", ["x"], g, 1),
        ("conv1_2", "down", ["conv1_1"], 2 * g, 1),
        ("conv2_1", "conv", ["conv1_2"], 2 * g, 1),
        ("conv2_2", "down", ["conv2_1"], 4 * g, 1),
        ("conv3_1", "conv", ["conv2_2"], 4 * g, 1),
        ("conv3_2", "conv", ["conv3_1"], 4 * g, 1),
        ("conv3_3", "down", ["conv3_2"], 8 * g, 1),
        ("conv4_1", "conv", ["conv3_3"], 8 * g, 2),
        ("conv4_2", "conv", ["conv4_1"], 8 * g, 2),
        ("conv4_3", "conv", ["conv4_2"], 8 * g, 2),
        ("conv6_1", "deconv", ["conv4_3", "conv3_3"], 4 * g, 1),
        ("conv6_2", "conv", ["conv6_1"], 4 * g, 1),
        ("conv6_3", "conv", ["conv6_2"], 4 * g, 1),
        ("conv7_1", "deconv", ["conv6_3", "conv2_2"], 2 * g, 1),
        ("conv7_2", "conv", ["conv7_1"], 2 * g, 1),
        ("conv8_1", "deconv", ["conv7_2", "conv1_2"], g, 1),
        ("conv8_2", "conv", ["conv8_1"], g, 1),
        ("color_pred", "head", ["conv8_2"], nout, 1),
    ]


def layer_shapes(ngf: int, cin0: int, nout: int, variant: str):
    """{layer: {leaf: shape}} of the flax tree of a net."""
    cout = {"x": cin0}
    shapes = {}
    for name, kind, srcs, co, _ in plan(ngf, cin0, nout):
        cin = sum(cout[s] for s in srcs)
        cin += int(variant == "coord" and kind in ("conv", "down"))
        k = {"deconv": 4, "head": 1}.get(kind, 3)
        shapes[name] = {"kernel": (k, k, cin, co), "bias": (co,)}
        if kind != "head":
            shapes[name + "_ln"] = {"gamma": (co,), "beta": (co,)}
        cout[name] = co
    return shapes


def _same_pads(n: int, k: int, stride: int):
    total = max((-(-n // stride) - 1) * stride + k - n, 0)
    return total // 2, total - total // 2


def _wrap_pad(x, top: int, bottom: int, left: int, right: int):
    w = x.shape[-1]
    x = torch.cat([x[..., w - left:], x, x[..., :right]], dim=-1)
    return F.pad(x, (0, 0, top, bottom))


def _coord(x):
    """x with |sin(lat)| appended as its last channel, lat =
    linspace(-pi/2, pi/2, H) in float64, stored as float32."""
    b, _, h, w = x.shape
    col = torch.from_numpy(np.abs(np.sin(np.linspace(
        -np.pi / 2, np.pi / 2, h))).astype(np.float32)).to(x.device)
    return torch.cat([x, col[None, None, :, None].expand(b, 1, h, w)], 1)


def _layer_norm_relu(y, gamma, beta):
    mean = y.mean(dim=(1, 2, 3), keepdim=True)
    var = (y - mean).square().mean(dim=(1, 2, 3), keepdim=True)
    y = (y - mean) * torch.rsqrt(var + 1e-12) * gamma[:, None, None] \
        + beta[:, None, None]
    return torch.relu(y)


def forward(tree, x, variant: str, ngf: int, q=None):
    """x [B, Cin, H, W] -> tanh prediction [B, K, H, W] float32."""
    q = q or (lambda t: t)
    nout = tree["color_pred"]["bias"].shape[0]
    acts = {"x": q(x.float())}
    for name, kind, srcs, _, rate in plan(ngf, x.shape[1], nout):
        inp = torch.cat([acts[s] for s in srcs], dim=1)
        k = tree[name]["kernel"].float()
        wt = q(k.permute(3, 2, 0, 1).contiguous())          # [Co, Ci, k, k]
        bias = tree[name]["bias"].float()[:, None, None]
        if kind == "head":
            acts[name] = torch.tanh(F.conv2d(inp, wt) + bias)
            break
        if kind == "deconv" and variant == "coord":
            y = F.conv_transpose2d(inp, wt.flip(2, 3).transpose(0, 1),
                                   stride=2, padding=1)
        elif kind == "deconv":
            b, _, h, w = inp.shape
            xp = _wrap_pad(inp, 2, 2, 2, 2)
            y = inp.new_empty((b, wt.shape[0], 2 * h, 2 * w))
            for da in (0, 1):
                for db in (0, 1):
                    c = F.conv2d(xp, wt[:, :, da::2, db::2])
                    y[:, :, da::2, db::2] = c[:, :, 1 + da:1 + da + h,
                                              1 + db:1 + db + w]
        else:
            stride = 2 if kind == "down" else 1
            if variant == "coord":
                inp = q(_coord(inp))
                h, w = inp.shape[-2:]
                t, bt = _same_pads(h, 2 * rate + 1, stride)
                lf, rt = _same_pads(w, 2 * rate + 1, stride)
                inp = F.pad(inp, (lf, rt, t, bt))
            else:
                inp = _wrap_pad(inp, rate, rate, rate, rate)
            y = F.conv2d(inp, wt, stride=stride, dilation=rate)
        y = q(y + bias)
        ln = tree[name + "_ln"]
        acts[name] = q(_layer_norm_relu(y, ln["gamma"].float(),
                                        ln["beta"].float()))
    return acts["color_pred"]
