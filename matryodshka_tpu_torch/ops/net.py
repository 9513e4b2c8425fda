"""The MSI U-Net run stage by stage through the conv kernel.

Counterpart of `matryodshka_tpu/ops/pallas_net.py` (`unet_plan`,
`prepare_params`, `coord_operands`, `unet_forward`), for both variants of
the net. On the TPU the whole net is one kernel because every custom-call
boundary cost XLA its cross-layer pipelining; on the GPU each stage is one
conv launch (`ops/conv.py`), and the layer norm + ReLU between two stages
is fused into them as the TPU kernel fuses it: each stage but the head
stores its raw output with its statistics' partials, and each consumer
normalizes its input as it reads it (`conv(..., norm=, stats=)`). Skip
concats are a `torch.cat` of the two raw sources, whose normalizations
the consumer applies end to end. Activations are [B, C, H, W] in the
compute dtype; the head writes float32. In bfloat16 the activations
between two convs are channels-last (`torch.channels_last`: conv1_1 reads
the sweep's NCHW volume and writes channels-last, the head reads
channels-last and writes the NCHW prediction), which the conv kernel reads
by `ldmatrix`; a skip concat of two channels-last sources is
channels-last. No stage copies a layout.

The two variants share the topology and differ in each stage's padding
(`conv_args`): the wrap net wraps columns horizontally; the coord net pads
with zeros as flax's SAME does and reads an |sin(lat)| coord channel as
the last input channel of every 3x3 conv and stride-2 down (its values per
input row are built once, by `prepare`). A smoothed net (`smoothed=True`:
nearest 2x upsampling and a 4x4 conv in place of each transposed conv)
runs its three upsampling stages in the conv kernel's folded parity form
(`ops/conv.py:pack_smoothed`), so its 18 stages are conv launches too.
"""

from __future__ import annotations

from typing import Dict, List

import torch

from matryodshka_tpu_torch.ops import conv as conv_ops

VARIANTS = ("wrap", "coord")


def unet_plan(ngf: int, cin0: int, num_outputs: int):
    """The topology of both variants, one row per stage:
    (name, kind, srcs, cin_each, cout, in_div, out_div, rate); cin_each
    counts the sources' channels, without the coord channel."""
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


def has_coord(kind: str, variant: str) -> bool:
    """Whether a stage reads the coord channel: the coord net's 3x3 convs
    and stride-2 downs (`MSIUNet._conv` of `models/unet.py`)."""
    return variant == "coord" and kind in ("conv", "down")


def kernel_cin(kind: str, cins, variant: str) -> int:
    """Input channels of a stage's weight."""
    return sum(cins) + has_coord(kind, variant)


def conv_args(kind: str, rate: int, variant: str = "wrap",
              smoothed: bool = False) -> Dict:
    """Keyword arguments of ops.conv.conv for a stage kind (without the
    coord vector, which depends on the input height). The coord net's pads
    are flax's SAME on the even sizes the config guarantees: (rate, rate)
    for a stride-1 conv, (0, 1) for a stride-2 down. The 1x1 head pads
    nothing; the coord net runs it in the zero mode too, so that its 18
    stages are the launches of one mode. A deconv is the transposed conv's
    2x2 parity form, or with smoothed the folded 3x3 parity form of the
    upsampling conv (the wrap net wraps its columns and zero-pads its
    rows, the coord net zero-pads both, with no coord channel, as JAX
    models/unet.py:306-322 pads the upsampled input)."""
    if variant not in VARIANTS:
        raise ValueError(f"variant {variant!r}; known: {VARIANTS}")
    if kind == "head":
        head = dict(kh=1, kw=1, tanh=True, out_dtype=torch.float32)
        return head if variant == "wrap" else dict(head, hpad="zero")
    if kind == "deconv":
        k = 3 if smoothed else 2
        deconv = dict(kh=k, kw=k, npar=4)
        return deconv if variant == "wrap" else dict(deconv, hpad="zero")
    if variant == "wrap":
        if kind == "conv":
            return dict(kh=3, kw=3, stride=1, dil=rate, pad=rate)
        return dict(kh=3, kw=3, stride=2, dil=1, pad=1)
    if kind == "conv":
        return dict(kh=3, kw=3, stride=1, dil=rate, pad=(rate, rate),
                    hpad="zero")
    return dict(kh=3, kw=3, stride=2, dil=1, pad=(0, 1), hpad="zero")


def pack_stage(model, name: str, kind: str, dtype):
    """A stage's packed weight: the transposed conv's parity kernels, a
    smoothed net's folded ones, or a plain conv's."""
    weight = getattr(model, name).weight.detach()
    if kind != "deconv":
        return conv_ops.pack_conv(weight, dtype)
    if model.smoothed:
        return conv_ops.pack_smoothed(weight, dtype)
    return conv_ops.pack_deconv(weight, dtype, smoothed=False, name=name)


def prepare(model, dtype, height: int = None) -> List[Dict]:
    """Kernel operands from an MSIUNet's own parameters: per stage the
    packed weight (compute dtype), the bias (f32), `stats` (whether its
    output is layer-normed, every stage but the head), `norm`, the
    (gamma, beta) f32 of each source's layer norm (None for the net's
    input), `memory_format`, its output's layout (channels-last where the
    next stage reads it by the kernel's channels-last form: every stage
    but the head, in bfloat16), and for the coord net's convs and downs
    the coord channel per input row (float32, `conv.coord_column`), which
    needs the net's input height. Call again after the model's parameters
    change."""
    if model.variant == "coord" and height is None:
        raise ValueError("prepare: the coord net needs the input height")
    ln = {}
    for (name, kind, *_) in model.plan:
        if kind != "head":
            m = getattr(model, name + "_ln")
            ln[name] = (m.gamma.detach().float().contiguous(),
                        m.beta.detach().float().contiguous())
    stages = []
    for (name, kind, srcs, _, _, ind, _, rate) in model.plan:
        layer = getattr(model, name)
        args = conv_args(kind, rate, model.variant, model.smoothed)
        if has_coord(kind, model.variant):
            args["coord"] = conv_ops.coord_column(height // ind,
                                                  layer.weight.device)
        stages.append({
            "name": name, "srcs": srcs, "args": args,
            "w": pack_stage(model, name, kind, dtype),
            "b": layer.bias.detach().float().contiguous(),
            "stats": kind != "head",
            "norm": None if srcs == ["x"] else [ln[s] for s in srcs],
            "memory_format": (torch.channels_last
                              if kind != "head" and dtype == torch.bfloat16
                              else torch.contiguous_format)})
    return stages


def stage_input(st: Dict, acts: Dict):
    """A stage's conv input and its norm from the raw activations and
    their partials, acts[name] = (y, partials): the one source or the
    channel concat of two, with one conv.Norm per source."""
    srcs = [acts[s] for s in st["srcs"]]
    x = srcs[0][0] if len(srcs) == 1 else torch.cat([y for y, _ in srcs],
                                                    dim=1)
    if st["norm"] is None:
        return x, None
    return x, [conv_ops.Norm(part, g, b)
               for (_, part), (g, b) in zip(srcs, st["norm"])]


def unet_forward(stages: List[Dict], x) -> torch.Tensor:
    """x [B, Cin, H, W] in the compute dtype -> tanh prediction
    [B, K, H, W] float32, NCHW-contiguous."""
    acts = {"x": (x, None)}
    y = x
    for st in stages:
        inp, norm = stage_input(st, acts)
        out = conv_ops.conv(inp, st["w"], st["b"], **st["args"], norm=norm,
                            stats=st["stats"],
                            memory_format=st["memory_format"])
        y, part = out if st["stats"] else (out, None)
        acts[st["name"]] = (y, part)
    return y
