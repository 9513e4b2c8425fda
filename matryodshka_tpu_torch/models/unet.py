"""The MSI prediction U-Net, both variants, the plain version of the net.

Counterpart of `matryodshka_tpu/models/unet.py` (`MSIUNet` with
variant="wrap" or "coord", `SpatialLayerNorm`, `FusedDeconvCrop`,
`WrapConv3x3`, `sph_coord_channel`). Layout is [B, C, H, W]; parameter
names follow the flax tree (`conv1_1`, `conv1_1_ln`, ..., `color_pred`),
with `weight` [Cout, Cin, KH, KW] in place of flax's `kernel`
[KH, KW, Cin, Cout] (see weights.from_flax).

variant="wrap": every 3x3 conv wraps `rate` columns horizontally and
zero-pads `rate` rows vertically (wrap_pad); the 4x4 stride-2 transposed
convs run as the subpixel decomposition of FusedDeconvCrop.

variant="coord" (the released checkpoints' architecture): every 3x3 conv
and stride-2 down sees its input with an |sin(lat)| channel appended last
(so its weight has Cin + 1 input channels) and pads with zeros as flax's
SAME does; the transposed convs are flax's `ConvTranspose(padding="SAME")`,
here `F.conv_transpose2d` with the kernel flipped (flax does not flip it).

smoothed=True (flax's `smoothed`, the checkerboard-free option,
nets.py:186-203): each transposed conv becomes nearest-neighbour 2x
upsampling and a 4x4 conv padded (1, 2) on both axes, the wrap net
wrapping the columns (one on the left, two on the right) and zero-padding
the rows, the coord net zero-padding both, with no coord channel. The
weights keep the [Cout, Cin, 4, 4] shape.

Both: layer norm is over (C, H, W) in float32; the 1x1 head ends in tanh
and returns float32. Convs compute in the model's dtype, as flax's
dtype=compute_dtype does.

wrap_conv_kernel=True (the trainer's net; flax's `use_pallas_conv=True`)
sends the wrap net's stride-1, rate-1 3x3 convs through the wrap-conv
kernel K7 (`ops/wrap_conv.py`, differentiable): with the layer-norm
statistics (K7c) when the input has at least `stats_min_cin` channels (160,
flax's gate: conv1_1, conv3_1, conv3_2, conv6_2 and conv6_3 at ngf 64),
else without (K7b: conv2_1, conv7_2, conv8_2). stats_min_cin=0 sends every
such conv through K7c, as flax's `pallas_interpret=True` does. The other
layers, the layer norm and the ReLU stay PyTorch ops with autograd.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from matryodshka_tpu_torch.ops import wrap_conv
from matryodshka_tpu_torch.ops.conv import coord_column, with_coord, wrap_pad
from matryodshka_tpu_torch.ops.layernorm import layer_norm_relu_plain
from matryodshka_tpu_torch.ops.net import VARIANTS, kernel_cin, unet_plan


class SpatialLayerNorm(nn.Module):
    """Layer norm over (C, H, W) with per-channel scale and offset."""

    def __init__(self, channels: int, eps: float = 1e-12):
        super().__init__()
        self.eps = eps
        self.beta = nn.Parameter(torch.zeros(channels))
        self.gamma = nn.Parameter(torch.ones(channels))

    def forward(self, x, stats=None):
        """stats=(s1, s2, n), the per-sample sums of x and x^2 ([B], float64
        from K7c) over its n values, replaces the reduction passes: mean =
        s1/n and var = max(s2/n - mean^2, 0), formed in float64."""
        if stats is None:
            return layer_norm_relu_plain(x, self.gamma, self.beta, self.eps,
                                         relu=False)
        s1, s2, n = stats
        mean = s1 / n
        var = torch.clamp(s2 / n - mean.square(), min=0.0)
        mean = mean.float()[:, None, None, None]
        rstd = torch.rsqrt(var.float() + self.eps)[:, None, None, None]
        y = ((x.float() - mean) * rstd * self.gamma[:, None, None]
             + self.beta[:, None, None])
        return y.to(x.dtype)


class ConvParams(nn.Module):
    """A conv layer's parameters: weight [Cout, Cin, KH, KW], bias [Cout]."""

    def __init__(self, cin: int, cout: int, k: int):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(cout, cin, k, k))
        self.bias = nn.Parameter(torch.zeros(cout))


def _same_pads(n: int, k: int, stride: int):
    """(lo, hi) of flax/XLA SAME padding for size n and effective kernel
    size k: the odd pixel goes after."""
    total = max((-(-n // stride) - 1) * stride + k - n, 0)
    return total // 2, total - total // 2


class MSIUNet(nn.Module):
    """Blend-weight / alpha prediction net: [B, Cin, H, W] -> tanh
    [B, num_outputs, H, W] float32."""

    def __init__(self, num_inputs: int, num_outputs: int, ngf: int = 64,
                 dtype=torch.bfloat16, variant: str = "wrap",
                 wrap_conv_kernel: bool = False, stats_min_cin: int = 160,
                 smoothed: bool = False):
        super().__init__()
        if variant not in VARIANTS:
            raise ValueError(f"variant {variant!r}; known: {VARIANTS}")
        self.dtype = dtype
        self.variant = variant
        self.smoothed = smoothed
        self.wrap_conv_kernel = wrap_conv_kernel
        self.stats_min_cin = stats_min_cin
        self.plan = unet_plan(ngf, num_inputs, num_outputs)
        for (name, kind, _, cins, cout, _, _, _) in self.plan:
            k = {"deconv": 4, "head": 1}.get(kind, 3)
            self.add_module(name, ConvParams(
                kernel_cin(kind, cins, variant), cout, k))
            if kind != "head":
                self.add_module(name + "_ln", SpatialLayerNorm(cout))

    def _conv(self, x, name: str, stride: int = 1, rate: int = 1):
        layer = getattr(self, name)
        ln = getattr(self, name + "_ln")
        if (self.wrap_conv_kernel and self.variant == "wrap" and stride == 1
                and rate == 1):
            if x.shape[1] >= self.stats_min_cin:
                y, s1, s2 = wrap_conv.wrap_conv3x3(x, layer.weight,
                                                   layer.bias, stats=True)
                y = ln(y, stats=(s1, s2, y[0].numel()))
            else:
                y = ln(wrap_conv.wrap_conv3x3(x, layer.weight, layer.bias))
            return torch.relu(y)
        if self.variant == "coord":
            h, w = x.shape[-2:]
            x = with_coord(x, coord_column(h, x.device))
            top, bottom = _same_pads(h, 2 * rate + 1, stride)
            left, right = _same_pads(w, 2 * rate + 1, stride)
            x = F.pad(x, (left, right, top, bottom))
        else:
            x = wrap_pad(x, rate, rate, rate, rate)
        y = F.conv2d(x, layer.weight.to(x.dtype), stride=stride,
                     dilation=rate)
        y = y + layer.bias.to(x.dtype)[:, None, None]
        return torch.relu(ln(y))

    def _deconv(self, x, name: str):
        """4x4 stride-2 transposed conv. Wrap net: flax ConvTranspose,
        VALID, on the 2-wrap-padded input, cropped 5 per side, in subpixel
        form: out[2i+da, 2j+db] = conv(xpad, k[da::2, db::2]) at
        (1+da+i, 1+db+j). Coord net: flax ConvTranspose, SAME, which pads
        the 2x-dilated input by 2 on each side and does not flip the
        kernel: out[2j+da] = sum_ka x[j+da+ka-1] k[da+2ka], the same as
        F.conv_transpose2d with the kernel flipped and padding 1. Smoothed:
        the upsampling conv of JAX models/unet.py:306-322."""
        layer = getattr(self, name)
        if self.smoothed:
            x = x.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)
            x = (F.pad(x, (1, 2, 1, 2)) if self.variant == "coord"
                 else wrap_pad(x, 1, 2, 1, 2))
            y = F.conv2d(x, layer.weight.to(x.dtype))
            y = y + layer.bias.to(x.dtype)[:, None, None]
            return torch.relu(getattr(self, name + "_ln")(y))
        if self.variant == "coord":
            wt = layer.weight.to(x.dtype).flip(2, 3).transpose(0, 1)
            y = F.conv_transpose2d(x, wt, stride=2, padding=1)
            y = y + layer.bias.to(x.dtype)[:, None, None]
            return torch.relu(getattr(self, name + "_ln")(y))
        b, _, h, w = x.shape
        xp = wrap_pad(x, 2, 2, 2, 2)
        wt = layer.weight.to(x.dtype)
        y = x.new_empty((b, wt.shape[0], 2 * h, 2 * w))
        for da in (0, 1):
            for db in (0, 1):
                c = F.conv2d(xp, wt[:, :, da::2, db::2])
                y[:, :, da::2, db::2] = c[:, :, 1 + da:1 + da + h,
                                          1 + db:1 + db + w]
        y = y + layer.bias.to(x.dtype)[:, None, None]
        return torch.relu(getattr(self, name + "_ln")(y))

    def forward(self, net_input, dtype=None):
        """dtype overrides the compute dtype for this call."""
        dt = self.dtype if dtype is None else dtype
        x = net_input.to(dt)
        cnv1_1 = self._conv(x, "conv1_1")
        cnv1_2 = self._conv(cnv1_1, "conv1_2", stride=2)
        cnv2_1 = self._conv(cnv1_2, "conv2_1")
        cnv2_2 = self._conv(cnv2_1, "conv2_2", stride=2)
        cnv3_1 = self._conv(cnv2_2, "conv3_1")
        cnv3_2 = self._conv(cnv3_1, "conv3_2")
        cnv3_3 = self._conv(cnv3_2, "conv3_3", stride=2)
        cnv4_1 = self._conv(cnv3_3, "conv4_1", rate=2)
        cnv4_2 = self._conv(cnv4_1, "conv4_2", rate=2)
        cnv4_3 = self._conv(cnv4_2, "conv4_3", rate=2)
        cnv6_1 = self._deconv(torch.cat([cnv4_3, cnv3_3], dim=1), "conv6_1")
        cnv6_2 = self._conv(cnv6_1, "conv6_2")
        cnv6_3 = self._conv(cnv6_2, "conv6_3")
        cnv7_1 = self._deconv(torch.cat([cnv6_3, cnv2_2], dim=1), "conv7_1")
        cnv7_2 = self._conv(cnv7_1, "conv7_2")
        cnv8_1 = self._deconv(torch.cat([cnv7_2, cnv1_2], dim=1), "conv8_1")
        cnv8_2 = self._conv(cnv8_1, "conv8_2")
        head = self.color_pred
        pred = F.conv2d(cnv8_2, head.weight.to(dt)) + head.bias.to(dt)[
            :, None, None]
        return torch.tanh(pred).float()


def atlas_pack(pred, height: int, width: int, channels: int = 64):
    """Pack the net's output channels into an 8 x (C/8) image atlas (JAX
    unet.py:373-388, the reference's export-time msi_output tiling,
    nets.py:370-385): pred [1, H, W, >= channels] (NHWC) -> [1, 8H,
    (channels/8) W], channel 8r + c at tile (r, c). blend_psv keeps 64
    channels ([1, 8H, 8W]), alpha_only 32 ([1, 8H, 4W])."""
    cols = channels // 8
    x = pred[..., :channels].permute(0, 3, 1, 2)
    x = x.reshape(1, 8, cols, height, width).permute(0, 1, 3, 2, 4)
    return x.reshape(1, 8 * height, cols * width)
