"""The MSI prediction U-Net (wrap variant), the plain version of the net.

Counterpart of `matryodshka_tpu/models/unet.py` (`MSIUNet` with
variant="wrap", `SpatialLayerNorm`, `FusedDeconvCrop`, `WrapConv3x3`).
Layout is [B, C, H, W]; parameter names follow the flax tree (`conv1_1`,
`conv1_1_ln`, ..., `color_pred`), with `weight` [Cout, Cin, KH, KW] in
place of flax's `kernel` [KH, KW, Cin, Cout] (see weights.from_flax).

Every 3x3 conv wraps `rate` columns horizontally and zero-pads `rate` rows
vertically (wrap_pad); the 4x4 stride-2 transposed convs run as the
subpixel decomposition of FusedDeconvCrop; layer norm is over (C, H, W)
in float32; the 1x1 head ends in tanh and returns float32. Convs compute
in the model's dtype, as flax's dtype=compute_dtype does.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from matryodshka_tpu_torch.ops.conv import wrap_pad
from matryodshka_tpu_torch.ops.layernorm import layer_norm_relu_plain
from matryodshka_tpu_torch.ops.net import unet_plan


class SpatialLayerNorm(nn.Module):
    """Layer norm over (C, H, W) with per-channel scale and offset."""

    def __init__(self, channels: int, eps: float = 1e-12):
        super().__init__()
        self.eps = eps
        self.beta = nn.Parameter(torch.zeros(channels))
        self.gamma = nn.Parameter(torch.ones(channels))

    def forward(self, x):
        return layer_norm_relu_plain(x, self.gamma, self.beta, self.eps,
                                     relu=False)


class ConvParams(nn.Module):
    """A conv layer's parameters: weight [Cout, Cin, KH, KW], bias [Cout]."""

    def __init__(self, cin: int, cout: int, k: int):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(cout, cin, k, k))
        self.bias = nn.Parameter(torch.zeros(cout))


class MSIUNet(nn.Module):
    """Blend-weight / alpha prediction net: [B, Cin, H, W] -> tanh
    [B, num_outputs, H, W] float32."""

    def __init__(self, num_inputs: int, num_outputs: int, ngf: int = 64,
                 dtype=torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        self.plan = unet_plan(ngf, num_inputs, num_outputs)
        for (name, kind, _, cins, cout, _, _, _) in self.plan:
            k = {"deconv": 4, "head": 1}.get(kind, 3)
            self.add_module(name, ConvParams(sum(cins), cout, k))
            if kind != "head":
                self.add_module(name + "_ln", SpatialLayerNorm(cout))

    def _conv(self, x, name: str, stride: int = 1, rate: int = 1):
        layer = getattr(self, name)
        y = F.conv2d(wrap_pad(x, rate, rate, rate, rate),
                     layer.weight.to(x.dtype), stride=stride, dilation=rate)
        y = y + layer.bias.to(x.dtype)[:, None, None]
        return torch.relu(getattr(self, name + "_ln")(y))

    def _deconv(self, x, name: str):
        """4x4 stride-2 transposed conv (flax ConvTranspose, VALID, on the
        2-wrap-padded input, cropped 5 per side) in subpixel form:
        out[2i+da, 2j+db] = conv(xpad, k[da::2, db::2]) at (1+da+i, 1+db+j)."""
        layer = getattr(self, name)
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
