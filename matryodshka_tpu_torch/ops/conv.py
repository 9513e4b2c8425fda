"""Wrap-padded convolution for the U-Net: weight packing, kernel wrapper
and its plain version.

The kernel is `csrc/conv.cu` (the conv block of
`matryodshka_tpu/ops/pallas_net.py:_build_kernel`); its source note gives
the bound and the design. One call is one layer, in one of two forms:

* npar=1: a KHxKW conv with stride and dilation; input rows outside
  [0, H) read zero, input columns wrap mod W (`wrap_pad` of
  `models/unet.py`), `pad` rows/columns on each side;
* npar=4: the 4x4 stride-2 transposed conv as four 2x2 parity convs
  (`FusedDeconvCrop`): parity (da, db) pads (1 - da, 1 - db) before and
  (da, db) after, and writes output pixels (2i + da, 2j + db).

Weights are packed [npar, KH*KW*Cin, Cout], k = (kh*KW + kw)*Cin + c.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from matryodshka_tpu_torch.ops import _build

#: Launches of the conv kernel in this process.
launches = 0


def pack_conv(weight, dtype):
    """[Cout, Cin, KH, KW] -> [1, KH*KW*Cin, Cout]."""
    cout = weight.shape[0]
    return weight.permute(2, 3, 1, 0).reshape(1, -1, cout).to(
        dtype).contiguous()


def pack_deconv(weight, dtype):
    """Transposed-conv kernel [Cout, Cin, 4, 4] -> the four 2x2 parity
    kernels [4, 4*Cin, Cout]; parity da*2 + db takes taps
    weight[..., da + 2*ka, db + 2*kb]."""
    return torch.cat([pack_conv(weight[:, :, da::2, db::2], dtype)
                      for da in (0, 1) for db in (0, 1)]).contiguous()


def _unpack(wk, par: int, kh: int, kw: int):
    k, cout = wk.shape[1:]
    return wk[par].reshape(kh, kw, k // (kh * kw), cout).permute(3, 2, 0, 1)


def wrap_pad(x, top: int, bottom: int, left: int, right: int):
    """Horizontal wrap padding by (left, right) columns and vertical zero
    padding by (top, bottom) rows of [..., H, W]."""
    w = x.shape[-1]
    x = torch.cat([x[..., w - left:], x, x[..., :right]], dim=-1)
    return F.pad(x, (0, 0, top, bottom))


def out_size(h: int, w: int, kh: int, kw: int, stride: int, dil: int,
             pad: int, npar: int):
    """(Ho, Wo) of the GEMM grid; the written tensor is (2Ho, 2Wo) for
    npar=4."""
    if npar == 4:
        return h, w
    return ((h + 2 * pad - dil * (kh - 1) - 1) // stride + 1,
            (w + 2 * pad - dil * (kw - 1) - 1) // stride + 1)


def conv_plain(x, wk, bias, kh: int, kw: int, stride: int = 1, dil: int = 1,
               pad: int = 0, npar: int = 1, tanh: bool = False,
               out_dtype=None):
    """Plain version of the kernel: f32 math on the given operands, one
    rounding to out_dtype (default x.dtype)."""
    out_dtype = x.dtype if out_dtype is None else out_dtype
    x32 = x.float()
    if npar == 1:
        y = F.conv2d(wrap_pad(x32, pad, pad, pad, pad),
                     _unpack(wk, 0, kh, kw).float(), stride=stride,
                     dilation=dil)
    else:
        b, _, h, w = x.shape
        y = x32.new_empty((b, wk.shape[2], 2 * h, 2 * w))
        for par in range(4):
            da, db = par >> 1, par & 1
            y[:, :, da::2, db::2] = F.conv2d(
                wrap_pad(x32, 1 - da, da, 1 - db, db),
                _unpack(wk, par, 2, 2).float())
    y = y + bias.float()[None, :, None, None]
    if tanh:
        y = torch.tanh(y)
    return y.to(out_dtype)


def conv(x, wk, bias, kh: int, kw: int, stride: int = 1, dil: int = 1,
         pad: int = 0, npar: int = 1, tanh: bool = False, out_dtype=None):
    """One conv layer: the CUDA kernel for CUDA tensors, the plain version
    for CPU tensors. x [B, Cin, H, W]; wk from pack_conv / pack_deconv;
    bias [Cout] float32."""
    if x.device.type == "cpu":
        return conv_plain(x, wk, bias, kh, kw, stride, dil, pad, npar, tanh,
                          out_dtype)
    global launches
    out_dtype = x.dtype if out_dtype is None else out_dtype
    b, cin, h, w = x.shape
    cout = wk.shape[2]
    req = _build.require
    req(x.is_cuda, f"conv: unsupported device {x.device}")
    req(x.dtype in (torch.float32, torch.bfloat16) and x.is_contiguous(),
        f"conv: x must be contiguous float32/bfloat16, got {x.dtype}")
    req(wk.dtype == x.dtype and wk.is_contiguous() and wk.device == x.device
        and tuple(wk.shape) == (npar, kh * kw * cin, cout),
        f"conv: packed weight {wk.dtype} {tuple(wk.shape)}")
    req(bias.dtype == torch.float32 and bias.is_contiguous()
        and bias.device == x.device and tuple(bias.shape) == (cout,),
        f"conv: bias {bias.dtype} {tuple(bias.shape)}")
    req(out_dtype in (torch.float32, torch.bfloat16),
        f"conv: out_dtype {out_dtype}")
    req(npar == 1 or (npar == 4 and kh == 2 and kw == 2 and stride == 1
                      and dil == 1),
        "conv: npar=4 is the 2x2 parity form of the transposed conv")
    ho, wo = out_size(h, w, kh, kw, stride, dil, pad, npar)
    oh, ow = (2 * ho, 2 * wo) if npar == 4 else (ho, wo)
    out = torch.empty((b, cout, oh, ow), dtype=out_dtype, device=x.device)
    err = _build.lib().matry_conv(
        x.data_ptr(), wk.data_ptr(), bias.data_ptr(), out.data_ptr(),
        b, cin, h, w, cout, ho, wo, kh, kw, stride, dil,
        1 if npar == 4 else pad, 1 if npar == 4 else pad, npar, oh, ow,
        int(tanh), int(x.dtype == torch.float32),
        int(out_dtype == torch.float32), _build.stream_ptr(x.device))
    _build.check(err, "matry_conv")
    launches += 1
    return out
