"""The per-layer 3x3 wrap convolution (K7) and its gradient: kernel
wrappers, plain versions, launch counters and the autograd Function.

Counterpart of `matryodshka_tpu/ops/pallas_conv.py`. A stride-1 3x3 conv
whose input columns wrap mod W and whose rows outside [0, H) read zero
(`wrap_pad` of `models/unet.py`), in three forms:

* `conv3x3_wrap` (K7a, `pallas_conv.conv3x3_wrap`): float32 output from
  inputs of either dtype, the bias added in float32.
* `conv3x3_wrap_dma` (K7b, `pallas_conv.conv3x3_wrap_dma`): output in x's
  dtype. The port adds the bias in float32 before the single rounding; the
  TPU kernel adds it in the output dtype after rounding, so the two may
  differ by one step of that dtype (one bf16 step for bf16 outputs).
* `conv3x3_ln_stats` (K7c, `pallas_conv.conv3x3_ln_stats`): y = conv +
  bias rounded once to x's dtype, and per sample (s1, s2) = (sum y,
  sum y^2) over the ROUNDED y, float64 [B], for `SpatialLayerNorm(stats=)`.

Layout is the port's: x [B, Cin, H, W], weight [Cout, Cin, 3, 3] (the
parameter, float32 or bfloat16), bias [Cout] (float32 or bfloat16; the
kernel adds it in float32). There is no lane padding:
`cin_pad` / `cout_pad` are TPU artefacts. The kernels are `csrc/conv.cu`
in its wrap mode (the STATS epilogue for K7c) and, for the weight
gradient, `csrc/conv_wgrad.cu`; their source notes give the bounds.

The gradient (`WrapConv3x3Fn`, which the JAX package never needed: its
trainer runs XLA's convs) is hand-written too:

* dgrad: the same kernel in its float32-output form (K7a) on the adjoint
  weights W'[ci, co, kh, kw] = W[co, ci, 2 - kh, 2 - kw], exact for stride
  1 and rate 1 with wrap in W and zeros in H; skipped when the input needs
  no gradient (the first layer reads the sweep);
* wgrad and the bias gradient: `csrc/conv_wgrad.cu` (wgmma fed by TMA
  for bfloat16 operands, its split partials folded in the same launch;
  exact float32 FMA for float32 ones). `wgrad_plan` mirrors the bfloat16
  launch's plan.

For K7c the incoming gradient first becomes gy + gs1 + 2 y gs2, in float32.
Each kernel reads its operands in x's dtype (the gradient is rounded to it
once, as a gradient of a bf16 tensor is bf16 in JAX).

Every wrapper runs its plain version (float32 math on operands rounded to
x's dtype, one rounding of the output; float64 throughout for float64
inputs, which `torch.autograd.gradcheck` uses) for CPU tensors, and
launches its kernel or raises for CUDA tensors.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch
import torch.nn.functional as F

from matryodshka_tpu_torch.ops import _build
from matryodshka_tpu_torch.ops import conv as conv_ops
from matryodshka_tpu_torch.ops.conv import pack_conv, wrap_pad

#: Launches of each form's kernel in this process. K7a's count includes
#: the backward's input gradients, which are K7a launches.
k7a_launches = 0
k7b_launches = 0
k7c_launches = 0
#: Launches of the weight-gradient kernel (csrc/conv_wgrad.cu).
wgrad_launches = 0

#: Blocks the float32 weight-gradient kernel aims to have in flight (4 per
#: SM of an H100) when it splits the pixel sum, and the fewest pixels per
#: split.
_WGRAD_BLOCKS = 4 * 132
_WGRAD_MIN_CHUNK = 256
#: The bfloat16 (wgmma) weight-gradient kernel's tile: input channels
#: (wgmma M) and output channels (wgmma N), each pair with its nine taps;
#: the halo columns its windows hold either side of a k-step; and the
#: floats of one tile's split partial (nine taps of 64 x 64 accumulators
#: and the 64 bias sums).
WGRAD_TILE = (64, 64)
WGRAD_HALO = 8
WGRAD_TILE_ENTRIES = 9 * 64 * 64 + 64
#: SMs of an H100, the plan's default.
H100_SMS = 132


def _acc(x) -> torch.dtype:
    """The plain versions' math dtype: float64 for float64 x, else
    float32."""
    return torch.float64 if x.dtype == torch.float64 else torch.float32


def adjoint(weight):
    """W'[ci, co, kh, kw] = W[co, ci, 2 - kh, 2 - kw]: the weight whose wrap
    conv of dL/dy is dL/dx."""
    return weight.flip(2, 3).transpose(0, 1)


# ---------------------------------------------------------------------------
# Plain versions.
# ---------------------------------------------------------------------------

def _conv_plain(x, weight, bias, out_dtype):
    acc = _acc(x)
    y = F.conv2d(wrap_pad(x.to(acc), 1, 1, 1, 1),
                 weight.to(x.dtype).to(acc))
    if bias is not None:
        y = y + bias.to(acc)[:, None, None]
    return y.to(out_dtype)


def conv3x3_wrap_plain(x, weight, bias=None):
    """K7a's plain version: float32 output (float64 for float64 x)."""
    return _conv_plain(x, weight, bias, _acc(x))


def conv3x3_wrap_dma_plain(x, weight, bias=None):
    """K7b's plain version: output in x's dtype."""
    return _conv_plain(x, weight, bias, x.dtype)


def conv3x3_ln_stats_plain(x, weight, bias):
    """K7c's plain version: (y in x's dtype, s1, s2 float64 [B])."""
    y = _conv_plain(x, weight, bias, x.dtype)
    y64 = y.double()
    return y, y64.sum(dim=(1, 2, 3)), y64.square().sum(dim=(1, 2, 3))


def conv3x3_wrap_wgrad_plain(g, x):
    """The weight-gradient kernel's plain version: (dW [Cout, Cin, 3, 3],
    db [Cout]) float32 (float64 for float64 x)."""
    acc = _acc(x)
    g = g.to(x.dtype).to(acc)
    dw = torch.nn.grad.conv2d_weight(
        wrap_pad(x.to(acc), 1, 1, 1, 1), (g.shape[1], x.shape[1], 3, 3), g)
    return dw, g.sum(dim=(0, 2, 3))


# ---------------------------------------------------------------------------
# Kernel wrappers.
# ---------------------------------------------------------------------------

def _check(x, weight, bias, name):
    req = _build.require
    b, cin, h, w = x.shape
    req(x.is_cuda, f"{name}: unsupported device {x.device}")
    req(x.dtype in (torch.float32, torch.bfloat16) and x.is_contiguous(),
        f"{name}: x must be contiguous float32/bfloat16, got {x.dtype}")
    req(weight.device == x.device and weight.dim() == 4
        and tuple(weight.shape[1:]) == (cin, 3, 3)
        and weight.dtype in (torch.float32, torch.bfloat16),
        f"{name}: weight {weight.dtype} {tuple(weight.shape)}")
    cout = weight.shape[0]
    if bias is None:
        bias = torch.zeros(cout, dtype=torch.float32, device=x.device)
    req(bias.dtype in (torch.float32, torch.bfloat16)
        and bias.device == x.device and tuple(bias.shape) == (cout,),
        f"{name}: bias {bias.dtype} {tuple(bias.shape)}")
    return bias.float().contiguous()


def _launch(x, weight, bias, out_dtype, stats: bool, name: str):
    """One wrap-mode conv launch (and, with stats, the fold of its
    partials) -> (y, stats [B, 2] float64 or None)."""
    bias = _check(x, weight, bias, name)
    b, cin, h, w = x.shape
    cout = weight.shape[0]
    out = torch.empty((b, cout, h, w), dtype=out_dtype, device=x.device)
    partial = sums = None
    nblk = 0
    if stats:
        nblk = conv_ops.stats_blocks(x.shape, cout, 3, 3, pad=1,
                                     dtype=x.dtype)
        partial = torch.empty((b, nblk, 2), dtype=torch.float32,
                              device=x.device)
        sums = torch.empty((b, 2), dtype=torch.float64, device=x.device)
    wk = pack_conv(weight, x.dtype)
    _build.launch(
        "matry_conv", x.data_ptr(), wk.data_ptr(), bias.data_ptr(), None,
        out.data_ptr(), b, cin, h, w, cout, h, w, 3, 3, 1, 1, 1, 1, 1, h, w,
        0, int(x.dtype == torch.float32), int(out_dtype == torch.float32),
        0, None if partial is None else partial.data_ptr(),
        None if sums is None else sums.data_ptr(), nblk,
        *conv_ops.NO_NORM, 0, 0, _build.stream_ptr(x.device))
    conv_ops.wgmma_launches += x.dtype == torch.bfloat16
    return out, sums


def conv3x3_wrap(x, weight, bias=None):
    """K7a: x [B, Cin, H, W] -> [B, Cout, H, W] float32 (bias added in
    float32). The kernel for CUDA tensors, the plain version for CPU
    tensors."""
    if x.device.type == "cpu":
        return conv3x3_wrap_plain(x, weight, bias)
    global k7a_launches
    out, _ = _launch(x, weight, bias, torch.float32, False, "conv3x3_wrap")
    k7a_launches += 1
    return out


def conv3x3_wrap_dma(x, weight, bias=None):
    """K7b: x [B, Cin, H, W] -> [B, Cout, H, W] in x's dtype."""
    if x.device.type == "cpu":
        return conv3x3_wrap_dma_plain(x, weight, bias)
    global k7b_launches
    out, _ = _launch(x, weight, bias, x.dtype, False, "conv3x3_wrap_dma")
    k7b_launches += 1
    return out


def conv3x3_ln_stats(x, weight, bias):
    """K7c: (y [B, Cout, H, W] in x's dtype, s1 [B], s2 [B] float64), the
    sums over the rounded y."""
    if x.device.type == "cpu":
        return conv3x3_ln_stats_plain(x, weight, bias)
    global k7c_launches
    y, sums = _launch(x, weight, bias, x.dtype, True, "conv3x3_ln_stats")
    k7c_launches += 1
    return y, sums[:, 0], sums[:, 1]


def wgrad_splits(k: int, cout: int, cin: int):
    """(splits, chunk) of the float32 weight-gradient kernel's pixel sum
    over k = B*H*W: enough splits for about _WGRAD_BLOCKS blocks, chunks of
    at least _WGRAD_MIN_CHUNK pixels (a multiple of 16). Fixed by the
    shape, so the summation order is too."""
    tiles = -(-(9 * cin + 1) // 128) * -(-cout // 64)
    splits = max(1, min(-(-_WGRAD_BLOCKS // tiles), k // _WGRAD_MIN_CHUNK))
    chunk = -(-k // splits)
    chunk = -(-chunk // 16) * 16
    return -(-k // chunk), chunk


class WgradPlan(NamedTuple):
    """The bfloat16 weight-gradient kernel's launch (csrc/conv_wgrad.cu
    make_wplan): k-steps of `kp` pixels of one image row, `kpr` a row and
    `kblocks` in all (k-step k: image row k // kpr of the batch's B*H,
    columns from kp * (k % kpr)); stages by TMA or gathered; Cin and Cout
    tiles of 64; `splits` blocks per tile, each summing `chunk` consecutive
    k-steps."""
    kp: int
    tma: bool
    kpr: int
    kblocks: int
    ctiles: int
    mtiles: int
    splits: int
    chunk: int

    @property
    def tiles(self) -> int:
        return self.ctiles * self.mtiles

    @property
    def code(self) -> int:
        """matry_wgrad_plan's packing: log2(kp) - 4, tma << 2, splits <<
        3."""
        return (self.kp.bit_length() - 5) | int(self.tma) << 2 \
            | self.splits << 3


def wgrad_plan(b: int, h: int, w: int, cout: int, cin: int,
               sms: int = H100_SMS) -> WgradPlan:
    """The bfloat16 weight-gradient kernel's plan (matry_wgrad_plan's
    mirror): k-steps of the widest of 64, 32, 16 pixels dividing W (16
    otherwise, the last of a row ragged); stages by TMA where W % 16 == 0
    (the kernel gathers them instead where an operand is not 16-byte
    aligned); as many splits of each tile's pixel sum as keep tiles x
    splits within one block per SM (every block resident for the in-launch
    fold; one split when the tiles alone fill the card), the k-steps shared
    out evenly. Fixed by the shape, so the summation order is too."""
    kp = 64 if w % 64 == 0 else 32 if w % 32 == 0 else 16
    kpr = -(-w // kp)
    kblocks = b * h * kpr
    bc, bn = WGRAD_TILE
    ctiles, mtiles = -(-cin // bc), -(-cout // bn)
    splits = max(1, min(sms // (ctiles * mtiles), kblocks))
    chunk = -(-kblocks // splits)
    return WgradPlan(kp, w % 16 == 0, kpr, kblocks, ctiles, mtiles,
                     -(-kblocks // chunk), chunk)


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def conv3x3_wrap_wgrad(g, x):
    """(dW [Cout, Cin, 3, 3], db [Cout]) float32 of y = K7(x, W) + b, given
    g = dL/dy [B, Cout, H, W] in x's dtype. The kernel for CUDA tensors,
    the plain version for CPU tensors."""
    if x.device.type == "cpu":
        return conv3x3_wrap_wgrad_plain(g, x)
    global wgrad_launches
    req = _build.require
    b, cin, h, w = x.shape
    req(x.is_cuda, f"conv3x3_wrap_wgrad: unsupported device {x.device}")
    req(x.dtype in (torch.float32, torch.bfloat16) and x.is_contiguous(),
        f"conv3x3_wrap_wgrad: x must be contiguous float32/bfloat16, got "
        f"{x.dtype}")
    req(g.dtype == x.dtype and g.is_contiguous() and g.device == x.device
        and g.dim() == 4 and g.shape[0] == b and tuple(g.shape[2:]) == (h, w),
        f"conv3x3_wrap_wgrad: g {g.dtype} {tuple(g.shape)}")
    cout = g.shape[1]
    sms = _sm_count(x.device.index)
    if x.dtype == torch.float32:
        splits, chunk = wgrad_splits(b * h * w, cout, cin)
        shape = (splits, cout, 9 * cin + 1)
    else:
        plan = wgrad_plan(b, h, w, cout, cin, sms)
        splits, chunk = plan.splits, plan.chunk
        shape = (splits, plan.tiles, WGRAD_TILE_ENTRIES)
    partial = torch.empty(shape, dtype=torch.float32, device=x.device)
    dw = torch.empty((cout, cin, 3, 3), dtype=torch.float32, device=x.device)
    db = torch.empty(cout, dtype=torch.float32, device=x.device)
    _build.launch(
        "matry_conv_wgrad", g.data_ptr(), x.data_ptr(), partial.data_ptr(),
        dw.data_ptr(), db.data_ptr(), b, cin, cout, h, w, splits, chunk,
        int(x.dtype == torch.float32), sms, _build.stream_ptr(x.device))
    wgrad_launches += 1
    return dw, db


# ---------------------------------------------------------------------------
# The autograd Function.
# ---------------------------------------------------------------------------

class WrapConv3x3Fn(torch.autograd.Function):
    """y = K7b(x, W, b), or (y, s1, s2) = K7c(x, W, b) with stats=True; the
    backward runs dgrad (K7a on the adjoint weights) and the weight-
    gradient kernel."""

    @staticmethod
    def forward(ctx, x, weight, bias, stats: bool):
        ctx.stats = stats
        if stats:
            y, s1, s2 = conv3x3_ln_stats(x, weight, bias)
            ctx.save_for_backward(x, weight, y)
            return y, s1, s2
        ctx.save_for_backward(x, weight)
        return conv3x3_wrap_dma(x, weight, bias)

    @staticmethod
    def backward(ctx, gy, gs1=None, gs2=None):
        # saved_tensors once: under torch.utils.checkpoint each read
        # unpacks (recomputes) the saved tensors
        saved = ctx.saved_tensors
        x, weight = saved[:2]
        if ctx.stats:
            y = saved[2]
            acc = _acc(x)
            g = (gy.to(acc) + gs1.to(acc)[:, None, None, None]
                 + 2.0 * y.to(acc) * gs2.to(acc)[:, None, None, None])
        else:
            g = gy
        g = g.to(x.dtype).contiguous()
        dx = dw = db = None
        if ctx.needs_input_grad[0]:
            dx = conv3x3_wrap(g, adjoint(weight)).to(x.dtype)
        if ctx.needs_input_grad[1] or ctx.needs_input_grad[2]:
            dw, db = conv3x3_wrap_wgrad(g, x)
            dw, db = dw.to(weight.dtype), db.to(weight.dtype)
        return dx, dw, db, None


def wrap_conv3x3(x, weight, bias, stats: bool = False):
    """Differentiable K7: y (K7b), or (y, s1, s2) (K7c) with stats=True.
    The parameters may be float32 or bfloat16 (param_dtype); their
    gradients come back in their dtypes."""
    return WrapConv3x3Fn.apply(x, weight, bias, stats)
