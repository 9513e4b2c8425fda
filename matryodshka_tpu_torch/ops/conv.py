"""Convolution for the U-Net: weight packing, kernel wrapper and its plain
version.

The kernel is `csrc/conv.cu` (the conv block of
`matryodshka_tpu/ops/pallas_net.py:_build_kernel`, both variants); its
source note gives the bound and the design, and `conv_plan` mirrors its
choice of tile and producer for bfloat16 operands. One call is one layer,
in one of two forms:

* npar=1: a KHxKW conv with stride and dilation, `pad` = (lo, hi) rows and
  columns before and after (an int means the same on both sides); input
  rows outside [0, H) read zero;
* npar=4: the 4x4 stride-2 transposed conv as four 2x2 parity convs
  (`FusedDeconvCrop`; the coord net's SAME `ConvTranspose` has the same
  index map): parity (da, db) pads (1 - da, 1 - db) before and (da, db)
  after, and writes output pixels (2i + da, 2j + db);
* npar=4 with kh = kw = 3: the smoothed net's upsampling conv (nearest 2x,
  then a 4x4 conv padded (1, 2)) folded onto the un-upsampled input:
  parity (da, db) is a (3 - da) x (3 - db) conv padded (1 - da, 1 - db)
  before and 1 after, whose taps are sums of the 4x4 taps
  (`pack_smoothed`), with the same output map.

and in one of two horizontal paddings: hpad="wrap" wraps input columns mod
W (`wrap_pad` of `models/unet.py`, the wrap net), hpad="zero" reads zero
outside [0, W) (SAME padding, the coord net). The coord net also appends
an |sin(lat)| channel to the input of every 3x3 conv and stride-2 down:
`coord` is that channel's value per input row, [H] float32, and the kernel
reads it as input channel Cin without a Cin+1-channel copy of x.

Weights are packed [npar, KH*KW*Cin', Cout], k = (kh*KW + kw)*Cin' + c,
Cin' = Cin + 1 with a coord channel (its weights last), else Cin; a
smoothed parity's (3 - da) x (3 - db) taps fill the first rows of its
9-tap block.

The net's layer norm + ReLU (`SpatialLayerNorm` then ReLU, between every
two stages) has no launch of its own: a producer asks for its output's
statistics (`stats=True`: one (sum y, sum y^2) partial per tile and sample,
`stats_blocks`), and its consumer takes each source's `Norm` (those
partials, gamma, beta), folds them into per-channel vectors and applies
relu(a * y + b) to its input as it stages it. For CPU tensors the same call
is `conv_plain` after `ops/layernorm.layer_norm_relu_plain` of each source.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from matryodshka_tpu_torch import trace
from matryodshka_tpu_torch.ops import _build
from matryodshka_tpu_torch.ops.layernorm import layer_norm_relu_plain

#: Launches of the conv kernel in this process (both paddings).
launches = 0
#: Of those, the launches in the coord net's mode (hpad="zero": its convs
#: and downs, which read the coord channel, its deconvs and its head).
coord_launches = 0
#: Launches of the bf16 kernel (csrc/conv.cu:conv_wgmma_kernel) in this
#: process: conv's bf16 launches and the K7 wrappers' (ops/wrap_conv.py).
wgmma_launches = 0
#: Of conv's launches, those that applied the layer norm + ReLU to their
#: input (the K2 stage's LN+ReLU, fused), and those whose epilogue wrote
#: their output's statistics.
norm_launches = 0
stats_launches = 0

HPADS = ("wrap", "zero")


def pack_conv(weight, dtype):
    """[Cout, Cin, KH, KW] -> [1, KH*KW*Cin, Cout]."""
    cout = weight.shape[0]
    return weight.permute(2, 3, 1, 0).reshape(1, -1, cout).to(
        dtype).contiguous()


def pack_deconv(weight, dtype, *, smoothed: bool, name: str = "deconv"):
    """Transposed-conv kernel [Cout, Cin, 4, 4] -> the four 2x2 parity
    kernels [4, 4*Cin, Cout]; parity da*2 + db takes taps
    weight[..., da + 2*ka, db + 2*kb]. smoothed says whether the weights
    are a smoothed net's: its 4x4 upsampling conv has the same shape, but
    read as a transposed conv it would compute something else, so the
    packer refuses it (pack_smoothed packs it)."""
    if smoothed:
        raise ValueError(f"pack_deconv: {name} belongs to a smoothed net, "
                         f"whose 4x4 weights are an upsampling conv's, not "
                         f"a transposed conv's; pack it with pack_smoothed")
    return torch.cat([pack_conv(weight[:, :, da::2, db::2], dtype)
                      for da in (0, 1) for db in (0, 1)]).contiguous()


#: The 4x4 taps each of a folded parity's taps sums, per axis: parity 0
#: reads input offsets -1, 0, 1, parity 1 offsets 0, 1.
FOLD_TAPS = (((0,), (1, 2), (3,)), ((0, 1), (2, 3)))


def fold_smoothed(weight, da: int, db: int):
    """Parity (da, db) of the smoothed upsampling conv [Cout, Cin, 4, 4]
    as a conv on the un-upsampled input: [Cout, Cin, 3 - da, 3 - db],
    summed in float32."""
    w = weight.float()
    rows = torch.stack([w[:, :, list(t)].sum(2) for t in FOLD_TAPS[da]], 2)
    return torch.stack([rows[..., list(t)].sum(-1) for t in FOLD_TAPS[db]],
                       -1)


def pack_smoothed(weight, dtype):
    """The smoothed net's upsampling conv [Cout, Cin, 4, 4] -> the four
    folded parity kernels [4, 9*Cin, Cout]: parity da*2 + db packs
    fold_smoothed(weight, da, db) in its first (3 - da)(3 - db)*Cin rows
    and zeros after."""
    cin, cout = weight.shape[1], weight.shape[0]
    out = torch.zeros((4, 9 * cin, cout), dtype=dtype, device=weight.device)
    for da in (0, 1):
        for db in (0, 1):
            wk = pack_conv(fold_smoothed(weight, da, db), dtype)[0]
            out[da * 2 + db, :wk.shape[0]] = wk
    return out


def _unpack(wk, par: int, kh: int, kw: int, cin: int):
    cout = wk.shape[2]
    return wk[par, :kh * kw * cin].reshape(kh, kw, cin, cout).permute(
        3, 2, 0, 1)


def par_taps(k: int, npar: int, d: int) -> int:
    """Taps along an axis of parity d's conv (csrc/conv.cu:par_taps): the
    smoothed form's 3 - d where npar == 4 and k == 3, else k."""
    return k - d if npar == 4 and k == 3 else k


def coord_column(h: int, device=None) -> torch.Tensor:
    """The coord channel's value per row, |sin(lat)| with lat =
    linspace(-pi/2, pi/2, h) (`sph_coord_channel` of `models/unet.py`),
    computed in float64 and stored as float32 [h]."""
    lat = np.linspace(-np.pi / 2, np.pi / 2, h)
    return torch.from_numpy(np.abs(np.sin(lat)).astype(np.float32)).to(
        device)


def with_coord(x, coord):
    """x [B, C, H, W] with the coord channel (coord [H]) appended last, in
    x's dtype."""
    b, _, h, w = x.shape
    col = coord.to(x.dtype)[None, None, :, None].expand(b, 1, h, w)
    return torch.cat([x, col], dim=1)


def wrap_pad(x, top: int, bottom: int, left: int, right: int):
    """Horizontal wrap padding by (left, right) columns and vertical zero
    padding by (top, bottom) rows of [..., H, W]."""
    w = x.shape[-1]
    x = torch.cat([x[..., w - left:], x, x[..., :right]], dim=-1)
    return F.pad(x, (0, 0, top, bottom))


def pad2d(x, top: int, bottom: int, left: int, right: int,
          hpad: str = "wrap"):
    """wrap_pad, or zero padding on all four sides for hpad="zero"."""
    if hpad == "wrap":
        return wrap_pad(x, top, bottom, left, right)
    return F.pad(x, (left, right, top, bottom))


def pad_pair(pad):
    """(lo, hi) of a pad argument: an int for both sides, or a pair."""
    return (pad, pad) if isinstance(pad, int) else tuple(pad)


def out_size(h: int, w: int, kh: int, kw: int, stride: int, dil: int,
             pad, npar: int):
    """(Ho, Wo) of the GEMM grid; the written tensor is (2Ho, 2Wo) for
    npar=4. pad: (lo, hi), or an int for both."""
    if npar == 4:
        return h, w
    lo, hi = pad_pair(pad)
    return ((h + lo + hi - dil * (kh - 1) - 1) // stride + 1,
            (w + lo + hi - dil * (kw - 1) - 1) // stride + 1)


def conv_plain(x, wk, bias, kh: int, kw: int, stride: int = 1, dil: int = 1,
               pad=0, npar: int = 1, tanh: bool = False, out_dtype=None,
               hpad: str = "wrap", coord=None):
    """Plain version of the kernel: f32 math on the given operands (f64
    for f64 x), one rounding to out_dtype (default x.dtype)."""
    out_dtype = x.dtype if out_dtype is None else out_dtype
    acc = torch.float64 if x.dtype == torch.float64 else torch.float32
    x32 = x.to(acc)
    if coord is not None:
        x32 = with_coord(x32, coord.to(acc))
    cin = wk.shape[1] // (kh * kw)
    if npar == 1:
        lo, hi = pad_pair(pad)
        y = F.conv2d(pad2d(x32, lo, hi, lo, hi, hpad),
                     _unpack(wk, 0, kh, kw, cin).to(acc), stride=stride,
                     dilation=dil)
    else:
        b, _, h, w = x.shape
        y = x32.new_empty((b, wk.shape[2], 2 * h, 2 * w))
        for par in range(4):
            da, db = par >> 1, par & 1
            ph, pw = par_taps(kh, npar, da), par_taps(kw, npar, db)
            y[:, :, da::2, db::2] = F.conv2d(
                pad2d(x32, 1 - da, ph - 2 + da, 1 - db, pw - 2 + db, hpad),
                _unpack(wk, par, ph, pw, cin).to(acc))
    y = y + bias.to(acc)[None, :, None, None]
    if tanh:
        y = torch.tanh(y)
    return y.to(out_dtype)


#: The bf16 kernel's tiles (Cout x pixels) in csrc/conv.cu's order
#: (kTileBM, wg::kTilePx).
WGMMA_TILES = ((128, 128), (64, 128))


class ConvPlan(NamedTuple):
    """A bf16 launch's plan (csrc/conv.cu:make_plan): the tile (index into
    WGMMA_TILES, its Cout x pixel size), the tile's pixels as rows x cols
    of output pixels, and the producers: tma_x, the patch windows by TMA
    (else gathered); tma_w, the weights by TMA (else gathered)."""
    tile: int
    bm: int
    bn: int
    cols: int
    rows: int
    tma_x: bool
    tma_w: bool

    def code(self) -> int:
        """The plan as matry_conv_plan packs it."""
        return (self.tile | (self.cols.bit_length() - 5) << 2
                | int(self.tma_x) << 4 | int(self.tma_w) << 5)

    def __str__(self) -> str:
        xs = "patch TMA" if self.tma_x else "patch gathered"
        ws = "weights TMA" if self.tma_w else "weights gathered"
        return (f"wgmma {self.bm}x{self.bn} ({self.rows}x{self.cols} px, "
                f"{xs}, {ws})")


def conv_plan(wi: int, cout: int, wo: int, stride: int,
              hpad: str) -> ConvPlan:
    """Plain-Python mirror of csrc/conv.cu:make_plan for a bf16 launch
    (wo: the GEMM grid's width, per parity for npar=4): columns the widest
    of 64, 32, 16 dividing wo (16 otherwise), at most 32 at stride 2;
    128-Cout tiles where cout > 64, else 64; the patch windows by TMA at
    stride 1 or 2 for wi % 8 == 0 and, wrapping, columns dividing wo (else
    gathered); the weights by TMA for cout % 8 == 0."""
    cols = 64 if wo % 64 == 0 else 32 if wo % 32 == 0 else 16
    if stride == 2:
        cols = min(cols, 32)
    tile = 0 if cout > 64 else 1
    bm, bn = WGMMA_TILES[tile]
    return ConvPlan(tile, bm, bn, cols, bn // cols,
                    stride in (1, 2) and wi % 8 == 0
                    and (hpad == "zero" or wo % cols == 0), cout % 8 == 0)


#: csrc/conv.cu's shared-memory plan (wg::kSmemBudget, wg::kStages,
#: wg::kBoxW, wg::kTilePx, wg::kHalo, wg::BK): the ring's budget, its
#: depth, a [64 k][64 Cout] weight box's bytes, a tile's pixels, a halo's
#: columns, the channels of a k-step.
SMEM_BUDGET = 220 * 1024
RING_STAGES = 2
BOX_BYTES = 64 * 64 * 2
TILE_PX = 128
HALO = 8
BK = 64


def conv_smem(cin: int, wi: int, cout: int, wo: int, kw: int, stride: int,
              hpad: str, norm: bool):
    """Plain-Python mirror of csrc/conv.cu:smem_of for a bf16 launch, to
    check a shape's fit without a card (a launch that does not fit refuses
    itself, with cudaErrorInvalidValue): (stage bytes, ring stages,
    dynamic bytes the launch asks for). A stage holds the kw taps'
    weights, the main window and two halos; the layer norm's vectors (a
    and b in f32 for cin rounded up to 64 channels) follow the ring; the
    ring takes at most RING_STAGES stages, as many as SMEM_BUDGET holds
    beside the vectors, and the launch refuses fewer than 2 (stages 0)."""
    plan = conv_plan(wi, cout, wo, stride, hpad)
    stage = (kw * (plan.bm // 64) * BOX_BYTES
             + plan.rows * BK * plan.cols * stride * 2
             + 2 * plan.rows * BK * HALO * 2)
    vec = -(-cin // BK) * BK * 8 if norm else 0
    stages = min(RING_STAGES, (SMEM_BUDGET - vec) // stage)
    if stages < 2:
        return stage, 0, 0
    return stage, stages, stages * stage + vec + 1024


@functools.lru_cache(maxsize=None)
def stats_blocks(x_shape, cout: int, kh: int, kw: int, stride: int = 1,
                 dil: int = 1, pad=0, npar: int = 1, hpad: str = "wrap",
                 dtype=torch.bfloat16) -> int:
    """Partials a sample that a launch of conv(x, ..., stats=True) writes
    (csrc/conv.cu:stat_blocks): one per (parity, pixel tile, Cout tile) of
    the bf16 kernel's plan, one per 128-pixel x 64-Cout block of the f32
    kernel. Memoized: conv sizes each launch's partials with it, and a
    stage's shape stays the same from frame to frame."""
    ho, wo = grid_of(x_shape, kh, kw, stride, dil, pad, npar)
    if dtype == torch.float32:
        return -(-ho * wo // 128) * -(-cout // 64) * npar
    plan = conv_plan(x_shape[3], cout, wo, stride, hpad)
    return (-(-wo // plan.cols) * -(-ho // plan.rows) * -(-cout // plan.bm)
            * npar)


class Norm(NamedTuple):
    """The layer norm + ReLU a consumer applies to one source of its input
    (`models/unet.py:SpatialLayerNorm` then ReLU): partial, the source's
    producer's partial sums [B, nblk, 2] float32 (conv(..., stats=True);
    None on the CPU, whose plain route takes the statistics from the
    source itself); gamma, beta [C] float32."""
    partial: Optional[torch.Tensor]
    gamma: torch.Tensor
    beta: torch.Tensor


def normalize_plain(x, norm: Sequence[Norm]):
    """x [B, sum C, H, W], the channel concat of the norm's sources, with
    each source's layer_norm_relu_plain: what a conv with `norm` reads."""
    parts = torch.split(x, [n.gamma.shape[0] for n in norm], dim=1)
    return torch.cat([layer_norm_relu_plain(p, n.gamma, n.beta)
                      for p, n in zip(parts, norm)], dim=1)


def grid_of(x_shape, kh: int, kw: int, stride: int = 1, dil: int = 1,
            pad=0, npar: int = 1):
    """(Ho, Wo) of a launch's GEMM grid for input shape [B, C, H, W]."""
    return out_size(x_shape[2], x_shape[3], kh, kw, stride, dil, pad, npar)


def tile_config(x, cout: int, kh: int, kw: int, stride: int = 1,
                dil: int = 1, pad=0, npar: int = 1, hpad: str = "wrap",
                **_) -> str:
    """The tile a CUDA launch of conv(x, ...) with `cout` outputs takes:
    for bfloat16 operands the wgmma kernel's plan (conv_plan), for float32
    the f32 kernel's one tile. Takes conv's keyword arguments."""
    if x.dtype == torch.float32:
        return "f32 FMA 64x128"
    _, wo = grid_of(x.shape, kh, kw, stride, dil, pad, npar)
    return str(conv_plan(x.shape[3], cout, wo, stride, hpad))


#: matry_conv's layer-norm arguments for an input taken as it is.
NO_NORM = (0, 0, None, None, None, 0, None, None, None, 0)
#: matry_conv's arguments for an absent second source.
NO_SOURCE = [None, None, None, 0]


def _norm_args(norm, x):
    """matry_conv's layer-norm arguments (nsrc, c0, then per source its
    partials, gamma, beta and partials a sample) after checking them."""
    if norm is None:
        return NO_NORM
    req = _build.require
    b, cin = x.shape[:2]
    dev = x.device
    req(len(norm) in (1, 2), lambda: f"conv: norm has {len(norm)} sources; "
                                     f"the kernel takes one or two")
    out = [len(norm), norm[0].gamma.shape[0]]
    total = 0
    for i, (p, g, bt) in enumerate(norm):
        ps = None if p is None else p.shape
        req(ps is not None and p.dtype == torch.float32 and p.is_contiguous()
            and p.device == dev and len(ps) == 3 and ps[0] == b
            and ps[1] >= 1 and ps[2] == 2,
            lambda: f"conv: norm source {i} partials must be float32 "
                    f"[B, nblk, 2] on x's device (conv(..., stats=True) of "
                    f"its producer)")
        c = g.shape[0]
        total += c
        for name, t in (("gamma", g), ("beta", bt)):
            req(t.dtype == torch.float32 and t.is_contiguous()
                and t.device == dev and t.shape == (c,),
                lambda: f"conv: norm source {i} {name} {t.dtype} "
                        f"{tuple(t.shape)}")
        out += [p.data_ptr(), g.data_ptr(), bt.data_ptr(), ps[1]]
    req(total == cin, lambda: f"conv: norm covers "
                              f"{[n.gamma.shape[0] for n in norm]} "
                              f"channels of {cin}")
    return out if len(norm) == 2 else out + NO_SOURCE


def conv(x, wk, bias, kh: int, kw: int, stride: int = 1, dil: int = 1,
         pad=0, npar: int = 1, tanh: bool = False, out_dtype=None,
         hpad: str = "wrap", coord=None, norm: Sequence[Norm] = None,
         stats: bool = False):
    """One conv layer: the CUDA kernel for CUDA tensors, the plain version
    for CPU tensors. x [B, Cin, H, W]; wk from pack_conv / pack_deconv /
    pack_smoothed; bias [Cout] float32; coord None or [H] float32
    (hpad="zero" only). norm: None (x as it is), or one Norm per source of
    x in channel order (x the torch.cat of one or two raw sources): the
    conv reads relu(a * x + b) of each source's layer norm. stats: also
    return the output's partial sums, [B, stats_blocks, 2] float32 (None
    for CPU tensors), which a consumer's Norm takes. -> out, or (out,
    partials) with stats."""
    global launches, coord_launches, wgmma_launches
    global norm_launches, stats_launches
    with trace.span("conv.conv"):
        if x.device.type == "cpu":
            if norm is not None:
                x = normalize_plain(x, norm)
            y = conv_plain(x, wk, bias, kh, kw, stride, dil, pad, npar, tanh,
                           out_dtype, hpad, coord)
            return (y, None) if stats else y
        out_dtype = x.dtype if out_dtype is None else out_dtype
        b, cin, h, w = x.shape
        cout = wk.shape[2]
        lo, hi = pad_pair(pad)
        kcin = cin + (coord is not None)
        dev = x.device
        req = _build.require
        req(x.is_cuda, lambda: f"conv: unsupported device {dev}")
        req(x.dtype in (torch.float32, torch.bfloat16) and x.is_contiguous(),
            lambda: f"conv: x must be contiguous float32/bfloat16, got "
                    f"{x.dtype}")
        req(wk.dtype == x.dtype and wk.is_contiguous() and wk.device == dev
            and wk.shape == (npar, kh * kw * kcin, cout),
            lambda: f"conv: packed weight {wk.dtype} {tuple(wk.shape)}")
        req(bias.dtype == torch.float32 and bias.is_contiguous()
            and bias.device == dev and bias.shape == (cout,),
            lambda: f"conv: bias {bias.dtype} {tuple(bias.shape)}")
        req(out_dtype in (torch.float32, torch.bfloat16),
            lambda: f"conv: out_dtype {out_dtype}")
        req(hpad in HPADS, lambda: f"conv: hpad {hpad!r}; known: {HPADS}")
        req(coord is None or (
            hpad == "zero" and npar == 1 and coord.dtype == torch.float32
            and coord.is_contiguous() and coord.device == dev
            and coord.shape == (h,)),
            "conv: coord must be float32 [H] on x's device, with hpad='zero' "
            "and npar=1")
        req(npar == 1 or (npar == 4 and kh == kw and kh in (2, 3)
                          and stride == 1 and dil == 1),
            "conv: npar=4 is the 2x2 parity form of the transposed conv or "
            "the 3x3 folded form of the smoothed one")
        req(npar == 4 or hpad == "zero" or lo == hi,
            "conv: wrap padding is symmetric")
        nargs = _norm_args(norm, x)
        ho, wo = out_size(h, w, kh, kw, stride, dil, (lo, hi), npar)
        oh, ow = (2 * ho, 2 * wo) if npar == 4 else (ho, wo)
        out = torch.empty((b, cout, oh, ow), dtype=out_dtype, device=dev)
        partial, nblk = None, 0
        if stats:
            nblk = stats_blocks(x.shape, cout, kh, kw, stride, dil, (lo, hi),
                                npar, hpad, x.dtype)
            partial = torch.empty((b, nblk, 2), dtype=torch.float32,
                                  device=dev)
        _build.launch(
            "matry_conv", x.data_ptr(), wk.data_ptr(), bias.data_ptr(),
            None if coord is None else coord.data_ptr(), out.data_ptr(),
            b, cin, h, w, cout, ho, wo, kh, kw, stride, dil,
            1 if npar == 4 else lo, 1 if npar == 4 else lo, npar, oh, ow,
            int(tanh), int(x.dtype == torch.float32),
            int(out_dtype == torch.float32), int(hpad == "zero"),
            None if partial is None else partial.data_ptr(), None, nblk,
            *nargs, _build.stream_ptr(dev))
        launches += 1
        coord_launches += hpad == "zero"
        wgmma_launches += x.dtype == torch.bfloat16
        norm_launches += norm is not None
        stats_launches += stats
        return (out, partial) if stats else out
