"""The conv kernel's fused layer norm + ReLU (csrc/conv.cu), on the CPU.

The net's LN+ReLU between two stages has no launch of its own: the
producer's epilogue writes one (sum y, sum y^2) partial per (sample, tile),
the consumer folds its sources' partials into per-channel vectors a =
gamma * rsqrt(var + eps), b = beta - mean * a and applies relu(a * y + b)
to each A fragment its taps load; the pads (rows and, in zero mode,
columns outside the input, channels past Cin, the parity forms' padding)
must stay zero, and do because its tensor maps fill them with NaN. Here
that algorithm is emulated in float64: the partials in the kernel's tile
order (each output element in exactly one partial), the fold in its thread
order, the vectors, and what the taps read of tests/test_torch_conv_plan.py's emulated windows: every element
outside the input filled with NaN (as the kernel's tensor maps fill it)
and every element through fmax(a * y + b, 0), which takes NaN to 0; held
to `conv_plain` of the plain layer norm (beta near 5, so a pad element
that came out relu(b) would show). The vectors are also held to the JAX
package's SpatialLayerNorm fed the same sums through flax `apply`, and the
plan of every flagship consumer to the shared memory its vectors need.
The card runs the kernel itself (tests/test_torch_kernels_cuda.py).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from matryodshka_tpu.models import unet as junet
from matryodshka_tpu_torch.ops import conv as conv_ops
from matryodshka_tpu_torch.ops import layernorm as ln_ops
from matryodshka_tpu_torch.ops.net import conv_args, unet_plan
from test_torch_conv_plan import _emulated

EPS = ln_ops.EPS
#: Threads of the kernels' fold (csrc/conv.cu: fold_norm<256>, by the bf16
#: kernel's two consumer warpgroups and by the f32 kernel's block).
FOLD_THREADS = 256


def _cdiv(a, b):
    return -(-a // b)


def _partials(y, x_shape, args, dtype=torch.bfloat16):
    """The STATS epilogue's partials of a producer launch conv(x, ...,
    **args) whose output is y [B, Cout, OH, OW], float64 [B, nblk, 2] in
    the kernel's order: bf16, sample, then parity, then pixel tile (row
    tile, column tile), Cout tile fastest; f32, sample, parity, Cout block,
    pixel block. Also the number of partials each output element lies in."""
    b, cout = y.shape[:2]
    kh, kw = args["kh"], args["kw"]
    stride, dil = args.get("stride", 1), args.get("dil", 1)
    pad, npar = args.get("pad", 0), args.get("npar", 1)
    ho, wo = conv_ops.grid_of(x_shape, kh, kw, stride, dil, pad, npar)
    nblk = conv_ops.stats_blocks(x_shape, cout, kh, kw, stride, dil, pad,
                                 npar, args.get("hpad", "wrap"), dtype)
    part = np.zeros((b, nblk, 2))
    seen = np.zeros(y.shape, dtype=int)
    yn = y.numpy()
    if dtype == torch.float32:
        gy, gx = _cdiv(cout, 64), _cdiv(ho * wo, 128)
        tiles = [(by * gx + bx, np.arange(by * 64, min(by * 64 + 64, cout)),
                  np.arange(bx * 128, min(bx * 128 + 128, ho * wo)))
                 for by in range(gy) for bx in range(gx)]
        tiles = [(i, ch, pix // wo, pix % wo) for i, ch, pix in tiles]
    else:
        plan = conv_ops.conv_plan(x_shape[3], cout, wo, stride,
                                  args.get("hpad", "wrap"))
        ntx, nty = _cdiv(wo, plan.cols), _cdiv(ho, plan.rows)
        mtiles = _cdiv(cout, plan.bm)
        tiles = []
        for local in range(mtiles * ntx * nty):
            mt, pt = local % mtiles, local // mtiles
            oy0, ox0 = (pt // ntx) * plan.rows, (pt % ntx) * plan.cols
            oy = np.arange(oy0, min(oy0 + plan.rows, ho))
            ox = np.arange(ox0, min(ox0 + plan.cols, wo))
            oy, ox = [g.ravel() for g in np.meshgrid(oy, ox, indexing="ij")]
            tiles.append((local, np.arange(mt * plan.bm,
                                           min(mt * plan.bm + plan.bm,
                                               cout)), oy, ox))
    per = len(tiles)
    assert per * npar == nblk
    for bi in range(b):
        for par in range(npar):
            da, db = par >> 1, par & 1
            for i, ch, oy, ox in tiles:
                py, px = (2 * oy + da, 2 * ox + db) if npar == 4 else (oy, ox)
                v = yn[bi][ch[:, None], py[None, :], px[None, :]]
                part[bi, par * per + i] = (v.sum(), (v * v).sum())
                seen[bi][ch[:, None], py[None, :], px[None, :]] += 1
    return part, seen


def _fold(part):
    """One sample's partials [nblk, 2] summed as fold_norm sums them:
    thread t takes partials t, t + 256, ... in order, a butterfly sums
    each warp of 32, the eight warp sums are added in order."""
    t = np.zeros((FOLD_THREADS, 2))
    for i in range(part.shape[0]):
        t[i % FOLD_THREADS] += part[i]
    t = t.reshape(FOLD_THREADS // 32, 32, 2)
    for off in (16, 8, 4, 2, 1):
        t = t + t[:, np.arange(32) ^ off]
    s = np.zeros(2)
    for wi in range(FOLD_THREADS // 32):
        s += t[wi, 0]
    return s


def _vectors(part, gamma, beta, n):
    """(a, b) [B, C] float64 from a source's partials: mean = s1 / n, var
    = max(s2 / n - mean^2, 0), a = gamma * rsqrt(var + eps), b = beta -
    mean * a."""
    a, b = [], []
    for pb in part:
        s1, s2 = _fold(pb)
        mean = s1 / n
        var = max(s2 / n - mean * mean, 0.0)
        ai = gamma.double().numpy() / np.sqrt(var + EPS)
        a.append(ai)
        b.append(beta.double().numpy() - mean * ai)
    return torch.from_numpy(np.stack(a)), torch.from_numpy(np.stack(b))


def _ln_relu64(y, gamma, beta):
    """The plain layer norm + ReLU in float64 (two-pass mean and
    variance)."""
    mean = y.mean(dim=(1, 2, 3), keepdim=True)
    var = (y - mean).square().mean(dim=(1, 2, 3), keepdim=True)
    return torch.relu((y - mean) / torch.sqrt(var + EPS)
                      * gamma.double()[:, None, None]
                      + beta.double()[:, None, None])


def _norm_window(va, vb, cin, h, w, stride, cols, hpad, fill=math.nan):
    """What the kernel's taps read of one stage's window [64, rows, cols *
    stride + 2 halo] (input rows iy0 + r * stride, columns ox0 * stride -
    halo ..; halo 8 for NCHW x, 2 for channels-last x, the window's width
    says which): its tensor maps fill every element outside the input (a
    channel
    at or past cin, a row outside [0, h), in zero mode a column outside [0,
    w)) with NaN, where the emulation's window holds zeros, and every
    element goes through fmax(a[c] * y + b[c], 0) with a = b = 0 past cin,
    so NaN comes out 0 (fill=0: the zero-filled window, whose pads would
    come out relu(b))."""
    ctw = cols * stride

    def f(win, bi, c0, iy0, ox0):
        c = c0 + torch.arange(win.shape[0])
        iy = iy0 + torch.arange(win.shape[1]) * stride
        ix = ox0 * stride - (win.shape[2] - ctw) // 2 + torch.arange(
            win.shape[2])
        m = (c < cin)[:, None, None] & ((iy >= 0) & (iy < h))[None, :, None]
        if hpad == "zero":
            m = m & ((ix >= 0) & (ix < w))[None, None, :]
        else:
            m = m.expand(-1, -1, win.shape[2])
        assert bool((win[~m] == 0).all()), "a pad element is not zero"
        inside = c < cin
        cc = c.clamp(max=cin - 1)
        ka = torch.where(inside, va[bi, cc], 0.0)[:, None, None]
        kb = torch.where(inside, vb[bi, cc], 0.0)[:, None, None]
        filled = torch.where(m, win, torch.full_like(win, fill))
        return torch.fmax(ka * filled + kb, torch.zeros_like(win))
    return f


#: (name, batch, source channels, H, W, Cout, conv args): every mode and
#: form a consumer takes, small; the ragged widths (W 20, 40) take a
#: gathered window (wrap) or a main box past W (zero), 72 and 40 channels
#: a ragged chunk.
_ZP = dict(hpad="zero")
CASES = [
    ("wrap_conv", 1, [72], 10, 32, 16, dict(kh=3, kw=3, pad=1)),
    ("wrap_down", 1, [72], 12, 64, 24, dict(kh=3, kw=3, stride=2, pad=1)),
    ("wrap_dil2", 1, [40], 10, 32, 16, dict(kh=3, kw=3, dil=2, pad=2)),
    ("wrap_deconv", 1, [40], 8, 32, 16, dict(kh=2, kw=2, npar=4)),
    ("wrap_smoothed", 1, [40], 8, 32, 16, dict(kh=3, kw=3, npar=4)),
    ("wrap_batch2", 2, [40], 8, 32, 16, dict(kh=3, kw=3, pad=1)),
    ("wrap_concat", 2, [24, 40], 8, 32, 16, dict(kh=2, kw=2, npar=4)),
    ("wrap_head", 1, [16], 8, 32, 5, dict(kh=1, kw=1, tanh=True)),
    ("wrap_gathered", 1, [24], 6, 20, 16, dict(kh=3, kw=3, pad=1)),
    ("zero_conv", 1, [72], 10, 32, 16, dict(kh=3, kw=3, pad=(1, 1), **_ZP)),
    ("zero_down", 1, [72], 12, 64, 24,
     dict(kh=3, kw=3, stride=2, pad=(0, 1), **_ZP)),
    ("zero_dil2", 1, [40], 10, 32, 16,
     dict(kh=3, kw=3, dil=2, pad=(2, 2), **_ZP)),
    ("zero_deconv", 1, [40], 8, 32, 16, dict(kh=2, kw=2, npar=4, **_ZP)),
    ("zero_smoothed", 1, [40], 8, 32, 16, dict(kh=3, kw=3, npar=4, **_ZP)),
    ("zero_batch2", 2, [40], 8, 32, 16, dict(kh=3, kw=3, pad=(1, 1), **_ZP)),
    ("zero_concat", 2, [24, 40], 8, 32, 16, dict(kh=2, kw=2, npar=4, **_ZP)),
    ("zero_head", 1, [16], 8, 32, 5, dict(kh=1, kw=1, tanh=True, **_ZP)),
    ("zero_ragged", 1, [24], 6, 40, 16, dict(kh=3, kw=3, pad=(1, 1), **_ZP)),
    ("coord_conv", 1, [72], 10, 32, 16,
     dict(kh=3, kw=3, pad=(1, 1), coord=True, **_ZP)),
    ("coord_down", 1, [72], 12, 64, 24,
     dict(kh=3, kw=3, stride=2, pad=(0, 1), coord=True, **_ZP)),
    ("coord_dil2", 1, [40], 10, 32, 16,
     dict(kh=3, kw=3, dil=2, pad=(2, 2), coord=True, **_ZP)),
    ("coord_batch2", 2, [40], 8, 32, 16,
     dict(kh=3, kw=3, pad=(1, 1), coord=True, **_ZP)),
    ("coord_concat", 1, [24, 40], 8, 32, 16,
     dict(kh=3, kw=3, pad=(1, 1), coord=True, **_ZP)),
    ("coord_ragged", 1, [24], 6, 40, 16,
     dict(kh=3, kw=3, pad=(1, 1), coord=True, **_ZP)),
]


def _weights(rng, cout, kcin, args):
    """A packed float64 weight for the case's form."""
    if args.get("npar") == 4:
        wt = torch.from_numpy(rng.randn(cout, kcin, 4, 4) * 0.1)
        if args["kh"] == 3:
            return conv_ops.pack_smoothed(wt, torch.float64)
        return conv_ops.pack_deconv(wt, torch.float64, smoothed=False)
    wt = torch.from_numpy(rng.randn(cout, kcin, args["kh"], args["kw"])
                          * 0.1)
    return conv_ops.pack_conv(wt, torch.float64)


@pytest.mark.parametrize("layout", ["nchw", "cl"])
@pytest.mark.parametrize("case", [c[0] for c in CASES])
def test_fused_layer_norm_matches_plain(case, layout):
    """The emulated fused algorithm (each source's partials from a
    producer at its shape, the fold, the vectors, the consumer's windows
    normalized in place with their masks) against conv_plain of the plain
    layer norm of each source, float64, within 1e-10, x NCHW and
    channels-last; beta near 5, so a normalized pad element shows."""
    _, b, cins, h, w, cout, args = next(c for c in CASES if c[0] == case)
    args = dict(args)
    rng = np.random.RandomState(sum(map(ord, case)))
    cin = sum(cins)
    if args.pop("coord", False):
        args["coord"] = conv_ops.coord_column(h).double()
    kcin = cin + ("coord" in args)
    wk = _weights(rng, cout, kcin, args)
    bias = torch.from_numpy(rng.randn(cout) * 0.1)
    hpad = args.get("hpad", "wrap")
    srcs, va, vb = [], [], []
    for c in cins:
        # a producer of this source: a stride-1 3x3 conv in the same mode
        y = torch.from_numpy(rng.randn(b, c, h, w) * 3 + 2)
        gamma = torch.from_numpy(1 + 0.2 * rng.randn(c)).float()
        beta = torch.from_numpy(5 + 0.5 * rng.randn(c)).float()
        prod = dict(kh=3, kw=3, pad=1 if hpad == "wrap" else (1, 1),
                    hpad=hpad)
        part, seen = _partials(y, (b, 8, h, w), prod)
        assert (seen == 1).all()
        a_s, b_s = _vectors(part, gamma, beta, c * h * w)
        srcs.append((y, gamma, beta))
        va.append(a_s)
        vb.append(b_s)
    x = torch.cat([y for y, _, _ in srcs], dim=1)
    va, vb = torch.cat(va, dim=1), torch.cat(vb, dim=1)
    ho, wo = conv_ops.grid_of(x.shape, args["kh"], args["kw"],
                              args.get("stride", 1), args.get("dil", 1),
                              args.get("pad", 0), args.get("npar", 1))
    plan = conv_ops.conv_plan(w, cout, wo, args.get("stride", 1), hpad)
    got = _emulated(x, wk, bias, **args, layout=layout,
                    transform=_norm_window(va, vb, cin, h, w,
                                           args.get("stride", 1), plan.cols,
                                           hpad))
    xn = torch.cat([_ln_relu64(y, g, bt) for y, g, bt in srcs], dim=1)
    want = conv_ops.conv_plain(xn, wk, bias, **args)
    torch.testing.assert_close(got, want, rtol=1e-10, atol=1e-10)
    # filled with zeros instead of NaN, the pads would read relu(b) ~ 5
    if "pad" in args or args.get("npar") == 4:
        leak = _emulated(x, wk, bias, **args, layout=layout,
                         transform=_norm_window(va, vb, cin, h, w,
                                                args.get("stride", 1),
                                                plan.cols, hpad, fill=0.0))
        assert (leak - want).abs().max() > 1e-2


#: Producer forms whose partials a consumer folds: (name, batch, Cin, H,
#: W, Cout, args, dtype).
PRODUCERS = [
    ("conv", 1, 8, 10, 32, 72, dict(kh=3, kw=3, pad=1), torch.bfloat16),
    ("down", 2, 8, 12, 64, 136, dict(kh=3, kw=3, stride=2, pad=1),
     torch.bfloat16),
    ("down_zero", 1, 8, 12, 64, 24,
     dict(kh=3, kw=3, stride=2, pad=(0, 1), hpad="zero"), torch.bfloat16),
    ("deconv", 2, 8, 8, 32, 40, dict(kh=2, kw=2, npar=4), torch.bfloat16),
    ("smoothed_zero", 1, 8, 8, 40, 16,
     dict(kh=3, kw=3, npar=4, hpad="zero"), torch.bfloat16),
    ("gathered", 1, 8, 6, 20, 16, dict(kh=3, kw=3, pad=1), torch.bfloat16),
    ("f32", 2, 8, 10, 40, 72, dict(kh=3, kw=3, pad=1), torch.float32),
    ("f32_deconv", 1, 8, 8, 32, 16, dict(kh=2, kw=2, npar=4),
     torch.float32),
]


@pytest.mark.parametrize("case", [c[0] for c in PRODUCERS])
def test_partials_cover_the_output_once(case):
    """A producer's partials in the kernel's order: stats_blocks of them a
    sample, every output element (each parity's pixels for npar 4) in
    exactly one, and their fold equal to the sample's sums in float64."""
    _, b, cin, h, w, cout, args, dtype = next(c for c in PRODUCERS
                                              if c[0] == case)
    ho, wo = conv_ops.grid_of((b, cin, h, w), args["kh"], args["kw"],
                              args.get("stride", 1), args.get("dil", 1),
                              args.get("pad", 0), args.get("npar", 1))
    oh, ow = (2 * ho, 2 * wo) if args.get("npar") == 4 else (ho, wo)
    rng = np.random.RandomState(3)
    y = torch.from_numpy(rng.randn(b, cout, oh, ow) + 4)
    part, seen = _partials(y, (b, cin, h, w), args, dtype)
    assert part.shape[1] == conv_ops.stats_blocks(
        (b, cin, h, w), cout, args["kh"], args["kw"], args.get("stride", 1),
        args.get("dil", 1), args.get("pad", 0), args.get("npar", 1),
        args.get("hpad", "wrap"), dtype)
    assert (seen == 1).all()
    for bi in range(b):
        s1, s2 = _fold(part[bi])
        np.testing.assert_allclose([s1, s2], [y[bi].sum().item(),
                                              (y[bi] ** 2).sum().item()],
                                   rtol=1e-12)


def test_vectors_match_flax_layer_norm():
    """The kernel's a/b form, relu(a * y + b) with a and b in float32 from
    the fold's float64 sums (a = gamma * float32(rsqrt(var + eps)), b =
    fma(-float32(mean), a, beta)), against the JAX net's SpatialLayerNorm
    fed the same sums (stats=(s1, s2, n)) through flax apply, then ReLU:
    two examples of different scale, within 2e-6 of the output's scale
    (float32 roundings in two orders; flax takes s2 / n - mean^2 in
    float32, which loses ~1e-7 x mean^2 / var of var, so the examples keep
    mean^2 / var at most 4)."""
    rng = np.random.RandomState(21)
    b, c, h, w = 2, 24, 8, 32
    y = np.concatenate([rng.randn(1, c, h, w) * 3 + 1,
                        rng.randn(1, c, h, w) * 0.5 - 1]).astype(np.float32)
    gamma = (1 + 0.2 * rng.randn(c)).astype(np.float32)
    beta = (0.5 * rng.randn(c)).astype(np.float32)
    part, _ = _partials(torch.from_numpy(y).double(), (b, 8, h, w),
                        dict(kh=3, kw=3, pad=1))
    sums = np.stack([_fold(p) for p in part])
    n = c * h * w
    mean = sums[:, 0] / n
    var = np.maximum(sums[:, 1] / n - mean * mean, 0.0)
    r = (1.0 / np.sqrt(var + EPS)).astype(np.float32)
    m = mean.astype(np.float32)
    a = (gamma[None, :] * r[:, None]).astype(np.float32)
    bv = (-m[:, None].astype(np.float64) * a + beta[None, :]).astype(
        np.float32)
    got = np.maximum(a[:, :, None, None] * y + bv[:, :, None, None],
                     np.float32(0))
    s1 = jnp.asarray(sums[:, 0], jnp.float32)[:, None, None, None]
    s2 = jnp.asarray(sums[:, 1], jnp.float32)[:, None, None, None]
    ln = junet.SpatialLayerNorm()
    want = jax.nn.relu(ln.apply(
        {"params": {"gamma": gamma, "beta": beta}},
        jnp.asarray(y.transpose(0, 2, 3, 1)), stats=(s1, s2, float(n))))
    want = np.asarray(want).transpose(0, 3, 1, 2)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=2e-6 * np.abs(want).max())


@pytest.mark.parametrize("ratio", [1e2, 1e3, 1e4])
def test_vectors_against_flax_at_high_mean_to_var(ratio):
    """Where mean^2 / var is large, var = s2 / n - mean^2 cancels: the
    kernel folds float32 partials in float64, flax takes s2 / n - mean^2
    in float32, and both lose ~6e-8 x mean^2 / var of var. Two examples at
    mean^2 / var = ratio (and ratio / 4 ... ratio x 4 by sample), the
    kernel's a/b form from its float32 partials, flax fed the same sums in
    float32, and as the witness the float64 two-pass layer norm. Measured
    (relative to the output's scale) port / flax / their gap: 1.4e-6 /
    5.9e-6 / 5.2e-6 at 1e2, 1.0e-5 / 5.6e-5 / 4.6e-5 at 1e3, 2.8e-4 /
    6.3e-4 / 4.2e-4 at 1e4. Held: the port within 6e-8 x ratio + 1e-6 of
    the witness and nearer it than flax, the gap to flax within 1.2e-7 x
    ratio + 2e-6."""
    rng = np.random.RandomState(22)
    b, c, h, w = 2, 24, 8, 32
    m0 = math.sqrt(ratio)
    y = np.concatenate([rng.randn(1, c, h, w) * 3 + 3 * m0,
                        rng.randn(1, c, h, w) * 0.5 - 0.5 * m0]).astype(
                            np.float32)
    gamma = (1 + 0.2 * rng.randn(c)).astype(np.float32)
    beta = (0.5 * rng.randn(c)).astype(np.float32)
    part, _ = _partials(torch.from_numpy(y).double(), (b, 8, h, w),
                        dict(kh=3, kw=3, pad=1))
    # the kernel stores its partials in float32
    part = part.astype(np.float32).astype(np.float64)
    sums = np.stack([_fold(p) for p in part])
    n = c * h * w
    mean = sums[:, 0] / n
    var = np.maximum(sums[:, 1] / n - mean * mean, 0.0)
    r = (1.0 / np.sqrt(var + EPS)).astype(np.float32)
    a = (gamma[None, :] * r[:, None]).astype(np.float32)
    bv = (-mean.astype(np.float32)[:, None].astype(np.float64) * a
          + beta[None, :]).astype(np.float32)
    got = np.maximum(a[:, :, None, None] * y + bv[:, :, None, None],
                     np.float32(0))
    y64 = y.astype(np.float64)
    mu = y64.mean(axis=(1, 2, 3), keepdims=True)
    va = ((y64 - mu) ** 2).mean(axis=(1, 2, 3), keepdims=True)
    ref = np.maximum((y64 - mu) / np.sqrt(va + EPS)
                     * gamma[None, :, None, None]
                     + beta[None, :, None, None], 0.0)
    s1 = jnp.asarray(sums[:, 0], jnp.float32)[:, None, None, None]
    s2 = jnp.asarray(sums[:, 1], jnp.float32)[:, None, None, None]
    want = jax.nn.relu(junet.SpatialLayerNorm().apply(
        {"params": {"gamma": gamma, "beta": beta}},
        jnp.asarray(y.transpose(0, 2, 3, 1)), stats=(s1, s2, float(n))))
    want = np.asarray(want).transpose(0, 3, 1, 2)
    scale = np.abs(ref).max()
    port_err = np.abs(got - ref).max() / scale
    flax_err = np.abs(want - ref).max() / scale
    assert port_err <= 6e-8 * ratio + 1e-6, port_err
    assert port_err < flax_err, (port_err, flax_err)
    assert np.abs(got - want).max() / scale <= 1.2e-7 * ratio + 2e-6


def test_cpu_route_composes_the_plain_versions():
    """conv(x, ..., norm=, stats=True) on CPU tensors: conv_plain after
    layer_norm_relu_plain of each source, and no partials."""
    rng = np.random.RandomState(4)
    ys = [torch.from_numpy(rng.randn(2, c, 8, 16).astype(np.float32))
          for c in (8, 16)]
    norm = [conv_ops.Norm(None, torch.from_numpy(
        (1 + 0.1 * rng.randn(c)).astype(np.float32)), torch.from_numpy(
            (5 + rng.randn(c)).astype(np.float32))) for c in (8, 16)]
    wk = conv_ops.pack_deconv(torch.from_numpy(
        rng.randn(4, 24, 4, 4).astype(np.float32) * 0.1), torch.float32,
        smoothed=False)
    bias = torch.zeros(4)
    x = torch.cat(ys, dim=1)
    got, part = conv_ops.conv(x, wk, bias, 2, 2, npar=4, norm=norm,
                              stats=True)
    xn = torch.cat([ln_ops.layer_norm_relu_plain(y, n.gamma, n.beta)
                    for y, n in zip(ys, norm)], dim=1)
    assert part is None
    assert torch.equal(got, conv_ops.conv_plain(xn, wk, bias, 2, 2,
                                                npar=4))


H, W, NGF = 320, 640, 64
#: Static shared memory of conv_wgmma_kernel (bytes): the full and empty
#: mbarriers (2 x 8 x 8), the stats' warp sums (2 x 8 x 4), the coord
#: weights (9 x 128 x 4) and the fold's warp sums (2 x 8 x 8).
STATIC_SMEM = 128 + 64 + 4608 + 128
#: An H100 block's shared memory (opt-in limit).
BLOCK_SMEM = 232_448


@pytest.mark.parametrize("net", ["wrap", "coord", "wrap_smoothed"])
@pytest.mark.parametrize("stage", [p[0] for p in unet_plan(NGF, 192, 64)
                                   if p[2] != ["x"]])
def test_flagship_consumer_fits(net, stage):
    """Each of the 17 stages that reads layer-normed inputs (640x320, ngf
    64): its sources' channels cover its Cin; each source's producer
    writes stats_blocks partials a sample (its own plan); the consumer's
    ring keeps two stages beside the vectors (8 bytes a channel), within a
    block's shared memory with the kernel's static arrays, x NCHW and
    channels-last (the net's layout, its output tile staged in shared
    memory but for the head's)."""
    variant, smoothed = net.split("_")[0], net.endswith("smoothed")
    plan = {p[0]: p for p in unet_plan(NGF, 192, 64)}
    name, kind, srcs, cins, cout, ind, _, rate = plan[stage]
    args = conv_args(kind, rate, variant, smoothed)
    assert sum(plan[s][4] for s in srcs) == sum(cins)
    for s in srcs:
        _, pk, _, pc, pco, pind, _, prate = plan[s]
        pargs = conv_args(pk, prate, variant, smoothed)
        shape = (1, sum(pc), H // pind, W // pind)
        n = conv_ops.stats_blocks(shape, pco, pargs["kh"], pargs["kw"],
                                  pargs.get("stride", 1), pargs.get("dil", 1),
                                  pargs.get("pad", 0), pargs.get("npar", 1),
                                  pargs.get("hpad", "wrap"))
        assert 1 <= n <= (H // pind) * (W // pind) * 4
    h, w = H // ind, W // ind
    _, wo = conv_ops.grid_of((1, sum(cins), h, w), args["kh"], args["kw"],
                             args.get("stride", 1), args.get("dil", 1),
                             args.get("pad", 0), args.get("npar", 1))
    stage_b, stages, dyn = conv_ops.conv_smem(
        sum(cins), w, cout, wo, args["kw"], args.get("stride", 1),
        args.get("hpad", "wrap"), True)
    _, stages0, dyn0 = conv_ops.conv_smem(
        sum(cins), w, cout, wo, args["kw"], args.get("stride", 1),
        args.get("hpad", "wrap"), False)
    assert stages == stages0 == 2
    assert dyn - dyn0 == -(-sum(cins) // 64) * 64 * 8
    assert dyn + STATIC_SMEM <= BLOCK_SMEM
    _, stages_cl, dyn_cl = conv_ops.conv_smem(
        sum(cins), w, cout, wo, args["kw"], args.get("stride", 1),
        args.get("hpad", "wrap"), True, True, kind != "head")
    assert stages_cl == 2
    assert dyn_cl + STATIC_SMEM <= BLOCK_SMEM


def test_conv_smem_refuses_what_does_not_fit():
    """A ring of two stages and the vectors must fit: at Cin 8192 the
    vectors (64 KB) leave room for one 96 KB stage only."""
    args = dict(cin=8192, wi=64, cout=128, wo=32, kw=3, stride=2,
                hpad="wrap")
    assert conv_ops.conv_smem(**args, norm=False)[1] == 2
    assert conv_ops.conv_smem(**args, norm=True)[1:] == (0, 0)



def _good_norm(c=(8, 16)):
    return [conv_ops.Norm(torch.zeros(2, 5, 2), torch.ones(k), torch.zeros(k))
            for k in c]


@pytest.mark.parametrize("case", [
    "three sources", "channels", "partials missing", "partials f64",
    "partials shape", "partials batch", "gamma length", "beta dtype",
    "beta strided"])
def test_norm_operands_are_checked(case):
    """The wrapper's checks of a conv's layer-norm operands (ops/conv.py
    `_norm_args`, which conv runs before every normed launch), on CPU
    tensors as the device: each malformed operand raises ValueError with
    its message; well-formed ones give the kernel's arguments."""
    x = torch.zeros(2, 24, 4, 8)
    norm = _good_norm()
    args = conv_ops._norm_args(norm, x)
    assert args[:2] == [2, 8] and args[5] == args[9] == 5
    assert conv_ops._norm_args(_good_norm((24,)), x)[-4:] == [None] * 3 + [0]
    p, g, bt = norm[1]
    bad = {
        "three sources": _good_norm((8, 8, 8)),
        "channels": _good_norm((8, 8)),
        "partials missing": [norm[0], conv_ops.Norm(None, g, bt)],
        "partials f64": [norm[0], conv_ops.Norm(p.double(), g, bt)],
        "partials shape": [norm[0], conv_ops.Norm(p[..., :1], g, bt)],
        "partials batch": [norm[0], conv_ops.Norm(p[:1], g, bt)],
        "gamma length": [norm[0], conv_ops.Norm(p, g[:15], bt)],
        "beta dtype": [norm[0], conv_ops.Norm(p, g, bt.half())],
        "beta strided": [norm[0], conv_ops.Norm(p, g, torch.zeros(32)[::2])],
    }[case]
    with pytest.raises(ValueError, match="conv: norm"):
        conv_ops._norm_args(bad, x)
