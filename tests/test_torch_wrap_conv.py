"""The port's per-layer wrap conv (K7, ops/wrap_conv.py) against the JAX
package's Pallas kernels in interpret mode, and its hand-written gradient.

The plain versions of K7a, K7b and K7c (the route every CPU tensor takes)
against `pallas_conv.conv3x3_wrap`, `conv3x3_wrap_dma` and
`conv3x3_ln_stats` with interpret=True, on tests/test_pallas_conv.py's
shapes and its tolerance (1e-5: the same float32 products summed in
another order). The autograd Function by `torch.autograd.gradcheck` in
float64: the adjoint-weight dgrad, the weight and bias gradients and the
gradient through the layer-norm sums.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from matryodshka_tpu.ops import pallas_conv
from matryodshka_tpu_torch.ops import wrap_conv as wc
from matryodshka_tpu_torch.ops.conv import wrap_pad
from matryodshka_tpu_torch.ops.net import unet_plan

torch.set_num_threads(1)


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2)))


def _weight(k):
    """flax [3, 3, Cin, Cout] -> [Cout, Cin, 3, 3]."""
    return torch.from_numpy(np.ascontiguousarray(k.transpose(3, 2, 0, 1)))


def _nhwc(t):
    return t.permute(0, 2, 3, 1).numpy()


@pytest.mark.parametrize("with_bias", [False, True])
def test_k7a_plain_matches_pallas(with_bias):
    rng = np.random.RandomState(0 + with_bias)
    x = rng.rand(2, 16, 128, 12).astype(np.float32)
    k = (rng.rand(3, 3, 12, 10) - 0.5).astype(np.float32)
    b = rng.rand(10).astype(np.float32) if with_bias else None
    want = pallas_conv.conv3x3_wrap(
        jnp.asarray(x), jnp.asarray(k),
        bias=None if b is None else jnp.asarray(b), row_block=8,
        interpret=True)
    got = wc.conv3x3_wrap(_nchw(x), _weight(k),
                          None if b is None else torch.from_numpy(b))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(_nhwc(got), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_k7b_plain_matches_pallas():
    rng = np.random.RandomState(2)
    x = rng.rand(1, 16, 128, 12).astype(np.float32)
    k = (rng.rand(3, 3, 12, 10) - 0.5).astype(np.float32)
    b = rng.rand(10).astype(np.float32)
    want = pallas_conv.conv3x3_wrap_dma(jnp.asarray(x), jnp.asarray(k),
                                        bias=jnp.asarray(b), row_block=8,
                                        interpret=True)
    got = wc.conv3x3_wrap_dma(_nchw(x), _weight(k), torch.from_numpy(b))
    np.testing.assert_allclose(_nhwc(got), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_k7b_bias_rounding_within_one_bf16_step():
    """bf16: the port adds the bias in f32 before its one rounding, the
    TPU kernel rounds the conv, then adds the rounded bias in bf16. Each
    of those roundings moves a value by at most half a bf16 step (2^-9 of
    its magnitude), so the two differ by at most 2^-7 (|conv| + |bias|)."""
    rng = np.random.RandomState(3)
    x = torch.from_numpy(rng.rand(1, 6, 8, 16).astype(np.float32)).to(
        torch.bfloat16)
    w = torch.from_numpy((rng.rand(5, 6, 3, 3) - 0.5).astype(np.float32))
    b = torch.from_numpy(rng.rand(5).astype(np.float32))
    got = wc.conv3x3_wrap_dma(x, w, b)
    tpu = wc.conv3x3_wrap_dma(x, w) + b.to(torch.bfloat16)[:, None, None]
    assert got.dtype == tpu.dtype == torch.bfloat16
    scale = wc.conv3x3_wrap(x, w).abs() + b.abs()[:, None, None]
    err = (got.float() - tpu.float()).abs()
    assert (err <= 2.0 ** -7 * scale).all()
    assert err.max() > 0


def test_k7c_plain_matches_pallas():
    """y to 1e-5 and the sums to rtol 1e-5 of the interpret-mode kernel,
    which takes a lane-padded input and pads its output lanes with zeros;
    the port has neither pad."""
    rng = np.random.RandomState(3)
    h, w, cin, cout, cin_pad = 16, 128, 12, 10, 128
    x = rng.rand(h, w, cin).astype(np.float32)
    k = (rng.rand(3, 3, cin, cout) - 0.5).astype(np.float32)
    b = rng.rand(cout).astype(np.float32)
    xp = jnp.pad(jnp.asarray(x), ((0, 0), (0, 0), (0, cin_pad - cin)))
    y, s1, s2 = pallas_conv.conv3x3_ln_stats(xp, jnp.asarray(k),
                                             jnp.asarray(b), cin,
                                             row_block=8, interpret=True)
    gy, gs1, gs2 = wc.conv3x3_ln_stats(_nchw(x[None]), _weight(k),
                                       torch.from_numpy(b))
    assert gy.shape == (1, cout, h, w) and gs1.dtype == torch.float64
    np.testing.assert_allclose(_nhwc(gy)[0], np.asarray(y)[:, :, :cout],
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(gs1.numpy(), [float(s1)], rtol=1e-5)
    np.testing.assert_allclose(gs2.numpy(), [float(s2)], rtol=1e-5)


def test_k7c_sums_are_over_rounded_outputs():
    """bf16: the sums run over the stored (rounded) y, as
    _conv_ln_kernel:368-370 does, in float64."""
    rng = np.random.RandomState(4)
    x = torch.from_numpy(rng.randn(2, 4, 8, 12).astype(np.float32)).to(
        torch.bfloat16)
    w = torch.from_numpy(rng.randn(6, 4, 3, 3).astype(np.float32))
    b = torch.from_numpy(rng.randn(6).astype(np.float32))
    y, s1, s2 = wc.conv3x3_ln_stats(x, w, b)
    assert y.dtype == torch.bfloat16
    y64 = y.double()
    assert torch.equal(s1, y64.sum(dim=(1, 2, 3)))
    assert torch.equal(s2, (y64 * y64).sum(dim=(1, 2, 3)))


def _gradcheck_inputs(seed, width=5):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(2, 3, 4, width, generator=g, dtype=torch.float64)
    w = torch.randn(4, 3, 3, 3, generator=g, dtype=torch.float64)
    b = torch.randn(4, generator=g, dtype=torch.float64)
    return [t.requires_grad_() for t in (x, w, b)]


@pytest.mark.parametrize("width", [1, 2, 5])
def test_function_gradcheck(width):
    """dgrad (K7a on the adjoint weights), wgrad and db, float64; widths 1
    and 2 wrap every tap onto the row itself."""
    x, w, b = _gradcheck_inputs(width, width)
    assert torch.autograd.gradcheck(
        lambda x, w, b: wc.wrap_conv3x3(x, w, b), (x, w, b))


def test_function_gradcheck_stats():
    """The stats form: gradients through y, s1 and s2 (gy + gs1 + 2 y gs2)
    by gradcheck on all three outputs, and through a layer norm built on
    the sums."""
    x, w, b = _gradcheck_inputs(7)
    assert torch.autograd.gradcheck(
        lambda x, w, b: wc.wrap_conv3x3(x, w, b, stats=True), (x, w, b))

    def normalized(x, w, b):
        y, s1, s2 = wc.wrap_conv3x3(x, w, b, stats=True)
        n = y[0].numel()
        mean = s1 / n
        var = s2 / n - mean.square()
        return (y - mean[:, None, None, None]) * torch.rsqrt(
            var + 1e-6)[:, None, None, None]

    assert torch.autograd.gradcheck(normalized, (x, w, b))


def test_dgrad_is_the_conv_on_adjoint_weights():
    """dL/dx of the wrap conv equals the same conv of dL/dy with
    W'[ci, co, kh, kw] = W[co, ci, 2 - kh, 2 - kw] (autograd of F.conv2d
    on the wrap-padded input as the yardstick); the Function skips dgrad
    when x needs no gradient."""
    x, w, b = _gradcheck_inputs(8)
    gy = torch.randn(2, 4, 4, 5, dtype=torch.float64)
    ref = F.conv2d(wrap_pad(x, 1, 1, 1, 1), w) + b[:, None, None]
    want = torch.autograd.grad(ref, x, gy)[0]
    got = wc.conv3x3_wrap(gy, wc.adjoint(w.detach()))
    torch.testing.assert_close(got, want, rtol=1e-12, atol=1e-12)
    xd = x.detach()
    y = wc.wrap_conv3x3(xd, w, b)
    y.backward(gy)
    assert xd.grad is None and w.grad is not None and b.grad is not None
    dw, db = wc.conv3x3_wrap_wgrad(gy, xd)
    torch.testing.assert_close(w.grad, dw)
    torch.testing.assert_close(b.grad, db)


def test_wgrad_split_plan():
    """The pixel sum's split is fixed by the shape, covers every pixel
    and keeps chunks at >= 256 pixels, multiples of 16."""
    for k, cout, cin in ((204800, 64, 192), (12800, 256, 256), (1, 8, 8),
                         (51200, 128, 128)):
        splits, chunk = wc.wgrad_splits(k, cout, cin)
        assert splits >= 1 and chunk % 16 == 0
        assert splits * chunk >= k > (splits - 1) * chunk
        assert splits == 1 or chunk >= 256
    assert wc.wgrad_splits(204800, 64, 192)[0] > 8


#: The trainer's stride-1 wrap convs at the flagship shape (name, Cin,
#: Cout, H, W): the weight-gradient kernel's eight shapes.
TRAINER_WGRAD = [(name, sum(cins), cout, 320 // ind, 640 // ind)
                 for (name, kind, _, cins, cout, ind, _, rate)
                 in unet_plan(64, 192, 1) if kind == "conv" and rate == 1]


def test_trainer_wgrad_shapes():
    assert [s[0] for s in TRAINER_WGRAD] == [
        "conv1_1", "conv2_1", "conv3_1", "conv3_2", "conv6_2", "conv6_3",
        "conv7_2", "conv8_2"]


#: PP and RealEstate's first layer (Cin 192 or, with the coord channel,
#: 195) at the flagship size, and tests/test_torch_kernels_cuda.py's
#: WGRAD_RAGGED shapes (B, Cin, Cout, H, W): odd channel counts, W = 40,
#: 37 and 5 (not a multiple of 16: gathered stages; W = 5 wraps every
#: tap onto the row).
PP_WGRAD = [(1, 192, 64, 320, 640), (1, 195, 64, 320, 640)]
WGRAD_RAGGED = [(2, 13, 19, 6, 40), (2, 33, 65, 37, 40), (1, 7, 9, 5, 37),
                (2, 5, 3, 4, 5)]


def _check_wgrad_plan(b, cin, cout, h, w, sms=wc.H100_SMS):
    """The bfloat16 kernel's plan is a function of the shape and covers
    the work once: k-steps of kp pixels of one image row cover every pixel
    once (kp divides W where the stages come by TMA), the splits cover
    every k-step once and none is empty, the 64 x 64 tiles cover every
    (Cout, Cin) pair, tiles x splits blocks fit one per SM when there is
    more than one split (the fold's cooperative launch), and the splits'
    slices of a tile's entries cover each entry once. Returns the plan."""
    plan = wc.wgrad_plan(b, h, w, cout, cin, sms)
    assert plan == wc.wgrad_plan(b, h, w, cout, cin, sms)
    assert plan.kp in (16, 32, 64) and plan.kpr == -(-w // plan.kp)
    assert plan.tma == (w % 16 == 0)
    assert not plan.tma or w % plan.kp == 0
    assert w % plan.kp == 0 or plan.kp == 16
    assert plan.kblocks == b * h * plan.kpr
    k = plan.splits * plan.chunk
    assert k >= plan.kblocks > k - plan.chunk
    kb = np.arange(plan.kblocks)
    row, x0 = kb // plan.kpr, (kb % plan.kpr) * plan.kp
    count = np.zeros((b * h, w), np.int64)
    for d in range(plan.kp):
        ok = x0 + d < w
        np.add.at(count, (row[ok], x0[ok] + d), 1)
    assert (count == 1).all()
    bc, bn = wc.WGRAD_TILE
    assert plan.ctiles * bc >= cin > (plan.ctiles - 1) * bc
    assert plan.mtiles * bn >= cout > (plan.mtiles - 1) * bn
    assert plan.splits == 1 or plan.tiles * plan.splits <= sms
    for tile_c in (0, 1):
        n = 9 * bc * bn + (bn if tile_c == 0 else 0)
        cover = np.zeros(n, np.int64)
        for z in range(plan.splits):
            cover[n * z // plan.splits:n * (z + 1) // plan.splits] += 1
        assert (cover == 1).all()
    return plan


@pytest.mark.parametrize("shape", TRAINER_WGRAD,
                         ids=[s[0] for s in TRAINER_WGRAD])
@pytest.mark.parametrize("batch", [1, 2])
def test_wgrad_tc_plan(shape, batch):
    """The bfloat16 kernel's plan at the trainer's shapes: every stage by
    TMA, k-steps of 64 pixels at W = 640 and 320 and of 32 at W = 160, the
    pixel sum split so that tiles x splits fill 120-132 of the H100's 132
    SMs, and the f32 partials under 24 MB."""
    _, cin, cout, h, w = shape
    plan = _check_wgrad_plan(batch, cin, cout, h, w)
    assert plan.tma and plan.kp == (32 if w == 160 else 64)
    assert 120 <= plan.tiles * plan.splits <= 132
    assert plan.splits * plan.tiles * wc.WGRAD_TILE_ENTRIES * 4 <= 24e6


@pytest.mark.parametrize("shape", PP_WGRAD + WGRAD_RAGGED,
                         ids=["x".join(map(str, s))
                              for s in PP_WGRAD + WGRAD_RAGGED])
@pytest.mark.parametrize("sms", [wc.H100_SMS, 7])
def test_wgrad_plan_valid(shape, sms):
    """The plan at PP's and RealEstate's first layer (Cin 192 and 195: a
    ragged last Cin tile) and at the CUDA tests' ragged shapes (gathered
    stages, ragged k-steps), on the H100's SMs and on 7 (several k-steps a
    split; one split where the tiles alone exceed the SMs)."""
    b, cin, cout, h, w = shape
    plan = _check_wgrad_plan(b, cin, cout, h, w, sms)
    if sms == wc.H100_SMS and w == 640:
        assert plan.tma and plan.kp == 64 and plan.ctiles == 3 + (cin > 192)


def _fragment_store():
    """[9, 64, 64] -> the partial entry a consumer thread of the kernel
    stores accumulator (tap, ci, co) at: thread wtid of the tap's
    warpgroup (warp wtid // 32, lane's group gq = lane // 4 and q4 =
    lane % 4) holds accumulator 4 j + 2 h + e = (ci 16 warp + gq + 8 h, co
    8 j + 2 q4 + e) and stores it at ((tap * 8 + j) * 128 + wtid) * 4 +
    2 h + e."""
    out = np.full((9, 64, 64), -1, np.int64)
    for tap in range(9):
        for wtid in range(128):
            warp, lane = divmod(wtid, 32)
            gq, q4 = divmod(lane, 4)
            for j in range(8):
                for h in range(2):
                    for e in range(2):
                        out[tap, 16 * warp + gq + 8 * h, 8 * j + 2 * q4 + e] \
                            = ((tap * 8 + j) * 128 + wtid) * 4 + 2 * h + e
    return out


def _fragment_decode(f):
    """The fold's decoding of entries f < 9 * 4096: (tap, ci, co)."""
    rem = f & 4095
    thr, v = (rem >> 2) & 127, rem & 3
    return (f >> 12, 16 * (thr >> 5) + ((thr & 31) >> 2) + 8 * (v >> 1),
            8 * (rem >> 9) + 2 * (thr & 3) + (v & 1))


def test_wgrad_partial_layout():
    """The consumers' stores fill each of a tile's 9 * 64 * 64 partial
    entries once, and the fold decodes every entry to the accumulator that
    was stored there."""
    store = _fragment_store()
    assert sorted(store.ravel()) == list(range(9 * 64 * 64))
    tap, ci, co = _fragment_decode(store)
    grid = np.indices(store.shape)
    assert (tap == grid[0]).all() and (ci == grid[1]).all() \
        and (co == grid[2]).all()


def _wgrad_tc_emulated(g, x, sms=wc.H100_SMS, tma=None):
    """The bfloat16 kernel's algorithm in float64 on the CPU, as the plan
    lays it out: per split, per k-step (b, y, x0) in order, the g tile
    g[b, :, y, x0:x0+kp] (zero past the row end and past Cout) and the
    window of input rows y-1..y+1 (zero outside [0, H) and past Cin) with
    8 halo columns either side, loaded as the TMA boxes lie (the main box
    at x0, the halo boxes at x0 - 8 or W - 8 and at x0 + kp or 0) or
    gathered (columns x0 - 8 + j wrapped mod W); tap (kh, kw) takes window
    row kh shifted by kw - 1 columns. Each split's accumulators go to its
    partial in the consumers' fragment order (db from the same g tiles,
    first Cin tile only); the fold sums the splits in order and decodes
    each entry to dW."""
    b, cin, h, w = x.shape
    cout = g.shape[1]
    plan = wc.wgrad_plan(b, h, w, cout, cin, sms)
    tma = plan.tma if tma is None else tma
    kp, halo = plan.kp, wc.WGRAD_HALO
    bc, bn = wc.WGRAD_TILE
    ci_n, co_n = plan.ctiles * bc, plan.mtiles * bn
    xp = torch.zeros(b, ci_n, h + 2, w, dtype=torch.float64)
    xp[:, :cin, 1:h + 1] = x
    gp = torch.zeros(b, co_n, h, w, dtype=torch.float64)
    gp[:, :cout] = g
    ntap = 9 * bc * bn
    store = torch.from_numpy(_fragment_store().reshape(9, -1))
    partial = torch.zeros(plan.splits, plan.tiles, wc.WGRAD_TILE_ENTRIES,
                          dtype=torch.float64)
    for z in range(plan.splits):
        acc = torch.zeros(9, ci_n, co_n, dtype=torch.float64)
        dbs = torch.zeros(co_n, dtype=torch.float64)
        for k in range(z * plan.chunk,
                       min((z + 1) * plan.chunk, plan.kblocks)):
            row, xc = divmod(k, plan.kpr)
            bi, y = divmod(row, h)
            x0 = xc * kp
            cols = torch.arange(x0, x0 + kp)
            gt = gp[bi, :, y, cols % w] * (cols < w)
            rows = xp[bi, :, y:y + 3]
            if tma:
                lcol = w - halo if x0 == 0 else x0 - halo
                rcol = 0 if x0 + kp >= w else x0 + kp
                win = torch.cat([rows[..., lcol:lcol + halo],
                                 rows[..., x0:x0 + kp],
                                 rows[..., rcol:rcol + halo]], dim=-1)
            else:
                win = rows[..., torch.arange(x0 - halo, x0 + kp + halo) % w]
            for kh in range(3):
                for kw in range(3):
                    a = win[:, kh, halo + kw - 1:halo + kw - 1 + kp]
                    acc[3 * kh + kw] += a @ gt.T
            dbs += gt.sum(dim=1)
        for ct in range(plan.ctiles):
            for mt in range(plan.mtiles):
                tile = ct * plan.mtiles + mt
                sub = acc[:, ct * bc:(ct + 1) * bc, mt * bn:(mt + 1) * bn]
                partial[z, tile, store.ravel()] = sub.reshape(-1)
                if ct == 0:
                    partial[z, tile, ntap:] = dbs[mt * bn:(mt + 1) * bn]
    total = torch.zeros_like(partial[0])
    for z in range(plan.splits):
        total += partial[z]
    tap, ci, co = (torch.from_numpy(a)
                   for a in _fragment_decode(np.arange(ntap)))
    dw = torch.zeros(co_n, ci_n, 9, dtype=torch.float64)
    db = torch.zeros(co_n, dtype=torch.float64)
    for ct in range(plan.ctiles):
        for mt in range(plan.mtiles):
            tile = ct * plan.mtiles + mt
            dw[mt * bn + co, ct * bc + ci, tap] = total[tile, :ntap]
            if ct == 0:
                db[mt * bn:(mt + 1) * bn] = total[tile, ntap:]
    return dw[:cout, :cin].reshape(cout, cin, 3, 3), db[:cout]


@pytest.mark.parametrize("shape", [(2, 5, 7, 6, 40), (1, 3, 4, 3, 37),
                                   (2, 33, 65, 5, 8), (1, 4, 3, 4, 1)])
def test_wgrad_tc_algorithm_matches_plain(shape):
    """The emulated wgmma algorithm (gathered stages: k-steps past the row
    end, ragged W, W < 16, odd channel counts, several splits) against the
    plain version, float64."""
    b, cin, cout, h, w = shape
    rng = np.random.RandomState(sum(shape))
    x = torch.from_numpy(rng.randn(b, cin, h, w))
    g = torch.from_numpy(rng.randn(b, cout, h, w))
    dw, db = _wgrad_tc_emulated(g, x)
    dwp, dbp = wc.conv3x3_wrap_wgrad_plain(g, x)
    torch.testing.assert_close(dw, dwp, rtol=1e-12, atol=1e-12)
    torch.testing.assert_close(db, dbp, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("shape,sms,tma", [
    ((2, 6, 5, 3, 5), 132, False),     # W = 5: every tap wraps, batch 2
    ((1, 4, 6, 4, 3), 5, False),       # W = 3 on 5 SMs: splits of 3 k-steps
    ((2, 70, 65, 3, 16), 132, True),   # TMA, kp 16: both halos at the seam
    ((2, 9, 12, 3, 96), 6, True),      # TMA, kp 32 (as W = 160)
    ((1, 5, 70, 4, 128), 9, True),     # TMA, kp 64, two Cout tiles
    ((2, 7, 5, 3, 64), 132, False),    # the same window gathered
])
def test_wgrad_window_emulation_matches_plain(shape, sms, tma):
    """The tap-shifted window with its wrapped halo boxes (or gathered
    columns) and the fixed split order, emulated in float64, against the
    plain version: W = 5 and W = 3 (every tap wraps), batch 2, both stage
    forms at k-steps of 16, 32 and 64 pixels."""
    b, cin, cout, h, w = shape
    rng = np.random.RandomState(sum(shape) + sms)
    x = torch.from_numpy(rng.randn(b, cin, h, w))
    g = torch.from_numpy(rng.randn(b, cout, h, w))
    plan = wc.wgrad_plan(b, h, w, cout, cin, sms)
    assert plan.tma == (w % 16 == 0)
    dw, db = _wgrad_tc_emulated(g, x, sms, tma)
    dwp, dbp = wc.conv3x3_wrap_wgrad_plain(g, x)
    torch.testing.assert_close(dw, dwp, rtol=1e-12, atol=1e-12)
    torch.testing.assert_close(db, dbp, rtol=1e-12, atol=1e-12)


def test_wrappers_raise_off_cpu_and_cuda():
    """A tensor on neither the CPU nor a card neither runs the plain
    version nor counts a launch."""
    meta = torch.device("meta")
    x = torch.empty((1, 4, 8, 16), device=meta)
    w = torch.empty((5, 4, 3, 3), device=meta)
    b = torch.empty(5, device=meta)
    before = (wc.k7a_launches, wc.k7b_launches, wc.k7c_launches,
              wc.wgrad_launches)
    for fn in (lambda: wc.conv3x3_wrap(x, w, b),
               lambda: wc.conv3x3_wrap_dma(x, w, b),
               lambda: wc.conv3x3_ln_stats(x, w, b),
               lambda: wc.conv3x3_wrap_wgrad(
                   torch.empty((1, 5, 8, 16), device=meta), x)):
        with pytest.raises(ValueError):
            fn()
    assert before == (wc.k7a_launches, wc.k7b_launches, wc.k7c_launches,
                      wc.wgrad_launches)
