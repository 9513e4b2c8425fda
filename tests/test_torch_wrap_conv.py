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


@pytest.mark.parametrize("shape", TRAINER_WGRAD,
                         ids=[s[0] for s in TRAINER_WGRAD])
@pytest.mark.parametrize("batch", [1, 2])
def test_wgrad_tc_plan(shape, batch):
    """The bfloat16 kernel's plan at the trainer's shapes: the k-blocks
    (runs of 32 pixels of one image row) cover every pixel once, the
    splits cover every k-block once, the 64 x 32-channel tiles cover every
    (Cout, Cin) column, the grid stays within one wave of 2 blocks per SM,
    the f32 partials stay under 24 MB, and the plan is a function of the
    shape alone."""
    _, cin, cout, h, w = shape
    bm, bc, bk = wc.WGRAD_TC_TILE
    splits, chunk = wc.wgrad_tc_splits(batch, h, w, cout, cin)
    assert (splits, chunk) == wc.wgrad_tc_splits(batch, h, w, cout, cin)
    nkb = wc.wgrad_tc_kblocks(batch, h, w)
    kpr = -(-w // bk)
    assert nkb == batch * h * kpr
    assert splits * chunk >= nkb > (splits - 1) * chunk
    kb = np.arange(nkb)
    row, x0 = kb // kpr, (kb % kpr) * bk
    count = np.zeros((batch * h, w), np.int64)
    for d in range(bk):
        ok = x0 + d < w
        np.add.at(count, (row[ok], x0[ok] + d), 1)
    assert (count == 1).all()
    tiles = -(-cin // bc) * -(-cout // bm)
    assert tiles * bc * bm >= cin * cout
    assert tiles * splits <= 2 * 132
    assert splits * cout * (9 * cin + 1) * 4 <= 24e6


def _wgrad_tc_emulated(g, x):
    """The bfloat16 kernel's algorithm in float64 on the CPU: per split, per
    k-block (b, y, x0), the g run g[b, :, y, x0:x0+32] (zero past the row
    end) times the nine tap views of the x halo tile (rows y-1..y+1, zero
    outside [0, H); the run shifted by -1, 0, +1 pixel, wrapped), summed
    into the split's partial; db from the same g runs; then the splits in
    order."""
    b, cin, h, w = x.shape
    cout = g.shape[1]
    bk = wc.WGRAD_TC_TILE[2]
    kpr = -(-w // bk)
    nkb = wc.wgrad_tc_kblocks(b, h, w)
    splits, chunk = wc.wgrad_tc_splits(b, h, w, cout, cin)
    xp = F.pad(x, (0, 0, 1, 1))
    dw = torch.zeros(cout, cin, 3, 3, dtype=torch.float64)
    db = torch.zeros(cout, dtype=torch.float64)
    for z in range(splits):
        pw = torch.zeros_like(dw)
        pb = torch.zeros_like(db)
        for k in range(z * chunk, min((z + 1) * chunk, nkb)):
            r, xs = divmod(k, kpr)
            bi, y = divmod(r, h)
            cols = torch.arange(xs * bk, xs * bk + bk)
            a = g[bi, :, y, cols % w] * (cols < w)
            for kh in range(3):
                for kw in range(3):
                    pw[:, :, kh, kw] += a @ xp[bi, :, y + kh,
                                               (cols + kw - 1) % w].T
            pb += a.sum(dim=1)
        dw += pw
        db += pb
    return dw, db


@pytest.mark.parametrize("shape", [(2, 5, 7, 6, 40), (1, 3, 4, 3, 37),
                                   (2, 33, 65, 5, 8), (1, 4, 3, 4, 1)])
def test_wgrad_tc_algorithm_matches_plain(shape):
    """The emulated tensor-core algorithm (k-blocks past the row end,
    ragged W, W < 32, odd channel counts, several splits) against the
    plain version, float64."""
    b, cin, cout, h, w = shape
    rng = np.random.RandomState(sum(shape))
    x = torch.from_numpy(rng.randn(b, cin, h, w))
    g = torch.from_numpy(rng.randn(b, cout, h, w))
    dw, db = _wgrad_tc_emulated(g, x)
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
