"""The bf16 conv kernel's plan and addressing, on the CPU.

`ops/conv.conv_plan` mirrors `csrc/conv.cu:make_plan` (the tile, its pixel
rows x columns, and which operands arrive by TMA); here it is held to what
every stage of the flagship nets, the smoothed folds, K7's trainer shapes,
the PP / RealEstate first layers and the CUDA edge cases need. Then the
kernel's algorithm is emulated in float64 (`_emulated`): per block, per
stage, the TMA window (a main box and two halo boxes with their
out-of-bounds zero fill, the halos wrapped across the seam by their
coordinates) or the gathered one, each tap's A fragment at its column
shift within the window, the coord term the epilogue adds and the parity
scatter, held to `conv_plain` in float64 within 1e-12. The card runs the same plan
(`tests/test_torch_kernels_cuda.py` compares `matry_conv_plan` with it).
"""

import functools

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from matryodshka_tpu_torch.ops import conv as conv_ops
from matryodshka_tpu_torch.ops.net import conv_args, has_coord, unet_plan
from test_torch_kernels_cuda import EDGE_CASES

H, W, NGF = 320, 640, 64
#: K7's trainer layers (ops/wrap_conv.py: the stride-1, rate-1 3x3 convs of
#: the wrap net): (Cin, Cout, size divisor).
K7_SHAPES = [(sum(cins), cout, ind)
             for (_, kind, _, cins, cout, ind, _, rate)
             in unet_plan(NGF, 192, 64) if kind == "conv" and rate == 1]


def _plan(b, cin, h, w, cout, args):
    ho, wo = conv_ops.grid_of((b, cin, h, w), args["kh"], args["kw"],
                              args.get("stride", 1), args.get("dil", 1),
                              args.get("pad", 0), args.get("npar", 1))
    return conv_ops.conv_plan(w, cout, wo, args.get("stride", 1),
                              args.get("hpad", "wrap")), ho, wo


def _flagship_stages(variant, smoothed=False):
    for (name, kind, _, cins, cout, ind, _, rate) in unet_plan(NGF, 192, 64):
        args = conv_args(kind, rate, variant, smoothed)
        yield name, kind, sum(cins), H // ind, W // ind, cout, args


@pytest.mark.parametrize("variant,smoothed", [("wrap", False),
                                              ("coord", False),
                                              ("wrap", True),
                                              ("coord", True)])
def test_plan_flagship_stages(variant, smoothed):
    """Every stage of the 640x320 ngf-64 net (and the smoothed net's three
    folded upsampling stages) takes the wgmma kernel on a tile whose
    columns divide Wo (no column of a 160- or 80-wide layer is wasted),
    128 Cout wide where Cout > 64, and reads its weights and its patch
    windows by TMA (the downs' rows at TMA's element stride 2)."""
    for name, kind, cin, h, w, cout, args in _flagship_stages(variant,
                                                              smoothed):
        plan, ho, wo = _plan(1, cin, h, w, cout, args)
        assert str(plan).startswith("wgmma "), name
        assert (plan.bm, plan.bn) in conv_ops.WGMMA_TILES
        assert plan.rows * plan.cols == plan.bn
        assert wo % plan.cols == 0 and ho % plan.rows == 0, name
        assert plan.bm == (128 if cout > 64 else 64), name
        assert plan.tma_w and plan.tma_x, name


#: The tiles the plan gives the wrap net's stages at 640x320, ngf 64
#: (Cout x pixels, rows x columns of output pixels).
FLAGSHIP_TILES = {
    "conv1_1": "wgmma 64x128 (2x64 px, patch TMA, weights TMA)",
    "conv1_2": "wgmma 128x128 (4x32 px, patch TMA, weights TMA)",
    "conv2_1": "wgmma 128x128 (2x64 px, patch TMA, weights TMA)",
    "conv2_2": "wgmma 128x128 (4x32 px, patch TMA, weights TMA)",
    "conv3_1": "wgmma 128x128 (4x32 px, patch TMA, weights TMA)",
    "conv3_3": "wgmma 128x128 (8x16 px, patch TMA, weights TMA)",
    "conv4_1": "wgmma 128x128 (8x16 px, patch TMA, weights TMA)",
    "conv6_1": "wgmma 128x128 (8x16 px, patch TMA, weights TMA)",
    "conv7_1": "wgmma 128x128 (4x32 px, patch TMA, weights TMA)",
    "conv8_1": "wgmma 64x128 (2x64 px, patch TMA, weights TMA)",
    "color_pred": "wgmma 64x128 (2x64 px, patch TMA, weights TMA)",
}


def test_plan_flagship_tiles():
    """The plan's tiles at the wrap net's stages, by name."""
    got = {name: str(_plan(1, cin, h, w, cout, args)[0])
           for name, _, cin, h, w, cout, args in _flagship_stages("wrap")}
    assert {k: got[k] for k in FLAGSHIP_TILES} == FLAGSHIP_TILES


@pytest.mark.parametrize("batch", [1, 2])
def test_plan_k7_trainer_shapes(batch):
    """K7a/b/c at the eight trainer shapes (wrap, stride 1, rate 1; the
    dgrad swaps Cin and Cout): the wgmma kernel with both operands by TMA,
    tiles that divide the output."""
    for cin, cout, ind in K7_SHAPES:
        for ci, co in ((cin, cout), (cout, cin)):
            args = dict(kh=3, kw=3, pad=1)
            plan, ho, wo = _plan(batch, ci, H // ind, W // ind, co, args)
            assert plan.tma_x and plan.tma_w
            assert wo % plan.cols == 0 and ho % plan.rows == 0


@pytest.mark.parametrize("cin", [193, 196])
def test_plan_pp_realestate_first_layer(cin):
    """The PP and RealEstate nets' first layer (Cin' 193 / 196 with the
    coord channel: Cin 192 / 195 read by TMA, the ragged chunk zero-filled
    past Cin)."""
    plan, _, _ = _plan(1, cin - 1, H, W, NGF,
                       dict(kh=3, kw=3, pad=(1, 1), hpad="zero"))
    assert plan.tma_x and plan.tma_w and str(plan).startswith("wgmma 64x")


@pytest.mark.parametrize("cout,tma_w", [(64, True), (67, False),
                                        (99, False)])
def test_plan_heads(cout, tma_w):
    """The 1x1 heads: 64 outputs (blend_psv) by TMA; 67 and 99 (blend_bg,
    blend_bg_psv), whose weight rows are not a multiple of 16 bytes, through
    the generic producer's weight gather."""
    for hpad in ("wrap", "zero"):
        plan, _, _ = _plan(1, NGF, H, W, cout,
                           dict(kh=1, kw=1, hpad=hpad))
        assert plan.tma_w == tma_w and plan.tma_x


@pytest.mark.parametrize("case", [c[0] for c in EDGE_CASES])
def test_plan_edge_cases(case):
    """The CUDA edge cases' plans: the patch windows gathered exactly where
    a tensor map cannot express them (x's rows not a multiple of 16 bytes,
    W % 8 != 0) or a wrapped window would come from a ragged tile (wrap
    mode, the tile's columns not dividing Wo), the weights where Cout % 8
    != 0; the tile's columns a divisor of Wo where one of 64, 32, 16 is."""
    _, b, cin, h, w, cout, args = next(c for c in EDGE_CASES
                                       if c[0] == case)
    plan, _, wo = _plan(b, cin, h, w, cout, args)
    assert plan.tma_x == (w % 8 == 0 and (args.get("hpad") == "zero"
                                          or wo % plan.cols == 0))
    assert plan.tma_w == (cout % 8 == 0)
    assert wo % plan.cols == 0 or wo % 16 != 0


# ---------------------------------------------------------------------------
# The kernel's addressing, emulated in float64.
# ---------------------------------------------------------------------------

BK = 64  # channels of one tap per k-step (csrc/conv.cu:wg::BK)


def _emulated(x, wk, bias, kh, kw, stride=1, dil=1, pad=0, npar=1,
              tanh=False, hpad="wrap", coord=None, out_dtype=None,
              halo_hpad=None, transform=None):
    """csrc/conv.cu's wgmma kernel in float64: block by block (Cout tile,
    pixel tile of plan.rows x plan.cols output pixels, sample and parity),
    stage by stage (channel chunk c0 outer, kernel row kh inner: the
    window of input rows iy0 + r * stride, _window), tap by tap along the
    row (the A fragment: the window's columns at the tap's shift, pixel c
    reading window column c * stride + kw * dil - pw + 8), times the tap's
    weight slab, rows arow .. arow + 63 of the packed [npar*K, Cout] (the
    next taps' rows past this tap's Cin, zero past the end). The epilogue
    adds the coord term (the coord weights times the coord value over the
    taps inside the input), then the bias, and writes the tile's valid
    pixels, at (2 oy + da, 2 ox + db) for npar 4. halo_hpad overrides the
    horizontal padding of the TMA halos alone; transform(win, bi, c0,
    iy0, ox0), if given, replaces each stage's window (the fused layer
    norm's in-place pass, tests/test_torch_conv_ln.py)."""
    b, cin, h, w = x.shape
    cout = wk.shape[2]
    lo = conv_ops.pad_pair(pad)[0] if npar == 1 else 1
    ho, wo = conv_ops.out_size(h, w, kh, kw, stride, dil, pad, npar)
    plan = conv_ops.conv_plan(w, cout, wo, stride, hpad)
    kcin = cin + (coord is not None)
    krows = npar * kh * kw * kcin
    nchunk = -(-cin // BK)
    # weights with the slab's tail of zeros, x with a zero margin
    wrows = torch.zeros(krows + BK, cout + plan.bm, dtype=torch.float64)
    wrows[:krows, :cout] = wk.reshape(krows, cout).double()
    xz = F.pad(x.double(), (MARGIN,) * 4)
    xz = torch.cat([xz, xz.new_zeros(b, nchunk * BK - cin, *xz.shape[2:])],
                   dim=1)
    oh, ow = (2 * ho, 2 * wo) if npar == 4 else (ho, wo)
    out = torch.zeros((b, cout, oh, ow), dtype=torch.float64)
    ct, rows = plan.cols, plan.rows
    ry, rx = torch.arange(rows), torch.arange(ct)
    for z in range(b * npar):
        bi, par = divmod(z, npar)
        da, db = par >> 1, par & 1
        khp = conv_ops.par_taps(kh, npar, da)
        kwp = conv_ops.par_taps(kw, npar, db)
        ph, pw = lo - da, lo - db
        for oy0 in range(0, ho, rows):
            for ox0 in range(0, wo, ct):
                for m0 in range(0, cout, plan.bm):
                    acc = torch.zeros(plan.bm, rows * ct,
                                      dtype=torch.float64)
                    for c0 in range(0, cin, BK):
                        for i in range(khp):
                            iy0 = oy0 * stride + i * dil - ph
                            win = _window(xz, bi, c0, iy0, ox0, ry, plan,
                                          stride, hpad, h, w,
                                          halo_hpad or hpad)
                            if transform is not None:
                                win = transform(win, bi, c0, iy0, ox0)
                            for j in range(kwp):
                                cols = rx * stride + j * dil - pw + HALO
                                arow = par * kh * kw * kcin + (
                                    i * kwp + j) * kcin + c0
                                a = wrows[arow:arow + BK, m0:m0 + plan.bm]
                                acc += a.T @ win[:, :, cols].reshape(BK, -1)
                    _epilogue(out, acc, bias, wrows, coord, kcin, cin, kh,
                              kw, stride, dil, lo, h, w, ho, wo, bi, da, db,
                              m0, oy0, ox0, ry, rx, npar, tanh)
    return out


HALO = 8      # window columns each side of a tile (csrc/conv.cu:kHalo)
MARGIN = 300  # zero margin of the emulation's input, past any box


def _box(xz, bi, c0, iy, col, ncol):
    """A TMA box: channels c0 .. c0 + 63, input rows iy (a vector), columns
    col .. col + ncol - 1, zero outside the input."""
    return xz[bi, c0:c0 + BK, MARGIN + iy, MARGIN + col:MARGIN + col + ncol]


def _window(xz, bi, c0, iy0, ox0, ry, plan, stride, hpad, h, w, halo_hpad):
    """One stage's window [64, rows, cols * stride + 16]: input rows
    iy0 + r * stride, columns ox0 * stride - 8 .. ox0 * stride + cols *
    stride + 7. By TMA (plan.tma_x): the main box at ox0 * stride and two
    8-column halo boxes, each zero outside the input; the left halo at the
    columns before the tile, wrapped to W - 8 across the seam (wrap) or
    taken at W, wholly outside (zero); the right one after the tile,
    wrapped to 0 across the seam. Else gathered, each column wrapped or
    bounds-checked."""
    iy = iy0 + ry * stride
    ctw = plan.cols * stride
    x0 = ox0 * stride
    if plan.tma_x:
        lcol, rcol = x0 - HALO, x0 + ctw
        if halo_hpad == "wrap":
            lcol += w if lcol < 0 else 0
            rcol -= w if rcol >= w else 0
        elif lcol < 0:
            lcol = w
        return torch.cat([_box(xz, bi, c0, iy, lcol, HALO),
                          _box(xz, bi, c0, iy, x0, ctw),
                          _box(xz, bi, c0, iy, rcol, HALO)], dim=2)
    ix = x0 - HALO + torch.arange(ctw + 2 * HALO)
    if hpad == "wrap":
        ix = ix % w
    return xz[bi, c0:c0 + BK, MARGIN + iy[:, None], MARGIN + ix[None, :]]


def _epilogue(out, acc, bias, wrows, coord, kcin, cin, kh, kw, stride, dil,
              lo, h, w, ho, wo, bi, da, db, m0, oy0, ox0, ry, rx, npar,
              tanh):
    cout = out.shape[1]
    oy, ox = oy0 + ry, ox0 + rx
    v = acc.reshape(acc.shape[0], len(ry), len(rx))
    if coord is not None:
        cv = coord.double()
        for i in range(kh):
            iy = oy * stride + i * dil - lo
            civ = torch.where((iy >= 0) & (iy < h), cv[iy.clamp(0, h - 1)],
                              torch.zeros((), dtype=torch.float64))
            for j in range(kw):
                ix = ox * stride + j * dil - lo
                okx = ((ix >= 0) & (ix < w)).double()
                wc = wrows[(i * kw + j) * kcin + cin, m0:m0 + v.shape[0]]
                v = v + wc[:, None, None] * civ[None, :, None] * \
                    okx[None, None, :]
    v = v + F.pad(bias.double(), (0, m0 + v.shape[0] - cout))[
        m0:m0 + v.shape[0], None, None]
    if tanh:
        v = torch.tanh(v)
    nm = min(v.shape[0], cout - m0)
    ny, nx = min(len(ry), ho - oy0), min(len(rx), wo - ox0)
    v = v[:nm, :ny, :nx]
    if npar == 4:
        out[bi, m0:m0 + nm, 2 * oy0 + da:2 * (oy0 + ny) + da:2,
            2 * ox0 + db:2 * (ox0 + nx) + db:2] = v
    else:
        out[bi, m0:m0 + nm, oy0:oy0 + ny, ox0:ox0 + nx] = v


def _case(case):
    """One EDGE_CASES layer in float64: (x, packed weight, bias, args)."""
    _, b, cin, h, w, cout, args = next(c for c in EDGE_CASES
                                       if c[0] == case)
    args = dict(args)
    rng = np.random.RandomState(sum(map(ord, case)))
    kcin = cin + bool(args.pop("coord", False))
    if kcin > cin:
        args["coord"] = conv_ops.coord_column(h).double()
    args.pop("out_dtype", None)
    taps = 16 if args.get("npar") == 4 else args["kh"] * args["kw"]
    wt = torch.from_numpy((rng.randn(cout, kcin, 4, 4) if taps == 16 else
                           rng.randn(cout, kcin, args["kh"], args["kw"]))
                          * (taps * kcin) ** -0.5)
    if taps != 16:
        pack = conv_ops.pack_conv
    elif args["kh"] == 3:
        pack = conv_ops.pack_smoothed
    else:
        pack = functools.partial(conv_ops.pack_deconv, smoothed=False)
    bias = torch.from_numpy(rng.randn(cout) * 0.1)
    x = torch.from_numpy(rng.uniform(-1, 1, (b, cin, h, w)))
    return x, pack(wt, torch.float64), bias, args


@pytest.mark.parametrize("case", [c[0] for c in EDGE_CASES])
def test_emulated_kernel_matches_plain_edge_cases(case):
    """The emulated kernel against conv_plain, float64, at each CUDA edge
    case: seams, ragged tiles and channels, the generic producer, the
    coord term, both parity forms, heads."""
    x, wk, bias, args = _case(case)
    got = _emulated(x, wk, bias, **args)
    want = conv_ops.conv_plain(x, wk, bias, **args)
    torch.testing.assert_close(got, want, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("variant,smoothed", [("wrap", False),
                                              ("coord", False),
                                              ("wrap", True)])
def test_emulated_kernel_matches_plain_net(variant, smoothed):
    """Every stage of a 64x128 ngf-8 net (both variants, and the smoothed
    wrap net's folded stages), batch 2: the emulated kernel against
    conv_plain in float64."""
    h, w, ngf = 64, 128, 8
    rng = np.random.RandomState(17)
    for (name, kind, _, cins, cout, ind, _, rate) in unet_plan(ngf, 24, 6):
        args = conv_args(kind, rate, variant, smoothed)
        cin = sum(cins)
        kcin = cin + has_coord(kind, variant)
        if has_coord(kind, variant):
            args["coord"] = conv_ops.coord_column(h // ind).double()
        args.pop("out_dtype", None)
        if kind == "deconv":
            wt = torch.from_numpy(rng.randn(cout, kcin, 4, 4) * 0.2)
            wk = (conv_ops.pack_smoothed(wt, torch.float64) if smoothed else
                  conv_ops.pack_deconv(wt, torch.float64, smoothed=False))
        else:
            wt = torch.from_numpy(
                rng.randn(cout, kcin, args["kh"], args["kw"]) * 0.2)
            wk = conv_ops.pack_conv(wt, torch.float64)
        bias = torch.from_numpy(rng.randn(cout) * 0.1)
        x = torch.from_numpy(rng.uniform(-1, 1, (2, cin, h // ind,
                                                 w // ind)))
        got = _emulated(x, wk, bias, **args)
        want = conv_ops.conv_plain(x, wk, bias, **args)
        torch.testing.assert_close(got, want, rtol=1e-12, atol=1e-12,
                                   msg=name)


def test_emulated_halos_carry_the_wrap():
    """In the wrap net's 3x3 conv every tap reads one TMA window, and its
    halo boxes carry the wrap: taken with zeros outside the image instead,
    the result differs from conv_plain at the first and last columns
    only."""
    x, wk, bias, args = _case("seam_w48")
    want = conv_ops.conv_plain(x, wk, bias, **args)
    full = _emulated(x, wk, bias, **args)
    assert torch.allclose(full, want, rtol=1e-12, atol=1e-12)
    part = _emulated(x, wk, bias, **args, halo_hpad="zero")
    diff = (part - want).abs().amax(dim=(0, 1, 2))
    assert diff[0] > 1e-3 and diff[-1] > 1e-3
    assert diff[1:-1].max() < 1e-12
