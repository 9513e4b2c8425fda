"""The bf16 conv kernel's plan and addressing, on the CPU.

`ops/conv.conv_plan` mirrors `csrc/conv.cu:make_plan` (the tile, its pixel
rows x columns, and which operands arrive by TMA); here it is held to what
every stage of the flagship nets, the smoothed folds, K7's trainer shapes,
the PP / RealEstate first layers and the CUDA edge cases need. Then the
kernel's algorithm is emulated in float64 (`_emulated`): per block, per
stage, the window and each tap's A fragment at its column shift within
it, the coord term the epilogue adds and the parity scatter, held to
`conv_plain` in float64 within 1e-12. The window, by x's layout: NCHW, a
main box and two halo boxes with their out-of-bounds zero fill, the halos
wrapped across the seam by their coordinates, or the gathered one;
channels-last, the shared memory as the kernel's boxes lay it (one box of
the tile's columns and two either side, 128-byte lines of 64 channels
with the 128-byte swizzle, the wrap seam's columns in seam boxes of their
own, or the gathered box), each lane's ldmatrix row address per tap and
k16 (`_cl_rows`), and the bank groups of each 8x8 matrix's rows. The card
runs the same plan (`tests/test_torch_kernels_cuda.py` compares
`matry_conv_plan` with it).
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
              halo_hpad=None, transform=None, layout="nchw"):
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
    norm's in-place pass, tests/test_torch_conv_ln.py). layout="cl": x is
    read as channels-last (`_cl_stage`: the window's columns start 2
    before the tile's, and each tap's fragment comes through the lanes'
    ldmatrix rows)."""
    b, cin, h, w = x.shape
    cout = wk.shape[2]
    cl = layout == "cl"
    lo = conv_ops.pad_pair(pad)[0] if npar == 1 else 1
    ho, wo = conv_ops.out_size(h, w, kh, kw, stride, dil, pad, npar)
    plan = conv_ops.conv_plan(w, cout, wo, stride, hpad, cin if cl else None)
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
                            if cl:
                                taps = _cl_stage(xz, bi, c0, iy0, ox0, ry,
                                                 plan, stride, dil, pw, kwp,
                                                 hpad, h, w, transform)
                            else:
                                win = _window(xz, bi, c0, iy0, ox0, ry, plan,
                                              stride, hpad, h, w,
                                              halo_hpad or hpad)
                                if transform is not None:
                                    win = transform(win, bi, c0, iy0, ox0)
                            for j in range(kwp):
                                arow = par * kh * kw * kcin + (
                                    i * kwp + j) * kcin + c0
                                a = wrows[arow:arow + BK, m0:m0 + plan.bm]
                                if cl:
                                    acc += a.T @ taps[j]
                                    continue
                                cols = rx * stride + j * dil - pw + HALO
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


HALO_CL = conv_ops.HALO_CL  # the channels-last window's columns either side
LINE = BK * 2                # bytes of a pixel's 64 channels, one line


def _region(nbytes):
    """A box's region in a stage, rounded up to 1024 bytes."""
    return -(-nbytes // 1024) * 1024


def _cl_line(r, wc, x0, plan, stride, w, seams):
    """csrc/conv.cu:cl_line: the byte offset from the window of the line of
    window pixel (r, wc) (wc from input column x0 - 2): the window box's
    line r * ncol + wc, or with seams (a TMA-loaded wrap window) a column
    outside [0, w) in the left or right seam box. r, wc: int tensors."""
    ncol = plan.cols * stride + 2 * HALO_CL
    main = plan.rows * ncol * LINE
    hb = _region(plan.rows * HALO_CL * LINE)
    col = x0 - HALO_CL + wc
    off = (r * ncol + wc) * LINE
    if seams:
        off = torch.where(col < 0, main + (r * HALO_CL + col + HALO_CL)
                          * LINE, off)
        off = torch.where(col >= w, main + hb + (r * HALO_CL + col - w)
                          * LINE, off)
    return off


def _cl_rows(plan, stride, dil, pw, kwp, x0, w, seams):
    """Each lane's ldmatrix.x4 row address (bytes from the window) per tap
    and k16, [kwp, 4 kk, 2 cw, 4 warps, 32 lanes], as the kernel computes
    it: lane l of warp `warp` in warpgroup cw gives the row of pixel m = 64
    cw + 16 warp + (l & 15) of the tile (output row m / cols, column m %
    cols), channels 16 kk + 8 (l >> 4) of the chunk; its line at the tap's
    shift (cl_line), the 16-byte chunk swizzled by the line's key, + 16 kk
    channels as XOR kk << 5. -> (addresses, pixel m, channel half t)."""
    lane = torch.arange(32)
    m = (64 * torch.arange(2)[:, None, None] + 16 * torch.arange(4)[
        None, :, None] + (lane & 15)[None, None, :])
    t = (lane >> 4).expand_as(m)
    pr, pc = m // plan.cols, m % plan.cols
    out = []
    for j in range(kwp):
        o = _cl_line(pr, pc * stride + j * dil - pw + HALO_CL, x0, plan,
                     stride, w, seams)
        row = o | ((((o >> 7) ^ t) & 7) << 4)
        out.append(torch.stack([row ^ (kk << 5) for kk in range(BK // 16)]))
    return torch.stack(out), m, t


def bank_conflict_degree(addrs):
    """The most rows of one 8x8 matrix (an 8-lane phase of an ldmatrix.x4)
    that share a 16-byte bank group (address bits 4-6): 1 where each phase
    reads a 128-byte wavefront."""
    phases = addrs.reshape(-1, 8)
    groups = (phases >> 4) & 7
    counts = torch.zeros(phases.shape[0], 8, dtype=torch.int64)
    counts.scatter_add_(1, groups, torch.ones_like(groups))
    return int(counts.max())


def _cl_smem(boxes, nbytes):
    """The window's shared memory as the channels-last TMA boxes (or the
    gathered window) lay it: each box [64, rows, ncol] at its byte offset,
    line q = r * ncol + c, 16-byte chunk k at (k ^ (q % 8)) * 16 within the
    line; slots of 2 bytes, NaN where nothing is written."""
    img = torch.full((nbytes // 2,), float("nan"), dtype=torch.float64)
    for off, box in boxes:
        rows, ncol = box.shape[1:]
        q = torch.arange(rows * ncol)[:, None, None]
        k = torch.arange(8)[None, :, None]
        j = torch.arange(8)[None, None, :]
        slot = (off + q * LINE + ((k ^ (q & 7)) << 4)) // 2 + j
        img[slot.reshape(-1)] = box.permute(1, 2, 0).reshape(-1)
    return img


@functools.lru_cache(maxsize=None)
def _cl_index(plan, stride, dil, pw, kwp, x0, w, seams):
    """The slots (2-byte units from the window) the taps of a tile at input
    column x0 read: the window as lines [rows, ncol, 64 channels] (each
    line at cl_line, its 16-byte chunks swizzled), and per tap the (row,
    window column) of each of the tile's 128 pixels. Checked once here: the
    lanes' ldmatrix rows (_cl_rows) name exactly the slots of channels 16
    kk + 8 t .. + 7 of their pixel's line at the tap's shift."""
    ncol = plan.cols * stride + 2 * HALO_CL
    r = torch.arange(plan.rows)[:, None].expand(-1, ncol)
    wc = torch.arange(ncol)[None, :].expand(plan.rows, -1)
    line = _cl_line(r, wc, x0, plan, stride, w, seams)[..., None, None]
    k = torch.arange(8)[:, None]
    raw = ((line + ((k ^ ((line >> 7) & 7)) << 4)) // 2
           + torch.arange(8)).reshape(plan.rows, ncol, BK)
    rows_, m, t = _cl_rows(plan, stride, dil, pw, kwp, x0, w, seams)
    pr, pc = m // plan.cols, m % plan.cols
    taps = []
    for j in range(kwp):
        cols = pc * stride + j * dil - pw + HALO_CL
        for kk in range(BK // 16):
            ch = 16 * kk + 8 * t[..., None] + torch.arange(8)
            got = rows_[j, kk][..., None] // 2 + torch.arange(8)
            want = raw[pr[..., None].expand_as(ch), cols[..., None].expand_as(
                ch), ch]
            assert torch.equal(got, want), (j, kk)
        first = t == 0  # each pixel's lane of channels 0-7
        order = torch.argsort(m[first])
        taps.append((pr[first][order], cols[first][order]))
    return raw, taps


def _cl_stage(xz, bi, c0, iy0, ox0, ry, plan, stride, dil, pw, kwp, hpad,
              h, w, transform):
    """One stage of a channels-last launch: [kwp][64 channels, rows * cols
    pixels], each tap's A as the lanes' ldmatrix rows read it (_cl_index).
    By TMA (plan.tma_x): the window's box (columns x0 - 2 .. x0 + cols *
    stride + 1, zero outside the input) and, in wrap mode, where the
    window crosses the seam, the seam box of the 2 wrapped columns (W - 2
    or 0); else the gathered box, each column wrapped or bounds-checked.
    Every slot a tap reads was written by a box; transform, if given,
    applies to the window as the taps read it (its columns from x0 - 2),
    as the producer normalizes it in place."""
    iy = iy0 + ry * stride
    ctw = plan.cols * stride
    x0 = ox0 * stride
    ncol = ctw + 2 * HALO_CL
    seams = plan.tma_x and hpad == "wrap"
    main = plan.rows * ncol * LINE
    hb = _region(plan.rows * HALO_CL * LINE)
    if plan.tma_x:
        boxes = [(0, _box(xz, bi, c0, iy, x0 - HALO_CL, ncol))]
        if seams and x0 - HALO_CL < 0:
            boxes.append((main, _box(xz, bi, c0, iy, w - HALO_CL, HALO_CL)))
        if seams and x0 + ctw + HALO_CL > w:
            boxes.append((main + hb, _box(xz, bi, c0, iy, 0, HALO_CL)))
    else:
        ix = x0 - HALO_CL + torch.arange(ncol)
        if hpad == "wrap":
            ix = ix % w
        boxes = [(0, xz[bi, c0:c0 + BK, MARGIN + iy[:, None],
                        MARGIN + ix[None, :]])]
    raw_idx, taps = _cl_index(plan, stride, dil, pw, kwp, x0, w, seams)
    win = _cl_smem(boxes, main + 2 * hb)[raw_idx].permute(2, 0, 1)
    assert not win.isnan().any(), "a tap reads a slot no box wrote"
    if transform is not None:
        win = transform(win, bi, c0, iy0, ox0)
    return [win[:, pr, cols] for pr, cols in taps]


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


@pytest.mark.parametrize("layout", ["nchw", "cl"])
@pytest.mark.parametrize("case", [c[0] for c in EDGE_CASES])
def test_emulated_kernel_matches_plain_edge_cases(case, layout):
    """The emulated kernel against conv_plain, float64, at each CUDA edge
    case, x NCHW and channels-last: seams, ragged tiles and channels, the
    generic producer, the coord term, both parity forms, heads."""
    x, wk, bias, args = _case(case)
    got = _emulated(x, wk, bias, **args, layout=layout)
    want = conv_ops.conv_plain(x, wk, bias, **args)
    torch.testing.assert_close(got, want, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("layout", ["nchw", "cl"])
@pytest.mark.parametrize("variant,smoothed", [("wrap", False),
                                              ("coord", False),
                                              ("wrap", True)])
def test_emulated_kernel_matches_plain_net(variant, smoothed, layout):
    """Every stage of a 64x128 ngf-8 net (both variants, and the smoothed
    wrap net's folded stages), batch 2, x NCHW and channels-last (the
    net's layout past its first conv): the emulated kernel against
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
        got = _emulated(x, wk, bias, **args, layout=layout)
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


def test_emulated_seam_boxes_carry_the_wrap():
    """Channels-last, the window's box holds the fill across the wrap
    seam, and the seam boxes the wrapped columns: a wrap net's 3x3 conv
    read from the window's box alone (zero mode's addressing) differs from
    conv_plain at the first and last columns only, and with the seam
    boxes matches it."""
    x, wk, bias, args = _case("seam_w48")
    want = conv_ops.conv_plain(x, wk, bias, **args)
    full = _emulated(x, wk, bias, **args, layout="cl")
    assert torch.allclose(full, want, rtol=1e-12, atol=1e-12)
    zero = conv_ops.conv_plain(x, wk, bias, **dict(args, hpad="zero",
                                                   pad=(1, 1)))
    diff = (zero - want).abs().amax(dim=(0, 1, 2))
    assert diff[0] > 1e-3 and diff[-1] > 1e-3
    assert diff[1:-1].max() < 1e-12


#: Flagship stages whose ldmatrix rows are checked for bank groups: (net,
#: stage name) over the wrap and coord nets' 17 channels-last inputs.
_CL_STAGES = [(v, p[0]) for v in ("wrap", "coord")
              for p in unet_plan(NGF, 192, 64) if p[2] != ["x"]]


@pytest.mark.parametrize("variant,stage", _CL_STAGES)
def test_ldmatrix_rows_bank_groups(variant, stage):
    """At each channels-last flagship stage (640x320, ngf 64), for the
    first, a middle and the last column tile, every tap and k16: the 8 row
    addresses of each 8x8 matrix fall in 8 distinct 16-byte bank groups
    at stride 1 (dilation 1 or 2, the parity forms); the stride-2 downs
    read every second line, a 2-way conflict; where a wrap tile's seam box
    serves a row, one row more may share a group."""
    name, kind, _, cins, cout, ind, _, rate = next(
        p for p in unet_plan(NGF, 192, 64) if p[0] == stage)
    args = conv_args(kind, rate, variant)
    h, w = H // ind, W // ind
    stride = args.get("stride", 1)
    plan, _, wo = _plan(1, sum(cins), h, w, cout, args)
    npar = args.get("npar", 1)
    lo = conv_ops.pad_pair(args.get("pad", 0))[0] if npar == 1 else 1
    seams = plan.tma_x and args.get("hpad", "wrap") == "wrap"
    degrees = {}
    for ox0 in (0, wo // 2 // plan.cols * plan.cols, wo - plan.cols):
        for db in range(2 if npar == 4 else 1):
            kwp = conv_ops.par_taps(args["kw"], npar, db)
            rows, _, _ = _cl_rows(plan, stride, args.get("dil", 1), lo - db,
                                  kwp, ox0 * stride, w, seams)
            edge = ox0 == 0 or ox0 + plan.cols >= wo
            degrees[edge] = max(degrees.get(edge, 1),
                                bank_conflict_degree(rows))
    print(f"{variant} {stage}: stride {stride}, dilation "
          f"{args.get('dil', 1)}: {degrees[False]}-way inside, "
          f"{degrees[True]}-way at the edge tiles")
    assert degrees[False] == stride
    assert degrees[True] == stride if not seams else \
        stride <= degrees[True] <= stride + 1
