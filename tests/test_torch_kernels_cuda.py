"""The port's CUDA kernels against their plain versions, on the card.

Every test here needs an NVIDIA GPU and nvcc; elsewhere each skips. The
file imports neither JAX nor the JAX package, so it also runs where only
PyTorch is installed:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_kernels_cuda.py

(tests/conftest.py imports JAX, hence --noconftest.) Shapes are small;
chip_smoke.py checks the same pairs at the flagship shapes.
"""

import copy
import dataclasses
import functools
import itertools
import math
import warnings

import numpy as np
import pytest
import torch

from matryodshka_tpu_torch import entry
from matryodshka_tpu_torch.evaluation import metrics as eval_metrics
from matryodshka_tpu_torch.geometry import render as render_lib
from matryodshka_tpu_torch.losses.elpips import api as elpips_api
from matryodshka_tpu_torch.models import msi as msi_lib
from matryodshka_tpu_torch.models.unet import MSIUNet
from matryodshka_tpu_torch.ops import conv as conv_ops
from matryodshka_tpu_torch.ops import mpi_render as mpi_ops
from matryodshka_tpu_torch.ops import net as net_ops
from matryodshka_tpu_torch.ops import render as render_ops
from matryodshka_tpu_torch.ops import render_layers as rl_ops
from matryodshka_tpu_torch.ops import sweep as sweep_ops

H, W, P, NGF = 32, 64, 4, 8
DTYPES = [torch.float32, torch.bfloat16]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _batch(dev, seed=0):
    cfg = entry.flagship_cfg(height=H, width=W, num_psv_planes=P,
                             num_msi_planes=P, ngf=NGF)
    return cfg, entry.synthetic_batch(cfg, seed, dev)


#: Sweep shapes (H, W, planes): the small slice's, and a narrow 2048-row
#: one whose width takes the kernel's column tiles (W > 1024: three tiles
#: of 512, the last one partial; windows wrap around the seam).
SWEEP_SHAPES = [(H, W, 4), (2048, 1280, 2)]


def _sweep_case(dev, h, w, p, seed=0):
    rng = np.random.RandomState(seed)
    ref, src = (torch.from_numpy(rng.rand(1, h, w, 3).astype(np.float32))
                .to(dev) for _ in range(2))
    depths = torch.tensor([100.0, 5.0, 1.5, 1.0][:p], device=dev)
    intr = torch.eye(3, device=dev)[None].clone()
    intr[0, 0, 0] = 0.032
    return ref, src, depths, intr


@pytest.mark.cuda
@pytest.mark.parametrize("shape", SWEEP_SHAPES)
def test_sweep_row_params_match_float64(cuda, shape):
    """The sweep kernel's projection (its row-parameter instrument)
    against row_params in float64: validity identical, positions within
    the f32 noise bound (grids.lookup_error)."""
    h, w, p = shape
    _, _, depths, intr = _sweep_case(cuda, h, w, p)
    n = sweep_ops.row_params_launches
    got = sweep_ops.sweep_row_params(depths, intr, h, w)
    assert sweep_ops.row_params_launches == n + 1
    ref = sweep_ops.dual_row_params(depths.double(), intr.double(), h, w)
    same, err = sweep_ops.row_params_error(got, ref, depths, h, w)
    assert same and err["u"] <= 1.0 and err["v"] <= 1.0, err


@pytest.mark.cuda
@pytest.mark.parametrize("shape", SWEEP_SHAPES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_sweep_kernel_matches_plain(cuda, dtype, shape):
    """The sweep kernel, one launch, against the plain version fed the
    kernel's own row parameters: identical taps and weights, each
    operation rounded once in both, so f32 to 1e-5 and bf16 to one
    rounding of values in [-1, 1] (2^-8)."""
    h, w, p = shape
    ref, src, depths, intr = _sweep_case(cuda, h, w, p)
    n = sweep_ops.launches
    got = sweep_ops.sweep_volume(ref, src, depths, intr, dtype).float()
    assert sweep_ops.launches == n + 1
    images, _ = sweep_ops.sweep_inputs(msi_lib.preprocess_image(ref),
                                       msi_lib.preprocess_image(src),
                                       depths[:1], intr)
    want = sweep_ops.ods_sweep_plain(
        images, sweep_ops.sweep_row_params(depths, intr, h, w),
        torch.float32)
    tol = 1e-5 if dtype == torch.float32 else 2.0 ** -8
    assert (got - want).abs().max().item() <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("shape", SWEEP_SHAPES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_op_library_sweep_equals_sweep_volume(cuda, dtype, shape):
    """The op library's matry::sweep_volume (csrc/sweep_op.cpp, linked
    with its own build of csrc/sweep.cu) is one launch of the same kernel
    on the same lookups: bit-equal to sweep_volume, counted by the
    library; a width it does not take raises."""
    h, w, p = shape
    ref, src, depths, intr = _sweep_case(cuda, h, w, p)
    n = sweep_ops.op_launches()
    got = sweep_ops.sweep_volume_op(ref, src, depths, intr, dtype)
    torch.cuda.synchronize()
    assert sweep_ops.op_launches() == n + 1
    assert torch.equal(got, sweep_ops.sweep_volume(ref, src, depths, intr,
                                                   dtype))
    with pytest.raises(ValueError, match="multiple of 8"):
        sweep_ops.sweep_volume_op(ref[:, :, :w - 4].contiguous(),
                                  src[:, :, :w - 4].contiguous(), depths,
                                  intr, dtype)


#: Single conv layers at the edges of the kernel's tiles: (id, B, Cin, H,
#: W, Cout, conv arguments; coord=True appends the coord channel). Heads of
#: 67, 99 and 32 channels (Cout not a multiple of 8: the weights gathered,
#: or of the 64-channel tile); pixel counts that fill no whole tile (Wo =
#: 200, 40: a ragged last column tile, whose wrapped window is gathered;
#: Wo = 48, 80: 16-column tiles whose halos cross the wrap seam by TMA);
#: W = 5 and 20 in both paddings, W = 12 with the coord channel (x's rows
#: not a multiple of 16 bytes: the patch gathered), so the wrap crosses
#: every tile at W = 5; Cin' = Cin + 1 (coord) and Cin = 96 (a k-step past
#: Cin in every tap); Cin = 195, the RealEstate net's first layer (a ragged
#: channel chunk, with and without the coord channel: Cin' = 196); stride
#: 2 (gathered at W 24, by TMA at W 64), dilation 2 (W 20 gathered, W 32 by
#: TMA with shifts of two columns), the npar=4 parity deconv in both
#: paddings, transposed (2x2 taps) and smoothed (the folded 3x3 / 3x2 /
#: 2x3 / 2x2 taps), at W 20 (gathered), 32 (by TMA) and 24 (zero mode by
#: TMA, a ragged tile); B = 2; the conv4 shape (512 -> 512 at 40x80) and a
#: shape that takes the 64x128 tile.
EDGE_CASES = [
    ("head67", 1, 64, 8, 80, 67,
     dict(kh=1, kw=1, tanh=True, out_dtype=torch.float32)),
    ("head99", 1, 64, 8, 80, 99,
     dict(kh=1, kw=1, tanh=True, out_dtype=torch.float32)),
    ("head32_zero", 2, 64, 8, 80, 32,
     dict(kh=1, kw=1, tanh=True, out_dtype=torch.float32, hpad="zero")),
    ("wo80", 1, 64, 6, 80, 64, dict(kh=3, kw=3, pad=1)),
    ("w5_wrap", 2, 32, 40, 5, 64, dict(kh=3, kw=3, pad=1)),
    ("coord", 2, 64, 12, 24, 64,
     dict(kh=3, kw=3, pad=(1, 1), hpad="zero", coord=True)),
    ("coord_down", 1, 32, 12, 24, 64,
     dict(kh=3, kw=3, stride=2, pad=(0, 1), hpad="zero", coord=True)),
    ("down", 2, 64, 12, 24, 128, dict(kh=3, kw=3, stride=2, pad=1)),
    ("dil2", 1, 96, 10, 20, 64, dict(kh=3, kw=3, dil=2, pad=2)),
    ("deconv", 2, 96, 10, 20, 64, dict(kh=2, kw=2, npar=4)),
    ("deconv_zero", 1, 64, 10, 20, 32, dict(kh=2, kw=2, npar=4, hpad="zero")),
    ("smoothed", 2, 96, 10, 20, 64, dict(kh=3, kw=3, npar=4)),
    ("smoothed_zero", 1, 64, 10, 20, 32,
     dict(kh=3, kw=3, npar=4, hpad="zero")),
    ("conv4", 1, 512, 40, 80, 512, dict(kh=3, kw=3, dil=2, pad=2)),
    ("tile128", 2, 32, 96, 200, 64, dict(kh=3, kw=3, pad=1)),
    ("cin195_wrap", 1, 195, 12, 24, 64, dict(kh=3, kw=3, pad=1)),
    ("cin195_coord", 2, 195, 12, 24, 64,
     dict(kh=3, kw=3, pad=(1, 1), hpad="zero", coord=True)),
    ("seam_w40", 1, 64, 12, 40, 64, dict(kh=3, kw=3, pad=1)),
    ("seam_w48", 1, 64, 12, 48, 64, dict(kh=3, kw=3, pad=1)),
    ("w5_zero", 2, 32, 40, 5, 64, dict(kh=3, kw=3, pad=(1, 1), hpad="zero")),
    ("w12_coord", 1, 64, 10, 12, 64,
     dict(kh=3, kw=3, pad=(1, 1), hpad="zero", coord=True)),
    ("dil2_w32", 1, 96, 10, 32, 64, dict(kh=3, kw=3, dil=2, pad=2)),
    ("down_w64", 1, 64, 16, 64, 128, dict(kh=3, kw=3, stride=2, pad=1)),
    ("deconv_w32", 2, 96, 10, 32, 64, dict(kh=2, kw=2, npar=4)),
    ("smoothed_w32", 1, 64, 10, 32, 128, dict(kh=3, kw=3, npar=4)),
    ("smoothed_w24_zero", 1, 64, 10, 24, 32,
     dict(kh=3, kw=3, npar=4, hpad="zero")),
]
#: The wgmma tile each of these must take (ops/conv.conv_plan: Cout x
#: pixels, rows x columns of output pixels, the operands' producer).
_T = "patch TMA, weights TMA"
_G = "patch gathered, weights TMA"
EDGE_TILES = {"conv4": f"wgmma 128x128 (8x16 px, {_T})",
              "tile128": f"wgmma 64x128 (8x16 px, {_G})",
              "seam_w40": f"wgmma 64x128 (8x16 px, {_G})",
              "seam_w48": f"wgmma 64x128 (8x16 px, {_T})",
              "head67": "wgmma 128x128 (8x16 px, patch TMA, weights "
                        "gathered)",
              "w5_zero": f"wgmma 64x128 (8x16 px, {_G})",
              "down_w64": f"wgmma 128x128 (4x32 px, {_T})",
              "deconv_w32": f"wgmma 64x128 (4x32 px, {_T})"}


def _conv_plan_case(dev, dtype):
    rng = np.random.RandomState(6)
    net = MSIUNet(2 * P * 3, 2 * P, NGF).to(dev)
    with torch.no_grad():
        for prm in net.parameters():
            prm.copy_(torch.from_numpy(
                rng.randn(*prm.shape).astype(np.float32) * 0.2))
    for plan, st in zip(net.plan, net_ops.prepare(net, dtype)):
        _, _, _, cins, _, ind, _, _ = plan
        x = torch.from_numpy(rng.uniform(
            -1, 1, (2, sum(cins), H // ind, W // ind)).astype(
                np.float32)).to(dev, dtype)
        yield plan[0], x, st["w"], st["b"], st["args"]


def _conv_edge_case(dev, dtype, case):
    _, b, cin, h, w, cout, args = next(c for c in EDGE_CASES
                                       if c[0] == case)
    args = dict(args)
    rng = np.random.RandomState(sum(map(ord, case)))
    kcin = cin + bool(args.pop("coord", False))
    if kcin > cin:
        args["coord"] = conv_ops.coord_column(h, dev)
    taps = (16 if args.get("npar") == 4 else args["kh"] * args["kw"])
    wt = torch.from_numpy((rng.randn(cout, kcin, 4, 4) if taps == 16 else
                           rng.randn(cout, kcin, args["kh"], args["kw"]))
                          .astype(np.float32) * (taps * kcin) ** -0.5)
    if taps != 16:
        pack = conv_ops.pack_conv
    elif args["kh"] == 3:
        pack = conv_ops.pack_smoothed
    else:
        pack = functools.partial(conv_ops.pack_deconv, smoothed=False)
    bias = torch.from_numpy(rng.randn(cout).astype(np.float32) * 0.1)
    x = torch.from_numpy(rng.uniform(-1, 1, (b, cin, h, w)).astype(
        np.float32)).to(dev, dtype)
    yield case, x, pack(wt, dtype).to(dev), bias.to(dev), args


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["plan"] + [c[0] for c in EDGE_CASES])
@pytest.mark.parametrize("dtype", DTYPES)
def test_conv_kernel_matches_plain(cuda, dtype, case):
    """Every stage of the plan ("plan"), then single layers at the tile
    edges (EDGE_CASES), on the same (rounded) operands. f32 runs the exact
    f32 FMA kernel: it differs from the plain version in accumulation order
    only (1e-4 of the output scale over the plan, 1e-5 on the single
    layers, whose K is at most 4,608); in bf16 (the wgmma kernel) both sides
    round once and may land one bf16 step apart (2^-7 of the scale), and
    a second launch gives the same bits."""
    layers = (_conv_plan_case(cuda, dtype) if case == "plan"
              else _conv_edge_case(cuda, dtype, case))
    for name, x, wk, bias, args in layers:
        got = conv_ops.conv(x, wk, bias, **args).float()
        want = conv_ops.conv_plain(x, wk, bias, **args).float()
        assert torch.isfinite(got).all(), name
        rel = 1e-4 if case == "plan" else 1e-5
        tol = (rel if dtype == torch.float32 else 2.0 ** -7) * \
            want.abs().max().item()
        assert (got - want).abs().max().item() <= tol, name
        if dtype == torch.bfloat16:
            # no atomics: a second launch gives the same bits
            again = conv_ops.conv(x, wk, bias, **args).float()
            assert torch.equal(got, again), name
        if case in EDGE_TILES and dtype == torch.bfloat16:
            assert conv_ops.tile_config(x, wk.shape[2], **args) == \
                EDGE_TILES[case]


@pytest.mark.cuda
def test_conv_plan_matches_c(cuda):
    """matry_conv_plan (csrc/conv.cu) equals ops/conv.conv_plan at every
    stage of both 640x320 ngf-64 nets (and the smoothed folds), at K7's
    trainer shapes at batch 1 and 2 (forward and dgrad) and at the edge
    cases, for NCHW and channels-last x."""
    from matryodshka_tpu_torch.ops import _build
    from matryodshka_tpu_torch.ops.net import conv_args, unet_plan
    shapes = []
    for variant in ("wrap", "coord"):
        for smoothed in (False, True):
            for (_, kind, _, cins, cout, ind, _, rate) in unet_plan(
                    64, 192, 64):
                shapes.append(((1, sum(cins), 320 // ind, 640 // ind), cout,
                               conv_args(kind, rate, variant, smoothed)))
    for (_, kind, _, cins, cout, ind, _, rate) in unet_plan(64, 192, 64):
        if kind == "conv" and rate == 1:
            for b in (1, 2):
                for ci, co in ((sum(cins), cout), (cout, sum(cins))):
                    shapes.append(((b, ci, 320 // ind, 640 // ind), co,
                                   dict(kh=3, kw=3, pad=1)))
    for (_, b, cin, h, w, cout, args) in EDGE_CASES:
        shapes.append(((b, cin, h, w), cout, args))
    lib = _build.lib()
    for (b, cin, h, w), cout, args in shapes:
        stride = args.get("stride", 1)
        hpad = args.get("hpad", "wrap")
        _, wo = conv_ops.grid_of((b, cin, h, w), args["kh"], args["kw"],
                                 stride, args.get("dil", 1),
                                 args.get("pad", 0), args.get("npar", 1))
        for cl in (False, True):
            want = conv_ops.conv_plan(w, cout, wo, stride, hpad,
                                      cin if cl else None)
            got = lib.matry_conv_plan(cin, w, cout, wo, stride,
                                      int(hpad == "zero"), int(cl))
            assert got == want.code(), ((b, cin, h, w), cout, args, cl, got,
                                        want)


def _fused_stage(plan, stages, name, dev, dtype, seed=0):
    """A consumer stage of a net with its layer-normed inputs: each source
    produced by its own stage's kernel on a uniform [-1, 1] input (with
    its partials), gamma 1 + 0.1 N(0, 1) and beta 0.1 N(0, 1) per source.
    -> (x, norm, stage operands): the raw sources' concat and one Norm
    each."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    by = {p[0]: (p, st) for p, st in zip(plan, stages)}
    (_, _, srcs, _, _, _, _, _), st = by[name]
    ys, norm = [], []
    for s in srcs:
        (_, _, _, cins, cout, ind, _, _), pst = by[s]
        shape = (1, sum(cins), 320 // ind, 640 // ind)
        xs = (torch.rand(shape, generator=gen, device=dev) * 2 - 1).to(dtype)
        y, part = conv_ops.conv(xs, pst["w"].to(dtype), pst["b"],
                                **pst["args"], stats=True)
        g = 1 + 0.1 * torch.randn(cout, generator=gen, device=dev)
        bt = 0.1 * torch.randn(cout, generator=gen, device=dev)
        ys.append(y)
        norm.append(conv_ops.Norm(part, g, bt))
    x = ys[0] if len(ys) == 1 else torch.cat(ys, dim=1)
    return x, norm, st


#: The 17 stages of the flagship net that read layer-normed inputs.
LN_STAGES = ["conv1_2", "conv2_1", "conv2_2", "conv3_1", "conv3_2",
             "conv3_3", "conv4_1", "conv4_2", "conv4_3", "conv6_1",
             "conv6_2", "conv6_3", "conv7_1", "conv7_2", "conv8_1",
             "conv8_2", "color_pred"]


@functools.lru_cache(maxsize=None)
def _flagship_params(net):
    cfg = entry.flagship_cfg(coord_net=net.startswith("coord"),
                             smoothed=net.endswith("smoothed"))
    return entry.make_params(cfg, seed=0, device=torch.device("cuda"))


@pytest.mark.cuda
@pytest.mark.parametrize("stage", LN_STAGES)
@pytest.mark.parametrize("net", ["wrap", "coord", "wrap_smoothed"])
@pytest.mark.parametrize("dtype", DTYPES)
def test_fused_layer_norm_conv_matches_plain(cuda, dtype, net, stage):
    """The conv kernel with its sources' layer norm + ReLU fused (the
    producers' partials folded in the launch, relu(a * y + b) on the
    staged input) against conv_plain of layer_norm_relu_plain of each
    source, at the flagship's 17 layer-normed inputs (640x320, ngf 64) of
    the wrap, coord and smoothed nets: float32 within 1e-5 of the output's
    scale, bf16 within one bf16 step (2^-7 of it: each side rounds the
    normalized input and the output once, the sums in other orders); two
    launches bit-identical, each counted once as a normed launch."""
    params = _flagship_params(net)
    x, norm, st = _fused_stage(params.net.plan, params.stages, stage, cuda,
                               dtype)
    wk = st["w"].to(dtype)
    n0 = conv_ops.norm_launches
    got = conv_ops.conv(x, wk, st["b"], **st["args"], norm=norm)
    again = conv_ops.conv(x, wk, st["b"], **st["args"], norm=norm)
    torch.cuda.synchronize()
    assert conv_ops.norm_launches == n0 + 2
    assert torch.equal(got, again)
    xn = conv_ops.normalize_plain(x, norm)
    want = conv_ops.conv_plain(xn, wk, st["b"], **st["args"]).float()
    tol = (1e-5 if dtype == torch.float32 else 2.0 ** -7) * \
        want.abs().max().item()
    assert (got.float() - want).abs().max().item() <= tol


#: Small consumers of every mode and form (name, batch, source channels,
#: H, W, Cout, args): ragged channel chunks (40, 72), a gathered window
#: (W 20, wrap), a main box past W (W 40, zero), a skip concat, the
#: parity forms, the head.
FUSED_CASES = [
    ("wrap_conv", 1, [72], 10, 32, 16, dict(kh=3, kw=3, pad=1)),
    ("wrap_down", 2, [72], 12, 64, 136, dict(kh=3, kw=3, stride=2, pad=1)),
    ("wrap_dil2", 1, [40], 10, 32, 16, dict(kh=3, kw=3, dil=2, pad=2)),
    ("wrap_concat_deconv", 2, [24, 40], 8, 32, 16,
     dict(kh=2, kw=2, npar=4)),
    ("wrap_smoothed", 1, [40], 8, 32, 16, dict(kh=3, kw=3, npar=4)),
    ("wrap_gathered", 1, [24], 6, 20, 16, dict(kh=3, kw=3, pad=1)),
    ("wrap_head", 1, [16], 8, 32, 5,
     dict(kh=1, kw=1, tanh=True, out_dtype=torch.float32)),
    ("zero_down", 1, [72], 12, 64, 24,
     dict(kh=3, kw=3, stride=2, pad=(0, 1), hpad="zero")),
    ("zero_ragged", 2, [24], 6, 40, 16,
     dict(kh=3, kw=3, pad=(1, 1), hpad="zero")),
    ("zero_concat_smoothed", 1, [24, 40], 8, 32, 16,
     dict(kh=3, kw=3, npar=4, hpad="zero")),
    ("coord_concat", 2, [24, 40], 8, 32, 16,
     dict(kh=3, kw=3, pad=(1, 1), hpad="zero", coord=True)),
    ("coord_dil2_ragged", 1, [72], 10, 40, 16,
     dict(kh=3, kw=3, dil=2, pad=(2, 2), hpad="zero", coord=True)),
]


@pytest.mark.cuda
@pytest.mark.parametrize("case", [c[0] for c in FUSED_CASES])
@pytest.mark.parametrize("dtype", DTYPES)
def test_fused_layer_norm_small_cases(cuda, dtype, case):
    """Each source's producer a stride-1 3x3 conv of the consumer's mode
    with stats (its partials), beta near 5 so that a normalized pad
    element would show; the fused consumer against conv_plain of
    layer_norm_relu_plain of each source, with the tolerances of
    test_fused_layer_norm_conv_matches_plain; two launches bit-identical;
    the producer's partials folded equal the plain sums within float32's
    noise."""
    _, b, cins, h, w, cout, args = next(c for c in FUSED_CASES
                                        if c[0] == case)
    args = dict(args)
    rng = np.random.RandomState(sum(map(ord, case)))
    hpad = args.get("hpad", "wrap")
    if args.pop("coord", False):
        args["coord"] = conv_ops.coord_column(h, cuda)
    kcin = sum(cins) + ("coord" in args)

    def tensor(a):
        return torch.from_numpy(np.asarray(a, np.float32)).to(cuda)

    ys, norm = [], []
    for c in cins:
        xs = tensor(rng.uniform(-1, 1, (b, 8, h, w))).to(dtype)
        wp = conv_ops.pack_conv(tensor(rng.randn(c, 8, 3, 3) * 0.3), dtype)
        y, part = conv_ops.conv(xs, wp, tensor(rng.randn(c) + 1), 3, 3,
                                pad=1 if hpad == "wrap" else (1, 1),
                                hpad=hpad, stats=True)
        yf = y.float()
        sums = part.double().sum(1)
        want_sums = torch.stack([yf.double().sum((1, 2, 3)),
                                 yf.double().square().sum((1, 2, 3))], 1)
        assert torch.allclose(sums, want_sums, rtol=1e-5)
        ys.append(y)
        norm.append(conv_ops.Norm(part, tensor(1 + 0.2 * rng.randn(c)),
                                  tensor(5 + 0.5 * rng.randn(c))))
    x = ys[0] if len(ys) == 1 else torch.cat(ys, dim=1)
    if args.get("npar") == 4:
        wt = tensor(rng.randn(cout, kcin, 4, 4) * 0.1)
        wk = (conv_ops.pack_smoothed(wt, dtype) if args["kh"] == 3 else
              conv_ops.pack_deconv(wt, dtype, smoothed=False))
    else:
        wk = conv_ops.pack_conv(tensor(rng.randn(
            cout, kcin, args["kh"], args["kw"]) * 0.1), dtype)
    bias = tensor(rng.randn(cout) * 0.1)
    got = conv_ops.conv(x, wk, bias, **args, norm=norm)
    again = conv_ops.conv(x, wk, bias, **args, norm=norm)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    want = conv_ops.conv_plain(conv_ops.normalize_plain(x, norm), wk, bias,
                               **args).float()
    tol = (1e-5 if dtype == torch.float32 else 2.0 ** -7) * \
        want.abs().max().item()
    assert (got.float() - want).abs().max().item() <= tol


@pytest.mark.cuda
def test_conv_smem_matches_c(cuda):
    """ops/conv.conv_smem against csrc/conv.cu:smem_of (matry_conv_smem)
    at every stage of the flagship nets, with and without the layer
    norm's vectors, for NCHW and channels-last x and output, and
    ops/conv.stats_blocks
    against stat_blocks (matry_conv_stats_blocks) in bf16 and f32."""
    from matryodshka_tpu_torch.ops import _build
    lib = _build.lib()
    for net in ("wrap", "coord", "wrap_smoothed"):
        params = _flagship_params(net)
        for (name, _, _, cins, cout, ind, _, _), st in zip(
                params.net.plan, params.stages):
            a = st["args"]
            w = 640 // ind
            _, wo = conv_ops.grid_of((1, sum(cins), 320 // ind, w), a["kh"],
                                     a["kw"], a.get("stride", 1),
                                     a.get("dil", 1), a.get("pad", 0),
                                     a.get("npar", 1))
            for norm, cl, cl_out in itertools.product((False, True),
                                                      repeat=3):
                want = conv_ops.conv_smem(
                    sum(cins), w, cout, wo, a["kw"], a.get("stride", 1),
                    a.get("hpad", "wrap"), norm, cl, cl_out)[2]
                got = lib.matry_conv_smem(
                    sum(cins), w, cout, wo, a["kw"], a.get("stride", 1),
                    int(a.get("hpad") == "zero"), int(norm), int(cl),
                    int(cl_out))
                assert got == want, (net, name, norm, cl, cl_out)
            shape = (1, sum(cins), 320 // ind, w)
            ho, _ = conv_ops.grid_of(shape, a["kh"], a["kw"],
                                     a.get("stride", 1), a.get("dil", 1),
                                     a.get("pad", 0), a.get("npar", 1))
            for dtype in DTYPES:
                want = conv_ops.stats_blocks(
                    shape, cout, a["kh"], a["kw"], a.get("stride", 1),
                    a.get("dil", 1), a.get("pad", 0), a.get("npar", 1),
                    a.get("hpad", "wrap"), dtype)
                got = lib.matry_conv_stats_blocks(
                    w, cout, ho, wo, a.get("stride", 1), a.get("npar", 1),
                    int(a.get("hpad") == "zero"),
                    int(dtype == torch.float32))
                assert got == want, (net, name, dtype)


def _cl(x):
    return x.contiguous(memory_format=torch.channels_last)


def _both_layouts(x, wk, bias, args, norm, cl_out):
    """One layer launched twice, on x NCHW with an NCHW output (the form
    the K7 and f32 callers run) and on x channels-last with the output
    channels-last (cl_out) or NCHW (the second counted as a channels-last
    launch), each with its partials: -> ((out, partials) NCHW, (out,
    partials) channels-last)."""
    fmt = torch.channels_last if cl_out else torch.contiguous_format
    nchw = conv_ops.conv(x.contiguous(), wk, bias, **args, norm=norm,
                         stats=True)
    n = conv_ops.cl_launches
    cl = conv_ops.conv(_cl(x), wk, bias, **args, norm=norm, stats=True,
                       memory_format=fmt)
    torch.cuda.synchronize()
    assert conv_ops.cl_launches == n + 1
    assert cl[0].is_contiguous(memory_format=fmt)
    return nchw, cl


@pytest.mark.cuda
@pytest.mark.parametrize("stage", LN_STAGES)
@pytest.mark.parametrize("net", ["wrap", "coord", "wrap_smoothed"])
def test_channels_last_launch_is_bit_identical(cuda, net, stage):
    """At each of the flagship's 17 layer-normed stages of the wrap, coord
    and smoothed nets (bf16), the launch that reads x channels-last (its
    A fragments by ldmatrix) gives the NCHW launch's output and STATS
    partials bit for bit, in the output layout the net asks for."""
    params = _flagship_params(net)
    x, norm, st = _fused_stage(params.net.plan, params.stages, stage, cuda,
                               torch.bfloat16)
    (y0, p0), (y1, p1) = _both_layouts(
        x, st["w"], st["b"], st["args"], norm,
        st["memory_format"] == torch.channels_last)
    assert torch.equal(y0, y1) and torch.equal(p0, p1)


def _edge_norm(x, gen):
    """A one-source layer norm of x as a consumer takes it: one partial a
    sample (x's own sums), gamma 1 + 0.1 N(0, 1), beta 0.1 N(0, 1)."""
    xf = x.float()
    part = torch.stack([xf.sum(dim=(1, 2, 3)), xf.square().sum(
        dim=(1, 2, 3))], dim=-1)[:, None].contiguous()
    c = x.shape[1]
    return [conv_ops.Norm(part, 1 + 0.1 * torch.randn(
        c, generator=gen, device=x.device), 0.1 * torch.randn(
            c, generator=gen, device=x.device))]


@pytest.mark.cuda
@pytest.mark.parametrize("case", [c[0] for c in EDGE_CASES])
def test_channels_last_edge_cases_are_bit_identical(cuda, case):
    """Each CUDA edge case with a layer-normed input (bf16), channels-last
    x against NCHW x: the same output and partials bit for bit, out
    channels-last and NCHW. The cases take the channels-last window's
    every path: its seam boxes (the wrap net's tiles at either end), its
    fill (zero mode, rows outside, Cin 96 and 195's ragged chunks), the
    gathered window (Cin 195: a pixel's line not a multiple of 16 bytes;
    W 5 and a ragged wrap tile), stride 2, dilation 2, the parity forms,
    the coord term and the heads. A channels-last output the kernel has
    no form for (the f32 heads) raises."""
    gen = torch.Generator(device=cuda).manual_seed(11)
    for name, x, wk, bias, args in _conv_edge_case(cuda, torch.bfloat16,
                                                   case):
        norm = _edge_norm(x, gen)
        for cl_out in (False, True):
            if cl_out and (args.get("out_dtype") == torch.float32
                           or wk.shape[2] % 8):
                with pytest.raises(ValueError, match="channels-last output"):
                    conv_ops.conv(_cl(x), wk, bias, **args, norm=norm,
                                  memory_format=torch.channels_last)
                continue
            (y0, p0), (y1, p1) = _both_layouts(x, wk, bias, args, norm,
                                               cl_out)
            assert torch.equal(y0, y1) and torch.equal(p0, p1), (name,
                                                                cl_out)
            want = conv_ops.conv_plain(conv_ops.normalize_plain(x, norm),
                                       wk, bias, **args).float()
            tol = 2.0 ** -7 * want.abs().max().item()
            assert (y1.float() - want).abs().max().item() <= tol, name


@pytest.mark.cuda
@pytest.mark.parametrize("net", ["wrap", "coord", "wrap_smoothed"])
def test_unet_forward_channels_last_matches_nchw(cuda, net):
    """The flagship net stage (640x320, ngf 64, bf16, batch 2): its
    activations channels-last from conv1_1 to the head (17 of its 18
    launches read a channels-last window) give the same prediction bit
    for bit as the same stages run on NCHW activations, a contiguous
    [B, K, H, W] float32 tensor."""
    params = _flagship_params(net)
    cfg = entry.flagship_cfg(coord_net=net.startswith("coord"))
    gen = torch.Generator(device=cuda).manual_seed(3)
    x = (torch.rand((2, cfg.num_net_inputs(), 320, 640), generator=gen,
                    device=cuda) * 2 - 1).to(torch.bfloat16)
    nchw = [dict(st, memory_format=torch.contiguous_format)
            for st in params.stages]
    n = conv_ops.cl_launches
    got = net_ops.unet_forward(params.stages, x)
    torch.cuda.synchronize()
    assert conv_ops.cl_launches - n == 17
    want = net_ops.unet_forward(nchw, x)
    torch.cuda.synchronize()
    assert conv_ops.cl_launches - n == 17
    assert got.dtype == torch.float32 and got.is_contiguous()
    assert torch.equal(got, want)


@pytest.mark.cuda
def test_net_stage_runs_convs_and_concats_only(cuda):
    """A profiler trace of the flagship net stage (bf16, batch 4): its
    device operations are the 18 conv launches and the 3 skip concats,
    with no layout copy."""
    from torch.profiler import ProfilerActivity, profile

    from matryodshka_tpu_torch.trace import device_events
    params = _flagship_params("coord")
    cfg = entry.flagship_cfg(coord_net=True)
    x = torch.rand((4, cfg.num_net_inputs(), 320, 640), device=cuda).to(
        torch.bfloat16)
    msi_lib.net_stage(params.stages, x)
    torch.cuda.synchronize()
    for _ in range(3):  # the profiler now and then drops a device event
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            msi_lib.net_stage(params.stages, x)
            torch.cuda.synchronize()
        names = [e[0] for e in device_events(prof)]
        conv = [n for n in names if "conv_wgmma_kernel" in n]
        if len(conv) == 18:
            break
    assert len(conv) == 18, names
    assert len(names) == 21, [n for n in names if n not in conv]


@pytest.mark.cuda
def test_train_step_reads_no_channels_last_window(cuda):
    """The trainer's K7 route (NCHW activations, ops/wrap_conv.py) reads
    no channels-last window: cl_launches stays put over a train step that
    launches every K7 kernel."""
    from matryodshka_tpu_torch.ops import wrap_conv as wc
    from matryodshka_tpu_torch.training import state as state_lib
    from matryodshka_tpu_torch.training import step as step_lib
    cfg = entry.flagship_cfg(height=H, width=W, num_psv_planes=P,
                             num_msi_planes=P)
    b = entry.synthetic_batch(cfg, 4, cuda, tgt_pos=(0.03, 0.01, -0.02))
    state = state_lib.init_state(cfg, 5, cuda)
    n = conv_ops.cl_launches
    k7 = (wc.k7a_launches, wc.k7b_launches, wc.k7c_launches)
    loss, _ = step_lib.make_loss_fn(cfg, state.net, None)(b)
    loss.backward()
    torch.cuda.synchronize()
    assert all(a > c for a, c in zip(
        (wc.k7a_launches, wc.k7b_launches, wc.k7c_launches), k7))
    assert conv_ops.cl_launches == n


def _target(dev, rot_deg):
    """(pose [1, 4, 4], position [1, 3], radii [P]) of a target rotated
    about y and translated."""
    a = math.radians(rot_deg)
    rt = torch.eye(4, device=dev)[None]
    rt[0, 0, 0], rt[0, 0, 2] = math.cos(a), math.sin(a)
    rt[0, 2, 0], rt[0, 2, 2] = -math.sin(a), math.cos(a)
    return (rt, torch.tensor([[0.05, 0.0, 0.01]], device=dev),
            torch.tensor([100.0, 5.0, 1.5, 1.0], device=dev))


@pytest.mark.cuda
@pytest.mark.parametrize("rot_deg", [0.0, 40.0])
def test_uv_project_matches_float64(cuda, rot_deg):
    """The render kernel's projection (its uv instrument) against
    intersect_sphere_uv in float64, wrap-aware, within the f32 noise
    bound (grids.lookup_error)."""
    from matryodshka_tpu_torch.geometry import grids
    pose, pos, radii = _target(cuda, rot_deg)
    n = render_ops.uv_launches
    u, v = render_ops.uv_project(pose, pos, radii, H, W)
    assert render_ops.uv_launches == n + 1
    u6, v6 = render_lib.uv_tables(pose.double(), pos.double(),
                                  radii.double(), H, W)
    err = grids.lookup_error(u, v, u6, v6,
                             radii.double()[None, :, None, None], H, W)
    assert err["u"] <= 1.0 and err["v"] <= 1.0, err


@pytest.mark.cuda
@pytest.mark.parametrize("depth", [False, True])
@pytest.mark.parametrize("rot_deg", [0.0, 40.0])
@pytest.mark.parametrize("dtype", DTYPES)
def test_render_kernel_matches_plain(cuda, rot_deg, dtype, depth):
    """The render kernel, one launch, against the plain version fed the
    kernel's own lookups (uv_project): the same taps, the composite's f32
    math in another order, plus early termination at T < 1e-6: 1e-5 on
    values in [-1, 1] (colour) and [0, 1) (depth)."""
    rng = np.random.RandomState(8)
    vol = torch.from_numpy(rng.uniform(-1, 1, (1, 6 * P, H, W)).astype(
        np.float32)).to(cuda, dtype)
    pred = torch.from_numpy(np.tanh(rng.randn(1, 2 * P, H, W) * 1.5).astype(
        np.float32)).to(cuda)
    target = _target(cuda, rot_deg)
    n = render_ops.depth_launches if depth else render_ops.launches
    got = render_ops.render_blend(vol, pred, *target, depth=depth)
    assert (render_ops.depth_launches if depth else render_ops.launches) \
        == n + 1
    u, v = render_ops.uv_project(*target, H, W)
    want = render_ops.render_blend_plain(vol, pred, u, v, depth=depth)
    assert (got - want).abs().max().item() <= 1e-5


def _stack(dev, dtype, b, p, h, w, seed=9):
    """An interleaved layer stack [B, P, H, W, 4]: colours uniform in
    [-1, 1], alphas in (0, 1)."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    layers = torch.rand((b, p, h, w, 4), generator=gen, device=dev) * 2 - 1
    layers[..., 3] = torch.sigmoid(3.0 * layers[..., 3])
    return layers.to(dtype)


def _layer_stack_modes(layers, target, ftb):
    """{mode: (kernel outputs, launches counted)} of the colour, depth and
    both modes, each one launch."""
    out = {}
    for mode in ("rgb", "depth", "both"):
        before = (rl_ops.launches, rl_ops.ftb_launches, rl_ops.both_launches)
        if mode == "both":
            got = rl_ops.render_layers_both(layers, *target, ftb=ftb)
        else:
            got = (rl_ops.render_layers(layers, *target, ftb=ftb,
                                        depth=mode == "depth"),)
        after = (rl_ops.launches, rl_ops.ftb_launches, rl_ops.both_launches)
        out[mode] = (got, tuple(a - n for a, n in zip(after, before)))
    return out


def _check_layer_stack_modes(layers, target, ftb, h, w):
    """Every mode, one launch each, against render_layers_plain fed the
    kernel's own lookups (uv_project): the same taps, the composite's f32
    math in another order, plus early termination at T < 1e-6 when ftb:
    1e-5 on values in [-1, 1] (colour) and [0, 1) (depth). Returns the
    kernel's (rgb, depth) of the both mode."""
    u, v = render_ops.uv_project(*target, h, w)
    want = (rl_ops.render_layers_plain(layers, u, v),
            rl_ops.render_layers_plain(layers, u, v, depth=True))
    del u, v
    got = _layer_stack_modes(layers, target, ftb)
    one = (int(not ftb), int(ftb))
    assert got["rgb"][1] == got["depth"][1] == (*one, 0)
    assert got["both"][1] == (*one, 1)
    for outs, wants in ((got["rgb"][0], want[:1]),
                        (got["depth"][0], want[1:]),
                        (got["both"][0], want)):
        for g, wnt in zip(outs, wants):
            assert g.shape == wnt.shape == (layers.shape[0], h, w, 3)
            assert (g - wnt).abs().max().item() <= 1e-5
    return got["both"][0]


@pytest.mark.cuda
@pytest.mark.parametrize("ftb", [False, True])
@pytest.mark.parametrize("rot_deg", [0.0, 40.0])
@pytest.mark.parametrize("dtype", DTYPES)
def test_render_layers_kernel_matches_plain(cuda, rot_deg, dtype, ftb):
    """Back to front (K4/K5) and front to back (K6), colour, depth and
    both, two targets in a batch, against the plain version fed the
    kernel's own lookups (_check_layer_stack_modes)."""
    layers = _stack(cuda, dtype, 2, P, H, W)
    pose, pos, radii = _target(cuda, rot_deg)
    target = (pose.expand(2, 4, 4), torch.cat([pos, -pos]), radii)
    _check_layer_stack_modes(layers, target, ftb, H, W)


@pytest.mark.cuda
@pytest.mark.parametrize("ftb", [False, True])
@pytest.mark.parametrize("dtype", DTYPES)
def test_render_layers_kernel_flagship(cuda, dtype, ftb):
    """The same at the flagship's 640x320 and 32 shells (1 m to 100 m),
    rotated and translated target."""
    from matryodshka_tpu_torch.geometry import sweep as sweep_lib
    radii = torch.tensor(sweep_lib.inv_depths(1.0, 100.0, 32),
                         dtype=torch.float32, device=cuda)
    pose, pos, _ = _target(cuda, 30.0)
    _check_layer_stack_modes(_stack(cuda, dtype, 1, 32, 320, 640),
                             (pose, pos, radii), ftb, 320, 640)


@pytest.mark.cuda
def test_render_layers_kernel_hres(cuda):
    """The high-res re-render's case: a stack of 32 4096x2048 shells (2^30
    values: 64-bit shell offsets), bf16 and f32, back to front, every
    mode."""
    from matryodshka_tpu_torch.geometry import sweep as sweep_lib
    radii = torch.tensor(sweep_lib.inv_depths(1.0, 100.0, 32),
                         dtype=torch.float32, device=cuda)
    pose, pos, _ = _target(cuda, 0.0)
    for dtype in (torch.bfloat16, torch.float32):
        rgb, depth = _check_layer_stack_modes(
            _stack(cuda, dtype, 1, 32, 2048, 4096), (pose, pos, radii),
            False, 2048, 4096)
        assert torch.isfinite(rgb).all() and torch.isfinite(depth).all()
        del rgb, depth


@pytest.mark.cuda
def test_uv_project_hres_matches_float64(cuda):
    """The kernels' projection at 4096x2048 and 32 shells against
    intersect_sphere_uv in float64, four shells at a time, within the f32
    noise bound (grids.lookup_error)."""
    from matryodshka_tpu_torch.geometry import grids
    from matryodshka_tpu_torch.geometry import sweep as sweep_lib
    radii = torch.tensor(sweep_lib.inv_depths(1.0, 100.0, 32),
                         dtype=torch.float32, device=cuda)
    pose, pos, _ = _target(cuda, 30.0)
    for p0 in range(0, 32, 4):
        r = radii[p0:p0 + 4].contiguous()
        u, v = render_ops.uv_project(pose, pos, r, 2048, 4096)
        u6, v6 = render_lib.uv_tables(pose.double(), pos.double(),
                                      r.double(), 2048, 4096)
        err = grids.lookup_error(u, v, u6, v6,
                                 r.double()[None, :, None, None], 2048, 4096)
        assert err["u"] <= 1.0 and err["v"] <= 1.0, (p0, err)


@pytest.mark.cuda
def test_layer_stack_paths_build_no_tables(cuda):
    """The CLI's layer-stack request (blend_bg), its ftb request and the
    high-res re-render: one layer-stack launch per render call (image and
    depth together) and no uv_tables build."""
    from matryodshka_tpu_torch.cli import test as cli_test
    cfg = entry.flagship_cfg(height=H, width=W, num_psv_planes=P,
                             num_msi_planes=P, ngf=NGF,
                             which_color_pred="blend_bg", hres_height=2 * H,
                             hres_width=2 * W)
    params = entry.make_params(cfg, seed=3, device=cuda)
    b = entry.synthetic_batch(cfg, 2, cuda, tgt_pos=(0.03, -0.01, 0.02))
    counts = ((rl_ops, "launches"), (rl_ops, "ftb_launches"),
              (rl_ops, "both_launches"), (render_lib, "uv_builds"))
    for ftb, want in ((False, [1, 0, 1, 0]), (True, [0, 1, 1, 0])):
        before = [getattr(m, c) for m, c in counts]
        cli_test.build_infer_fn(cfg, params, "tgt_image", ftb=ftb)(b)
        assert [getattr(m, c) - n for (m, c), n in zip(counts, before)] \
            == want
    hcfg = entry.flagship_cfg(height=H, width=W, num_psv_planes=P,
                              num_msi_planes=P, ngf=NGF, hres_height=2 * H,
                              hres_width=2 * W)
    rng = np.random.RandomState(11)
    img = [torch.from_numpy(rng.rand(1, 2 * H, 2 * W, 3).astype(
        np.float32)).to(cuda) for _ in range(2)]
    bw, al = (torch.from_numpy(rng.rand(1, H, W, P).astype(np.float32)).to(
        cuda) for _ in range(2))
    eye = torch.eye(4, device=cuda)[None]
    before = [getattr(m, c) for m, c in counts]
    cli_test.build_hres_render_fn(hcfg)(*img, bw, al, eye, eye, eye,
                                        b["intrinsics"], b["tgt_pose"])
    assert [getattr(m, c) - n for (m, c), n in zip(counts, before)] == \
        [1, 0, 1, 0]


@pytest.mark.cuda
@pytest.mark.parametrize("scheme", ["blend_psv", "blend_bg", "blend_bg_psv",
                                    "alpha_only"])
def test_infer_fn_matches_plain(cuda, scheme):
    """cli.test.build_infer_fn on the card (bf16 kernels) against its
    all-plain f32 twin, image and depth, to the bf16 bound of
    chip_smoke.py; the head widths 2P, 2P+3, 3P+3 and P go through the
    conv kernel."""
    from matryodshka_tpu_torch.cli import test as cli_test
    cfg = entry.flagship_cfg(height=H, width=W, num_psv_planes=P,
                             num_msi_planes=P, ngf=NGF,
                             which_color_pred=scheme)
    params = entry.make_params(cfg, seed=3, device=cuda)
    b = entry.synthetic_batch(cfg, 2, cuda, tgt_pos=(0.03, -0.01, 0.02))
    got = cli_test.build_infer_fn(cfg, params, "tgt_image")(b)
    want = cli_test.infer_plain(cfg, params, b)
    for k in ("output_image", "output_depth"):
        assert (got[k] - want[k]).abs().max().item() <= 2e-2, k


@pytest.mark.cuda
def test_hres_render_matches_plain(cuda):
    """The high-res re-render (sweep, upsample, hres assembly, layer-stack
    kernel) at 128x256 against the shell-streamed plain f32 path."""
    from matryodshka_tpu_torch.cli import test as cli_test
    cfg = entry.flagship_cfg(height=H, width=W, num_psv_planes=P,
                             num_msi_planes=P, ngf=NGF, hres_height=2 * H,
                             hres_width=2 * W, min_depth=2.0, max_depth=20.0)
    rng = np.random.RandomState(10)

    def t(*shape):
        return torch.from_numpy(rng.rand(*shape).astype(np.float32)).to(cuda)

    ref, src, bw, al = t(1, 2 * H, 2 * W, 3), t(1, 2 * H, 2 * W, 3), \
        t(1, H, W, P), t(1, H, W, P)
    eye = torch.eye(4, device=cuda)[None]
    intr = torch.eye(3, device=cuda)[None].clone()
    intr[0, 0, 0] = 0.032
    pos = torch.tensor([[0.02, 0.01, -0.015]], device=cuda)
    rgb, depth = cli_test.build_hres_render_fn(cfg)(ref, src, bw, al, eye,
                                                    eye, eye, intr, pos)
    rgb_p, depth_p = cli_test.hres_render_plain(cfg, ref, src, bw, al, intr,
                                                pos)
    assert (rgb - rgb_p).abs().max().item() <= 2e-2
    assert (depth - depth_p).abs().max().item() <= 2e-2


@pytest.mark.cuda
@pytest.mark.parametrize("scheme", ["blend_bg", "blend_bg_psv",
                                    "alpha_only"])
def test_hres_render_schemes_match_plain(cuda, scheme):
    """The high-res re-render of the other schemes, each with its colour
    rule (cli/test.py:HRES_ASSEMBLY), at 128x256: one assembled-sweep
    launch (no K1 volume) and one layer-stack launch for image and depth,
    no lookup table, against the
    shell-streamed plain f32 path at test_hres_render_matches_plain's
    bound. alpha_only is given no blend weights."""
    from matryodshka_tpu_torch.cli import test as cli_test
    cfg = entry.flagship_cfg(height=H, width=W, num_psv_planes=P,
                             num_msi_planes=P, ngf=NGF, hres_height=2 * H,
                             hres_width=2 * W, min_depth=2.0, max_depth=20.0,
                             which_color_pred=scheme)
    rng = np.random.RandomState(12)

    def t(*shape):
        return torch.from_numpy(rng.rand(*shape).astype(np.float32)).to(cuda)

    ref, src, bw, al = t(1, 2 * H, 2 * W, 3), t(1, 2 * H, 2 * W, 3), \
        t(1, H, W, P), t(1, H, W, P)
    bg = t(1, H, W, 3) * 2 - 1
    if scheme == "alpha_only":
        bw = None
    eye = torch.eye(4, device=cuda)[None]
    intr = torch.eye(3, device=cuda)[None].clone()
    intr[0, 0, 0] = 0.032
    pos = torch.tensor([[0.02, 0.01, -0.015]], device=cuda)
    counts = ((sweep_ops, "assembled_launches"), (sweep_ops, "launches"),
              (rl_ops, "launches"), (rl_ops, "both_launches"),
              (render_lib, "uv_builds"))
    before = [getattr(m, c) for m, c in counts]
    rgb, depth = cli_test.build_hres_render_fn(cfg)(
        ref, src, bw, al, eye, eye, eye, intr, pos, bg_rgb=bg)
    torch.cuda.synchronize()
    assert [getattr(m, c) - n for (m, c), n in zip(counts, before)] == \
        [1, 0, 1, 1, 0]
    rgb_p, depth_p = cli_test.hres_render_plain(cfg, ref, src, bw, al, intr,
                                                pos, bg_rgb=bg)
    assert (rgb - rgb_p).abs().max().item() <= 2e-2
    assert (depth - depth_p).abs().max().item() <= 2e-2


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["wrap", "coord"])
def test_smoothed_net_kernel_route_matches_plain(cuda, variant):
    """A smoothed net (upsampling convs in place of the transposed ones)
    through ops/net.unet_forward: 18 conv launches (the three upsampling
    stages in the kernel's folded parity form), 17 of them with their
    inputs' layer norm fused, and no layer-norm launch. In float32 the
    f32 kernels against the plain versions to
    1e-4 (the plan's bound in test_conv_kernel_matches_plain); in bf16 the
    kernel route against the float32 plain net within max(2e-2, 1.5 x
    the bf16 plain net's own distance from it) (chip_smoke.py path 11's
    rule: two bf16 routes' errors from f32 add)."""
    cfg = entry.flagship_cfg(height=H, width=W, num_psv_planes=P,
                             num_msi_planes=P, ngf=NGF, smoothed=True,
                             coord_net=variant == "coord")
    params = entry.make_params(cfg, seed=4, device=cuda)
    x = torch.from_numpy(np.random.RandomState(13).uniform(
        -1, 1, (1, cfg.num_net_inputs(), H, W)).astype(np.float32)).to(cuda)
    with torch.no_grad():
        want32 = params.net(x, dtype=torch.float32)
        plain16 = params.net(x, dtype=torch.bfloat16)
        stages32 = net_ops.prepare(params.net, torch.float32, H)
        got32 = net_ops.unet_forward(stages32, x)
        n_conv, n_ln = conv_ops.launches, conv_ops.norm_launches
        got16 = net_ops.unet_forward(params.stages, x.to(torch.bfloat16))
        torch.cuda.synchronize()
        assert (conv_ops.launches - n_conv,
                conv_ops.norm_launches - n_ln) == (18, 17)
        cpu = [{k: (v.cpu() if torch.is_tensor(v) else v)
                for k, v in st.items()} for st in stages32]
        for st in cpu:
            if "coord" in st["args"]:
                st["args"] = dict(st["args"], coord=st["args"]["coord"].cpu())
            if st["norm"] is not None:
                st["norm"] = [(g.cpu(), bt.cpu()) for g, bt in st["norm"]]
        plain32 = net_ops.unet_forward(cpu, x.cpu())
    assert (got32.cpu() - plain32).abs().max().item() <= \
        1e-4 * plain32.abs().max().item()
    spread = (plain16 - want32).abs().max().item()
    assert (got16 - want32).abs().max().item() <= max(2e-2, 1.5 * spread)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_full_export_on_the_card(cuda, tmp_path, dtype):
    """cli/export.main --net_only false --platform cuda: the loaded
    program launches K1 (the op library's matry::sweep_volume, counted by
    the library, not by the Python wrapper) exactly once a call and is
    within 1e-6 of the eager build_full_fn (the same
    operations); in bf16 the test CLI's kernel-route rgba_layers are held
    to the float32 function within max(2e-2, 1.5 x the bf16 program's
    distance from it) (chip_smoke.py path 11's rule: the two bf16 nets'
    errors from float32 add, so they are not held to each other)."""
    from matryodshka_tpu_torch import weights
    from matryodshka_tpu_torch.cli import export as export_cli
    from matryodshka_tpu_torch.cli import test as cli_test
    flags = ["--height", str(H), "--width", str(W), "--num_psv_planes",
             str(P), "--num_msi_planes", str(P), "--ngf", str(NGF),
             "--compute_dtype", dtype, "--coord_net", "true", "--net_only",
             "false", "--export_dir", str(tmp_path), "--checkpoint_dir",
             str(tmp_path / "none")]
    with pytest.warns(UserWarning, match="no checkpoint"):
        path = export_cli.main(flags)
    cfg = export_cli.config_from_args(export_cli.build_parser().parse_args(
        flags))
    b = entry.synthetic_batch(cfg, 5, cuda)
    inputs = [b[k].contiguous() for k in ("ref_image", "src_image",
                                          "ref_pose", "src_pose",
                                          "ref_pose_inv", "intrinsics")]
    tree = weights.seeded_init(cfg, 0)
    program = torch.export.load(path).module()
    with torch.no_grad():
        n, n_py = sweep_ops.op_launches(), sweep_ops.launches
        got = program(*inputs)
        torch.cuda.synchronize()
        assert sweep_ops.op_launches() == n + 1
        assert sweep_ops.launches == n_py
        eager = export_cli.build_full_fn(cfg, tree, cuda)(*inputs)
        params = entry.make_params(cfg, flax_params=tree, device=cuda)
        kern = cli_test.build_infer_fn(cfg, params, "rgba_layers")(b)
    assert got.dtype == cfg.torch_compute_dtype
    assert tuple(got.shape) == (1, H, W, P, 4)
    assert (got.float() - eager.float()).abs().max().item() <= 1e-6
    if dtype == "bfloat16":
        with torch.no_grad():
            want32 = export_cli.build_full_fn(
                dataclasses.replace(cfg, compute_dtype="float32"), tree,
                cuda)(*inputs)
        spread = (got.float() - want32).abs().max().item()
        err = (kern["rgba_layers"].float() - want32).abs().max().item()
        assert err <= max(2e-2, 1.5 * spread), (err, spread)


@pytest.mark.cuda
def test_forward_one_launch_per_stage(cuda):
    """entry.forward's sweep stage is one K1 launch and its render stage
    one K3 launch per frame, with no instrument launched."""
    cfg, b = _batch(cuda, seed=3)
    params = entry.make_params(cfg, seed=2, device=cuda)
    counts = ((sweep_ops, "launches"), (sweep_ops, "row_params_launches"),
              (render_ops, "launches"), (render_ops, "uv_launches"))
    before = [getattr(m, c) for m, c in counts]
    for _ in range(2):
        entry.forward(params, b)
    after = [getattr(m, c) for m, c in counts]
    assert [a - n for a, n in zip(after, before)] == [2, 0, 2, 0]


@pytest.mark.cuda
def test_forward_runs_every_kernel(cuda):
    """The small slice on the card goes through all four kernels and
    matches its all-plain f32 twin to the bf16 bound of chip_smoke.py."""
    cfg, b = _batch(cuda, seed=1)
    params = entry.make_params(cfg, seed=2, device=cuda)
    mods = (sweep_ops, conv_ops, render_ops)
    before = [m.launches for m in mods]
    n_norm = conv_ops.norm_launches
    out = entry.forward(params, b)
    torch.cuda.synchronize()
    assert all(m.launches > n for m, n in zip(mods, before))
    assert conv_ops.norm_launches - n_norm == 17
    assert torch.isfinite(out).all()
    err = (out - entry.forward_plain(params, b)).abs().max().item()
    assert err <= 2e-2, err


def _coord_net(dev, ngf, cin, cout, seed):
    rng = np.random.RandomState(seed)
    net = MSIUNet(cin, cout, ngf, variant="coord").to(dev)
    with torch.no_grad():
        for prm in net.parameters():
            prm.copy_(torch.from_numpy(
                rng.randn(*prm.shape).astype(np.float32) * 0.2))
    return net, rng


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
def test_coord_conv_kernel_matches_plain(cuda, dtype):
    """Every stage of the coord plan at 32x64 (the coord channel, zero
    padding at the edge columns, SAME downs, zero-mode parity deconvs),
    with the tolerances of test_conv_kernel_matches_plain; each stage,
    the head included, counts one coord-mode launch."""
    net, rng = _coord_net(cuda, NGF, 2 * P * 3, 2 * P, 12)
    for plan, st in zip(net.plan, net_ops.prepare(net, dtype, H)):
        name, kind, _, cins, _, ind, outd, _ = plan
        x = torch.from_numpy(rng.uniform(
            -1, 1, (2, sum(cins), H // ind, W // ind)).astype(
                np.float32)).to(cuda, dtype)
        before = conv_ops.coord_launches
        got = conv_ops.conv(x, st["w"], st["b"], **st["args"]).float()
        assert conv_ops.coord_launches == before + 1, name
        assert tuple(got.shape[2:]) == (H // outd, W // outd), name
        want = conv_ops.conv_plain(x, st["w"], st["b"],
                                   **st["args"]).float()
        tol = (1e-4 if dtype == torch.float32 else 2.0 ** -7) * \
            want.abs().max().item()
        assert (got - want).abs().max().item() <= tol, name


@pytest.mark.cuda
def test_coord_conv_kernel_edges_and_poles(cuda):
    """On a constant input, zero padding shows only in the first and last
    rows and columns and the coord channel weighs most at the pole rows:
    the kernel's edge columns and pole rows against the plain version and
    against each other's interior, f32."""
    net, _ = _coord_net(cuda, NGF, 5, 3, 13)
    st = net_ops.prepare(net, torch.float32, 24)[0]   # conv1_1, +coord
    x = torch.ones((1, 5, 24, 40), device=cuda)
    got = conv_ops.conv(x, st["w"], st["b"], **st["args"])
    want = conv_ops.conv_plain(x, st["w"], st["b"], **st["args"])
    assert (got - want).abs().max().item() <= 1e-4 * want.abs().max().item()
    inner = got[:, :, 1:-1, 1:-1]
    assert (inner - inner[:, :, :, :1]).abs().max().item() <= 1e-5
    assert (got[:, :, :, 0] - got[:, :, :, 1]).abs().max().item() > 1e-3
    assert (got[:, :, 1] - got[:, :, 12]).abs().max().item() > 1e-3


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["conv1_1", "conv1_2", "conv4_1",
                                  "conv8_1", "color_pred"])
def test_coord_conv_kernel_flagship_shapes(cuda, name):
    """Flagship stages of the coord net (ngf 64, 640x320, 32 + 32 planes,
    bf16): conv1_1 reads 192 + 1 channels, the stride-2 SAME down writes
    160x320 from 320x640, conv4_1 is rate 2, conv8_1 a deconv."""
    cfg = entry.flagship_cfg(coord_net=True)
    params = entry.make_params(cfg, seed=0, device=cuda)
    i = [pl[0] for pl in params.net.plan].index(name)
    _, kind, _, cins, _, ind, outd, _ = params.net.plan[i]
    st = params.stages[i]
    rng = np.random.RandomState(14)
    x = torch.from_numpy(rng.uniform(
        -1, 1, (1, sum(cins), 320 // ind, 640 // ind)).astype(
            np.float32)).to(cuda, torch.bfloat16)
    got = conv_ops.conv(x, st["w"], st["b"], **st["args"]).float()
    assert tuple(got.shape[2:]) == (320 // outd, 640 // outd)
    if kind in ("conv", "down"):
        assert tuple(st["w"].shape) == (1, 9 * (sum(cins) + 1),
                                        got.shape[1])
    want = conv_ops.conv_plain(x, st["w"], st["b"], **st["args"]).float()
    assert (got - want).abs().max().item() <= \
        2.0 ** -7 * want.abs().max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("input_type,cin", [("PP", 192),
                                            ("REALESTATE_PP", 195)])
def test_coord_conv_first_layer_mpi_inputs(cuda, input_type, cin):
    """The coord net's first conv at the PP and RealEstate recipes' input
    widths (Cin' = 193 and 196 with the coord channel; 640x320, ngf 64,
    bf16) against its plain version, within one bf16 step of the scale."""
    cfg = entry.flagship_cfg(coord_net=True, input_type=input_type)
    params = entry.make_params(cfg, seed=0, device=cuda)
    st = params.stages[0]
    assert tuple(st["w"].shape) == (1, 9 * (cin + 1), 64)
    rng = np.random.RandomState(15)
    x = torch.from_numpy(rng.uniform(-1, 1, (1, cin, 320, 640)).astype(
        np.float32)).to(cuda, torch.bfloat16)
    got = conv_ops.conv(x, st["w"], st["b"], **st["args"]).float()
    want = conv_ops.conv_plain(x, st["w"], st["b"], **st["args"]).float()
    assert (got - want).abs().max().item() <= \
        2.0 ** -7 * want.abs().max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("input_type", ["PP", "REALESTATE_PP"])
@pytest.mark.parametrize("coord", [False, True])
def test_infer_mpi_runs_the_net_kernels(cuda, input_type, coord):
    """The test CLI's MPI route (msi.infer_mpi) on the card at a small
    size: one conv launch per stage (18), 17 of them with their inputs'
    layer norm fused (no layer-norm launch), no sweep, K3 or layer-stack
    render launch, one launch of the MPI render kernel; its view
    within chip_smoke.py's bf16 bound of the all-plain f32 route."""
    cfg = entry.flagship_cfg(height=H, width=W, num_psv_planes=P,
                             num_msi_planes=P, ngf=NGF, coord_net=coord,
                             input_type=input_type)
    b = entry.synthetic_batch(cfg, 3, cuda)
    params = entry.make_params(cfg, seed=4, device=cuda)
    before = (conv_ops.launches, conv_ops.norm_launches, sweep_ops.launches,
              render_ops.launches, rl_ops.launches, mpi_ops.launches)
    out = msi_lib.infer_mpi(cfg, params.stages, b, params.psv_depths,
                            params.msi_depths)["output_image"]
    torch.cuda.synchronize()
    after = (conv_ops.launches, conv_ops.norm_launches, sweep_ops.launches,
             render_ops.launches, rl_ops.launches, mpi_ops.launches)
    assert [a - n for a, n in zip(after, before)] == [18, 17, 0, 0, 0, 1]
    assert out.shape == (1, H, W, 3) and torch.isfinite(out).all()
    from matryodshka_tpu_torch.cli.test import infer_plain
    want = infer_plain(cfg, params, b)["output_image"] * 2 - 1
    assert (out - want).abs().max().item() <= 2e-2


def _rot_yp(yaw, pitch):
    cy, sy, cp, sp = (math.cos(yaw), math.sin(yaw), math.cos(pitch),
                      math.sin(pitch))
    ry = torch.tensor([[cy, 0.0, sy], [0.0, 1.0, 0.0], [-sy, 0.0, cy]])
    rx = torch.tensor([[1.0, 0.0, 0.0], [0.0, cp, -sp], [0.0, sp, cp]])
    return ry @ rx


def _mpi_case(dev, b, c, h, w, p, kind, dtype, seed=0):
    """The MPI render's inputs on dev: vol [b, c, h, w] in dtype and pred
    [b, 2p, h, w] f32, uniform in [-1, 1]; target poses [b, 4, 4],
    intrinsics [b, 3, 3], depths [p] (1-100 m). near: a viewer's head
    motion; outside: 0.7 m and 25 degrees off, so most near taps fall
    outside the image; edge_on: the target turned 90 degrees about y with
    a wide field of view (f = w/4), so the planes are seen edge-on down
    the middle column (coordinates beyond any integer) and obliquely
    beside it."""
    g = torch.Generator().manual_seed(seed)
    vol = (torch.rand((b, c, h, w), generator=g) * 2 - 1).to(dev, dtype)
    pred = (torch.rand((b, 2 * p, h, w), generator=g) * 2 - 1).to(dev)
    f = (w / 4, w / 4) if kind == "edge_on" else (0.9 * w, 1.2 * h)
    k = torch.tensor([[f[0], 0.0, w / 2], [0.0, f[1], h / 2],
                      [0.0, 0.0, 1.0]]).repeat(b, 1, 1)
    pose = torch.eye(4).repeat(b, 1, 1)
    for i in range(b):
        s = (i + 1) / b
        if kind == "near":
            pose[i, :3, :3] = _rot_yp(math.radians(4 * s),
                                      math.radians(-3 * s))
            pose[i, :3, 3] = torch.tensor([0.06, -0.03, 0.05]) * s
        elif kind == "outside":
            pose[i, :3, :3] = _rot_yp(math.radians(25 * s), math.radians(10))
            pose[i, :3, 3] = torch.tensor([0.6, -0.3, 0.2]) * s
        else:
            pose[i, :3, :3] = torch.tensor([[0.0, 0.0, 1.0], [0.0, 1.0, 0.0],
                                            [-1.0, 0.0, 0.0]])
            pose[i, :3, 3] = torch.tensor([0.0, 0.02, 0.0]) * s
    from matryodshka_tpu_torch.geometry.sweep import inv_depths
    depths = torch.tensor(inv_depths(1.0, 100.0, p), dtype=torch.float32)
    return vol, pred, pose.to(dev), k.to(dev), depths.to(dev)


#: (B, C, H, W, P): a small shape and realestate-coord.mpi-video's (640x320,
#: 32 planes; its volume has C = 195), each with C = 6P and C > 6P.
MPI_SHAPES = [(1, 6 * P, 32, 128, P), (4, 6 * P + 3, 32, 128, P),
              (1, 192, 320, 640, 32), (4, 195, 320, 640, 32)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("kind", ["near", "outside", "edge_on"])
@pytest.mark.parametrize("shape", MPI_SHAPES,
                         ids=["x".join(map(str, s)) for s in MPI_SHAPES])
def test_mpi_render_matches_plain(cuda, shape, kind, dtype):
    """The MPI render kernel (one launch) against its plain version in f32
    on the same values (a bf16 volume upcast): within 2e-4. The two warp
    by the same homographies; what remains is the order of the f32 sums
    (the blend as bg + w (fg - bg), the composite front to back)."""
    b, c, h, w, p = shape
    vol, pred, pose, k, depths = _mpi_case(cuda, b, c, h, w, p, kind, dtype)
    n = mpi_ops.launches
    got = mpi_ops.render_mpi_blend(vol, pred, pose, k, depths)
    torch.cuda.synchronize()
    assert mpi_ops.launches == n + 1 and got.shape == (b, h, w, 3)
    want = mpi_ops.render_mpi_blend_plain(vol.float(), pred, pose, k, depths)
    assert bool(torch.isfinite(got).all())
    assert (got - want).abs().max().item() <= 2e-4
    assert want.abs().max().item() > 0.1


@pytest.mark.cuda
def test_mpi_render_is_deterministic(cuda):
    args = _mpi_case(cuda, 4, 195, 320, 640, 32, "near", torch.bfloat16)
    first = mpi_ops.render_mpi_blend(*args)
    second = mpi_ops.render_mpi_blend(*args)
    assert torch.equal(first, second)


def _mpi_entry(dev, b=2, dtype="bfloat16"):
    cfg = entry.flagship_cfg(height=H, width=W, num_psv_planes=P,
                             num_msi_planes=P, ngf=NGF, batch_size=b,
                             coord_net=True, input_type="REALESTATE_PP",
                             compute_dtype=dtype)
    return (cfg, entry.make_params(cfg, seed=6, device=dev),
            entry.synthetic_batch(cfg, 6, dev))


@pytest.mark.cuda
def test_mpi_render_stage_does_not_synchronize(cuda):
    """mpi_render_stage on the card (the homographies, K^-1 by inv_ex, and
    the launch) under torch.cuda.set_sync_debug_mode("error"): no call
    waits on the card."""
    cfg, params, batch = _mpi_entry(cuda)
    vol = msi_lib.sweep_stage(cfg, batch, params.psv_depths)
    pred = msi_lib.net_stage(params.stages, vol)
    msi_lib.mpi_render_stage(cfg, vol, pred, batch, params.msi_depths)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        outs = msi_lib.mpi_render_stage(cfg, vol, pred, batch,
                                        params.msi_depths)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert set(outs) == {"vol", "pred", "output_image"}


@pytest.mark.cuda
def test_forward_renders_the_mpi_in_one_launch(cuda):
    """One entry.forward of a REALESTATE_PP batch: one launch of the MPI
    render kernel, no layer stack; its view within chip_smoke.py's bf16
    bound of the bf16-stack route (assemble_train, render_mpi_view)."""
    cfg, params, batch = _mpi_entry(cuda)
    n = mpi_ops.launches
    got = entry.forward(params, batch)
    torch.cuda.synchronize()
    assert mpi_ops.launches == n + 1
    vol = msi_lib.sweep_stage(cfg, batch, params.psv_depths)
    pred = msi_lib.net_stage(params.stages, vol)
    layers = msi_lib.assemble_train(cfg, vol, pred)["rgba_layers"]
    assert layers.dtype == torch.bfloat16
    want = msi_lib.render_mpi_view(layers, msi_lib.mpi_view_pose(batch),
                                   params.msi_depths, batch["intrinsics"])
    assert (got - want).abs().max().item() <= 2e-2


#: The trainer's stride-1 wrap convs at ngf 64 (name, Cin, Cout, size
#: divisor of 320x640): K7c for >= 160 input channels, else K7b.
K7_LAYERS = [(name, sum(cins), cout, ind) for (name, kind, _, cins, cout,
                                                ind, _, rate)
             in net_ops.unet_plan(64, 192, 1) if kind == "conv" and rate == 1]


@pytest.mark.cuda
@pytest.mark.parametrize("layer", K7_LAYERS, ids=[lay[0] for lay in K7_LAYERS])
def test_wrap_conv_kernels_match_plain(cuda, layer):
    """K7 at the trainer's eight layer shapes (640x320 flagship, bf16
    operands): forward K7a (f32 out, 1e-4 of the scale: f32 sums in another
    order), K7b and K7c's y (one bf16 step, 2^-7 of the scale), K7c's sums
    (1e-5 of sum|y| and of sum y^2, chip_smoke.py's STATS_TOL: ~1e-3 of
    the elements round one bf16 step the other way, ~1e-7 in all, while
    one of the 400-1600 block partials lost moves s2 by >= 6e-4; two
    launches give bit-identical sums), dgrad
    (K7a on the adjoint weights) and wgrad (relative L2 1e-3: sums of up
    to 204,800 products in two blockings; bit-identical over two launches);
    each wrapper counts one launch.
    Inputs post-ReLU-like (half zeros), as the trainer feeds these layers,
    so s1 is not a small difference of large sums."""
    from matryodshka_tpu_torch.ops import wrap_conv as wc
    _, cin, cout, ind = layer
    g = torch.Generator(device=cuda).manual_seed(cin * 1000 + ind)
    h, w = 320 // ind, 640 // ind
    x = torch.relu(torch.rand((1, cin, h, w), generator=g, device=cuda) * 2
                   - 1).to(torch.bfloat16)
    wt = torch.randn((cout, cin, 3, 3), generator=g, device=cuda) * (
        9 * cin) ** -0.5
    bias = 0.1 * torch.randn(cout, generator=g, device=cuda)
    gy = torch.randn((1, cout, h, w), generator=g, device=cuda).to(
        torch.bfloat16)

    def scale(t):
        return t.float().abs().max().item()

    before = (wc.k7a_launches, wc.k7b_launches, wc.k7c_launches,
              wc.wgrad_launches)
    want = wc.conv3x3_wrap_plain(x, wt, bias)
    got = wc.conv3x3_wrap(x, wt, bias)
    assert got.dtype == torch.float32
    assert (got - want).abs().max().item() <= 1e-4 * scale(want)
    want = wc.conv3x3_wrap_dma_plain(x, wt, bias)
    got = wc.conv3x3_wrap_dma(x, wt, bias)
    assert got.dtype == torch.bfloat16
    assert (got.float() - want.float()).abs().max().item() <= \
        2.0 ** -7 * scale(want)
    y, s1, s2 = wc.conv3x3_ln_stats(x, wt, bias)
    yp, p1, p2 = wc.conv3x3_ln_stats_plain(x, wt, bias)
    assert (y.float() - yp.float()).abs().max().item() <= 2.0 ** -7 * scale(yp)
    assert s1.dtype == s2.dtype == torch.float64
    # no atomics: a second launch gives the same y and bit-identical sums
    y2, s1b, s2b = wc.conv3x3_ln_stats(x, wt, bias)
    assert torch.equal(y, y2) and torch.equal(s1, s1b) and \
        torch.equal(s2, s2b)
    assert (s1 - p1).abs().item() <= 1e-5 * yp.double().abs().sum().item()
    assert (s2 - p2).abs().item() <= 1e-5 * p2.item()
    wadj = wc.adjoint(wt)
    want = wc.conv3x3_wrap_plain(gy, wadj)
    got = wc.conv3x3_wrap(gy, wadj)
    assert (got - want).abs().max().item() <= 1e-4 * scale(want)
    dw, db = wc.conv3x3_wrap_wgrad(gy, x)
    dwp, dbp = wc.conv3x3_wrap_wgrad_plain(gy, x)
    assert dw.shape == wt.shape and db.shape == (cout,)
    assert ((dw - dwp).norm() / dwp.norm()).item() <= 1e-3
    assert ((db - dbp).norm() / dbp.norm()).item() <= 1e-3
    # fixed split and fold: a second launch gives bit-identical dW and db
    dw2, db2 = wc.conv3x3_wrap_wgrad(gy, x)
    assert torch.equal(dw, dw2) and torch.equal(db, db2)
    torch.cuda.synchronize()
    assert (wc.k7a_launches, wc.k7b_launches, wc.k7c_launches,
            wc.wgrad_launches) == (before[0] + 2, before[1] + 1,
                                   before[2] + 2, before[3] + 2)


#: Weight-gradient shapes (B, Cin, Cout, H, W) that fill no tile: odd
#: channel counts, W = 40 (not a multiple of 16: the bf16 kernel gathers
#: its stages; a k-step of 16 pixels half past the row end), a pixel sum
#: that splits unevenly (222 k-steps in 56 splits of 4), W = 37 and W = 5
#: (W = 5 wraps every tap onto the row).
WGRAD_RAGGED = [(2, 13, 19, 6, 40), (2, 33, 65, 37, 40), (1, 7, 9, 5, 37),
                (2, 5, 3, 4, 5)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", WGRAD_RAGGED,
                         ids=["x".join(map(str, s)) for s in WGRAD_RAGGED])
@pytest.mark.parametrize("dtype", DTYPES)
def test_wgrad_kernel_ragged_matches_plain(cuda, dtype, shape):
    """The weight-gradient kernel (tensor cores in bf16, exact FMA in f32)
    against its plain version: relative L2 1e-3 in bf16 (f32 sums of exact
    bf16 products in another blocking), 1e-5 in f32; bit-identical over
    two launches; one launch counted per call; one shape's bf16 plan
    splits its k-blocks unevenly."""
    from matryodshka_tpu_torch.ops import wrap_conv as wc
    b, cin, cout, h, w = shape
    rng = np.random.RandomState(sum(shape))
    x = torch.from_numpy(rng.randn(b, cin, h, w).astype(np.float32)).to(
        cuda, dtype)
    g = torch.from_numpy(rng.randn(b, cout, h, w).astype(np.float32)).to(
        cuda, dtype)
    before = wc.wgrad_launches
    dw, db = wc.conv3x3_wrap_wgrad(g, x)
    dw2, db2 = wc.conv3x3_wrap_wgrad(g, x)
    torch.cuda.synchronize()
    assert wc.wgrad_launches == before + 2
    assert torch.equal(dw, dw2) and torch.equal(db, db2)
    dwp, dbp = wc.conv3x3_wrap_wgrad_plain(g, x)
    tol = 1e-5 if dtype == torch.float32 else 1e-3
    assert ((dw - dwp).norm() / dwp.norm()).item() <= tol
    assert ((db - dbp).norm() / dbp.norm()).item() <= tol
    if shape == (2, 33, 65, 37, 40):
        plan = wc.wgrad_plan(b, h, w, cout, cin,
                             wc._sm_count(cuda.index or 0))
        assert plan.splits * plan.chunk > plan.kblocks


#: The trainer's eight wrap-conv layers at the flagship shape (name, Cin,
#: Cout, H, W), the bf16 weight gradient's main path.
WGRAD_TRAINER = [(name, sum(cins), cout, 320 // ind, 640 // ind)
                 for (name, kind, _, cins, cout, ind, _, rate)
                 in net_ops.unet_plan(64, 192, 1)
                 if kind == "conv" and rate == 1]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", WGRAD_TRAINER,
                         ids=[s[0] for s in WGRAD_TRAINER])
def test_wgrad_kernel_trainer_matches_plain(cuda, shape):
    """The bf16 weight-gradient kernel at the trainer's eight layer shapes
    (stages by TMA, k-steps of 64 or 32 pixels, 120-132 blocks folded in
    the launch) against its plain version: relative L2 1e-3 (f32 sums of
    exact bf16 products in another blocking), bit-identical over two
    launches, one launch counted per call."""
    from matryodshka_tpu_torch.ops import wrap_conv as wc
    _, cin, cout, h, w = shape
    gen = torch.Generator(device=cuda).manual_seed(cin * 1000 + cout + w)
    x = torch.relu(torch.randn((1, cin, h, w), generator=gen,
                               device=cuda)).to(torch.bfloat16)
    g = torch.randn((1, cout, h, w), generator=gen,
                    device=cuda).to(torch.bfloat16)
    before = wc.wgrad_launches
    dw, db = wc.conv3x3_wrap_wgrad(g, x)
    dw2, db2 = wc.conv3x3_wrap_wgrad(g, x)
    torch.cuda.synchronize()
    assert wc.wgrad_launches == before + 2
    assert torch.equal(dw, dw2) and torch.equal(db, db2)
    dwp, dbp = wc.conv3x3_wrap_wgrad_plain(g, x)
    assert ((dw - dwp).norm() / dwp.norm()).item() <= 1e-3
    assert ((db - dbp).norm() / dbp.norm()).item() <= 1e-3


@pytest.mark.cuda
def test_wgrad_plan_matches_c(cuda):
    """matry_wgrad_plan (csrc/conv_wgrad.cu) equals ops/wrap_conv.wgrad_plan
    at the trainer's shapes at batch 1 and 2, PP's first layer (Cin 192 and
    195) and the ragged shapes, on this card's SMs and on 7."""
    from matryodshka_tpu_torch.ops import _build
    from matryodshka_tpu_torch.ops import wrap_conv as wc
    shapes = [(b, cin, cout, h, w) for (_, cin, cout, h, w) in WGRAD_TRAINER
              for b in (1, 2)]
    shapes += [(1, 192, 64, 320, 640), (1, 195, 64, 320, 640)]
    shapes += WGRAD_RAGGED
    lib = _build.lib()
    for sms in (wc._sm_count(cuda.index or 0), 7):
        for b, cin, cout, h, w in shapes:
            want = wc.wgrad_plan(b, h, w, cout, cin, sms)
            got = lib.matry_wgrad_plan(b, cin, cout, h, w, sms)
            assert got == want.code, ((b, cin, cout, h, w), sms, got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("stats", [False, True])
def test_wrap_conv_function_matches_plain_autograd(cuda, stats):
    """The autograd Function on the card in f32 (K7 forward, dgrad on the
    adjoint weights, wgrad) against the same Function on the CPU (plain
    versions), odd widths and a batch of 2 so the wgrad's pixel split
    crosses samples: outputs and every gradient to 1e-4 of their scale."""
    from matryodshka_tpu_torch.ops import wrap_conv as wc
    rng = np.random.RandomState(15)
    x0 = rng.uniform(-1, 1, (2, 20, 24, 37)).astype(np.float32)
    w0 = (rng.randn(12, 20, 3, 3) * 0.2).astype(np.float32)
    b0 = rng.randn(12).astype(np.float32)
    r0 = rng.randn(2, 12, 24, 37).astype(np.float32)
    res = {}
    for dev in ("cpu", cuda):
        x, w, b = (torch.from_numpy(a).to(dev).requires_grad_()
                   for a in (x0, w0, b0))
        r = torch.from_numpy(r0).to(dev)
        if stats:
            y, s1, s2 = wc.wrap_conv3x3(x, w, b, stats=True)
            loss = (y * r).sum() + (s1 * 1e-3).sum() + (s2 * 1e-4).sum()
        else:
            y = wc.wrap_conv3x3(x, w, b)
            loss = (y * r).sum()
        loss.backward()
        res[str(dev)] = [t.detach().cpu() for t in (y, x.grad, w.grad,
                                                    b.grad)]
    for got, want in zip(res[str(cuda)], res["cpu"]):
        assert (got - want).abs().max().item() <= \
            1e-4 * want.abs().max().item()


@pytest.mark.cuda
def test_train_step_kernel_route_matches_plain(cuda):
    """One train step of the small default trainer on the card (K1, K7
    forward, dgrad and wgrad, bf16) against the all-plain f32 route on the
    card from the same parameters, chip_smoke.py's gate: loss within 1e-2
    relative, each parameter's gradient within relative L2 max(5e-2, 1.5 x
    the all-plain bf16 route's, which no kernel of the port touches);
    every K7 kernel launched (ngf 64, so conv3_1's 256 input channels take
    K7c)."""
    from matryodshka_tpu_torch.ops import wrap_conv as wc
    from matryodshka_tpu_torch.training import state as state_lib
    from matryodshka_tpu_torch.training import step as step_lib
    cfg = entry.flagship_cfg(height=H, width=W, num_psv_planes=P,
                             num_msi_planes=P)
    b = entry.synthetic_batch(cfg, 4, cuda, tgt_pos=(0.03, 0.01, -0.02))
    state = state_lib.init_state(cfg, 5, cuda)

    def plain(dtype):
        net = MSIUNet(cfg.num_net_inputs(), cfg.num_net_outputs(), cfg.ngf,
                      dtype=dtype).to(cuda)
        net.load_state_dict(state.net.state_dict())

        def sweep(c, bq, d):
            images, rowp = sweep_ops.sweep_inputs(
                msi_lib.preprocess_image(bq["ref_image"]),
                msi_lib.preprocess_image(bq["src_image"]), d,
                bq["intrinsics"])
            return sweep_ops.ods_sweep_plain(images, rowp, dtype)
        return net, sweep

    before = (wc.k7a_launches, wc.k7b_launches, wc.k7c_launches,
              wc.wgrad_launches, sweep_ops.launches)
    out = {}
    for key, (net, sweep) in (("kernel", (state.net, None)),
                              ("plain_bf16", plain(torch.bfloat16)),
                              ("plain", plain(torch.float32))):
        loss, _ = step_lib.make_loss_fn(cfg, net, sweep)(b)
        loss.backward()
        out[key] = (loss.item(), {n: p.grad.float()
                                  for n, p in net.named_parameters()})
    torch.cuda.synchronize()
    after = (wc.k7a_launches, wc.k7b_launches, wc.k7c_launches,
             wc.wgrad_launches, sweep_ops.launches)
    assert all(a > n for a, n in zip(after, before)), (before, after)
    (lk, gk), (_, gb), (lp, gp) = (out[k] for k in ("kernel", "plain_bf16",
                                                    "plain"))
    assert math.isfinite(lk) and abs(lk - lp) <= 1e-2 * abs(lp)
    for n in gp:
        rel = ((gk[n] - gp[n]).norm() / gp[n].norm()).item()
        rel_bf16 = ((gb[n] - gp[n]).norm() / gp[n].norm()).item()
        assert rel <= max(5e-2, 1.5 * rel_bf16), (n, rel, rel_bf16)


@pytest.mark.cuda
def test_forward_coord_runs_every_kernel(cuda):
    """The small coord slice on the card goes through the sweep, the conv
    kernel's coord mode (17 launches with the layer norm fused) and the
    render, and matches its
    all-plain f32 twin to the bf16 bound of chip_smoke.py."""
    cfg = entry.flagship_cfg(height=H, width=W, num_psv_planes=P,
                             num_msi_planes=P, ngf=NGF, coord_net=True)
    b = entry.synthetic_batch(cfg, 1, cuda)
    params = entry.make_params(cfg, seed=2, device=cuda)
    before = (sweep_ops.launches, conv_ops.coord_launches,
              conv_ops.norm_launches, render_ops.launches)
    out = entry.forward(params, b)
    torch.cuda.synchronize()
    after = (sweep_ops.launches, conv_ops.coord_launches,
             conv_ops.norm_launches, render_ops.launches)
    assert all(a > n for a, n in zip(after, before))
    assert after[1] - before[1] == 18 and after[2] - before[2] == 17
    assert torch.isfinite(out).all()
    err = (out - entry.forward_plain(params, b)).abs().max().item()
    assert err <= 2e-2, err


#: The probe kernels' row shapes: the tools' own, then odd ones (W = 1, 33,
#: 1000; row counts that fill no whole 256-thread block).
PROBE_SHAPES = [(8, 256), (8, 640), (3, 1, 256), (5, 1), (257, 33),
                (7, 1000)]


def _probe_shifts(w):
    return (-w - 1, -1, 0, 1, 5, 123, w, 2 * w + 3)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [(8, 128), (1,), (33,), (1000,), (3, 257)])
def test_probe_trig_kernel_matches_plain(cuda, n):
    """K8a: the kernel's precise atan2f and sqrtf against the plain version
    on the card (the same atan2f; x*x + 1 rounded once there by fmaf,
    twice here): within 2 ulp; x ~ N(0, 1) and some large |x|."""
    from matryodshka_tpu_torch.ops import probes
    rng = np.random.RandomState(16)
    xn = (rng.randn(*n) * rng.choice([1.0, 1e3], size=n)).astype(np.float32)
    x = torch.from_numpy(xn).to(cuda)
    before = probes.trig_launches
    got = probes.trig(x)
    assert probes.trig_launches == before + 1
    assert probes.ulp_error(got, probes.trig_plain(x)) <= 2


@pytest.mark.cuda
@pytest.mark.parametrize("shape", PROBE_SHAPES,
                         ids=["x".join(map(str, s)) for s in PROBE_SHAPES])
@pytest.mark.parametrize("dtype", DTYPES)
def test_probe_roll_kernel_matches_plain(cuda, dtype, shape):
    """K8b/K8c: the roll by a run-time shift, bit-exact against torch.roll
    for shifts negative, 0, W and beyond; each call counts one launch of
    its type."""
    from matryodshka_tpu_torch.ops import probes
    x = torch.from_numpy(np.random.RandomState(17).randn(*shape).astype(
        np.float32)).to(cuda, dtype)
    bf16 = dtype == torch.bfloat16
    for s in _probe_shifts(shape[-1]):
        before = (probes.roll_launches, probes.roll_bf16_launches)
        got = probes.roll(x, s)
        assert (probes.roll_launches, probes.roll_bf16_launches) == (
            before[0] + (not bf16), before[1] + bf16)
        assert got.dtype == dtype
        assert torch.equal(got, probes.roll_plain(x, s)), s


@pytest.mark.cuda
@pytest.mark.parametrize("shape", PROBE_SHAPES + [(2, 20000)],
                         ids=["x".join(map(str, s))
                              for s in PROBE_SHAPES + [(2, 20000)]])
def test_probe_window_shift_kernel_matches_plain(cuda, shape):
    """K9: the left shift through shared memory, bit-exact against
    torch.roll(x, -s), at the tool's 20 shifts and the odd ones (20000
    values a row: 160 KB of shared memory, above the 48 KB default)."""
    from matryodshka_tpu_torch.ops import probes
    w = shape[-1]
    x = torch.from_numpy(np.random.RandomState(18).rand(*shape).astype(
        np.float32)).to(cuda)
    shifts = sorted(set(range(0, w, 13)) | set(_probe_shifts(w)))
    before = probes.window_shift_launches
    for s in shifts:
        assert torch.equal(probes.window_shift(x, s),
                           probes.window_shift_plain(x, s)), s
    assert probes.window_shift_launches == before + len(shifts)


@pytest.mark.cuda
def test_probe_tool_launches_every_probe_kernel(cuda, capsys):
    """python -m matryodshka_tpu_torch.tools.probes with no flag: the four
    probes on the card, each through its kernel."""
    from matryodshka_tpu_torch.ops import probes
    from matryodshka_tpu_torch.tools import probes as probes_tool
    names = ("trig_launches", "roll_launches", "roll_bf16_launches",
             "window_shift_launches")
    before = [getattr(probes, n) for n in names]
    assert probes_tool.main([]) == 0
    after = [getattr(probes, n) for n in names]
    assert [a - b for a, b in zip(after, before)] == [1, 3, 1, 20]
    assert "[shift] 20 shifts bit-exact" in capsys.readouterr().out


# ---------------------------------------------------------------------------
# E-LPIPS and the evaluator's metrics: no kernel of the port (cuDNN convs
# in float32); the card against the CPU.
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("scale", [1, 2, 8])
@pytest.mark.parametrize("swap", [False, True])
def test_elpips_card_matches_cpu(cuda, scale, swap):
    """At one draw (its dropout masks hash to the same bits on both
    devices): the distance within 1e-4 relative and the input gradient
    within relative L2 1e-3 of the CPU's (chip_smoke.py path 7's gates),
    with TF32 allowed globally: the metric keeps its own convs, forward
    and backward, in float32 and leaves the global flag as it was."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        metric = elpips_api.Metric(elpips_api.elpips_vgg(batch_size=1))
    card = copy.deepcopy(metric).to(cuda)
    rng = np.random.RandomState(scale)
    pred, tgt = (torch.from_numpy(rng.uniform(-1, 1, (1, 128, 256, 3))
                                  .astype(np.float32)) for _ in range(2))
    draw = metric.draw(1, torch.Generator().manual_seed(scale), scale=scale,
                       swap=swap)
    out = {}
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
        for dev, m in (("cpu", metric), (cuda, card)):
            x = pred.to(dev, copy=True).requires_grad_(True)
            d = m(x, tgt.to(dev), draws=[elpips_api.Draw(draw.params,
                                                         draw.seed)])
            d.sum().backward()
            out[str(dev)] = (d.item(), x.grad.cpu())
        assert torch.backends.cudnn.allow_tf32
    finally:
        torch.backends.cudnn.allow_tf32 = prev
    (dc, gc), (dg, gg) = out["cpu"], out[str(cuda)]
    assert abs(dg - dc) <= 1e-4 * abs(dc), (dg, dc)
    rel = ((gg - gc).norm() / gc.norm()).item()
    assert rel <= 1e-3 and math.isfinite(rel), rel


@pytest.mark.cuda
def test_eval_metrics_card_match_cpu(cuda):
    """SSIM within 1e-5, PSNR within 1e-4 dB, the temporal diff within
    1e-6 (chip_smoke.py path 8's gates) on a 320x640 image pair."""
    rng = np.random.RandomState(0)
    a = rng.rand(320, 640, 3).astype(np.float32)
    b = np.clip(a + 0.05 * rng.randn(320, 640, 3), 0, 1).astype(np.float32)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    ca, cb = ta.to(cuda), tb.to(cuda)
    assert abs(float(eval_metrics.ssim(ca, cb))
               - float(eval_metrics.ssim(ta, tb))) <= 1e-5
    assert abs(float(eval_metrics.psnr(ca, cb))
               - float(eval_metrics.psnr(ta, tb))) <= 1e-4
    assert abs(float(eval_metrics.temporal_diff(ca, cb))
               - float(eval_metrics.temporal_diff(ta, tb))) <= 1e-6


@pytest.mark.cuda
def test_reg_train_step_kernel_route_matches_plain(cuda):
    """One train step with the transform-inverse regularizer (K1 for the
    unjittered forward, the gather sweep for the jittered one, K7 in both
    forwards and the backward) on the card against the all-plain f32
    route from the same parameters at one fixed jitter pose: the gate of
    test_train_step_kernel_route_matches_plain; K1 launched once, the
    gather sweep once, each K7 form twice as often as without the
    regularizer."""
    from matryodshka_tpu_torch.geometry import cameras
    from matryodshka_tpu_torch.geometry import sweep as sweep_lib
    from matryodshka_tpu_torch.ops import wrap_conv as wc
    from matryodshka_tpu_torch.training import state as state_lib
    from matryodshka_tpu_torch.training import step as step_lib
    cfg = entry.flagship_cfg(height=H, width=W, num_psv_planes=P,
                             num_msi_planes=P, transform_inverse_reg=True)
    b = entry.synthetic_batch(cfg, 4, cuda, tgt_pos=(0.03, 0.01, -0.02))
    state = state_lib.init_state(cfg, 5, cuda)
    pose = cameras.random_jitter_pose(torch.Generator().manual_seed(2),
                                      device=cuda)

    def plain(dtype):
        net = MSIUNet(cfg.num_net_inputs(), cfg.num_net_outputs(), cfg.ngf,
                      dtype=dtype).to(cuda)
        net.load_state_dict(state.net.state_dict())

        def sweep(c, bq, d):
            images, rowp = sweep_ops.sweep_inputs(
                msi_lib.preprocess_image(bq["ref_image"]),
                msi_lib.preprocess_image(bq["src_image"]), d,
                bq["intrinsics"])
            return sweep_ops.ods_sweep_plain(images, rowp, dtype)
        return net, sweep

    def counts():
        torch.cuda.synchronize()
        return (sweep_ops.launches, sweep_lib.gather_sweeps,
                wc.k7a_launches, wc.k7b_launches, wc.k7c_launches,
                wc.wgrad_launches)

    before = counts()
    base_cfg = entry.flagship_cfg(height=H, width=W, num_psv_planes=P,
                                  num_msi_planes=P)
    step_lib.make_loss_fn(base_cfg, state.net)(b)[0].backward()
    base = [a - n for a, n in zip(counts(), before)]
    assert base[:2] == [1, 0] and min(base[2:]) > 0, base
    out = {}
    for key, (net, sweep) in (("kernel", (state.net, None)),
                              ("plain_bf16", plain(torch.bfloat16)),
                              ("plain", plain(torch.float32))):
        net.zero_grad(set_to_none=True)
        before = counts()
        loss, aux = step_lib.make_loss_fn(cfg, net, sweep)(b, jitter_pose=pose)
        loss.backward()
        if key == "kernel":
            got = [a - n for a, n in zip(counts(), before)]
            assert got == [1, 1] + [2 * n for n in base[2:]], (got, base)
        out[key] = (loss.item(), {n: p.grad.float()
                                  for n, p in net.named_parameters()})
        assert float(aux["enforcement_loss"]) > 0
    (lk, gk), (_, gb), (lp, gp) = (out[k] for k in ("kernel", "plain_bf16",
                                                    "plain"))
    assert math.isfinite(lk) and abs(lk - lp) <= 1e-2 * abs(lp)
    for n in gp:
        rel = ((gk[n] - gp[n]).norm() / gp[n].norm()).item()
        rel_bf16 = ((gb[n] - gp[n]).norm() / gp[n].norm()).item()
        assert rel <= max(5e-2, 1.5 * rel_bf16), (n, rel, rel_bf16)


def _k7_counts():
    from matryodshka_tpu_torch.ops import wrap_conv as wc
    torch.cuda.synchronize()
    return (sweep_ops.launches, wc.k7a_launches, wc.k7b_launches,
            wc.k7c_launches, wc.wgrad_launches)


def _step_grads(cfg, net, b, sweep=None):
    """(loss, {name: gradient}, launches (K1, K7a, K7b, K7c, wgrad)) of one
    loss and backward of cfg's trainer."""
    from matryodshka_tpu_torch.training import step as step_lib
    net.zero_grad(set_to_none=True)
    before = _k7_counts()
    loss, _ = step_lib.make_loss_fn(cfg, net, sweep)(b)
    loss.backward()
    got = [a - n for a, n in zip(_k7_counts(), before)]
    return loss.item(), {n: p.grad.detach().clone()
                         for n, p in net.named_parameters()}, got


@pytest.mark.cuda
def test_remat_train_step_reruns_the_k7_forward(cuda):
    """remat_network on the card (ngf 64, so K7b and K7c both run): the
    K7b and K7c forwards launch twice as often as without it (the net's
    forward recomputed in the backward), dgrad (K7a) and wgrad as often;
    the loss and every gradient equal the step without it, within what
    two runs of that step differ by (bit-equal where the card's
    algorithms are deterministic)."""
    import dataclasses

    from matryodshka_tpu_torch.training import state as state_lib
    cfg = entry.flagship_cfg(height=H, width=W, num_psv_planes=P,
                             num_msi_planes=P)
    b = entry.synthetic_batch(cfg, 4, cuda, tgt_pos=(0.03, 0.01, -0.02))
    state = state_lib.init_state(cfg, 5, cuda)
    l0, g0, n0 = _step_grads(cfg, state.net, b)
    l1, g1, _ = _step_grads(cfg, state.net, b)
    rcfg = dataclasses.replace(cfg, remat_network=True)
    lr, gr, nr = _step_grads(rcfg, state.net, b)
    assert nr[0] == n0[0] == 1 and nr[1] == n0[1] and nr[4] == n0[4]
    assert nr[2] == 2 * n0[2] > 0 and nr[3] == 2 * n0[3] > 0, (n0, nr)
    assert abs(lr - l0) <= abs(l1 - l0)
    for n in g0:
        noise = (g1[n] - g0[n]).abs().max().item()
        assert (gr[n] - g0[n]).abs().max().item() <= 2 * noise, n


@pytest.mark.cuda
def test_hrestgt_train_step_sweeps_twice(cuda):
    """tgt_hrestgt on the card (32x64, 128x256 high res): K1 launched twice
    a step, the second time at the high-res size; the loss and gradients
    of the kernel route against the all-plain f32 route's (the plain
    identity-pose sweep at both sizes, the plain net), the gate of
    test_train_step_kernel_route_matches_plain."""
    from matryodshka_tpu_torch.training import state as state_lib
    cfg = entry.flagship_cfg(height=H, width=W, num_psv_planes=P,
                             num_msi_planes=P, supervision="tgt_hrestgt",
                             hres_height=128, hres_width=256)
    b = entry.synthetic_batch(cfg, 4, cuda, tgt_pos=(0.03, 0.01, -0.02))
    g = torch.Generator().manual_seed(6)
    for k in ("ref", "src", "tgt"):
        b[f"hres_{k}_image"] = torch.rand((1, 128, 256, 3),
                                          generator=g).to(cuda)
    state = state_lib.init_state(cfg, 5, cuda)
    shapes = []
    real = sweep_ops.sweep_volume

    def spy(ref, *a, **k):
        shapes.append(tuple(ref.shape[1:3]))
        return real(ref, *a, **k)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(sweep_ops, "sweep_volume", spy)
        lk, gk, nk = _step_grads(cfg, state.net, b)
    assert shapes == [(H, W), (128, 256)] and nk[0] == 2, (shapes, nk)

    def plain(dtype):
        net = MSIUNet(cfg.num_net_inputs(), cfg.num_net_outputs(), cfg.ngf,
                      dtype=dtype).to(cuda)
        net.load_state_dict(state.net.state_dict())

        def sweep(c, bq, d):
            images, rowp = sweep_ops.sweep_inputs(
                msi_lib.preprocess_image(bq["ref_image"]),
                msi_lib.preprocess_image(bq["src_image"]), d,
                bq["intrinsics"])
            return sweep_ops.ods_sweep_plain(images, rowp, dtype)
        return net, sweep

    net_b, sweep_b = plain(torch.bfloat16)
    _, gb, _ = _step_grads(cfg, net_b, b, sweep_b)
    net_p, sweep_p = plain(torch.float32)
    lp, gp, _ = _step_grads(cfg, net_p, b, sweep_p)
    assert math.isfinite(lk) and abs(lk - lp) <= 1e-2 * abs(lp)
    for n in gp:
        rel = ((gk[n].float() - gp[n]).norm() / gp[n].norm()).item()
        rel_bf16 = ((gb[n].float() - gp[n]).norm() / gp[n].norm()).item()
        assert rel <= max(5e-2, 1.5 * rel_bf16), (n, rel, rel_bf16)


@pytest.mark.cuda
def test_rerenders_card_match_cpu(cuda):
    """The test CLI's perspective windows and ODS-eye re-renders (gathers,
    no kernel of the port) on the card against the same function on the
    CPU from the same bf16 rgba_layers: within 1e-4 on [0, 1] images
    (float32 lookups whose transcendentals differ by an ulp between the
    two devices, times the layers' slopes)."""
    from matryodshka_tpu_torch.cli import test as cli_test
    cfg, b = _batch(cuda, 3)
    params = entry.make_params(cfg, seed=1, device=cuda)
    outputs = "rgba_layers_psp_src_output_image_ref_output_image"
    got = cli_test.build_infer_fn(cfg, params, outputs)(b)
    cpu_b = {k: v.cpu() for k, v in b.items()}
    want = cli_test.rerender(cfg, got["rgba_layers"].cpu(), cpu_b,
                             params.msi_depths.cpu(), outputs)
    assert sorted(want) == sorted(k for k in got if k != "rgba_layers")
    for k, v in want.items():
        assert torch.isfinite(got[k]).all()
        err = (got[k].cpu() - v).abs().max().item()
        assert err <= 1e-4, (k, err)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_export_round_trip_on_the_card(cuda, tmp_path, dtype):
    """cli/export.main (coord net, net only, --platform cuda) writes a
    program that torch.export.load runs on the card within 1e-6 of the
    eager plain net's atlas in both dtypes (the same operations; cuDNN
    may pick another algorithm for the loaded graph), on an input drawn
    from a seeded torch.Generator. The kernel route's prediction
    (ops/net.unet_forward, the conv kernel's coord mode, 18 launches) is
    held to the float32 plain net's atlas: in float32 within 2e-2 of the
    program, in bf16 within max(2e-2, 1.5 x the bf16 program's distance
    from float32) (chip_smoke.py path 11's rule). The two bf16 routes are
    not held to each other: each rounds every activation of 18 layers in
    other places, and their distances from float32 add (PERF.md section
    7 gives the measured spread over seeds)."""
    from matryodshka_tpu_torch import weights
    from matryodshka_tpu_torch.cli import export as export_cli
    from matryodshka_tpu_torch.models.unet import atlas_pack
    flags = ["--height", str(H), "--width", str(W), "--num_psv_planes",
             str(P), "--num_msi_planes", str(P), "--ngf", str(NGF),
             "--compute_dtype", dtype, "--coord_net", "true", "--net_only",
             "true", "--export_dir", str(tmp_path), "--checkpoint_dir",
             str(tmp_path / "none")]
    with pytest.warns(UserWarning, match="no checkpoint"):
        path = export_cli.main(flags)
    cfg = export_cli.config_from_args(export_cli.build_parser().parse_args(
        flags))
    gen = torch.Generator(device=cuda).manual_seed(0)
    x = torch.rand(1, H, W, cfg.num_net_inputs(), generator=gen, device=cuda)
    tree = weights.seeded_init(cfg, 0)
    with torch.no_grad():
        got = torch.export.load(path).module()(x)
        want = export_cli.build_net_only_fn(cfg, tree, cuda)(x)
        assert (got - want).abs().max().item() <= 1e-6
        want32 = export_cli.build_net_only_fn(
            dataclasses.replace(cfg, compute_dtype="float32"), tree, cuda)(x)
        params = entry.make_params(cfg, flax_params=tree, device=cuda)
        before = conv_ops.coord_launches
        pred = net_ops.unet_forward(params.stages, x.permute(0, 3, 1, 2).to(
            cfg.torch_compute_dtype).contiguous())
        torch.cuda.synchronize()
        assert conv_ops.coord_launches - before == 18
        kern = atlas_pack(pred.permute(0, 2, 3, 1), H, W,
                          min(64, cfg.num_net_outputs()))
    if dtype == "float32":
        assert (got - kern).abs().max().item() <= 2e-2
    else:
        spread = (got - want32).abs().max().item()
        err = (kern - want32).abs().max().item()
        assert err <= max(2e-2, 1.5 * spread), (err, spread)


# ---------------------------------------------------------------------------
# The layer-stack render's partial mode, the shell-sharded high-res render
# and the GCN's kernel route.
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("blocks", [1, 2, 4])
@pytest.mark.parametrize("rot_deg", [0.0, 40.0])
@pytest.mark.parametrize("dtype", DTYPES)
def test_render_layers_partial_matches_plain(cuda, dtype, rot_deg, blocks):
    """The partial mode per block of 8 shells, one launch each, against
    render_layers_partial_plain fed the kernel's own lookups (1e-5, the
    render-layer gates); the blocks' partials combined against the full
    back-to-front render, and one block bit for bit the full render."""
    from matryodshka_tpu_torch.parallel import sharded_render
    p = 8
    layers = _stack(cuda, dtype, 2, p, H, W)
    pose, pos, _ = _target(cuda, rot_deg)
    radii = torch.linspace(20.0, 1.0, p, device=cuda)
    target = (pose.expand(2, 4, 4), torch.cat([pos, -pos]), radii)
    parts = []
    for p0, p1 in sharded_render.shell_blocks(p, blocks):
        blk = layers[:, p0:p1].contiguous()
        before = rl_ops.partial_launches
        got = rl_ops.render_layers_partial(blk, *target[:2], radii[p0:p1],
                                           p0, p)
        assert rl_ops.partial_launches == before + 1
        u, v = render_ops.uv_project(*target[:2], radii[p0:p1], H, W)
        want = rl_ops.render_layers_partial_plain(blk, u, v, p0, p)
        for g, wnt in zip(got, want):
            assert g.shape == wnt.shape
            assert (g - wnt).abs().max().item() <= 1e-5
        parts.append(got)
    c, d, t = (torch.stack(x) for x in zip(*parts))
    full = rl_ops.render_layers_both(layers, *target)
    for g, wnt in ((sharded_render.combine_partials(c, t), full[0]),
                   (sharded_render.combine_partials(d, t), full[1])):
        assert (g - wnt).abs().max().item() <= 1e-5
    if blocks == 1:
        assert torch.equal(parts[0][0], full[0])
        assert torch.equal(parts[0][1], full[1])


@pytest.mark.cuda
def test_hres_render_shell_blocks_match_unsharded(cuda):
    """The test CLI's high-res re-render in 4 shell blocks in one process
    (4 assembled-sweep and 4 partial-mode launches) against the unsharded
    render."""
    from matryodshka_tpu_torch.cli import test as cli_test
    cfg = entry.flagship_cfg(height=H, width=W, num_psv_planes=8,
                             num_msi_planes=8, ngf=NGF, hres_height=2 * H,
                             hres_width=2 * W, min_depth=2.0, max_depth=20.0)
    rng = np.random.RandomState(11)

    def t(*shape):
        return torch.from_numpy(rng.rand(*shape).astype(np.float32)).to(cuda)

    eye = torch.eye(4, device=cuda)[None]
    intr = torch.eye(3, device=cuda)[None].clone()
    intr[0, 0, 0] = 0.032
    args = (t(1, 2 * H, 2 * W, 3), t(1, 2 * H, 2 * W, 3), t(1, H, W, 8),
            t(1, H, W, 8), eye, eye, eye, intr,
            torch.tensor([[0.02, 0.01, -0.015]], device=cuda))
    whole = cli_test.build_hres_render_fn(cfg)(*args)
    sweeps, parts = sweep_ops.assembled_launches, rl_ops.partial_launches
    blocks = cli_test.build_hres_render_fn(cfg, shards=4)(*args)
    assert sweep_ops.assembled_launches - sweeps == 4
    assert rl_ops.partial_launches - parts == 4
    for g, wnt in zip(blocks, whole):
        assert (g - wnt).abs().max().item() <= 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("scheme", ["blend_psv", "blend_bg"])
def test_gcn_infer_fn_matches_plain(cuda, scheme, tmp_path):
    """cli.test.build_infer_fn with gcn=True on the card (K1, then K3 for
    blend_psv or the prepared assembly and one layer-stack launch) against
    its all-plain twin, image and depth, and its launches."""
    from matryodshka_tpu_torch.cli import test as cli_test
    cfg = entry.flagship_cfg(height=H, width=W, num_psv_planes=P,
                             num_msi_planes=P, ngf=NGF, gcn=True, subdiv=2,
                             mesh_dir=str(tmp_path), which_color_pred=scheme)
    params = entry.make_params(cfg, seed=3, device=cuda)
    b = entry.synthetic_batch(cfg, 2, cuda, tgt_pos=(0.03, -0.01, 0.02))
    counts = (sweep_ops.launches, render_ops.launches, rl_ops.launches)
    got = cli_test.build_infer_fn(cfg, params, "tgt_image")(b)
    torch.cuda.synchronize()
    d = [a - n for a, n in zip((sweep_ops.launches, render_ops.launches,
                                rl_ops.launches), counts)]
    assert d == ([1, 1, 0] if scheme == "blend_psv" else [1, 0, 1])
    want = cli_test.infer_plain(cfg, params, b)
    for k in ("output_image", "output_depth"):
        assert (got[k] - want[k]).abs().max().item() <= 1e-4, k


# ---------------------------------------------------------------------------
# The sweep's assembled mode (csrc/sweep_assembled.cu).
# ---------------------------------------------------------------------------

def bf16_ulps(got, want):
    """|got - want| in bf16 steps (ulps), elementwise, of two bf16
    tensors: their bit patterns as ordered integers."""
    def ordered(x):
        i = x.view(torch.int16).to(torch.int32)
        return torch.where(i < 0, -(i & 0x7FFF), i)
    return (ordered(got) - ordered(want)).abs()


def _assembled_case(dev, hh, hw, p, seed=21):
    """The batch's high-res pair [1, hh, hw, 3] in [0, 1], the low-res
    (hh/2 x hw/2) alphas and blend weights [1, ., ., p] in [0, 1] and
    background colour in [-1, 1], the depths (1 m to 100 m) and
    intrinsics."""
    from matryodshka_tpu_torch.geometry import sweep as sweep_lib
    gen = torch.Generator(device=dev).manual_seed(seed)

    def rand(*shape):
        return torch.rand(shape, generator=gen, device=dev)

    depths = torch.tensor(sweep_lib.inv_depths(1.0, 100.0, p),
                          dtype=torch.float32, device=dev)
    intr = torch.eye(3, device=dev)[None].clone()
    intr[0, 0, 0] = 0.032
    return (rand(1, hh, hw, 3), rand(1, hh, hw, 3), depths, intr,
            rand(1, hh // 2, hw // 2, p), rand(1, hh // 2, hw // 2, p),
            rand(1, hh // 2, hw // 2, 3) * 2 - 1)


#: (high-res rows, columns, shells, the block's first and last shell): the
#: flagship's whole stack at 640x320, the re-render's at 4096x2048 and one
#: of its four shell blocks.
ASSEMBLED_CASES = [(320, 640, 32, 0, 32), (2048, 4096, 32, 0, 32),
                   (2048, 4096, 32, 8, 16)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("rule", ["alpha_only", "blend_psv", "blend_bg"])
@pytest.mark.parametrize("case", ASSEMBLED_CASES)
def test_sweep_assembled_matches_plain(cuda, case, rule, dtype):
    """One launch of the assembled mode against sweep_assembled_plain
    (compared four shells at a time) fed the kernel's own row parameters
    (sweep_row_params: K1's projection, held to float64 by the sweep
    gates): the same taps, upsample and rule, each rounded once in f32 but
    in other orders: 1e-5
    on values in [-1, 1] in f32; in bf16 both round the f32 stack once, so
    every value lies within one bf16 step, or, near 0, where a bf16 step
    is finer than the two f32 sums' difference, within that f32 bound (the
    shares one step off and beyond it are printed). Two launches are
    bit-identical."""
    hh, hw, p, p0, p1 = case
    ref, src, depths, intr, alphas, blend, bg = _assembled_case(cuda, hh,
                                                                 hw, p)
    args = (ref, src, depths[p0:p1].contiguous(), intr, alphas, blend, bg)
    n = sweep_ops.assembled_launches
    got = sweep_ops.sweep_assembled(*args, rule=rule, p0=p0, out_dtype=dtype)
    assert sweep_ops.assembled_launches == n + 1
    assert got.shape == (1, p1 - p0, hh, hw, 4) and got.dtype == dtype
    assert torch.equal(got, sweep_ops.sweep_assembled(
        *args, rule=rule, p0=p0, out_dtype=dtype))
    off = near0 = 0
    for q in range(p0, p1, 4):
        dq = depths[q:q + 4].contiguous()
        want = sweep_ops.sweep_assembled_plain(
            ref, src, dq, intr, alphas, blend, bg, rule, q, dtype,
            sweep_ops.sweep_row_params(dq, intr, hh, hw))
        mine = got[:, q - p0:q - p0 + 4]
        if dtype == torch.float32:
            assert (mine - want).abs().max().item() <= 1e-5, q
        else:
            ulps = bf16_ulps(mine, want)
            small = (mine.float() - want.float()).abs() <= 1e-5
            assert torch.where(small, 0, ulps).max().item() <= 1, q
            off += int((ulps == 1).sum())
            near0 += int(((ulps > 1) & small).sum())
    if dtype == torch.bfloat16:
        print(f"assembled {hw}x{hh} shells {p0}..{p1 - 1} {rule}: "
              f"{off / got.numel():.3e} of the values one bf16 step off, "
              f"{near0 / got.numel():.3e} more near 0 within 1e-5")


@pytest.mark.cuda
def test_hres_rerender_launches(cuda):
    """A re-render at 4096x2048 is one assembled-sweep launch and one K5
    launch (image and depth); in 4 shell blocks one of each a block (the
    partial mode); no K1 volume and no lookup table."""
    from matryodshka_tpu_torch.cli import test as cli_test
    cfg = entry.flagship_cfg(which_color_pred="blend_bg")
    hh, hw, p = cfg.hres_height, cfg.hres_width, cfg.num_psv_planes
    ref, src, _, intr, alphas, blend, bg = _assembled_case(cuda, hh, hw, p)
    small = [torch.nn.functional.interpolate(
        x.permute(0, 3, 1, 2), size=(cfg.height, cfg.width)).permute(
        0, 2, 3, 1).contiguous() for x in (alphas, blend, bg)]
    eye = torch.eye(4, device=cuda)[None]
    pos = torch.tensor([[0.02, 0.01, -0.015]], device=cuda)
    counts = ((sweep_ops, "assembled_launches"), (sweep_ops, "launches"),
              (rl_ops, "launches"), (rl_ops, "partial_launches"),
              (render_lib, "uv_builds"))
    for shards, want in ((1, [1, 0, 1, 0, 0]), (4, [4, 0, 0, 4, 0])):
        before = [getattr(m, c) for m, c in counts]
        rgb, depth = cli_test.build_hres_render_fn(cfg, shards)(
            ref, src, small[1], small[0], eye, eye, eye, intr, pos,
            bg_rgb=small[2])
        torch.cuda.synchronize()
        assert [getattr(m, c) - n for (m, c), n in zip(counts, before)] \
            == want
        assert torch.isfinite(rgb).all() and torch.isfinite(depth).all()
