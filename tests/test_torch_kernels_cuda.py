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
from matryodshka_tpu_torch.ops import layernorm as ln_ops
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


#: Single conv layers at the edges of the kernel's tiles: (id, B, Cin, H,
#: W, Cout, conv arguments; coord=True appends the coord channel). Heads of
#: 67, 99 and 32 channels (Cout not a multiple of 8, or of the 64-channel
#: tile); pixel counts that fill no whole tile (Wo = 80, 200); W = 5, so
#: the wrap crosses every tile; Cin' = Cin + 1 (coord) and Cin = 96 (a
#: k-block past Cin' in every tap); stride 2, dilation 2, the npar=4
#: parity deconv in both paddings; B = 2; the conv4 shape (512 -> 512 at
#: 40x80, the 64x64 tile) and a shape that takes the 64x128 tile.
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
    ("conv4", 1, 512, 40, 80, 512, dict(kh=3, kw=3, dil=2, pad=2)),
    ("tile128", 2, 32, 96, 200, 64, dict(kh=3, kw=3, pad=1)),
]
#: The tensor-core tile each of these must take (Cout x pixels).
EDGE_TILES = {"conv4": "mma.sync 64x64", "tile128": "mma.sync 64x128"}


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
    pack = conv_ops.pack_deconv if taps == 16 else conv_ops.pack_conv
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
    layers, whose K is at most 4,608); in bf16 (tensor cores) both sides
    round once and may land one bf16 step apart (2^-7 of the scale)."""
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
        if case in EDGE_TILES and dtype == torch.bfloat16:
            npar = args.get("npar", 1)
            ho, wo = conv_ops.out_size(x.shape[2], x.shape[3], args["kh"],
                                       args["kw"], args.get("stride", 1),
                                       args.get("dil", 1),
                                       args.get("pad", 0), npar)
            assert conv_ops.tile_config(x.shape[0], npar, ho, wo,
                                        wk.shape[2], dtype) == \
                EDGE_TILES[case]


#: Layer-norm shapes (B, C, H, W) and the form each takes on an H100: the
#: original batch-2 case; one example on chip; odd sizes (not a whole
#: number of 16-byte vectors: the scalar path) in both forms; conv1_1's
#: output, on chip in bf16 and two-pass in f32 (too large for shared
#: memory).
LN_CASES = {
    "batch2": ((2, 16, 24, 40), "two_pass", "two_pass"),
    "onchip": ((1, 16, 24, 40), "onchip", "onchip"),
    "odd_onchip": ((1, 3, 5, 7), "onchip", "onchip"),
    "odd_batch3": ((3, 3, 5, 7), "two_pass", "two_pass"),
    "conv1_1": ((1, 64, 320, 640), "onchip", "two_pass"),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(LN_CASES))
@pytest.mark.parametrize("dtype", DTYPES)
def test_layernorm_kernel_matches_plain(cuda, dtype, case):
    """f64 partial sums against a two-pass f32 mean/variance: 1e-5 of the
    output scale in f32; in bf16 both sides round once (one bf16 step,
    2^-7 of the scale). Each case takes the form the shape asks for, two
    launches give bit-identical outputs, and each call counts one
    launch."""
    shape, form_bf16, form_f32 = LN_CASES[case]
    rng = np.random.RandomState(7)
    x = torch.from_numpy((rng.randn(*shape) * 2 + 0.5).astype(
        np.float32)).to(cuda, dtype)
    gamma = torch.from_numpy(rng.randn(shape[1]).astype(np.float32)).to(cuda)
    beta = torch.from_numpy(rng.randn(shape[1]).astype(np.float32)).to(cuda)
    assert ln_ops.plan_for(x)[0] == (form_f32 if dtype == torch.float32
                                     else form_bf16)
    before = ln_ops.launches
    got = ln_ops.layer_norm_relu(x, gamma, beta)
    again = ln_ops.layer_norm_relu(x, gamma, beta)
    torch.cuda.synchronize()
    assert ln_ops.launches == before + 2
    assert torch.equal(got, again)
    want = ln_ops.layer_norm_relu_plain(x, gamma, beta).float()
    tol = (1e-5 if dtype == torch.float32 else 2.0 ** -7) * \
        want.abs().max().item()
    assert (got.float() - want).abs().max().item() <= tol


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
    """A layer stack [B, P, 4, H, W]: colours uniform in [-1, 1], alphas
    in (0, 1)."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    layers = torch.rand((b, p, 4, h, w), generator=gen, device=dev) * 2 - 1
    layers[:, :, 3] = torch.sigmoid(3.0 * layers[:, :, 3])
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
    """The high-res re-render's case: a bf16 stack of 32 4096x2048 shells
    (2^30 values: 64-bit plane offsets), back to front, every mode."""
    from matryodshka_tpu_torch.geometry import sweep as sweep_lib
    radii = torch.tensor(sweep_lib.inv_depths(1.0, 100.0, 32),
                         dtype=torch.float32, device=cuda)
    pose, pos, _ = _target(cuda, 0.0)
    rgb, depth = _check_layer_stack_modes(
        _stack(cuda, torch.bfloat16, 1, 32, 2048, 4096), (pose, pos, radii),
        False, 2048, 4096)
    assert torch.isfinite(rgb).all() and torch.isfinite(depth).all()


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
    mods = (sweep_ops, conv_ops, ln_ops, render_ops)
    before = [m.launches for m in mods]
    out = entry.forward(params, b)
    torch.cuda.synchronize()
    assert all(m.launches > n for m, n in zip(mods, before))
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
#: channel counts, W = 40 (a k-block half past the row end), a pixel sum
#: that splits unevenly (148 k-blocks in 50 splits of 3), W = 37 and W = 5
#: (not a multiple of 8: the bf16 kernel's scalar loads; W = 5 wraps every
#: tap onto the row).
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
        splits, chunk = wc.wgrad_tc_splits(b, h, w, cout, cin)
        assert splits * chunk > wc.wgrad_tc_kblocks(b, h, w)


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
    kernel's coord mode, the layer norm and the render, and matches its
    all-plain f32 twin to the bf16 bound of chip_smoke.py."""
    cfg = entry.flagship_cfg(height=H, width=W, num_psv_planes=P,
                             num_msi_planes=P, ngf=NGF, coord_net=True)
    b = entry.synthetic_batch(cfg, 1, cuda)
    params = entry.make_params(cfg, seed=2, device=cuda)
    before = (sweep_ops.launches, conv_ops.coord_launches,
              ln_ops.launches, render_ops.launches)
    out = entry.forward(params, b)
    torch.cuda.synchronize()
    after = (sweep_ops.launches, conv_ops.coord_launches,
             ln_ops.launches, render_ops.launches)
    assert all(a > n for a, n in zip(after, before))
    assert after[1] - before[1] == 18
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
