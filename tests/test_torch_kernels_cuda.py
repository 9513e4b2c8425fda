"""The port's CUDA kernels against their plain versions, on the card.

Every test here needs an NVIDIA GPU and nvcc; elsewhere each skips. The
file imports neither JAX nor the JAX package, so it also runs where only
PyTorch is installed:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_kernels_cuda.py

(tests/conftest.py imports JAX, hence --noconftest.) Shapes are small;
chip_smoke.py checks the same pairs at the flagship shapes.
"""

import math

import numpy as np
import pytest
import torch

from matryodshka_tpu_torch import entry
from matryodshka_tpu_torch.geometry import render as render_lib
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


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
def test_sweep_kernel_matches_plain(cuda, dtype):
    """Identical taps and weights: f32 to 1e-5 (FMA contraction only),
    bf16 to one rounding of values in [-1, 1] (2^-8)."""
    cfg, b = _batch(cuda)
    depths = torch.tensor([100.0, 5.0, 1.5, 1.0], device=cuda)
    images, params = sweep_ops.sweep_inputs(
        msi_lib.preprocess_image(b["ref_image"]),
        msi_lib.preprocess_image(b["src_image"]), depths, b["intrinsics"])
    got = sweep_ops.ods_sweep(images, params, dtype).float()
    want = sweep_ops.ods_sweep_plain(images, params, torch.float32)
    tol = 1e-5 if dtype == torch.float32 else 2.0 ** -8
    assert (got - want).abs().max().item() <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
def test_conv_kernel_matches_plain(cuda, dtype):
    """Every stage of the plan on the same (rounded) operands: f32 differs
    in accumulation order (1e-4 of the output scale); in bf16 both sides
    round once and may land one bf16 step apart (2^-7 of the scale)."""
    rng = np.random.RandomState(6)
    net = MSIUNet(2 * P * 3, 2 * P, NGF).to(cuda)
    with torch.no_grad():
        for prm in net.parameters():
            prm.copy_(torch.from_numpy(
                rng.randn(*prm.shape).astype(np.float32) * 0.2))
    for plan, st in zip(net.plan, net_ops.prepare(net, dtype)):
        _, _, _, cins, _, ind, _, _ = plan
        x = torch.from_numpy(rng.uniform(
            -1, 1, (2, sum(cins), H // ind, W // ind)).astype(
                np.float32)).to(cuda, dtype)
        got = conv_ops.conv(x, st["w"], st["b"], **st["args"]).float()
        want = conv_ops.conv_plain(x, st["w"], st["b"],
                                   **st["args"]).float()
        tol = (1e-4 if dtype == torch.float32 else 2.0 ** -7) * \
            want.abs().max().item()
        assert (got - want).abs().max().item() <= tol, plan[0]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
def test_layernorm_kernel_matches_plain(cuda, dtype):
    """f64 partial sums against a two-pass f32 mean/variance: 1e-5 of the
    output scale in f32; in bf16 both sides round once (one bf16 step,
    2^-7 of the scale)."""
    rng = np.random.RandomState(7)
    x = torch.from_numpy((rng.randn(2, 16, 24, 40) * 2 + 0.5).astype(
        np.float32)).to(cuda, dtype)
    gamma = torch.from_numpy(rng.randn(16).astype(np.float32)).to(cuda)
    beta = torch.from_numpy(rng.randn(16).astype(np.float32)).to(cuda)
    got = ln_ops.layer_norm_relu(x, gamma, beta).float()
    want = ln_ops.layer_norm_relu_plain(x, gamma, beta).float()
    tol = (1e-5 if dtype == torch.float32 else 2.0 ** -7) * \
        want.abs().max().item()
    assert (got - want).abs().max().item() <= tol


def _uv(dev, rot_deg, h=H, w=W):
    a = math.radians(rot_deg)
    rt = torch.eye(4, device=dev)[None]
    rt[0, 0, 0], rt[0, 0, 2] = math.cos(a), math.sin(a)
    rt[0, 2, 0], rt[0, 2, 2] = -math.sin(a), math.cos(a)
    radii = torch.tensor([100.0, 5.0, 1.5, 1.0], device=dev)
    return render_lib.uv_tables(rt, torch.tensor([[0.05, 0.0, 0.01]],
                                                 device=dev), radii, h, w)


@pytest.mark.cuda
@pytest.mark.parametrize("depth", [False, True])
@pytest.mark.parametrize("rot_deg", [0.0, 40.0])
@pytest.mark.parametrize("dtype", DTYPES)
def test_render_kernel_matches_plain(cuda, rot_deg, dtype, depth):
    """The same f32 math in another order, plus early termination at
    T < 1e-6: 1e-5 on values in [-1, 1] (colour) and [0, 1) (depth)."""
    rng = np.random.RandomState(8)
    vol = torch.from_numpy(rng.uniform(-1, 1, (1, 6 * P, H, W)).astype(
        np.float32)).to(cuda, dtype)
    pred = torch.from_numpy(np.tanh(rng.randn(1, 2 * P, H, W) * 1.5).astype(
        np.float32)).to(cuda)
    u, v = _uv(cuda, rot_deg)
    n = render_ops.depth_launches if depth else render_ops.launches
    got = render_ops.render_blend(vol, pred, u, v, depth=depth)
    want = render_ops.render_blend_plain(vol, pred, u, v, depth=depth)
    assert (got - want).abs().max().item() <= 1e-5
    assert (render_ops.depth_launches if depth else render_ops.launches) \
        == n + 1


@pytest.mark.cuda
@pytest.mark.parametrize("depth", [False, True])
@pytest.mark.parametrize("ftb", [False, True])
@pytest.mark.parametrize("rot_deg", [0.0, 40.0])
@pytest.mark.parametrize("dtype", DTYPES)
def test_render_layers_kernel_matches_plain(cuda, rot_deg, dtype, ftb,
                                            depth):
    """Back to front (K4/K5) and front to back with early termination at
    T < 1e-6 (K6), colour and depth, against the shell-streamed plain
    composite: the same f32 samples composited in another order, 1e-5 on
    values in [-1, 1]."""
    rng = np.random.RandomState(9)
    layers = rng.uniform(-1, 1, (2, P, 4, H, W)).astype(np.float32)
    layers[:, :, 3] = 1.0 / (1.0 + np.exp(-3.0 * layers[:, :, 3]))
    layers = torch.from_numpy(layers).to(cuda, dtype)
    u, v = _uv(cuda, rot_deg)
    u, v = torch.cat([u, u]), torch.cat([v, v.flip(-1)])
    before = (rl_ops.launches, rl_ops.ftb_launches)
    got = rl_ops.render_layers(layers, u, v, ftb=ftb, depth=depth)
    want = rl_ops.render_layers_plain(layers, u, v, depth=depth)
    assert (got - want).abs().max().item() <= 1e-5
    assert (rl_ops.launches, rl_ops.ftb_launches) == (
        before[0] + (not ftb), before[1] + ftb)


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
