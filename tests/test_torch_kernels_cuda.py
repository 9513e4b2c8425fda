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


@pytest.mark.cuda
@pytest.mark.parametrize("rot_deg", [0.0, 40.0])
@pytest.mark.parametrize("dtype", DTYPES)
def test_render_kernel_matches_plain(cuda, rot_deg, dtype):
    """The same f32 math in another order, plus early termination at
    T < 1e-6: 1e-5 on values in [-1, 1]."""
    rng = np.random.RandomState(8)
    vol = torch.from_numpy(rng.uniform(-1, 1, (1, 6 * P, H, W)).astype(
        np.float32)).to(cuda, dtype)
    pred = torch.from_numpy(np.tanh(rng.randn(1, 2 * P, H, W) * 1.5).astype(
        np.float32)).to(cuda)
    a = math.radians(rot_deg)
    rt = torch.eye(4, device=cuda)[None]
    rt[0, 0, 0], rt[0, 0, 2] = math.cos(a), math.sin(a)
    rt[0, 2, 0], rt[0, 2, 2] = -math.sin(a), math.cos(a)
    radii = torch.tensor([100.0, 5.0, 1.5, 1.0], device=cuda)
    u, v = render_lib.uv_tables(rt, torch.tensor([[0.05, 0.0, 0.01]],
                                                 device=cuda), radii, H, W)
    got = render_ops.render_blend(vol, pred, u, v)
    want = render_ops.render_blend_plain(vol, pred, u, v)
    assert (got - want).abs().max().item() <= 1e-5


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
