"""The port's U-Net against flax: the plain MSIUNet, the stage-by-stage
unet_forward (plain versions of csrc/conv.cu and csrc/layernorm.cu), and
the weight bridge.

Same weights in both (flax init -> weights.from_flax), same numpy input,
float32, ngf 8 at 32x64. Tolerance atol 5e-5, as tests/test_pallas_net.py
holds the TPU net kernel: 18 float32 layers with per-layer normalization
keep accumulation-order differences around 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from matryodshka_tpu.config import MatryConfig as JaxConfig
from matryodshka_tpu.models import unet as junet
from matryodshka_tpu.training import state as state_lib
from matryodshka_tpu_torch import weights
from matryodshka_tpu_torch.config import MatryConfig
from matryodshka_tpu_torch.models.unet import MSIUNet
from matryodshka_tpu_torch.ops import layernorm as ln_ops
from matryodshka_tpu_torch.ops import net as net_ops

torch.set_num_threads(1)

H, W, P, NGF = 32, 64, 4, 8
ATOL = 5e-5


@pytest.fixture(scope="module")
def flax_net():
    cfg = JaxConfig(height=H, width=W, num_psv_planes=P, num_msi_planes=P,
                    ngf=NGF, compute_dtype="float32").validate()
    state, model = state_lib.init_state(cfg, jax.random.PRNGKey(0))
    params = jax.tree.map(np.asarray, state.params)
    x = np.random.RandomState(0).uniform(
        -1, 1, (1, H, W, cfg.num_net_inputs())).astype(np.float32)
    ref = np.asarray(model.apply(state.params, jnp.asarray(x)))
    return cfg, params, x, ref


def _torch_net(cfg, params):
    net = MSIUNet(cfg.num_net_inputs(), cfg.num_net_outputs(), cfg.ngf,
                  dtype=torch.float32)
    net.load_state_dict(weights.from_flax(params))
    return net


def test_msiunet_matches_flax(flax_net):
    cfg, params, x, ref = flax_net
    net = _torch_net(cfg, params)
    with torch.no_grad():
        got = net(torch.from_numpy(x).permute(0, 3, 1, 2))
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), ref, rtol=0,
                               atol=ATOL)


def test_unet_forward_matches_flax(flax_net):
    """The kernel route (packed weights, parity deconvs, LN+ReLU stage)
    through the plain versions."""
    cfg, params, x, ref = flax_net
    stages = net_ops.prepare(_torch_net(cfg, params), torch.float32)
    got = net_ops.unet_forward(stages,
                               torch.from_numpy(x).permute(0, 3, 1, 2))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), ref, rtol=0,
                               atol=ATOL)


def test_from_flax_maps_every_leaf(flax_net):
    cfg, params, _, _ = flax_net
    sd = weights.from_flax(params)
    n_leaves = len(jax.tree.leaves(params))
    assert len(sd) == n_leaves
    net = MSIUNet(cfg.num_net_inputs(), cfg.num_net_outputs(), cfg.ngf)
    want = net.state_dict()
    assert set(sd) == set(want)
    for k, v in sd.items():
        assert tuple(v.shape) == tuple(want[k].shape), k
    net.load_state_dict(sd, strict=True)


@pytest.mark.parametrize("layer", ["conv1_1", "conv1_2", "conv4_1",
                                   "conv6_1", "color_pred"])
def test_from_flax_kernel_layout(flax_net, layer):
    """[KH, KW, Cin, Cout] -> [Cout, Cin, KH, KW] for the 3x3 convs, the
    stride-2 and dilated ones, the 4x4 transposed conv and the 1x1 head."""
    _, params, _, _ = flax_net
    k = params["params"][layer]["kernel"]
    sd = weights.from_flax(params)
    np.testing.assert_array_equal(sd[f"{layer}.weight"].numpy(),
                                  k.transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(sd[f"{layer}.bias"].numpy(),
                                  params["params"][layer]["bias"])


def test_from_flax_layer_norm_and_unknown_leaf(flax_net):
    _, params, _, _ = flax_net
    sd = weights.from_flax(params)
    ln = params["params"]["conv3_2_ln"]
    np.testing.assert_array_equal(sd["conv3_2_ln.gamma"].numpy(),
                                  ln["gamma"])
    np.testing.assert_array_equal(sd["conv3_2_ln.beta"].numpy(), ln["beta"])
    with pytest.raises(KeyError):
        weights.from_flax({"conv1_1": {"scale": np.zeros(3)}})


def test_seeded_init_has_flax_shapes(flax_net):
    cfg, params, _, _ = flax_net
    tcfg = MatryConfig(height=H, width=W, num_psv_planes=P,
                       num_msi_planes=P, ngf=NGF)
    mine = weights.seeded_init(tcfg, 0)
    shapes = jax.tree.map(np.shape, params)
    assert jax.tree.map(np.shape, mine) == shapes
    again = weights.seeded_init(tcfg, 0)
    np.testing.assert_array_equal(mine["params"]["conv2_1"]["kernel"],
                                  again["params"]["conv2_1"]["kernel"])


def test_seeded_init_matches_flax_scale():
    """lecun_normal: std sqrt(1/fan_in), truncated at 2 sigma (numpy
    draw; the sample std of 36,864 values lies within 3% of it)."""
    tcfg = MatryConfig(height=H, width=W, num_psv_planes=P,
                       num_msi_planes=P, ngf=64)
    k = weights.seeded_init(tcfg, 1)["params"]["conv2_1"]["kernel"]
    flax_k = np.asarray(jax.nn.initializers.lecun_normal()(
        jax.random.PRNGKey(1), k.shape))
    assert abs(k.std() / flax_k.std() - 1.0) < 0.03
    assert np.abs(k).max() <= 2.0 * np.sqrt(1.0 / (9 * 128)) / 0.8796 + 1e-6


def test_layer_norm_relu_matches_flax():
    rng = np.random.RandomState(5)
    x = (rng.randn(2, 6, 5, 7) * 3 + 1).astype(np.float32)
    gamma = rng.randn(7).astype(np.float32)
    beta = rng.randn(7).astype(np.float32)
    ln = junet.SpatialLayerNorm()
    ref = jax.nn.relu(ln.apply({"params": {"gamma": gamma, "beta": beta}},
                               jnp.asarray(x)))
    got = ln_ops.layer_norm_relu_plain(
        torch.from_numpy(x).permute(0, 3, 1, 2), torch.from_numpy(gamma),
        torch.from_numpy(beta))
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(),
                               np.asarray(ref), rtol=0, atol=1e-5)
