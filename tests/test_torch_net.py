"""The port's U-Net against flax: the plain MSIUNet, the stage-by-stage
unet_forward (plain versions of csrc/conv.cu, its layer norm fused), and
the weight bridge; and the conv wrapper's two input layouts (NCHW and
channels-last) on the CPU.

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
from matryodshka_tpu_torch.models import msi as msi_lib
from matryodshka_tpu_torch.models.unet import MSIUNet
from matryodshka_tpu_torch.ops import conv as conv_ops
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


# ---------------------------------------------------------------------------
# The conv wrapper's input layouts (ops/conv.conv on CPU tensors).
# ---------------------------------------------------------------------------

CL = torch.channels_last

#: Layers of every form: (name, batch, Cin, H, W, Cout, conv args).
LAYOUT_CASES = [
    ("conv", 2, 16, 8, 32, 8, dict(kh=3, kw=3, pad=1)),
    ("down_zero", 1, 16, 8, 32, 24,
     dict(kh=3, kw=3, stride=2, pad=(0, 1), hpad="zero")),
    ("dil2_coord", 1, 16, 8, 32, 8,
     dict(kh=3, kw=3, dil=2, pad=(2, 2), hpad="zero", coord=True)),
    ("deconv", 2, 16, 8, 16, 8, dict(kh=2, kw=2, npar=4)),
    ("smoothed_zero", 1, 16, 8, 16, 8, dict(kh=3, kw=3, npar=4, hpad="zero")),
    ("head", 1, 16, 8, 32, 5,
     dict(kh=1, kw=1, tanh=True, out_dtype=torch.float32)),
]


def _layout_case(case):
    _, b, cin, h, w, cout, args = next(c for c in LAYOUT_CASES
                                       if c[0] == case)
    args = dict(args)
    rng = np.random.RandomState(sum(map(ord, case)))
    if args.pop("coord", False):
        args["coord"] = conv_ops.coord_column(h)
    kcin = cin + ("coord" in args)
    if args.get("npar") == 4:
        wt = torch.from_numpy(rng.randn(cout, kcin, 4, 4).astype(np.float32))
        wk = (conv_ops.pack_smoothed(wt, torch.bfloat16) if args["kh"] == 3
              else conv_ops.pack_deconv(wt, torch.bfloat16, smoothed=False))
    else:
        wk = conv_ops.pack_conv(torch.from_numpy(rng.randn(
            cout, kcin, args["kh"], args["kw"]).astype(np.float32)),
            torch.bfloat16)
    bias = torch.from_numpy(rng.randn(cout).astype(np.float32))
    x = torch.from_numpy(rng.randn(b, cin, h, w).astype(np.float32)).to(
        torch.bfloat16)
    norm = [conv_ops.Norm(None, torch.from_numpy(1 + 0.1 * rng.randn(
        cin // 2).astype(np.float32)), torch.from_numpy(0.1 * rng.randn(
            cin // 2).astype(np.float32))) for _ in range(2)]
    return x, wk, bias, args, norm


@pytest.mark.parametrize("out_format", ["nchw", "cl"])
@pytest.mark.parametrize("case", [c[0] for c in LAYOUT_CASES])
def test_conv_layouts_give_the_same_values(case, out_format):
    """conv on the CPU, x NCHW and channels-last, with and without a
    two-source layer norm: the same values bit for bit, the output in the
    memory format asked for."""
    x, wk, bias, args, norm = _layout_case(case)
    fmt = CL if out_format == "cl" else torch.contiguous_format
    for nm in (None, norm):
        want = conv_ops.conv(x, wk, bias, **args, norm=nm)
        got = conv_ops.conv(x.contiguous(memory_format=CL), wk, bias,
                            **args, norm=nm, memory_format=fmt)
        assert got.is_contiguous(memory_format=fmt)
        assert torch.equal(got, want)
        y, part = conv_ops.conv(x.contiguous(memory_format=CL), wk, bias,
                                **args, norm=nm, stats=True,
                                memory_format=fmt)
        assert torch.equal(y, want) and part is None


@pytest.mark.parametrize("view", ["strided", "permuted"])
def test_conv_raises_on_neither_layout(view):
    """An input contiguous in neither NCHW nor channels-last format (every
    second column; C and H swapped) raises, as does an unknown output
    format."""
    x, wk, bias, args, _ = _layout_case("conv")
    bad = x[..., ::2] if view == "strided" else \
        x.transpose(1, 2).contiguous().transpose(1, 2)
    with pytest.raises(ValueError, match="contiguous in neither"):
        conv_ops.conv(bad, wk, bias, **args)
    with pytest.raises(ValueError, match="memory_format"):
        conv_ops.conv(x, wk, bias, **args,
                      memory_format=torch.preserve_format)


#: conv's layouts on a CUDA launch (ops/conv.check_layouts): (case, x
#: channels-last, x dtype, with a norm, output dtype, Cout, output
#: channels-last, the (x, output) channels-last flags it returns, or None
#: where it raises).
KERNEL_LAYOUTS = [
    ("net_inner", True, torch.bfloat16, True, torch.bfloat16, 64, True,
     (True, True)),
    ("net_first", False, torch.bfloat16, False, torch.bfloat16, 64, True,
     (False, True)),
    ("net_head", True, torch.bfloat16, True, torch.float32, 67, False,
     (True, False)),
    ("nchw", False, torch.float32, True, torch.float32, 64, False,
     (False, False)),
    ("cl_x_f32", True, torch.float32, True, torch.float32, 64, False, None),
    ("cl_x_without_norm", True, torch.bfloat16, False, torch.bfloat16, 64,
     True, None),
    ("cl_out_f32", True, torch.bfloat16, True, torch.float32, 64, True,
     None),
    ("cl_out_ragged_cout", True, torch.bfloat16, True, torch.bfloat16, 67,
     True, None),
    ("cl_out_of_normed_nchw_x", False, torch.bfloat16, True,
     torch.bfloat16, 64, True, None),
    ("cl_out_of_f32_x", False, torch.float32, False, torch.bfloat16, 64,
     True, None),
    ("cl_out_of_nchw_x_128_cout", False, torch.bfloat16, False,
     torch.bfloat16, 128, True, None),
]


@pytest.mark.parametrize("case", [c[0] for c in KERNEL_LAYOUTS])
def test_check_layouts_takes_the_kernel_forms_only(case):
    """The layouts a CUDA launch of conv takes: a channels-last x only in
    bfloat16 with a layer norm, a channels-last output only in bfloat16
    with Cout % 8 == 0 from a channels-last x or an un-normed NCHW x at
    Cout <= 64 (the net's first conv); every other combination raises, so
    no launch copies a layout."""
    _, cl, dtype, normed, out_dtype, cout, cl_out, want = next(
        c for c in KERNEL_LAYOUTS if c[0] == case)
    x = torch.zeros((1, 16, 4, 8), dtype=dtype)
    if cl:
        x = x.contiguous(memory_format=CL)
    norm = [conv_ops.Norm(None, torch.ones(16), torch.zeros(16))] \
        if normed else None
    fmt = CL if cl_out else torch.contiguous_format
    if want is None:
        with pytest.raises(ValueError, match="channels-last"):
            conv_ops.check_layouts(x, cout, out_dtype, norm, fmt)
    else:
        assert conv_ops.check_layouts(x, cout, out_dtype, norm, fmt) == want


def _bf16_stages(seed=0):
    cfg = MatryConfig(height=H, width=W, num_psv_planes=P, num_msi_planes=P,
                      ngf=NGF, coord_net=True)
    net = MSIUNet(cfg.num_net_inputs(), cfg.num_net_outputs(), cfg.ngf,
                  variant="coord")
    rng = np.random.RandomState(seed)
    with torch.no_grad():
        for prm in net.parameters():
            prm.copy_(torch.from_numpy(
                rng.randn(*prm.shape).astype(np.float32) * 0.2))
    x = torch.from_numpy(rng.uniform(-1, 1, (2, cfg.num_net_inputs(), H, W))
                         .astype(np.float32)).to(torch.bfloat16)
    return net, x


def test_prepare_picks_each_stage_layout():
    """ops/net.prepare: in bfloat16 every stage but the head writes
    channels-last (the next conv reads it by the kernel's channels-last
    form); the head, and every stage in float32, NCHW."""
    net, _ = _bf16_stages()
    st16 = net_ops.prepare(net, torch.bfloat16, H)
    assert [st["memory_format"] for st in st16] == [CL] * 17 + [
        torch.contiguous_format]
    st32 = net_ops.prepare(net, torch.float32, H)
    assert {st["memory_format"] for st in st32} == {torch.contiguous_format}


def test_unet_forward_layouts_match_on_cpu():
    """unet_forward of the bf16 coord net on the CPU: its channels-last
    activations give the prediction of the same stages on NCHW
    activations bit for bit, and net_stage returns it as a contiguous
    [B, K, H, W] float32 tensor."""
    net, x = _bf16_stages()
    stages = net_ops.prepare(net, torch.bfloat16, H)
    nchw = [dict(st, memory_format=torch.contiguous_format)
            for st in stages]
    got = msi_lib.net_stage(stages, x)
    assert got.dtype == torch.float32 and got.is_contiguous()
    assert got.shape == (2, net.plan[-1][4], H, W)
    assert torch.equal(got, net_ops.unet_forward(nchw, x))
    assert torch.equal(got, net_ops.unet_forward(stages, x.contiguous(
        memory_format=CL)))
