"""The smoothed U-Net (nearest 2x upsampling and a 4x4 conv in place of
each transposed conv) against the JAX package's, on the CPU.

* The folded parity form that the conv kernel runs (ops/conv.py:
  pack_smoothed, conv_plain with npar=4, kh=kw=3) against the upsampled
  conv it replaces in float64: the plain version folds and convolves in
  float32, so within 2e-6 of the output's largest magnitude (3e-7
  measured); a wrong tap or pad gives O(1).
* MSIUNet(smoothed=True), wrap and coord, against flax MSIUNet.apply with
  smoothed=True in float32 on the same weights and numpy input: the port's
  float32 net at tests/test_torch_net.py's 5e-5; its bfloat16 net within
  max(2e-2, 1.5 x the distance of flax's own bfloat16 net from float32),
  the port's standing bf16 gate (PERF.md section 2) with chip_smoke.py
  path 11's margin. On these raw tanh outputs of an ngf-8 net at 32x64,
  flax's bf16 net itself sits 2.5e-2 to 3.6e-2 from its float32 one, with
  or without smoothed, and the port's bf16 net as far (3.56e-2 both,
  wrap). Two bf16 nets are not held to each other: each rounds every
  activation of 18 layers in other places, and their errors add.
* The kernel route's plain version (ops/net.unet_forward on CPU tensors,
  the three upsampling stages in the folded form) against the same, f32
  at 5e-5 and bf16 at 2e-2.
* The packers: pack_deconv refuses a smoothed net's weights, and
  ops/net.prepare packs the smoothed stages with pack_smoothed.

The train step with smoothed=True is held to JAX's in
tests/test_torch_train.py (CONFIGS).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from matryodshka_tpu.config import MatryConfig as JaxConfig
from matryodshka_tpu.training import state as jstate
from matryodshka_tpu_torch import weights
from matryodshka_tpu_torch.config import MatryConfig
from matryodshka_tpu_torch.models.unet import MSIUNet
from matryodshka_tpu_torch.ops import conv as conv_ops
from matryodshka_tpu_torch.ops import net as net_ops
from matryodshka_tpu_torch.training import state as tstate

torch.set_num_threads(1)

H, W, P, NGF = 32, 64, 4, 8
ATOL = 5e-5
BF16_GATE = 2e-2
DTYPES = ("float32", "bfloat16")


@pytest.fixture(scope="module", params=["wrap", "coord"])
def smoothed_net(request):
    """(variant, flax params, input, flax float32 output, {dtype:
    tolerance}) for the smoothed net of each variant, from flax's init at
    PRNGKey(0)."""
    out = {}
    for dtype in ("float32", "bfloat16"):
        cfg = JaxConfig(height=H, width=W, num_psv_planes=P,
                        num_msi_planes=P, ngf=NGF, compute_dtype=dtype,
                        coord_net=request.param == "coord",
                        smoothed=True).validate()
        state, model = jstate.init_state(cfg, jax.random.PRNGKey(0))
        x = np.random.RandomState(0).uniform(
            -1, 1, (1, H, W, cfg.num_net_inputs())).astype(np.float32)
        out[dtype] = np.asarray(model.apply(state.params, jnp.asarray(x)))
        if dtype == "float32":
            params = jax.tree.map(np.asarray, state.params)
    spread = float(np.abs(out["bfloat16"] - out["float32"]).max())
    tols = {"float32": ATOL, "bfloat16": max(BF16_GATE, 1.5 * spread)}
    return request.param, params, x, out["float32"], tols


def _net(variant, params, dtype):
    cfg = MatryConfig(height=H, width=W, num_psv_planes=P, num_msi_planes=P,
                      ngf=NGF, compute_dtype=dtype,
                      coord_net=variant == "coord", smoothed=True).validate()
    net = tstate.build_model(cfg)
    net.load_state_dict(weights.from_flax(params))
    return cfg, net.eval()


@pytest.mark.parametrize("hpad", ["wrap", "zero"])
def test_folded_parities_match_upsampled_conv(hpad):
    """Nearest 2x, then the 4x4 conv padded (1, 2) (the wrap net wraps the
    columns, 1 left and 2 right, and zero-pads the rows; the coord net
    zero-pads both), against the four folded parity convs."""
    rng = np.random.RandomState(3)
    x = torch.from_numpy(rng.randn(2, 5, 6, 10))
    w = torch.from_numpy(rng.randn(7, 5, 4, 4))
    b = torch.from_numpy(rng.randn(7).astype(np.float32))
    u = x.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)
    u = (conv_ops.wrap_pad(u, 1, 2, 1, 2) if hpad == "wrap"
         else F.pad(u, (1, 2, 1, 2)))
    want = F.conv2d(u, w) + b.double()[:, None, None]
    wk = conv_ops.pack_smoothed(w, torch.float64)
    assert tuple(wk.shape) == (4, 9 * 5, 7)
    got = conv_ops.conv_plain(x, wk, b, kh=3, kw=3, npar=4, hpad=hpad)
    assert got.shape == want.shape == (2, 7, 12, 20)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0,
                               atol=2e-6 * want.abs().max().item())


@pytest.mark.parametrize("dtype", DTYPES)
def test_smoothed_msiunet_matches_flax(smoothed_net, dtype):
    variant, params, x, ref, tols = smoothed_net
    _, net = _net(variant, params, dtype)
    with torch.no_grad():
        got = net(torch.from_numpy(x).permute(0, 3, 1, 2))
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), ref, rtol=0,
                               atol=tols[dtype])


@pytest.mark.parametrize("dtype", DTYPES)
def test_smoothed_kernel_route_matches_flax(smoothed_net, dtype):
    """The 18 stages through the conv and layer-norm kernels' plain
    versions, the upsampling stages in the folded parity form."""
    variant, params, x, ref, tols = smoothed_net
    cfg, net = _net(variant, params, dtype)
    stages = net_ops.prepare(net, cfg.torch_compute_dtype, H)
    ups = [st for st in stages if st["name"] in ("conv6_1", "conv7_1",
                                                 "conv8_1")]
    assert len(stages) == 18 and len(ups) == 3
    for st in ups:
        assert (st["args"]["kh"], st["args"]["npar"]) == (3, 4)
        assert st["args"].get("hpad", "wrap") == (
            "zero" if variant == "coord" else "wrap")
        assert "coord" not in st["args"]
    got = net_ops.unet_forward(stages, torch.from_numpy(x).permute(
        0, 3, 1, 2).to(cfg.torch_compute_dtype))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), ref, rtol=0,
                               atol=tols[dtype])


def test_pack_deconv_refuses_a_smoothed_net():
    """The fault the JAX fused net has (fused_net_ops never reads
    cfg.smoothed, ROADMAP Queue 3): a smoothed net's 4x4 weights have the
    transposed conv's shape, so the packer must be told, and refuses them
    by the stage's name."""
    net = MSIUNet(2 * P * 3, 2 * P, NGF, smoothed=True)
    with pytest.raises(ValueError, match="conv7_1 belongs to a smoothed"):
        conv_ops.pack_deconv(net.conv7_1.weight.detach(), torch.float32,
                             smoothed=True, name="conv7_1")
    with pytest.raises(TypeError):
        conv_ops.pack_deconv(net.conv7_1.weight.detach(), torch.float32)
    stages = net_ops.prepare(net, torch.float32)
    st = next(s for s in stages if s["name"] == "conv7_1")
    want = conv_ops.pack_smoothed(net.conv7_1.weight.detach(), torch.float32)
    assert torch.equal(st["w"], want)


def test_config_and_trainer_take_smoothed():
    """validate() accepts smoothed; the trainer's, entry's and the
    export's nets are built smoothed (JAX training/state.py:30)."""
    from matryodshka_tpu_torch import entry
    from matryodshka_tpu_torch.cli import export as export_cli
    cfg = MatryConfig(height=H, width=W, num_psv_planes=P, num_msi_planes=P,
                      ngf=NGF, smoothed=True).validate()
    assert tstate.build_model(cfg).smoothed
    assert entry.make_params(cfg, device="cpu").net.smoothed
    tree = weights.seeded_init(cfg, 0)
    assert export_cli.build_net_only_fn(cfg, tree, "cpu").net.smoothed
