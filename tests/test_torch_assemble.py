"""The port's MSI assembly against the JAX package, on CPU: assemble_rgba
for the four colour schemes, the prepared (render-native) assembly, the
high-res prepared assembly, the align-corners upsample, and the net's head
width for each scheme.

Inputs are numpy from a seed at 32x64 with 4 planes. The port's layer
stack is [B, P, H, W, 4], interleaved, unflipped and unpadded; the JAX
stack is planar, W-flipped and row-wrap-padded by `pad` with two pole-cap
bands beside it, so the test compares the port's stack, permuted to
[P, 4, H, W], with prepared[:, :, pad:pad+H, ::-1] and rebuilds each cap
band from the port's rows.

Tolerances: in float32 both packages evaluate the same expressions on the
same values, so 1e-6 (measured 0). In bfloat16 the stack is rounded once
from float32 in both; a float32 difference of one ulp could cross a
rounding boundary, so one bf16 step of values in [-1, 1], 2^-8 (measured
0).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from matryodshka_tpu.config import MatryConfig as JaxConfig
from matryodshka_tpu.models import msi as jmsi
from matryodshka_tpu.ops import pallas_render
from matryodshka_tpu.training import state as state_lib
from matryodshka_tpu_torch import weights
from matryodshka_tpu_torch.config import MatryConfig
from matryodshka_tpu_torch.models import msi as tmsi
from matryodshka_tpu_torch.models.unet import MSIUNet

torch.set_num_threads(1)

H, W, P = 32, 64, 4
SCHEMES = ["blend_psv", "blend_bg", "blend_bg_psv", "alpha_only"]
K = {"blend_psv": 2 * P, "blend_bg": 2 * P + 3, "blend_bg_psv": 3 * P + 3,
     "alpha_only": P}
CAP, CAP_PAD = pallas_render.CAP_ROWS, 16
DTYPES = {"float32": (torch.float32, jnp.float32, 1e-6),
          "bfloat16": (torch.bfloat16, jnp.bfloat16, 2.0 ** -8)}


def _inputs(scheme, seed=0):
    """msi_pred [1, H, W, K] tanh, net_input [1, H, W, 2*P*3] in [-1, 1]."""
    rng = np.random.RandomState(seed)
    pred = np.tanh(rng.randn(1, H, W, K[scheme]) * 1.5).astype(np.float32)
    net_input = rng.uniform(-1, 1, (1, H, W, 2 * P * 3)).astype(np.float32)
    return pred, net_input


def _planar(net_input):
    """[1, H, W, 2*P*3] -> the port's vol [1, 2*P*3, H, W] and the JAX
    flipped plane-major fgF, bgF [P, 3, H, W]."""
    vol = net_input.transpose(0, 3, 1, 2)
    v = vol[0].reshape(2, P, 3, H, W)[..., ::-1]
    return (torch.from_numpy(np.ascontiguousarray(vol)),
            jnp.asarray(v[0].copy()), jnp.asarray(v[1].copy()))


def _check_stack(got, want, pad, tol):
    """got: the port's [P, H, W, 4]; want: the JAX prepared dict."""
    got = got.permute(0, 3, 1, 2).float().numpy()
    prep = np.asarray(want["prepared"].astype(jnp.float32))
    np.testing.assert_allclose(got, prep[:, :, pad:pad + H, ::-1], rtol=0,
                               atol=tol)
    bp = CAP_PAD
    bands = {"cap_top": np.concatenate([got[:, :, H - bp:],
                                        got[:, :, :CAP + bp]], axis=2),
             "cap_bot": np.concatenate([got[:, :, H - CAP - bp:],
                                        got[:, :, :bp]], axis=2)}
    for name, band in bands.items():
        np.testing.assert_allclose(
            band.transpose(2, 3, 0, 1),
            np.asarray(want[name].astype(jnp.float32)), rtol=0, atol=tol)


@pytest.mark.parametrize("scheme", SCHEMES)
def test_assemble_rgba_matches_jax(scheme):
    pred, net_input = _inputs(scheme)
    got = tmsi.assemble_rgba(scheme, torch.from_numpy(pred),
                             torch.from_numpy(net_input), P)
    want = jmsi.assemble_rgba(scheme, jnp.asarray(pred),
                              jnp.asarray(net_input), P)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=0, atol=1e-6, err_msg=k)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("scheme", SCHEMES)
def test_assemble_rgba_prepared_matches_jax(scheme, dtype):
    tdt, jdt, tol = DTYPES[dtype]
    pred, net_input = _inputs(scheme, seed=1)
    vol, fgF, bgF = _planar(net_input)
    got = tmsi.assemble_rgba_prepared(
        scheme, torch.from_numpy(pred).permute(0, 3, 1, 2), vol, P, tdt)
    assert got.shape == (1, P, H, W, 4) and got.dtype == tdt
    want = jmsi.assemble_rgba_prepared(scheme, jnp.asarray(pred[0]), fgF,
                                       bgF, P, cap_pad=CAP_PAD, dtype=jdt)
    pad = pallas_render.prepared_geometry(H, W)["pad"]
    _check_stack(got[0], want, pad, tol)


@pytest.mark.parametrize("scheme", ["blend_psv", "blend_bg", "alpha_only"])
def test_assemble_hres_prepared_matches_jax(scheme):
    """Upsampled weights in [0, 1] on a high-res volume; blend_bg takes an
    upsampled background RGB."""
    from matryodshka_tpu.ops.pallas_render import _band_geometry
    rng = np.random.RandomState(2)
    _, net_input = _inputs(scheme, seed=3)
    u_blend, u_alpha = rng.rand(2, H, W, P).astype(np.float32)
    u_bg = rng.uniform(-1, 1, (H, W, 3)).astype(np.float32)
    vol, fgF, bgF = _planar(net_input)

    def cf(x):
        return torch.from_numpy(x.transpose(2, 0, 1)[None].copy())

    got = tmsi.assemble_hres_prepared(
        scheme, cf(u_blend), cf(u_alpha), vol,
        cf(u_bg) if scheme == "blend_bg" else None, dtype=torch.float32)
    kv = 7
    want = jmsi.assemble_hres_prepared(
        scheme, jnp.asarray(u_blend), jnp.asarray(u_alpha), fgF, bgF,
        jnp.asarray(u_bg), CAP, pallas_render.ROW_BLOCK, CAP_PAD, kv,
        dtype=jnp.float32)
    _check_stack(got[0], want, _band_geometry(CAP, pallas_render.ROW_BLOCK,
                                              kv)[2], 1e-6)


@pytest.mark.parametrize("shape", [(8, 16, 32, 64), (5, 7, 128, 256)])
def test_upsample_align_corners_matches_jax(shape):
    """F.interpolate(align_corners=True) against the JAX separable
    matrices: the same two taps per axis, with weights that differ by the
    float32 rounding of the source position and sums taken in another
    order (measured 8.9e-7 on values in [0, 1]): 2e-6."""
    h, w, oh, ow = shape
    img = np.random.RandomState(4).rand(2, h, w, 6).astype(np.float32)
    got = tmsi.upsample_align_corners(torch.from_numpy(img), oh, ow)
    want = jmsi.upsample_align_corners(jnp.asarray(img), oh, ow)
    assert got.shape == (2, oh, ow, 6)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=2e-6)


def test_deprocess_inverts_preprocess():
    x = torch.from_numpy(np.random.RandomState(5).rand(3, 4).astype(
        np.float32))
    np.testing.assert_allclose(
        tmsi.deprocess_image(tmsi.preprocess_image(x)).numpy(), x.numpy(),
        rtol=0, atol=1e-7)
    np.testing.assert_allclose(tmsi.deprocess_image(x).numpy(),
                               np.asarray(jmsi.deprocess_image(x.numpy())),
                               rtol=0, atol=0)


@pytest.mark.parametrize("scheme", SCHEMES)
def test_head_width_per_scheme(scheme):
    """num_net_outputs follows the JAX table (2P, 2P+3, 3P+3, P; here
    64, 67, 99, 32 at 32 planes); weights.seeded_init draws that head and
    weights.from_flax maps JAX init_state's tree of that width."""
    kw = dict(height=32, width=64, num_psv_planes=32, num_msi_planes=32,
              ngf=8, which_color_pred=scheme)
    cfg = MatryConfig(**kw).validate()
    jcfg = JaxConfig(**kw).validate()
    assert cfg.num_net_outputs() == jcfg.num_net_outputs()
    assert cfg.num_net_outputs() == {"blend_psv": 64, "blend_bg": 67,
                                     "blend_bg_psv": 99,
                                     "alpha_only": 32}[scheme]
    state, _ = state_lib.init_state(jcfg, jax.random.PRNGKey(0))
    jtree = jax.tree.map(np.asarray, state.params)
    for tree in (weights.seeded_init(cfg, 0), jtree):
        net = MSIUNet(cfg.num_net_inputs(), cfg.num_net_outputs(), cfg.ngf)
        net.load_state_dict(weights.from_flax(tree))
        assert net.color_pred.weight.shape[0] == cfg.num_net_outputs()
