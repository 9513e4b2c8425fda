"""The port's layer-stack render and K3's depth mode against the JAX
package, on CPU (each kernel's plain version; the kernels themselves are
held against these on the card by tests/test_torch_kernels_cuda.py).

* over_composite_depth and the gather render_equirect_depth against
  geometry/render.py;
* render_layers' CPU route (uv_tables + render_layers_plain, the plain
  version of csrc/render_layers.cu, K4/K5/K6) on the port's prepared
  stack against the JAX package's
  render_equirect_view_from_prepared / render_equirect_depth_from_prepared
  on its own prepared stack of the same prediction and volumes, with the
  ladder kernels in interpret mode (as tests/test_prepared_path.py runs
  them), for three schemes, with the back-to-front (K4) and the
  front-to-back (K6, pallas_render.DEFAULT_FTB) kernel, for a translated
  target (the ladder) and a rotated one (the JAX gather fallback); the
  image-and-depth entry (render_view_and_depth_from_prepared, one
  uv_tables build) against the same pair for both poses with ftb on and
  off, and against the port's two one-output calls, bit for bit;
* render_blend_plain(depth=True) (K3's depth mode) against the JAX
  render_equirect_view_fused_blend(depth=True) in interpret mode.

Inputs: numpy from a seed, float32, 64x128 (the ladder needs W % 128 == 0
and H - 32 a multiple of its 32-row blocks), 4 shells from 20 m to 2 m.
Tolerance 3e-4 on renders in [-1, 1] and depths in [0, 1): the two
packages' uv tables differ by up to 5e-5 px at 64 wide
(tests/test_torch_render.py), twice that at 128 wide, and more near the
poles of a rotated view; layers uniform in [-1, 1] have slopes up to 2 per
pixel, so a bilinear sample moves by up to ~2e-4 (measured 1.5e-4 on 3 of
24,576 values, rotated blend_bg). Composites differ in f32 order (~1e-6),
and the JAX FTB kernel stops rays at T < 1e-6.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from matryodshka_tpu.geometry import render as jrender
from matryodshka_tpu.models import msi as jmsi
from matryodshka_tpu.ops import pallas_render, pallas_sweep
from matryodshka_tpu_torch.geometry import render as trender
from matryodshka_tpu_torch.models import msi as tmsi
from matryodshka_tpu_torch.ops import render as render_ops
from matryodshka_tpu_torch.ops import render_layers as rl_ops

torch.set_num_threads(1)

H, W, P = 64, 128, 4
RADII = np.array([20.0, 8.0, 4.0, 2.0], np.float32)
K = {"blend_bg": 2 * P + 3, "blend_bg_psv": 3 * P + 3, "alpha_only": P,
     "blend_psv": 2 * P}
TOL = 3e-4


def _pose(kind):
    pose = np.eye(4, dtype=np.float32)
    if kind == "translated":
        pos = np.array([0.02, 0.01, -0.015], np.float32)
    else:
        a = 0.5
        pose[:3, :3] = [[1, 0, 0], [0, np.cos(a), -np.sin(a)],
                        [0, np.sin(a), np.cos(a)]]
        pos = np.array([0.01, 0.0, 0.0], np.float32)
    return pose[None], pos[None]


def _inputs(scheme, seed):
    """pred [1, K, H, W] tanh and vol [1, 2*P*3, H, W] in [-1, 1]."""
    rng = np.random.RandomState(seed)
    pred = np.tanh(rng.randn(1, K[scheme], H, W) * 1.5).astype(np.float32)
    vol = rng.uniform(-1, 1, (1, 2 * P * 3, H, W)).astype(np.float32)
    return pred, vol


def _flipped(vol):
    v = vol[0].reshape(2, P, 3, H, W)[..., ::-1]
    return jnp.asarray(v[0].copy()), jnp.asarray(v[1].copy())


def test_over_composite_depth_matches_jax():
    rgba = np.random.RandomState(0).rand(5, 7, 6, 4).astype(np.float32)
    got = trender.over_composite_depth(torch.from_numpy(rgba)).numpy()
    ref = np.asarray(jrender.over_composite_depth(jnp.asarray(rgba)))
    assert got.shape == ref.shape == (5, 7, 3)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)


@pytest.mark.parametrize("kind", ["translated", "rotated"])
def test_gather_depth_render_matches_jax(kind):
    """The batched reference-path depth render (models/msi.py over
    geometry/render.py) at 32x64."""
    layers = np.random.RandomState(1).rand(1, 32, 64, P, 4).astype(
        np.float32)
    pose, pos = _pose(kind)
    got = tmsi.render_equirect_depth(
        torch.from_numpy(layers), torch.from_numpy(pose),
        torch.from_numpy(pos), torch.from_numpy(RADII)).numpy()
    ref = np.asarray(jmsi.render_equirect_depth(
        jnp.asarray(layers), jnp.asarray(pose), jnp.asarray(pos),
        jnp.asarray(RADII)))
    assert got.shape == ref.shape == (1, 32, 64, 3)
    np.testing.assert_allclose(got, ref, rtol=0, atol=TOL)


@pytest.mark.parametrize("depth", [False, True])
def test_plain_composite_equals_closed_form(depth):
    """The shell-streamed plain composite equals over_composite
    (over_composite_depth) of all sampled shells, to f32 order (1e-6)."""
    rng = np.random.RandomState(2)
    layers = torch.from_numpy(rng.rand(2, P, 16, 32, 4).astype(np.float32))
    u = torch.from_numpy(rng.uniform(-40, 80, (2, P, 16, 32)).astype(
        np.float32))
    v = torch.from_numpy(rng.uniform(-20, 40, (2, P, 16, 32)).astype(
        np.float32))
    got = rl_ops.render_layers_plain(layers, u, v, depth=depth)
    composite = (trender.over_composite_depth if depth
                 else trender.over_composite)
    from matryodshka_tpu_torch.ops.resample import resample_layers_uv
    want = torch.stack([composite(resample_layers_uv(
        layers[i], u[i], v[i]).permute(1, 2, 0, 3)) for i in range(2)])
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=1e-6)


@pytest.mark.parametrize("kind,ftb", [("translated", False),
                                      ("translated", True),
                                      ("rotated", False)])
@pytest.mark.parametrize("scheme", ["blend_bg", "blend_bg_psv",
                                    "alpha_only"])
def test_layer_stack_render_matches_jax(scheme, kind, ftb, monkeypatch):
    monkeypatch.setattr(pallas_render, "DEFAULT_FTB", ftb)
    jouts, jargs, touts, targs = _layer_stack_case(scheme, kind)
    for fn in ("render_equirect_view_from_prepared",
               "render_equirect_depth_from_prepared"):
        ref = np.asarray(getattr(jmsi, fn)(jouts, *jargs, interpret=True))
        got = getattr(tmsi, fn)(touts, *targs, ftb=ftb).numpy()
        assert got.shape == ref.shape == (1, H, W, 3)
        np.testing.assert_allclose(got, ref, rtol=0, atol=TOL, err_msg=fn)


def _layer_stack_case(scheme, kind):
    """(JAX prepared outputs, JAX pose args, the port's prepared outputs,
    the port's pose args) of one prediction and volume."""
    pred, vol = _inputs(scheme, seed=3)
    fgF, bgF = _flipped(vol)
    cap_pad = jrender._cap_band_pad(H, W, pallas_render.CAP_ROWS)
    jprep = jmsi.assemble_rgba_prepared(
        scheme, jnp.asarray(pred[0].transpose(1, 2, 0)), fgF, bgF, P,
        cap_pad=cap_pad)
    pose, pos = _pose(kind)
    return ({k: v[None] for k, v in jprep.items()},
            (jnp.asarray(pose), jnp.asarray(pos), jnp.asarray(RADII), H),
            {"layers": tmsi.assemble_rgba_prepared(
                scheme, torch.from_numpy(pred), torch.from_numpy(vol), P)},
            (torch.from_numpy(pose), torch.from_numpy(pos),
             torch.from_numpy(RADII)))


@pytest.mark.parametrize("ftb", [False, True])
@pytest.mark.parametrize("kind", ["translated", "rotated"])
def test_both_equals_two_calls(kind, ftb):
    """The image-and-depth entry (models/msi.py over
    ops/render_layers.render_layers_both) gives the image and the depth of
    the two one-output calls bit for bit, on a random f32 and bf16 stack."""
    rng = np.random.RandomState(5)
    stack = rng.uniform(-1, 1, (2, P, H, W, 4)).astype(np.float32)
    stack[..., 3] = 1.0 / (1.0 + np.exp(-3.0 * stack[..., 3]))
    pose, pos = _pose(kind)
    targs = (torch.from_numpy(pose).expand(2, 4, 4),
             torch.from_numpy(np.concatenate([pos, -pos])),
             torch.from_numpy(RADII))
    for dtype in (torch.float32, torch.bfloat16):
        outs = {"layers": torch.from_numpy(stack).to(dtype)}
        n = trender.uv_builds
        img, depth = tmsi.render_view_and_depth_from_prepared(
            outs, *targs, ftb=ftb)
        assert trender.uv_builds == n + 1
        assert img.shape == depth.shape == (2, H, W, 3)
        assert torch.equal(img, tmsi.render_equirect_view_from_prepared(
            outs, *targs, ftb=ftb))
        assert torch.equal(depth, tmsi.render_equirect_depth_from_prepared(
            outs, *targs, ftb=ftb))


@pytest.mark.parametrize("ftb", [False, True])
@pytest.mark.parametrize("kind", ["translated", "rotated"])
def test_layer_stack_both_matches_jax(kind, ftb, monkeypatch):
    """The image-and-depth entry against the JAX package's
    render_equirect_view_from_prepared and render_equirect_depth_from_
    prepared (ladder kernels in interpret mode, K6 when ftb; the gather
    fallback for the rotated pose) on its own prepared stack of the same
    prediction and volume, blend_bg, within TOL (module docstring)."""
    monkeypatch.setattr(pallas_render, "DEFAULT_FTB", ftb)
    jouts, jargs, touts, targs = _layer_stack_case("blend_bg", kind)
    got = tmsi.render_view_and_depth_from_prepared(touts, *targs, ftb=ftb)
    for fn, g in zip(("render_equirect_view_from_prepared",
                      "render_equirect_depth_from_prepared"), got):
        ref = np.asarray(getattr(jmsi, fn)(jouts, *jargs, interpret=True))
        assert g.shape == ref.shape == (1, H, W, 3)
        np.testing.assert_allclose(g.numpy(), ref, rtol=0, atol=TOL,
                                   err_msg=fn)


@pytest.mark.parametrize("kind", ["translated", "rotated"])
def test_blend_fused_depth_matches_jax(kind):
    """K3's depth mode: the JAX blend-fused FTB render with depth=True
    reads the padded planar volumes, the flipped [H, 2P, W] prediction and
    the blended pole-cap bands; the port reads vol and pred as they are."""
    pred, vol = _inputs("blend_psv", seed=4)
    fgF, bgF = _flipped(vol)
    vpad = pallas_sweep.NET_ROW_PAD

    def padded(x):
        return jnp.pad(x, ((0, 0), (0, 0), (vpad, vpad), (0, 0)))

    pred_hkwF = jnp.asarray(pred[0].transpose(1, 0, 2)[..., ::-1].copy())
    cap, rb = pallas_render.CAP_ROWS, pallas_render.ROW_BLOCK
    cap_pad = jrender._cap_band_pad(H, W, cap)
    caps = jmsi.assemble_caps_blend_psv(pred_hkwF, fgF, bgF, P,
                                        cap_pad=cap_pad)
    pose, pos = _pose(kind)
    ref = np.asarray(jrender.render_equirect_view_fused_blend(
        padded(fgF), padded(bgF), pred_hkwF, caps["cap_top"],
        caps["cap_bot"], jnp.asarray(pose[0]), jnp.asarray(pos[0]),
        jnp.asarray(RADII), H, cap, rb, cap_pad, vpad, depth=True,
        interpret=True))
    got = render_ops.render_blend(torch.from_numpy(vol),
                                  torch.from_numpy(pred),
                                  torch.from_numpy(pose),
                                  torch.from_numpy(pos),
                                  torch.from_numpy(RADII),
                                  depth=True)[0].numpy()
    assert got.shape == ref.shape == (H, W, 3)
    np.testing.assert_allclose(got, ref, rtol=0, atol=TOL)
