"""The port's renders against the JAX package: over-compositing, the gather
render, and the blend-fused render (plain version of csrc/render.cu)
against the JAX gather branch on the assembled layers
(geometry/render.py:371-384 semantics, reached through
msi.render_equirect_view(use_pallas=False)).

Inputs: numpy from a seed, float32, 32x64, 6 shells, for a translated and
a rotated target pose. Tolerance 5e-5 on renders in [-1, 1]: the
composites differ in f32 summation order (~1e-6), and the two packages'
uv tables differ by up to 5e-5 px (test_torch_geometry), which moves a
bilinear sample of layers with slopes near 1 per pixel by as much
(measured 2.4e-5 on 2 of 6,144 values).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from matryodshka_tpu.geometry import render as jrender
from matryodshka_tpu.models import msi as jmsi
from matryodshka_tpu_torch.geometry import render as trender

torch.set_num_threads(1)

H, W, P = 32, 64, 6
RADII = np.array([100.0, 30.0, 8.0, 3.0, 1.5, 1.0], np.float32)


def _pose(kind):
    pose = np.eye(4, dtype=np.float32)
    pos = np.zeros(3, np.float32)
    if kind == "translated":
        pos[:] = [0.05, 0.01, -0.02]
    else:
        a = 0.5
        pose[:3, :3] = [[1, 0, 0], [0, np.cos(a), -np.sin(a)],
                        [0, np.sin(a), np.cos(a)]]
        pos[:] = [0.01, 0.0, 0.0]
    return pose[None], pos[None]


def _volumes(seed):
    """vol [1, 2*P*3, H, W] in [-1, 1] and pred [1, 2P, H, W] tanh."""
    rng = np.random.RandomState(seed)
    vol = rng.uniform(-1, 1, (1, 2 * P * 3, H, W)).astype(np.float32)
    pred = np.tanh(rng.randn(1, 2 * P, H, W) * 1.5).astype(np.float32)
    return vol, pred


def test_over_composite():
    rng = np.random.RandomState(0)
    rgba = rng.rand(5, 7, P, 4).astype(np.float32)
    got = trender.over_composite(torch.from_numpy(rgba)).numpy()
    ref = np.asarray(jrender.over_composite(jnp.asarray(rgba)))
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)


@pytest.mark.parametrize("kind", ["translated", "rotated"])
def test_gather_render_matches_jax(kind):
    rng = np.random.RandomState(1)
    layers = rng.rand(H, W, P, 4).astype(np.float32)
    pose, pos = _pose(kind)
    got = trender.render_equirect_view(
        torch.from_numpy(layers), torch.from_numpy(pose[0]),
        torch.from_numpy(pos[0]), torch.from_numpy(RADII)).numpy()
    ref = np.asarray(jrender.render_equirect_view(
        jnp.asarray(layers), jnp.asarray(pose[0]), jnp.asarray(pos[0]),
        jnp.asarray(RADII)))
    np.testing.assert_allclose(got, ref, rtol=0, atol=5e-5)


@pytest.mark.parametrize("kind", ["translated", "rotated"])
def test_fused_blend_render_matches_jax_gather(kind):
    """The blend-fused render (blend at source pixels, then sample and
    composite) equals assembling the blend_psv layers first and rendering
    them with the JAX gather path."""
    vol, pred = _volumes(2)
    pose, pos = _pose(kind)
    got = trender.render_equirect_view_fused_blend(
        torch.from_numpy(vol), torch.from_numpy(pred),
        torch.from_numpy(pose), torch.from_numpy(pos),
        torch.from_numpy(RADII)).numpy()
    net_input = vol.transpose(0, 2, 3, 1)             # [1, H, W, 2*P*3]
    msi_pred = pred.transpose(0, 2, 3, 1)             # [1, H, W, 2P]
    layers = jmsi.assemble_rgba("blend_psv", jnp.asarray(msi_pred),
                                jnp.asarray(net_input), P)["rgba_layers"]
    ref = np.asarray(jmsi.render_equirect_view(
        layers, jnp.asarray(pose), jnp.asarray(pos), jnp.asarray(RADII),
        use_pallas=False))
    assert got.shape == ref.shape == (1, H, W, 3)
    np.testing.assert_allclose(got, ref, rtol=0, atol=5e-5)
