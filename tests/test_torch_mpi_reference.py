"""The benchmark's plain MPI reference (`msi_bench/reference/homography.py`,
`msi_bench/reference/mpi.py`) against the JAX package on the same inputs:
the RealEstate10K net input (`format_realestate_network_input`: the ref
image and the two homography plane sweeps), blend_psv's layers
(`assemble_rgba`, the JAX fg and bg slices) and the MPI render
(`render_mpi_view`), on CPU, float32, numpy inputs from seeds.

The two sides compute their float32 sampling coordinates in different
orders, a few ulp apart at up to 64 px (~1e-5 px), so a sampled value may
differ by that much times the image's gradient: the images are held to
1e-5 + max|grad| x 1e-4 px (`warp_tol`), as tests/test_torch_homography.py
holds the port's warps.
"""

import math

import jax.numpy as jnp
import numpy as np
import torch

from matryodshka_tpu.geometry import sweep as jsweep
from matryodshka_tpu.models import msi as jmsi
from msi_bench.reference import mpi
from msi_bench.reference.geometry import inv_depths

H, W, P = 32, 64, 4
PX_TOL = 1e-4


def warp_tol(img):
    """1e-5 + the largest difference of neighbouring pixels x PX_TOL."""
    img = np.asarray(img)
    grad = max(np.abs(np.diff(img, axis=0)).max(),
               np.abs(np.diff(img, axis=1)).max())
    return 1e-5 + grad * PX_TOL


def _pose(tx, ty, tz, yaw_deg):
    a = math.radians(yaw_deg)
    pose = np.eye(4, dtype=np.float32)
    pose[:3, :3] = [[math.cos(a), 0.0, math.sin(a)], [0.0, 1.0, 0.0],
                    [-math.sin(a), 0.0, math.cos(a)]]
    pose[:3, 3] = tx, ty, tz
    return pose


K = np.asarray([[0.9 * W, 0.0, 0.5 * W], [0.0, 1.2 * H, 0.5 * H],
                [0.0, 0.0, 1.0]], np.float32)
DEPTHS = np.asarray(inv_depths(1.0, 100.0, P), np.float32)


def _inputs(seed):
    rng = np.random.RandomState(seed)
    ref = rng.rand(H, W, 3).astype(np.float32)
    src = rng.rand(H, W, 3).astype(np.float32)
    return ref, src


def test_net_input_matches_jax_format_realestate_network_input():
    ref, src = _inputs(1)
    ref_pose = _pose(0.03, -0.01, 0.02, 3.0)      # not at the origin
    src_pose = _pose(-0.12, 0.0, 0.01, -2.0)
    want = np.asarray(jsweep.format_realestate_network_input(
        jnp.asarray(ref * 2 - 1)[None], jnp.asarray(src * 2 - 1)[None],
        jnp.asarray(ref_pose)[None], jnp.asarray(src_pose)[None],
        jnp.asarray(DEPTHS), jnp.asarray(K)[None]))[0]
    got = mpi.net_input(torch.from_numpy(ref), torch.from_numpy(src),
                        torch.from_numpy(ref_pose),
                        torch.from_numpy(src_pose), torch.from_numpy(K),
                        torch.from_numpy(DEPTHS)).permute(1, 2, 0).numpy()
    assert got.shape == want.shape == (H, W, 3 + 6 * P)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=warp_tol(np.concatenate([ref, src], -1)
                                             * 2))


def test_layers_match_jax_assemble_rgba_blend_psv():
    rng = np.random.RandomState(2)
    vol = (rng.rand(H, W, 3 + 6 * P) * 2 - 1).astype(np.float32)
    pred = np.tanh(rng.randn(H, W, 2 * P)).astype(np.float32)
    want = np.asarray(jmsi.assemble_rgba(
        "blend_psv", jnp.asarray(pred)[None], jnp.asarray(vol)[None],
        P)["rgba_layers"])[0]                          # [H, W, P, 4]
    got = mpi.layers(torch.from_numpy(vol).permute(2, 0, 1),
                     torch.from_numpy(pred).permute(2, 0, 1))
    np.testing.assert_allclose(got.permute(1, 2, 0, 3).numpy(), want,
                               rtol=0, atol=1e-6)


def test_render_matches_jax_render_mpi_view():
    rng = np.random.RandomState(3)
    rgba = rng.rand(H, W, P, 4).astype(np.float32)
    pose = _pose(0.06, -0.02, 0.04, 4.0)
    want = np.asarray(jmsi.render_mpi_view(
        jnp.asarray(rgba)[None], jnp.asarray(pose)[None], jnp.asarray(DEPTHS),
        jnp.asarray(K)[None]))[0]
    got = mpi.render(torch.from_numpy(rgba).permute(2, 0, 1, 3),
                     torch.from_numpy(pose), torch.from_numpy(K),
                     torch.from_numpy(DEPTHS)).numpy()
    assert got.shape == want.shape == (H, W, 3)
    np.testing.assert_allclose(got, want, rtol=0, atol=warp_tol(rgba))
