"""The three public geometry helpers no pipeline calls, against the JAX
package on the CPU: geometry/sweep.ods_centered_sphere_sweep,
geometry/cameras.pose_from_offset and geometry/grids.theta_y_grid.

Inputs: numpy from a seed, float32.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from matryodshka_tpu.geometry import cameras as jcameras
from matryodshka_tpu.geometry import grids as jgrids
from matryodshka_tpu.geometry import sweep as jsweep
from matryodshka_tpu_torch.geometry import cameras, grids, sweep

torch.set_num_threads(1)


def test_centered_sweep_identity_is_flip():
    """JAX tests/test_sweep.py's case: with the identity pose the lookup
    hits pixel centres, so every plane is the image flipped horizontally
    (1e-4)."""
    rng = np.random.RandomState(0)
    b, h, w = 2, 8, 16
    img = rng.rand(b, h, w, 3).astype(np.float32)
    pose = torch.eye(4).repeat(b, 1, 1)
    intr = torch.eye(3).repeat(b, 1, 1)
    vol = sweep.ods_centered_sphere_sweep(
        torch.from_numpy(img), 0, torch.tensor([100.0, 1.0]), pose,
        intr).numpy()
    assert vol.shape == (b, h, w, 2 * 3)
    for p in range(2):
        np.testing.assert_allclose(vol[..., 3 * p:3 * p + 3],
                                   img[:, :, ::-1, :], atol=1e-4)


def _pose(rng, b):
    """b poses: a rotation about y of up to 0.3 rad and a translation of
    up to 0.2 m."""
    poses = np.tile(np.eye(4, dtype=np.float32)[None], (b, 1, 1))
    for i, a in enumerate(rng.uniform(-0.3, 0.3, b)):
        poses[i, 0, 0] = poses[i, 2, 2] = np.cos(a)
        poses[i, 0, 2], poses[i, 2, 0] = np.sin(a), -np.sin(a)
    poses[:, :3, 3] = rng.uniform(-0.2, 0.2, (b, 3))
    return poses


@pytest.mark.parametrize("seed", [1, 2])
def test_centered_sweep_matches_jax(seed):
    """A non-identity pose: the JAX gather sweep (use_pallas=False) within
    1e-5 (the same bilinear taps; f32 projections in other orders)."""
    rng = np.random.RandomState(seed)
    b, h, w = 2, 16, 32
    img = rng.rand(b, h, w, 3).astype(np.float32)
    depths = np.asarray(jsweep.inv_depths(1.0, 50.0, 4), np.float32)
    pose = _pose(rng, b)
    intr = np.tile(np.eye(3, dtype=np.float32)[None], (b, 1, 1))
    got = sweep.ods_centered_sphere_sweep(
        torch.from_numpy(img), 1, torch.from_numpy(depths),
        torch.from_numpy(pose), torch.from_numpy(intr)).numpy()
    want = np.asarray(jsweep.ods_centered_sphere_sweep(
        jnp.asarray(img), 1, jnp.asarray(depths), jnp.asarray(pose),
        jnp.asarray(intr)))
    assert got.shape == want.shape == (b, h, w, 4 * 3)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_pose_from_offset_matches_jax(dtype):
    off = np.random.RandomState(3).uniform(-1, 1, 3).astype(dtype)
    got = cameras.pose_from_offset(torch.from_numpy(off))
    assert got.dtype == getattr(torch, dtype)
    if dtype == "float32":
        np.testing.assert_array_equal(
            got.numpy(), np.asarray(jcameras.pose_from_offset(
                jnp.asarray(off))))
    want = np.eye(4, dtype=dtype)
    want[:3, 3] = off
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("shape", [(8, 16), (33, 70), (320, 640)])
def test_theta_y_grid_matches_jax(shape):
    """Within two float32 steps at the range's end (4.8e-7 for theta in
    [-pi, pi], 2.4e-7 for y in [-1, 1]): one step at pi is 2.4e-7, and
    jnp.linspace on XLA:CPU itself sits up to two steps from the float64
    linspace rounded to float32, torch.linspace up to one."""
    th, y = grids.theta_y_grid(shape)
    jth, jy = jgrids.theta_y_grid(shape)
    assert tuple(th.shape) == tuple(y.shape) == shape
    assert th.dtype == y.dtype == torch.float32
    for got, want, end in ((th, jth, np.pi), (y, jy, 1.0)):
        tol = 2 * float(np.spacing(np.float32(end)))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=tol)
    h, w = shape
    exact = np.linspace(-np.pi, np.pi, w).astype(np.float32)
    np.testing.assert_allclose(th.numpy()[0], exact, rtol=0,
                               atol=float(np.spacing(np.float32(np.pi))))
    np.testing.assert_array_equal(th.numpy(), th.numpy()[:1].repeat(h, 0))
    np.testing.assert_array_equal(y.numpy(), y.numpy()[:, :1].repeat(w, 1))
