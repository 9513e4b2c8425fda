"""The port's geometry and resampling against the JAX package, on CPU.

Inputs are drawn with numpy from a seed and handed to both packages in
float32. Tolerance: 5e-5 in pixels (u, v up to 63 at W=64, where a float32
ulp is 3.8e-6; XLA and torch evaluate atan2/sqrt/trig with different
roundings, measured up to 9 ulps apart there) and 1e-5 for unit-scale
values.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from matryodshka_tpu.geometry import cameras as jcam
from matryodshka_tpu.geometry import grids as jgrids
from matryodshka_tpu.geometry import intersect as jint
from matryodshka_tpu.ops import resample as jres
from matryodshka_tpu_torch.geometry import cameras as tcam
from matryodshka_tpu_torch.geometry import grids as tgrids
from matryodshka_tpu_torch.geometry import intersect as tint
from matryodshka_tpu_torch.ops import resample as tres

torch.set_num_threads(1)

H, W = 32, 64
PIX_TOL = 5e-5
UNIT_TOL = 1e-5


def _t(a):
    return torch.from_numpy(np.asarray(a, dtype=np.float32))


def _pose(kind):
    pose = np.eye(4, dtype=np.float32)
    if kind in ("rotated", "both"):
        a, b = 0.4, -0.3
        rx = np.array([[1, 0, 0], [0, np.cos(a), -np.sin(a)],
                       [0, np.sin(a), np.cos(a)]])
        ry = np.array([[np.cos(b), 0, np.sin(b)], [0, 1, 0],
                       [-np.sin(b), 0, np.cos(b)]])
        pose[:3, :3] = (ry @ rx).astype(np.float32)
    if kind in ("translated", "both"):
        pose[:3, 3] = [0.05, -0.02, 0.03]
    return pose


def test_lat_long_grid():
    S, T = tgrids.lat_long_grid((H, W))
    Sj, Tj = jgrids.lat_long_grid((H, W))
    np.testing.assert_allclose(S.numpy(), np.asarray(Sj), rtol=0,
                               atol=UNIT_TOL)
    np.testing.assert_allclose(T.numpy(), np.asarray(Tj), rtol=0,
                               atol=UNIT_TOL)


def test_theta_phi_to_pixels():
    rng = np.random.RandomState(0)
    th = rng.uniform(-np.pi, np.pi, (5, 7)).astype(np.float32)
    ph = rng.uniform(-np.pi / 2, np.pi / 2, (5, 7)).astype(np.float32)
    got = tgrids.theta_phi_to_pixels(_t(th), _t(ph), W, H).numpy()
    ref = np.asarray(jgrids.theta_phi_to_pixels(jnp.asarray(th),
                                                jnp.asarray(ph), W, H))
    np.testing.assert_allclose(got, ref, rtol=0, atol=PIX_TOL)


@pytest.mark.parametrize("kind", ["identity", "rotated", "both"])
def test_backproject_and_poses(kind):
    depths = np.array([50.0, 3.0, 1.2], np.float32)
    pose = _pose(kind)
    S, T = tgrids.lat_long_grid((H, W))
    pts = tcam.apply_pose(tcam.backproject_spherical(S, T, _t(depths)),
                          _t(pose))
    dirs = tcam.rotate_dirs(tgrids.spherical_ray_dirs(S, T), _t(pose))
    Sj, Tj = jgrids.lat_long_grid((H, W))
    pj = jcam.apply_pose(jcam.backproject_spherical(Sj, Tj,
                                                    jnp.asarray(depths)),
                         jnp.asarray(pose))
    dj = jcam.rotate_dirs(jgrids.spherical_ray_dirs(Sj, Tj),
                          jnp.asarray(pose))
    for a, b in zip(pts, pj):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=1e-4)
    for a, b in zip(dirs, dj):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=UNIT_TOL)


@pytest.mark.parametrize("order", [1, -1])
def test_project_ods(order):
    """Same uv wherever both packages find a tangent ray. The tangent
    quadratic cancels catastrophically for shells far outside the viewing
    circle (its terms grow as depth^2 while the root stays O(1)), so two
    float32 evaluations of the same formula drift apart in proportion to
    the depth: measured 2.5e-5 * depth pixels at W=64; the tolerance is
    4e-5 * depth (and PIX_TOL near the circle). The parked set (disc < 0 ->
    pixel (1, 1)) may differ on a few points whose discriminant is that
    noise (PARITY.md park-flip noise): at most 1% of points."""
    depths = np.array([100.0, 20.0, 2.0, 0.05], np.float32)
    intr = np.eye(3, dtype=np.float32)
    intr[0, 0] = 0.064
    S, T = tgrids.lat_long_grid((H, W))
    got = tcam.project_ods(tcam.backproject_spherical(S, T, _t(depths)),
                           order, _t(intr), W, H).numpy()
    Sj, Tj = jgrids.lat_long_grid((H, W))
    ref = np.asarray(jcam.project_ods(
        jcam.backproject_spherical(Sj, Tj, jnp.asarray(depths)), order,
        None, jnp.asarray(intr), W, H))
    pg = np.all(got == 1.0, axis=-1)
    pr = np.all(ref == 1.0, axis=-1)
    assert pr[-1].all() and pg[-1].all()      # inside the viewing circle
    assert (pg != pr).mean() <= 0.01
    tol = np.maximum(PIX_TOL, 4e-5 * depths)[:, None, None, None]
    both = (~pg & ~pr)[..., None]
    assert np.all(np.where(both, np.abs(got - ref), 0.0) <= tol)


def test_project_spherical():
    rng = np.random.RandomState(1)
    x, y, z = (rng.randn(3, 6, 9) * 5).astype(np.float32)
    got = tcam.project_spherical((_t(x), _t(y), _t(z)), W, H).numpy()
    ref = np.asarray(jcam.project_spherical(
        (jnp.asarray(x), jnp.asarray(y), jnp.asarray(z)), 1, None, None,
        W, H))
    np.testing.assert_allclose(got, ref, rtol=0, atol=PIX_TOL)


def test_sphere_intersections():
    rng = np.random.RandomState(2)
    rays = rng.randn(3, 4, 5).astype(np.float32)
    centers = (rng.randn(3, 4, 5) * 0.1).astype(np.float32)
    radius = np.float32(2.5)
    got = tint.sphere_intersections(tuple(_t(r) for r in rays),
                                    tuple(_t(c) for c in centers),
                                    torch.tensor(radius))
    ref = jint.sphere_intersections(tuple(jnp.asarray(r) for r in rays),
                                    tuple(jnp.asarray(c) for c in centers),
                                    radius)
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=UNIT_TOL)


@pytest.mark.parametrize("kind", ["translated", "rotated", "both"])
def test_intersect_sphere_uv(kind):
    pose = _pose("rotated" if kind != "translated" else "identity")
    pos = np.array([0.05, 0.0, 0.0] if kind != "rotated" else [0, 0, 0],
                   np.float32)
    radii = np.array([100.0, 10.0, 1.5, 1.0], np.float32)
    u, v = tint.intersect_sphere_uv(_t(pose), _t(pos), _t(radii), W, H)
    uj, vj = jint.intersect_sphere_uv(jnp.asarray(pose), jnp.asarray(pos),
                                      jnp.asarray(radii), W, H)
    np.testing.assert_allclose(u.numpy(), np.asarray(uj), rtol=0,
                               atol=PIX_TOL)
    np.testing.assert_allclose(v.numpy(), np.asarray(vj), rtol=0,
                               atol=PIX_TOL)
    uv = tint.intersect_sphere(_t(pose), _t(pos), _t(radii), W, H).numpy()
    uvj = np.asarray(jint.intersect_sphere(jnp.asarray(pose),
                                           jnp.asarray(pos),
                                           jnp.asarray(radii), W, H))
    np.testing.assert_allclose(uv, uvj, rtol=0, atol=PIX_TOL)


def test_bilinear_wrap_resample():
    """Coordinates beyond both edges exercise the wrap on each axis."""
    rng = np.random.RandomState(3)
    img = rng.rand(H, W, 3).astype(np.float32)
    coords = np.stack([rng.uniform(-5, W + 5, (7, 11)),
                       rng.uniform(-3, H + 3, (7, 11))],
                      axis=-1).astype(np.float32)
    got = tres.bilinear_wrap_resample(_t(img), _t(coords)).numpy()
    ref = np.asarray(jres.bilinear_wrap_resample(jnp.asarray(img),
                                                 jnp.asarray(coords)))
    np.testing.assert_allclose(got, ref, rtol=0, atol=UNIT_TOL)


def test_resample_layers_uv():
    rng = np.random.RandomState(4)
    layers = rng.rand(3, H, W, 4).astype(np.float32)
    u = rng.uniform(-2, W + 2, (3, 5, 6)).astype(np.float32)
    v = rng.uniform(-2, H + 2, (3, 5, 6)).astype(np.float32)
    got = tres.resample_layers_uv(_t(layers), _t(u), _t(v)).numpy()
    ref = np.asarray(jres.resample_layers_uv(jnp.asarray(layers),
                                             jnp.asarray(u), jnp.asarray(v)))
    np.testing.assert_allclose(got, ref, rtol=0, atol=UNIT_TOL)
