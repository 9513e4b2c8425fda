"""The port's planar cameras, quaternion pose interpolation, zero-outside
resampling, homography path and PP / RealEstate sweeps against the JAX
package, on CPU, float32, numpy inputs from seeds.

Tolerances: images (resampled values in [0, 1] or [-1, 1]) 1e-5; pixel
coordinates 1e-4 px; points, matrices, quaternions and poses 1e-6 (f32
arithmetic in another order: a few ulp).

Where each package computes its own float32 sampling coordinates (the
sweeps, the warps, the MPI render), those coordinates agree within 1e-4
px (they are held to float64 at that bound here), so a sampled value may
differ by that much times the image's gradient: these images are held to
1e-5 + max|grad| x 1e-4 px (`warp_tol`; 2.1e-4 on the white noise in
[-1, 1] used here, gradients up to 2 per pixel). Measured: 1.1e-5 to
2.3e-5, from float32 coordinates a few ulp apart at up to 64 px.

The JAX `perspective_plane_sweep` applies its pose twice (its
`_sweep_coords` moves the points by the pose, then `project_perspective`
multiplies by K @ pose again), while the JAX package's MPI render and
RealEstate sweep apply the same pose chain once; the port applies it once.
So the port's perspective sweep is held to the JAX package's own functions
composed with the pose applied once (`jax_pp_sweep_once`), and
`test_jax_perspective_sweep_doubles_the_pose` pins the JAX function's
doubled shift.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from matryodshka_tpu.geometry import cameras as jcam
from matryodshka_tpu.geometry import grids as jgrids
from matryodshka_tpu.geometry import homography as jhom
from matryodshka_tpu.geometry import sweep as jsweep
from matryodshka_tpu.models import msi as jmsi
from matryodshka_tpu.ops import resample as jres
from matryodshka_tpu_torch.geometry import cameras as tcam
from matryodshka_tpu_torch.geometry import grids as tgrids
from matryodshka_tpu_torch.geometry import homography as thom
from matryodshka_tpu_torch.geometry import sweep as tsweep
from matryodshka_tpu_torch.models import msi as tmsi
from matryodshka_tpu_torch.ops import resample as tres

torch.set_num_threads(1)

H, W, P = 32, 64, 4
IMG_TOL = 1e-5
PX_TOL = 1e-4
MAT_TOL = 1e-6


def _t(x):
    return torch.from_numpy(np.asarray(x))


def warp_tol(*images):
    """IMG_TOL + the images' largest difference of neighbouring pixels
    (their gradient, per pixel) x PX_TOL."""
    g = max(max(np.abs(np.diff(np.asarray(im), axis=ax)).max()
                for ax in (-3, -2)) for im in images)
    return IMG_TOL + g * PX_TOL


def _close(got, want, tol, what=""):
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=tol,
                               err_msg=what)


def random_rotation(rng, max_angle=np.pi):
    """A rotation about a random axis by an angle up to max_angle."""
    axis = rng.randn(3)
    axis /= np.linalg.norm(axis)
    a = rng.uniform(-max_angle, max_angle)
    k = np.asarray([[0, -axis[2], axis[1]], [axis[2], 0, -axis[0]],
                    [-axis[1], axis[0], 0]])
    return (np.eye(3) + np.sin(a) * k + (1 - np.cos(a)) * k @ k).astype(
        np.float32)


def random_pose(rng, max_angle=0.1, max_t=0.2):
    pose = np.eye(4, dtype=np.float32)
    pose[:3, :3] = random_rotation(rng, max_angle)
    pose[:3, 3] = rng.uniform(-max_t, max_t, 3)
    return pose


def pp_intrinsics(h=H, w=W):
    """The PP loader's K: fx = cx = W/2, fy = cy = H/2."""
    return np.asarray([[w / 2, 0, w / 2], [0, h / 2, h / 2], [0, 0, 1]],
                      np.float32)


def re_intrinsics(h=H, w=W):
    """A RealEstate-style K (the fixture's normalized 0.9, 1.2, 0.5, 0.5)."""
    return np.asarray([[0.9 * w, 0, 0.5 * w], [0, 1.2 * h, 0.5 * h],
                       [0, 0, 1]], np.float32)


def jax_pp_sweep_once(image, order, depths, pose, intrinsics,
                      use_pallas=False):
    """The JAX package's perspective sweep with the pose applied once: its
    `_sweep_batch` with `project_perspective` at the identity pose after
    `apply_pose` (the same signature as `jsweep.perspective_plane_sweep`)."""
    return jsweep._sweep_batch(
        image, order, depths, pose, intrinsics, jgrids.uv_grid,
        jcam.backproject_planar,
        lambda p, o, po, K, w, h: jcam.project_perspective(
            p, o, jnp.eye(4), K, w, h))


# ---------------------------------------------------------------------------
# Cameras.
# ---------------------------------------------------------------------------

def test_backprojection_and_perspective_projection():
    rng = np.random.RandomState(0)
    depths = np.asarray([1.5, 3.0, 7.0], np.float32)
    K = re_intrinsics()
    pose = random_pose(rng)
    U, V = tgrids.uv_grid((H, W))
    JU, JV = jgrids.uv_grid((H, W))
    _close(U, JU, MAT_TOL)
    pts_t = tcam.backproject_planar(U, V, _t(depths), _t(K))
    pts_j = jcam.backproject_planar(JU, JV, jnp.asarray(depths),
                                    jnp.asarray(K))
    for a, b in zip(pts_t, pts_j):
        _close(a, b, MAT_TOL * 10)
    S = rng.uniform(-np.pi, np.pi, (H, W)).astype(np.float32)
    T = rng.uniform(-1, 1, (H, W)).astype(np.float32)
    for a, b in zip(tcam.backproject_cylindrical(_t(S), _t(T), _t(depths),
                                                 _t(K)),
                    jcam.backproject_cylindrical(S, T, depths, K)):
        _close(a, b, MAT_TOL * 10)
    got = tcam.project_perspective(pts_t, _t(K), _t(pose))
    want = jcam.project_perspective(pts_j, 1, jnp.asarray(pose),
                                    jnp.asarray(K), W, H)
    assert got.shape == (3, H, W, 2)
    _close(got, want, PX_TOL)
    # without a pose: K alone, as JAX at the identity
    _close(tcam.project_perspective(pts_t, _t(K)),
           jcam.project_perspective(pts_j, 1, jnp.eye(4), jnp.asarray(K),
                                    W, H), PX_TOL)


def _rotations(rng):
    """Random rotations, and one whose largest Shepperd pivot is each of
    the four candidates (angle pi about x, y, z; a small angle)."""
    rots = [random_rotation(rng) for _ in range(6)]
    for axis in np.eye(3):
        k = np.asarray([[0, -axis[2], axis[1]], [axis[2], 0, -axis[0]],
                        [-axis[1], axis[0], 0]])
        rots.append((np.eye(3) + 2 * k @ k).astype(np.float32))
    rots.append(random_rotation(rng, 0.05))
    return rots


def test_quaternions_match_jax():
    rng = np.random.RandomState(1)
    cases = set()
    for R in _rotations(rng):
        piv = [1 + np.trace(R), 1 + R[0, 0] - R[1, 1] - R[2, 2],
               1 - R[0, 0] + R[1, 1] - R[2, 2],
               1 - R[0, 0] - R[1, 1] + R[2, 2]]
        cases.add(int(np.argmax(piv)))
        q = tcam.quaternion_from_rotation(_t(R))
        _close(q, jcam.quaternion_from_rotation(jnp.asarray(R)), MAT_TOL)
        _close(tcam.rotation_from_quaternion(q),
               jcam.rotation_from_quaternion(jnp.asarray(q.numpy())),
               MAT_TOL)
        _close(tcam.rotation_from_quaternion(q), R, 1e-5)
    assert cases == {0, 1, 2, 3}


@pytest.mark.parametrize("kind", ["random", "near_parallel", "opposite"])
def test_slerp_matches_jax(kind):
    """Random pairs, nearly parallel pairs (sin theta <= 1e-6: the lerp),
    and pairs with a negative dot product (the shorter arc)."""
    rng = np.random.RandomState({"random": 2, "near_parallel": 3,
                                 "opposite": 4}[kind])
    for _ in range(5):
        q0 = rng.randn(4).astype(np.float32)
        q0 /= np.linalg.norm(q0)
        if kind == "random":
            q1 = rng.randn(4).astype(np.float32)
        elif kind == "near_parallel":
            q1 = q0.copy()
        else:
            q1 = -q0 + 0.3 * rng.randn(4).astype(np.float32)
        q1 = (q1 / np.linalg.norm(q1)).astype(np.float32)
        if kind == "opposite":
            assert float(q0 @ q1) < 0
        for t in (0.0, 0.3, 0.5, 1.0):
            _close(tcam.slerp(_t(q0), _t(q1), t),
                   jcam.slerp(jnp.asarray(q0), jnp.asarray(q1), t), MAT_TOL,
                   f"{kind} t={t}")


def test_interpolate_pose_matches_jax():
    rng = np.random.RandomState(5)
    for _ in range(5):
        a, b = random_pose(rng, 1.0, 1.0), random_pose(rng, 1.0, 1.0)
        for t in (0.25, 0.5):
            _close(tcam.interpolate_pose(_t(a), _t(b), t),
                   jcam.interpolate_pose(jnp.asarray(a), jnp.asarray(b), t),
                   MAT_TOL)
    # the PP loader's case: identity and a pure x translation
    src = np.eye(4, dtype=np.float32)
    src[0, 3] = -0.1
    got = tcam.interpolate_pose(torch.eye(4), _t(src))
    _close(got, jcam.interpolate_pose(jnp.eye(4), jnp.asarray(src)), MAT_TOL)
    assert float(got[0, 3]) == pytest.approx(-0.05)


# ---------------------------------------------------------------------------
# Zero-outside resampling.
# ---------------------------------------------------------------------------

def _edge_coords(rng, h, w, shape):
    """Coordinates over [-2, W+1] x [-2, H+1] (taps off every edge), with
    exact integers on and just past each border."""
    xy = np.stack([rng.uniform(-2, w + 1, shape),
                   rng.uniform(-2, h + 1, shape)], -1).astype(np.float32)
    flat = xy.reshape(-1, 2)
    edges = [(-1, 0), (0, -1), (w - 1, h - 1), (w, 0), (0, h), (w - 1, 0),
             (-0.5, 3), (w - 0.5, 2), (3, -0.5), (2, h - 0.5)]
    flat[:len(edges)] = edges
    return xy


def test_bilinear_zero_resample_matches_jax():
    rng = np.random.RandomState(6)
    img = rng.rand(7, 9, 3).astype(np.float32)
    coords = _edge_coords(rng, 7, 9, (5, 11))
    want = jres.bilinear_zero_resample(jnp.asarray(img), jnp.asarray(coords))
    got = tres.bilinear_zero_resample(_t(img), _t(coords))
    assert got.shape == (5, 11, 3) and got.dtype == torch.float32
    _close(got, want, IMG_TOL)
    # a tap wholly outside reads zero
    far = _t(np.asarray([[-1.5, 3.0], [10.5, 3.0]], np.float32))
    assert float(tres.bilinear_zero_resample(_t(img), far).abs().max()) == 0
    # leading dims pair each image with its own coordinates: one gather
    imgs = rng.rand(2, 3, 7, 9, 3).astype(np.float32)
    cs = _edge_coords(rng, 7, 9, (2, 3, 4, 6))
    want = jax.vmap(jax.vmap(jres.bilinear_zero_resample))(
        jnp.asarray(imgs), jnp.asarray(cs))
    _close(tres.bilinear_zero_resample(_t(imgs), _t(cs)), want, IMG_TOL)


@pytest.mark.parametrize("wrap", [True, False])
def test_resample_stack_matches_jax(wrap):
    rng = np.random.RandomState(7)
    img = rng.rand(8, 12, 3).astype(np.float32)
    coords = _edge_coords(rng, 8, 12, (P, 8, 12))
    _close(tres.resample_stack(_t(img), _t(coords), wrap=wrap),
           jres.resample_stack(jnp.asarray(img), jnp.asarray(coords),
                               wrap=wrap), IMG_TOL)


# ---------------------------------------------------------------------------
# The homography path.
# ---------------------------------------------------------------------------

def test_homography_algebra_matches_jax():
    rng = np.random.RandomState(8)
    num = rng.randn(5, 3).astype(np.float32)
    den = rng.randn(5, 3).astype(np.float32)
    den[0, 1] = den[3, 2] = 0.0
    _close(thom._divide_safe(_t(num), _t(den)),
           jhom._divide_safe(jnp.asarray(num), jnp.asarray(den)), MAT_TOL)
    K = re_intrinsics()
    k_inv = np.linalg.inv(K)
    rot = np.stack([random_rotation(rng, 0.2) for _ in range(P)])
    t = rng.uniform(-0.3, 0.3, (P, 3, 1)).astype(np.float32)
    n_hat = np.tile(np.asarray([[0, 0, 1.0]], np.float32), (P, 1, 1))
    a = -rng.uniform(1, 10, (P, 1, 1)).astype(np.float32)
    want = jhom.inv_homography(*(jnp.asarray(v) for v in (
        np.tile(K, (P, 1, 1)), np.tile(k_inv, (P, 1, 1)), rot, t, n_hat, a)))
    # the port's form, n_hat = +z and a = -depth: plane i at pose i
    pose = np.tile(np.eye(4, dtype=np.float32), (P, 1, 1))
    pose[:, :3, :3], pose[:, :3, 3:] = rot, t
    got = thom.mpi_homographies(_t(K), _t(k_inv), _t(pose),
                                _t(-a.reshape(P)))[range(P), range(P)]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    grid = np.transpose(np.asarray(jhom.meshgrid_abs(H, W)), (1, 2, 0))
    _close(thom.meshgrid_abs(H, W).permute(1, 2, 0), grid, 0)
    pts = np.broadcast_to(grid, (P, H, W, 3)).copy()
    tp = thom.transform_points(_t(pts), got)
    jp = jhom.transform_points(jnp.asarray(pts), want)
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=1e-5,
                               atol=PX_TOL)
    tp[0, 0, 0, 2] = 0.0
    jp = jp.at[0, 0, 0, 2].set(0.0)
    np.testing.assert_allclose(
        thom.normalize_homogeneous(tp).numpy(),
        np.asarray(jhom.normalize_homogeneous(jp)), rtol=1e-5, atol=PX_TOL)


def _mpi_case(seed, b=2, h=H, w=W):
    rng = np.random.RandomState(seed)
    rgba = rng.rand(b, h, w, P, 4).astype(np.float32)
    rgba[..., :3] = rgba[..., :3] * 2 - 1
    poses = np.stack([random_pose(rng) for _ in range(b)])
    K = np.stack([re_intrinsics(h, w), pp_intrinsics(h, w)])[:b]
    depths = np.asarray(jsweep.inv_depths(1.0, 100.0, P), np.float32)
    return rgba, poses, K, depths


def test_planar_transform_and_forward_homography_match_jax():
    rgba, poses, K, depths = _mpi_case(9)
    k_inv = np.linalg.inv(K)
    for i in range(2):
        layers = np.moveaxis(rgba[i], 2, 0)
        want = jhom.projective_forward_homography(
            jnp.asarray(layers), jnp.asarray(K[i]), jnp.asarray(k_inv[i]),
            jnp.asarray(poses[i]), jnp.asarray(depths))
        got = thom.projective_forward_homography(
            _t(layers), _t(K[i]), _t(k_inv[i]), _t(poses[i]), _t(depths))
        _close(got, want, warp_tol(np.moveaxis(rgba, -2, -4)))
        assert float(got.abs().max()) > 0.1
    # batched: both examples in one gather
    got = thom.projective_forward_homography(
        _t(np.moveaxis(rgba, 3, 1)), _t(K), _t(k_inv), _t(poses),
        _t(depths))
    for i in range(2):
        want = jhom.projective_forward_homography(
            jnp.asarray(np.moveaxis(rgba[i], 2, 0)), jnp.asarray(K[i]),
            jnp.asarray(k_inv[i]), jnp.asarray(poses[i]),
            jnp.asarray(depths))
        _close(got[i], want, warp_tol(np.moveaxis(rgba, -2, -4)))


def test_mpi_render_view_matches_jax():
    """The model's batched render_mpi_view (geometry's mpi_render_view
    over the batch in one call) against JAX's, which vmaps the JAX
    geometry function over the batch."""
    rgba, poses, K, depths = _mpi_case(10)
    want = jmsi.render_mpi_view(jnp.asarray(rgba), jnp.asarray(poses),
                                jnp.asarray(depths), jnp.asarray(K))
    got = tmsi.render_mpi_view(_t(rgba), _t(poses), _t(depths), _t(K))
    assert got.shape == (2, H, W, 3)
    _close(got, want, warp_tol(np.moveaxis(rgba, -2, -4)))


def _sweep_case(seed, b=2):
    rng = np.random.RandomState(seed)
    img = rng.uniform(-1, 1, (b, H, W, 3)).astype(np.float32)
    poses = np.stack([random_pose(rng) for _ in range(b)])
    K = np.stack([re_intrinsics(), pp_intrinsics()])[:b]
    depths = np.asarray(jsweep.inv_depths(1.0, 100.0, P), np.float32)
    return img, poses, K, depths


def test_inverse_warp_and_plane_sweep_match_jax():
    img, poses, K, depths = _sweep_case(11)
    k_inv = np.linalg.inv(K)
    for d in (1.0, 2.5, 40.0):
        _close(thom.projective_inverse_warp(_t(img[0]), d, _t(poses[0]),
                                            _t(K[0]), _t(k_inv[0])),
               jhom.projective_inverse_warp(
                   jnp.asarray(img[0]), d, jnp.asarray(poses[0]),
                   jnp.asarray(K[0]), jnp.asarray(k_inv[0])), warp_tol(img))
    want = jhom.plane_sweep(jnp.asarray(img), jnp.asarray(depths),
                            jnp.asarray(poses), jnp.asarray(K))
    got = thom.plane_sweep(_t(img), _t(depths), _t(poses), _t(K))
    assert got.shape == (2, H, W, P * 3)
    _close(got, want, warp_tol(img))
    # the warp coordinates: the JAX pixel2cam / cam2pixel chain in float64
    coords = thom.inverse_warp_coords(H, W, _t(depths), _t(poses), _t(K),
                                      _t(k_inv))
    grid = np.asarray(jhom.meshgrid_abs(H, W), np.float64).reshape(3, -1)
    for i in range(2):
        k4 = np.eye(4)
        k4[:3, :3] = K[i]
        for p, d in enumerate(depths):
            cam = np.linalg.inv(K[i].astype(np.float64)) @ grid * d
            pix = k4 @ poses[i].astype(np.float64) @ np.concatenate(
                [cam, np.ones((1, H * W))])
            uv = (pix[:2] / pix[2:3]).T.reshape(H, W, 2)
            _close(coords[i, p].double(), uv, PX_TOL)


def test_format_realestate_network_input_matches_jax():
    img, poses, K, depths = _sweep_case(12)
    src = np.roll(img, 3, axis=2)
    src_pose = poses[::-1].copy()
    want = jsweep.format_realestate_network_input(
        jnp.asarray(img), jnp.asarray(src), jnp.asarray(poses),
        jnp.asarray(src_pose), jnp.asarray(depths), jnp.asarray(K))
    got = tsweep.format_realestate_network_input(
        _t(img), _t(src), _t(poses), _t(src_pose), _t(depths), _t(K))
    assert got.shape == (2, H, W, 3 + 2 * P * 3)
    _close(got, want, warp_tol(img))
    jit = np.stack([random_pose(np.random.RandomState(13), 0.03, 0.01)] * 2)
    jit_inv = np.linalg.inv(jit)
    _close(tsweep.format_realestate_network_input(
        _t(img), _t(src), _t(poses), _t(src_pose), _t(depths), _t(K),
        jitter_pose_inv=_t(jit_inv)),
        jsweep.format_realestate_network_input(
            jnp.asarray(img), jnp.asarray(src), jnp.asarray(poses),
            jnp.asarray(src_pose), jnp.asarray(depths), jnp.asarray(K),
            jitter_pose_inv=jnp.asarray(jit_inv)), warp_tol(img))


# ---------------------------------------------------------------------------
# The perspective (PP) sweep, pose applied once.
# ---------------------------------------------------------------------------

def test_perspective_plane_sweep_matches_jax_pose_once():
    img, poses, _, depths = _sweep_case(14)
    K = np.stack([pp_intrinsics()] * 2)
    want = jax_pp_sweep_once(jnp.asarray(img), 1, jnp.asarray(depths),
                             jnp.asarray(poses), jnp.asarray(K))
    got = tsweep.perspective_plane_sweep(_t(img), _t(depths), _t(poses),
                                         _t(K))
    assert got.shape == (2, H, W, P * 3)
    _close(got, want, warp_tol(img))
    # the coordinates themselves, against float64
    uv = tsweep.perspective_sweep_coords(H, W, _t(depths), _t(poses[0]),
                                         _t(K[0])).double()
    U, V = np.meshgrid(np.linspace(-1 + 1 / W, 1 - 1 / W, W),
                       np.linspace(-1 + 1 / H, 1 - 1 / H, H))
    k = K[0].astype(np.float64)
    for p, d in enumerate(depths):
        pts = np.stack([d * U * k[0, 2] / k[0, 0], d * V * k[1, 2] / k[1, 1],
                        d * np.ones_like(U), np.ones_like(U)]).reshape(4, -1)
        cam = (poses[0].astype(np.float64) @ pts)[:3]
        pix = k @ cam
        want_uv = (pix[:2] / pix[2:]).T.reshape(H, W, 2)
        _close(uv[p], want_uv, PX_TOL)


def test_format_network_input_pp_matches_jax_pose_once(monkeypatch):
    """format_network_input(input_type="PP") against JAX's with its
    perspective sweep replaced by the pose-once composition: both eyes at
    pose @ ref_pose_inv, and with a jitter pose."""
    monkeypatch.setattr(jsweep, "perspective_plane_sweep", jax_pp_sweep_once)
    rng = np.random.RandomState(15)
    ref, src = (rng.uniform(-1, 1, (1, H, W, 3)).astype(np.float32)
                for _ in range(2))
    ref_pose = np.eye(4, dtype=np.float32)[None]
    src_pose = ref_pose.copy()
    src_pose[0, 0, 3] = -0.1
    interp = np.asarray(jcam.interpolate_pose(jnp.asarray(ref_pose[0]),
                                              jnp.asarray(src_pose[0])))
    ref_inv = np.linalg.inv(interp)[None]
    K = pp_intrinsics()[None]
    depths = np.asarray(jsweep.inv_depths(1.0, 100.0, P), np.float32)
    jit_inv = np.linalg.inv(random_pose(rng, 0.03, 0.01))[None]
    for j in (None, jit_inv):
        want = jsweep.format_network_input(
            jnp.asarray(ref), jnp.asarray(src), jnp.asarray(ref_pose),
            jnp.asarray(src_pose), jnp.asarray(ref_inv), jnp.asarray(depths),
            jnp.asarray(K), input_type="PP",
            jitter_pose_inv=None if j is None else jnp.asarray(j))
        got = tsweep.format_network_input(
            _t(ref), _t(src), _t(ref_pose), _t(src_pose), _t(ref_inv),
            _t(depths), _t(K), input_type="PP",
            jitter_pose_inv=None if j is None else _t(j))
        _close(got, want, warp_tol(ref, src))


def test_jax_perspective_sweep_doubles_the_pose():
    """A column ramp swept at one plane (depth 2, fx = 8) under a 0.1 m x
    translation: the JAX perspective_plane_sweep shifts u by 0.8 px, twice
    the 0.4 px of projecting with the pose applied once, which the port's
    sweep gives (within 1e-3 px, away from the wrap seam)."""
    h, w = 8, 16
    ramp = np.broadcast_to(np.arange(w, dtype=np.float32)[None, :, None],
                           (1, h, w, 3)).copy()
    depths = np.asarray([2.0], np.float32)
    K = pp_intrinsics(h, w)[None]
    assert K[0, 0, 0] == 8.0
    pose = np.eye(4, dtype=np.float32)[None].copy()
    pose[0, 0, 3] = 0.1
    eye = np.eye(4, dtype=np.float32)[None]

    def jax_sweep(po):
        return np.asarray(jsweep.perspective_plane_sweep(
            jnp.asarray(ramp), 1, jnp.asarray(depths), jnp.asarray(po),
            jnp.asarray(K)))[0, :, 3:12, 0]

    def port_sweep(po):
        return tsweep.perspective_plane_sweep(
            _t(ramp), _t(depths), _t(po), _t(K)).numpy()[0, :, 3:12, 0]

    once = 8.0 * 0.1 / 2.0
    _close(port_sweep(pose) - port_sweep(eye), np.full((h, 9), once), 1e-3)
    _close(jax_sweep(pose) - jax_sweep(eye), np.full((h, 9), 2 * once),
           1e-3)
