"""The port's identity-pose sweep (plain version of csrc/sweep.cu) against
the JAX package: its row parameters, the Pallas sweep kernel K1 run in
interpret mode, and the general gather sweep.

Inputs: numpy from a seed, float32, 32x64 images, 6 planes.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from matryodshka_tpu.geometry import sweep as jsweep
from matryodshka_tpu.ops import pallas_sweep
from matryodshka_tpu_torch.geometry import sweep as tsweep
from matryodshka_tpu_torch.ops import sweep as sweep_ops

torch.set_num_threads(1)

H, W, P = 32, 64, 6


def _inputs(seed, baseline=0.032):
    rng = np.random.RandomState(seed)
    ref = rng.uniform(-1, 1, (1, H, W, 3)).astype(np.float32)
    src = rng.uniform(-1, 1, (1, H, W, 3)).astype(np.float32)
    depths = np.asarray(jsweep.inv_depths(1.0, 100.0, P), np.float32)
    intr = np.eye(3, dtype=np.float32)[None].copy()
    intr[:, 0, 0] = baseline
    return ref, src, depths, intr


def test_inv_depths():
    assert tsweep.inv_depths(1.0, 100.0, 32) == jsweep.inv_depths(
        1.0, 100.0, 32)


def _pallas_params(depths, intr):
    """K1's own row parameters, both eyes, in the port's layout
    ([1, 2, P, H]). They are evaluated under jit with flip_out=True as
    _ods_sweep_dual_stack evaluates them: XLA's fusion rounds the far
    shells' projection differently from an eager evaluation (by up to
    ~2.5e-5 * depth pixels), so only the jitted form is K1's exactly. The
    flipped kernel's lane shift is x0 + 1 (mod W)."""
    rp = jax.jit(pallas_sweep._row_params, static_argnums=(0, 3, 4),
                 static_argnames=("flip_out",))
    eyes = [rp(o, jnp.asarray(depths), jnp.asarray(intr[0]), H, W,
               flip_out=True) for o in (1, -1)]
    out = {}
    for k, src in (("y0", "y0"), ("y1", "y1"), ("fy", "fy"), ("fx", "fx"),
                   ("valid", "valid"), ("x0", "shift")):
        v = np.stack([np.asarray(e[src]) for e in eyes])[None]
        if k == "x0":
            v = (v - 1) % W
        dt = np.float32 if k in ("fy", "fx") else np.int32
        out[k] = torch.from_numpy(np.ascontiguousarray(v.astype(dt)))
    return out


def _raw(image):
    """The batch image whose preprocessing (2x - 1, which sweep_volume
    applies) gives `image` back to f32 rounding."""
    return torch.from_numpy((image + 1.0) / 2.0)


def _images(ref, src):
    return torch.from_numpy(np.stack([ref, src], 1)).permute(
        0, 1, 4, 2, 3).contiguous()


def _k1(ref, src, depths, intr):
    fg, bg = pallas_sweep._ods_sweep_dual_stack(
        jnp.asarray(ref[0]), jnp.asarray(src[0]), jnp.asarray(depths),
        jnp.asarray(intr[0]), H, W, interpret=True)
    k1 = np.concatenate([np.asarray(fg)[..., ::-1],
                         np.asarray(bg)[..., ::-1]])
    return k1.reshape(2 * P * 3, H, W)


@pytest.mark.parametrize("order", [1, -1])
def test_row_params_match_pallas(order):
    """Validity equal; sample positions y0 + fy and x0 + fx equal,
    circularly, to 4e-5 * depth pixels (min 1e-4): v and u0 come from one
    f32 projection per row, whose far-shell noise grows with the depth
    (test_torch_geometry.test_project_ods). Where a position sits on a
    pixel centre that noise may move the integer tap by one and the
    fraction from ~1 to ~0, which samples the same value."""
    _, _, depths, intr = _inputs(0, baseline=0.064)
    got = sweep_ops.row_params(order, torch.from_numpy(depths),
                               torch.from_numpy(intr[0]), H, W)
    ref = _pallas_params(depths, intr)
    eye = 0 if order == 1 else 1
    ref = {k: v[0, eye].numpy() for k, v in ref.items()}
    valid = ref["valid"] > 0
    np.testing.assert_array_equal(got["valid"].numpy() > 0, valid)
    tol = np.broadcast_to(np.maximum(1e-4, 4e-5 * depths)[:, None],
                          valid.shape)[valid]

    def circ(a, b, n):
        d = np.abs(a - b) % n
        return np.minimum(d, n - d)[valid]

    for i, f, n in (("y0", "fy", H), ("x0", "fx", W)):
        pos = got[i].numpy() + got[f].numpy()
        assert np.all(circ(pos, ref[i] + ref[f], n) <= tol), i
    np.testing.assert_array_equal(
        (got["y1"].numpy() - got["y0"].numpy()) % H, 1)


@pytest.mark.parametrize("seed,baseline", [(0, 0.032), (1, 0.064)])
def test_sweep_matches_pallas_k1(seed, baseline):
    """The plain sweep fed K1's own row parameters equals K1 (interpret
    mode, un-flipped) to 1e-5: the same taps and weights, values in
    [-1, 1], f32 rounding only."""
    ref, src, depths, intr = _inputs(seed, baseline)
    got = sweep_ops.ods_sweep_plain(_images(ref, src),
                                    _pallas_params(depths, intr)).numpy()[0]
    err = np.abs(got - _k1(ref, src, depths, intr))
    assert err.max() < 1e-5, err.max()


def test_sweep_volume_matches_pallas_k1():
    """With the port's own row parameters: their position noise (see
    test_row_params_match_pallas, <= 4e-3 px on the 100 m shell) times an
    image slope of at most 2 per pixel bounds the difference by 1e-2; the
    mean stays at 1e-4. sweep_volume takes the batch's [0, 1] images and
    preprocesses them itself."""
    ref, src, depths, intr = _inputs(5)
    vol = sweep_ops.sweep_volume(_raw(ref), _raw(src),
                                 torch.from_numpy(depths),
                                 torch.from_numpy(intr)).numpy()[0]
    err = np.abs(vol - _k1(ref, src, depths, intr))
    assert err.max() < 1e-2, err.max()
    assert err.mean() < 1e-4, err.mean()


@pytest.mark.parametrize("order", [1, -1])
def test_sweep_matches_gather_path(order):
    """Kernel semantics vs the general gather sweep of the JAX package:
    the gather path parks single far-shell pixels on f32 cancellation
    noise (PARITY.md) and evaluates each pixel's projection separately,
    with the far-shell noise of ~2.5e-5 * depth pixels. Bounds and
    baseline (0.064) are test_pallas_sweep's: 99th percentile < 2e-3,
    mean < 2e-4."""
    ref, src, depths, intr = _inputs(2, baseline=0.064)
    img = ref if order == 1 else src
    vol = sweep_ops.sweep_volume(_raw(ref), _raw(src),
                                 torch.from_numpy(depths),
                                 torch.from_numpy(intr)).numpy()[0]
    eye = 0 if order == 1 else 1
    got = vol[eye * P * 3:(eye + 1) * P * 3].transpose(1, 2, 0)
    gather = np.asarray(jsweep.ods_sphere_sweep(
        jnp.asarray(img), order, jnp.asarray(depths), jnp.eye(4)[None],
        jnp.asarray(intr)))[0]
    err = np.abs(got - gather)
    assert np.percentile(err, 99) < 2e-3, np.percentile(err, 99)
    assert err.mean() < 2e-4, err.mean()


def test_format_network_input_matches_jax():
    """The port's gather path against the JAX one, translated src pose.
    Both park on the same noisy discriminant, evaluated by two libraries:
    on the 100 m shell a pixel may park in one and not the other. Bound:
    < 0.5% of values off by more than 2e-3 (the far-shell coordinate noise
    times an image slope of 2), and the rest agree to a mean of 1e-4."""
    ref, src, depths, intr = _inputs(3, baseline=0.064)
    pose = np.eye(4, dtype=np.float32)[None]
    src_pose = pose.copy()
    src_pose[:, 0, 3] = 0.01
    t = torch.from_numpy
    got = tsweep.format_network_input(t(ref), t(src), t(pose), t(src_pose),
                                      t(pose), t(depths), t(intr)).numpy()
    want = np.asarray(jsweep.format_network_input(
        jnp.asarray(ref), jnp.asarray(src), jnp.asarray(pose),
        jnp.asarray(src_pose), jnp.asarray(pose), jnp.asarray(depths),
        jnp.asarray(intr)))
    assert got.shape == want.shape == (1, H, W, 2 * P * 3)
    err = np.abs(got - want)
    flip = err > 2e-3
    assert flip.mean() < 5e-3, flip.mean()
    assert err[~flip].mean() < 1e-4, err[~flip].mean()


@pytest.mark.parametrize("order", [1, -1])
def test_row_params_float64(order):
    """row_params follows its inputs' dtype: float64 inputs give float64
    fractions, and the float32 parameters agree with them as with K1's
    (test_row_params_match_pallas): validity equal, positions within
    max(1e-4, 4e-5 * depth) px circularly at this size."""
    _, _, depths, intr = _inputs(0, baseline=0.064)
    d, k = torch.from_numpy(depths), torch.from_numpy(intr[0])
    got = sweep_ops.row_params(order, d, k, H, W)
    ref = sweep_ops.row_params(order, d.double(), k.double(), H, W)
    assert got["fy"].dtype == torch.float32
    assert ref["fy"].dtype == ref["fx"].dtype == torch.float64
    valid = ref["valid"].numpy() > 0
    np.testing.assert_array_equal(got["valid"].numpy() > 0, valid)
    tol = np.broadcast_to(np.maximum(1e-4, 4e-5 * depths)[:, None],
                          valid.shape)[valid]
    for i, f, n in (("y0", "fy", H), ("x0", "fx", W)):
        e = np.abs((got[i].numpy() + got[f].numpy().astype(np.float64))
                   - (ref[i].numpy() + ref[f].numpy())) % n
        assert np.all(np.minimum(e, n - e)[valid] <= tol), i


def test_row_params_noise_bound_at_flagship_size():
    """The gate chip_smoke.py holds the sweep kernel's row parameters to,
    met by the plain float32 ones at 640x320, 32 planes, both eyes:
    validity equal to float64's, positions within the 64 x 32 bound
    scaled by the pixels per radian (grids.lookup_error)."""
    h, w = 320, 640
    depths = torch.tensor(jsweep.inv_depths(1.0, 100.0, 32),
                          dtype=torch.float32)
    intr = torch.eye(3)[None].clone()
    intr[0, 0, 0] = 0.032
    got = sweep_ops.dual_row_params(depths, intr, h, w)
    ref = sweep_ops.dual_row_params(depths.double(), intr.double(), h, w)
    same, err = sweep_ops.row_params_error(got, ref, depths, h, w)
    assert same and err["u"] <= 1.0 and err["v"] <= 1.0, err
