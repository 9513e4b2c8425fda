"""The port against the committed reference goldens.

tests/goldens/reference_goldens.npz holds the outputs of a numpy-only
transcription of the reference's TF graphs (tests/test_reference_goldens.py
holds the JAX package to it). These are the same 13 test functions for
`matryodshka_tpu_torch`, at that file's tolerances: grids, backprojection,
ODS / spherical projection, ray-shell intersections (ERP, ODS eye and
perspective window; identity, translated and jittered poses), wrap-around
resampling, the double-eye gather sweep, over-compositing and the ERP and
ODS-eye renders. Float32 on the CPU.
"""

import os

import numpy as np
import pytest
import torch

from matryodshka_tpu_torch.geometry import cameras, grids, intersect, render
from matryodshka_tpu_torch.geometry import sweep as sweep_lib
from matryodshka_tpu_torch.ops.resample import bilinear_wrap_resample

G = np.load(os.path.join(os.path.dirname(__file__), "goldens",
                         "reference_goldens.npz"))
H, W, P = 32, 64, 6
DEPTHS = torch.tensor(sweep_lib.inv_depths(1.0, 100.0, P),
                      dtype=torch.float32)
INTR = torch.eye(3)
INTR[0, 0] = 0.032
ATOL = 2e-4  # float32 transcendentals along two independent paths


def _t(a):
    return torch.as_tensor(np.asarray(a, np.float32))


def test_inv_depths():
    np.testing.assert_allclose(
        np.asarray(sweep_lib.inv_depths(1.0, 100.0, 32), np.float32),
        G["inv_depths_32"], rtol=1e-6)


def test_grids():
    S, T = grids.lat_long_grid((H, W))
    np.testing.assert_allclose(S.numpy(), G["lat_long_S"], atol=1e-6)
    np.testing.assert_allclose(T.numpy(), G["lat_long_T"], atol=1e-6)
    U, V = grids.uv_grid((H, W))
    np.testing.assert_allclose(U.numpy(), G["uv_grid_U"], atol=1e-6)
    np.testing.assert_allclose(V.numpy(), G["uv_grid_V"], atol=1e-6)


def test_backproject_spherical():
    S, T = grids.lat_long_grid((H, W))
    pts = cameras.backproject_spherical(S, T, DEPTHS)
    np.testing.assert_allclose(torch.stack(pts).numpy(),
                               G["backproject_spherical"], atol=1e-4)


@pytest.mark.parametrize("order,key", [(1, "project_ods_l"),
                                       (-1, "project_ods_r")])
def test_project_ods(order, key):
    """As the JAX test: a pixel may park in one derivation and not the
    other (an f32 discriminant sign on the far shells); no other pixel
    may disagree, and over 99% agree without that escape."""
    S, T = grids.lat_long_grid((H, W))
    pts = cameras.backproject_spherical(S, T, DEPTHS)
    got = cameras.project_ods(pts, order, INTR, W, H).numpy()
    exp = G[key]
    close = np.isclose(got, exp, atol=1e-2)
    either_parked = (np.all(np.isclose(got, 1.0, atol=1e-5), axis=-1)
                     | np.all(np.isclose(exp, 1.0, atol=1e-5), axis=-1))
    assert (close.all(axis=-1) | either_parked).all()
    assert close.all(axis=-1).mean() > 0.99


def test_project_spherical():
    S, T = grids.lat_long_grid((H, W))
    pts = cameras.backproject_spherical(S, T, DEPTHS)
    uv = cameras.project_spherical(pts, W, H)
    np.testing.assert_allclose(uv.numpy(), G["project_spherical"],
                               atol=ATOL)


@pytest.mark.parametrize("key,pose,center", [
    ("intersect_sphere_id_offs", np.eye(4), [0.05, -0.02, 0.03]),
    ("intersect_sphere_jit_offs", None, [-0.04, 0.01, 0.06]),
])
def test_intersect_sphere(key, pose, center):
    pose = G["jitter_pose"] if pose is None else pose
    uv = intersect.intersect_sphere(_t(pose), _t(center), DEPTHS, W, H)
    np.testing.assert_allclose(uv.numpy(), G[key], atol=2e-3)


def test_intersect_ods():
    uv = intersect.intersect_ods(torch.eye(4), None, 1, INTR, DEPTHS, W, H)
    np.testing.assert_allclose(uv.numpy(), G["intersect_ods_l"], atol=2e-3)
    uv = intersect.intersect_ods(_t(G["jitter_pose"]), None, -1, INTR,
                                 DEPTHS, W, H)
    np.testing.assert_allclose(uv.numpy(), G["intersect_ods_jit_r"],
                               atol=2e-3)


def test_intersect_perspective():
    uv = intersect.intersect_perspective(
        torch.eye(4), _t([0.02, -0.01, 0.04]), DEPTHS, W, H, tgt_width=32,
        tgt_height=16)
    np.testing.assert_allclose(uv.numpy(), G["intersect_persp"], atol=2e-3)


def test_wrap_resample():
    img, coords = G["resample_img"], G["resample_coords"]
    got = np.stack([bilinear_wrap_resample(_t(img[i]), _t(coords[i])).numpy()
                    for i in range(img.shape[0])])
    np.testing.assert_allclose(got, G["resample_out"], atol=1e-5)


@pytest.mark.parametrize("order,key", [(1, "sweep_l"), (-1, "sweep_r")])
def test_full_ods_sweep(order, key):
    got = sweep_lib.ods_sphere_sweep(_t(G["sweep_image"]), order, DEPTHS,
                                     torch.eye(4)[None], INTR[None]).numpy()
    err = np.abs(got[0] - G[key])
    # the same park-boundary escape as test_project_ods
    assert np.median(err) < 1e-5
    assert (err < 5e-3).mean() > 0.99


def test_over_composite_goldens():
    rgba = _t(G["render_rgba"])
    np.testing.assert_allclose(render.over_composite(rgba).numpy(),
                               G["over_composite"][0], atol=1e-5)
    np.testing.assert_allclose(render.over_composite_depth(rgba).numpy(),
                               G["over_composite_depth"][0], atol=1e-5)


def test_render_equirect_golden():
    got = render.render_equirect_view(_t(G["render_rgba"]), torch.eye(4),
                                      _t([0.05, -0.02, 0.03]), DEPTHS)
    np.testing.assert_allclose(got.numpy(), G["render_equirect"], atol=2e-3)


def test_render_ods_golden():
    got = render.render_ods_view(_t(G["render_rgba"]), 1, torch.eye(4),
                                 None, DEPTHS, INTR)
    np.testing.assert_allclose(got.numpy(), G["render_ods_l"], atol=2e-3)
