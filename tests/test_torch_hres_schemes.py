"""The test CLI's high-res re-render for every colour scheme
(matryodshka_tpu_torch/cli/test.py: build_hres_render_fn,
hres_render_plain, main with --test_type high_res) against the JAX
package's colour rule, on the CPU.

The rule is JAX `assemble_hres_rgba` (models/msi.py:312-339, the one the
hrestgt trainer supervises with): blend_psv blends the ref eye's shells
with the src eye's, blend_bg with the upsampled predicted background
colour, alpha_only and blend_bg_psv take the ref eye's shells as they
are. The reference here is that function on the JAX gather sweep's
high-res volume, followed by the JAX gather renders of its layers
(render_equirect_view, render_equirect_depth) with the PSV depths as
radii. The port's routes sweep with K1's identity-pose semantics (its
plain version here); shells span 2 m to 20 m, where the gather parks no
pixel (ROADMAP Queue 3, park-flip noise), so what is left is f32
projection noise through bilinear taps on random images: 2e-3 on [0, 1]
images and depths (tests/test_torch_cli.py's bound; the blend_psv
re-render there measured 5.3e-4).
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from matryodshka_tpu.geometry import sweep as jsweep
from matryodshka_tpu.models import msi as jmsi
from matryodshka_tpu_torch import entry, weights
from matryodshka_tpu_torch.cli import test as tcli
from matryodshka_tpu_torch.data import synthetic
from matryodshka_tpu_torch.data.loader import OdsLoader

torch.set_num_threads(1)

P, NGF = 4, 8
DEPTHS = dict(min_depth=2.0, max_depth=20.0)
TOL = 2e-3
NEW_SCHEMES = ["blend_bg", "blend_bg_psv", "alpha_only"]


def _cfg(scheme, h=64, w=128, **kw):
    return entry.flagship_cfg(height=h, width=w, num_psv_planes=P,
                              num_msi_planes=P, ngf=NGF,
                              compute_dtype="float32",
                              which_color_pred=scheme, hres_height=2 * h,
                              hres_width=2 * w, **DEPTHS, **kw)


def jax_hres(cfg, hres_ref, hres_src, low, intrinsics, tgt_pose):
    """JAX assemble_hres_rgba on the gather sweep's high-res volume, then
    the gather renders of colour and depth -> (rgb in [0, 1], depth)."""
    eye = jnp.eye(4)[None]
    depths = jnp.asarray(jsweep.inv_depths(cfg.min_depth, cfg.max_depth,
                                           cfg.num_psv_planes))
    vol = jsweep.format_network_input(
        jmsi.preprocess_image(jnp.asarray(hres_ref)),
        jmsi.preprocess_image(jnp.asarray(hres_src)), eye, eye, eye, depths,
        jnp.asarray(intrinsics))
    rgba = jmsi.assemble_hres_rgba(
        cfg.which_color_pred, {k: jnp.asarray(v) for k, v in low.items()},
        vol, cfg.num_psv_planes, cfg.hres_height, cfg.hres_width)
    tgt = jnp.asarray(tgt_pose)
    rgb = jmsi.render_equirect_view(rgba, eye, tgt, depths)
    depth = jmsi.render_equirect_depth(rgba, eye, tgt, depths)
    return np.asarray(jmsi.deprocess_image(rgb)), np.asarray(depth)


@pytest.mark.parametrize("scheme", NEW_SCHEMES)
def test_hres_render_matches_jax_rule(scheme):
    """build_hres_render_fn (the card's route: one sweep, the upsampled
    weights, the prepared assembly, one layer-stack render for image and
    depth) and hres_render_plain (the shell-streamed plain composite),
    128x256 from 64x128, against the JAX rule. Each scheme reads only
    its own inputs (hres_inputs): alpha_only no blend weights."""
    cfg = _cfg(scheme)
    rng = np.random.RandomState(8)
    hres = [rng.rand(1, 128, 256, 3).astype(np.float32) for _ in range(2)]
    low = {"blend_weights": rng.rand(1, 64, 128, P).astype(np.float32),
           "alphas": rng.rand(1, 64, 128, P).astype(np.float32),
           "bg_rgb": rng.uniform(-1, 1, (1, 64, 128, 3)).astype(np.float32)}
    intr = np.asarray([[[0.032, 0, 0], [0, 1, 0], [0, 0, 1]]], np.float32)
    tgt = np.asarray([[0.02, -0.01, 0.015]], np.float32)
    want = jax_hres(cfg, *hres, low, intr, tgt)
    needs = tcli.hres_inputs(scheme)
    assert ("blend_weights" in needs) == (scheme == "blend_bg")
    assert ("bg_rgb" in needs) == (scheme == "blend_bg")
    t = {k: torch.from_numpy(v) for k, v in low.items() if k in needs}
    ref, src = map(torch.from_numpy, hres)
    eye = torch.eye(4)[None]
    got = tcli.build_hres_render_fn(cfg)(
        ref, src, t.get("blend_weights"), t["alphas"], eye, eye, eye,
        torch.from_numpy(intr), torch.from_numpy(tgt), bg_rgb=t.get("bg_rgb"))
    plain = tcli.hres_render_plain(cfg, ref, src, t.get("blend_weights"),
                                   t["alphas"], torch.from_numpy(intr),
                                   torch.from_numpy(tgt),
                                   bg_rgb=t.get("bg_rgb"))
    for route in (got, plain):
        for g, wnt in zip(route, want):
            assert g.shape == wnt.shape == (1, 128, 256, 3)
            np.testing.assert_allclose(g.numpy(), wnt, rtol=0, atol=TOL)


def test_hres_rule_differs_by_scheme():
    """The four rules give four different renders of the same inputs (a
    rule mapped to another scheme's would pass each test above only if
    the schemes coincided)."""
    rng = np.random.RandomState(9)
    hres = [torch.from_numpy(rng.rand(1, 64, 128, 3).astype(np.float32))
            for _ in range(2)]
    low = {"blend_weights": rng.rand(1, 32, 64, P).astype(np.float32),
           "alphas": rng.rand(1, 32, 64, P).astype(np.float32),
           "bg_rgb": rng.uniform(-1, 1, (1, 32, 64, 3)).astype(np.float32)}
    low = {k: torch.from_numpy(v) for k, v in low.items()}
    intr = torch.tensor([[[0.032, 0, 0], [0, 1, 0], [0, 0, 1]]])
    eye = torch.eye(4)[None]
    rgbs = {}
    for scheme in ["blend_psv"] + NEW_SCHEMES:
        rgbs[scheme] = tcli.build_hres_render_fn(_cfg(scheme, 32, 64))(
            *hres, low["blend_weights"], low["alphas"], eye, eye, eye, intr,
            torch.tensor([[0.01, 0.0, 0.0]]), bg_rgb=low["bg_rgb"])[0]
    assert torch.equal(rgbs["alpha_only"], rgbs["blend_bg_psv"])
    for a, b in (("blend_psv", "blend_bg"), ("blend_psv", "alpha_only"),
                 ("blend_bg", "alpha_only")):
        assert (rgbs[a] - rgbs[b]).abs().max() > 1e-2, (a, b)


@pytest.mark.parametrize("scheme", ["alpha_only", "blend_bg"])
def test_main_high_res_matches_jax_rule(tmp_path, scheme):
    """The test CLI's main with --test_type high_res on the synthetic
    fixture (64x128, high res 128x256): alpha_only writes no
    blend_weights.npy and needs none, blend_bg writes bg_rgb.npy; the
    high-res PNGs equal the JAX rule applied to the saved low-res outputs
    and the loader's high-res pair within 2 of 255 levels (TOL * 255 can
    move the uint8 truncation by one level)."""
    glob_pat = synthetic.make_ods_fixture(str(tmp_path / "fix"),
                                          num_scenes=1, height=64,
                                          width=128)
    cfg = _cfg(scheme)
    params = tmp_path / "params.npz"
    tree = weights.seeded_init(cfg, 3)["params"]
    np.savez(params, step=np.asarray(0), **{
        f"params/{layer}/{leaf}": v for layer, leaves in tree.items()
        for leaf, v in leaves.items()})
    flags = ["--image_dir", str(tmp_path / "fix" / "images"),
             "--hres_image_dir", str(tmp_path / "fix" / "images"),
             "--cameras_glob", glob_pat, "--height", "64", "--width", "128",
             "--hres_height", "128", "--hres_width", "256",
             "--num_psv_planes", str(P), "--num_msi_planes", str(P),
             "--ngf", str(NGF), "--compute_dtype", "float32",
             "--min_depth", "2", "--max_depth", "20",
             "--which_color_pred", scheme, "--experiment_name", "t",
             "--num_runs", "1", "--test_type", "high_res",
             "--output_root", str(tmp_path / "out"), "--params",
             str(params), "--device", "cpu"]
    tcli.main(flags)
    root = tmp_path / "out" / "t"
    (ex,) = [d for d in os.listdir(root) if (root / d).is_dir()]
    files = os.listdir(root / ex)
    assert ("blend_weights.npy" in files) == (scheme != "alpha_only")
    assert ("bg_rgb.npy" in files) == (scheme == "blend_bg")
    low = {k: np.load(root / ex / f"{k}.npy")
           for k in tcli.hres_inputs(scheme)}
    batch = next(OdsLoader(dataclasses.replace(
        cfg, image_dir=str(tmp_path / "fix" / "images"),
        hres_image_dir=str(tmp_path / "fix" / "images"),
        cameras_glob=glob_pat), training=False, load_hres=True).batches())
    want = jax_hres(cfg, batch["hres_ref_image"], batch["hres_src_image"],
                    low, batch["intrinsics"], batch["tgt_pose"])
    from PIL import Image
    for name, w in zip(("output_hrestgt", "output_hresdepth"), want):
        got = np.asarray(Image.open(root / ex / f"{name}_{ex}.png"),
                         np.int32)
        ref = np.clip(w[0] * 255.0, 0, 255).astype(np.uint8).astype(np.int32)
        assert got.shape == ref.shape == (128, 256, 3)
        diff = np.abs(got - ref)
        assert diff.max() <= 2 and diff.mean() < 0.1, (name, diff.max())
