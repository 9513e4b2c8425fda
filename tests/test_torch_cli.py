"""The port's test CLI (matryodshka_tpu_torch/cli/test.py) against the JAX
package's (matryodshka_tpu/cli/test.py), on CPU, where every kernel
wrapper of the port runs its plain version:

* build_infer_fn for the four colour schemes, and with ftb=True for the
  three that render a layer stack, against the JAX build_infer_fn (which
  on CPU takes its gather path: gather sweep, flax net, assemble_rgba,
  gather render), same flax weights and images;
* the high-res re-render against build_hres_render_fn_fused(interpret=True)
  at 64x128 -> 128x256 (blend_psv; the other schemes'
  re-render is tests/test_torch_hres_schemes.py);
* the perspective and ODS-eye re-renders (psp, src_output_image,
  ref_output_image) against the JAX build_infer_fn;
* main() end to end on the synthetic fixture (matryodshka_tpu.data.
  synthetic.make_ods_fixture), low-res and then high_res, and with the
  re-renders, against the JAX main() on an orbax checkpoint of the same
  parameters: the same files, with the same contents up to the bounds
  below; --shard_shells true on one device changes no file;
* the PP and REALESTATE_PP recipes' train -> test -> eval lifecycle
  through the port's CLIs (the port's MPI route itself is held to the JAX
  package in tests/test_torch_pp_train.py).

Shells span 2 m to 20 m: beyond that the JAX gather sweep parks single
far-shell pixels on f32 noise (ROADMAP Queue 3, park-flip noise), which
tests/test_torch_pipeline.py bounds separately; here the gaps left are the
two packages' f32 projection noise (~2.5e-5 * depth px, so <= 5e-4 px at
20 m) through the random net, bounded by 2e-3 (the bound
tests/test_torch_pipeline.py sets at 20 m) on renders in [-1, 1] (halved
by deprocess_image) and on the net's outputs in [0, 1].
"""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from matryodshka_tpu.cli import test as jcli
from matryodshka_tpu.config import MatryConfig as JaxConfig
from matryodshka_tpu.training import state as state_lib
from matryodshka_tpu_torch import entry
from matryodshka_tpu_torch.cli import test as tcli
from matryodshka_tpu_torch.data import synthetic as mpi_synthetic
from matryodshka_tpu_torch.training.checkpoint import restore_params

torch.set_num_threads(1)

P, NGF = 4, 8
SCHEMES = ["blend_psv", "blend_bg", "blend_bg_psv", "alpha_only"]
DEPTHS = dict(min_depth=2.0, max_depth=20.0)
TOL = 2e-3


def _cfgs(h, w, scheme="blend_psv", **kw):
    base = dict(height=h, width=w, num_psv_planes=P, num_msi_planes=P,
                ngf=NGF, compute_dtype="float32", which_color_pred=scheme,
                **DEPTHS, **kw)
    return JaxConfig(use_pallas=True, **base).validate(), \
        entry.flagship_cfg(**base)


@pytest.mark.parametrize("scheme", SCHEMES)
def test_infer_fn_matches_jax(scheme):
    """Measured max error: 8.5e-5 (output_depth) to 1.3e-3 (rgba_layers,
    whose colours are the sweep's, in [-1, 1])."""
    jcfg, tcfg = _cfgs(32, 64, scheme)
    state, model = state_lib.init_state(jcfg, jax.random.PRNGKey(0))
    params = entry.make_params(
        tcfg, flax_params=jax.tree.map(np.asarray, state.params), device="cpu")
    batch = entry.synthetic_batch(tcfg, seed=1, device="cpu",
                                  tgt_pos=(0.03, -0.01, 0.02))
    outputs = "tgt_image_blend_weights_alphas_rgba_layers"
    got = tcli.build_infer_fn(tcfg, params, outputs)(batch)
    want = jcli.build_infer_fn(jcfg, model, outputs, allow_fused=False)(
        state.params, {k: jnp.asarray(v.numpy()) for k, v in batch.items()})
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].shape == want[k].shape, k
        np.testing.assert_allclose(got[k].float().numpy(),
                                   np.asarray(want[k]), rtol=0, atol=TOL,
                                   err_msg=k)


@pytest.mark.parametrize("scheme", ["blend_psv", "blend_bg"])
def test_infer_fn_rerenders_match_jax(scheme):
    """psp (the four 270 x 480 perspective windows at 32 x 64 input),
    src_output_image and ref_output_image against the JAX CLI's, TOL
    (module docstring)."""
    jcfg, tcfg = _cfgs(32, 64, scheme)
    state, model = state_lib.init_state(jcfg, jax.random.PRNGKey(2))
    params = entry.make_params(
        tcfg, flax_params=jax.tree.map(np.asarray, state.params), device="cpu")
    batch = entry.synthetic_batch(tcfg, seed=3, device="cpu",
                                  tgt_pos=(0.02, 0.01, -0.03))
    outputs = "psp_src_output_image_ref_output_image"
    got = tcli.build_infer_fn(tcfg, params, outputs)(batch)
    want = jcli.build_infer_fn(jcfg, model, outputs, allow_fused=False)(
        state.params, {k: jnp.asarray(v.numpy()) for k, v in batch.items()})
    assert sorted(got) == sorted(want) == sorted(
        [f"output_psp{i}" for i in range(4)] + ["output_ref", "output_src"])
    for k in want:
        assert got[k].shape == want[k].shape, k
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=0, atol=TOL, err_msg=k)
    assert got["output_psp0"].shape == (1, 270, 480, 3)
    assert got["output_src"].shape == (1, 32, 64, 3)
    assert float((got["output_src"] - got["output_ref"]).abs().max()) > 1e-3


@pytest.mark.parametrize("scheme", SCHEMES[1:])
def test_infer_fn_ftb_matches_jax(scheme):
    """build_infer_fn(ftb=True), whose layer-stack render gives image and
    depth from one call (front to back with early termination on the
    card; the plain composite here), against the JAX build_infer_fn, TOL
    (module docstring)."""
    jcfg, tcfg = _cfgs(32, 64, scheme)
    state, model = state_lib.init_state(jcfg, jax.random.PRNGKey(1))
    params = entry.make_params(
        tcfg, flax_params=jax.tree.map(np.asarray, state.params), device="cpu")
    batch = entry.synthetic_batch(tcfg, seed=2, device="cpu",
                                  tgt_pos=(-0.02, 0.01, 0.03))
    got = tcli.build_infer_fn(tcfg, params, "tgt_image", ftb=True)(batch)
    want = jcli.build_infer_fn(jcfg, model, "tgt_image", allow_fused=False)(
        state.params, {k: jnp.asarray(v.numpy()) for k, v in batch.items()})
    assert sorted(got) == sorted(want) == ["output_depth", "output_image"]
    for k in want:
        assert got[k].shape == want[k].shape, k
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=0, atol=TOL, err_msg=k)


def test_hres_render_matches_jax_fused():
    """The JAX fused high-res path (chunked K1 sweep, hres prepared
    assembly, ladder render + gather caps, interpret mode) and the port's
    (K1 sweep, hres prepared assembly, layer-stack render) on the same
    inputs. Both sweeps have K1's semantics, so what differs is the f32
    noise of the row parameters and of the uv tables (~1e-4 px at 256
    wide), on random images whose slopes reach 2 per pixel in [-1, 1]:
    bound 1e-3 on [0, 1] outputs (measured 5.3e-4; 0.95% of values above
    1e-4)."""
    jcfg, tcfg = _cfgs(64, 128, hres_height=128, hres_width=256)
    rng = np.random.RandomState(6)
    intr = np.eye(3, dtype=np.float32)[None].copy()
    intr[:, 0, 0] = 0.032
    eye = np.eye(4, dtype=np.float32)[None]
    args = (rng.rand(1, 128, 256, 3).astype(np.float32),
            rng.rand(1, 128, 256, 3).astype(np.float32),
            rng.rand(1, 64, 128, P).astype(np.float32),
            rng.rand(1, 64, 128, P).astype(np.float32), eye, eye, eye, intr,
            np.array([[0.02, 0.01, -0.015]], np.float32))
    fused = jcli.build_hres_render_fn_fused(jcfg, interpret=True)
    want = fused(*[jnp.asarray(a) for a in args])
    got = tcli.build_hres_render_fn(tcfg)(*[torch.from_numpy(a)
                                            for a in args])
    for g, wnt in zip(got, want):
        assert g.shape == wnt.shape == (1, 128, 256, 3)
        np.testing.assert_allclose(g.numpy(), np.asarray(wnt), rtol=0,
                                   atol=1e-3)


@pytest.mark.parametrize("training", [False, True])
def test_loader_matches_jax(tmp_path, training):
    """The port's OdsLoader (data/loader.py, copied parsers and image IO)
    yields the JAX OdsLoader's batches: evaluation order with the high-res
    images, and the seeded shuffled training order."""
    from matryodshka_tpu.data import loader as jloader
    from matryodshka_tpu.data import synthetic
    from matryodshka_tpu_torch.data import loader as tloader

    glob_pat = synthetic.make_ods_fixture(str(tmp_path), num_scenes=2,
                                          height=32, width=64)
    # the port reads the high-res pair from hres_image_dir, the JAX loader
    # from image_dir: the same directory keeps the two like for like
    flags = dict(cameras_glob=glob_pat, image_dir=str(tmp_path / "images"),
                 hres_image_dir=str(tmp_path / "images"), hres_height=64,
                 hres_width=128)
    jcfg, tcfg = _cfgs(32, 64, **flags)
    if training:
        jl, tl = jloader.OdsLoader(jcfg), tloader.make_loader(tcfg)
    else:
        jl = jloader.OdsLoader(jcfg.replace(supervision="tgt_hrestgt"),
                               training=False)
        tl = tloader.OdsLoader(tcfg, training=False, load_hres=True)
    n = 0
    for jb, tb in zip(jl.batches(), tl.batches()):
        assert sorted(jb) == sorted(tb)
        for k in jb:
            if isinstance(jb[k], np.ndarray):
                np.testing.assert_array_equal(tb[k], jb[k], err_msg=k)
            else:
                assert tb[k] == jb[k], k
        n += 1
        if n == 5:
            break
    assert n == (5 if training else 4)


def _files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


def test_main_matches_jax_main(tmp_path):
    """Both CLIs over one example of the synthetic fixture, low-res then
    high_res (128x256): the same file names; blend_weights.npy and
    alphas.npy within TOL; every PNG within 2 of 255 levels per pixel (a
    float difference of TOL * 255 = 0.5 can move the uint8 truncation by
    one level, twice for the [-1, 1] layer colours), with a mean under
    0.1 level."""
    from matryodshka_tpu.data import synthetic
    from matryodshka_tpu.training.checkpoint import CheckpointManager
    from PIL import Image

    glob_pat = synthetic.make_ods_fixture(str(tmp_path / "fix"),
                                          num_scenes=1, height=64,
                                          width=128)
    jcfg, _ = _cfgs(64, 128)
    state, _ = state_lib.init_state(jcfg, jax.random.PRNGKey(0))
    CheckpointManager(str(tmp_path / "ckpt" / "t")).save(state)
    flat = {}

    def walk(node, prefix):
        for k, v in node.items():
            if isinstance(v, dict):
                walk(v, f"{prefix}{k}/")
            else:
                flat[prefix + k] = np.asarray(v)

    walk(state.params, "")
    flat["step"] = np.asarray(int(state.step))
    np.savez(tmp_path / "params.npz", **flat)

    flags = ["--image_dir", str(tmp_path / "fix" / "images"),
             "--hres_image_dir", str(tmp_path / "fix" / "images"),
             "--cameras_glob", glob_pat, "--height", "64", "--width", "128",
             "--hres_height", "128", "--hres_width", "256",
             "--num_psv_planes", str(P), "--num_msi_planes", str(P),
             "--ngf", str(NGF), "--compute_dtype", "float32",
             "--min_depth", "2", "--max_depth", "20",
             "--experiment_name", "t", "--num_runs", "1",
             "--test_type", "high_res"]
    jcli.main(flags + ["--output_root", str(tmp_path / "jax"),
                       "--checkpoint_dir", str(tmp_path / "ckpt")])
    tcli.main(flags + ["--output_root", str(tmp_path / "torch"),
                       "--params", str(tmp_path / "params.npz"),
                       "--device", "cpu"])

    jroot, troot = tmp_path / "jax" / "t", tmp_path / "torch" / "t"
    names = _files(jroot)
    assert names == _files(troot)
    assert any(n.endswith(".npy") for n in names)
    assert any("output_hrestgt_" in n for n in names)
    for name in names:
        if name.endswith(".npy"):
            np.testing.assert_allclose(np.load(troot / name),
                                       np.load(jroot / name), rtol=0,
                                       atol=TOL, err_msg=name)
        elif name.endswith(".png"):
            a = np.asarray(Image.open(troot / name), np.int32)
            b = np.asarray(Image.open(jroot / name), np.int32)
            diff = np.abs(a - b)
            assert diff.max() <= 2 and diff.mean() < 0.1, (name, diff.max())
        else:
            assert (troot / name).read_text() == (jroot / name).read_text()
    tree, step = restore_params(str(tmp_path / "params.npz"))
    assert step == int(state.step) and "conv1_1" in tree["params"]


def test_main_rerenders_and_shard_shells_match_jax(tmp_path):
    """Both CLIs over one fixture example with psp, src_output_image and
    ref_output_image among --test_outputs: the same files (output_ptgt0-3,
    output_src, output_ref), each PNG within test_main_matches_jax_main's
    bound. --shard_shells true on one device writes the same files, byte
    for byte, as without it (the JAX CLI ignores it there)."""
    from matryodshka_tpu.data import synthetic
    from matryodshka_tpu.training.checkpoint import CheckpointManager
    from PIL import Image

    glob_pat = synthetic.make_ods_fixture(str(tmp_path / "fix"),
                                          num_scenes=1, height=32, width=64)
    jcfg, _ = _cfgs(32, 64)
    state, _ = state_lib.init_state(jcfg, jax.random.PRNGKey(3))
    CheckpointManager(str(tmp_path / "ckpt" / "t")).save(state)
    flat = {"step": np.asarray(int(state.step))}
    for layer, leaves in state.params["params"].items():
        for leaf, v in leaves.items():
            flat[f"params/{layer}/{leaf}"] = np.asarray(v)
    np.savez(tmp_path / "params.npz", **flat)
    outputs = "tgt_image_psp_src_output_image_ref_output_image"
    flags = ["--image_dir", str(tmp_path / "fix" / "images"),
             "--cameras_glob", glob_pat, "--height", "32", "--width", "64",
             "--num_psv_planes", str(P), "--num_msi_planes", str(P),
             "--ngf", str(NGF), "--compute_dtype", "float32",
             "--min_depth", "2", "--max_depth", "20",
             "--experiment_name", "t", "--num_runs", "1",
             "--checkpoint_dir", str(tmp_path / "ckpt"),
             "--test_outputs", outputs]
    jcli.main(flags + ["--output_root", str(tmp_path / "jax")])
    for name, extra in (("torch", []), ("shard", ["--shard_shells", "true"])):
        tcli.main(flags + ["--output_root", str(tmp_path / name),
                           "--params", str(tmp_path / "params.npz"),
                           "--device", "cpu"] + extra)
    jroot, troot, sroot = (tmp_path / n / "t" for n in
                           ("jax", "torch", "shard"))
    names = _files(jroot)
    assert names == _files(troot) == _files(sroot)
    for part in ("output_ptgt0_", "output_ptgt3_", "output_src_",
                 "output_ref_"):
        assert any(part in n for n in names), part
    for name in names:
        assert (troot / name).read_bytes() == (sroot / name).read_bytes()
        if name.endswith(".png"):
            a = np.asarray(Image.open(troot / name), np.int32)
            b = np.asarray(Image.open(jroot / name), np.int32)
            diff = np.abs(a - b)
            assert diff.max() <= 2 and diff.mean() < 0.1, (name, diff.max())


#: The PP and RealEstate recipes (scripts/train/*.sh) and the fixture each
#: runs on here: the RealEstate training loader needs (10-1)*10+1 = 91
#: frames a clip.
MPI_RECIPES = {
    "PP": ("pp-wotemp-elpips-coord", functools.partial(
        mpi_synthetic.make_perspective_fixture, height=32, width=64)),
    "REALESTATE_PP": ("realestate-wotemp-elpips-coord", functools.partial(
        mpi_synthetic.make_realestate_fixture, frames=91, height=32,
        width=64))}


@pytest.mark.parametrize("input_type", list(MPI_RECIPES))
def test_mpi_recipe_lifecycle(tmp_path, input_type):
    """The PP / RealEstate recipe's flags (its data paths and the absent
    E-LPIPS weights replaced; tiny sizes appended) through the port's
    train CLI for 2 steps, then its test CLI and its evaluator on the
    checkpoint (JAX tests/test_cli_integration.py:79's lifecycle): the
    output_tgt images, the blend weights, no depth output, finite scores
    (every CLI on the CPU)."""
    from test_torch_train_elpips import _recipe_flags

    from matryodshka_tpu_torch.cli import evaluate as tevaluate
    from matryodshka_tpu_torch.cli import train as ttrain
    recipe, make = MPI_RECIPES[input_type]
    flags = _recipe_flags(os.path.join(os.path.dirname(__file__), "..",
                                       "scripts", "train", f"{recipe}.sh"))
    args = ttrain.build_parser().parse_args(flags)
    assert (args.input_type, args.which_loss, args.coord_net) == (
        input_type, "elpips", True)
    i = flags.index("--elpips_weight_path")
    del flags[i:i + 2]
    glob_pat = make(str(tmp_path / "fix"))
    flags += ["--cameras_glob", glob_pat,
              "--image_dir", str(tmp_path / "fix" / "images"),
              "--checkpoint_dir", str(tmp_path / "ckpt"),
              "--height", "32", "--width", "64",
              "--num_psv_planes", str(P), "--num_msi_planes", str(P),
              "--ngf", str(NGF), "--device", "cpu"]
    ttrain.main(flags + ["--max_steps", "2", "--summary_freq", "1",
                         "--save_latest_freq", "100"])
    assert (tmp_path / "ckpt" / recipe / "2" / "params.npz").exists()
    out = tmp_path / "out"
    tcli.main(flags + ["--output_root", str(out), "--num_runs", "2",
                       "--test_outputs", "tgt_image_blend_weights_alphas"])
    root = out / recipe
    dirs = sorted(d for d in root.iterdir() if d.is_dir())
    assert len(dirs) == (2 if input_type == "PP" else 1)
    files = os.listdir(dirs[0])
    assert f"output_tgt_{dirs[0].name}.png" in files
    assert "blend_weights.npy" in files and "alphas.npy" in files
    assert not any(f.startswith("output_depth_") for f in files)
    table = tevaluate.main(["--result_root", str(root), "--device", "cpu"])
    assert len(table["per_example"]) == len(dirs)
    assert np.isfinite(table["avg_psnr"]) and np.isfinite(table["avg_ssim"])
