"""The port's full-pipeline export (matryodshka_tpu_torch/cli/export.py
with --net_only false, and --with_preprocess) against the JAX package's
(matryodshka_tpu/cli/export.py), on the CPU.

* `crop_to_multiple`, `pose_from_flag` and `make_image_processor` (RGB and
  RGBA buffers, a seeded remap .npy, both flips, padding) against the JAX
  functions: the crop and the poses bit for bit, the processed images to
  1e-6 (float32 bilinear weights in other orders).
* The --net_only false program, torch.export.save'd and loaded, against
  JAX `build_full_fn` on the same seeded flax weights and images, wrap and
  coord net, float32 and bfloat16; and the --with_preprocess program
  against JAX `make_image_processor` composed with `build_full_fn`.
  Sweep semantics: the port's program runs K1's identity-pose sweep (the
  registered op matry::sweep_volume, its plain version here), the JAX
  function on the CPU its gather sweep. Beyond ~20 m the gather parks
  single far-shell pixels on f32 noise (ROADMAP Queue 3, park-flip noise),
  so, as tests/test_torch_cli.py does, the shells span 2 m to 20 m: what
  is left is the two packages' f32 projection noise through the random
  net, bounded by 2e-3 (tests/test_torch_cli.py's bound; rgba_layers'
  colours are the sweep's, in [-1, 1]). In bfloat16 the port's program
  is held to the JAX float32 function within max(2e-2, 1.5 x the JAX
  bfloat16 function's own distance from it): the port's standing bf16
  gate (PERF.md section 2) with chip_smoke.py path 11's margin.
* The program carries the op once; `main` writes meta.json with the JAX
  CLI's keys and values plus `custom_ops` and `op_library`, and copies
  the op library (csrc/sweep_op.cpp, built with g++ here) beside the
  program; the consumer tool runs the program in a subprocess with
  PYTHONPATH="" that loads that library alone and imports no module of
  either package or JAX; flag poses with a relative pose are refused.
"""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from matryodshka_tpu.cli import export as jexport
from matryodshka_tpu.config import MatryConfig as JaxConfig
from matryodshka_tpu.training import state as jstate
from matryodshka_tpu_torch.cli import export as texport
from matryodshka_tpu_torch.config import MatryConfig
from matryodshka_tpu_torch.ops import sweep as sweep_ops

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
H, W = 32, 64
TINY = dict(height=H, width=W, num_psv_planes=4, num_msi_planes=4, ngf=8,
            min_depth=2.0, max_depth=20.0)
FLAGS = ["--height", str(H), "--width", str(W), "--num_psv_planes", "4",
         "--num_msi_planes", "4", "--ngf", "8", "--min_depth", "2.0",
         "--max_depth", "20.0", "--net_only", "false", "--platform", "cpu"]
TOL = 2e-3
BF16_GATE = 2e-2
POSE = "1,0,0,0.1, 0,1,0,-0.2, 0,0,1,0.3"


def _pair(dtype, coord=False):
    kw = dict(TINY, coord_net=coord, compute_dtype=dtype)
    jcfg = JaxConfig(**kw).validate()
    state, model = jstate.init_state(jcfg, jax.random.PRNGKey(0))
    return jcfg, MatryConfig(**kw).validate(), state, model


def _inputs(seed=1):
    """The full program's inputs (numpy): an ODS pair in [0, 1], identity
    poses, the ODS intrinsics."""
    rng = np.random.RandomState(seed)
    eye = np.eye(4, dtype=np.float32)[None]
    intr = np.asarray(texport.ODS_INTRINSICS, np.float32)[None]
    return (rng.rand(1, H, W, 3).astype(np.float32),
            rng.rand(1, H, W, 3).astype(np.float32), eye, eye, eye, intr)


def _save_load(program, tmp_path, name="p"):
    path = str(tmp_path / f"{name}.pt2")
    torch.export.save(program, path)
    return torch.export.load(path).module()


def _args(extra=()):
    return texport.build_parser().parse_args(FLAGS + ["--with_preprocess",
                                                      *extra])


# ---------------------------------------------------------------------------
# The preprocessing pieces.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(32, 64), (37, 70), (50, 81)])
def test_crop_to_multiple_matches_jax(shape):
    img = np.random.RandomState(0).rand(*shape, 3).astype(np.float32)
    want = np.asarray(jexport.crop_to_multiple(jnp.asarray(img), 16))
    got = texport.crop_to_multiple(torch.from_numpy(img), 16).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("flag", ["", POSE, "0 1 0 0 -1 0 0 0 0 0 1 2"])
def test_pose_from_flag_matches_jax(flag):
    np.testing.assert_array_equal(texport.pose_from_flag(flag),
                                  jexport.pose_from_flag(flag))
    with pytest.raises(ValueError, match="12 values"):
        texport.pose_from_flag("1 2 3")


#: (rgba, flip_y, flip_channels, padx, pady, remap): the remap field is a
#: seeded [40, 72, 2] (x, y) warp reaching past every edge.
PROCESSORS = [(False, False, False, 0, 0, False),
              (True, True, False, 0, 0, True),
              (False, False, True, 8, 3, False),
              (True, True, True, 4, 2, True)]


def _remap(tmp_path):
    rng = np.random.RandomState(7)
    y, x = np.mgrid[0:40, 0:72].astype(np.float32)
    field = np.stack([x * (W + 2) / 71 - 1, y * (H + 2) / 39 - 1], -1)
    field += rng.uniform(-0.7, 0.7, field.shape).astype(np.float32)
    path = str(tmp_path / "remap.npy")
    np.save(path, field)
    return path


@pytest.mark.parametrize("case", range(len(PROCESSORS)))
def test_image_processor_matches_jax(tmp_path, case):
    rgba, fy, fc, px, py, remap = PROCESSORS[case]
    ch = 4 if rgba else 3
    remap_file = _remap(tmp_path) if remap else None
    raw = np.random.RandomState(case).randint(
        0, 256, H * W * ch).astype(np.uint8)
    jproc = jexport.make_image_processor(None, H, W, ch, px, py, fy, fc,
                                         remap_file)
    tproc = texport.make_image_processor(None, H, W, ch, px, py, fy, fc,
                                         remap_file)
    want = np.asarray(jproc(jnp.asarray(raw)))
    got = tproc(torch.from_numpy(raw)).numpy()
    assert got.shape == want.shape and got.shape[0] % 16 == 0 \
        and got.shape[1] % 16 == 0
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


# ---------------------------------------------------------------------------
# The programs.
# ---------------------------------------------------------------------------

def _jax_full(dtype, coord, inputs):
    jcfg, _, state, model = _pair(dtype, coord)
    return np.asarray(jexport.build_full_fn(jcfg, model, state.params)(
        *map(jnp.asarray, inputs)).astype(jnp.float32))


def _tol(dtype, want32, coord, inputs):
    if dtype == "float32":
        return TOL
    spread = np.abs(_jax_full("bfloat16", coord, inputs) - want32).max()
    return max(BF16_GATE, 1.5 * float(spread))


@pytest.mark.parametrize("coord", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_full_program_matches_jax(tmp_path, dtype, coord):
    jcfg, tcfg, state, model = _pair(dtype, coord)
    tree = jax.tree.map(np.asarray, state.params)
    inputs = _inputs()
    want32 = _jax_full("float32", coord, inputs)
    program = texport.export_full(tcfg, tree, "cpu")
    ops = [n.target for n in program.graph.nodes
           if n.op == "call_function" and "matry" in str(n.target)]
    assert [str(o) for o in ops] == ["matry.sweep_volume.default"]
    with torch.no_grad():
        got = _save_load(program, tmp_path)(*map(torch.from_numpy, inputs))
        eager = texport.build_full_fn(tcfg, tree, "cpu")(
            *map(torch.from_numpy, inputs))
    assert got.dtype == tcfg.torch_compute_dtype
    assert tuple(got.shape) == (1, H, W, 4, 4)
    assert torch.equal(got, eager)
    err = np.abs(got.float().numpy() - want32).max()
    assert err <= _tol(dtype, want32, coord, inputs), err


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_preprocessed_program_matches_jax(tmp_path, dtype):
    """RGBA buffers, a seeded remap for each eye, both flips and padding,
    the identity flag poses: the port's program against the JAX
    processors composed with build_full_fn (as the JAX CLI's
    --with_preprocess function composes them, export.py:189-197)."""
    jcfg, tcfg, state, model = _pair(dtype)
    remap = _remap(tmp_path)
    extra = ["--rgba", "--flip_y", "--flip_channels", "--padx", "4",
             "--pady", "2", "--remap_ref", remap, "--remap_src", remap,
             "--compute_dtype", dtype]
    args = _args(extra)
    rng = np.random.RandomState(3)
    raws = [rng.randint(0, 256, H * W * 4).astype(np.uint8)
            for _ in range(2)]

    def jax_fn(cfg, mdl):
        procs = [jexport.make_image_processor(cfg, H, W, 4, 4, 2, True, True,
                                              remap) for _ in range(2)]
        inner = jexport.build_full_fn(cfg, mdl, state.params)
        eye = jnp.eye(4)[None]
        intr = jnp.asarray(texport.ODS_INTRINSICS, jnp.float32)[None]
        return np.asarray(inner(procs[0](jnp.asarray(raws[0]))[None],
                                procs[1](jnp.asarray(raws[1]))[None], eye,
                                eye, eye, intr).astype(jnp.float32))

    jf32, _, _, fmodel = _pair("float32")
    want32 = jax_fn(jf32, fmodel)
    tree = jax.tree.map(np.asarray, state.params)
    with torch.no_grad():
        got = _save_load(texport.export_preprocessed(tcfg, tree, args, "cpu"),
                         tmp_path)(*map(torch.from_numpy, raws))
    h, w = texport.processed_size(tcfg, args)
    assert tuple(got.shape) == want32.shape == (1, h, w, 4, 4) == tuple(
        texport.interface(tcfg, args)["outputs"]["rgba_layers"])
    tol = TOL
    if dtype == "bfloat16":
        spread = np.abs(jax_fn(jcfg, model) - want32).max()
        tol = max(BF16_GATE, 1.5 * float(spread))
    err = np.abs(got.float().numpy() - want32).max()
    assert err <= tol, (err, tol)


def test_preprocess_refuses_a_relative_pose():
    """The identity-pose sweep reads no pose: a pose2 that is not pose1
    would be ignored, so the export refuses it; equal flag poses pass."""
    _, tcfg, state, _ = _pair("float32")
    tree = jax.tree.map(np.asarray, state.params)
    with pytest.raises(ValueError, match="relative pose"):
        texport.build_preprocessed_fn(tcfg, tree, _args(["--pose2", POSE]),
                                      "cpu")
    fn = texport.build_preprocessed_fn(
        tcfg, tree, _args(["--pose1", POSE, "--pose2", POSE]), "cpu")
    assert torch.equal(fn.pose1, fn.pose2)


def test_main_meta_and_consumer(tmp_path):
    """Both CLIs export the full pipeline at --platform cpu with no
    checkpoint: the port's meta.json is the JAX CLI's plus the op it
    carries and the op library beside the program. The consumer tool, run
    as a script from another directory with PYTHONPATH="", loads that
    library, imports no module of either package or of JAX, loads the
    program and writes its output for its seeded inputs, equal to the
    in-process load's; the same for the --with_preprocess program, whose
    uint8 inputs meta.json declares, exported into the same directory."""
    flags = FLAGS + ["--checkpoint_dir", str(tmp_path / "none")]
    jexport.main(flags + ["--export_dir", str(tmp_path / "jax")])
    with pytest.warns(UserWarning, match="no checkpoint"):
        path = texport.main(flags + ["--export_dir", str(tmp_path / "t")])
    jmeta = json.loads((tmp_path / "jax" / "msi_model.meta.json").read_text())
    tmeta = json.loads((tmp_path / "t" / "msi_model.meta.json").read_text())
    assert tmeta.pop("custom_ops") == [sweep_ops.OP_NAME]
    library = tmeta.pop("op_library")
    assert library.startswith("libmatry_ops-") and library.endswith(".so")
    assert (tmp_path / "t" / library).is_file()
    assert tmeta == jmeta
    inode = os.stat(tmp_path / "t" / library).st_ino
    with pytest.warns(UserWarning, match="no checkpoint"):
        pre = texport.main(flags + ["--export_dir", str(tmp_path / "t"),
                                    "--export_name", "pre",
                                    "--with_preprocess", "--clip_to_fp16"])
    # a second export into the directory renames a new copy into place: a
    # consumer still running the first program keeps the file it mapped
    assert os.stat(tmp_path / "t" / library).st_ino != inode
    run_dir = tmp_path / "elsewhere"
    run_dir.mkdir()
    for p, dtypes in ((path, [np.float32] * 6), (pre, [np.uint8] * 2)):
        out = tmp_path / "out.npy"
        res = subprocess.run(
            [sys.executable, os.path.join(
                REPO, "matryodshka_tpu_torch", "tools", "consume_export.py"),
             p, "--device", "cpu", "--out", str(out)],
            capture_output=True, text=True, timeout=300, cwd=str(run_dir),
            env=dict(os.environ, PYTHONPATH=""))
        assert res.returncode == 0, res.stderr
        assert f"loaded op library {library} for " \
               f"['matry::sweep_volume']" in res.stdout
        imported = res.stdout.split("imported: ")[-1].strip()
        assert imported == "[]", imported
        meta = json.loads(open(p.rsplit(".", 1)[0] + ".meta.json").read())
        rng = np.random.RandomState(0)
        xs = [torch.from_numpy(
            rng.randint(0, 256, size=s).astype(np.uint8) if dt == np.uint8
            else rng.rand(*s).astype(np.float32))
            for s, dt in zip(meta["interface"]["inputs"].values(), dtypes)]
        with torch.no_grad():
            want = torch.export.load(p).module()(*xs).float().numpy()
        np.testing.assert_array_equal(np.load(out), want)
