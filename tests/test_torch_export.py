"""The port's net-only export (matryodshka_tpu_torch/cli/export.py)
against the JAX package's (matryodshka_tpu/cli/export.py), on CPU.

* The exported program, saved and loaded back with torch.export, against
  JAX `build_net_only_fn` on the same flax weights and input, wrap and
  coord net: float32 to 1e-5 (measured 2.3e-6); bfloat16 within the JAX
  bf16 function's own distance from its float32 one (each package rounds
  at its own points: measured 1.5e-2 and 1.8e-2 against 2.3e-2 and
  2.5e-2), and away from the float32 program, so the program keeps the
  net's cast. The loaded program equals the eager module bit for bit.
* `atlas_pack` against JAX's for 64 and 32 channels, bit for bit;
  `clip_params_to_fp16` against JAX's.
* `main`: meta.json's keys and values against the JAX CLI's (both at
  --platform cpu); the artifact run by the port's consumer tool in a
  subprocess as a script, importing neither package; the card default.

The full pipeline and --with_preprocess are tests/test_torch_export_full.py.
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
from matryodshka_tpu.models import unet as junet
from matryodshka_tpu.training import state as jstate
from matryodshka_tpu_torch.cli import export as texport
from matryodshka_tpu_torch.config import MatryConfig
from matryodshka_tpu_torch.models import unet as tunet

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = dict(height=32, width=64, num_psv_planes=4, num_msi_planes=4, ngf=8,
            net_only=True)
FLAGS = ["--height", "32", "--width", "64", "--num_psv_planes", "4",
         "--num_msi_planes", "4", "--ngf", "8", "--net_only", "true"]


def _pair(coord, dtype):
    kw = dict(TINY, coord_net=coord, compute_dtype=dtype)
    jcfg = JaxConfig(**kw).validate()
    state, model = jstate.init_state(jcfg, jax.random.PRNGKey(0))
    return jcfg, MatryConfig(**kw).validate(), state, model


def _x():
    return np.random.RandomState(0).rand(1, 32, 64, 24).astype(np.float32)


def _loaded(tcfg, tree, tmp_path):
    path = str(tmp_path / "p.pt2")
    torch.export.save(texport.export_net_only(tcfg, tree, "cpu"), path)
    with torch.no_grad():
        return torch.export.load(path).module()(
            torch.from_numpy(_x())).numpy()


@pytest.mark.parametrize("coord", [False, True])
def test_program_matches_jax_float32(tmp_path, coord):
    jcfg, tcfg, state, model = _pair(coord, "float32")
    want = np.asarray(jexport.build_net_only_fn(jcfg, model, state.params)(
        jnp.asarray(_x())))
    tree = jax.tree.map(np.asarray, state.params)
    got = _loaded(tcfg, tree, tmp_path)
    assert got.shape == want.shape == (1, 256, 64)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    with torch.no_grad():
        eager = texport.build_net_only_fn(tcfg, tree, "cpu")(
            torch.from_numpy(_x())).numpy()
    np.testing.assert_array_equal(got, eager)


@pytest.mark.parametrize("coord", [False, True])
def test_program_matches_jax_bfloat16(tmp_path, coord):
    jcfg, tcfg, state, model = _pair(coord, "bfloat16")
    jf32, _, _, fmodel = _pair(coord, "float32")
    x = jnp.asarray(_x())
    want = np.asarray(jexport.build_net_only_fn(jcfg, model, state.params)(x))
    want32 = np.asarray(jexport.build_net_only_fn(jf32, fmodel,
                                                  state.params)(x))
    tree = jax.tree.map(np.asarray, state.params)
    got = _loaded(tcfg, tree, tmp_path)
    tol = np.abs(want - want32).max()
    assert np.abs(got - want).max() <= tol, (np.abs(got - want).max(), tol)
    assert np.abs(got - want32).max() > 1e-3
    with torch.no_grad():
        eager = texport.build_net_only_fn(tcfg, tree, "cpu")(
            torch.from_numpy(_x())).numpy()
    np.testing.assert_array_equal(got, eager)


@pytest.mark.parametrize("channels", [64, 32])
def test_atlas_pack_matches_jax(channels):
    pred = np.random.RandomState(1).rand(1, 8, 16, 67).astype(np.float32)
    want = np.asarray(junet.atlas_pack(jnp.asarray(pred), 8, 16, channels))
    got = tunet.atlas_pack(torch.from_numpy(pred), 8, 16, channels).numpy()
    assert got.shape == (1, 64, channels // 8 * 16)
    np.testing.assert_array_equal(got, want)


def test_clip_to_fp16_matches_jax():
    rng = np.random.RandomState(2)
    tree = {"params": {"a": {"kernel": rng.randn(3, 4).astype(np.float32)
                             * 1e5, "bias": np.float32([7e4, -7e4, 1.0])}}}
    want = jexport.clip_params_to_fp16(jax.tree.map(jnp.asarray, tree))
    got = texport.clip_params_to_fp16(tree)
    for k in ("kernel", "bias"):
        np.testing.assert_array_equal(got["params"]["a"][k],
                                      np.asarray(want["params"]["a"][k]))
    assert got["params"]["a"]["bias"][0] == 65504.0


def _keys(d, prefix=""):
    out = set()
    for k, v in d.items():
        out.add(prefix + k)
        if isinstance(v, dict):
            out |= _keys(v, prefix + k + "/")
    return out


def test_main_meta_and_consumer(tmp_path):
    """Both CLIs export the coord net at --platform cpu with no
    checkpoint (each warns and exports fresh weights): meta.json holds the
    same keys, and the same values except the platform-independent step
    and config; the port's consumer tool, run as a script, loads the
    artifact importing neither package and writes the program's output
    for its seeded input."""
    flags = FLAGS + ["--coord_net", "true", "--platform", "cpu",
                     "--checkpoint_dir", str(tmp_path / "none")]
    jexport.main(flags + ["--export_dir", str(tmp_path / "jax")])
    with pytest.warns(UserWarning, match="no checkpoint"):
        path = texport.main(flags + ["--export_dir", str(tmp_path / "t"),
                                     "--clip_to_fp16"])
    assert path == str(tmp_path / "t" / "msi_model.pt2")
    jmeta = json.loads((tmp_path / "jax" / "msi_model.meta.json").read_text())
    tmeta = json.loads((tmp_path / "t" / "msi_model.meta.json").read_text())
    assert _keys(tmeta) == _keys(jmeta)
    assert tmeta == jmeta
    out = tmp_path / "out.npy"
    res = subprocess.run(
        [sys.executable, os.path.join(REPO, "matryodshka_tpu_torch", "tools",
                                      "consume_export.py"), path,
         "--device", "cpu", "--out", str(out)],
        capture_output=True, text=True, timeout=300,
        env=dict(os.environ, PYTHONPATH=""))
    assert res.returncode == 0, res.stderr
    assert "modules of either package or JAX imported: []" in res.stdout
    assert "finite=True" in res.stdout
    x = np.random.RandomState(0).rand(1, 32, 64, 24).astype(np.float32)
    with torch.no_grad():
        want = torch.export.load(path).module()(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(np.load(out), want)


def test_export_defaults_to_the_card(tmp_path):
    """Without --platform the program is exported for the card, which
    raises here rather than exporting for the CPU."""
    args = texport.build_parser().parse_args(FLAGS)
    assert args.platform == "cuda"
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises((AssertionError, RuntimeError)):
        texport.main(FLAGS + ["--export_dir", str(tmp_path),
                              "--checkpoint_dir", str(tmp_path / "none")])
    assert not os.path.exists(tmp_path / "msi_model.pt2")
