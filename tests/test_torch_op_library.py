"""The op library (csrc/sweep_op.cpp, built by ops/_build.op_library):
the custom op matry::sweep_volume registered in C++, on the CPU.

* The library builds with g++ into _build/ (no CUDA implementation here)
  and a CUDA machine without nvcc refuses to build it.
* Its CPU implementation equals ops/sweep.sweep_volume's plain route bit
  for bit (the same ATen operations in the same order), in float32 and
  bfloat16, at 64x128 with 4 planes and a batch of 2; and it sits within
  tests/test_torch_sweep.py's gather-path bounds of the JAX package's
  format_network_input on identity poses.
* Its Meta implementation gives the output's shape and dtype under
  FakeTensorMode.
* The consumer tool refuses a meta.json that names a Python op_module and
  no op_library.

Inputs: numpy from a seed.
"""

import json
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from matryodshka_tpu.geometry import sweep as jsweep
from matryodshka_tpu_torch.ops import _build
from matryodshka_tpu_torch.ops import sweep as sweep_ops
from matryodshka_tpu_torch.tools import consume_export

torch.set_num_threads(1)

B, H, W, P = 2, 64, 128, 4
DTYPES = [torch.float32, torch.bfloat16]


def _inputs(seed=0):
    """A batch of two ODS pairs in [0, 1], the inverse-depth planes and
    per-example intrinsics (baselines 0.032 and 0.064 m)."""
    rng = np.random.RandomState(seed)
    ref = rng.rand(B, H, W, 3).astype(np.float32)
    src = rng.rand(B, H, W, 3).astype(np.float32)
    depths = np.asarray(jsweep.inv_depths(1.0, 100.0, P), np.float32)
    intr = np.tile(np.eye(3, dtype=np.float32)[None], (B, 1, 1))
    intr[:, 0, 0] = [0.032, 0.064]
    return ref, src, depths, intr


def test_library_builds_with_gxx():
    so = _build.op_library()
    assert so.parent == _build.BUILD_DIR and so.is_file()
    assert so.name.startswith("libmatry_ops-") and so.suffix == ".so"
    log = so.with_suffix(".log").read_text()
    assert log.startswith("g++ ") and "-DMATRY_WITH_CUDA" not in log
    sweep_ops.load_op_library()
    sweep_ops.load_op_library()          # a second call registers nothing
    assert str(torch.ops.matry.sweep_volume.default._schema) == (
        "matry::sweep_volume(Tensor ref_image, Tensor src_image, Tensor "
        "depths, Tensor intrinsics, ScalarType out_dtype) -> Tensor")


def test_cuda_machine_without_nvcc_raises(monkeypatch, tmp_path):
    """Where CUDA is available the library must carry K1: without nvcc the
    build raises rather than build the CPU implementation alone."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    if _build.Path("/usr/local/cuda/bin/nvcc").exists():
        pytest.skip("this machine has /usr/local/cuda/bin/nvcc")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.op_library()


@pytest.mark.parametrize("dtype", DTYPES)
def test_cpu_op_equals_plain_route(dtype):
    ref, src, depths, intr = map(torch.from_numpy, _inputs())
    got = sweep_ops.sweep_volume_op(ref, src, depths, intr, dtype)
    want = sweep_ops.sweep_volume(ref, src, depths, intr, dtype)
    assert got.dtype == want.dtype == dtype
    assert tuple(got.shape) == (B, 2 * P * 3, H, W)
    assert torch.equal(got, want)


@pytest.mark.parametrize("order", [1, -1])
def test_cpu_op_matches_jax_sweep(order):
    """Against the JAX gather sweep (format_network_input on identity
    poses, on the preprocessed images) as test_torch_sweep.py's
    test_sweep_matches_gather_path runs it: 32x64, 6 planes, a 0.064 m
    baseline, and its bounds, 99th percentile < 2e-3 and mean < 2e-4 (the
    gather parks single far-shell pixels on f32 cancellation noise); a
    batch of 2."""
    rng = np.random.RandomState(2)
    b, h, w, p = 2, 32, 64, 6
    ref = rng.rand(b, h, w, 3).astype(np.float32)
    src = rng.rand(b, h, w, 3).astype(np.float32)
    depths = np.asarray(jsweep.inv_depths(1.0, 100.0, p), np.float32)
    intr = np.tile(np.eye(3, dtype=np.float32)[None], (b, 1, 1))
    intr[:, 0, 0] = 0.064
    vol = sweep_ops.sweep_volume_op(
        *map(torch.from_numpy, (ref, src, depths, intr)),
        torch.float32).numpy()
    eye = np.eye(4, dtype=np.float32)[None].repeat(b, 0)
    want = np.asarray(jsweep.format_network_input(
        jnp.asarray(ref * 2 - 1), jnp.asarray(src * 2 - 1), jnp.asarray(eye),
        jnp.asarray(eye), jnp.asarray(eye), jnp.asarray(depths),
        jnp.asarray(intr)))
    k = 0 if order == 1 else 1
    got = vol.transpose(0, 2, 3, 1)[..., k * p * 3:(k + 1) * p * 3]
    err = np.abs(got - want[..., k * p * 3:(k + 1) * p * 3])
    assert np.percentile(err, 99) < 2e-3, np.percentile(err, 99)
    assert err.mean() < 2e-4, err.mean()


@pytest.mark.parametrize("dtype", DTYPES)
def test_meta_impl_under_fake_tensor_mode(dtype):
    sweep_ops.load_op_library()
    with FakeTensorMode() as mode:
        args = [mode.from_tensor(torch.from_numpy(a)) for a in _inputs()]
        out = torch.ops.matry.sweep_volume(*args, dtype)
    assert tuple(out.shape) == (B, 2 * P * 3, H, W)
    assert out.dtype == dtype and out.device.type == "cpu"


def test_consumer_refuses_op_module_meta(tmp_path):
    """A meta.json of an export that registered the op from a Python
    module is refused, with the advice to export again; the consumer
    never imports a module."""
    meta = {"platform": "cpu", "custom_ops": [sweep_ops.OP_NAME],
            "op_module": "matryodshka_tpu_torch.ops.sweep",
            "interface": {"inputs": {}}}
    (tmp_path / "old.meta.json").write_text(json.dumps(meta))
    with pytest.raises(SystemExit, match="export the program again"):
        consume_export.main([str(tmp_path / "old.pt2"), "--device", "cpu"])
