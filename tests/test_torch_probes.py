"""The port's lowering probes (ops/probes.py, tools/probes.py) against the
JAX package's Pallas probes, interpret mode, on the CPU.

The probes of `tools/` are inner functions of tools that must stay as they
are, so each kernel body is rebuilt here word for word: K8a from
`tools/r3_hw_session.py:71-74`, K8b from `tools/r4_hw_session.py:545-546`,
K8c from `tools/exp_dynroll.py:25-27`. K9 is the interpret-mode call of
`tests/test_pallas_sweep.py:83-101`, with `_circ_shift_left` from the JAX
package. The port's side is each wrapper on CPU tensors, i.e. its plain
version. Tolerances: exact for every roll and shift (data movement only);
2.5e-7 absolute for atan2/sqrt on values in (-pi/4, pi/4) (float32 ulp
6e-8 there; XLA's and the C library's atan2 round differently).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from matryodshka_tpu_torch.ops import probes
from matryodshka_tpu_torch.tools import probes as probes_tool


def _np(t):
    return t.float().numpy() if isinstance(t, torch.Tensor) else \
        np.asarray(t).astype(np.float32)


def test_trig_matches_pallas_probe():
    def kern(x_ref, o_ref):
        x = x_ref[...]
        y = jnp.sqrt(x * x + 1.0)
        o_ref[...] = jnp.arctan2(x, y)

    xn = np.random.RandomState(0).randn(8, 128).astype(np.float32)
    want = pl.pallas_call(
        kern, out_shape=jax.ShapeDtypeStruct((8, 128), jnp.float32),
        in_specs=[pl.BlockSpec(memory_space=pltpu.VMEM)],
        out_specs=pl.BlockSpec(memory_space=pltpu.VMEM),
        interpret=True)(jnp.asarray(xn))
    got = probes.trig(torch.from_numpy(xn))
    assert got.dtype == torch.float32 and got.shape == (8, 128)
    np.testing.assert_allclose(_np(got), _np(want), rtol=0, atol=2.5e-7)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_roll_matches_pallas_bf16_roll_probe(dtype):
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)

    def kern(x_ref, o_ref):
        o_ref[:, :] = pltpu.roll(x_ref[:, :], 1, axis=1)

    x = jnp.arange(8 * 256, dtype=jnp.float32).reshape(8, 256)
    want = pl.pallas_call(kern, out_shape=jax.ShapeDtypeStruct((8, 256), jdt),
                          interpret=True)(x.astype(jdt))
    got = probes.roll(torch.arange(8 * 256, dtype=torch.float32).reshape(
        8, 256).to(tdt), 1)
    assert got.dtype == tdt
    np.testing.assert_array_equal(_np(got), _np(want))


@pytest.mark.parametrize("shift", [5, 123])
def test_roll_matches_pallas_dynroll_probe(shift):
    w = 640

    def kernel(s_ref, x_ref, o_ref):
        s = s_ref[0]
        o_ref[:, :] = pltpu.roll(x_ref[:, :], s, axis=1)

    xn = np.random.RandomState(0).rand(8, w).astype(np.float32)

    @jax.jit
    def run(x, s):
        return pl.pallas_call(
            kernel,
            in_specs=[pl.BlockSpec(memory_space=pltpu.SMEM),
                      pl.BlockSpec(memory_space=pltpu.VMEM)],
            out_specs=pl.BlockSpec(memory_space=pltpu.VMEM),
            out_shape=jax.ShapeDtypeStruct((8, w), jnp.float32),
            interpret=True,
        )(jnp.asarray([s], jnp.int32), x)

    want = np.asarray(run(jnp.asarray(xn), shift))
    np.testing.assert_array_equal(want, np.roll(xn, shift, axis=1))
    np.testing.assert_array_equal(
        probes.roll(torch.from_numpy(xn), shift).numpy(), want)


def test_window_shift_matches_pallas_aligned_shift():
    from matryodshka_tpu.ops.pallas_sweep import _circ_shift_left

    C, W = 3, 256
    window = W + 128
    rown = np.random.RandomState(0).rand(C, 1, W).astype(np.float32)
    row = jnp.asarray(rown)

    def kern(s_ref, row_ref, out_ref, scratch_ref):
        s = s_ref[0]
        scratch_ref[:, :, 0:W] = row_ref[:, :, :]
        scratch_ref[:, :, W:2 * W] = row_ref[:, :, :]
        s_hi = pl.multiple_of((s // 128) * 128, 128)
        win = scratch_ref[:, :, pl.ds(s_hi, window)]
        out_ref[:, :, :] = _circ_shift_left(win, s - s_hi, window,
                                            nbits=7)[:, :, 0:W]

    shifts = list(range(0, W, 13))
    assert shifts == list(probes_tool.SHIFTS) and len(shifts) == 20
    for s in shifts:
        want = pl.pallas_call(
            kern,
            in_specs=[pl.BlockSpec(memory_space=pltpu.SMEM),
                      pl.BlockSpec(memory_space=pltpu.VMEM)],
            out_specs=pl.BlockSpec(memory_space=pltpu.VMEM),
            out_shape=jax.ShapeDtypeStruct((C, 1, W), jnp.float32),
            scratch_shapes=[pltpu.VMEM((C, 1, 2 * W), jnp.float32)],
            interpret=True,
        )(jnp.asarray([s], jnp.int32), row)
        np.testing.assert_array_equal(
            probes.window_shift(torch.from_numpy(rown), s).numpy(),
            np.asarray(want))


#: Shifts beyond the tools' own: negative, 0, W and beyond W, in units of the
#: row width W (k * W + d).
SHIFT_CASES = [(-1, -1), (0, -5), (0, -1), (0, 0), (0, 1), (1, 0), (1, 7),
               (2, 3)]


@pytest.mark.parametrize("shape", [(8, 1), (5, 33), (3, 1000)],
                         ids=["W1", "W33", "W1000"])
@pytest.mark.parametrize("case", SHIFT_CASES,
                         ids=[f"{k}W{d:+d}" for k, d in SHIFT_CASES])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_roll_any_shift_matches_numpy(dtype, case, shape):
    rows, w = shape
    s = case[0] * w + case[1]
    xn = np.random.RandomState(w).randn(rows, w).astype(np.float32)
    x = torch.from_numpy(xn).to(dtype)
    want = np.roll(_np(x), s, axis=-1)
    np.testing.assert_array_equal(_np(probes.roll(x, s)), want)


@pytest.mark.parametrize("shape", [(8, 1), (5, 33), (3, 1, 1000)],
                         ids=["W1", "W33", "W1000"])
@pytest.mark.parametrize("case", SHIFT_CASES,
                         ids=[f"{k}W{d:+d}" for k, d in SHIFT_CASES])
def test_window_shift_any_shift_matches_numpy(case, shape):
    w = shape[-1]
    s = case[0] * w + case[1]
    xn = np.random.RandomState(w + 1).rand(*shape).astype(np.float32)
    np.testing.assert_array_equal(
        probes.window_shift(torch.from_numpy(xn), s).numpy(),
        np.roll(xn, -s, axis=-1))


def test_cpu_route_launches_no_kernel():
    before = (probes.trig_launches, probes.roll_launches,
              probes.roll_bf16_launches, probes.window_shift_launches)
    x = torch.rand(4, 16)
    probes.trig(x)
    probes.roll(x, 3)
    probes.roll(x.bfloat16(), 3)
    probes.window_shift(x, 3)
    assert (probes.trig_launches, probes.roll_launches,
            probes.roll_bf16_launches, probes.window_shift_launches) == before


@pytest.mark.parametrize("shift", [2 ** 31, -2 ** 31 - 1, 1.5])
def test_shift_outside_int32_raises(shift):
    with pytest.raises((ValueError, TypeError)):
        probes.roll(torch.zeros(2, 4), shift)
    with pytest.raises((ValueError, TypeError)):
        probes.window_shift(torch.zeros(2, 4), shift)


def test_ulp_error_counts_last_places():
    want = torch.tensor([1.0, 0.5, -2.0, 0.0])
    got = torch.nextafter(want, torch.full_like(want, 9.0))
    assert probes.ulp_error(want, want) == 0
    assert probes.ulp_error(got, want) == 1
    got2 = torch.nextafter(got, torch.full_like(got, 9.0))
    assert probes.ulp_error(got2[:3], want[:3]) == 2


def test_tool_cpu_prints_the_four_probes(capsys):
    assert probes_tool.main(["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    for line in ("[probe] atan2/sqrt in-kernel: OK, max err",
                 "[bf16roll] f32: compiled, shift-correct=True",
                 "[bf16roll] bf16: compiled, shift-correct=True",
                 "[dynroll] traced-shift roll: OK, err=0.0e+00",
                 "[dynroll] shift=123 err=0.0e+00",
                 "[shift] 20 shifts bit-exact"):
        assert line in out, (line, out)


def test_tool_cuda_without_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        probes_tool.main(["--device", "cuda"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        probes_tool.main([])


@pytest.mark.parametrize("which", ["trig", "roll", "window_shift"])
def test_tool_failing_probe_raises(monkeypatch, which):
    """A probe whose kernel gives a wrong answer raises out of main (the
    JAX tools print FAIL and go on)."""
    wrong = {"trig": lambda x: probes.trig_plain(x) + 1e-3,
             "roll": lambda x, s: probes.roll_plain(x, s + 1),
             "window_shift": lambda x, s: probes.window_shift_plain(x, s + 1)}
    monkeypatch.setattr(probes, which, wrong[which])
    with pytest.raises(RuntimeError):
        probes_tool.main(["--device", "cpu"])
