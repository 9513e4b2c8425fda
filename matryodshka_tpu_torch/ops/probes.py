"""Lowering probes: kernel wrappers and their plain versions.

The kernels are `csrc/probes.cu`, the card's answers to the questions the
JAX package's Pallas lowering probes put to the TPU's compiler (K8a-c in
`tools/`, K9 in `tests/test_pallas_sweep.py`; the source note lists
them): atan2/sqrt inside a kernel, a circular roll of f32 and bf16 rows by
a shift given at run time, and a circular left shift of f32 rows through
on-chip memory. No path of the system runs them; the probe tool
(`python -m matryodshka_tpu_torch.tools.probes`) does. Every function
works on the last axis of a contiguous tensor; a shift may be any int32,
negative or beyond the row, and is taken modulo the row's width.
"""

from __future__ import annotations

import operator

import torch

from matryodshka_tpu_torch.ops import _build

#: Launches of each probe kernel in this process (roll: f32 and bf16 rows).
trig_launches = 0
roll_launches = 0
roll_bf16_launches = 0
window_shift_launches = 0

#: The widest row the window shift stages: two copies of it in f32 fill at
#: most the 227 KB of shared memory a Hopper block can have.
WINDOW_SHIFT_MAX_W = 232448 // 8


def ulp_error(got: torch.Tensor, want: torch.Tensor) -> float:
    """Largest |got - want| in units of the last place of want's float32
    magnitude."""
    a = want.float().abs()
    ulp = torch.nextafter(a, torch.full_like(a, float("inf"))) - a
    return ((got.float() - want.float()).abs() / ulp).max().item()


def _shift(shift) -> int:
    s = operator.index(shift)
    _build.require(-2 ** 31 <= s < 2 ** 31, f"shift {s} is not an int32")
    return s


def _rows(name: str, x: torch.Tensor, dtypes) -> tuple[int, int]:
    """Check a kernel's operand; -> (rows, width) of its last axis."""
    req = _build.require
    req(x.is_cuda, f"{name}: unsupported device {x.device}")
    req(x.dtype in dtypes and x.is_contiguous() and x.dim() >= 1
        and x.numel() > 0, f"{name}: x {x.dtype} {tuple(x.shape)}")
    width = x.shape[-1]
    return x.numel() // width, width


def trig_plain(x: torch.Tensor) -> torch.Tensor:
    """K8a's function, atan2(x, sqrt(x*x + 1)), elementwise."""
    return torch.atan2(x, torch.sqrt(x * x + 1))


def trig(x: torch.Tensor) -> torch.Tensor:
    """atan2(x, sqrt(x*x + 1)) of float32 x: the CUDA kernel for a CUDA
    tensor, the plain version for a CPU tensor."""
    if x.device.type == "cpu":
        return trig_plain(x)
    global trig_launches
    _rows("probe trig", x, (torch.float32,))
    out = torch.empty_like(x)
    err = _build.lib().matry_probe_trig(x.data_ptr(), out.data_ptr(),
                                        x.numel(),
                                        _build.stream_ptr(x.device))
    _build.check(err, "matry_probe_trig")
    trig_launches += 1
    return out


def roll_plain(x: torch.Tensor, shift: int) -> torch.Tensor:
    """jnp.roll / pltpu.roll along the last axis: out[..., j] =
    x[..., (j - shift) mod W]."""
    return torch.roll(x, shift, dims=-1)


def roll(x: torch.Tensor, shift: int) -> torch.Tensor:
    """roll_plain's function on float32 or bfloat16 x: the CUDA kernel for
    a CUDA tensor (the shift a kernel argument), the plain version for a
    CPU tensor."""
    s = _shift(shift)
    if x.device.type == "cpu":
        return roll_plain(x, s)
    global roll_launches, roll_bf16_launches
    rows, width = _rows("probe roll", x, (torch.float32, torch.bfloat16))
    bf16 = x.dtype == torch.bfloat16
    out = torch.empty_like(x)
    err = _build.lib().matry_probe_roll(x.data_ptr(), out.data_ptr(), rows,
                                        width, s, int(bf16),
                                        _build.stream_ptr(x.device))
    _build.check(err, "matry_probe_roll")
    if bf16:
        roll_bf16_launches += 1
    else:
        roll_launches += 1
    return out


def window_shift_plain(x: torch.Tensor, shift: int) -> torch.Tensor:
    """K9's function, a circular LEFT shift along the last axis: out[...,
    j] = x[..., (j + shift) mod W], i.e. np.roll(x, -shift, axis=-1)."""
    return torch.roll(x, -shift, dims=-1)


def window_shift(x: torch.Tensor, shift: int) -> torch.Tensor:
    """window_shift_plain's function on float32 x: the CUDA kernel (each row
    staged twice in shared memory, read from the shift) for a CUDA tensor,
    the plain version for a CPU tensor."""
    s = _shift(shift)
    if x.device.type == "cpu":
        return window_shift_plain(x, s)
    global window_shift_launches
    rows, width = _rows("probe window_shift", x, (torch.float32,))
    _build.require(width <= WINDOW_SHIFT_MAX_W and rows < 2 ** 31,
                   f"probe window_shift: {rows} rows of {width} (at most "
                   f"{WINDOW_SHIFT_MAX_W} wide)")
    out = torch.empty_like(x)
    err = _build.lib().matry_probe_window_shift(
        x.data_ptr(), out.data_ptr(), rows, width, s,
        _build.stream_ptr(x.device))
    _build.check(err, "matry_probe_window_shift")
    window_shift_launches += 1
    return out
