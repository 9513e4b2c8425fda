"""The lowering probes on the card.

    python -m matryodshka_tpu_torch.tools.probes [--device cuda|cpu]

Asks the four questions the JAX package's Pallas probes asked the TPU's
compiler, on their inputs, through the kernels of `csrc/probes.cu`
(`ops/probes.py`):

- atan2/sqrt inside a kernel (`tools/r3_hw_session.py` mosaic_trig_probe):
  [8, 128] f32 drawn by `RandomState(0).randn`;
- a roll by +1 of [8, 256] `arange` rows in f32 and in bf16
  (`tools/r4_hw_session.py` bf16_roll_probe);
- a roll of [8, 640] `RandomState(0).rand` rows by a shift given at run
  time, 5 and 123 (`tools/exp_dynroll.py`);
- a circular left shift of [3, 1, 256] `RandomState(0).rand` rows through
  on-chip memory, for the 20 shifts 0, 13, ..., 247
  (`tests/test_pallas_sweep.py` test_aligned_shift_bit_exact).

Each prints one line in its tool's words. Unlike those tools, a probe that
fails raises, so the command exits non-zero. `--device cuda` (the default)
launches the kernels and raises where there is no card; `--device cpu` runs
their plain versions.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from matryodshka_tpu_torch.ops import probes

#: K8a: the largest |kernel - numpy float64| on values in (-pi/4, pi/4),
#: whose float32 ulp is 6e-8 at most: 2 ulp of atan2f, one rounding of the
#: sqrt, and margin; and the most ulp it may differ from the plain version
#: (the same atan2f, with x*x + 1 rounded once by fmaf, twice there).
TRIG_TOL = 2.5e-7
TRIG_ULP = 2
DYNROLL_W = 640
DYNROLL_SHIFTS = (5, 123)
SHIFT_C, SHIFT_W = 3, 256
SHIFTS = tuple(range(0, SHIFT_W, 13))


def trig_probe(device) -> None:
    """K8a: atan2/sqrt of [8, 128] N(0, 1) draws, against numpy in
    float64 and against the plain version."""
    xn = np.random.RandomState(0).randn(8, 128).astype(np.float32)
    x = torch.from_numpy(xn).to(device)
    out, plain = probes.trig(x), probes.trig_plain(x)
    ulp = probes.ulp_error(out, plain)
    x64 = xn.astype(np.float64)
    want = np.arctan2(x64, np.sqrt(x64 * x64 + 1))
    err = float(np.abs(out.cpu().numpy() - want).max())
    # in ulp of the float32 rounding of the float64 value: the kernel's and
    # the plain version's own errors
    want32 = torch.from_numpy(want.astype(np.float32))
    ulp_k = probes.ulp_error(out.cpu(), want32)
    ulp_p = probes.ulp_error(plain.cpu(), want32)
    ok = err <= TRIG_TOL and ulp <= TRIG_ULP
    print(f"[probe] atan2/sqrt in-kernel: {'OK' if ok else 'FAIL'}, max err "
          f"{err:.2e} (numpy float64; {ulp_k:g} ulp from its float32 "
          f"rounding, the plain version {ulp_p:g}; {ulp:g} ulp between "
          f"them)", flush=True)
    if not ok:
        raise RuntimeError(f"trig probe: err {err:.2e} (tol {TRIG_TOL:.1e}),"
                           f" {ulp:g} ulp (tol {TRIG_ULP})")


def bf16_roll_probe(device) -> None:
    """K8b: a roll by +1 of [8, 256] arange rows, f32 and bf16."""
    for dt, name in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
        x = torch.arange(8 * 256, dtype=torch.float32).reshape(8, 256).to(
            device, dt)
        out = probes.roll(x, 1)
        ok = bool((out[:, 1:] == x[:, :-1]).all()
                  and (out[:, 0] == x[:, -1]).all())
        print(f"[bf16roll] {name}: compiled, shift-correct={ok}", flush=True)
        if not ok:
            raise RuntimeError(f"roll probe ({name}): shift-correct=False")


def dynroll_probe(device) -> None:
    """K8c: rolls of [8, 640] rows by shifts given at run time."""
    xn = np.random.RandomState(0).rand(8, DYNROLL_W).astype(np.float32)
    x = torch.from_numpy(xn).to(device)
    for i, s in enumerate(DYNROLL_SHIFTS):
        err = float(np.abs(probes.roll(x, s).cpu().numpy()
                           - np.roll(xn, s, axis=1)).max())
        print(f"[dynroll] traced-shift roll: OK, err={err:.1e}" if i == 0
              else f"[dynroll] shift={s} err={err:.1e}", flush=True)
        if err != 0:
            raise RuntimeError(f"run-time shift roll by {s}: err {err:.1e}")


def shift_probe(device) -> None:
    """K9: the circular left shift of [3, 1, 256] rows, bit-exact against
    np.roll for every shift in SHIFTS."""
    rown = np.random.RandomState(0).rand(SHIFT_C, 1, SHIFT_W).astype(
        np.float32)
    row = torch.from_numpy(rown).to(device)
    bad = [s for s in SHIFTS if not np.array_equal(
        probes.window_shift(row, s).cpu().numpy(), np.roll(rown, -s, axis=2))]
    if bad:
        raise RuntimeError(f"[shift] not bit-exact at shifts {bad}")
    print(f"[shift] {len(SHIFTS)} shifts bit-exact", flush=True)


PROBES = (trig_probe, bf16_roll_probe, dynroll_probe, shift_probe)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description="the lowering probes")
    parser.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = parser.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("--device cuda: no CUDA device here (pass "
                               "--device cpu for the plain versions)")
        print(f"[probes] on {torch.cuda.get_device_name(device)}: the "
              f"kernels of csrc/probes.cu", flush=True)
    else:
        print("[probes] on the CPU: the kernels' plain versions", flush=True)
    for probe in PROBES:
        probe(device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
