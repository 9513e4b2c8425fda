"""The control at the cells' own size on the card: the reference computed
with what the program stores in bfloat16 rounded to fp8 e4m3, in the
program's place, fails the limits of `correct` on every seed tried, and the
program passes them on the same seeds.

    python -m pytest -m cuda msi_bench/tests/test_msi_control_cuda.py
"""

from __future__ import annotations

import json

import pytest
import torch

import msi_tiny
from msi_bench import control

SEEDS = (2**31 + 101, 2**31 + 102, 2**31 + 103)


def _cells():
    bench = json.loads((msi_tiny.ROOT / "BENCHMARK.json").read_text())
    return [w["name"] for w in bench["workloads"]]


@pytest.mark.cuda
@pytest.mark.parametrize("workload", _cells())
def test_control_fails_and_program_passes(workload):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the port's kernels run only there")
    rows, limits = control.readings(workload, SEEDS, set(SEEDS), 2.0)
    for seed, kind, got in rows:
        failed = [k for k, lim in limits.items() if not got[k] <= lim]
        if kind == "program":
            assert not failed, (seed, got)
        else:
            assert failed, (seed, got)
