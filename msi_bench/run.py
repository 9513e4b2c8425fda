"""Run one benchmark cell once on one NVIDIA GPU.

    python3 msi_bench/run.py --workload ods-coord.video --seed 7 \
        --seconds 10 --trace 0

Prints the result as the last line of standard output (one JSON object:
correct, attempted, failed, metrics, device, with --trace 1 breakdown, and
last checks: each number compared with its limit) and the same numbers as
the last lines of standard error. With --trace 0 the metrics are the cell's
end-to-end ones, with --trace 1 its per-layer ones. Exits non-zero and
prints no result without a CUDA device, or if a JAX module is loaded once
the window has closed.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    sys.path.insert(0, str(ROOT))
    import torch

    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell = [w for w in bench["workloads"] if w["name"] == args.workload]
    if not cell:
        print(f"run: no workload {args.workload!r}", file=sys.stderr)
        return 2
    if (not torch.cuda.is_available()
            or torch.cuda.device_count() < cell[0]["chips"]):
        print(f"run: {args.workload} needs {cell[0]['chips']} CUDA "
              f"device(s); found {torch.cuda.device_count()}",
              file=sys.stderr)
        return 2
    from matryodshka_tpu_torch.ops import _build
    from msi_bench import harness

    # A checkout's first run builds the port's kernels into
    # matryodshka_tpu_torch/_build/ (a fixed directory of the checkout),
    # with every core; later runs find them there. The build is part of
    # setup_s and is also reported apart as device.build_s. Then one core
    # for the rest of the process, the server and the waiter threads
    # included.
    t_build = time.perf_counter()
    _build.build()
    build_s = time.perf_counter() - t_build
    os.sched_setaffinity(0, {max(os.sched_getaffinity(0))})

    result, checks = harness.run_cell(args.workload, args.seed, args.seconds,
                                      args.trace, "cuda", t_start=T_START)
    result["device"]["build_s"] = build_s
    found = harness.forbidden_modules()
    if found:
        print(f"run: modules loaded that the run may not hold: {found}",
              file=sys.stderr)
        return 3
    sys.stdout.write(json.dumps(result) + "\n")
    sys.stdout.flush()
    for name, (value, limit) in checks.items():
        print(f"check {name} {value!r} limit {limit!r}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
