"""The readings that the limits of `correct` are set from.

    python3 msi_bench/control.py --workload ods-coord.video \
        --seeds 1,2,...,12 --control-seeds 1,2,3 --seconds 2

For each seed, in one process: the cell's set-up from that seed, a short
window at the cell's own load, and the numbers `correct` compares for the
program's sampled answers; for each control seed also the same numbers for
the control, the reference computed with what the program stores in its
compute dtype (bfloat16) rounded to fp8 e4m3 (reference/quant.py), put in
the program's place. Prints one JSON line per seed and reading, and a
summary: per number the program's largest reading and the control's
smallest, with the limit the mix sets.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def readings(workload, seeds, control_seeds, seconds, device="cuda",
             bench_dir=None):
    """[(seed, "program" | "control", {number: value})]."""
    import torch

    from msi_bench import harness
    from msi_bench.reference.quant import fp8

    bench_dir = bench_dir or harness.BENCH_DIR
    _, cell, config, traffic, driver_mod = harness.load_cell(workload,
                                                            bench_dir)
    out = []
    for seed in seeds:
        ctx = harness.Ctx(bench_dir, cell, config, traffic, seed, device)
        drv = ctx.driver = driver_mod.Driver(ctx)
        win = drv.window(seconds)
        drv.free()
        out.append((seed, "program", drv.check(win["sample"])))
        if seed in control_seeds:
            out.append((seed, "control", drv.check(win["sample"], q=fp8)))
        del ctx, drv, win
        gc.collect()
        if device == "cuda":
            torch.cuda.empty_cache()
    return out, traffic["limits"]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=2.0)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch
    if not torch.cuda.is_available():
        print("control: no CUDA device", file=sys.stderr)
        return 2
    seeds = [int(s) for s in args.seeds.split(",")]
    ctl = {int(s) for s in args.control_seeds.split(",") if s}
    rows, limits = readings(args.workload, seeds, ctl, args.seconds)
    for seed, kind, got in rows:
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "kind": kind, **got}), flush=True)
    for name, limit in limits.items():
        prog = max(g[name] for _, k, g in rows if k == "program")
        ctrl = [g[name] for _, k, g in rows if k == "control"]
        print(f"{args.workload} {name}: program max {prog!r}, control min "
              f"{min(ctrl) if ctrl else None!r}, limit {limit!r} "
              f"[{torch.cuda.get_device_name()}]")
    return 0


if __name__ == "__main__":
    sys.exit(main())
