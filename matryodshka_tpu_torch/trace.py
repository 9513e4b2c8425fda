"""Where a flagship frame's or training step's time goes on the card,
from a torch.profiler trace.

    python -m matryodshka_tpu_torch.trace [--coord_net] [--train]

Runs entry.forward at the flagship configuration (640x320, 32 + 32 planes,
32 shells, ngf 64, bf16, blend_psv; the wrap net, or the coord net with
--coord_net) with seeded weights, and for each part -- the sweep stage,
the net stage, the render stage and then the whole frame -- traces
CALLS calls after 2 warm-up under torch.profiler (CPU and CUDA
activities). With --train it traces the default trainer's step instead
(training/step.py's train step with Adam, batch 1, on a synthetic batch).
Per part it prints the host wall ms per call (a synchronize ends the
window), the device busy ms per call (the union of the trace's kernel,
memcpy and memset intervals), the idle share 1 - busy / wall, the device
operations per call, the part's TOP largest kernels by device time, and
the device time and launches of each of the port's kernels.
Every line carries the card's name and power limit. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import re
import subprocess
import sys
import tempfile
import time
import warnings

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
CALLS = 10    # traced calls per part
TOP = 10      # kernels listed per part
#: The port's hand-written kernels (csrc/*.cu), summed per part by name
#: whatever their template arguments.
PORT_KERNELS = ("sweep_kernel", "row_params_kernel", "assembled_kernel",
                "conv_wgmma_kernel",
                "conv_f32_kernel", "uv_project_kernel",
                "stats_fold",
                "render_kernel", "render_layers_kernel", "wgrad_wgmma_kernel",
                "wgrad_f32_kernel", "wgrad_reduce")


def _card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def device_events(prof):
    """The trace's device events: [(name, start us, duration us)]."""
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as fh:
            events = json.load(fh)["traceEvents"]
    return [(e.get("name", ""), float(e["ts"]), float(e.get("dur", 0.0)))
            for e in events
            if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS]


def busy_us(events) -> float:
    """Length of the union of the events' intervals."""
    total, end = 0.0, None
    for _, ts, dur in sorted(events, key=lambda e: e[1]):
        lo, hi = ts, ts + dur
        if end is None or lo > end:
            total += hi - lo
            end = hi
        elif hi > end:
            total += hi - end
            end = hi
    return total


def trace_part(fn):
    """(host wall ms, device busy ms, idle share, device ops) per call,
    and device us by kernel name over the window."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(CALLS):
            fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / CALLS
    events = device_events(prof)
    if not events:
        raise RuntimeError("the profiler recorded no device activity")
    busy = busy_us(events) / 1e3 / CALLS
    by_name, counts = collections.Counter(), collections.Counter()
    for name, _, dur in events:
        by_name[name] += dur
        counts[name] += 1
    return (wall, busy, 1.0 - busy / wall, len(events) / CALLS, by_name,
            counts)


def port_kernels(by_name, counts):
    """{kernel: (launches, device us)} over the window for each of
    PORT_KERNELS that ran, summed over its instantiations."""
    out = {}
    for kern in PORT_KERNELS:
        pat = re.compile(rf"\b{kern}\b")
        hits = [n for n in by_name if pat.search(n)]
        if hits:
            out[kern] = (sum(counts[n] for n in hits),
                         sum(by_name[n] for n in hits))
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--coord_net", action="store_true")
    ap.add_argument("--train", action="store_true")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("trace: no CUDA device", file=sys.stderr)
        sys.exit(2)
    from matryodshka_tpu_torch import entry
    from matryodshka_tpu_torch.models import msi as msi_lib

    tag = f"[{_card()}]"
    dev = torch.device("cuda", 0)
    cfg = entry.flagship_cfg(coord_net=args.coord_net)
    batch = entry.synthetic_batch(cfg, 0, dev)
    if args.train:
        from matryodshka_tpu_torch.training import state as state_lib
        from matryodshka_tpu_torch.training import step as step_lib
        state = state_lib.init_state(cfg, 0, dev)
        step_fn = step_lib.make_train_step(cfg, state.net)
        what, unit = "the train step", "step"
        parts = {"step": lambda: step_fn(state, batch)}
    else:
        params = entry.make_params(cfg, seed=0, device=dev)
        rt = torch.eye(4, device=dev)[None]
        with torch.no_grad():
            vol = msi_lib.sweep_stage(cfg, batch, params.psv_depths)
            pred = msi_lib.net_stage(params.stages, vol)
        what, unit = "entry.forward", "frame"
        parts = {
            "sweep": lambda: msi_lib.sweep_stage(cfg, batch,
                                                 params.psv_depths),
            "net": lambda: msi_lib.net_stage(params.stages, vol),
            "render": lambda: msi_lib.render_stage(vol, pred, rt,
                                                   batch["tgt_pose"],
                                                   params.msi_depths),
            "e2e": lambda: entry.forward(params, batch),
        }
    warnings.filterwarnings("ignore", message=".*Profiler clears events")
    print(f"trace of {what}, {cfg.net_variant} net, {CALLS} calls per "
          f"part {tag}")
    with torch.set_grad_enabled(args.train):
        for part, fn in parts.items():
            wall, busy, idle, ops, by_name, counts = trace_part(fn)
            print(f"{part:7s} host wall {wall:.3f} ms/{unit}, device busy "
                  f"{busy:.3f} ms/{unit}, idle share {idle:.3f}, "
                  f"{ops:.0f} device ops/{unit} {tag}")
            for name, us in by_name.most_common(TOP):
                print(f"    {us / 1e3 / CALLS:8.3f} ms/{unit} "
                      f"{name[:100]}")
            for kern, (n, us) in port_kernels(by_name, counts).items():
                print(f"    port kernel {kern}: {us / 1e3 / CALLS:.4f} "
                      f"ms/{unit} in {n / CALLS:g} launches/{unit}")


if __name__ == "__main__":
    main()
