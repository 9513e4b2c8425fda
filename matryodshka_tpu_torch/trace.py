"""The port's spans, and where a flagship frame's or training step's time
goes on the card, from a torch.profiler trace.

Spans. `with span(name):` marks a layer boundary on the hot path: a
request (`entry.forward`, `test.hres_render`), a stage (`msi.sweep_stage`,
`msi.net_stage`, `msi.render_stage`, `sweep.sweep_assembled`,
`render.render_equirect_view_prepared_both`; for PP and RealEstate input
`msi.mpi_sweep` inside `msi.sweep_stage`, and `msi.mpi_render_stage`), the
net's host path (`conv.conv`) and each kernel launch (`launch.<C entry>`,
`ops/_build.launch`). While a profiler records it is a `record_function`,
so it lands in the profiler's trace beside the device events, on their
clock: a kernel belongs to the span that holds its runtime launch event
(the Chrome trace's `args.correlation`). Otherwise it is one shared no-op
context, and a call pays the profiler-flag check alone. `setup_span(name)`
marks a cold path (`_build.lib`, `_build.build`, `entry.make_params` and
its parts, `test.build_hres_render_fn`): it always records (name, start,
end, depth) on time.perf_counter() in a bounded list, `setup_spans()`, and
is a record_function too while a profiler records.

The CLI:

    python -m matryodshka_tpu_torch.trace [--coord_net] [--train]

runs entry.forward at the flagship configuration (640x320, 32 + 32 planes,
32 shells, ngf 64, bf16, blend_psv; the wrap net, or the coord net with
--coord_net) with seeded weights, and for each part -- the sweep stage,
the net stage, the render stage and then the whole frame -- traces
CALLS calls after 2 warm-up under torch.profiler (CPU and CUDA
activities), between two spin kernels: the profiler now and then drops a
device event at an edge of its window, so a window that lost a spin is
taken again, up to TRIES times. With --train it traces the default
trainer's step instead (training/step.py's train step with Adam, batch 1,
on a synthetic batch).
Per part it prints the host wall ms per call (a synchronize ends the
window), the device busy ms per call (the union of the trace's kernel,
memcpy and memset intervals), the idle share 1 - busy / wall, the device
operations per call, the part's TOP largest kernels by device time, the
device time and launches of each of the port's kernels, and each program
span's host self time per call (its duration less its child spans').
Every line carries the card's name and power limit. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import json
import os
import re
import subprocess
import sys
import tempfile
import threading
import time
import warnings
from typing import NamedTuple

import torch
from torch.autograd.profiler import record_function

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
#: The Chrome trace's category of a record_function.
SPAN_CAT = "user_annotation"
CALLS = 10    # traced calls per part
TOP = 10      # kernels listed per part
TRIES = 5     # windows taken before trace_window gives up
#: The spin kernel (torch.cuda._sleep) that opens and closes a window.
SPIN_CYCLES = 20_000_000
SPIN_KERNEL = "spin_kernel"
#: The port's hand-written kernels (csrc/*.cu), summed per part by name
#: whatever their template arguments.
PORT_KERNELS = ("sweep_kernel", "row_params_kernel", "assembled_kernel",
                "conv_wgmma_kernel",
                "conv_f32_kernel", "uv_project_kernel",
                "stats_fold",
                "render_kernel", "render_layers_kernel", "wgrad_wgmma_kernel",
                "wgrad_f32_kernel", "wgrad_reduce")
#: The setup spans kept; the oldest drop out first.
SETUP_SPANS_MAX = 4096

_profiling = torch._C._autograd._profiler_enabled
_NO_SPAN = contextlib.nullcontext()


def span(name: str):
    """A hot-path span: record_function(name) while a profiler records,
    else the one shared no-op context."""
    return record_function(name) if _profiling() else _NO_SPAN


class SetupSpan(NamedTuple):
    """A closed setup span: start and end on time.perf_counter(); depth,
    the setup spans open around it on its thread."""
    name: str
    start: float
    end: float
    depth: int


_setup_spans = collections.deque(maxlen=SETUP_SPANS_MAX)
_setup_depth = threading.local()


@contextlib.contextmanager
def setup_span(name: str):
    """A cold-path span, recorded whether or not a profiler records."""
    depth = getattr(_setup_depth, "n", 0)
    _setup_depth.n = depth + 1
    start = time.perf_counter()
    try:
        with span(name):
            yield
    finally:
        _setup_depth.n = depth
        _setup_spans.append(SetupSpan(name, start, time.perf_counter(),
                                      depth))


def setup_spans():
    """The process's setup spans in the order they closed."""
    return list(_setup_spans)


def _card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def chrome_events(prof):
    """The trace's complete ("X") events, as its Chrome export has them."""
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as fh:
            events = json.load(fh)["traceEvents"]
    return [e for e in events if e.get("ph") == "X"]


def _device(events):
    return [(e.get("name", ""), float(e["ts"]), float(e.get("dur", 0.0)))
            for e in events if e.get("cat") in DEVICE_CATS]


def device_events(prof):
    """The trace's device events: [(name, start us, duration us)]."""
    return _device(chrome_events(prof))


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


def span_self_us(spans):
    """spans [(name, start us, duration us, thread)] -> {name: (count,
    self us)}: each span's duration less that of the spans directly
    inside it on its thread, summed by name."""
    out = collections.defaultdict(lambda: [0, 0.0])
    by_thread = collections.defaultdict(list)
    for name, ts, dur, tid in spans:
        by_thread[tid].append((ts, -dur, name))
    for items in by_thread.values():
        stack = []                  # [name, end, self]

        def close():
            name, _, own = stack.pop()
            out[name][0] += 1
            out[name][1] += own

        for ts, neg, name in sorted(items):
            while stack and ts >= stack[-1][1]:
                close()
            if stack:
                stack[-1][2] += neg
            stack.append([name, ts - neg, -neg])
        while stack:
            close()
    return {name: tuple(v) for name, v in out.items()}


def trace_window(fn):
    """fn's CALLS calls after 2 warm-up, traced between two spins ->
    (host wall ms per call, device events, program spans [(name, start
    us, duration us, thread)])."""
    for _ in range(2):
        fn()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    for i in range(TRIES):
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=acts) as prof:
            torch.cuda._sleep(SPIN_CYCLES)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(CALLS):
                fn()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3 / CALLS
            torch.cuda._sleep(SPIN_CYCLES)
            torch.cuda.synchronize()
        events = chrome_events(prof)
        dev = _device(events)
        spins = sum(SPIN_KERNEL in e[0] for e in dev)
        dev = [e for e in dev if SPIN_KERNEL not in e[0]]
        if spins == 2 and dev:
            return wall, dev, [
                (e.get("name", ""), float(e["ts"]), float(e.get("dur", 0.0)),
                 e.get("tid")) for e in events if e.get("cat") == SPAN_CAT]
        print(f"trace: window {i + 1}/{TRIES} kept {spins} of 2 spins and "
              f"{len(dev)} device operations; taken again", file=sys.stderr)
    raise RuntimeError(f"no window of {TRIES} kept both spins and a device "
                       f"operation")


def summary(wall, events):
    """(host wall ms, device busy ms, idle share, device ops) per call,
    and device us and launches by kernel name over the window."""
    busy = busy_us(events) / 1e3 / CALLS
    by_name, counts = collections.Counter(), collections.Counter()
    for name, _, dur in events:
        by_name[name] += dur
        counts[name] += 1
    return (wall, busy, 1.0 - busy / wall, len(events) / CALLS, by_name,
            counts)


def trace_part(fn):
    """summary() of trace_window(fn)."""
    wall, events, _ = trace_window(fn)
    return summary(wall, events)


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
            wall, events, spans = trace_window(fn)
            wall, busy, idle, ops, by_name, counts = summary(wall, events)
            print(f"{part:7s} host wall {wall:.3f} ms/{unit}, device busy "
                  f"{busy:.3f} ms/{unit}, idle share {idle:.3f}, "
                  f"{ops:.0f} device ops/{unit} {tag}")
            for name, us in by_name.most_common(TOP):
                print(f"    {us / 1e3 / CALLS:8.3f} ms/{unit} "
                      f"{name[:100]}")
            for kern, (n, us) in port_kernels(by_name, counts).items():
                print(f"    port kernel {kern}: {us / 1e3 / CALLS:.4f} "
                      f"ms/{unit} in {n / CALLS:g} launches/{unit}")
            for name, (n, us) in sorted(span_self_us(spans).items()):
                print(f"    span {name}: host self {us / 1e3 / CALLS:.4f} "
                      f"ms/{unit} in {n / CALLS:g} spans/{unit}")


if __name__ == "__main__":
    main()
