"""One run of one cell: set-up, the measured window, the readings, the check.

Everything that belongs to one configuration, traffic mix or metric is a
file that this module finds by name:

  BENCHMARK.json              the cells, the metrics and their bounds
  <configs[].file>            a configuration: MatryConfig fields + metadata
  traffic/<traffic>.json      a traffic mix: its driver, parameters, limits
  drivers/<driver>.py         a kind of loop: class Driver (see below)
  metrics/<metric>.py         a per-layer metric: read(ctx) -> value or None
  work/<stage>.py             a stage's work: count(ctx) -> (flops, bytes,
                              peak) from the algorithm's shapes

A Driver(ctx) builds the program's state and its inputs from ctx.gen and
warms up; window(seconds) runs the traffic and returns {"requests" (the
calls made), "window_s", "latencies_s", "submit_s", "sample"}, and
"answers" where a call answers more than once; e2e(win) gives its
end-to-end metrics, {name: function of no arguments}; traffic(n) runs n
requests as the window does and returns the host wall; stages() gives
{stage: fn} for stage traces and stage_io the stages' inputs and outputs;
request_stages names the stages a request runs; span_targets names the
(module, function) calls into the program that the idle gaps' trace wraps
in spans; free() drops the program's state; check(sample, q=None) compares
the sample with the reference ({number: value}; q: the control, the
reference in a lower precision in the program's place).
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import math
import statistics
import sys
import time
from pathlib import Path

import torch

from msi_bench import devtrace, peaks, reference, seeding
from msi_bench.spans import spans

BENCH_DIR = Path(__file__).resolve().parent
#: Top-level module names that no run may hold once its window has closed.
FORBIDDEN = ("jax", "jaxlib", "flax", "matryodshka_tpu")
STAGE_CALLS = 20


def load_json(path: Path):
    with open(path) as fh:
        return json.load(fh)


def load_module(bench_dir: Path, kind: str, name: str):
    """bench_dir/kind/name.py as a module, or None if there is none."""
    path = bench_dir / kind / f"{name}.py"
    if not path.is_file():
        return None
    safe = "".join(ch if ch.isalnum() else "_" for ch in name)
    spec = importlib.util.spec_from_file_location(
        f"msi_bench_{kind}_{safe}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def forbidden_modules():
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def _applies(metric, cell, bench) -> bool:
    """Whether a metric is reported in a cell: its "workloads" list, or,
    without one, every cell (end to end) or every cell that reports the
    end-to-end metric it moves (per layer)."""
    if "workloads" in metric:
        return cell["name"] in metric["workloads"]
    if "moves" not in metric:
        return True
    moved = [m for m in bench["end_to_end"] if m["name"] == metric["moves"]]
    return bool(moved) and _applies(moved[0], cell, bench)


class Ctx:
    """What a driver, a metric reader and a work count see of a run."""

    def __init__(self, bench_dir, cell, config, traffic, seed, device):
        from matryodshka_tpu_torch import entry
        from matryodshka_tpu_torch.config import MatryConfig

        names = {f.name for f in dataclasses.fields(MatryConfig)}
        self.bench_dir = bench_dir
        self.cell, self.config, self.traffic = cell, config, traffic
        self.seed = seed
        self.device = torch.device(device)
        self.cfg = entry.flagship_cfg(
            **{k: v for k, v in config.items() if k in names})
        self.gen = seeding.generator(seed, self.device)
        self.tree = seeding.weight_tree(
            reference.unet.layer_shapes(
                self.cfg.ngf, self.cfg.num_net_inputs(),
                self.cfg.num_net_outputs(), self.cfg.net_variant),
            self.gen, self.device)
        self.driver = None
        self.window = None
        self._memo = {}

    def sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _once(self, key, fn):
        if key not in self._memo:
            self._memo[key] = fn()
        return self._memo[key]

    def least_s(self, stage: str):
        """The stage's least time on the chip (peaks.least_s of its work
        count), or None where work/<stage>.py is missing."""
        def count():
            mod = load_module(self.bench_dir, "work", stage)
            return None if mod is None else peaks.least_s(*mod.count(self))
        return self._once(("least", stage), count)

    def stage_busy_s(self, stage: str):
        """Device busy seconds per call of the stage, from a spin-bracketed
        trace of STAGE_CALLS calls of it alone; None where the driver has
        no such stage."""
        fn = self.driver.stages().get(stage)
        if fn is None:
            return None

        def measure():
            fn()
            fn()

            def calls():
                for _ in range(STAGE_CALLS):
                    fn()
            dev, _, _ = devtrace.trace(calls, STAGE_CALLS)
            return devtrace.busy_s(dev) / STAGE_CALLS
        return self._once(("busy", stage), measure)

    def roofline(self, stage: str):
        """The stage's least time over its device busy time a call, %; None
        where either is missing."""
        least, busy = self.least_s(stage), self.stage_busy_s(stage)
        return None if least is None or not busy else 100.0 * least / busy

    def per_call_s(self):
        """Host seconds a call in the measured window."""
        return self.window["window_s"] / self.window["requests"]

    def mfu(self):
        """A call's least time (the sum over the driver's request_stages)
        over the measured time a call, %; None where a stage has no work
        count or the window completed no call."""
        least = [self.least_s(s) for s in self.driver.request_stages]
        if None in least or not self.window["requests"]:
            return None
        return 100.0 * sum(least) / self.per_call_s()

    def idle_share(self):
        """1 - (device busy seconds a call, from the traffic trace) / (host
        seconds a call in the measured window), %. The trace's own host
        wall is not the denominator: tracing slows the host's launches, so
        a cell the host paces would read idler under the trace than it
        runs."""
        busy, _, _ = self.traffic_trace()
        per_call = busy / self.traffic["trace_requests"]
        return 100.0 * (1.0 - per_call / self.per_call_s())

    def traffic_trace(self):
        """(device busy s, host wall s, top device operations) over a
        spin-bracketed trace of the cell's own traffic (device activity
        only, so the host pays no tracing of its operations)."""
        n = self.traffic["trace_requests"]

        def measure():
            dev, _, wall = devtrace.trace(lambda: self.driver.traffic(n), n)
            return devtrace.busy_s(dev), wall, devtrace.top_ops(dev)
        return self._once("traffic", measure)

    def idle_gaps(self):
        """The traffic's idle gaps by host activity, from a second trace
        that records the host's operations too, with a span around each of
        the driver's span_targets."""
        n = self.traffic["trace_requests"]

        def measure():
            with spans(self.driver.span_targets):
                dev, host, _ = devtrace.trace(
                    lambda: self.driver.traffic(n), n, host=True)
            return devtrace.idle_gaps(dev, host)
        return self._once("gaps", measure)


def load_cell(workload: str, bench_dir: Path = BENCH_DIR):
    """(benchmark, cell, configuration, traffic mix, driver module) of a
    cell, each found by its name."""
    root = bench_dir.parent
    bench = load_json(root / "BENCHMARK.json")
    cell = next(w for w in bench["workloads"] if w["name"] == workload)
    conf = next(c for c in bench["configs"] if c["name"] == cell["config"])
    config = load_json(root / conf["file"])
    traffic = load_json(bench_dir / "traffic" / f"{cell['traffic']}.json")
    return (bench, cell, config, traffic,
            load_module(bench_dir, "drivers", traffic["driver"]))


def per_layer(bench, cell, ctx):
    """{name: {"value", "unit"}} of the cell's per-layer metrics, each from
    metrics/<name>.py; a reader that finds nothing to read is left out."""
    out = {}
    for m in bench["per_layer"]:
        if not _applies(m, cell, bench):
            continue
        reader = load_module(ctx.bench_dir, "metrics", m["name"])
        value = None if reader is None else reader.read(ctx)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def run_cell(workload: str, seed: int, seconds: float, trace: int,
             device: str = "cuda", bench_dir: Path = BENCH_DIR,
             t_start: float = None):
    """Run one cell once -> (result dict, checks {name: (value, limit)}).
    The result's "checks" key, last, holds the same numbers."""
    t_start = time.perf_counter() if t_start is None else t_start
    bench, cell, config, traffic, driver_mod = load_cell(workload, bench_dir)
    ctx = Ctx(bench_dir, cell, config, traffic, seed, device)
    drv = ctx.driver = driver_mod.Driver(ctx)
    ctx.sync()
    setup_s = time.perf_counter() - t_start
    win = ctx.window = drv.window(seconds)
    ctx.sync()
    lat, sub = win["latencies_s"], win["submit_s"]
    print(f"window: {win['requests']} requests in {win['window_s']:.4f} s; "
          f"median latency {statistics.median(lat) * 1e3 if lat else 0:.4f} "
          f"ms, median host submit "
          f"{statistics.median(sub) * 1e3 if sub else 0:.4f} ms",
          file=sys.stderr)
    cuda = ctx.device.type == "cuda"
    dev_info = {
        "platform": "gpu" if cuda else "cpu",
        "kind": torch.cuda.get_device_name(ctx.device) if cuda else "cpu",
        "count": 1,
        "memory_peak_bytes": (torch.cuda.max_memory_allocated(ctx.device)
                              if cuda else 0)}

    metrics, breakdown = {}, None
    if not trace:
        e2e = drv.e2e(win)
        e2e["setup_s"] = lambda: setup_s
        for m in bench["end_to_end"]:
            if _applies(m, cell, bench):
                metrics[m["name"]] = {"value": e2e[m["name"]](),
                                      "unit": m["unit"]}
    else:
        metrics = per_layer(bench, cell, ctx)
        busy, wall, ops = ctx.traffic_trace()
        dev_info.update(busy_s=busy, window_s=wall)
        breakdown = {"device_ops": ops, "idle_gaps": ctx.idle_gaps()}

    drv.free()
    limits = traffic["limits"]
    got = drv.check(win["sample"])
    checks = {k: (got[k], limits[k]) for k in limits}
    correct = all(math.isfinite(v) and v <= lim for v, lim in checks.values())
    result = {"correct": correct,
              "attempted": win.get("answers", win["requests"]), "failed": 0,
              "metrics": metrics, "device": dev_info}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = {k: {"value": v, "limit": lim}
                        for k, (v, lim) in checks.items()}
    return result, checks
