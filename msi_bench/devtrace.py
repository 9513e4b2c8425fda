"""Device traces: a torch.profiler window opened and closed by a spin kernel.

The profiler now and then drops a device event at an edge of its window, so
the window's first and last device operations are spins
(`torch.cuda._sleep`), which no reading counts. A window that did not keep
both spins, or whose operations are not a whole multiple of the calls made,
is taken again, up to TRIES times; after that the run fails rather than
read a window that may have lost an operation. Device busy time is the length of the
union of the kernel, copy and set intervals.
"""

from __future__ import annotations

import collections
import json
import os
import sys
import tempfile
import warnings

import torch

from msi_bench.stats import union_length

SPIN_CYCLES = 20_000_000
SPIN_NAME = "spin_kernel"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation")
TRIES = 5
TOP = 10


def _events(prof):
    """(device [(name, start us, dur us)], host [(name, start, dur)])."""
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as fh:
            events = json.load(fh)["traceEvents"]
    dev, host = [], []
    for e in events:
        if e.get("ph") != "X":
            continue
        item = (e.get("name", ""), float(e["ts"]), float(e.get("dur", 0.0)))
        if e.get("cat") in DEVICE_CATS:
            dev.append(item)
        elif e.get("cat") in HOST_CATS:
            host.append(item)
    return dev, host


def _window(fn, host: bool):
    acts = [torch.profiler.ProfilerActivity.CUDA]
    if host:
        acts.append(torch.profiler.ProfilerActivity.CPU)
    torch.cuda.synchronize()
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", message=".*Profiler clears events")
        with torch.profiler.profile(activities=acts) as prof:
            torch.cuda._sleep(SPIN_CYCLES)
            torch.cuda.synchronize()
            wall = fn()
            torch.cuda._sleep(SPIN_CYCLES)
            torch.cuda.synchronize()
        dev, hst = _events(prof)
    spins = sum(SPIN_NAME in e[0] for e in dev)
    return spins, [e for e in dev if SPIN_NAME not in e[0]], hst, wall


def trace(fn, calls: int, host: bool = False):
    """Trace fn() (which makes `calls` calls and returns its host wall
    seconds, or None) between two spins -> (device events, host events,
    wall)."""
    for i in range(TRIES):
        spins, dev, hst, wall = _window(fn, host)
        if spins == 2 and dev and len(dev) % calls == 0:
            return dev, hst, wall
        print(f"devtrace: window {i + 1}/{TRIES} kept {spins} of 2 spins and "
              f"{len(dev)} operations for {calls} calls; taken again",
              file=sys.stderr)
    raise RuntimeError(f"devtrace: no window of {TRIES} kept both spins and "
                       f"a whole number of operations for {calls} calls")


def busy_s(dev) -> float:
    return union_length([(ts, dur) for _, ts, dur in dev]) / 1e6


def top_ops(dev):
    """The device operations that took most time: [[name, seconds]]."""
    by_name = collections.Counter()
    for name, _, dur in dev:
        by_name[name[:120]] += dur / 1e6
    return [[n, s] for n, s in by_name.most_common(TOP)]


def idle_gaps(dev, host):
    """The idle gaps between device operations, summed by what the host was
    doing at each gap's midpoint (the innermost host operation there):
    [[name, seconds]], longest first."""
    spans = sorted((ts, ts + dur) for _, ts, dur in dev)
    merged = []
    for lo, hi in spans:
        if merged and lo <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], hi)
        else:
            merged.append([lo, hi])
    by_name = collections.Counter()
    for (_, end), (start, _) in zip(merged, merged[1:]):
        mid = (end + start) / 2
        inside = [(dur, name) for name, ts, dur in host
                  if ts <= mid <= ts + dur]
        name = min(inside)[1] if inside else "no host op (Python, ctypes)"
        by_name[f"host: {name[:100]}"] += (start - end) / 1e6
    return [[n, s] for n, s in by_name.most_common(TOP)]
