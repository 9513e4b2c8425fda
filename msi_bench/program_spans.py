"""The program's own spans in a cell's traffic, for the per-layer metrics
that read them.

One spin-bracketed trace of the mix's trace_requests calls, host and device
activity, with no span from the benchmark's side (`spans.py`), so every
span in it is the program's (`matryodshka_tpu_torch.trace`): memoized on
the run, so that its readers share it. A program without spans gives
nothing to read, and no trace is taken for it.
"""

from __future__ import annotations

from msi_bench import devtrace
from msi_bench.stats import union_length


def traffic_trace(ctx):
    """(device events, host events), each [(name, start us, duration us)],
    of the cell's traffic; None where the program opens no span."""
    from matryodshka_tpu_torch import trace

    if not hasattr(trace, "span"):
        return None
    n = ctx.traffic["trace_requests"]

    def measure():
        dev, host, _ = devtrace.trace(lambda: ctx.driver.traffic(n), n,
                                      host=True)
        return dev, host
    return ctx._once("program_spans", measure)


def named(host, name: str):
    """The host events called name: [(start us, duration us)]."""
    return [(ts, dur) for n, ts, dur in host if n == name]


def request_idle_us(dev, starts):
    """For each request span's start (us), the device's idle us from it to
    the end of the last device operation that starts before the next
    request's span (after the last request's: any); a request that started
    no device operation is left out."""
    starts = sorted(starts)
    out = []
    for i, lo in enumerate(starts):
        hi = starts[i + 1] if i + 1 < len(starts) else float("inf")
        ops = [(ts, dur) for _, ts, dur in dev if lo <= ts < hi]
        if ops:
            end = max(ts + dur for ts, dur in ops)
            out.append(end - lo - union_length(ops))
    return out


def top_level_s(spans):
    """The summed seconds of the setup spans that no other one holds (depth
    0), or None where there are none."""
    top = [s.end - s.start for s in spans if s.depth == 0]
    return sum(top) if top else None
