"""request_idle_ms.hres: the device's idle ms that a re-render's own request
path causes: the median over the traced re-renders of the idle time from
the start of the program's `test.hres_render` span to the end of the last
device operation that starts before the next such span, in a
spin-bracketed host-and-device trace of the mix's trace_requests calls
(program_spans.py). The gap after a re-render's last device operation, the
harness's loop, is not counted."""

import statistics

from msi_bench import program_spans


def read(ctx):
    got = program_spans.traffic_trace(ctx)
    if got is None:
        return None
    dev, host = got
    idle = program_spans.request_idle_us(
        dev, [ts for ts, _ in program_spans.named(host, "test.hres_render")])
    return statistics.median(idle) / 1e3 if idle else None
