"""conv_host_us.video: the median host us of one `ops/conv.conv` call (its
checks, argument marshalling and launch), read from the program's own
`conv.conv` spans (18 a call) in a spin-bracketed host-and-device trace of
the mix's trace_requests calls (program_spans.py)."""

import statistics

from msi_bench import program_spans


def read(ctx):
    got = program_spans.traffic_trace(ctx)
    durs = [] if got is None else [
        dur for _, dur in program_spans.named(got[1], "conv.conv")]
    return statistics.median(durs) if durs else None
