"""mpi_render_host_us.mpi-video: the median host us of one
`msi.mpi_render_stage` call (the assembly, the warps and the composite
submitted), read from the program's own `msi.mpi_render_stage` spans (one
a call) in a spin-bracketed host-and-device trace of the mix's
trace_requests calls (program_spans.py). A program without that span
gives nothing to read."""

import statistics

from msi_bench import program_spans


def read(ctx):
    got = program_spans.traffic_trace(ctx)
    durs = [] if got is None else [
        dur for _, dur in program_spans.named(got[1], "msi.mpi_render_stage")]
    return statistics.median(durs) if durs else None
