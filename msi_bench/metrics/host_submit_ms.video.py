"""host_submit_ms.video: the host's ms from the start of a call's
`entry.forward` to its return, with no synchronize: the median over every
call of the measured window (untraced)."""

import statistics


def read(ctx):
    sub = ctx.window["submit_s"]
    return statistics.median(sub) * 1e3 if sub else None
