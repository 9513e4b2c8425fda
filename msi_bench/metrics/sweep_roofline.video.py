"""sweep_roofline.video: the sweep stage's least time on the chip
(work/sweep.py) over its device busy time per call (a spin-bracketed
trace of the stage alone), %."""


def read(ctx):
    return ctx.roofline("sweep")
