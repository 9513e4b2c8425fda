"""sweep_assembled_roofline.hres: the sweep_assembled stage's least time on the chip
(work/sweep_assembled.py) over its device busy time per call (a spin-bracketed
trace of the stage alone), %."""


def read(ctx):
    return ctx.roofline("sweep_assembled")
