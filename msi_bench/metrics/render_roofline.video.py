"""render_roofline.video: the render stage's least time on the chip
(work/render.py) over its device busy time per call (a spin-bracketed
trace of the stage alone), %."""


def read(ctx):
    return ctx.roofline("render")
