"""render_layers_roofline.hres: the render_layers stage's least time on the chip
(work/render_layers.py) over its device busy time per call (a spin-bracketed
trace of the stage alone), %."""


def read(ctx):
    return ctx.roofline("render_layers")
