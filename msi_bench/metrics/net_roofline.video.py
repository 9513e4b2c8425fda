"""net_roofline.video: the net stage's least time on the chip
(work/net.py) over its device busy time per call (a spin-bracketed
trace of the stage alone), %."""


def read(ctx):
    return ctx.roofline("net")
