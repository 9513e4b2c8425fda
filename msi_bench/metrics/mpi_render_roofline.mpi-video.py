"""mpi_render_roofline.mpi-video: the planar render stage's least time on
the chip (work/mpi_render.py) over its device busy time per call (a
spin-bracketed trace of the stage alone), %."""


def read(ctx):
    return ctx.roofline("mpi_render")
