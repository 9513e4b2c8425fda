"""mpi_sweep_roofline.mpi-video: the planar sweep stage's least time on the
chip (work/mpi_sweep.py) over its device busy time per call (a
spin-bracketed trace of the stage alone), %."""


def read(ctx):
    return ctx.roofline("mpi_sweep")
