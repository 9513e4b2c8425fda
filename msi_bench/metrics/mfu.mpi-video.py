"""mfu.mpi-video: the least time on the chip of a call of the viewers'
frames (the sum over mpi_sweep, net and mpi_render of work/<stage>.py's
least times) over the measured time a call (the window over the calls it
completed), %."""


def read(ctx):
    return ctx.mfu()
