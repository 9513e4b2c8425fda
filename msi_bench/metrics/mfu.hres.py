"""mfu.hres: the least time on the chip of a re-render (the sum of its
stages' work/<stage>.py least times) over the measured time a call (the
window over the calls it completed), %. It stays meaningful when a later
change fuses or removes a kernel."""


def read(ctx):
    return ctx.mfu()
