"""idle_share.hres: the device's idle share of the cell's traffic, %:
1 - (device busy seconds a call, from a spin-bracketed trace of the mix's
trace_requests calls, device activity only) / (host seconds a call in the
measured window); see harness.Ctx.idle_share."""


def read(ctx):
    return ctx.idle_share()
