"""frame_device_ms: the card's busy ms a frame in the cell's own traffic:
the union of the device operations' intervals over a spin-bracketed trace
of the mix's trace_requests calls (device activity only), over the frames
those calls render. It reads the device alone, whatever pace the host
sets."""


def read(ctx):
    busy, _, _ = ctx.traffic_trace()
    frames = ctx.traffic["trace_requests"] * ctx.traffic.get("viewers", 1)
    return busy / frames * 1e3
