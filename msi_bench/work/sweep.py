"""The sweep stage's work: both eyes' ODS pair read once, the volume
[B, 2*P*3, H, W] written once in its dtype; per output sample one bilinear
tap set, three lerps of three operations (f32)."""

OPS_PER_SAMPLE = 9


def count(ctx):
    io = ctx.driver.stage_io
    img, vol = io["batch"]["ref_image"], io["vol"]
    nbytes = 2 * img.numel() * 4 + vol.numel() * vol.element_size()
    return OPS_PER_SAMPLE * vol.numel(), nbytes, "f32"
