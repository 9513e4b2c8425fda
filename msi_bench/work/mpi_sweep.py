"""The planar sweep stage's work (REALESTATE_PP): both images read once
(float32) and the net input [B, 3 + 2*P*3, H, W] written once in its dtype.
Per output sample (an image's plane p at one pixel): the 3x3 homography
applied to (x, y, 1) and the divide by w (15 f32 operations), the bilinear
weights (8) and four taps of 3 channels weighted and summed (24)."""

OPS_PER_SAMPLE = 15 + 8 + 24


def count(ctx):
    io = ctx.driver.stage_io
    img, vol = io["batch"]["ref_image"], io["vol"]
    b, _, h, w = vol.shape
    p = ctx.cfg.num_psv_planes
    nbytes = 2 * img.numel() * 4 + vol.numel() * vol.element_size()
    return OPS_PER_SAMPLE * b * 2 * p * h * w, nbytes, "f32"
