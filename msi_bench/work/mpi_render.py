"""The planar render stage's work (blend_psv's MPI): the volume's fg and
bg channels [0, 6P) and the prediction's blend weights and alphas read
once, the view [B, H, W, 3] written once in float32. The render composites
back to front with no early exit, so every (pixel, plane) sample counts:
the plane's homography applied to (x, y, 1) and the divide (15 f32
operations), the bilinear weights (8), four taps of 4 channels weighted
and summed (32), the blend (9) and the over step (8)."""

OPS_PER_SAMPLE = 15 + 8 + 32 + 9 + 8


def count(ctx):
    io = ctx.driver.stage_io
    vol, pred = io["vol"], io["pred"]
    b, _, h, w = vol.shape
    p = ctx.cfg.num_msi_planes
    nbytes = (b * 6 * p * h * w * vol.element_size()
              + b * 2 * p * h * w * pred.element_size() + b * h * w * 3 * 4)
    return OPS_PER_SAMPLE * b * p * h * w, nbytes, "f32"
