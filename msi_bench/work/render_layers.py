"""The high-res layer-stack render's work: the stack read once (back to
front: every shell is needed), the colour and the depth proxy written once
(float32, 3 channels each). Per (pixel, shell): the ray's hit and its
angles (~40 f32 operations), four taps of 4 channels weighted and summed
(32), the colour composite (8) and the depth composite (4)."""

OPS_PER_SAMPLE = 40 + 32 + 8 + 4


def count(ctx):
    stack = ctx.driver.stage_io["stack"]
    b, p, hh, hw, _ = stack.shape
    nbytes = stack.numel() * stack.element_size() + 2 * b * hh * hw * 3 * 4
    return OPS_PER_SAMPLE * b * p * hh * hw, nbytes, "f32"
