"""The high-res assembled sweep's work: the high-res pair and the low-res
alphas and blend weights read once, the interleaved stack [B, P, Hh, Wh, 4]
written once in its dtype. Per (shell, pixel): both eyes' three channels
sampled bilinearly (2 x 3 x 9), the alpha and blend weight upsampled
bilinearly (2 x 9) and blend_psv's blend (9), in f32."""

OPS_PER_TEXEL = 2 * 3 * 9 + 2 * 9 + 9


def count(ctx):
    io = ctx.driver.stage_io
    ref, src, _, _, alphas, blend = io["args"]
    stack = io["stack"]
    b, p, hh, hw, _ = stack.shape
    nbytes = (4 * (ref.numel() + src.numel() + alphas.numel() + blend.numel())
              + stack.numel() * stack.element_size())
    return OPS_PER_TEXEL * b * p * hh * hw, nbytes, "f32"
