"""The net stage's work from the U-Net's shapes (reference.unet.plan):
per stage output pixel x Cout x Cin x taps multiply-adds (3x3 convs and
stride-2 downs 9 taps, the coord net's with one more input channel; each
4x4 stride-2 transposed conv's output pixel 2 x 2 taps; the 1x1 head one),
2 operations each, plus the layer norm and ReLU of every output but the
head's (5 operations an element) and the head's tanh (1). Bytes: the
volume read once, the weights once in bfloat16 (biases and norm vectors in
float32) and the prediction written once. Counted at the bf16 peak."""

from msi_bench.reference.unet import plan

LN_OPS = 5


def count(ctx):
    cfg, tree = ctx.cfg, ctx.tree
    io = ctx.driver.stage_io
    vol, pred = io["vol"], io["pred"]
    coord = int(cfg.net_variant == "coord")
    size = {"x": (vol.shape[1], vol.shape[2], vol.shape[3])}
    flops = 0
    stages = plan(cfg.ngf, vol.shape[1], pred.shape[1])
    for name, kind, srcs, cout, _ in stages:
        cin = sum(size[s][0] for s in srcs)
        _, h, w = size[srcs[0]]
        if kind == "conv":
            taps, cin = 9, cin + coord
        elif kind == "down":
            taps, cin, h, w = 9, cin + coord, h // 2, w // 2
        elif kind == "deconv":
            taps, h, w = 4, 2 * h, 2 * w
        else:
            taps = 1
        flops += 2 * h * w * cout * cin * taps
        flops += (LN_OPS if kind != "head" else 1) * h * w * cout
        size[name] = (cout, h, w)
    wbytes = sum(t.numel() * (2 if leaf == "kernel" else 4)
                 for d in tree.values() for leaf, t in d.items())
    nbytes = (vol.numel() * vol.element_size() + wbytes
              + pred.numel() * pred.element_size())
    return flops * vol.shape[0], nbytes, "bf16"
