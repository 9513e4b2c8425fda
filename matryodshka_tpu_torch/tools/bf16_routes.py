"""How far the net's two bfloat16 routes sit from its float32 plain net,
over many inputs, on the card.

    python -m matryodshka_tpu_torch.tools.bf16_routes [--seeds 50] \
        [--height 32] [--width 64] [--planes 4] [--ngf 8] [--wrap_net]

The two bf16 routes are the exported net-only program (cli/export.py: the
plain MSIUNet in bf16, cuDNN's convs) and the kernel route
(ops/net.unet_forward: csrc/conv.cu, its layer norms fused, in bf16). For
each seed the input is torch.rand from a torch.Generator seeded with it,
the weights weights.seeded_init(cfg, 0) (the coord net unless
--wrap_net), and each route's atlas (models/unet.atlas_pack) is held to
the float32 plain net's (TF32 off). Prints, per seed, each route's max
|distance| from float32 and their max |distance| from each other, then
the largest of each over the seeds and how many seeds exceed the port's
standing bf16 gate (2e-2). Exits non-zero without a card.
"""

from __future__ import annotations

import argparse
import sys

import torch

GATE = 2e-2


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--seeds", type=int, default=50)
    parser.add_argument("--height", type=int, default=32)
    parser.add_argument("--width", type=int, default=64)
    parser.add_argument("--planes", type=int, default=4)
    parser.add_argument("--ngf", type=int, default=8)
    parser.add_argument("--wrap_net", action="store_true")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("bf16_routes: needs a CUDA device", file=sys.stderr)
        sys.exit(2)
    from matryodshka_tpu_torch import entry, weights
    from matryodshka_tpu_torch.cli import export as export_cli
    from matryodshka_tpu_torch.models.unet import atlas_pack
    from matryodshka_tpu_torch.ops import net as net_ops

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    h, w = args.height, args.width
    cfgs = {dt: entry.flagship_cfg(
        height=h, width=w, num_psv_planes=args.planes,
        num_msi_planes=args.planes, ngf=args.ngf, compute_dtype=dt,
        coord_net=not args.wrap_net, net_only=True)
        for dt in ("float32", "bfloat16")}
    tree = weights.seeded_init(cfgs["float32"], 0)
    f32 = export_cli.build_net_only_fn(cfgs["float32"], tree, dev)
    program = export_cli.export_net_only(cfgs["bfloat16"], tree, dev).module()
    stages = entry.make_params(cfgs["bfloat16"], flax_params=tree,
                               device=dev).stages
    channels = min(64, cfgs["float32"].num_net_outputs())
    worst = {"program": 0.0, "kernel": 0.0, "between": 0.0}
    over = dict.fromkeys(worst, 0)
    for seed in range(args.seeds):
        gen = torch.Generator(device=dev).manual_seed(seed)
        x = torch.rand((1, h, w, cfgs["float32"].num_net_inputs()),
                       generator=gen, device=dev)
        with torch.no_grad():
            want = f32(x)
            prog = program(x)
            pred = net_ops.unet_forward(stages, x.permute(0, 3, 1, 2).to(
                torch.bfloat16).contiguous())
            kern = atlas_pack(pred.permute(0, 2, 3, 1), h, w, channels)
        errs = {"program": (prog - want).abs().max().item(),
                "kernel": (kern - want).abs().max().item(),
                "between": (prog - kern).abs().max().item()}
        print(f"seed {seed:3d}: program-f32 {errs['program']:.4e} "
              f"kernel-f32 {errs['kernel']:.4e} program-kernel "
              f"{errs['between']:.4e}")
        for k, e in errs.items():
            worst[k] = max(worst[k], e)
            over[k] += e > GATE
    net = "wrap" if args.wrap_net else "coord"
    print(f"{net} net {w}x{h}, {args.planes}+{args.planes} planes, ngf "
          f"{args.ngf}, {args.seeds} seeds on {torch.cuda.get_device_name(0)}"
          f": max program-f32 {worst['program']:.4e} ({over['program']} "
          f"over {GATE}), kernel-f32 {worst['kernel']:.4e} "
          f"({over['kernel']} over), program-kernel {worst['between']:.4e} "
          f"({over['between']} over)")
    return worst


if __name__ == "__main__":
    main()
