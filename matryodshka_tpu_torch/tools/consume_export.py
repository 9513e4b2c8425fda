"""External consumer of the port's export artifacts.

A `.pt2` written by `matryodshka_tpu_torch.cli.export` and its sibling
`.meta.json` are all a runtime needs (the counterpart of the repo's
tools/consume_export.py for the StableHLO artifacts). Usage, as a script
so that no package is imported unless the program needs one:

  python matryodshka_tpu_torch/tools/consume_export.py DIR/NAME.pt2 \
      [--device cuda|cpu] [--out out.npy]

Loads the program with torch.export.load, reads the input contract from
meta.json, feeds inputs of the declared shapes drawn from
np.random.RandomState(0) (uniform [0, 1) float32, or uniform bytes for
the uint8 inputs meta.json's `input_dtypes` declares) on --device (the
meta's platform by default), prints each output's shape, dtype, range and
finiteness and, with --out, saves the first output as .npy. A float32
program runs its convs in float32 (TF32 off, as the exporting side
computes them).

A program of the net alone imports nothing of this repository. A program
that carries custom ops (the full pipeline's sweep, `matry::sweep_volume`)
lists them in meta.json's `custom_ops`, and its `op_module` registers
them: the tool imports that one module, from the checkout this script
lies in, before it loads the program, and only then. It prints which
modules of either package (or JAX) it imported.
"""

from __future__ import annotations

import argparse
import importlib
import json
import os
import sys

import numpy as np
import torch


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("path")
    parser.add_argument("--device", default=None)
    parser.add_argument("--out", default=None)
    args = parser.parse_args(argv)
    with open(args.path.rsplit(".", 1)[0] + ".meta.json") as fh:
        meta = json.load(fh)
    device = torch.device(args.device or meta["platform"])
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    if meta.get("custom_ops"):
        # the checkout's root: this file is <root>/matryodshka_tpu_torch/
        # tools/consume_export.py
        sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__)))))
        importlib.import_module(meta["op_module"])
        print(f"registered {meta['custom_ops']} from {meta['op_module']}")
    program = torch.export.load(args.path)
    print(f"loaded {args.path}: platform {meta['platform']}, "
          f"interface {meta['interface']}")
    rng = np.random.RandomState(0)
    dtypes = meta["interface"].get("input_dtypes", {})
    inputs = []
    for name, shape in meta["interface"]["inputs"].items():
        x = (rng.randint(0, 256, size=shape).astype(np.uint8)
             if dtypes.get(name) == "uint8"
             else rng.rand(*shape).astype(np.float32))
        inputs.append(torch.from_numpy(x).to(device))
    with torch.no_grad():
        outs = program.module()(*inputs)
    outs = outs if isinstance(outs, (tuple, list)) else (outs,)
    for i, o in enumerate(outs):
        o = o.float().cpu().numpy()
        print(f"out[{i}]: shape={o.shape} dtype={o.dtype} "
              f"range=[{o.min():.4f}, {o.max():.4f}] "
              f"finite={bool(np.isfinite(o).all())}")
    if args.out:
        np.save(args.out, outs[0].float().cpu().numpy())
    loaded = sorted(m for m in sys.modules
                    if m.split(".")[0] in ("matryodshka_tpu",
                                           "matryodshka_tpu_torch", "jax"))
    print(f"modules of either package or JAX imported: {loaded}")
    return outs


if __name__ == "__main__":
    main()
