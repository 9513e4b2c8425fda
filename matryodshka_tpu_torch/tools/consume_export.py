"""External consumer of the port's export artifacts.

A `.pt2` written by `matryodshka_tpu_torch.cli.export` and its sibling
`.meta.json` (and, for a program that carries the sweep, the op library
copied beside them) are all a runtime needs (the counterpart of the
repo's tools/consume_export.py for the StableHLO artifacts). Usage, as a
script, so that no package is imported:

  python matryodshka_tpu_torch/tools/consume_export.py DIR/NAME.pt2 \
      [--device cuda|cpu] [--out out.npy] [--count_kernels]

Loads the program with torch.export.load, reads the input contract from
meta.json, feeds inputs of the declared shapes drawn from
np.random.RandomState(0) (uniform [0, 1) float32, or uniform bytes for
the uint8 inputs meta.json's `input_dtypes` declares) on --device (the
meta's platform by default), prints each output's shape, dtype, range and
finiteness and, with --out, saves the first output as .npy. A float32
program runs its convs in float32 (TF32 off, as the exporting side
computes them).

It imports nothing of this repository. A program that carries custom ops
(the full pipeline's sweep, `matry::sweep_volume`) lists them in
meta.json's `custom_ops`, and `op_library` names the C++ library that
registers them (relative to the `.pt2`'s directory): the tool loads it
with torch.ops.load_library before it loads the program. A meta.json of
an older export that names a Python `op_module` instead is refused: export
the program again. With --count_kernels (a CUDA device) it traces one more
call with torch.profiler and prints the device kernels of that call by
name and count, as one JSON object. Last it prints which modules of either
package (or JAX) it imported.
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import sys
import tempfile

import numpy as np
import torch


#: Cycles of the spin kernel (torch.cuda._sleep, ~10 ms) launched at each
#: end of a traced window, outside the call it counts: the profiler may
#: drop a device event at an edge of a window, so the trace's first and
#: last device events are the spins, never a kernel of the call.
SPIN_CYCLES = 20_000_000
SPIN_KERNEL = "spin_kernel"


def count_kernels(fn):
    """Device kernels of one call of fn, {name: count}, from a
    torch.profiler trace (the chrome trace's "kernel" events) whose window
    opens and closes with a spin kernel."""
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        torch.cuda._sleep(SPIN_CYCLES)
        fn()
        torch.cuda._sleep(SPIN_CYCLES)
        torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as fh:
            events = json.load(fh)["traceEvents"]
    names = [e.get("name", "") for e in sorted(
        (e for e in events if e.get("ph") == "X"
         and e.get("cat") == "kernel"), key=lambda e: float(e["ts"]))]
    if len(names) < 2 or SPIN_KERNEL not in names[-1]:
        raise RuntimeError(f"the trace lost the window's closing spin "
                           f"kernel: {names[-3:]}")
    return dict(collections.Counter(n for n in names
                                    if SPIN_KERNEL not in n))


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("path")
    parser.add_argument("--device", default=None)
    parser.add_argument("--out", default=None)
    parser.add_argument("--count_kernels", action="store_true")
    args = parser.parse_args(argv)
    with open(args.path.rsplit(".", 1)[0] + ".meta.json") as fh:
        meta = json.load(fh)
    device = torch.device(args.device or meta["platform"])
    if args.count_kernels and device.type != "cuda":
        parser.error("--count_kernels traces a CUDA device")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    if meta.get("custom_ops"):
        if "op_library" not in meta:
            raise SystemExit(
                f"{args.path}: meta.json names the Python module "
                f"{meta.get('op_module')!r} to register {meta['custom_ops']}, "
                f"and no op_library; export the program again "
                f"(matryodshka_tpu_torch.cli.export) to get the C++ op "
                f"library beside it")
        library = os.path.join(os.path.dirname(os.path.abspath(args.path)),
                               meta["op_library"])
        torch.ops.load_library(library)
        print(f"loaded op library {meta['op_library']} for "
              f"{meta['custom_ops']}")
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
    module = program.module()
    with torch.no_grad():
        outs = module(*inputs)
    outs = outs if isinstance(outs, (tuple, list)) else (outs,)
    for i, o in enumerate(outs):
        o = o.float().cpu().numpy()
        print(f"out[{i}]: shape={o.shape} dtype={o.dtype} "
              f"range=[{o.min():.4f}, {o.max():.4f}] "
              f"finite={bool(np.isfinite(o).all())}")
    if args.out:
        np.save(args.out, outs[0].float().cpu().numpy())
    if args.count_kernels:
        with torch.no_grad():
            counts = count_kernels(lambda: module(*inputs))
        print(f"device kernels of one call: {json.dumps(counts)}")
    loaded = sorted(m for m in sys.modules
                    if m.split(".")[0] in ("matryodshka_tpu",
                                           "matryodshka_tpu_torch", "jax"))
    print(f"modules of either package or JAX imported: {loaded}")
    return outs


if __name__ == "__main__":
    main()
