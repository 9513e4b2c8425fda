"""The conv kernel of two checkouts timed in turn on one card.

    python -m matryodshka_tpu_torch.tools.conv_ab OTHER [--out FILE]

OTHER is the root of another checkout of this repository (for the parent
commit: `git archive` it into a directory that .gitignore lists). The
measurement runs in four fresh processes, in turn OTHER, this checkout,
this checkout, OTHER; each imports its own package (PYTHONPATH=its root,
run from its root) and builds its own kernels. Each process measures, on
seeded bf16 inputs at the flagship (640x320, ngf 64, batch 1):

- every conv stage of the wrap and the coord net: the kernel (CUDA events
  around one call, median of 10 after 2 warm-up) and cuDNN bf16 on the
  same operands (F.conv2d on the zero-padded input with the coord channel
  appended, F.conv_transpose2d for the deconvs), TFLOP/s, the net's total;
- the frame (entry.forward, median of 10) of each net;
- the weight gradient of the trainer's eight wrap-conv layers
  (ops/wrap_conv.conv3x3_wrap_wgrad, bf16, batch 1; CUDA events around one
  call, median of 10) and cuDNN bf16 on the same work
  (torch.nn.grad.conv2d_weight on the wrap-padded input), TFLOP/s, the
  step's sum;
- the default trainer's step in parts (sweep, net forward, assemble +
  render + loss, backward, optimizer; median of 6 after 2);
- the backward's device time: one torch.profiler trace of each of 5
  steps' backward (after 2) between two spin kernels, the rest of the
  step outside the window; medians of the device busy ms (the union of
  the operations' intervals), the span between the spins, the idle share
  1 - busy / span, the device operations, and the weight-gradient
  kernels' ms and launches (names holding "wgrad").

Prints each process's lines, then a table of the four processes side by
side, every line with the card's name and power limit; with --out, also
writes every process's records as JSON lines to FILE.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
from pathlib import Path

_CHILD = "--child"
ROOT = Path(__file__).resolve().parents[2]


def _measure() -> None:
    """The child: print one JSON record per measurement."""
    import torch
    import torch.nn.functional as F

    import chip_smoke as cs
    from matryodshka_tpu_torch import entry
    from matryodshka_tpu_torch.ops import conv as conv_ops
    from matryodshka_tpu_torch.training import state as state_lib
    from matryodshka_tpu_torch.training import step as step_lib

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)

    def emit(**rec):
        print("REC " + json.dumps(rec), flush=True)

    gen = torch.Generator(device=dev).manual_seed(1234)
    for key, coord in (("wrap", False), ("coord", True)):
        cfg = entry.flagship_cfg(coord_net=coord)
        prm = entry.make_params(cfg, seed=0, device=dev)
        for plan, st in zip(prm.net.plan, prm.stages):
            name, kind, _, cins, cout, ind, _, _ = plan
            args = st["args"]
            x = (torch.rand((1, sum(cins), cfg.height // ind,
                             cfg.width // ind), generator=gen, device=dev)
                 * 2 - 1).to(torch.bfloat16)
            y = conv_ops.conv(x, st["w"], st["b"], **args)
            kt = cs.time_ms(lambda: conv_ops.conv(x, st["w"], st["b"],
                                                  **args))
            layer = getattr(prm.net, name)
            wb = layer.weight.detach().to(torch.bfloat16)
            bb = st["b"].to(torch.bfloat16)
            if kind == "deconv":
                wt = wb.flip(2, 3).transpose(0, 1).contiguous()
                lt = cs.time_ms(lambda: F.conv_transpose2d(
                    x, wt, bb, stride=2, padding=1))
            else:
                xl = (conv_ops.with_coord(x, args["coord"])
                      if "coord" in args else x)
                lo = conv_ops.pad_pair(args.get("pad", 0))
                xl = F.pad(xl, (lo[0], lo[1], lo[0], lo[1]))
                lt = cs.time_ms(lambda: F.conv2d(
                    xl, wb, bb, stride=args.get("stride", 1),
                    dilation=args.get("dil", 1)))
            taps_cin = st["w"].shape[0] * st["w"].shape[1]
            flop = 2.0 * taps_cin * cout * y.shape[2] * y.shape[3] \
                / st["w"].shape[0]
            emit(kind="layer", net=key, name=name, ms=kt, cudnn_ms=lt,
                 gflop=flop / 1e9)
        batch = entry.synthetic_batch(cfg, 0, dev)
        emit(kind="frame", net=key,
             ms=cs.time_ms(lambda: entry.forward(prm, batch)))

    from matryodshka_tpu_torch.ops import wrap_conv as wc
    for name, cin, cout, ind in cs.wrap_conv_layers(64, 192):
        h, w = 320 // ind, 640 // ind
        x = torch.relu(torch.rand((1, cin, h, w), generator=gen,
                                  device=dev) * 2 - 1).to(torch.bfloat16)
        g = torch.randn((1, cout, h, w), generator=gen,
                        device=dev).to(torch.bfloat16)
        xp = conv_ops.wrap_pad(x, 1, 1, 1, 1)
        kt = cs.time_ms(lambda: wc.conv3x3_wrap_wgrad(g, x))
        lt = cs.time_ms(lambda: torch.nn.grad.conv2d_weight(
            xp, (cout, cin, 3, 3), g))
        emit(kind="wgrad", name=name, ms=kt, cudnn_ms=lt,
             gflop=2.0 * 9 * cin * cout * h * w / 1e9)

    tcfg = entry.flagship_cfg()
    tstate = state_lib.init_state(tcfg, 0, dev)
    tbatch = {k: torch.from_numpy(v).to(dev)
              for k, v in cs.training_batch(tcfg).items()}
    loss_fn = step_lib.make_loss_fn(tcfg, tstate.net)
    parts = {"sweep": [], "net_forward": [], "assemble_render_loss": [],
             "backward": [], "optimizer": []}
    warm, steps = 2, 6
    for i in range(warm + steps):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(6)]
        ev[0].record()
        vol = loss_fn.sweep(tbatch)
        ev[1].record()
        pred = tstate.net(vol)
        ev[2].record()
        loss, _ = loss_fn.tail(tbatch, vol, pred)
        ev[3].record()
        tstate.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        ev[4].record()
        tstate.optimizer.step()
        ev[5].record()
        torch.cuda.synchronize()
        if i >= warm:
            for j, k in enumerate(parts):
                parts[k].append(ev[j].elapsed_time(ev[j + 1]))
    emit(kind="train", **{k: statistics.median(v) for k, v in parts.items()})

    from matryodshka_tpu_torch import trace as trace_lib
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    bw = {"busy": [], "span": [], "idle": [], "ops": [], "wgrad_ms": [],
          "wgrad_launches": []}
    for i in range(warm + 5):
        vol = loss_fn.sweep(tbatch)
        loss, _ = loss_fn.tail(tbatch, vol, tstate.net(vol))
        tstate.optimizer.zero_grad(set_to_none=True)
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=acts) as prof:
            torch.cuda._sleep(cs.SPIN_CYCLES)
            loss.backward()
            torch.cuda._sleep(cs.SPIN_CYCLES)
            torch.cuda.synchronize()
        tstate.optimizer.step()
        events = trace_lib.device_events(prof)
        spins = sorted((e for e in events if cs.SPIN_KERNEL in e[0]),
                       key=lambda e: e[1])
        if i < warm or len(spins) != 2:
            continue
        ops = [e for e in events if cs.SPIN_KERNEL not in e[0]]
        wg = [e for e in ops if "wgrad" in e[0]]
        busy = trace_lib.busy_us(ops) / 1e3
        span = (spins[1][1] - spins[0][1] - spins[0][2]) / 1e3
        for k, v in (("busy", busy), ("span", span),
                     ("idle", 1.0 - busy / span), ("ops", len(ops)),
                     ("wgrad_ms", sum(e[2] for e in wg) / 1e3),
                     ("wgrad_launches", len(wg))):
            bw[k].append(v)
    emit(kind="backward_trace", traces=len(bw["busy"]),
         **{k: statistics.median(v) if v else None for k, v in bw.items()})


def _run(root: Path, tag: str, log):
    # this file runs as a script in the other checkout's root, importing
    # that checkout's package and chip_smoke.py
    env = dict(os.environ, PYTHONPATH=str(root))
    proc = subprocess.run([sys.executable, str(Path(__file__).resolve()),
                           _CHILD], cwd=root, env=env, capture_output=True,
                          text=True, check=False)
    recs = []
    for line in proc.stdout.splitlines():
        if line.startswith("REC "):
            recs.append(json.loads(line[4:]))
    if proc.returncode != 0 or not recs:
        raise RuntimeError(f"{tag} ({root}) failed:\n{proc.stdout[-3000:]}"
                           f"\n{proc.stderr[-3000:]}")
    if log:
        for r in recs:
            log.write(json.dumps(dict(r, run=tag)) + "\n")
    return recs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("other", type=Path)
    ap.add_argument("--out", type=Path)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("conv_ab: no CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    order = [("other", args.other.resolve()), ("this", ROOT),
             ("this", ROOT), ("other", args.other.resolve())]
    log = open(args.out, "w") if args.out else None
    runs = []
    try:
        for i, (tag, root) in enumerate(order):
            runs.append(_run(root, f"{tag}{i}", log))
    finally:
        if log:
            log.close()
    heads = [f"{t}{i}" for i, (t, _) in enumerate(order)]
    print(f"conv_ab: other = {args.other.resolve()}, this = {ROOT} [{card}]")
    layers = [r for r in runs[0] if r["kind"] == "layer"]
    for net in ("wrap", "coord"):
        tot = [0.0] * len(runs)
        lib = [0.0] * len(runs)
        gflop = 0.0
        for r0 in layers:
            if r0["net"] != net:
                continue
            ms = [next(r for r in run if r["kind"] == "layer"
                       and r["net"] == net and r["name"] == r0["name"])
                  for run in runs]
            gflop += r0["gflop"]
            for i, r in enumerate(ms):
                tot[i] += r["ms"]
                lib[i] += r["cudnn_ms"]
            print(f"{net:5s} {r0['name']:10s} " + " ".join(
                f"{h} {r['ms']:7.4f}" for h, r in zip(heads, ms))
                + f" ms; cuDNN bf16 {statistics.median(r['cudnn_ms'] for r in ms):7.4f}"
                f" ms [{card}]")
        print(f"{net:5s} total {gflop:.1f} GFLOP " + " ".join(
            f"{h} {t:7.3f} ms ({gflop / t:6.1f} TFLOP/s)"
            for h, t in zip(heads, tot))
            + f"; cuDNN bf16 {statistics.median(lib):7.3f} ms [{card}]")
    for net in ("wrap", "coord"):
        ms = [next(r["ms"] for r in run if r["kind"] == "frame"
                   and r["net"] == net) for run in runs]
        print(f"frame {net:5s} " + " ".join(
            f"{h} {t:7.3f}" for h, t in zip(heads, ms)) + f" ms [{card}]")
    tot = [0.0] * len(runs)
    lib, gflop = [], 0.0
    for r0 in (r for r in runs[0] if r["kind"] == "wgrad"):
        ms = [next(r for r in run if r["kind"] == "wgrad"
                   and r["name"] == r0["name"]) for run in runs]
        gflop += r0["gflop"]
        for i, r in enumerate(ms):
            tot[i] += r["ms"]
        lib.append(statistics.median(r["cudnn_ms"] for r in ms))
        print(f"wgrad {r0['name']:10s} " + " ".join(
            f"{h} {r['ms']:7.4f}" for h, r in zip(heads, ms))
            + " ms (TFLOP/s " + " ".join(
                f"{r0['gflop'] / r['ms']:6.1f}" for r in ms)
            + f"); cuDNN bf16 {lib[-1]:7.4f} ms [{card}]")
    print(f"wgrad step {gflop:.1f} GFLOP " + " ".join(
        f"{h} {t:7.3f} ms ({gflop / t:6.1f} TFLOP/s)"
        for h, t in zip(heads, tot))
        + f"; cuDNN bf16 {sum(lib):7.3f} ms [{card}]")
    tr = [next(r for r in run if r["kind"] == "train") for run in runs]
    for k in ("sweep", "net_forward", "assemble_render_loss", "backward",
              "optimizer"):
        print(f"train {k:20s} " + " ".join(
            f"{h} {r[k]:8.3f}" for h, r in zip(heads, tr)) + f" ms [{card}]")
    bt = [next(r for r in run if r["kind"] == "backward_trace")
          for run in runs]
    for k, unit in (("busy", "ms"), ("span", "ms"), ("idle", ""),
                    ("ops", ""), ("wgrad_ms", "ms"), ("wgrad_launches", ""),
                    ("traces", "")):
        print(f"backward {k:14s} " + " ".join(
            f"{h} " + ("none" if r[k] is None else f"{r[k]:8.3f}")
            for h, r in zip(heads, bt)) + f" {unit} (device trace, median) "
            f"[{card}]")
    return 0


if __name__ == "__main__":
    if sys.argv[1:] == [_CHILD]:
        sys.path.insert(0, os.getcwd())
        _measure()
        sys.exit(0)
    sys.exit(main())
