"""The conv kernel of two checkouts timed in turn on one card.

    python -m matryodshka_tpu_torch.tools.conv_ab OTHER [--out FILE]
        [--net_only] [--rounds N]

OTHER is the root of another checkout of this repository (for the parent
commit: `git archive` it into a directory that .gitignore lists). The
measurement runs in four fresh processes, in turn OTHER, this checkout,
this checkout, OTHER (N times over with --rounds N); each imports its own
package (PYTHONPATH=its root, run from its root) and builds its own
kernels. Each process measures, on
seeded bf16 inputs at the flagship (640x320, ngf 64, batch 1):

- every stage of the wrap and the coord net as that checkout's
  ops/net.py runs it (in the layouts it gives the activations), on the
  activations of one forward of a seeded net input: a conv launch whose
  input's layer norm + ReLU is fused and whose
  epilogue writes its statistics (a checkout whose ops/conv.py has Norm),
  or a conv launch and, but for the head, a layer-norm launch (the
  parent's ops/layernorm.layer_norm_relu); per stage its CUDA events
  (around the stage's calls, median of 10 after 2 warm-up) and its
  kernels' device time (one torch.profiler trace of 10 rounds of the 18
  stages, chip_smoke.device_ms), beside cuDNN bf16 on the same input
  (F.conv2d on the zero-padded input with the coord channel appended,
  F.conv_transpose2d for the deconvs) and F.layer_norm + relu_ on its
  output; the 18 stages' sums and TFLOP/s;
- the net stage (models/msi.net_stage, CUDA events and one trace's device
  time) and the frame (entry.forward, median of 10) of each net;
- the host's time, with the device kept busy by a spin kernel queued
  ahead (`_host_us`, medians of HOST_ROUNDS): each conv() call of the 18
  stages and, in the parent, each layer-norm call; the net stage's and
  the frame's submission; and the frame's wall (perf_counter around
  entry.forward and a synchronize, median, 10th and 90th percentile);
- unless --net_only: the weight gradient of the trainer's eight wrap-conv
  layers (ops/wrap_conv.conv3x3_wrap_wgrad, bf16, batch 1; CUDA events
  around one call, median of 10) and cuDNN bf16 on the same work
  (torch.nn.grad.conv2d_weight on the wrap-padded input), TFLOP/s, the
  step's sum; the default trainer's step in parts (sweep, net forward,
  assemble + render + loss, backward, optimizer; median of 6 after 2);
  the backward's device time: one torch.profiler trace of each of 5
  steps' backward (after 2) between two spin kernels, the rest of the
  step outside the window; medians of the device busy ms (the union of
  the operations' intervals), the span between the spins, the idle share
  1 - busy / span, the device operations, and the weight-gradient
  kernels' ms and launches (names holding "wgrad").

Prints each process's lines, then a table of the processes side by
side (the host lines also each checkout's median over its processes),
every line with the card's name and power limit; with --out, also
writes every process's records as JSON lines to FILE.
"""

from __future__ import annotations

import argparse
import functools
import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

_CHILD = "--child"
ROOT = Path(__file__).resolve().parents[2]


#: The net's kernels in a trace: the conv kernel and the parent's layer
#: norm's forms.
_KERNELS = r"\b(conv_wgmma_kernel|ln_onchip|ln_stats|ln_apply)\b"


def _stages(prm, x0):
    """[(plan row, stage operands, conv input, stage output, the stage's
    calls, their kernel launches, [(kind, call)] the same calls one by
    one: "conv" and, in the parent, "ln")] of one net's 18 stages as this
    checkout's ops/net.py runs them on x0 (the stage output: the conv's,
    before any layer norm)."""
    import torch

    from matryodshka_tpu_torch.ops import conv as conv_ops
    out = []
    if hasattr(conv_ops, "Norm"):
        # the layer norm fused: one conv launch a stage
        from matryodshka_tpu_torch.ops import net as net_ops
        acts = {"x": (x0, None)}
        for plan, st in zip(prm.net.plan, prm.stages):
            x, norm = net_ops.stage_input(st, acts)
            # the output's layout, where the checkout's net picks one
            fmt = ({"memory_format": st["memory_format"]}
                   if "memory_format" in st else {})
            fn = functools.partial(conv_ops.conv, x, st["w"], st["b"],
                                   **st["args"], norm=norm,
                                   stats=st["stats"], **fmt)
            y = fn()
            acts[st["name"]] = y if st["stats"] else (y, None)
            out.append((plan, st, x, acts[st["name"]][0], fn, 1,
                        [("conv", fn)]))
        return out
    # a conv launch and a layer-norm launch (one or two kernels) a stage
    from matryodshka_tpu_torch.ops import layernorm as ln_ops
    acts = {"x": x0}
    for plan, st in zip(prm.net.plan, prm.stages):
        srcs = [acts[s] for s in st["srcs"]]
        x = srcs[0] if len(srcs) == 1 else torch.cat(srcs, dim=1)
        conv = functools.partial(conv_ops.conv, x, st["w"], st["b"],
                                 **st["args"])
        y = conv()
        if "gamma" not in st:
            acts[st["name"]] = y
            out.append((plan, st, x, y, conv, 1, [("conv", conv)]))
            continue
        ln = functools.partial(ln_ops.layer_norm_relu, y, st["gamma"],
                               st["beta"])
        acts[st["name"]] = ln()
        nln = 1 if ln_ops.plan_for(y)[0] == "onchip" else 2
        out.append((plan, st, x, y, lambda conv=conv, ln=ln: (conv(), ln()),
                    1 + nln, [("conv", conv), ("ln", ln)]))
    return out


#: Rounds of each host-time measurement (after 2 warm-up rounds).
HOST_ROUNDS = 40


def _host_us(fns):
    """Host microseconds of each of fns per call, the median of
    HOST_ROUNDS rounds: each round queues a spin kernel (~10 ms at the
    card's clock) and then calls fns in turn, each between two
    perf_counter reads, so the device stays busy and only the host path
    (Python, the wrapper's checks, the launch) is timed."""
    import torch

    import chip_smoke as cs
    per = [[] for _ in fns]
    for i in range(2 + HOST_ROUNDS):
        torch.cuda.synchronize()
        torch.cuda._sleep(cs.SPIN_CYCLES)
        for j, fn in enumerate(fns):
            t0 = time.perf_counter()
            fn()
            t1 = time.perf_counter()
            if i >= 2:
                per[j].append((t1 - t0) * 1e6)
    torch.cuda.synchronize()
    return [statistics.median(p) for p in per]


def _measure(net_only: bool) -> None:
    """The child: print one JSON record per measurement."""
    import torch
    import torch.nn.functional as F

    import chip_smoke as cs
    from matryodshka_tpu_torch import entry
    from matryodshka_tpu_torch.models import msi as msi_lib
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
        x0 = (torch.rand((1, cfg.num_net_inputs(), cfg.height, cfg.width),
                         generator=gen, device=dev) * 2 - 1).to(
                             torch.bfloat16)
        stages = _stages(prm, x0)
        per_dev, _, _ = cs.device_ms([s[4] for s in stages],
                                     [s[5] for s in stages], _KERNELS)
        for i, (plan, st, x, y, fn, *_) in enumerate(stages):
            name, kind, _, cins, cout, ind, _, _ = plan
            args = st["args"]
            kt = cs.time_ms(fn)
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
            lnt = 0.0
            if kind != "head":
                chw = y.shape[1:]
                ge = torch.ones(chw, dtype=y.dtype, device=dev)
                lnt = cs.time_ms(lambda: torch.relu_(F.layer_norm(
                    y, chw, ge, ge, eps=1e-12)))
            taps_cin = st["w"].shape[0] * st["w"].shape[1]
            flop = 2.0 * taps_cin * cout * y.shape[2] * y.shape[3] \
                / st["w"].shape[0]
            emit(kind="layer", net=key, name=name, ms=kt,
                 device_ms=per_dev[i] if per_dev else None, cudnn_ms=lt,
                 layer_norm_ms=lnt, gflop=flop / 1e9)
        net_fn = functools.partial(msi_lib.net_stage, prm.stages, x0)
        _, net_dev, net_launches = cs.device_ms(
            [net_fn], [sum(s[5] for s in stages)], _KERNELS)
        emit(kind="net", net=key, ms=cs.time_ms(net_fn), device_ms=net_dev,
             launches=net_launches)
        batch = entry.synthetic_batch(cfg, 0, dev)
        frame_fn = functools.partial(entry.forward, prm, batch)
        emit(kind="frame", net=key, ms=cs.time_ms(frame_fn))
        calls = [c for s in stages for c in s[6]]
        us = _host_us([fn for _, fn in calls])
        net_us = _host_us([net_fn, frame_fn])
        walls = []
        for i in range(2 + HOST_ROUNDS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            frame_fn()
            torch.cuda.synchronize()
            if i >= 2:
                walls.append((time.perf_counter() - t0) * 1e3)
        q = statistics.quantiles(walls, n=10)
        emit(kind="host", net=key,
             conv_us=[u for (k, _), u in zip(calls, us) if k == "conv"],
             ln_us=[u for (k, _), u in zip(calls, us) if k == "ln"],
             net_submit_ms=net_us[0] / 1e3, frame_submit_ms=net_us[1] / 1e3,
             frame_wall_ms=statistics.median(walls), frame_wall_p10=q[0],
             frame_wall_p90=q[-1])
    if net_only:
        return

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


def _run(root: Path, tag: str, log, net_only: bool):
    # this file runs as a script in the other checkout's root, importing
    # that checkout's package and chip_smoke.py
    env = dict(os.environ, PYTHONPATH=str(root))
    proc = subprocess.run([sys.executable, str(Path(__file__).resolve()),
                           _CHILD, *(["--net_only"] if net_only else [])],
                          cwd=root, env=env, capture_output=True,
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


def _print_host(net, runs, heads, card) -> None:
    """The host-time lines of one net: per process, then each checkout's
    median over its processes."""
    hs = [next(r for r in run if r["kind"] == "host" and r["net"] == net)
          for run in runs]
    rows = {
        "conv() calls, sum ms": [sum(h["conv_us"]) / 1e3 for h in hs],
        "conv() per call us": [statistics.mean(h["conv_us"]) for h in hs],
        "LN calls, sum ms": [sum(h["ln_us"]) / 1e3 for h in hs],
        "net stage submit ms": [h["net_submit_ms"] for h in hs],
        "frame submit ms": [h["frame_submit_ms"] for h in hs],
        "frame wall ms": [h["frame_wall_ms"] for h in hs],
        "frame wall p10 ms": [h["frame_wall_p10"] for h in hs],
        "frame wall p90 ms": [h["frame_wall_p90"] for h in hs]}
    for k, v in rows.items():
        by = {t: statistics.median(x for h, x in zip(heads, v)
                                   if h.startswith(t))
              for t in ("other", "this")}
        print(f"host {net:5s} {k:20s} " + " ".join(
            f"{h} {x:8.4f}" for h, x in zip(heads, v))
            + f"; median other {by['other']:8.4f} this {by['this']:8.4f} "
            f"(device busy behind a spin; wall: forward + synchronize; "
            f"medians of {HOST_ROUNDS}) [{card}]")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("other", type=Path)
    ap.add_argument("--out", type=Path)
    ap.add_argument("--net_only", action="store_true",
                    help="the nets' stages, net stage and frame only")
    ap.add_argument("--rounds", type=int, default=1,
                    help="repeat the order other, this, this, other")
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
             ("this", ROOT), ("other", args.other.resolve())] * args.rounds
    log = open(args.out, "w") if args.out else None
    runs = []
    try:
        for i, (tag, root) in enumerate(order):
            runs.append(_run(root, f"{tag}{i}", log, args.net_only))
    finally:
        if log:
            log.close()
    heads = [f"{t}{i}" for i, (t, _) in enumerate(order)]
    print(f"conv_ab: other = {args.other.resolve()}, this = {ROOT} [{card}]")
    layers = [r for r in runs[0] if r["kind"] == "layer"]

    def dev_txt(v):
        return "  none " if v is None else f"{v:7.4f}"
    for net in ("wrap", "coord"):
        tot = [0.0] * len(runs)
        dtot = [0.0] * len(runs)
        lib = [0.0] * len(runs)
        lnl = [0.0] * len(runs)
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
                dtot[i] = (None if dtot[i] is None or r["device_ms"] is None
                           else dtot[i] + r["device_ms"])
                lib[i] += r["cudnn_ms"]
                lnl[i] += r["layer_norm_ms"]
            print(f"{net:5s} {r0['name']:10s} events " + " ".join(
                f"{h} {r['ms']:7.4f}" for h, r in zip(heads, ms))
                + " ms; device " + " ".join(
                    f"{h} {dev_txt(r['device_ms'])}"
                    for h, r in zip(heads, ms))
                + f" ms; cuDNN bf16 "
                f"{statistics.median(r['cudnn_ms'] for r in ms):7.4f} ms; "
                f"F.layer_norm + relu_ of its output "
                f"{statistics.median(r['layer_norm_ms'] for r in ms):7.4f}"
                f" ms [{card}]")
        print(f"{net:5s} 18 stages {gflop:.1f} GFLOP events " + " ".join(
            f"{h} {t:7.3f} ms ({gflop / t:6.1f} TFLOP/s)"
            for h, t in zip(heads, tot)) + "; device " + " ".join(
                f"{h} " + ("none" if t is None else f"{t:7.4f} ms")
                for h, t in zip(heads, dtot))
            + f"; cuDNN bf16 {statistics.median(lib):7.3f} ms; "
            f"F.layer_norm + relu_ of 17 outputs {statistics.median(lnl):7.3f}"
            f" ms [{card}]")
    for net in ("wrap", "coord"):
        rs = [next(r for r in run if r["kind"] == "net" and r["net"] == net)
              for run in runs]
        print(f"net stage {net:5s} events " + " ".join(
            f"{h} {r['ms']:7.3f}" for h, r in zip(heads, rs))
            + " ms; device " + " ".join(
                f"{h} {r['device_ms']:7.4f}" for h, r in zip(heads, rs))
            + " ms; launches " + " ".join(
                f"{h} {r['launches']:g}" for h, r in zip(heads, rs))
            + f" [{card}]")
        ms = [next(r["ms"] for r in run if r["kind"] == "frame"
                   and r["net"] == net) for run in runs]
        print(f"frame {net:5s} " + " ".join(
            f"{h} {t:7.3f}" for h, t in zip(heads, ms)) + f" ms [{card}]")
        _print_host(net, runs, heads, card)
    if args.net_only:
        return 0
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
    if sys.argv[1:2] == [_CHILD]:
        sys.path.insert(0, os.getcwd())
        _measure("--net_only" in sys.argv[2:])
        sys.exit(0)
    sys.exit(main())
