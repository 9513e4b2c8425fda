"""The layer-stack render and the high-res re-render of two checkouts,
timed in turn on one card.

    python -m matryodshka_tpu_torch.tools.render_ab OTHER [--out FILE]

OTHER is the root of another checkout of this repository (for the parent
commit: `git archive` it into a directory that .gitignore lists). The
measurement runs in four fresh processes, in turn OTHER, this checkout,
this checkout, OTHER; each imports its own package (PYTHONPATH=its root,
run from its root), builds its own kernels and makes its stacks in its own
layout (interleaved [B, P, H, W, 4] where the package has the sweep's
assembled mode, planar [B, P, 4, H, W] before). Each process measures, on
seeded inputs at the flagship (640x320, 32 shells, bf16 stacks) and its
4096x2048 re-render:

- the layer-stack render, image and depth in one launch: K4 (640x320,
  back to front), K6 (640x320, front to back), K5 (4096x2048), and the
  partial mode on one block of 8 shells at 4096x2048: profiler device time
  (mean of the launches a trace of 10 calls kept, 5 at 4096x2048) and
  CUDA events (median);
- the high-res stack of each colour rule (blend_psv, blend_bg,
  alpha_only): the sweep's assembled mode where the package has it, else
  the sweep, the upsample and the assembly it stands in for; CUDA events
  (median of 3 after 1) and the peak device memory above what was held;
- the test CLI's 4096x2048 re-render of each scheme, whole and in 4 shell
  blocks: CUDA events (median of 3 after 1) and the peak above what was
  held.

Prints each process's records, then a table of the four processes side by
side, every line with the card's name and power limit; with --out, also
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
from pathlib import Path

_CHILD = "--child"
ROOT = Path(__file__).resolve().parents[2]
RULES = ("blend_psv", "blend_bg", "alpha_only")
SCHEMES = ("blend_psv", "blend_bg", "blend_bg_psv", "alpha_only")


def _measure() -> None:
    """The child: print one JSON record per measurement."""
    import torch

    import chip_smoke as cs
    from matryodshka_tpu_torch import entry
    from matryodshka_tpu_torch.cli import test as cli_test
    from matryodshka_tpu_torch.models import msi as msi_lib
    from matryodshka_tpu_torch.ops import render_layers as rl_ops
    from matryodshka_tpu_torch.ops import sweep as sweep_ops

    dev = torch.device("cuda", 0)
    interleaved = hasattr(sweep_ops, "sweep_assembled")

    def emit(**rec):
        print("REC " + json.dumps(rec), flush=True)

    gen = torch.Generator(device=dev).manual_seed(1234)

    def stack(p, h, w):
        shape = (1, p, h, w, 4) if interleaved else (1, p, 4, h, w)
        st = torch.rand(shape, generator=gen, device=dev) * 2 - 1
        alpha = st[..., 3] if interleaved else st[:, :, 3]
        alpha.copy_(torch.sigmoid(3.0 * alpha))
        return st.to(torch.bfloat16)

    cfg = entry.flagship_cfg()
    params = entry.make_params(cfg, seed=0, device=dev)
    batch = entry.synthetic_batch(cfg, 0, dev)
    p, hh, hw = cfg.num_psv_planes, cfg.hres_height, cfg.hres_width
    eye = torch.eye(4, device=dev)[None]
    small, big = stack(p, cfg.height, cfg.width), stack(p, hh, hw)
    tgt = batch["tgt_pose"]
    for name, st, radii, ftb in (
            ("K4", small, params.msi_depths, False),
            ("K6", small, params.msi_depths, True),
            ("K5", big, params.psv_depths, False)):
        fn = functools.partial(rl_ops.render_layers_both, st, eye, tgt,
                               radii, ftb=ftb)
        calls = 5 if st is big else 10
        _, total, seen = cs.device_ms([fn], [1], r"\brender_layers_kernel\b",
                                      calls=calls)
        emit(kind="render", name=name, device_ms=total / seen,
             events_ms=cs.time_ms(fn, iters=calls))
    blk = big[:, 8:16].contiguous()
    fn = functools.partial(rl_ops.render_layers_partial, blk, eye, tgt,
                           params.psv_depths[8:16].contiguous(), 8, p)
    _, total, seen = cs.device_ms([fn], [1], r"\brender_layers_kernel\b",
                                  calls=5)
    emit(kind="render", name="K5 partial (8 of 32)",
         device_ms=total / seen, events_ms=cs.time_ms(fn, iters=5))
    del small, big, blk

    ref, src = (torch.rand((1, hh, hw, 3), generator=gen, device=dev)
                for _ in range(2))
    alphas, blend = (torch.rand((1, cfg.height, cfg.width, p),
                                generator=gen, device=dev)
                     for _ in range(2))
    bg = torch.rand((1, cfg.height, cfg.width, 3), generator=gen,
                    device=dev) * 2 - 1
    depths, intr = params.psv_depths, batch["intrinsics"]

    def peak_and_ms(fn):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        mem0 = torch.cuda.memory_allocated()
        fn()
        torch.cuda.synchronize()
        peak = (torch.cuda.max_memory_allocated() - mem0) / 2**30
        return cs.time_ms(fn, iters=3, warmup=1), peak

    for rule in RULES:
        if interleaved:
            fn = functools.partial(sweep_ops.sweep_assembled, ref, src,
                                   depths, intr, alphas, blend, bg,
                                   rule=rule, out_dtype=torch.bfloat16)
        else:
            def fn(rule=rule):
                # the parent's block: one upsample of what the rule reads
                vol = sweep_ops.sweep_volume(ref, src, depths, intr,
                                             torch.bfloat16)
                low = [alphas] + ([blend] if rule != "alpha_only" else []) \
                    + ([bg] if rule == "blend_bg" else [])
                up = msi_lib.upsample_align_corners_cf(
                    torch.cat(low, -1).permute(0, 3, 1, 2), hh, hw)
                return msi_lib.assemble_hres_prepared(
                    rule, up[:, p:2 * p] if rule != "alpha_only" else None,
                    up[:, :p], vol,
                    u_bg_rgb=up[:, 2 * p:] if rule == "blend_bg" else None,
                    dtype=torch.bfloat16)
        ms, peak = peak_and_ms(fn)
        emit(kind="stack", name=rule, ms=ms, peak_gib=peak)
    for scheme in SCHEMES:
        c = entry.flagship_cfg(which_color_pred=scheme)
        args = (ref, src, None if scheme == "alpha_only" else blend, alphas,
                eye, eye, eye, intr, tgt)
        for shards in (1, 4):
            render = cli_test.build_hres_render_fn(c, shards)
            ms, peak = peak_and_ms(lambda: render(*args, bg_rgb=bg))
            emit(kind="rerender", name=f"{scheme} x{shards}", ms=ms,
                 peak_gib=peak)


def _run(root: Path, tag: str, log):
    # this file runs as a script in the other checkout's root, importing
    # that checkout's package and chip_smoke.py
    env = dict(os.environ, PYTHONPATH=str(root))
    proc = subprocess.run([sys.executable, str(Path(__file__).resolve()),
                           _CHILD], cwd=root, env=env, capture_output=True,
                          text=True, check=False)
    recs = [json.loads(line[4:]) for line in proc.stdout.splitlines()
            if line.startswith("REC ")]
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
        print("render_ab: no CUDA device", file=sys.stderr)
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
    print(f"render_ab: other = {args.other.resolve()}, this = {ROOT} "
          f"[{card}]")
    for r0 in runs[0]:
        recs = [next(r for r in run if r["kind"] == r0["kind"]
                     and r["name"] == r0["name"]) for run in runs]
        keys = [k for k in r0 if k not in ("kind", "name")]
        for k in keys:
            vals = [r[k] for r in recs]
            this = statistics.mean(vals[1:3])
            other = statistics.mean([vals[0], vals[3]])
            print(f"{r0['kind']:8s} {r0['name']:22s} {k:9s} " + " ".join(
                f"{h} {v:9.4f}" for h, v in zip(heads, vals))
                + f"; this/other {this / other:6.3f} [{card}]")
    return 0


if __name__ == "__main__":
    if sys.argv[1:] == [_CHILD]:
        sys.path.insert(0, os.getcwd())
        _measure()
        sys.exit(0)
    sys.exit(main())
