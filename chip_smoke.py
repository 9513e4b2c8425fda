"""Drive the PyTorch port's inference and training paths and its probe tool
once on an NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from matryodshka_tpu_torch/csrc, reports
the conv kernel's instantiations (ptxas registers, stack and spills; the
HMMA/HGMMA count of each one's SASS, which must be above 0 for the bf16
tensor-core instantiations), and checks each kernel against its plain
PyTorch version at the shapes its path gives it, all at the full width
of the flagship configuration (640x320 ODS input, 32 planes per eye, 32
shells, ngf 64, bf16) with seeded random weights. The sweep and the two
renders (blend-fused and layer-stack), which make their own lookups, are
checked in two halves, also at 4096x2048 (the sweep and the layer-stack
render): their projection, through its instrument entry, against the
plain projection in float64 (the worst errors and the bound printed),
and the kernel against its plain version fed the instrument's tables,
the layer-stack render in each output mode (image, depth, both in one
launch), back to front and front to back, bf16 and f32 stacks.
Then it drives eight paths, each with every launch count set to 0 just
before it and read just after (on the first, exactly one sweep and one
render launch per frame, and one device operation per stage in a
profiler trace):

1. entry.forward (blend_psv: sweep, U-Net, blend-fused render) on three
   requests;
2. the test CLI's build_infer_fn (matryodshka_tpu_torch/cli/test.py) once
   per colour scheme, each at its own target position: image and depth
   through the blend-fused render's colour and depth modes (blend_psv) or
   the prepared assembly and one layer-stack launch for both (the other
   three); then once front to back (the ftb=True prepared render); no
   lookup table (uv_tables) is built;
3. the test CLI's 4096x2048 high-res re-render from the blend_psv
   request's blend weights and alphas (one layer-stack launch, no
   tables);
4. the coord net (coord_net=True, the released checkpoints' architecture:
   the conv kernel in its zero-padding and coord-channel mode) through
   entry.forward on two requests and the test CLI once (blend_psv, image
   and depth);
5. the trainer (training/loop.train with the default ODS train step: K1
   sweep, the wrap net with its stride-1 convs through K7 forward, dgrad
   and wgrad, the gather render, Adam) for 8 steps on one in-memory batch,
   after K7's gates at its eight layer shapes; then the step in parts, and
   one step's loss and gradients against the all-plain f32 route;
6. the lowering probes (`python -m matryodshka_tpu_torch.tools.probes`:
   K8's atan2/sqrt, bf16 roll and run-time-shift roll, K9's left shift
   through shared memory, on the JAX tools' inputs), then each probe kernel
   against its plain version on those inputs and its time per launch, by
   CUDA events and by profiler device time, beside torch.roll's;
7. the E-LPIPS trainer: the released recipe (which_loss=elpips, the coord
   net, random E-LPIPS features) for 8 steps and the wrap net's recipe
   for 3 (K1; K7 and wgrad on the wrap net), every metrics record stamped
   elpips_calibrated: false; the E-LPIPS part of a step at each scale
   level; the card's E-LPIPS distance and input gradient against the
   CPU's at fixed draws; one step's gradients against the all-plain f32
   route;
8. the evaluator: the coord net's test CLI writes two examples and two
   video frames (K1, K2c, K3), then cli/evaluate.main with E-LPIPS in reg
   and video mode on the card and on the CPU, the two JSONs held to each
   other, and its time per example.

Every output is gated against its all-plain float32 twin. Stages, kernels
and plain versions are timed with CUDA events (the conv layers with their
TFLOP/s and the tile each took; the sweep, the renders, the layer norm
and the probes also by profiler device time), and beside each kernel the
least time the card could take for its work (bound_ms: the larger of its
bytes over the memory rate and its operations over the peak rate for
their type, computed from this run's inputs) and, where one PyTorch call
computes the same function, that call's time (library_ms).

Needs one CUDA device; without one it exits non-zero and prints no result.
Every check that fails raises, so the script exits non-zero before its last
line. Output: one line per check and timing (each timing line carries the
card's name and power limit), then a JSON line of kernels, then the
`nvidia-smi` name/power-limit line, then the result line
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import dataclasses
import functools
import itertools
import json
import math
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

#: Bound on |kernel path (bf16) - all-plain path (f32)| over a rendered
#: frame in [-1, 1]. bf16 stores the sweep volume (relative rounding 2^-9)
#: and every activation of the 18 net layers; the JAX package's bf16 hot
#: path differs from its own f32 reference by 9.46e-3 at this shape, and
#: the gate allows about twice that.
E2E_TOL = 2e-2
REQUESTS = [(0, (0.05, 0.0, 0.0)), (1, (-0.03, 0.02, 0.04)),
            (2, (0.0, -0.05, -0.02))]
#: (scheme, image seed, target position) of the test CLI's requests.
CLI_REQUESTS = [("blend_psv", 3, (0.04, 0.01, -0.02)),
                ("blend_bg", 4, (-0.02, 0.03, 0.01)),
                ("blend_bg_psv", 5, (0.01, -0.04, 0.03)),
                ("alpha_only", 6, (-0.05, 0.0, -0.01))]
HRES = (2048, 4096)

#: H100 SXM peaks (NVIDIA's data sheet, dense, at a 700 W power limit):
#: device memory bytes/s, bf16 tensor-core FLOP/s, f32 FLOP/s outside the
#: tensor cores.
HBM_BPS = 3.35e12
BF16_FLOPS = 989e12
F32_FLOPS = 67e12
#: f32 operations per sample of the render kernels (estimates from their
#: inner loops), besides the projection (OPS_SHELL_UV): a blend-fused
#: colour sample (4 taps x (6 volume values blended + 2 prediction
#: values) with bilinear weights, and the composite); a layer-stack colour
#: sample (4 taps x 4 channels); a depth sample (4 taps x 1 alpha); a
#: layer-stack sample of image and depth together (the colour sample and
#: the depth composite's few operations: the alpha taps are shared).
OPS_RENDER_BLEND = 80
OPS_RENDER_LAYERS = 40
OPS_RENDER_DEPTH = 16
OPS_RENDER_BOTH = OPS_RENDER_LAYERS + 4
#: f32 operations per output element: the sweep (two vertical and one
#: horizontal lerp, 3 ops each) and the layer norm (sum and sum of
#: squares, then normalize, scale, shift, ReLU).
OPS_SWEEP = 9
OPS_LAYERNORM = 7
#: f32 operations of the lookups the sweep and render kernels project
#: (estimates): one row's parameters, 16 probes of the ODS projection
#: (~40 single-rounded operations, five divisions, two sqrtf, two atan2f,
#: four sin/cos: ~160 each); one (pixel, shell) uv (~60 operations, two
#: atan2f, two sqrtf).
OPS_ROW_PARAM = 16 * 160
OPS_SHELL_UV = 60 + 2 * 30 + 2 * 10
#: f32 operations per element of the trig probe (an estimate of CUDA's
#: precise atan2f: range reduction, a division and a polynomial of about
#: ten terms; sqrtf and the fma). Bytes bound it by far.
OPS_TRIG = 30
#: The training phase: steps through training/loop.train on one repeated
#: batch, the first TRAIN_WARMUP untimed.
TRAIN_WARMUP = 2
TRAIN_STEPS = 6
#: One step from the same parameters, the kernel route (bf16 storage of the
#: sweep and of every activation, K7) against the all-plain f32 route:
#: the loss within TRAIN_LOSS_TOL relative, each parameter's gradient
#: within relative L2 max(TRAIN_GRAD_TOL, TRAIN_GRAD_MARGIN x the all-plain
#: bf16 route's). bf16 rounds each stored activation and each gradient by
#: up to 2^-9 relative, and over 18 layers forward and back a gradient's
#: relative error grows to several 1e-2 with no kernel of the port in the
#: way: the plain bf16 route (PyTorch convs, no K1, no K7) sits 4-19% from
#: f32 on some parameters at 128x64 (CPU rehearsal). So the gate asks the
#: kernel route to be no farther from f32 than bf16 itself puts it, with
#: margin; a wrong tap, adjoint or split gives O(1).
TRAIN_LOSS_TOL = 1e-2
TRAIN_GRAD_TOL = 5e-2
TRAIN_GRAD_MARGIN = 1.5
#: The weight-gradient kernel against its plain version, relative L2 (see
#: wrap_conv_kernels).
WGRAD_TOL = 1e-3
#: K7c's sums against its plain version's: |ds1| <= STATS_TOL * sum|y| and
#: |ds2| <= STATS_TOL * s2 (see wrap_conv_kernels).
STATS_TOL = 1e-5


#: The K7 kernels' launch counters in ops/wrap_conv.py.
K7_COUNTS = {"wrap_conv_k7a": "k7a_launches", "wrap_conv_k7b": "k7b_launches",
             "wrap_conv_k7c": "k7c_launches",
             "wrap_conv_wgrad": "wgrad_launches"}
#: Path 7 (E-LPIPS), at fixed draws: the card's distance within
#: ELPIPS_TOL relative and its input gradient within relative L2
#: ELPIPS_GRAD_TOL of the CPU's. Both run float32 convs (TF32 off inside
#: the metric) through ~20 layers in other summation orders: ~1e-6
#: relative; a wrong tap, pool or mask gives O(1).
ELPIPS_TOL = 1e-4
ELPIPS_GRAD_TOL = 1e-3
ELPIPS_LEVELS = (1, 2, 8)
#: Steps of the wrap-net E-LPIPS recipe (launch counts only).
ELPIPS_WRAP_STEPS = 3
#: Path 8 (the evaluator): card against CPU, SSIM and the temporal diffs
#: absolute, PSNR in dB, E-LPIPS relative. float32 filters and convs in
#: other orders: SSIM ~1e-7, PSNR ~1e-6 dB.
EVAL_SSIM_TOL = 1e-5
EVAL_PSNR_TOL = 1e-4
EVAL_ELPIPS_TOL = 1e-4
EVAL_DIFF_TOL = 1e-6


def bound(nbytes: float, ops: float, peak: float):
    """(bound_ms, bound_by): the larger of bytes over HBM_BPS and ops over
    peak."""
    t_bytes, t_ops = nbytes / HBM_BPS * 1e3, ops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


#: Kernels the build report lists (demangled names), and those whose
#: every instantiation must hold tensor-core instructions.
REPORTED = r"conv_(tc|f32)_kernel|wgrad_(tc|f32)_kernel|wgrad_reduce|" \
    r"stats_fold|ln_(onchip|stats|apply)\b"
TENSOR_CORE = ("conv_tc_kernel", "wgrad_tc_kernel")


def kernel_build_report(so) -> None:
    """The conv, weight-gradient and layer-norm kernels' instantiations in
    the built library: ptxas's registers and spills for each (from the
    build log, `-Xptxas -v`), and the tensor-core instructions (HMMA,
    HGMMA) in each one's SASS (`cuobjdump -sass`). Fails if a bf16
    instantiation (conv_tc_kernel, wgrad_tc_kernel) has none, or if
    wgrad_tc_kernel spills."""
    import re
    from pathlib import Path

    from matryodshka_tpu_torch.ops import _build
    bin_dir = Path(_build._nvcc()).parent
    ptxas, cur = {}, None
    for line in so.with_suffix(".log").read_text().splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties "
                      r"for) '?(\w+)'?", line)
        if m:
            cur = m.group(1)
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m:
            ptxas.setdefault(cur, {})["spill"] = tuple(map(int, m.groups()))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            ptxas.setdefault(cur, {})["regs"] = int(m.group(1))
    sass = subprocess.run([str(bin_dir / "cuobjdump"), "-sass", str(so)],
                          capture_output=True, text=True, check=True,
                          timeout=300).stdout
    mma, fn = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            fn = m.group(1)
            mma[fn] = 0
        elif fn and re.search(r"\bHG?MMA\b", line):
            mma[fn] += 1
    names = sorted(set(ptxas) | set(mma))
    try:
        short = subprocess.run([str(bin_dir / "cu++filt")],
                               input="\n".join(names), capture_output=True,
                               text=True, check=True,
                               timeout=60).stdout.splitlines()
    except (OSError, subprocess.SubprocessError):
        short = names
    if len(short) != len(names):
        short = names
    missing, spilled, n_tc = [], [], {k: 0 for k in TENSOR_CORE}
    for name, nice in zip(names, short):
        if not re.search(REPORTED, nice):
            continue
        nice = re.sub(r"^void |<unnamed>::|\(anonymous namespace\)::", "",
                      nice)
        nice = re.sub(r"\((?:[^()]|\([^()]*\))*\)$", "", nice)
        info = ptxas.get(name, {})
        spill = info.get("spill", ("?", "?", "?"))
        print(f"kernel build {nice}: {info.get('regs', '?')} registers, "
              f"stack frame {spill[0]} B, spill stores {spill[1]} B, spill "
              f"loads {spill[2]} B, "
              f"{mma.get(name, 0)} HMMA/HGMMA in its SASS")
        for k in TENSOR_CORE:
            if k in nice:
                n_tc[k] += 1
                if mma.get(name, 0) == 0:
                    missing.append(nice)
        if "wgrad_tc_kernel" in nice and spill[1:] != (0, 0):
            spilled.append(nice)
    for k, n in n_tc.items():
        print(f"kernel build: {n} bf16 (tensor-core) instantiations of {k}; "
              f"{'ok' if n and not missing else 'FAIL'}")
    check(all(n_tc.values()) and not missing,
          f"bf16 instantiations without tensor-core instructions: "
          f"{missing or n_tc}")
    check(not spilled, f"wgrad_tc_kernel spills: {spilled}")


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def time_ms(fn, iters: int = 10, warmup: int = 2) -> float:
    """Median device time of fn over iters calls, CUDA events around each."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    events = []
    for _ in range(iters):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        events.append((s, e))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in events)


#: Profiler traces taken of one window before device_ms gives up.
TRACE_TRIES = 3
#: The layer-norm kernel's device functions (csrc/layernorm.cu), as the
#: profiler names them.
LN_KERNELS = r"\bln_(onchip|stats|apply)\b"


def device_ms(fns, kernels, pattern: str, calls: int = 10):
    """Device ms per call of each of fns, from one torch.profiler trace of
    `calls` rounds of every fn in turn after 2 warm-up rounds: the kernels'
    own time, which CUDA events around a call shorter than its launch path
    do not see. fn i launches kernels[i] kernels matching pattern per call;
    on one stream they run in launch order, which assigns each to its fn.
    Returns (per-fn ms, or None for every fn if the trace lost a launch;
    total ms per round; launches per round). The profiler now and then
    keeps no device event of a window; such a trace is taken again, up to
    TRACE_TRIES times."""
    import re
    import warnings

    from matryodshka_tpu_torch.trace import device_events
    for _ in range(2):
        for fn in fns:
            fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    for _ in range(TRACE_TRIES):
        with warnings.catch_warnings():
            warnings.filterwarnings("ignore",
                                    message=".*Profiler clears events")
            with torch.profiler.profile(activities=acts) as prof:
                for _ in range(calls):
                    for fn in fns:
                        fn()
                torch.cuda.synchronize()
            events = sorted((e for e in device_events(prof)
                             if re.search(pattern, e[0])),
                            key=lambda e: e[1])
        if events:
            break
    check(bool(events), f"{TRACE_TRIES} traces hold no kernel matching "
                        f"{pattern}")
    total = sum(d for _, _, d in events) / 1e3 / calls
    per_fn = None
    if len(events) == calls * sum(kernels):
        per_fn = [0.0] * len(fns)
        durs = iter(d for _, _, d in events)
        for _ in range(calls):
            for i, k in enumerate(kernels):
                per_fn[i] += sum(next(durs) for _ in range(k)) / 1e3 / calls
    return per_fn, total, len(events) / calls


def trace_counted(fn, counters=None):
    """trace.trace_part(fn), checked against the wrappers' launch counts
    where counters is given (counters() sums the counts of the kernels fn
    launches, each count one kernel). A trace that holds no device event,
    or whose events of the port's kernels (trace.PORT_KERNELS) per call
    differ from the launches counted per call over its window, missed part
    of the window (the profiler now and then drops device events) and is
    taken again, up to TRACE_TRIES times. Returns trace_part's tuple of the
    first complete trace."""
    from matryodshka_tpu_torch.trace import CALLS, port_kernels, trace_part
    for i in range(TRACE_TRIES):
        torch.cuda.synchronize()
        before = counters() if counters else 0
        try:
            got = trace_part(fn)
        except RuntimeError as e:     # no device event in the window
            print(f"  trace {i + 1}/{TRACE_TRIES}: {e}; taken again")
            continue
        if counters is None:
            return got
        launched = (counters() - before) / (CALLS + 2)   # 2 warm-up calls
        traced = sum(n for n, _ in port_kernels(*got[4:]).values()) / CALLS
        if traced == launched:
            return got
        print(f"  trace {i + 1}/{TRACE_TRIES}: {traced:g} port kernel "
              f"events per call against {launched:g} launches counted; "
              f"taken again")
    check(False, f"{TRACE_TRIES} traces lost device events")


def rot_y(deg: float, device) -> torch.Tensor:
    a = math.radians(deg)
    rt = torch.eye(4, device=device)
    rt[0, 0], rt[0, 2], rt[2, 0], rt[2, 2] = (math.cos(a), math.sin(a),
                                              -math.sin(a), math.cos(a))
    return rt[None]


def random_stack(rng, p: int, h: int, w: int, dev) -> torch.Tensor:
    """A bf16 layer stack [1, P, 4, H, W]: colours uniform in [-1, 1],
    alphas in [0, 1]."""
    stack = torch.rand((1, p, 4, h, w), generator=rng, device=dev) * 2 - 1
    stack[:, :, 3] = torch.sigmoid(3.0 * stack[:, :, 3])
    return stack.to(torch.bfloat16)


def sweep_kernels(what, ref, src, depths, intr, gate):
    """K1's gates on one pair of batch images ([1, H, W, 3] in [0, 1]):
    1. the kernel's projection (sweep_ops.sweep_row_params, the
       instrument) against row_params in float64: validity identical,
       positions within the f32 noise bound (grids.lookup_error), printed
       beside the plain float32 row_params' own distance from float64;
    2. sweep_volume (one launch) in f32 and bf16 against ods_sweep_plain
       fed the instrument's tables: the same taps and weights, each
       operation rounded once in both (1e-5), and one bf16 rounding of
       values in [-1, 1] (2^-8). The plain version runs a few planes at a
       time, which keeps its gathers small at 4096x2048."""
    from matryodshka_tpu_torch.geometry import grids
    from matryodshka_tpu_torch.models import msi as msi_lib
    from matryodshka_tpu_torch.ops import sweep as sweep_ops
    _, h, w, _ = ref.shape
    p = depths.shape[0]
    rowp = sweep_ops.sweep_row_params(depths, intr, h, w)
    ref64 = sweep_ops.dual_row_params(depths.double(), intr.double(), h, w)
    same, err = sweep_ops.row_params_error(rowp, ref64, depths, h, w)
    _, perr = sweep_ops.row_params_error(
        sweep_ops.dual_row_params(depths, intr, h, w), ref64, depths, h, w)
    ok = same and err["u"] <= 1.0 and err["v"] <= 1.0
    print(f"sweep      row params {what}: validity "
          f"{'identical' if same else 'DIFFERS'} to float64; worst "
          f"|d(x0+fx)| {err['u_px']:.3e} px, |d(y0+fy)| {err['v_px']:.3e} "
          f"px; of the noise bound u {err['u']:.3f} v {err['v']:.3f} "
          f"(tol 1; plain f32 row_params {perr['u']:.3f}, {perr['v']:.3f}; "
          f"the bound is max({grids.NOISE_PX:g}, {grids.NOISE_PX_PER_M:g} "
          f"depth) px at 64x32, x{w // 64} in u and x{h // 32} in v here, "
          f"u counted on the sphere) {'ok' if ok else 'FAIL'}")
    check(ok, f"sweep row params {what} vs float64")
    images, _ = sweep_ops.sweep_inputs(msi_lib.preprocess_image(ref),
                                       msi_lib.preprocess_image(src),
                                       depths[:1], intr)
    step = max(1, (1 << 27) // (6 * h * w))
    for dt, tol in ((torch.float32, 1e-5), (torch.bfloat16, 2.0 ** -8)):
        n = sweep_ops.launches
        got = sweep_ops.sweep_volume(ref, src, depths, intr, dt)
        check(sweep_ops.launches == n + 1, "sweep_volume is one launch")
        got = got.view(1, 2, p, 3, h, w)
        errs = []
        for p0 in range(0, p, step):
            part = {k: t[:, :, p0:p0 + step] for k, t in rowp.items()}
            mine = got[:, :, p0:p0 + step].float()
            check(bool(torch.isfinite(mine).all()), f"sweep {what} finite")
            want = sweep_ops.ods_sweep_plain(images, part, torch.float32)
            errs.append((mine - want.view_as(mine)).abs().max())
        del got, mine, want
        gate("sweep", f"2x{p} planes {what} -> {str(dt)[6:]}",
             torch.stack(errs).max(), torch.zeros(()), tol)


def uv_gate(what, rt, pos, radii, h, w, shells=None):
    """The per-shell lookups the render kernels project (their uv
    instrument, ops/render.py:uv_project) against intersect_sphere_uv in
    float64 (grids.lookup_error), `shells` shells at a time (all by
    default), printed beside the plain float32 tables' own distance; fails
    beyond the noise bound."""
    from matryodshka_tpu_torch.geometry import grids
    from matryodshka_tpu_torch.geometry import render as render_lib
    from matryodshka_tpu_torch.ops import render as render_ops
    err, perr = {}, {}
    step = shells or radii.shape[0]
    for p0 in range(0, radii.shape[0], step):
        r = radii[p0:p0 + step].contiguous()
        u6, v6 = render_lib.uv_tables(rt.double(), pos.double(), r.double(),
                                      h, w)
        scale = r.double()[None, :, None, None]
        for acc, (u, v) in ((err, render_ops.uv_project(rt, pos, r, h, w)),
                            (perr, render_lib.uv_tables(rt, pos, r, h, w))):
            for k, x in grids.lookup_error(u, v, u6, v6, scale, h,
                                           w).items():
                acc[k] = max(acc.get(k, 0.0), x)
            del u, v
        del u6, v6
    ok = err["u"] <= 1.0 and err["v"] <= 1.0
    print(f"render     uv {w}x{h} {what}: worst |du| {err['u_px']:.3e} px, "
          f"|dv| {err['v_px']:.3e} px from float64; of the noise bound "
          f"u {err['u']:.3f} v {err['v']:.3f} (tol 1; plain f32 tables "
          f"{perr['u']:.3f}, {perr['v']:.3f}; max({grids.NOISE_PX:g}, "
          f"{grids.NOISE_PX_PER_M:g} radius) px at 64x32, x{w // 64} in "
          f"u and x{h // 32} in v here, u counted on the sphere) "
          f"{'ok' if ok else 'FAIL'}")
    check(ok, f"render uv {w}x{h} {what} vs float64")


def layer_stack_gates(gate, name, what, stack, target, u, v, ftb):
    """The layer-stack kernel's three output modes on one stack and target
    (image, depth proxy, both in one launch), each one launch, against
    render_layers_plain fed (u, v), the uv instrument's tables of the
    target: the same taps, the composite's f32 math in another order, plus
    early termination at T < 1e-6 when ftb: 1e-5 on values in [-1, 1]
    (image) and [0, 1) (depth). Prints whether the both mode's outputs
    equal the one-output modes' bit for bit."""
    from matryodshka_tpu_torch.ops import render_layers as rl_ops
    want = (rl_ops.render_layers_plain(stack, u, v),
            rl_ops.render_layers_plain(stack, u, v, depth=True))
    counters = ("launches", "ftb_launches", "both_launches")
    got = {}
    for mode in ("rgb", "depth", "both"):
        before = [getattr(rl_ops, c) for c in counters]
        if mode == "both":
            got[mode] = rl_ops.render_layers_both(stack, *target, ftb=ftb)
        else:
            got[mode] = (rl_ops.render_layers(stack, *target, ftb=ftb,
                                              depth=mode == "depth"),)
        n = [getattr(rl_ops, c) - b for c, b in zip(counters, before)]
        check(n == [int(not ftb), int(ftb), int(mode == "both")],
              f"{name} {what} {mode}: one launch, counted {n}")
    for mode, outs, wants in (("", got["rgb"], want[:1]),
                              (" depth", got["depth"], want[1:]),
                              (" both", got["both"], want)):
        for i, (g, wnt) in enumerate(zip(outs, wants)):
            part = f"{mode}{' (depth)' if mode == ' both' and i else ''}"
            gate(name, f"{what}{part}", g, wnt, 1e-5)
    same = (torch.equal(got["both"][0], got["rgb"][0])
            and torch.equal(got["both"][1], got["depth"][0]))
    print(f"{name:10s} {what} both mode vs the two one-output launches: "
          f"{'bit-identical' if same else 'DIFFER (within the gates)'}")


def wrap_conv_layers(ngf: int, cin0: int):
    """(name, Cin, Cout, size divisor) of the net's stride-1, rate-1 3x3
    convs, the layers the trainer runs through K7 (models/unet.py)."""
    from matryodshka_tpu_torch.ops.net import unet_plan
    return [(name, sum(cins), cout, ind)
            for (name, kind, _, cins, cout, ind, _, rate)
            in unet_plan(ngf, cin0, 1) if kind == "conv" and rate == 1]


def training_batch(cfg):
    """A training example as the loader gives it (numpy, batch 1), built in
    memory from the synthetic fixture's texture (data/synthetic.py: ref,
    src and tgt are longitude-rolled copies), identity eye poses, baseline
    0.032 m."""
    from matryodshka_tpu_torch.data.synthetic import erp_texture
    tex = erp_texture(cfg.height, cfg.width, seed=0)

    def img(k):
        shift = int(round((k - 1) * cfg.width * 0.01))
        return np.roll(tex, shift, axis=1)[None].copy()

    eye = np.eye(4, dtype=np.float32)[None]
    intr = np.eye(3, dtype=np.float32)[None]
    intr[0, 0, 0] = 0.032
    return {"ref_image": img(0), "src_image": img(1), "tgt_image": img(2),
            "ref_pose": eye, "src_pose": eye, "ref_pose_inv": eye,
            "tgt_pose": np.asarray([[0.03, 0.01, -0.02]], np.float32),
            "intrinsics": intr}


def wrap_conv_kernels(dev, h, w, gate, errs, tag):
    """K7 at the eight layer shapes of the flagship trainer (bf16 inputs,
    seeded weights): every form, the dgrad and the wgrad against their
    plain versions, then the times of the forms each layer runs in a step
    (K7c for >= 160 input channels, else K7b; dgrad, a K7a launch, for all
    but conv1_1, whose input is the sweep; wgrad for all), their plain
    versions and cuDNN bf16 on the same work. Returns per-step sums
    {key: (ms, plain_ms, library_ms, bound)}."""
    import torch.nn.functional as F

    from matryodshka_tpu_torch.ops import wrap_conv as wc
    from matryodshka_tpu_torch.ops.conv import tile_config as conv_tile
    from matryodshka_tpu_torch.ops.conv import wrap_pad

    rng = torch.Generator(device=dev).manual_seed(4321)
    sums = {k: [0.0, 0.0, 0.0, 0.0, 0.0] for k in (
        "wrap_conv_k7a", "wrap_conv_k7b", "wrap_conv_k7c", "wrap_conv_wgrad")}

    def add(key, kt, pt, lt, nb, ops):
        s = sums[key]
        for i, v in enumerate((kt, pt, lt, nb, ops)):
            s[i] += v

    for name, cin, cout, ind in wrap_conv_layers(64, 192):
        hh, ww = h // ind, w // ind
        # post-ReLU-like inputs, as the trainer feeds these layers: half
        # zeros, so s1 is not a small difference of large sums
        x = torch.relu(torch.rand((1, cin, hh, ww), generator=rng,
                                  device=dev) * 2 - 1).to(torch.bfloat16)
        wt = torch.randn((cout, cin, 3, 3), generator=rng, device=dev) * (
            9 * cin) ** -0.5
        bias = 0.1 * torch.randn(cout, generator=rng, device=dev)
        gy = torch.randn((1, cout, hh, ww), generator=rng,
                         device=dev).to(torch.bfloat16)
        shape = f"{name} {cin}->{cout} {hh}x{ww}"
        # Forward and dgrad: kernel and plain version read the same rounded
        # operands and sum in f32 in other orders: f32 outputs to 1e-4 of
        # their scale, bf16 outputs within one bf16 step (2^-7 of the
        # scale), as the conv gates above.
        want = wc.conv3x3_wrap_plain(x, wt, bias)
        gate("wrap_conv_k7a", f"{shape} fwd", wc.conv3x3_wrap(x, wt, bias),
             want, 1e-4 * want.abs().max().item())
        want = wc.conv3x3_wrap_dma_plain(x, wt, bias)
        gate("wrap_conv_k7b", shape, wc.conv3x3_wrap_dma(x, wt, bias), want,
             2.0 ** -7 * want.float().abs().max().item())
        y, s1, s2 = wc.conv3x3_ln_stats(x, wt, bias)
        yp, p1, p2 = wc.conv3x3_ln_stats_plain(x, wt, bias)
        gate("wrap_conv_k7c", shape, y, yp,
             2.0 ** -7 * yp.float().abs().max().item())
        # The sums: the f32 products of a y element sum in another order
        # in the kernel (~sqrt(9 Cin) * 2^-24 of |y|), so about 1e-3 of
        # the elements round one bf16 step (2^-8 |y|) the other way, with
        # random signs: ~1e-7 of sum|y| and of s2 at 1e5-1e7 elements,
        # and the f32 block partials add less. STATS_TOL = 1e-5 leaves
        # 100x for that; one of the 400-1600 block partials of a sample
        # dropped or counted twice moves s2 by >= 6e-4 of it.
        d1, d2 = (s1 - p1).abs().item(), (s2 - p2).abs().item()
        t1 = STATS_TOL * yp.double().abs().sum().item()
        t2 = STATS_TOL * p2.item()
        print(f"wrap_conv_k7c {shape} stats |ds1|/|s1| "
              f"{d1 / abs(p1.item()):.3e} |ds1|/sum|y| "
              f"{d1 / t1 * STATS_TOL:.3e} |ds2|/s2 {d2 / p2.item():.3e} "
              f"(tol {STATS_TOL:.0e} of sum|y|, s2) "
              f"{'ok' if d1 <= t1 and d2 <= t2 else 'FAIL'}")
        check(d1 <= t1 and d2 <= t2, f"wrap_conv_k7c {shape} stats")
        wadj = wc.adjoint(wt)
        want = wc.conv3x3_wrap_plain(gy, wadj)
        gate("wrap_conv_k7a", f"{shape} dgrad", wc.conv3x3_wrap(gy, wadj),
             want, 1e-4 * want.abs().max().item())
        # wgrad: sums of up to 204,800 products in f32, in two blockings;
        # rounding errors grow like sqrt(K) * 2^-24 relative to the
        # result's root-sum-square (~3e-5 at K = 204,800), while a wrong
        # tap, row or lost split moves it by O(1): relative L2 <= 1e-3.
        dw, db = wc.conv3x3_wrap_wgrad(gy, x)
        dwp, dbp = wc.conv3x3_wrap_wgrad_plain(gy, x)
        rw = ((dw - dwp).norm() / dwp.norm()).item()
        rb = ((db - dbp).norm() / dbp.norm()).item()
        err = max((dw - dwp).abs().max().item(), (db - dbp).abs().max().item())
        errs_ok = rw <= WGRAD_TOL and rb <= WGRAD_TOL and bool(
            torch.isfinite(dw).all())
        # the split and the fold are fixed by the shape: bit-identical
        dw2, db2 = wc.conv3x3_wrap_wgrad(gy, x)
        same = bool(torch.equal(dw, dw2) and torch.equal(db, db2))
        print(f"wrap_conv_wgrad {shape} rel L2 dW {rw:.3e} db {rb:.3e} "
              f"max_abs_err {err:.3e} (tol rel {WGRAD_TOL:.0e}); two "
              f"launches {'bit-identical' if same else 'DIFFER'} "
              f"{'ok' if errs_ok and same else 'FAIL'}")
        check(errs_ok, f"wrap_conv_wgrad {shape}")
        check(same, f"wrap_conv_wgrad {shape}: two launches differ")
        errs["wrap_conv_wgrad"] = max(errs["wrap_conv_wgrad"], err)

        # times of this layer's launches in a training step
        flops = 2.0 * 9 * cin * cout * hh * ww
        xp = wrap_pad(x, 1, 1, 1, 1)
        wb, bb = wt.to(torch.bfloat16), bias.to(torch.bfloat16)
        lib_fwd = time_ms(lambda: F.conv2d(xp, wb, bb))
        if cin >= 160:
            kt = time_ms(lambda: wc.conv3x3_ln_stats(x, wt, bias))
            pt = time_ms(lambda: wc.conv3x3_ln_stats_plain(x, wt, bias))
            add("wrap_conv_k7c", kt, pt, lib_fwd,
                nbytes(x, wt, bias, y) + 16, flops)
        else:
            kt = time_ms(lambda: wc.conv3x3_wrap_dma(x, wt, bias))
            pt = time_ms(lambda: wc.conv3x3_wrap_dma_plain(x, wt, bias))
            add("wrap_conv_k7b", kt, pt, lib_fwd, nbytes(x, wt, bias, y),
                flops)
        line = (f"{name:8s} fwd ({'K7c' if cin >= 160 else 'K7b'}) kernel "
                f"{kt:7.3f} ms ({flops / kt / 1e9:6.2f} TFLOP/s, tile "
                f"{conv_tile(1, 1, hh, ww, cout, x.dtype)}) plain "
                f"{pt:7.3f} library bf16 {lib_fwd:7.3f}")
        if name != "conv1_1":
            dt = time_ms(lambda: wc.conv3x3_wrap(gy, wadj))
            dpt = time_ms(lambda: wc.conv3x3_wrap_plain(gy, wadj))
            dlt = time_ms(lambda: torch.nn.grad.conv2d_input(
                xp.shape, wb, gy))
            add("wrap_conv_k7a", dt, dpt, dlt,
                nbytes(gy, wt) + 4 * x.numel(), flops)
            line += (f" | dgrad kernel {dt:7.3f} ({flops / dt / 1e9:6.2f} "
                     f"TFLOP/s, tile {conv_tile(1, 1, hh, ww, cin, x.dtype)})"
                     f" plain {dpt:7.3f} library {dlt:7.3f}")
        gt = time_ms(lambda: wc.conv3x3_wrap_wgrad(gy, x))
        gpt = time_ms(lambda: wc.conv3x3_wrap_wgrad_plain(gy, x))
        glt = time_ms(lambda: torch.nn.grad.conv2d_weight(xp, wt.shape, gy))
        add("wrap_conv_wgrad", gt, gpt, glt, nbytes(gy, x, dw, db),
            flops + 2.0 * cout * hh * ww)
        splits, chunk = wc.wgrad_tc_splits(1, hh, ww, cout, cin)
        part_mb = splits * cout * (9 * cin + 1) * 4 / 1e6
        print(f"{line} | wgrad kernel {gt:7.3f} ({flops / gt / 1e9:6.2f} "
              f"TFLOP/s; {splits} splits of {chunk} k-blocks, f32 partials "
              f"{part_mb:.1f} MB written and read) plain {gpt:7.3f} library "
              f"{glt:7.3f} ms {tag}")
    return {k: (v[0], v[1], v[2], bound(v[3], v[4], BF16_FLOPS))
            for k, v in sums.items()}


def run_train_loop(tcfg, dev, reset_counts, read_counts, elpips, nsteps):
    """tcfg's trainer through training/loop.train for nsteps steps on one
    repeated in-memory batch, with E-LPIPS `elpips` (None for the pixel
    loss) and the metrics records stamped with its calibration; the launch
    counts (K7's too) zeroed before and read after. Returns (state,
    launches, CUDA events per step, metrics records, peak bytes, bytes held
    before)."""
    from matryodshka_tpu_torch.data.loader import device_prefetch
    from matryodshka_tpu_torch.ops import wrap_conv as wc
    from matryodshka_tpu_torch.training import loop as loop_lib
    from matryodshka_tpu_torch.training import state as state_lib
    from matryodshka_tpu_torch.training import step as step_lib

    with tempfile.TemporaryDirectory() as ckdir:
        tcfg = dataclasses.replace(tcfg, max_steps=nsteps, summary_freq=1,
                                   save_latest_freq=nsteps,
                                   checkpoint_dir=ckdir,
                                   experiment_name="run")
        tstate = state_lib.init_state(tcfg, 0, dev)
        np_batch = training_batch(tcfg)
        step_fn = step_lib.make_train_step(tcfg, tstate.net, elpips=elpips)
        events = []

        def timed_step(state, b):
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            out = step_fn(state, b)
            e.record()
            events.append((s, e))
            return out

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        mem0 = torch.cuda.memory_allocated()
        reset_counts()
        for attr in K7_COUNTS.values():
            setattr(wc, attr, 0)
        # the batches reach the card as the CLI sends them: pinned copies,
        # non_blocking, from device_prefetch's thread
        batches = device_prefetch(itertools.repeat(np_batch), size=2,
                                  device=dev)
        tstate = loop_lib.train(
            tcfg, tstate, timed_step, batches, static_log_fields=None
            if elpips is None else {"elpips_calibrated": elpips.calibrated})
        batches.close()
        launches = read_counts()
        launches.update({k: getattr(wc, a) for k, a in K7_COUNTS.items()})
        peak = torch.cuda.max_memory_allocated()
        with open(f"{ckdir}/run/logs/metrics.jsonl") as fh:
            records = [json.loads(line) for line in fh]
    return tstate, launches, events, records, peak, mem0


def training_path(dev, tag, reset_counts, read_counts):
    """Path 5: the default ODS trainer through training/loop.train for
    TRAIN_WARMUP + TRAIN_STEPS steps on one repeated in-memory batch at
    the flagship configuration, the launch counts zeroed before and read
    after; the step's median time, peak memory and losses; the step in
    parts; one step's loss and gradients against the all-plain f32 route,
    beside the all-plain bf16 route's. Returns each kernel's launches over
    the steps."""
    from matryodshka_tpu_torch import entry
    from matryodshka_tpu_torch.training import step as step_lib

    nsteps = TRAIN_WARMUP + TRAIN_STEPS
    tcfg = entry.flagship_cfg()
    tstate, train_launches, step_events, records, train_peak, mem0 = \
        run_train_loop(tcfg, dev, reset_counts, read_counts, None, nsteps)
    losses = [r["total_loss"] for r in records]
    tbatch = {k: torch.from_numpy(v).to(dev)
              for k, v in training_batch(tcfg).items()}
    print(f"launches over {nsteps} training steps: {train_launches}")
    check(tstate.step == nsteps and len(losses) == nsteps,
          f"training ran {tstate.step} steps")
    for k in ("sweep", *K7_COUNTS):
        check(train_launches[k] > 0, f"kernel {k} was not launched on the "
                                     f"training path")
    step_ms = statistics.median(s.elapsed_time(e)
                                for s, e in step_events[TRAIN_WARMUP:])
    print(f"train step {step_ms:.3f} ms (median of {TRAIN_STEPS} after "
          f"{TRAIN_WARMUP} warm-up; 640x320, 32+32 planes, ngf 64, bf16, "
          f"batch 1), peak device memory {train_peak / 2**30:.3f} GiB "
          f"({(train_peak - mem0) / 2**30:.3f} GiB above the "
          f"{mem0 / 2**30:.3f} GiB held before) {tag}")
    print(f"train losses on one repeated batch: "
          + " ".join(f"{v:.3f}" for v in losses))
    check(all(math.isfinite(v) for v in losses) and losses[-1] < losses[0],
          "training losses are finite and fall")

    # where a step's time goes: the same step in parts, CUDA events between
    loss_fn = step_lib.make_loss_fn(tcfg, tstate.net)
    parts = {"sweep": [], "net_forward": [], "assemble_render_loss": [],
             "backward": [], "optimizer": []}
    for i in range(nsteps):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(6)]
        ev[0].record()
        vol_t = loss_fn.sweep(tbatch)
        ev[1].record()
        pred_t = tstate.net(vol_t)
        ev[2].record()
        loss_t, _ = loss_fn.tail(tbatch, vol_t, pred_t)
        ev[3].record()
        tstate.optimizer.zero_grad(set_to_none=True)
        loss_t.backward()
        ev[4].record()
        tstate.optimizer.step()
        ev[5].record()
        torch.cuda.synchronize()
        if i >= TRAIN_WARMUP:
            for j, k in enumerate(parts):
                parts[k].append(ev[j].elapsed_time(ev[j + 1]))
    del vol_t, pred_t, loss_t
    print("train step parts " + " ".join(
        f"{k} {statistics.median(v):.3f}" for k, v in parts.items())
          + f" ms (median of {TRAIN_STEPS}) {tag}")

    route_gate("train step", tcfg, tstate.net, tbatch, dev)
    return train_launches


def route_gate(what, tcfg, net, tbatch, dev, elpips=None,
               loss_tol=TRAIN_LOSS_TOL):
    """One step from net's parameters: the kernel route (net as the
    trainer runs it, bf16) against the all-plain f32 route, with the
    all-plain bf16 route (no kernel of the port) as the measure of what
    bf16 alone costs. The loss within loss_tol relative of plain f32 (None:
    within max(TRAIN_LOSS_TOL, TRAIN_GRAD_MARGIN x the plain bf16 route's
    distance)), each parameter's gradient within relative L2
    max(TRAIN_GRAD_TOL, TRAIN_GRAD_MARGIN x the plain bf16 route's).
    elpips: the routes' shared E-LPIPS (with one fixed draw)."""
    from matryodshka_tpu_torch.models import msi as msi_lib
    from matryodshka_tpu_torch.models.unet import MSIUNet
    from matryodshka_tpu_torch.ops import sweep as sweep_ops
    from matryodshka_tpu_torch.training import step as step_lib

    def plain_net(dtype):
        net_ = MSIUNet(tcfg.num_net_inputs(), tcfg.num_net_outputs(),
                       tcfg.ngf, dtype=dtype,
                       variant=tcfg.net_variant).to(dev)
        net_.load_state_dict(net.state_dict())
        return net_

    def plain_sweep(dtype):
        def sweep(c, b, d):
            imgs, rowp = sweep_ops.sweep_inputs(
                msi_lib.preprocess_image(b["ref_image"]),
                msi_lib.preprocess_image(b["src_image"]), d, b["intrinsics"])
            return sweep_ops.ods_sweep_plain(imgs, rowp, dtype)
        return sweep

    routes = {}
    for key, net_, sweep in (
            ("kernel", net, None),
            ("plain_bf16", plain_net(torch.bfloat16),
             plain_sweep(torch.bfloat16)),
            ("plain", plain_net(torch.float32), plain_sweep(torch.float32))):
        net_.zero_grad(set_to_none=True)
        loss_r, _ = step_lib.make_loss_fn(tcfg, net_, sweep, elpips)(tbatch)
        loss_r.backward()
        routes[key] = (loss_r.item(), {n: p.grad.detach().float()
                                       for n, p in net_.named_parameters()})
        del loss_r, net_
    lp, gp = routes["plain"]
    rel, loss_rel = {}, {}
    for key in ("plain_bf16", "kernel"):
        lk, gk = routes[key]
        loss_rel[key] = abs(lk - lp) / abs(lp)
        rel[key] = {n: ((gk[n] - gp[n]).norm() / gp[n].norm()).item()
                    for n in gp}
        worst = sorted(rel[key].items(), key=lambda kv: -kv[1])
        tol = (loss_tol if loss_tol is not None else max(
            TRAIN_LOSS_TOL, TRAIN_GRAD_MARGIN * loss_rel["plain_bf16"]))
        print(f"{what} {key} route vs all-plain f32, same parameters: "
              f"loss {lk:.4f} vs {lp:.4f}, rel {loss_rel[key]:.3e} "
              f"(tol {tol:.0e}); gradient rel L2 median "
              f"{statistics.median(rel[key].values()):.3e}, worst "
              + ", ".join(f"{n} {v:.3e}" for n, v in worst[:4]))
        check(loss_rel[key] <= tol, f"{what} loss, {key} vs plain f32 route")
    bad = [n for n, v in rel["kernel"].items()
           if v > max(TRAIN_GRAD_TOL, TRAIN_GRAD_MARGIN * rel["plain_bf16"][n])]
    print(f"{what} gradients of the kernel route within max("
          f"{TRAIN_GRAD_TOL:.0e}, {TRAIN_GRAD_MARGIN} x the plain bf16 "
          f"route's) of plain f32: {len(rel['kernel']) - len(bad)} of "
          f"{len(rel['kernel'])} parameters "
          f"{'ok' if not bad else 'FAIL ' + ', '.join(bad)}")
    check(not bad, f"{what} gradients {bad}, kernel vs plain route")


def elpips_training_path(dev, tag, reset_counts, read_counts):
    """Path 7: the E-LPIPS trainer at the flagship shape. The released
    recipe (scripts/train/ods-wotemp-elpips-coord.sh: which_loss=elpips,
    the coord net, elpips_average_over 1, random features) for
    TRAIN_WARMUP + TRAIN_STEPS steps, then the wrap recipe
    (ods-wotemp-elpips-wocoord) for ELPIPS_WRAP_STEPS, each through
    training/loop.train with the launch counts zeroed and read. Then the
    E-LPIPS part of a step (forward and input gradient on the step's
    render) at each scale level, both swaps; the card's distance and input
    gradient against the CPU's at fixed draws (ELPIPS_LEVELS, both swaps);
    one step's gradients against the all-plain f32 route (route_gate)."""
    import warnings

    from matryodshka_tpu_torch import entry
    from matryodshka_tpu_torch.losses.elpips import api as elpips_api
    from matryodshka_tpu_torch.models import msi as msi_lib
    from matryodshka_tpu_torch.training import step as step_lib

    nsteps = TRAIN_WARMUP + TRAIN_STEPS
    tcfg = entry.flagship_cfg(which_loss="elpips", coord_net=True)
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", message="elpips: no weight_path")
        metric = step_lib.build_elpips(tcfg, dev)
        metric_cpu = step_lib.build_elpips(tcfg, "cpu")
    check(not metric.calibrated, "E-LPIPS without weights is uncalibrated")
    tstate, launches, events, records, peak, mem0 = run_train_loop(
        tcfg, dev, reset_counts, read_counts, metric, nsteps)
    print(f"launches over {nsteps} E-LPIPS training steps (coord net): "
          f"{launches}")
    check(tstate.step == nsteps and len(records) == nsteps,
          f"E-LPIPS training ran {tstate.step} steps")
    check(launches["sweep"] > 0, "kernel sweep was not launched on the "
                                 "E-LPIPS training path")
    check(all(r.get("elpips_calibrated") is False for r in records),
          "every metrics record says elpips_calibrated: false")
    losses = [r["total_loss"] for r in records]
    check(all(math.isfinite(v) for v in losses), "E-LPIPS losses finite")
    # the levels the steps drew: the step's generator feeds only the
    # metric's draws, so a generator seeded alike replays them
    g = torch.Generator().manual_seed(tcfg.random_seed)
    levels = [(d.params.scale_level, d.params.swap_xy)
              for d in (metric.draw(1, g) for _ in range(nsteps))]
    step_ms = [s.elapsed_time(e) for s, e in events]
    step_med = statistics.median(step_ms[TRAIN_WARMUP:])
    print(f"elpips train step {step_med:.3f} ms (median of {TRAIN_STEPS} "
          f"after {TRAIN_WARMUP} warm-up; coord net, 640x320, 32+32 planes, "
          f"ngf 64, bf16, batch 1), peak device memory "
          f"{peak / 2**30:.3f} GiB ({(peak - mem0) / 2**30:.3f} GiB above "
          f"the {mem0 / 2**30:.3f} GiB held before) {tag}")
    print("elpips train steps (level, swap): ms " + " ".join(
        f"({lv},{sw}):{t:.3f}" for (lv, sw), t in zip(levels, step_ms)))
    print("elpips train losses: " + " ".join(f"{v:.4f}" for v in losses))

    wcfg = entry.flagship_cfg(which_loss="elpips")
    wstate, wl, _, wrecs, _, _ = run_train_loop(
        wcfg, dev, reset_counts, read_counts, metric, ELPIPS_WRAP_STEPS)
    print(f"launches over {ELPIPS_WRAP_STEPS} E-LPIPS training steps (wrap "
          f"net): {wl}")
    for k in ("sweep", *K7_COUNTS):
        check(wl[k] > 0, f"kernel {k} was not launched on the wrap net's "
                         f"E-LPIPS training path")
    check(all(math.isfinite(r["total_loss"]) and r["elpips_calibrated"]
              is False for r in wrecs), "wrap E-LPIPS records")
    del wstate

    # the metric's inputs as the step gives them: the [-1, 1] render of
    # the trained net and the preprocessed target
    tbatch = {k: torch.from_numpy(v).to(dev)
              for k, v in training_batch(tcfg).items()}
    loss_fn = step_lib.make_loss_fn(tcfg, tstate.net, elpips=metric)
    with torch.no_grad():
        vol = loss_fn.sweep(tbatch)
        pred = loss_fn.render(vol, tstate.net(vol), tbatch)["output_image"]
    tgt = msi_lib.preprocess_image(tbatch["tgt_image"])
    del vol

    # where the step's time goes, at one level-1 draw: the step in parts,
    # CUDA events between
    draw = metric.draw(1, torch.Generator().manual_seed(5), scale=1)
    parts = {"sweep": [], "net_forward": [], "assemble_render": [],
             "elpips": [], "backward": [], "optimizer": []}
    for i in range(nsteps):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(7)]
        ev[0].record()
        vol_t = loss_fn.sweep(tbatch)
        ev[1].record()
        pred_t = tstate.net(vol_t)
        ev[2].record()
        out_t = loss_fn.render(vol_t, pred_t, tbatch)["output_image"]
        ev[3].record()
        loss_t = torch.mean(metric(out_t, tgt, draws=[draw]))
        ev[4].record()
        tstate.optimizer.zero_grad(set_to_none=True)
        loss_t.backward()
        ev[5].record()
        tstate.optimizer.step()
        ev[6].record()
        torch.cuda.synchronize()
        if i >= TRAIN_WARMUP:
            for j, k in enumerate(parts):
                parts[k].append(ev[j].elapsed_time(ev[j + 1]))
    del vol_t, pred_t, out_t, loss_t
    print("elpips train step parts at level 1 " + " ".join(
        f"{k} {statistics.median(v):.3f}" for k, v in parts.items())
          + f" ms (median of {TRAIN_STEPS}) {tag}")

    def fwd_bwd(m, p, t, draw):
        x = p.detach().clone().requires_grad_(True)
        d = m(x, t, draws=[draw])
        d.mean().backward()
        return d.item(), x.grad

    gen = torch.Generator().manual_seed(7)
    per_level = {}
    for level in range(1, 9):
        for swap in (False, True):
            draw = metric.draw(1, gen, scale=level, swap=swap)
            per_level[level, swap] = time_ms(
                lambda: fwd_bwd(metric, pred, tgt, draw), iters=5)
    probs = np.asarray(metric.config.scale_probabilities)
    probs = probs / probs.sum()
    expect = sum(p * (per_level[lv, False] + per_level[lv, True]) / 2
                 for lv, p in zip(range(1, 9), probs))
    print("elpips forward + input gradient per scale level, ms (swap off, "
          "on; share of the step's median): " + "; ".join(
              f"{lv}: {per_level[lv, False]:.3f}, {per_level[lv, True]:.3f} "
              f"({(per_level[lv, False] + per_level[lv, True]) / 2 / step_med:.3f})"
              for lv in range(1, 9))
          + f"; expected under the 1/i^2 prior {expect:.3f} ms "
            f"({expect / step_med:.3f} of the step) {tag}")

    for level in ELPIPS_LEVELS:
        for swap in (False, True):
            draw = metric.draw(1, gen, scale=level, swap=swap)
            dc, gc = fwd_bwd(metric_cpu, pred.cpu(), tgt.cpu(),
                             elpips_api.Draw(draw.params, draw.seed))
            dg, gg = fwd_bwd(metric, pred, tgt,
                             elpips_api.Draw(draw.params, draw.seed))
            rd = abs(dg - dc) / abs(dc)
            rg = ((gg.cpu() - gc).norm() / gc.norm()).item()
            ok = rd <= ELPIPS_TOL and rg <= ELPIPS_GRAD_TOL
            print(f"elpips level {level} swap {swap:d} card vs CPU f32: "
                  f"distance {dg:.6f} vs {dc:.6f} rel {rd:.3e} (tol "
                  f"{ELPIPS_TOL:.0e}); input gradient rel L2 {rg:.3e} (tol "
                  f"{ELPIPS_GRAD_TOL:.0e}) {'ok' if ok else 'FAIL'}")
            check(ok, f"elpips level {level} swap {swap}, card vs CPU")
    del metric_cpu

    # one step's gradients at one fixed draw (level 1, the likeliest),
    # the same for the three routes
    draw = metric.draw(1, gen, scale=1, swap=False)
    route_gate("elpips train step", tcfg, tstate.net, tbatch, dev,
               elpips=lambda p, t, g: metric(p, t, draws=[draw]),
               loss_tol=None)
    return launches, wl


def evaluator_path(dev, tag, reset_counts, read_counts):
    """Path 8: the evaluator. The coord net's test CLI (main, seeded
    weights from --params, --test_outputs tgt_image) writes two examples
    and then two consecutive video frames of a 640x320 synthetic fixture
    to a temporary directory, the launch counts zeroed before and read
    after; then cli/evaluate.main with --with_elpips --allow_uncalibrated
    in reg and video mode, on the card and with --device cpu, the two
    JSONs held to each other; then the card's ms per example."""
    import warnings

    from matryodshka_tpu_torch import entry, weights
    from matryodshka_tpu_torch.cli import evaluate as cli_evaluate
    from matryodshka_tpu_torch.cli import test as cli_test
    from matryodshka_tpu_torch.data.synthetic import make_ods_fixture
    from matryodshka_tpu_torch.losses.elpips import api as elpips_api
    from matryodshka_tpu_torch.training.checkpoint import save_params

    ccfg = entry.flagship_cfg(coord_net=True)
    with tempfile.TemporaryDirectory() as tmp:
        cams = make_ods_fixture(f"{tmp}/fix", num_scenes=1,
                                height=ccfg.height, width=ccfg.width)
        save_params(f"{tmp}/coord.npz", weights.seeded_init(ccfg, 0))
        flags = ["--image_dir", f"{tmp}/fix/images", "--cameras_glob", cams,
                 "--height", str(ccfg.height), "--width", str(ccfg.width),
                 "--num_psv_planes", str(ccfg.num_psv_planes),
                 "--num_msi_planes", str(ccfg.num_msi_planes),
                 "--ngf", str(ccfg.ngf),
                 "--coord_net", "true", "--params", f"{tmp}/coord.npz",
                 "--output_root", f"{tmp}/out", "--experiment_name", "eval",
                 "--test_outputs", "tgt_image", "--num_runs", "2",
                 "--device", str(dev)]
        reset_counts()
        t0 = time.perf_counter()
        cli_test.main(flags)
        cli_test.main(flags + ["--test_type", "on_video"])
        cli_wall = time.perf_counter() - t0
        launches = read_counts()
        print(f"launches of the test CLI runs the evaluator reads: "
              f"{launches}")
        for k in ("sweep", "conv_coord", "layernorm", "render",
                  "render_depth"):
            check(launches[k] > 0, f"kernel {k} was not launched on the "
                                   f"evaluator's test CLI path")
        root = f"{tmp}/out/eval"
        out, wall = {}, {}
        for mode in ("reg", "video"):
            for side, d in (("card", str(dev)), ("cpu", "cpu")):
                t0 = time.perf_counter()
                with warnings.catch_warnings():
                    warnings.filterwarnings("ignore",
                                            message="elpips: no weight_path")
                    out[mode, side] = cli_evaluate.main([
                        "--result_root", root, "--eval_type", mode,
                        "--with_elpips", "--allow_uncalibrated", "--device",
                        d, "--output_json", f"{tmp}/{mode}_{side}.json"])
                wall[mode, side] = time.perf_counter() - t0
        examples = cli_evaluate.collect_examples(root)
        imgs = [(cli_evaluate._load(e["gt"]), cli_evaluate._load(e["out"]))
                for e in examples]
        with warnings.catch_warnings():
            warnings.filterwarnings("ignore", message="elpips: no weight_path")
            metric = elpips_api.Metric(elpips_api.elpips_vgg()).to(dev)
    reg_c, reg_p = out["reg", "card"], out["reg", "cpu"]
    vid_c, vid_p = out["video", "card"], out["video", "cpu"]
    check(len(reg_c["per_example"]) == 4 and len(examples) == 4,
          "two examples and two video frames, all four scored")
    check(list(reg_c) == list(reg_p) and list(vid_c) == list(vid_p),
          "the card's and the CPU's JSON keys")
    check(reg_c["elpips_calibrated"] is False, "elpips_calibrated: false")
    worst = {"ssim": 0.0, "psnr": 0.0, "elpips": 0.0}
    for ec, ep in zip(reg_c["per_example"] + [reg_c],
                      reg_p["per_example"] + [reg_p]):
        for k in worst:
            key = k if k in ec else f"avg_{k}"
            check(math.isfinite(ec[key]), f"eval {key} finite")
            err = abs(ec[key] - ep[key])
            worst[k] = max(worst[k], err / abs(ep[key]) if k == "elpips"
                           else err)
    diff = max(abs(vid_c[k] - vid_p[k]) for k in (
        "avg_rgb_diff", "sd_rgb_diff", "avg_depth_diff", "sd_depth_diff"))
    ok = (worst["ssim"] <= EVAL_SSIM_TOL and worst["psnr"] <= EVAL_PSNR_TOL
          and worst["elpips"] <= EVAL_ELPIPS_TOL and diff <= EVAL_DIFF_TOL)
    print(f"evaluator card vs CPU over {len(examples)} examples and their "
          f"means: SSIM {worst['ssim']:.3e} (tol {EVAL_SSIM_TOL:.0e}), PSNR "
          f"{worst['psnr']:.3e} dB (tol {EVAL_PSNR_TOL:.0e}), E-LPIPS rel "
          f"{worst['elpips']:.3e} (tol {EVAL_ELPIPS_TOL:.0e}); temporal "
          f"diffs {diff:.3e} (tol {EVAL_DIFF_TOL:.0e}) "
          f"{'ok' if ok else 'FAIL'}")
    check(ok, "evaluator, card vs CPU")
    print(f"evaluator reg: avg ssim {reg_c['avg_ssim']:.4f} psnr "
          f"{reg_c['avg_psnr']:.3f} elpips {reg_c['avg_elpips']:.5f}; "
          f"video: rgb diff {vid_c['avg_rgb_diff']:.5f} depth diff "
          f"{vid_c['avg_depth_diff']:.5f}")
    per_ex = [time_ms(lambda: cli_evaluate.evaluate_one(
        gt, o, False, metric, dev), iters=5) for gt, o in imgs]
    plain = [time_ms(lambda: cli_evaluate.evaluate_one(gt, o, False, None,
                                                       dev), iters=5)
             for gt, o in imgs]
    print(f"evaluator ms per 640x320 example on the card (median of 5 "
          f"each; SSIM, PSNR, E-LPIPS at the seed-0 draw, level "
          f"{metric.draw(1, torch.Generator().manual_seed(0)).params.scale_level}): "
          f"{statistics.median(per_ex):.3f} ({statistics.median(plain):.3f} "
          f"without E-LPIPS); main's wall per example: reg card "
          f"{wall['reg', 'card'] / 4 * 1e3:.1f}, CPU "
          f"{wall['reg', 'cpu'] / 4 * 1e3:.1f}; the test CLI's two runs "
          f"{cli_wall:.2f} s {tag}")
    return launches


def probe_path(dev, tag):
    """Path 6: the lowering probes, `python -m
    matryodshka_tpu_torch.tools.probes` as its main(), the launch counts
    zeroed before and read after; then each probe kernel against its plain
    version on the tool's inputs (bit-exact for the rolls and K9's shift,
    TRIG_ULP for atan2/sqrt), and its times per launch (for several shifts,
    the mean of each shift's median). Returns the kernels' rows."""
    from matryodshka_tpu_torch.ops import probes
    from matryodshka_tpu_torch.tools import probes as probes_tool

    counters = {"trig": "trig_launches", "roll": "roll_launches",
                "roll_bf16": "roll_bf16_launches",
                "window_shift": "window_shift_launches"}
    torch.cuda.synchronize()
    for attr in counters.values():
        setattr(probes, attr, 0)
    check(probes_tool.main([]) == 0, "the probe tool")
    torch.cuda.synchronize()
    launches = {k: getattr(probes, a) for k, a in counters.items()}
    print(f"launches of the probe tool: {launches}")
    for k, n in launches.items():
        check(n > 0, f"probe kernel {k} was not launched by the probe tool")

    def roll_lib(x, s):
        return torch.roll(x, s, dims=-1)

    def shift_lib(x, s):
        return torch.roll(x, -s, dims=-1)

    xt = torch.from_numpy(np.random.RandomState(0).randn(8, 128).astype(
        np.float32)).to(dev)
    xr = torch.arange(8 * 256, dtype=torch.float32, device=dev).reshape(8, 256)
    xd = torch.from_numpy(np.random.RandomState(0).rand(
        8, probes_tool.DYNROLL_W).astype(np.float32)).to(dev)
    row = torch.from_numpy(np.random.RandomState(0).rand(
        probes_tool.SHIFT_C, 1, probes_tool.SHIFT_W).astype(np.float32)).to(dev)
    shared = ("matry_probe_roll in f32: K8b's f32 probe (one launch) and "
              "K8c's two shifts count together")
    # name, replaces, kernel, plain, library call, argument tuples, launches
    # in the tool's run, f32 operations per launch
    cases = [
        ("probe_trig_k8a", "tools/r3_hw_session.py:61 (pallas_call :79)",
         probes.trig, probes.trig_plain, None, [(xt,)], launches["trig"],
         OPS_TRIG * xt.numel()),
        ("probe_roll_k8b_f32", "tools/r4_hw_session.py:534 (pallas_call "
         ":549), f32", probes.roll, probes.roll_plain, roll_lib, [(xr, 1)],
         launches["roll"], 0),
        ("probe_roll_k8b_bf16", "tools/r4_hw_session.py:534 (pallas_call "
         ":549), bf16", probes.roll, probes.roll_plain, roll_lib,
         [(xr.bfloat16(), 1)], launches["roll_bf16"], 0),
        ("probe_roll_k8c", "tools/exp_dynroll.py:17 (pallas_call :33)",
         probes.roll, probes.roll_plain, roll_lib,
         [(xd, s) for s in probes_tool.DYNROLL_SHIFTS], launches["roll"], 0),
        ("probe_window_shift_k9", "tests/test_pallas_sweep.py:70 (inner "
         "kern, pallas_call :93)", probes.window_shift,
         probes.window_shift_plain, shift_lib,
         [(row, s) for s in probes_tool.SHIFTS], launches["window_shift"],
         0),
    ]
    kernel_pattern = {probes.trig: r"\btrig_kernel\b",
                      probes.roll: r"\broll_kernel\b",
                      probes.window_shift: r"\bwindow_shift_kernel\b"}
    rows = []
    for name, rep, kern, plain, lib, args, n, ops in cases:
        err = 0.0
        for a in args:
            got, want = kern(*a), plain(*a)
            err = max(err, (got.float() - want.float()).abs().max().item())
            if kern is probes.trig:
                ulp = probes.ulp_error(got, want)
                x64 = a[0].double()
                w64 = torch.atan2(x64, torch.sqrt(x64 * x64 + 1))
                err64, perr64 = ((t.double() - w64).abs().max().item()
                                 for t in (got, want))
                print(f"{name} {tuple(a[0].shape)} max_abs_err {err:.3e} = "
                      f"{ulp:g} ulp from the plain version (tol "
                      f"{probes_tool.TRIG_ULP} ulp); from f64: kernel "
                      f"{err64:.3e}, plain {perr64:.3e} "
                      f"{'ok' if ulp <= probes_tool.TRIG_ULP else 'FAIL'}")
                check(ulp <= probes_tool.TRIG_ULP, f"{name} ulp")
            else:
                check(torch.equal(got, want), f"{name} shift {a[1]} is not "
                                              f"bit-exact")
        if kern is not probes.trig:
            print(f"{name} {tuple(args[0][0].shape)} "
                  f"{str(args[0][0].dtype)[6:]} shifts "
                  f"{[a[1] for a in args]}: bit-exact ok")
        ms = [statistics.mean(time_ms(lambda f=f, a=a: f(*a)) for a in args)
              if f is not None else None for f in (kern, plain, lib)]
        # device time (profiler): the kernel's mean per launch the trace
        # kept, and per library call every device operation it makes, the
        # mean over the shifts
        _, total, seen = device_ms([functools.partial(kern, *a)
                                    for a in args], [1] * len(args),
                                   kernel_pattern[kern])
        dms = [total / seen, None if lib is None else device_ms(
            [functools.partial(lib, *a) for a in args], [1] * len(args),
            r".")[1] / len(args)]
        bms, bby = bound(2 * nbytes(args[0][0]), ops, F32_FLOPS)
        lib_txt = "null" if ms[2] is None else (
            f"{ms[2]:.4f} ms (device {dms[1]:.4f})")
        print(f"kernel {name:22s} {ms[0]:.4f} ms (device {dms[0]:.4f})  "
              f"plain {ms[1]:.4f} ms  library {lib_txt}  bound {bms:.3e} "
              f"ms ({bby}) per launch, {n} launches in the tool's run {tag}")
        r = {"name": name, "route": "cuda",
             "source": "matryodshka_tpu_torch/csrc/probes.cu",
             "replaces": rep, "launches": n, "max_abs_err": err,
             "ms": ms[0], "plain_ms": ms[1], "bound_ms": bms,
             "bound_by": bby, "library_ms": ms[2], "device_ms": dms[0],
             "library_device_ms": dms[1]}
        if lib is None:
            r["library_note"] = ("no single PyTorch call: atan2 and sqrt "
                                 "are two")
        if name in ("probe_roll_k8b_f32", "probe_roll_k8c"):
            r["launches_note"] = shared
        rows.append(r)
    return rows


def main() -> None:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port has no CPU route here",
              file=sys.stderr)
        sys.exit(2)
    card = nvidia_smi_line()
    tag = f"[{card}]"
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from matryodshka_tpu_torch import entry
    from matryodshka_tpu_torch.cli import test as cli_test
    from matryodshka_tpu_torch.geometry import render as render_lib
    from matryodshka_tpu_torch.models import msi as msi_lib
    from matryodshka_tpu_torch.ops import _build
    from matryodshka_tpu_torch.ops import conv as conv_ops
    from matryodshka_tpu_torch.ops import layernorm as ln_ops
    from matryodshka_tpu_torch.ops import render as render_ops
    from matryodshka_tpu_torch.ops import render_layers as rl_ops
    from matryodshka_tpu_torch.ops import sweep as sweep_ops
    from matryodshka_tpu_torch.ops.resample import resample_layers_uv

    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]} {tag}")

    # ---- build -----------------------------------------------------------
    t0 = time.perf_counter()
    so = _build.build()
    _build.lib()
    print(f"kernels built/loaded in {time.perf_counter() - t0:.2f} s: "
          f"{so.name}")
    log = so.with_suffix(".log")
    if log.exists():
        for line in log.read_text().splitlines():
            if "registers" in line or "spill" in line:
                print("  ptxas:", line.strip())
    kernel_build_report(so)

    # ---- flagship operands -------------------------------------------------
    cfg = entry.flagship_cfg()
    params = entry.make_params(cfg, seed=0, device=dev)
    batch = entry.synthetic_batch(cfg, 0, dev)
    rng = torch.Generator(device=dev).manual_seed(1234)
    h, w, p = cfg.height, cfg.width, cfg.num_msi_planes
    errs = {"sweep": 0.0, "conv": 0.0, "conv_coord": 0.0, "layernorm": 0.0,
            "render": 0.0, "render_depth": 0.0, "render_layers_k4": 0.0,
            "render_layers_k5": 0.0, "render_layers_k6": 0.0,
            "wrap_conv_k7a": 0.0, "wrap_conv_k7b": 0.0,
            "wrap_conv_k7c": 0.0, "wrap_conv_wgrad": 0.0}

    def gate(name, what, got, want, tol_abs):
        err = (got.float() - want.float()).abs().max().item()
        fin = bool(torch.isfinite(got.float()).all())
        print(f"{name:10s} {what:34s} max_abs_err {err:.3e} tol "
              f"{tol_abs:.3e} {'ok' if err <= tol_abs and fin else 'FAIL'}")
        check(fin and err <= tol_abs, f"{name} {what}")
        errs[name] = max(errs[name], err)
        return err

    # sweep: both eyes x 32 planes at 640x320, and at the re-render's
    # 4096x2048 (column tiles), each in its two halves: the kernel's
    # projection (its row-parameter instrument) against row_params in
    # float64, then the kernel, one launch, against the plain version fed
    # those row parameters (sweep_kernels).
    hrng = torch.Generator(device=dev).manual_seed(77)
    hres_images = [torch.rand((1, *HRES, 3), generator=hrng, device=dev)
                   for _ in range(2)]
    for what, ref_i, src_i in (
            (f"{h}x{w}", batch["ref_image"], batch["src_image"]),
            (f"{HRES[1]}x{HRES[0]}", *hres_images)):
        sweep_kernels(what, ref_i, src_i, params.psv_depths,
                      batch["intrinsics"], gate)
    vol = sweep_ops.sweep_volume(batch["ref_image"], batch["src_image"],
                                 params.psv_depths, batch["intrinsics"],
                                 torch.bfloat16)

    # conv + layer norm: every stage of unet_plan at ngf 64 on bf16 inputs
    # of the stage's shape. Kernel and plain version see the same rounded
    # operands, accumulate in f32 (in different orders) and round to bf16
    # once each, so an output may land one bf16 step apart where the two
    # sums straddle a rounding boundary: tolerance 2^-7 of the output's
    # largest magnitude, which is at least one bf16 step there.
    stage_inputs = {}
    for plan, st in zip(params.net.plan, params.stages):
        name, kind, _, cins, cout, ind, _, _ = plan
        x = (torch.rand((1, sum(cins), h // ind, w // ind), generator=rng,
                        device=dev) * 2 - 1).to(torch.bfloat16)
        if name == "conv1_1":
            x = vol
        stage_inputs[name] = x
        y = conv_ops.conv(x, st["w"], st["b"], **st["args"])
        yp = conv_ops.conv_plain(x, st["w"], st["b"], **st["args"])
        gate("conv", f"{name} {kind} {tuple(x.shape[1:])}->{cout}", y, yp,
             2.0 ** -7 * yp.float().abs().max().item())
        if "gamma" in st:
            # the LN+ReLU on this stage's output, bf16 (as the net runs it)
            # and f32: f64 partials against the plain version's two-pass
            # f32 mean/variance, 1e-5 of the output scale in f32, one bf16
            # step (2^-7 of it) in bf16; two launches bit-identical
            g = st["gamma"] * (1 + 0.1 * torch.randn(
                cout, generator=rng, device=dev))
            bt = 0.1 * torch.randn(cout, generator=rng, device=dev)
            for yd, rel in ((y, 2.0 ** -7), (y.float(), 1e-5)):
                form = ln_ops.plan_for(yd)
                zp = ln_ops.layer_norm_relu_plain(yd, g, bt)
                z = ln_ops.layer_norm_relu(yd, g, bt)
                gate("layernorm", f"{name} {tuple(y.shape[1:])} "
                     f"{str(yd.dtype)[6:]} {form[0]} ({form[1]} x "
                     f"{form[2]})", z, zp, rel * zp.float().abs().max().item())
                check(torch.equal(z, ln_ops.layer_norm_relu(yd, g, bt)),
                      f"layernorm {name} {yd.dtype}: two launches differ")
            del z, zp

    # the coord net's conv kernel mode: every stage of its plan at ngf 64,
    # on the wrap stages' inputs (same shapes), with the same tolerance.
    # Convs and downs read the coord channel (Cin + 1 weights) and pad with
    # zeros (downs SAME: 320x640 -> 160x320); deconvs pad with zeros.
    ccfg = entry.flagship_cfg(coord_net=True)
    cparams = entry.make_params(ccfg, seed=0, device=dev)
    for plan, st in zip(cparams.net.plan, cparams.stages):
        name, kind, _, _, cout, _, outd, _ = plan
        x = stage_inputs[name]
        y = conv_ops.conv(x, st["w"], st["b"], **st["args"])
        check(tuple(y.shape[2:]) == (h // outd, w // outd),
              f"coord {name} output {tuple(y.shape)}")
        yp = conv_ops.conv_plain(x, st["w"], st["b"], **st["args"])
        gate("conv_coord", f"{name} {kind} {tuple(x.shape[1:])}->{cout}"
             f"{' +coord' if 'coord' in st['args'] else ''}", y, yp,
             2.0 ** -7 * yp.float().abs().max().item())

    # render: translated and rotated target, bf16 volume, f32 prediction,
    # in K3's two halves: the kernel's projection (its uv instrument)
    # against intersect_sphere_uv in float64 (grids.lookup_error, printed
    # beside the plain float32 tables' own distance), then the kernel, one
    # launch, against the plain version fed those tables: the same taps,
    # the composite's f32 math in another order, plus early termination at
    # T < 1e-6: 1e-5 on values in [-1, 1].
    pred = torch.tanh(1.5 * torch.randn((1, 2 * p, h, w), generator=rng,
                                        device=dev))
    stack = random_stack(rng, p, h, w, dev)
    radii = params.msi_depths
    for what, rt, pos in (("translated (0.05, 0, 0)", torch.eye(4)[None],
                           (0.05, 0.0, 0.0)),
                          ("rotated 30 deg + (0.02, 0, 0)", rot_y(30, "cpu"),
                           (0.02, 0.0, 0.0))):
        rt, pos = rt.to(dev), torch.tensor([pos], device=dev)
        uv_gate(what, rt, pos, radii, h, w)
        u, v = render_ops.uv_project(rt, pos, radii, h, w)
        for name, depth in (("render", False), ("render_depth", True)):
            n = render_ops.launches + render_ops.depth_launches
            got = render_ops.render_blend(vol, pred, rt, pos, radii,
                                          depth=depth)
            check(render_ops.launches + render_ops.depth_launches == n + 1,
                  "render_blend is one launch")
            # K3's depth mode: the same composite of the constant p/P.
            gate(name, what, got,
                 render_ops.render_blend_plain(vol, pred, u, v, depth=depth),
                 1e-5)
        # K4 (back to front) and K6 (front to back, T < 1e-6), which make
        # the same lookups, on the layer stack in bf16 and f32, colours in
        # [-1, 1] and alphas in [0, 1]: every output mode against the
        # shell-streamed plain composite fed the uv instrument's tables
        # (layer_stack_gates).
        target = (rt, pos, radii)
        for name, ftb in (("render_layers_k4", False),
                          ("render_layers_k6", True)):
            for st in (stack, stack.float()):
                layer_stack_gates(gate, name, f"{what} {str(st.dtype)[6:]}",
                                  st, target, u, v, ftb)

    # ---- the slice: three requests through entry.forward -----------------
    mods = {"sweep": sweep_ops, "conv": conv_ops, "layernorm": ln_ops,
            "render": render_ops}
    batches = [entry.synthetic_batch(cfg, seed, dev, tgt_pos=pos)
               for seed, pos in REQUESTS]
    torch.cuda.synchronize()
    for m in mods.values():
        m.launches = 0
    sweep_ops.row_params_launches = render_ops.uv_launches = 0
    outs = [entry.forward(params, b) for b in batches]
    torch.cuda.synchronize()
    launches = {k: m.launches for k, m in mods.items()}
    instruments = (sweep_ops.row_params_launches, render_ops.uv_launches)
    print(f"launches over {len(batches)} requests: {launches}; instruments "
          f"(row params, uv) {instruments}")
    for k, n in launches.items():
        check(n > 0, f"kernel {k} was not launched on the main path")
    check(launches["sweep"] == launches["render"] == len(batches)
          and instruments == (0, 0),
          "one sweep and one render launch per frame, no instrument")

    # the stages' device operations per frame: one profiler trace each
    # (trace.trace_part, 10 calls after 2 warm-up; a sweep or render trace
    # whose kernel events differ from the counted launches is taken again)
    b0, rt0 = batches[0], torch.eye(4, device=dev)[None]
    with torch.no_grad():
        vq = msi_lib.sweep_stage(cfg, b0, params.psv_depths)
        pq = msi_lib.net_stage(params.stages, vq)
        for name, fn, want_ops, mod in (
                ("sweep", lambda: msi_lib.sweep_stage(cfg, b0,
                                                      params.psv_depths), 1,
                 sweep_ops),
                ("render", lambda: msi_lib.render_stage(
                    vq, pq, rt0, b0["tgt_pose"], params.msi_depths), 1,
                 render_ops),
                ("frame", lambda: entry.forward(params, b0), None, None)):
            wall, busy, idle, ops, by_name, counts = trace_counted(
                fn, mod and (lambda m=mod: m.launches))
            print(f"stage {name:6s} {ops:g} device ops/frame (trace: host "
                  f"wall {wall:.3f} ms, device busy {busy:.3f} ms, idle "
                  f"share {idle:.3f}) {tag}")
            if want_ops is not None and ops != want_ops:
                for op, n in counts.most_common():
                    print(f"  {n} x {op[:100]} ({by_name[op]:.1f} us)")
            check(want_ops is None or ops == want_ops,
                  f"the {name} stage is {want_ops} device operation")
    del vq, pq
    for (seed, pos), b, out in zip(REQUESTS, batches, outs):
        check(tuple(out.shape) == (1, h, w, 3), f"output shape {out.shape}")
        check(bool(torch.isfinite(out).all()), "non-finite output")
        plain = entry.forward_plain(params, b)
        ref = entry.forward_reference(params, b)
        err = (out - plain).abs()
        err_ref = (out - ref).abs()
        print(f"request seed {seed} tgt_pos {pos}: |bf16 kernels - f32 plain| "
              f"max {err.max().item():.3e} mean {err.mean().item():.3e} "
              f"(gate {E2E_TOL:.0e}); vs f32 reference semantics max "
              f"{err_ref.max().item():.3e} mean {err_ref.mean().item():.3e}")
        check(err.max().item() <= E2E_TOL, "slice vs all-plain f32 path")

    # ---- path 2: the test CLI, one request per colour scheme ---------------
    counted = {"sweep": sweep_ops, "conv": conv_ops, "layernorm": ln_ops,
               "render": render_ops, "render_layers": rl_ops}

    def reset_counts():
        torch.cuda.synchronize()
        for m in counted.values():
            m.launches = 0
        render_ops.depth_launches = 0
        rl_ops.ftb_launches = rl_ops.both_launches = 0
        render_lib.uv_builds = 0
        conv_ops.coord_launches = 0

    def read_counts():
        torch.cuda.synchronize()
        got = {k: m.launches for k, m in counted.items()}
        got["render_depth"] = render_ops.depth_launches
        got["render_layers_ftb"] = rl_ops.ftb_launches
        got["render_layers_both"] = rl_ops.both_launches
        got["uv_tables"] = render_lib.uv_builds
        got["conv_coord"] = conv_ops.coord_launches
        return got

    def gate_e2e(what, got, want):
        for k in ("output_image", "output_depth"):
            g, wnt = got[k], want[k]
            check(tuple(g.shape) == tuple(wnt.shape) and g.shape[-1] == 3,
                  f"{what} {k} shape {tuple(g.shape)}")
            check(bool(torch.isfinite(g).all()), f"{what} {k} non-finite")
            err = (g - wnt).abs()
            print(f"{what} {k}: |bf16 kernels - f32 plain| max "
                  f"{err.max().item():.3e} mean {err.mean().item():.3e} "
                  f"(gate {E2E_TOL:.0e})")
            check(err.max().item() <= E2E_TOL, f"{what} {k} vs all-plain")

    cli = []
    for scheme, seed, pos in CLI_REQUESTS:
        c = entry.flagship_cfg(which_color_pred=scheme)
        cli.append((scheme, c, entry.make_params(c, seed=0, device=dev),
                    entry.synthetic_batch(c, seed, dev, tgt_pos=pos)))
    cli_outputs = "tgt_image_blend_weights_alphas"
    reset_counts()
    cli_outs = [cli_test.build_infer_fn(c, prm, cli_outputs)(b)
                for _, c, prm, b in cli]
    cli_launches = read_counts()
    print(f"launches over the {len(cli)} test CLI requests: {cli_launches}")
    for k in ("sweep", "conv", "layernorm", "render", "render_depth",
              "render_layers"):
        check(cli_launches[k] > 0, f"kernel {k} was not launched on the "
                                   f"test CLI's low-res path")
    # one render call per request, image and depth: blend_psv's is K3's two
    # modes, each other scheme's one layer-stack launch; no lookup tables
    stacks = len(cli) - 1
    one_each = {"render": 1, "render_depth": 1, "render_layers": stacks,
                "render_layers_both": stacks, "render_layers_ftb": 0,
                "uv_tables": 0}
    check(all(cli_launches[k] == n for k, n in one_each.items()),
          f"the test CLI's render calls: want {one_each}")
    for (scheme, c, prm, b), o, (_, _, pos) in zip(cli, cli_outs,
                                                   CLI_REQUESTS):
        gate_e2e(f"cli {scheme:12s} tgt_pos {pos}", o,
                 cli_test.infer_plain(c, prm, b))

    # the ftb=True prepared render (K6), blend_bg request
    _, c1, prm1, b1 = cli[1]
    reset_counts()
    ftb_out = cli_test.build_infer_fn(c1, prm1, "tgt_image", ftb=True)(b1)
    ftb_launches = read_counts()
    print(f"launches of the ftb=True request: {ftb_launches}")
    check(ftb_launches["render_layers_ftb"] > 0,
          "the front-to-back layer-stack kernel was not launched")
    check(ftb_launches["render_layers_ftb"] == ftb_launches[
        "render_layers_both"] == 1 and ftb_launches["render_layers"] ==
        ftb_launches["uv_tables"] == 0,
        "the ftb request: one layer-stack launch, no lookup tables")
    gate_e2e("cli blend_bg ftb", ftb_out, cli_test.infer_plain(c1, prm1, b1))
    ftb_diff = (ftb_out["output_image"] - cli_outs[1]["output_image"]).abs()
    print(f"ftb vs back-to-front output_image max |diff| "
          f"{ftb_diff.max().item():.3e}")

    # ---- path 3: the 4096x2048 re-render from the blend_psv request -------
    hh, hw = HRES
    _, c0, _, bq = cli[0]
    check((c0.hres_height, c0.hres_width) == HRES, "hres default shape")
    eye = torch.eye(4, device=dev)[None]
    hargs = (*hres_images,
             cli_outs[0]["blend_weights"], cli_outs[0]["alphas"], eye, eye,
             eye, bq["intrinsics"], bq["tgt_pose"])
    hres_render = cli_test.build_hres_render_fn(c0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    mem0 = torch.cuda.memory_allocated()
    reset_counts()
    hres_rgb, hres_depth = hres_render(*hargs)
    hres_launches = read_counts()
    hres_peak = torch.cuda.max_memory_allocated()
    print(f"launches of the {hw}x{hh} re-render: {hres_launches}")
    print(f"hres peak device memory {hres_peak / 2**30:.3f} GiB "
          f"({(hres_peak - mem0) / 2**30:.3f} GiB above the "
          f"{mem0 / 2**30:.3f} GiB held before) {tag}")
    for k in ("sweep", "render_layers"):
        check(hres_launches[k] > 0, f"kernel {k} was not launched on the "
                                    f"high-res path")
    check(hres_launches["sweep"] == 1, "the high-res sweep is one launch")
    check(hres_launches["render_layers"] == hres_launches[
        "render_layers_both"] == 1 and hres_launches["uv_tables"] == 0,
        "the high-res render: one layer-stack launch, no lookup tables")
    rgb_p, depth_p = cli_test.hres_render_plain(
        c0, hargs[0], hargs[1], hargs[2], hargs[3], hargs[7], hargs[8])
    gate_e2e(f"hres {hw}x{hh}",
             {"output_image": hres_rgb, "output_depth": hres_depth},
             {"output_image": rgb_p, "output_depth": depth_p})
    del hres_rgb, hres_depth, rgb_p, depth_p
    # K5 at the shape the high-res path gives it: a bf16 stack of 32
    # 4096x2048 shells, the blend_psv request's target, the PSV depths as
    # radii; its projection against float64 (four shells at a time), then
    # every output mode against the plain version fed the instrument's
    # tables (layer_stack_gates).
    hstack = random_stack(rng, p, hh, hw, dev)
    htarget = (eye, bq["tgt_pose"], params.psv_depths)
    uv_gate(f"re-render target {tuple(bq['tgt_pose'][0].tolist())}",
            *htarget, hh, hw, shells=4)
    hu, hv = render_ops.uv_project(*htarget, hh, hw)
    layer_stack_gates(gate, "render_layers_k5", f"{hw}x{hh} bf16", hstack,
                      htarget, hu, hv, False)
    del hu, hv

    # ---- path 4: the coord net through entry.forward and the test CLI ------
    cbatches = [entry.synthetic_batch(ccfg, seed, dev, tgt_pos=pos)
                for seed, pos in REQUESTS[:2]]
    reset_counts()
    couts = [entry.forward(cparams, b) for b in cbatches]
    coord_launches = read_counts()
    print(f"launches over {len(cbatches)} coord-net requests: "
          f"{coord_launches}")
    for k in ("sweep", "conv_coord", "layernorm", "render"):
        check(coord_launches[k] > 0, f"kernel {k} was not launched on the "
                                     f"coord net's entry.forward path")
    for (seed, pos), b, out in zip(REQUESTS, cbatches, couts):
        check(tuple(out.shape) == (1, h, w, 3), f"coord output {out.shape}")
        check(bool(torch.isfinite(out).all()), "coord: non-finite output")
        err = (out - entry.forward_plain(cparams, b)).abs()
        err_ref = (out - entry.forward_reference(cparams, b)).abs()
        print(f"coord request seed {seed} tgt_pos {pos}: |bf16 kernels - f32 "
              f"plain| max {err.max().item():.3e} mean "
              f"{err.mean().item():.3e} (gate {E2E_TOL:.0e}); vs f32 "
              f"reference semantics max {err_ref.max().item():.3e} mean "
              f"{err_ref.mean().item():.3e}")
        check(err.max().item() <= E2E_TOL, "coord slice vs all-plain f32")
    cscheme, cseed, cpos = CLI_REQUESTS[0]
    cb_cli = entry.synthetic_batch(ccfg, cseed, dev, tgt_pos=cpos)
    reset_counts()
    ccli_out = cli_test.build_infer_fn(ccfg, cparams, cli_outputs)(cb_cli)
    ccli_launches = read_counts()
    print(f"launches of the coord-net test CLI request: {ccli_launches}")
    for k in ("sweep", "conv_coord", "layernorm", "render", "render_depth"):
        check(ccli_launches[k] > 0, f"kernel {k} was not launched on the "
                                    f"coord net's test CLI path")
    gate_e2e(f"cli coord {cscheme} tgt_pos {cpos}", ccli_out,
             cli_test.infer_plain(ccfg, cparams, cb_cli))

    # ---- path 5: training, the default ODS trainer -------------------------
    k7_ms = wrap_conv_kernels(dev, h, w, gate, errs, tag)
    train_launches = training_path(dev, tag, reset_counts, read_counts)
    nsteps = TRAIN_WARMUP + TRAIN_STEPS

    # ---- path 6: the lowering probes (K8, K9) ------------------------------
    probe_rows = probe_path(dev, tag)

    # ---- times (CUDA events, 2 warm-up, median of 10) ----------------------

    def stage_times(prm, bq):
        c = prm.cfg
        vq = msi_lib.sweep_stage(c, bq, prm.psv_depths)
        pq = msi_lib.net_stage(prm.stages, vq)
        return {
            "sweep": time_ms(lambda: msi_lib.sweep_stage(c, bq,
                                                         prm.psv_depths)),
            "net": time_ms(lambda: msi_lib.net_stage(prm.stages, vq)),
            "render": time_ms(lambda: msi_lib.render_stage(
                vq, pq, rt0, bq["tgt_pose"], prm.msi_depths)),
            "e2e": time_ms(lambda: entry.forward(prm, bq)),
            "e2e_plain_f32": time_ms(lambda: entry.forward_plain(prm, bq),
                                     iters=5),
        }, vq, pq

    stage_ms, vol0, pred0 = stage_times(params, b0)
    cstage_ms, _, _ = stage_times(cparams, cbatches[0])
    for k in stage_ms:
        print(f"stage {k:14s} wrap {stage_ms[k]:9.3f} ms  coord "
              f"{cstage_ms[k]:9.3f} ms {tag}")
    print(f"e2e {1000.0 / stage_ms['e2e']:.2f} frames/s (wrap), "
          f"{1000.0 / cstage_ms['e2e']:.2f} frames/s (coord) {tag}")

    kernel_ms, plain_ms, lib_ms, bounds = {}, {}, {}, {}
    device_only = {}  # key: (device ms, kernel launches) per frame, trace
    sweep_in = (b0["ref_image"], b0["src_image"], params.psv_depths,
                b0["intrinsics"])

    def sweep_kernel():
        return sweep_ops.sweep_volume(*sweep_in, torch.bfloat16)

    def sweep_plain():
        images, rowp = sweep_ops.sweep_inputs(
            msi_lib.preprocess_image(sweep_in[0]),
            msi_lib.preprocess_image(sweep_in[1]), *sweep_in[2:])
        return sweep_ops.ods_sweep_plain(images, rowp, torch.bfloat16)

    kernel_ms["sweep"] = time_ms(sweep_kernel)
    plain_ms["sweep"] = time_ms(sweep_plain)
    lib_ms["sweep"] = None
    out_elems = 2 * p * 3 * h * w
    bounds["sweep"] = bound(
        nbytes(*sweep_in) + 2 * out_elems,
        OPS_SWEEP * out_elems + OPS_ROW_PARAM * 2 * p * h, F32_FLOPS)

    def time_net(prm, key):
        """Per stage: the conv kernel, its plain version and the library
        conv (cuDNN in bf16 on the same operands, zero padded: F.conv2d on
        the input with the coord channel appended for coord stages,
        F.conv_transpose2d for deconvs); for the wrap net also the LN+ReLU
        kernel, its plain version and two library calls, F.group_norm
        with one group and F.layer_norm over (C, H, W) with gamma and beta
        expanded, each + relu_. Sums into kernel_ms / plain_ms / lib_ms
        (for the LN the faster call's sum) and the bounds."""
        kernel_ms[key] = plain_ms[key] = lib_ms[key] = 0.0
        with_ln = key == "conv"
        if with_ln:
            kernel_ms["layernorm"] = plain_ms["layernorm"] = 0.0
            ln_lib = {"group_norm": 0.0, "layer_norm": 0.0}
            ln_calls = []  # (layer, form, the kernel call)
        flops = cbytes = ln_bytes = ln_elems = 0.0
        for plan, st in zip(prm.net.plan, prm.stages):
            name, kind, _, cins, cout, _, _, rate = plan
            args = st["args"]
            x = stage_inputs[name]
            y = conv_ops.conv(x, st["w"], st["b"], **args)
            kt = time_ms(lambda: conv_ops.conv(x, st["w"], st["b"], **args))
            pt = time_ms(lambda: conv_ops.conv_plain(x, st["w"], st["b"],
                                                     **args))
            layer = getattr(prm.net, name)
            wb = layer.weight.detach().to(torch.bfloat16)
            bb = st["b"].to(torch.bfloat16)
            if kind == "deconv":
                wt = wb.flip(2, 3).transpose(0, 1).contiguous()
                lt = time_ms(lambda: torch.nn.functional.conv_transpose2d(
                    x, wt, bb, stride=2, padding=1))
            else:
                xl = (conv_ops.with_coord(x, args["coord"])
                      if "coord" in args else x)
                lo = conv_ops.pad_pair(args.get("pad", 0))
                xl = torch.nn.functional.pad(xl, (lo[0], lo[1], lo[0],
                                                  lo[1]))
                lt = time_ms(lambda: torch.nn.functional.conv2d(
                    xl, wb, bb, stride=args.get("stride", 1),
                    dilation=args.get("dil", 1)))
            kk = st["w"].shape[0] * st["w"].shape[1]   # taps x Cin' per px
            f = 2.0 * kk * cout * y.shape[2] * y.shape[3] / st["w"].shape[0]
            flops += f
            cbytes += nbytes(x, st["w"], st["b"], y) + (
                nbytes(args["coord"]) if "coord" in args else 0)
            npar = args.get("npar", 1)
            grid = conv_ops.out_size(x.shape[2], x.shape[3], args["kh"],
                                     args["kw"], args.get("stride", 1),
                                     args.get("dil", 1), args.get("pad", 0),
                                     npar)
            tile = conv_ops.tile_config(x.shape[0], npar, *grid, cout,
                                        x.dtype)
            line = (f"{key} {name:10s} kernel {kt:8.3f} ms "
                    f"({f / kt / 1e9:6.2f} TFLOP/s, tile {tile}) plain "
                    f"{pt:8.3f} ms library bf16 {lt:7.3f} ms")
            kernel_ms[key] += kt
            plain_ms[key] += pt
            lib_ms[key] += lt
            if with_ln and "gamma" in st:
                g, bt = st["gamma"], st["beta"]
                nt = time_ms(lambda: ln_ops.layer_norm_relu(y, g, bt))
                npt = time_ms(lambda: ln_ops.layer_norm_relu_plain(y, g, bt))
                gnt = time_ms(lambda: torch.relu_(
                    torch.nn.functional.group_norm(
                        y, 1, g.to(y.dtype), bt.to(y.dtype),
                        eps=ln_ops.EPS)))
                chw = y.shape[1:]
                ge = g.to(y.dtype)[:, None, None].expand(chw).contiguous()
                be = bt.to(y.dtype)[:, None, None].expand(chw).contiguous()
                lnt = time_ms(lambda: torch.relu_(
                    torch.nn.functional.layer_norm(y, chw, ge, be,
                                                   eps=ln_ops.EPS)))
                kernel_ms["layernorm"] += nt
                plain_ms["layernorm"] += npt
                ln_lib["group_norm"] += gnt
                ln_lib["layer_norm"] += lnt
                ln_bytes += 2 * nbytes(y) + nbytes(g, bt)
                ln_elems += y.numel()
                ln_calls.append((name, ln_ops.plan_for(y)[0],
                                 functools.partial(ln_ops.layer_norm_relu,
                                                   y, g, bt)))
                line += (f" | layernorm ({ln_calls[-1][1]}) kernel "
                         f"{nt:7.3f} ms plain "
                         f"{npt:7.3f} ms library group_norm {gnt:7.3f} ms "
                         f"layer_norm {lnt:7.3f} ms")
            print(line, tag)
        bounds[key] = bound(cbytes, flops, BF16_FLOPS)
        if with_ln:
            bounds["layernorm"] = bound(ln_bytes, OPS_LAYERNORM * ln_elems,
                                        F32_FLOPS)
            call = min(ln_lib, key=ln_lib.get)
            lib_ms["layernorm"] = ln_lib[call]
            # the 17 layers' kernels in one trace: the on-chip form is one
            # kernel a call, the two-pass form two
            per_layer, dev, nlaunch = device_ms(
                [fn for _, _, fn in ln_calls],
                [1 if form == "onchip" else 2 for _, form, _ in ln_calls],
                LN_KERNELS)
            for i, (name, form, _) in enumerate(ln_calls):
                us = (f"{per_layer[i] * 1e3:8.3f} us" if per_layer
                      else "not measured (the trace lost launches)")
                print(f"layernorm {name:10s} form {form:8s} device {us} "
                      f"(trace) {tag}")
            device_only["layernorm"] = (dev, nlaunch)
            print(f"net layernorm device time (trace) {dev:.4f} ms "
                  f"per frame in {nlaunch:g} kernel launches; CUDA "
                  f"events {kernel_ms['layernorm']:.4f} ms {tag}")
            print(f"net layernorm library: F.group_norm "
                  f"{ln_lib['group_norm']:.3f} ms, F.layer_norm "
                  f"{ln_lib['layer_norm']:.3f} ms; "
                  f"library_ms is F.{call} {tag}")
        print(f"net {key} total {flops / 1e9:.1f} GFLOP: kernel "
              f"{kernel_ms[key]:.3f} ms = "
              f"{flops / kernel_ms[key] / 1e9:.2f} TFLOP/s; library bf16 "
              f"{lib_ms[key]:.3f} ms; bound {bounds[key][0]:.3f} ms "
              f"({bounds[key][1]}) {tag}")

    time_net(params, "conv")
    time_net(cparams, "conv_coord")

    def visited(alpha, u, v):
        """Share of (pixel, shell) samples a front-to-back kernel takes on
        these inputs: alpha [P, H, W] in [0, 1] at source pixels, sampled
        at each shell's table; shell P-1 first, stop once T < EPS."""
        a = resample_layers_uv(alpha[..., None], u, v)[..., 0].flip(0)
        trans = torch.cumprod(1.0 - a, dim=0)
        reached = torch.cat([torch.ones_like(trans[:1]),
                             (trans[:-1] >= render_ops.EPS).float()])
        return reached.mean().item()

    target0 = (rt0, b0["tgt_pose"], params.msi_depths)
    u0, v0 = render_lib.uv_tables(*target0, h, w)
    for name, depth in (("render", False), ("render_depth", True)):
        kernel_ms[name] = time_ms(
            lambda: render_ops.render_blend(vol0, pred0, *target0,
                                            depth=depth))
        plain_ms[name] = time_ms(
            lambda: render_ops.render_blend_plain(
                vol0, pred0, *render_lib.uv_tables(*target0, h, w),
                depth=depth), iters=5)
    out3 = 3 * 4 * h * w
    frac = visited((pred0[0, p:] + 1.0) / 2.0, u0[0], v0[0])
    # no tables: the visited samples' taps, the output and the pose
    bounds["render"] = bound(
        frac * nbytes(vol0, pred0) + out3 + nbytes(*target0),
        frac * (OPS_RENDER_BLEND + OPS_SHELL_UV) * p * h * w, F32_FLOPS)
    bounds["render_depth"] = bound(
        frac * nbytes(pred0) / 2 + out3 + nbytes(*target0),
        frac * (OPS_RENDER_DEPTH + OPS_SHELL_UV) * p * h * w, F32_FLOPS)
    print(f"K3 front to back takes {frac:.4f} of the (pixel, shell) samples "
          f"on this request")
    # K1's and K3's device time from a profiler trace of 10 calls each
    # (CUDA events around one call time its launch path where that is the
    # longer); the mean over the launches the trace kept
    for k, fn, pat in (
            ("sweep", sweep_kernel, r"\bsweep_kernel\b"),
            ("render", functools.partial(render_ops.render_blend, vol0, pred0,
                                         *target0), r"\brender_kernel\b"),
            ("render_depth", functools.partial(
                render_ops.render_blend, vol0, pred0, *target0, depth=True),
             r"\brender_kernel\b")):
        _, total, seen = device_ms([fn], [1], pat)
        device_only[k] = (total / seen, 1)
        how = f"{total / seen:.4f} ms per launch ({seen:g} of 1 kept a call)"
        print(f"kernel {k} device time (trace) {how} {tag}")
    # K4 and K6 (640x320, the gates' bf16 stack, the first request's
    # target) and K5 (4096x2048, the re-render's target): the launch each
    # path makes, image and depth in one, by CUDA events and by profiler
    # device time, the device time of the two one-output launches beside
    # it. The plain version builds the tables (uv_tables) and renders
    # each output. Bounds count no tables: the stack once (its visited
    # share front to back), both outputs, the target, and per visited
    # sample the projection, the taps and the two composites.
    for name, st, tgt, ftb in (
            ("render_layers_k4", stack, target0, False),
            ("render_layers_k6", stack, target0, True),
            ("render_layers_k5", hstack, htarget, False)):
        sh, sw = st.shape[3:]
        big = sh > h
        fns = [functools.partial(rl_ops.render_layers_both, st, *tgt,
                                 ftb=ftb)] + [
            functools.partial(rl_ops.render_layers, st, *tgt, ftb=ftb,
                              depth=dp) for dp in (False, True)]
        kernel_ms[name] = time_ms(fns[0], iters=5 if big else 10)

        def plain(st=st, tgt=tgt, sh=sh, sw=sw):
            uu, vv = render_lib.uv_tables(*tgt, sh, sw)
            return (rl_ops.render_layers_plain(st, uu, vv),
                    rl_ops.render_layers_plain(st, uu, vv, depth=True))

        plain_ms[name] = time_ms(plain, iters=1 if big else 5,
                                 warmup=1 if big else 2)
        # one trace per mode: the mean over the launches each trace kept
        dev_ms = []
        for fn in fns:
            _, total, seen = device_ms([fn], [1], r"\brender_layers_kernel\b",
                                       calls=5 if big else 10)
            dev_ms.append(total / seen)
        device_only[name] = (dev_ms[0], 1)
        how = (f"both {dev_ms[0]:.4f} ms per launch; image alone "
               f"{dev_ms[1]:.4f}, depth alone {dev_ms[2]:.4f} (two launches "
               f"{dev_ms[1] + dev_ms[2]:.4f})")
        frac = 1.0
        if ftb:
            frac = visited(st[0, :, 3].float(), u0[0], v0[0])
            print(f"K6 front to back takes {frac:.4f} of the (pixel, shell) "
                  f"samples on this stack")
        bounds[name] = bound(
            frac * nbytes(st) + 2 * 3 * 4 * sh * sw + nbytes(*tgt),
            frac * (OPS_RENDER_BOTH + OPS_SHELL_UV) * p * sh * sw, F32_FLOPS)
        print(f"kernel {name} {sw}x{sh} device time (trace) {how}; CUDA "
              f"events {kernel_ms[name]:.4f} ms; bound "
              f"{bounds[name][0]:.4f} ms ({bounds[name][1]}) {tag}")
    for k in ("render", "render_depth", "render_layers_k4",
              "render_layers_k5", "render_layers_k6"):
        lib_ms[k] = None
    for k in kernel_ms:
        lib = "null" if lib_ms[k] is None else f"{lib_ms[k]:9.3f} ms"
        print(f"kernel {k:16s} {kernel_ms[k]:9.3f} ms  plain "
              f"{plain_ms[k]:9.3f} ms  library {lib}  bound "
              f"{bounds[k][0]:.4f} ms ({bounds[k][1]}) {tag}")

    # the test CLI, per scheme: stages and end to end (median of 5)
    for (scheme, c, prm, b) in cli:
        vq = msi_lib.sweep_stage(c, b, prm.psv_depths)
        pq = msi_lib.net_stage(prm.stages, vq)
        po = msi_lib.assemble_outputs_planar(c, vq, pq)
        infer = cli_test.build_infer_fn(c, prm, "tgt_image")
        ms = {
            "sweep": time_ms(lambda: msi_lib.sweep_stage(c, b,
                                                         prm.psv_depths),
                             iters=5),
            "net": time_ms(lambda: msi_lib.net_stage(prm.stages, vq),
                           iters=5),
            "assemble": time_ms(lambda: msi_lib.assemble_outputs_planar(
                c, vq, pq), iters=5),
            "render_depth": time_ms(
                lambda: msi_lib.render_view_and_depth_from_prepared(
                    po, eye, b["tgt_pose"], prm.msi_depths), iters=5),
            "e2e": time_ms(lambda: infer(b), iters=5),
            "e2e_plain_f32": time_ms(lambda: cli_test.infer_plain(c, prm, b),
                                     iters=3),
        }
        print(f"cli {scheme:12s} " + " ".join(
            f"{k} {t:.3f}" for k, t in ms.items()) + f" ms {tag}")
    del vq, pq, po
    finfer = cli_test.build_infer_fn(c1, prm1, "tgt_image", ftb=True)
    fms = time_ms(lambda: finfer(b1), iters=5)
    print(f"cli {cli[1][0]} ftb e2e {fms:.3f} ms {tag}")
    cinfer = cli_test.build_infer_fn(ccfg, cparams, "tgt_image")
    ce2e = time_ms(lambda: cinfer(cb_cli), iters=5)
    cplain = time_ms(lambda: cli_test.infer_plain(ccfg, cparams, cb_cli),
                     iters=3)
    print(f"cli coord {cscheme} e2e {ce2e:.3f} e2e_plain_f32 {cplain:.3f} "
          f"ms {tag}")

    # the 4096x2048 re-render: stages (each on the previous one's output)
    # and end to end (median of 3)
    hb, ha = hargs[2], hargs[3]
    hs = {"sweep": lambda: sweep_ops.sweep_volume(
        hargs[0], hargs[1], params.psv_depths, bq["intrinsics"],
        out_dtype=torch.bfloat16)}
    hs["upsample"] = lambda: msi_lib.upsample_align_corners_cf(
        torch.cat([hb, ha], dim=-1).permute(0, 3, 1, 2), hh, hw)
    hvol, hup = hs["sweep"](), hs["upsample"]()
    hs["assemble"] = lambda: msi_lib.assemble_hres_prepared(
        c0.which_color_pred, hup[:, :p], hup[:, p:], hvol,
        dtype=torch.bfloat16)
    hlayers = hs["assemble"]()
    hs["render_depth"] = lambda: render_lib.render_equirect_view_prepared_both(
        hlayers, eye, bq["tgt_pose"], params.psv_depths)
    hms = {k: time_ms(fn, iters=3) for k, fn in hs.items()}
    del hvol, hup, hlayers
    hms["e2e"] = time_ms(lambda: hres_render(*hargs), iters=3, warmup=1)
    print(f"hres {hw}x{hh} " + " ".join(
        f"{k} {t:.3f}" for k, t in hms.items()) + f" ms (render kernel "
          f"{kernel_ms['render_layers_k5']:.3f} ms for image and depth; "
          f"uv_tables builds {hres_launches['uv_tables']}; peak "
          f"{hres_peak / 2**30:.3f} GiB) {tag}")

    # launches on each kernel's path, and per frame (one request is one
    # frame; the re-render draws image and depth of one frame)
    launches["render_depth"] = cli_launches["render_depth"]
    launches["render_layers_k4"] = cli_launches["render_layers"]
    launches["render_layers_k5"] = hres_launches["render_layers"]
    launches["render_layers_k6"] = ftb_launches["render_layers_ftb"]
    launches["conv_coord"] = (coord_launches["conv_coord"]
                              + ccli_launches["conv_coord"])
    frames = {"sweep": len(batches), "conv": len(batches),
              "layernorm": len(batches), "render": len(batches),
              "render_depth": 1, "render_layers_k4": len(cli) - 1,
              "render_layers_k5": 1, "render_layers_k6": 1,
              "conv_coord": len(cbatches) + 1}
    sources = {
        "sweep": ("matryodshka_tpu_torch/csrc/sweep.cu",
                  "matryodshka_tpu/ops/pallas_sweep.py:230"),
        "conv": ("matryodshka_tpu_torch/csrc/conv.cu",
                 "matryodshka_tpu/ops/pallas_net.py:356"),
        "conv_coord": ("matryodshka_tpu_torch/csrc/conv.cu",
                       "matryodshka_tpu/ops/pallas_net.py:356 "
                       "(variant=coord)"),
        "layernorm": ("matryodshka_tpu_torch/csrc/layernorm.cu",
                      "matryodshka_tpu/ops/pallas_net.py:356"),
        "render": ("matryodshka_tpu_torch/csrc/render.cu",
                   "matryodshka_tpu/ops/pallas_render.py:920"),
        "render_depth": ("matryodshka_tpu_torch/csrc/render.cu",
                         "matryodshka_tpu/ops/pallas_render.py:920"),
        "render_layers_k4": ("matryodshka_tpu_torch/csrc/render_layers.cu",
                             "matryodshka_tpu/ops/pallas_render.py:295"),
        "render_layers_k5": ("matryodshka_tpu_torch/csrc/render_layers.cu",
                             "matryodshka_tpu/ops/pallas_render.py:132"),
        "render_layers_k6": ("matryodshka_tpu_torch/csrc/render_layers.cu",
                             "matryodshka_tpu/ops/pallas_render.py:694"),
    }
    rows = [{"name": k, "route": "cuda", "source": sources[k][0],
             "replaces": sources[k][1], "launches": launches[k],
             "launches_per_frame": launches[k] / frames[k],
             "max_abs_err": errs[k], "ms": kernel_ms[k],
             "plain_ms": plain_ms[k], "bound_ms": bounds[k][0],
             "bound_by": bounds[k][1], "library_ms": lib_ms[k]}
            for k in sources]
    for r in rows:
        if r["name"] in device_only:
            r["device_ms"], r["kernel_launches_per_frame"] = \
                device_only[r["name"]]
    # K7: times per training step, summed over the layers each form runs
    # (K7a: the seven dgrads; K7b: three forwards; K7c: five forwards and
    # their sums; wgrad: eight)
    k7_sources = {
        "wrap_conv_k7a": ("matryodshka_tpu_torch/csrc/conv.cu",
                          "matryodshka_tpu/ops/pallas_conv.py:56"),
        "wrap_conv_k7b": ("matryodshka_tpu_torch/csrc/conv.cu",
                          "matryodshka_tpu/ops/pallas_conv.py:159"),
        "wrap_conv_k7c": ("matryodshka_tpu_torch/csrc/conv.cu",
                          "matryodshka_tpu/ops/pallas_conv.py:272"),
        "wrap_conv_wgrad": ("matryodshka_tpu_torch/csrc/conv_wgrad.cu",
                            "matryodshka_tpu/ops/pallas_conv.py:56 (K7's "
                            "weight gradient; the TPU kernels have no "
                            "backward)"),
    }
    for k, (src, rep) in k7_sources.items():
        kt, pt, lt, (bms, bby) = k7_ms[k]
        print(f"kernel {k:16s} {kt:9.3f} ms  plain {pt:9.3f} ms  library "
              f"{lt:9.3f} ms  bound {bms:.4f} ms ({bby}) per step, "
              f"{train_launches[k] / nsteps:g} launches per step {tag}")
        rows.append({"name": k, "route": "cuda", "source": src,
                     "replaces": rep, "launches": train_launches[k],
                     "launches_per_step": train_launches[k] / nsteps,
                     "max_abs_err": errs[k], "ms": kt, "plain_ms": pt,
                     "bound_ms": bms, "bound_by": bby, "library_ms": lt})
    rows.extend(probe_rows)

    # ---- path 7: the E-LPIPS trainer (released recipe, then the wrap net) --
    # (after the profiler traces above: no trace follows these paths)
    elpips_training_path(dev, tag, reset_counts, read_counts)

    # ---- path 8: the evaluator on the coord net's test CLI outputs ---------
    evaluator_path(dev, tag, reset_counts, read_counts)

    print(json.dumps({"kernels": rows}))
    print(nvidia_smi_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
