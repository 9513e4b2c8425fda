"""Drive the PyTorch port's inference and training paths and its probe tool
once on an NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from matryodshka_tpu_torch/csrc, reports
the conv kernel's instantiations (ptxas registers, stack and spills; the
HGMMA and HMMA counts of each one's SASS: the bf16 conv and weight-
gradient instantiations must hold HGMMA, the weight gradient's no HMMA,
and none may spill), and
checks each kernel against its plain
PyTorch version at the shapes its path gives it, all at the full width
of the flagship configuration (640x320 ODS input, 32 planes per eye, 32
shells, ngf 64, bf16) with seeded random weights. The sweep and the two
renders (blend-fused and layer-stack), which make their own lookups, are
checked in two halves, also at 4096x2048 (the sweep and the layer-stack
render): their projection, through its instrument entry, against the
plain projection in float64 (the worst errors and the bound printed),
and the kernel against its plain version fed the instrument's tables,
the layer-stack render (on the interleaved stack [B, P, H, W, 4]) in each
output mode (image, depth, both in one launch), back to front and front
to back, bf16 and f32 stacks. The sweep's assembled mode
(csrc/sweep_assembled.cu, which writes the high-res re-render's stack) is
checked against its plain version at 4096x2048 for each colour rule,
whole and for a shell block, f32 within 1e-5 and bf16 within one bf16
step.
Then it drives fifteen paths, each with every launch count set to 0 just
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
   request's blend weights and alphas (one launch of the sweep's assembled
   mode, which writes the interleaved stack, and one layer-stack launch;
   no tables, no K1 volume; a profiler trace of one re-render lists its
   device operations, none an upsample or a stack-sized f32 copy);
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
9. the ods-temp train recipe (transform_inverse_reg: a second forward at
   a random jitter pose through the gather sweep, and 10 x the distance
   of its render to the plain one): the coord net on E-LPIPS for 8 steps,
   then the wrap net on the pixel loss for 3 (K1 once a step; K7 twice
   path 5's count), the step in parts, and one step's gradients against
   the all-plain f32 route at a fixed pose;
10. the test CLI's perspective windows and ODS-eye re-renders (psp,
   src_output_image, ref_output_image: gathers, as in the JAX package),
   each in two halves: its lookups against float64, and its gather and
   composite on the card against the CPU at the same lookups;
11. the net-only export (cli/export.py, --coord_net true --net_only true
   --platform cuda, bf16 and f32) and the port's consumer tool, which
   loads the .pt2 in a subprocess importing neither package; the loaded
   program against the eager plain net and against the kernel route;
12. the PP and RealEstate recipes (scripts/train/pp-wotemp-elpips-coord.sh,
   realestate-wotemp-elpips-coord.sh: coord net, E-LPIPS on random
   features) on the port's fixtures written at 640x320: cli/train.py for
   6 steps each (the gather sweeps, the coord net's PyTorch convs), the
   step in parts; the wrap net's PP pixel step for 3 (K7 at path 5's count
   a step); one test-CLI request each (the gather sweep, 18 conv launches
   in the coord mode, 17 of them with their inputs' layer norm fused, one
   launch of the MPI render kernel), its view against the all-plain f32
   route and its first conv (Cin' 193 and 196) against its plain version,
   its stages timed; then cli/evaluate.py on the two outputs; then the MPI
   render kernel at realestate-coord.mpi-video's shape against its plain
   version, timed beside its bound (mpi_render_row);
13. the rest of the trainer's options: the released recipe with src and
   ref supervision through cli/train.py, without and with the
   transform-inverse regularizer (one step against the all-plain f32
   route at a fixed draw and pose); the wrap net's pixel step with the
   4096x2048 target (hrestgt: K1 twice a step, once at 4096x2048; K7 at
   path 5's count; the step in parts and its peak memory; one step
   against the all-plain f32 route) and the coord net's E-LPIPS hrestgt
   step at a level-1 draw; remat_network on path 5's step (K7b and K7c
   twice path 5's count, the gradients against the step without it, the
   peak lower); bfloat16 parameters and Adam moments; the train CLI's
   --dry_run, --dry_run_inference (K1, the net's kernels, one layer-stack
   render for image and depth) and --profile_steps; use_pallas false (a
   test-CLI request and a train step with no kernel launch, against the
   default route);
14. the full-pipeline export (cli/export.py --net_only false, coord net,
   float32 and bfloat16, and bfloat16 with --with_preprocess and a seeded
   remap): the op matry::sweep_volume of the C++ op library
   (csrc/sweep_op.cpp, built beside the kernels) bit-equal to
   sweep_volume at full width, K1 once a call through it, each program
   against its eager function and the test CLI's kernel route, the
   consumer tool in subprocesses that load the op library and no module
   and count K1 once a call in a profiler trace; the smoothed net through
   entry.forward, wrap and coord (18 conv launches, 17 with the layer norm
   fused, the upsampling stages in the conv kernel's folded form, gated and timed
   beside the transposed form's), and its trainer for 3 steps (K7 at path
   5's count, one step against the all-plain routes); the 4096x2048
   re-render of blend_bg, blend_bg_psv and alpha_only (one assembled-sweep
   and one layer-stack launch each) against the plain composite, its ms
   and peak whole and in 4 shell blocks;
15. the GCN (--gcn true, icosphere subdiv 7: 163,842 vertices; its mesh
   generated unless cached, in a subprocess beside the kernels' build and
   finished before the first timed path, then loaded):
   the test CLI's request for blend_psv and blend_bg (one K1 launch, then
   K3's two modes or the prepared assembly and one layer-stack launch;
   each view and depth against the all-plain f32 route; the vertex sweep,
   the GCN forward and every stage timed) and the GCN trainer for 5 steps
   (K1 once a step; its parts and peak; one step against the all-plain
   f32 route); a one-rank NCCL process group through
   parallel/dp.make_dp_train_step and steps_per_call=3 on the default
   trainer, each against the single-device step; the 4096x2048 re-render
   in 4 shell blocks on the one card (per block one assembled-sweep launch
   over its planes and one launch of the layer-stack render's partial
   mode, then combine_partials) against the unsharded K5 render, and the
   partial mode
   against its plain version (partial_composite) at one block's shapes,
   bf16 and f32.
Each path's wall and the whole run's are printed.

Every output is gated against its all-plain float32 twin. Stages, kernels
and plain versions are timed with CUDA events (the conv layers with their
TFLOP/s and the tile each took; the sweep, the renders, the net's convs
with and without the fused layer norm and the probes also by profiler
device time), and beside each kernel the
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

import atexit
import concurrent.futures
import dataclasses
import functools
import itertools
import json
import math
import os
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
#: f32 operations per output element of the sweep (two vertical and one
#: horizontal lerp, 3 ops each); what the fused layer norm adds to the
#: convs: per output element of a producer the epilogue's sum and sum of
#: squares (an add and an FMA), per element a consumer reads
#: relu(a * y + b) (an FMA and a max).
OPS_SWEEP = 9
OPS_LN_STATS = 2
OPS_LN_APPLY = 2
#: The 18 convs and 17 layer-norm launches of one flagship frame before the
#: layer norm was fused, device ms (PERF.md section 6: the conv kernel's
#: sums and the layer norm's one-trace sum; NVIDIA H100 80GB HBM3, 700.00
#: W), printed beside this run's 18 fused stages; the two are compared
#: only within one call of tools/conv_ab.py.
PARENT_NET_MS = {"conv": (1.772, 0.245), "conv_coord": (1.874, 0.245)}
#: f32 operations per texel of the sweep's assembled mode, by colour rule:
#: per eye read three channels of OPS_SWEEP; the upsampled alpha's (and
#: blend weight's) horizontal lerp, 3 each, and its vertical one shared by
#: a tile's columns; the rule's blend, 3 a channel; blend_bg's three
#: upsampled background channels, 3 each.
OPS_ASSEMBLED = {"alpha_only": 3 * OPS_SWEEP + 3,
                 "blend_psv": 2 * 3 * OPS_SWEEP + 2 * 3 + 9,
                 "blend_bg": 3 * OPS_SWEEP + 2 * 3 + 9 + 9}
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
#: Path 9 (the ods-temp recipe): steps of the wrap net with the pixel loss
#: and the regularizer after the coord net's recipe (launch counts).
REG_WRAP_STEPS = 3
#: Path 10: a re-render's gather and composite on the card against the
#: CPU's at the same lookups and bf16 layers, on [0, 1] images. (The
#: lookups themselves are float32 on each device, whose atan2 and sin/cos
#: differ by an ulp: ~3e-5 px at 640 wide, ~1e-4 on these random layers,
#: so they are held to float64 within the noise bound instead.)
RERENDER_TOL = 1e-5
#: Path 12 (the PP and RealEstate recipes): steps of each recipe through
#: the train CLI, of the wrap net's PP pixel step (launch counts), and the
#: RealEstate fixture's frames, (10 - 1) * 10 + 1: the training loader
#: admits a clip that fits 10 frames at its largest stride, 10.
MPI_STEPS = 6
MPI_WRAP_STEPS = 3
MPI_RE_FRAMES = 91
#: Views a call of realestate-coord.mpi-video renders (its viewers).
MPI_CELL_BATCH = 4
#: Path 11: the loaded export against the eager plain net on the card
#: (bf16, bit-equal measured; float32 at tests/test_torch_net.py's f32
#: bound for two evaluations of the net: the exported graph's f32 convs
#: sum in another order, 1.7e-6 to 2.1e-6 measured, unsaved program too),
#: and the consumer tool's run of it, in another process, against the
#: loaded program (1.9e-6 measured in float32, bf16 bit-equal).
EXPORT_TOL = {"bfloat16": 1e-6, "float32": 5e-5}
CONSUMER_TOL = 1e-5
#: Path 13 (the rest of the trainer's options): steps of each train-CLI
#: run, of the hrestgt and bf16-parameter runs, and the timed repetitions
#: (the first a warm-up) of the step parts, the E-LPIPS hrestgt step and
#: the remat comparison.
OPT_CLI_STEPS = 6
OPT_STEPS = 3
OPT_REPS = 3
#: Path 13, use_pallas false against the default route: the share of
#: view values beyond E2E_TOL. The two routes' sweeps park different
#: far-shell pixels (the gather by the sign of an f32 discriminant that is
#: cancellation noise there, K1 by the analytic validity): under 1% of
#: pixels (PARITY.md), each a local error of up to a shell's colour.
PARK_SHARE = 1e-2
#: Path 14: steps of the smoothed wrap net's trainer (the first a warm-up),
#: and the upsampling stages of the U-Net, whose kernel times path 14
#: compares between the smoothed and the transposed form.
SMOOTH_STEPS = 3
UP_STAGES = ("conv6_1", "conv7_1", "conv8_1")
#: Path 15: the GCN at the reference's default icosphere subdivision (V =
#: 163,842), its trainer's steps through training/loop.train (the first a
#: warm-up), the data-parallel steps of the one-rank NCCL group (the
#: chained call's steps_per_call), the high-res re-render's shell blocks
#: on the one card, and the shells of the block the partial mode is gated
#: on alone.
GCN_SUBDIV = 7
GCN_STEPS = 5
DP_STEPS = 3
SHELL_BLOCKS = 4
BLOCK_SHELLS = 8
#: A device operation of the 4096x2048 re-render other than its two
#: kernels takes at most this long (ms): the image's deprocess and the
#: small copies take ~0.1 ms, and an f32 copy of a stack-sized tensor
#: (1 GB and more) would take over 0.6 ms at 3.35 TB/s.
RERENDER_OTHER_MS = 0.25
#: Path 15c: the one-rank data-parallel step against the single-device
#: step on the same batch from the same parameters: the same kernels on
#: the same inputs (the loss's forward is deterministic; the gather
#: render's backward adds with atomics): loss within DP_LOSS_TOL relative,
#: each gradient within relative L2 DP_GRAD_TOL; the chained call's losses
#: against three single steps' within DP_CHAIN_TOL relative (from the
#: second step the parameters differ by those atomics' noise).
DP_LOSS_TOL = 1e-5
DP_GRAD_TOL = 1e-3
DP_CHAIN_TOL = 1e-3


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


#: Kernels the build report lists (demangled names), and the bf16 kernels
#: with the tensor-core instruction each of their instantiations must hold:
#: the conv's and the weight gradient's wgmma (HGMMA); the weight gradient
#: must hold no mma.sync (HMMA) either.
REPORTED = r"conv_(wgmma|f32)_kernel|wgrad_(wgmma|f32)_kernel|" \
    r"wgrad_reduce|stats_fold"
#: Names of a layer-norm kernel of its own (the parent's csrc/layernorm.cu
#: ln_onchip, ln_stats, ln_apply): the build holds none since the layer
#: norm is fused into the conv kernel, and no trace of the net shows one.
LN_KERNEL_NAMES = r"\bln_(onchip|stats|apply)\b|layernorm"
TENSOR_CORE = {"conv_wgmma_kernel": "HGMMA", "wgrad_wgmma_kernel": "HGMMA"}
NO_HMMA = ("wgrad_wgmma_kernel",)


def kernel_build_report(so) -> None:
    """The conv and weight-gradient kernels' instantiations in the built
    library (conv_wgmma_kernel's with the fused layer norm's fold and
    transform): ptxas's registers and spills for each (from the build log,
    `-Xptxas -v`), and the tensor-core instructions in each one's SASS
    (`cuobjdump -sass`), HGMMA (wgmma) apart from HMMA (mma.sync). Fails
    if a bf16 instantiation lacks its instruction (conv_wgmma_kernel and
    wgrad_wgmma_kernel HGMMA) or spills, if a wgrad_wgmma_kernel
    instantiation holds any HMMA, or if the library holds a layer-norm
    kernel of its own (LN_KERNEL_NAMES)."""
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
            mma[fn] = {"HGMMA": 0, "HMMA": 0}
        elif fn:
            for op in ("HGMMA", "HMMA"):
                if re.search(rf"\b{op}\b", line):
                    mma[fn][op] += 1
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
        ops = mma.get(name, {"HGMMA": 0, "HMMA": 0})
        print(f"kernel build {nice}: {info.get('regs', '?')} registers, "
              f"stack frame {spill[0]} B, spill stores {spill[1]} B, spill "
              f"loads {spill[2]} B, {ops['HGMMA']} HGMMA and {ops['HMMA']} "
              f"HMMA in its SASS")
        for k, op in TENSOR_CORE.items():
            if k in nice:
                n_tc[k] += 1
                if ops[op] == 0:
                    missing.append(f"{nice} (no {op})")
                if k in NO_HMMA and ops["HMMA"]:
                    missing.append(f"{nice} ({ops['HMMA']} HMMA)")
                if spill[1:] != (0, 0):
                    spilled.append(nice)
    for k, n in n_tc.items():
        print(f"kernel build: {n} bf16 instantiations of {k} "
              f"({TENSOR_CORE[k]}); "
              f"{'ok' if n and not missing and not spilled else 'FAIL'}")
    ln = [n for n in short if re.search(LN_KERNEL_NAMES, n)]
    print(f"kernel build: {len(ln)} layer-norm kernels of their own "
          f"{'ok' if not ln else 'FAIL'}")
    check(not ln, f"the build holds layer-norm kernels: {ln}")
    check(all(n_tc.values()) and not missing,
          f"bf16 instantiations without their tensor-core instruction or "
          f"with mma.sync: {missing or n_tc}")
    check(not spilled, f"bf16 tensor-core instantiations spill: {spilled}")


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
#: The bf16 conv kernel, as the profiler names it.
CONV_KERNELS = r"\bconv_wgmma_kernel\b"
#: Cycles of the spin kernel (torch.cuda._sleep, "spin_kernel", ~10 ms)
#: that opens and closes each device_ms window, outside the calls it
#: counts. Without the spins the parent's per-layer traces of its layer
#: norm kept 169 of their 170 launches in every run, while a fresh process
#: keeps all 170: the profiler drops a device event at an edge of a
#: window (one whose timestamp falls outside the window it recorded on the
#: host), so the window's first and last kernels are spins, and its
#: counted launches lie well inside it.
SPIN_CYCLES = 20_000_000
SPIN_KERNEL = "spin_kernel"


def device_ms(fns, kernels, pattern: str, calls: int = 10):
    """Device ms per call of each of fns, from one torch.profiler trace of
    `calls` rounds of every fn in turn after 2 warm-up rounds: the kernels'
    own time, which CUDA events around a call shorter than its launch path
    do not see. fn i launches kernels[i] kernels matching pattern per call;
    on one stream they run in launch order, which assigns each to its fn.
    The window opens and closes with a spin kernel (SPIN_CYCLES), which
    no pattern counts. Returns
    (per-fn ms, or None for every fn if the trace lost a launch; total ms
    per round; launches per round). A trace that keeps another number of
    launches than the window made (none, now and then) is taken again, up
    to TRACE_TRIES times."""
    import re

    for _ in range(2):
        for fn in fns:
            fn()
    want = calls * sum(kernels)
    for i in range(TRACE_TRIES):
        spins, traced = _spin_window(fns, calls)
        events = sorted((e for e in traced if re.search(pattern, e[0])),
                        key=lambda e: e[1])
        if len(events) == want:
            break
        print(f"  device_ms trace {i + 1}/{TRACE_TRIES}: {len(events)} of "
              f"{want} launches matching {pattern}, {spins} of 2 spins; "
              f"taken again")
    check(bool(events), f"{TRACE_TRIES} traces hold no kernel matching "
                        f"{pattern}")
    total = sum(d for _, _, d in events) / 1e3 / calls
    per_fn = None
    if len(events) == want:
        per_fn = [0.0] * len(fns)
        durs = iter(d for _, _, d in events)
        for _ in range(calls):
            for i, k in enumerate(kernels):
                per_fn[i] += sum(next(durs) for _ in range(k)) / 1e3 / calls
    return per_fn, total, len(events) / calls


def _spin_window(fns, calls):
    """One torch.profiler trace of `calls` rounds of every fn in turn
    between two spin kernels: (spins kept, [(name, start us, duration
    us)] of the other device operations)."""
    import warnings

    from matryodshka_tpu_torch.trace import device_events
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", message=".*Profiler clears events")
        with torch.profiler.profile(activities=acts) as prof:
            torch.cuda._sleep(SPIN_CYCLES)
            for _ in range(calls):
                for fn in fns:
                    fn()
            torch.cuda._sleep(SPIN_CYCLES)
            torch.cuda.synchronize()
        traced = device_events(prof)
    return (sum(SPIN_KERNEL in e[0] for e in traced),
            [e for e in traced if SPIN_KERNEL not in e[0]])


def device_ops_per_call(fn, calls: int = 4):
    """Device operations (kernels, copies, sets) one call of fn runs, for a
    function whose launches are not known (a library call): from a trace
    of `calls` calls that kept both spins and a multiple of `calls`
    operations, up to TRACE_TRIES traces; None if none did."""
    for _ in range(2):
        fn()
    for _ in range(TRACE_TRIES):
        spins, events = _spin_window([fn], calls)
        if spins == 2 and events and len(events) % calls == 0:
            return len(events) // calls
    return None


def trace_counted(fn, counters=None):
    """trace.trace_part(fn), checked against the wrappers' launch counts
    where counters is given (counters() sums the counts of the kernels fn
    launches, each count one kernel). A trace whose events of the port's
    kernels (trace.PORT_KERNELS) per call differ from the launches one
    untraced call counts missed part of the window (the profiler now and
    then drops device events) and is taken again, up to TRACE_TRIES times,
    as is one whose spins trace_part lost TRIES times. Returns trace_part's
    tuple of the first complete trace."""
    from matryodshka_tpu_torch.trace import CALLS, port_kernels, trace_part
    launched = None
    if counters is not None:          # one call's launches
        before = counters()
        fn()
        torch.cuda.synchronize()
        launched = counters() - before
    for i in range(TRACE_TRIES):
        torch.cuda.synchronize()
        try:
            got = trace_part(fn)
        except RuntimeError as e:     # no window kept both spins
            print(f"  trace {i + 1}/{TRACE_TRIES}: {e}; taken again")
            continue
        if counters is None:
            return got
        traced = sum(n for n, _ in port_kernels(*got[4:]).values()) / CALLS
        if traced == launched:
            return got
        print(f"  trace {i + 1}/{TRACE_TRIES}: {traced:g} port kernel "
              f"events per call against {launched:g} launches counted; "
              f"taken again")
    check(False, f"{TRACE_TRIES} traces lost device events")


def rerender_trace(fn, what, tag, kernels=("assembled_kernel",
                                             "render_layers_kernel")):
    """One profiler trace of one high-res re-render (fn), between two spin
    kernels: its device operations printed by name and time. Fails unless
    each of `kernels` ran once, none of the operations is an upsample
    (upsample_bilinear2d) or K1's volume (sweep_kernel), and every other
    operation is short (RERENDER_OTHER_MS: no f32 copy of a stack-sized
    tensor). A trace that lost a spin or a kernel is taken again, up to
    TRACE_TRIES times."""
    import re
    for i in range(TRACE_TRIES):
        spins, events = _spin_window([fn], 1)
        ran = [sum(k in e[0] for e in events) for k in kernels]
        if spins == 2 and all(n >= 1 for n in ran):
            break
        print(f"  {what} trace {i + 1}/{TRACE_TRIES}: {spins} of 2 spins, "
              f"kernels {ran}; taken again")
    for name, _, dur in events:
        print(f"  {what} device op {dur / 1e3:9.4f} ms  {name[:100]}")
    busy = sum(d for _, _, d in events) / 1e3
    print(f"{what}: {len(events)} device operations, {busy:.4f} ms in "
          f"them {tag}")
    check(ran == [1] * len(kernels), f"{what}: each of {kernels} once, "
                                     f"traced {ran}")
    check(not any("upsample" in n or re.search(r"\bsweep_kernel\b", n)
                  for n, _, _ in events),
          f"{what}: no upsample and no K1 volume on the device")
    long_ops = [(n, d / 1e3) for n, _, d in events
                if not any(k in n for k in kernels)
                and d / 1e3 > RERENDER_OTHER_MS]
    check(not long_ops, f"{what}: other device operations over "
                        f"{RERENDER_OTHER_MS} ms (a stack-sized copy?): "
                        f"{long_ops}")


def rot_y(deg: float, device) -> torch.Tensor:
    a = math.radians(deg)
    rt = torch.eye(4, device=device)
    rt[0, 0], rt[0, 2], rt[2, 0], rt[2, 2] = (math.cos(a), math.sin(a),
                                              -math.sin(a), math.cos(a))
    return rt[None]


def random_stack(rng, p: int, h: int, w: int, dev) -> torch.Tensor:
    """A bf16 interleaved layer stack [1, P, H, W, 4]: colours uniform in
    [-1, 1], alphas in [0, 1]."""
    stack = torch.rand((1, p, h, w, 4), generator=rng, device=dev) * 2 - 1
    stack[..., 3] = torch.sigmoid(3.0 * stack[..., 3])
    return stack.to(torch.bfloat16)


def bf16_steps(got, want):
    """|got - want| in bf16 steps, elementwise, of two bf16 tensors: their
    bit patterns as ordered integers."""
    def ordered(x):
        i = x.view(torch.int16).to(torch.int32)
        return torch.where(i < 0, -(i & 0x7FFF), i)
    return (ordered(got) - ordered(want)).abs()


def assembled_gates(gate, what, ref, src, depths, intr, low, blocks):
    """The sweep's assembled mode (sweep_ops.sweep_assembled, one launch)
    against sweep_assembled_plain on the same inputs fed the kernel's own
    row parameters (sweep_row_params, K1's projection, which path 3's
    sweep gates hold to float64), for each colour rule and each (p0, p1)
    of blocks, f32 and bf16: the same taps, upsample and rule, each
    rounded once in f32 but in other orders (1e-5 on values in [-1, 1]);
    in bf16 both round the f32 stack once, so every value lies within one
    bf16 step, or, near 0, where a bf16 step is finer than the two f32
    sums' difference, within that f32 bound (the shares one step off and
    beyond it are printed). The plain version runs four shells at a time.
    Two launches are bit-identical. low: (alphas, blend, bg_rgb)
    [1, h, w, .] f32."""
    from matryodshka_tpu_torch.ops import sweep as sweep_ops
    for rule in sweep_ops.RULES:
        for p0, p1 in blocks:
            d = depths[p0:p1].contiguous()
            for dt in (torch.float32, torch.bfloat16):
                n = sweep_ops.assembled_launches
                got = sweep_ops.sweep_assembled(ref, src, d, intr, *low,
                                                rule=rule, p0=p0,
                                                out_dtype=dt)
                check(sweep_ops.assembled_launches == n + 1,
                      "sweep_assembled is one launch")
                check(torch.equal(got, sweep_ops.sweep_assembled(
                    ref, src, d, intr, *low, rule=rule, p0=p0,
                    out_dtype=dt)), f"assembled {rule}: two launches differ")
                errs, off, near0 = [], 0, 0
                for q in range(p0, p1, 4):
                    dq = depths[q:q + 4].contiguous()
                    want = sweep_ops.sweep_assembled_plain(
                        ref, src, dq, intr, *low, rule, q, dt,
                        sweep_ops.sweep_row_params(dq, intr, *ref.shape[1:3]))
                    mine = got[:, q - p0:q - p0 + 4]
                    check(bool(torch.isfinite(mine.float()).all()),
                          f"assembled {rule} finite")
                    if dt == torch.bfloat16:
                        steps = bf16_steps(mine, want)
                        small = (mine.float() - want.float()).abs() <= 1e-5
                        errs.append(torch.where(small, 0, steps).max())
                        off += int((steps == 1).sum())
                        near0 += int(((steps > 1) & small).sum())
                    else:
                        errs.append((mine - want).abs().max())
                    del want
                err = torch.stack(errs).max()
                tag = f"{what} {rule} shells {p0}..{p1 - 1}"
                if dt == torch.float32:
                    gate("sweep_assembled", f"{tag} f32", err,
                         torch.zeros(()), 1e-5)
                else:
                    ok = err.item() <= 1
                    print(f"sweep_assembled {tag} bf16: max "
                          f"{err.item():g} bf16 steps beyond 1e-5 (tol 1); "
                          f"{off / got.numel():.3e} of the values one step "
                          f"off, {near0 / got.numel():.3e} more near 0 "
                          f"within 1e-5 {'ok' if ok else 'FAIL'}")
                    check(ok, f"sweep_assembled {tag} bf16")
                del got


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


def fused_norm_gates(prm, key, stage_inputs, gate, gen, tag):
    """The conv kernel with its inputs' layer norm + ReLU fused, at the 17
    stages of one flagship net (prm) that read layer-normed inputs. Each
    source is made by its own stage's kernel (stats=True: its output and
    partials) on that stage's gate input (stage_inputs), and each source's
    gamma and beta are the stage's, perturbed from gen (gamma x (1 + 0.1
    N), beta + 0.1 N). In bf16 and in f32 (the f32 kernel, weights cast),
    the fused consumer is gated ("conv_ln") against conv_plain of
    layer_norm_relu_plain of each source: one bf16 step (2^-7 of the
    output's largest magnitude; both sides round the normalized input and
    the output once, the sums in other orders), 1e-5 of it in f32; two
    launches bit-identical. Then one profiler trace (device_ms) of every
    bf16 stage as the net runs it (norm and stats) and of the same conv
    alone on the same input: each stage's device us with and without the
    fusion. Returns {"stages": {name: (x, norm, st)} (bf16, the net's 18
    stages), "fused_ms", "alone_ms": per-stage device ms lists or None if
    the trace lost a launch}."""
    from matryodshka_tpu_torch.ops import conv as conv_ops
    stages = {}
    for dtype, rel in ((torch.bfloat16, 2.0 ** -7), (torch.float32, 1e-5)):
        outs = {}
        for plan, st in zip(prm.net.plan, prm.stages):
            if st["stats"]:
                n0 = conv_ops.stats_launches
                outs[plan[0]] = conv_ops.conv(
                    stage_inputs[plan[0]].to(dtype), st["w"].to(dtype),
                    st["b"], **st["args"], stats=True)
                check(conv_ops.stats_launches == n0 + 1,
                      f"{key} {plan[0]}: one launch with statistics")
        if dtype == torch.bfloat16:
            # where var = s2 / n - mean^2 cancels (tests/test_torch_conv_ln:
            # the fold's error grows with mean^2 / var)
            ratios = [(y.double().mean() ** 2 / y.double().var()).item()
                      for y, _ in outs.values()]
            print(f"conv_ln {key} mean^2 / var of the 17 normed outputs "
                  f"(seeded weights): {min(ratios):.3g} .. "
                  f"{max(ratios):.3g} {tag}")
        for plan, st in zip(prm.net.plan, prm.stages):
            name = plan[0]
            if st["norm"] is None:
                if dtype == torch.bfloat16:
                    stages[name] = (stage_inputs[name], None, st)
                continue
            ys = [outs[s][0] for s in st["srcs"]]
            x = ys[0] if len(ys) == 1 else torch.cat(ys, dim=1)
            norm = [conv_ops.Norm(
                outs[s][1],
                g * (1 + 0.1 * torch.randn(g.shape, generator=gen,
                                           device=g.device)),
                bt + 0.1 * torch.randn(bt.shape, generator=gen,
                                       device=bt.device))
                for s, (g, bt) in zip(st["srcs"], st["norm"])]
            wk = st["w"].to(dtype)
            n0 = conv_ops.norm_launches
            got = conv_ops.conv(x, wk, st["b"], **st["args"], norm=norm)
            check(conv_ops.norm_launches == n0 + 1,
                  f"{key} {name}: one launch with the layer norm fused")
            want = conv_ops.conv_plain(conv_ops.normalize_plain(x, norm), wk,
                                       st["b"], **st["args"])
            gate("conv_ln", f"{key} {name} {tuple(x.shape[1:])} "
                 f"{str(dtype)[6:]}", got, want,
                 rel * want.float().abs().max().item())
            check(torch.equal(got, conv_ops.conv(x, wk, st["b"],
                                                 **st["args"], norm=norm)),
                  f"conv_ln {key} {name} {dtype}: two launches differ")
            if dtype == torch.bfloat16:
                # the main path's form: x channels-last, read by ldmatrix,
                # the output in the layout the net gives it
                xc = x.contiguous(memory_format=torch.channels_last)
                fmt = st["memory_format"]
                n0 = conv_ops.cl_launches
                got_cl = conv_ops.conv(xc, wk, st["b"], **st["args"],
                                       norm=norm, memory_format=fmt)
                check(conv_ops.cl_launches == n0 + 1
                      and got_cl.is_contiguous(memory_format=fmt),
                      f"{key} {name}: one launch reading a channels-last "
                      f"window, its output {fmt}")
                gate("conv_ln", f"{key} {name} {tuple(x.shape[1:])} "
                     f"bfloat16 channels-last", got_cl, want,
                     rel * want.float().abs().max().item())
                check(torch.equal(got_cl, got),
                      f"conv_ln {key} {name}: the channels-last launch "
                      f"differs from the NCHW launch")
                stages[name] = (xc, norm, st)
        del outs
    fns = []
    for name, (x, norm, st) in stages.items():
        xn = x.contiguous()
        fns.append(functools.partial(conv_ops.conv, x, st["w"], st["b"],
                                     **st["args"], norm=norm,
                                     stats=st["stats"],
                                     memory_format=st["memory_format"]))
        fns.append(functools.partial(conv_ops.conv, xn, st["w"], st["b"],
                                     **st["args"], norm=norm,
                                     stats=st["stats"]))
        fns.append(functools.partial(conv_ops.conv, xn, st["w"], st["b"],
                                     **st["args"]))
    per, _, _ = device_ms(fns, [1] * len(fns), CONV_KERNELS)
    net_ms = per[0::3] if per else None
    fused_ms = per[1::3] if per else None
    alone_ms = per[2::3] if per else None
    for i, name in enumerate(stages):
        txt = ("not measured (the trace lost launches)" if per is None else
               f"as the net runs it {net_ms[i] * 1e3:8.3f} us; NCHW: fused "
               f"{fused_ms[i] * 1e3:8.3f} us, conv alone "
               f"{alone_ms[i] * 1e3:8.3f} us, added "
               f"{(fused_ms[i] - alone_ms[i]) * 1e3:8.3f} us")
        print(f"conv_ln {key:10s} {name:10s} device {txt} (trace) {tag}")
    if per:
        print(f"conv_ln {key} 18 stages device: as the net runs them "
              f"{sum(net_ms):.4f} ms; NCHW: fused {sum(fused_ms):.4f} "
              f"ms, conv alone {sum(alone_ms):.4f} ms, the layer norm's "
              f"added {sum(fused_ms) - sum(alone_ms):.4f} ms {tag}")
    return {"stages": stages, "net_ms": net_ms, "fused_ms": fused_ms,
            "alone_ms": alone_ms}


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
    versions and cuDNN bf16 on the same work; then each form's device time
    per layer from one profiler trace of its calls (device_ms: the
    kernels alone, without the wrapper's weight packing and allocations),
    and cuDNN's from one trace of its calls, device time against device
    time. Returns per-step sums {key: (ms, plain_ms, library_ms, bound,
    device_ms, library_device_ms)}, a device time None where its trace
    lost operations."""
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

    # each form's calls of the step, (layer, kernel fn, CUDA events ms,
    # library fn, its CUDA events ms), for the traces after the loop
    calls = {k: [] for k in sums}

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
        lib_fwd_fn = functools.partial(F.conv2d, xp, wb, bb)
        lib_fwd = time_ms(lib_fwd_fn)
        if cin >= 160:
            fwd = functools.partial(wc.conv3x3_ln_stats, x, wt, bias)
            kt = time_ms(fwd)
            pt = time_ms(lambda: wc.conv3x3_ln_stats_plain(x, wt, bias))
            add("wrap_conv_k7c", kt, pt, lib_fwd,
                nbytes(x, wt, bias, y) + 16, flops)
            calls["wrap_conv_k7c"].append((name, fwd, kt, lib_fwd_fn,
                                           lib_fwd))
        else:
            fwd = functools.partial(wc.conv3x3_wrap_dma, x, wt, bias)
            kt = time_ms(fwd)
            pt = time_ms(lambda: wc.conv3x3_wrap_dma_plain(x, wt, bias))
            add("wrap_conv_k7b", kt, pt, lib_fwd, nbytes(x, wt, bias, y),
                flops)
            calls["wrap_conv_k7b"].append((name, fwd, kt, lib_fwd_fn,
                                           lib_fwd))
        line = (f"{name:8s} fwd ({'K7c' if cin >= 160 else 'K7b'}) kernel "
                f"{kt:7.3f} ms ({flops / kt / 1e9:6.2f} TFLOP/s, tile "
                f"{conv_tile(x, cout, kh=3, kw=3, pad=1)}) plain "
                f"{pt:7.3f} library bf16 {lib_fwd:7.3f}")
        if name != "conv1_1":
            dgrad = functools.partial(wc.conv3x3_wrap, gy, wadj)
            dt = time_ms(dgrad)
            dpt = time_ms(lambda: wc.conv3x3_wrap_plain(gy, wadj))
            lib_dgrad = functools.partial(torch.nn.grad.conv2d_input,
                                          xp.shape, wb, gy)
            dlt = time_ms(lib_dgrad)
            add("wrap_conv_k7a", dt, dpt, dlt,
                nbytes(gy, wt) + 4 * x.numel(), flops)
            calls["wrap_conv_k7a"].append((name, dgrad, dt, lib_dgrad,
                                           dlt))
            line += (f" | dgrad kernel {dt:7.3f} ({flops / dt / 1e9:6.2f} "
                     f"TFLOP/s, tile {conv_tile(gy, cin, kh=3, kw=3, pad=1)})"
                     f" plain {dpt:7.3f} library {dlt:7.3f}")
        wgrad = functools.partial(wc.conv3x3_wrap_wgrad, gy, x)
        gt = time_ms(wgrad)
        gpt = time_ms(lambda: wc.conv3x3_wrap_wgrad_plain(gy, x))
        lib_wgrad = functools.partial(torch.nn.grad.conv2d_weight, xp,
                                      wt.shape, gy)
        glt = time_ms(lib_wgrad)
        add("wrap_conv_wgrad", gt, gpt, glt, nbytes(gy, x, dw, db),
            flops + 2.0 * cout * hh * ww)
        calls["wrap_conv_wgrad"].append((name, wgrad, gt, lib_wgrad, glt))
        plan = wc.wgrad_plan(1, hh, ww, cout, cin,
                             wc._sm_count(dev.index or 0))
        part_mb = plan.splits * plan.tiles * wc.WGRAD_TILE_ENTRIES * 4 / 1e6
        print(f"{line} | wgrad kernel {gt:7.3f} ({flops / gt / 1e9:6.2f} "
              f"TFLOP/s; {plan.tiles} tiles x {plan.splits} splits of "
              f"{plan.chunk} k-steps of {plan.kp} pixels, "
              f"{'TMA' if plan.tma else 'gathered'}, f32 partials "
              f"{part_mb:.1f} MB written and read, folded in the launch) "
              f"plain {gpt:7.3f} library {glt:7.3f} ms {tag}")
    # device time of each form's calls (one trace a form; the forms run
    # conv_wgmma_kernel, K7c also stats_fold, wgrad wgrad_wgmma_kernel)
    patterns = {"wrap_conv_k7a": (r"\bconv_wgmma_kernel\b", 1),
                "wrap_conv_k7b": (r"\bconv_wgmma_kernel\b", 1),
                "wrap_conv_k7c": (r"\b(conv_wgmma_kernel|stats_fold)\b", 2),
                "wrap_conv_wgrad": (r"\bwgrad_wgmma_kernel\b", 1)}
    # cuDNN's calls likewise, each call's operations counted from a trace
    # of its own (they differ by layer and by algorithm)
    lost = "not measured (the trace lost operations)"

    def fmt(v):
        return lost if v is None else f"{v:.4f} ms"

    dev_sum, lib_sum = {}, {}
    for key, (pat, n) in patterns.items():
        per, _, _ = device_ms([c[1] for c in calls[key]],
                              [n] * len(calls[key]), pat)
        lib_fns = [c[3] for c in calls[key]]
        ops = [device_ops_per_call(fn) for fn in lib_fns]
        lper = (device_ms(lib_fns, ops, r".")[0] if None not in ops
                else None)
        dev_sum[key] = sum(per) if per else None
        lib_sum[key] = sum(lper) if lper else None
        for i, (name, _, ev, _, lev) in enumerate(calls[key]):
            kd = per[i] if per else None
            ld = lper[i] if lper else None
            ratio = (f", kernel / library device {kd / ld:.2f}x"
                     if kd is not None and ld is not None else "")
            print(f"{key} {name:8s} device {fmt(kd)} (trace), CUDA events "
                  f"{ev:.4f} ms a call; library device {fmt(ld)} "
                  f"({ops[i]} operations a call), CUDA events {lev:.4f} "
                  f"ms{ratio} {tag}")
        ratio = (f"; kernel / library: device {dev_sum[key] / lib_sum[key]:.2f}x"
                 if dev_sum[key] is not None and lib_sum[key] is not None
                 else "")
        print(f"{key} per step: device {fmt(dev_sum[key])} (trace), CUDA "
              f"events {sums[key][0]:.4f} ms; library device "
              f"{fmt(lib_sum[key])}, CUDA events {sums[key][2]:.4f} ms; "
              f"kernel / library: events {sums[key][0] / sums[key][2]:.2f}x"
              f"{ratio} {tag}")
    return {k: (v[0], v[1], v[2], bound(v[3], v[4], BF16_FLOPS),
                dev_sum[k], lib_sum[k]) for k, v in sums.items()}


def run_train_loop(tcfg, dev, reset_counts, read_counts, elpips, nsteps,
                   np_batches=None):
    """tcfg's trainer through training/loop.train for nsteps steps on one
    repeated in-memory batch (or the numpy batches np_batches gives), with
    E-LPIPS `elpips` (None for the pixel loss) and the metrics records
    stamped with its calibration; the launch counts (K7's too) zeroed
    before and read after. Returns (state, launches, CUDA events per step,
    metrics records, peak bytes, bytes held before)."""
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
        if np_batches is None:
            np_batches = itertools.repeat(training_batch(tcfg))
        step_fn = step_lib.make_train_step(tcfg, tstate.net, elpips=elpips,
                                           gcn_inputs=tstate.gcn_inputs)
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
        batches = device_prefetch(np_batches, size=2, device=dev)
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
    k7 = sum(train_launches[k] for k in ("wrap_conv_k7a", "wrap_conv_k7b",
                                         "wrap_conv_k7c"))
    check(train_launches["conv_wgmma"] == k7,
          f"every K7a/b/c launch of the trainer was the wgmma kernel: "
          f"{train_launches['conv_wgmma']} of {k7}")
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
               loss_tol=TRAIN_LOSS_TOL, jitter_pose=None):
    """One step from net's parameters: the kernel route (net as the
    trainer runs it, bf16) against the all-plain f32 route, with the
    all-plain bf16 route (no kernel of the port) as the measure of what
    bf16 alone costs. The loss within loss_tol relative of plain f32 (None:
    within max(TRAIN_LOSS_TOL, TRAIN_GRAD_MARGIN x the plain bf16 route's
    distance)), each parameter's gradient within relative L2
    max(TRAIN_GRAD_TOL, TRAIN_GRAD_MARGIN x the plain bf16 route's).
    elpips: the routes' shared E-LPIPS (with one fixed draw); jitter_pose:
    the regularizer's pose, the same for the three routes (whose jittered
    forward is the gather sweep in each)."""
    from matryodshka_tpu_torch.models import msi as msi_lib
    from matryodshka_tpu_torch.models.unet import MSIUNet
    from matryodshka_tpu_torch.ops import sweep as sweep_ops
    from matryodshka_tpu_torch.training import step as step_lib

    def plain_net(dtype):
        net_ = MSIUNet(tcfg.num_net_inputs(), tcfg.num_net_outputs(),
                       tcfg.ngf, dtype=dtype, variant=tcfg.net_variant,
                       smoothed=tcfg.smoothed).to(dev)
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
        loss_r, _ = step_lib.make_loss_fn(tcfg, net_, sweep, elpips)(
            tbatch, jitter_pose=jitter_pose)
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
    E-LPIPS part of a step (forward and input gradient on the first step's
    render) at each scale level, both swaps; the card's distance and input
    gradient against the CPU's at fixed draws (ELPIPS_LEVELS, both swaps);
    one step's gradients against the all-plain f32 route (route_gate)."""
    import warnings

    from matryodshka_tpu_torch import entry
    from matryodshka_tpu_torch.losses.elpips import api as elpips_api
    from matryodshka_tpu_torch.models import msi as msi_lib
    from matryodshka_tpu_torch.training import state as state_lib
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

    # the metric's inputs as the first step gives them: the [-1, 1] render
    # of the seeded net and the preprocessed target. (Not the trained
    # net's: cuDNN's weight gradients are not bit-reproducible, so its
    # render moves by an ulp between runs, and where a pre-activation of
    # the metric's VGG sits that close to 0 the card's and the CPU's ReLUs
    # take other sides: the input gradients' distance then jumps between
    # runs of one tree, 2.1e-6 to 1.0e-3 at level 8.)
    tbatch = {k: torch.from_numpy(v).to(dev)
              for k, v in training_batch(tcfg).items()}
    loss_fn = step_lib.make_loss_fn(tcfg, tstate.net, elpips=metric)
    net0 = state_lib.init_state(tcfg, 0, dev).net
    with torch.no_grad():
        vol = loss_fn.sweep(tbatch)
        pred = loss_fn.render(vol, net0(vol), tbatch)["output_image"]
    tgt = msi_lib.preprocess_image(tbatch["tgt_image"])
    del vol, net0

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


def reg_training_path(dev, tag, reset_counts, read_counts, k7_per_step):
    """Path 9: the ods-temp recipe (scripts/train/ods-temp-elpips-coord.sh:
    which_loss=elpips, the coord net, transform_inverse_reg, random
    E-LPIPS features) for TRAIN_WARMUP + TRAIN_STEPS steps through
    training/loop.train, then the wrap net with the pixel loss and the
    regularizer for REG_WRAP_STEPS, each with the launch counts zeroed and
    read: K1 once a step (the unjittered forward), the gather sweep once
    (the jittered one), each K7 form twice path 5's count a step
    (k7_per_step). The step's median and peak memory; the step in parts at
    one level-1 draw and one fixed pose; one step's loss and gradients
    against the all-plain f32 route at that draw and pose."""
    import warnings

    from matryodshka_tpu_torch import entry
    from matryodshka_tpu_torch.geometry import cameras
    from matryodshka_tpu_torch.models import msi as msi_lib
    from matryodshka_tpu_torch.training import step as step_lib

    nsteps = TRAIN_WARMUP + TRAIN_STEPS
    tcfg = entry.flagship_cfg(which_loss="elpips", coord_net=True,
                              transform_inverse_reg=True)
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", message="elpips: no weight_path")
        metric = step_lib.build_elpips(tcfg, dev)
    tstate, launches, events, records, peak, mem0 = run_train_loop(
        tcfg, dev, reset_counts, read_counts, metric, nsteps)
    print(f"launches over {nsteps} ods-temp training steps (coord net, "
          f"E-LPIPS, transform_inverse_reg): {launches}")
    check(tstate.step == nsteps and len(records) == nsteps,
          f"ods-temp training ran {tstate.step} steps")
    check(launches["sweep"] == nsteps, "K1 once a step (the unjittered "
                                       "forward) on the ods-temp path")
    check(launches["gather_sweep"] == nsteps, "one gather sweep a step (the "
                                              "jittered forward)")
    losses = [(r["total_loss"], r["reconstruction_loss"],
               r["enforcement_loss"]) for r in records]
    check(all(math.isfinite(v) for t in losses for v in t)
          and all(t[2] > 0 for t in losses), "ods-temp losses finite, "
                                             "enforcement > 0")
    check(all(r.get("elpips_calibrated") is False for r in records),
          "every ods-temp record says elpips_calibrated: false")
    step_ms = [s.elapsed_time(e) for s, e in events]
    step_med = statistics.median(step_ms[TRAIN_WARMUP:])
    print(f"reg train step {step_med:.3f} ms (median of {TRAIN_STEPS} after "
          f"{TRAIN_WARMUP} warm-up; ods-temp recipe: coord net, E-LPIPS, "
          f"transform_inverse_reg, 640x320, 32+32 planes, ngf 64, bf16, "
          f"batch 1), peak device memory {peak / 2**30:.3f} GiB "
          f"({(peak - mem0) / 2**30:.3f} GiB above the {mem0 / 2**30:.3f} "
          f"GiB held before) {tag}")
    print("reg train steps ms: " + " ".join(f"{t:.3f}" for t in step_ms))
    print("reg train losses (total, reconstruction, enforcement): "
          + " ".join(f"({a:.4f},{b:.4f},{c:.5f})" for a, b, c in losses))

    # where the step's time goes, at one level-1 draw and one pose: the
    # step in parts, CUDA events between
    tbatch = {k: torch.from_numpy(v).to(dev)
              for k, v in training_batch(tcfg).items()}
    loss_fn = step_lib.make_loss_fn(tcfg, tstate.net, elpips=metric)
    draw = metric.draw(1, torch.Generator().manual_seed(5), scale=1)
    pose = cameras.random_jitter_pose(torch.Generator().manual_seed(9),
                                      device=dev)
    tgt = msi_lib.preprocess_image(tbatch["tgt_image"])
    net = tstate.net
    steps = [
        ("sweep", lambda t: loss_fn.sweep(tbatch)),
        ("sweep_jitter_gather", lambda t: loss_fn.sweep_jitter(tbatch,
                                                               pose)),
        ("net_forward", lambda t: net(t["sweep"])),
        ("net_forward_jitter", lambda t: net(t["sweep_jitter_gather"])),
        ("assemble_render", lambda t: loss_fn.render(
            t["sweep"], t["net_forward"], tbatch)["output_image"]),
        ("assemble_render_jitter", lambda t: loss_fn.render_jitter(
            t["sweep_jitter_gather"], t["net_forward_jitter"], tbatch,
            pose)["jitter_output_image"]),
        ("elpips", lambda t: torch.mean(metric(
            t["assemble_render"], tgt, draws=[draw]))),
        ("elpips_enforcement", lambda t: torch.mean(metric(
            t["assemble_render_jitter"], t["assemble_render"],
            draws=[draw]))),
        ("backward", lambda t: (t["elpips"] + 10.0
                                * t["elpips_enforcement"]).backward()),
        ("optimizer", lambda t: tstate.optimizer.step()),
    ]
    parts = {k: [] for k, _ in steps}
    for i in range(nsteps):
        tstate.optimizer.zero_grad(set_to_none=True)
        ev = [torch.cuda.Event(enable_timing=True)
              for _ in range(len(steps) + 1)]
        vals = {}
        ev[0].record()
        for j, (k, fn) in enumerate(steps):
            vals[k] = fn(vals)
            ev[j + 1].record()
        torch.cuda.synchronize()
        if i >= TRAIN_WARMUP:
            for j, k in enumerate(parts):
                parts[k].append(ev[j].elapsed_time(ev[j + 1]))
        del vals
    med = {k: statistics.median(v) for k, v in parts.items()}
    print("reg train step parts at level 1 " + " ".join(
        f"{k} {v:.3f}" for k, v in med.items())
          + f" ms (sum {sum(med.values()):.3f}; median of {TRAIN_STEPS}) "
            f"{tag}")

    route_gate("reg train step", tcfg, tstate.net, tbatch, dev,
               elpips=lambda p, t, g: metric(p, t, draws=[draw]),
               loss_tol=None, jitter_pose=pose)
    del tstate, loss_fn

    wcfg = entry.flagship_cfg(transform_inverse_reg=True)
    _, wl, wevents, wrecs, wpeak, wmem0 = run_train_loop(
        wcfg, dev, reset_counts, read_counts, None, REG_WRAP_STEPS)
    print(f"launches over {REG_WRAP_STEPS} regularized training steps (wrap "
          f"net, pixel loss): {wl}")
    check(wl["sweep"] == REG_WRAP_STEPS
          and wl["gather_sweep"] == REG_WRAP_STEPS,
          "K1 and the gather sweep once a regularized wrap step")
    for k in K7_COUNTS:
        want = 2 * k7_per_step[k] * REG_WRAP_STEPS
        check(wl[k] == want, f"{k}: {wl[k]} launches in {REG_WRAP_STEPS} "
                             f"regularized steps, want {want} (twice path "
                             f"5's a step)")
    check(all(math.isfinite(r["total_loss"]) and r["enforcement_loss"] > 0
              for r in wrecs), "regularized wrap records")
    print("reg train wrap pixel steps ms " + " ".join(
        f"{s.elapsed_time(e):.3f}" for s, e in wevents)
          + f", peak {wpeak / 2**30:.3f} GiB ({(wpeak - wmem0) / 2**30:.3f}"
            f" above the held) {tag}")
    return launches, wl


def rerender_path(dev, tag, reset_counts, read_counts):
    """Path 10: the test CLI's perspective windows and ODS-eye re-renders
    (build_infer_fn with psp_src_output_image_ref_output_image) at the
    flagship, launch counts zeroed and read (K1, K2 + LN; the re-renders
    gather, as the JAX package does: no render kernel). Each output in
    two halves, as the kernels' renders are held: its lookups (the card's
    float32 intersect_perspective / intersect_ods) against float64 within
    the f32 noise bound (grids.lookup_error), and its gather and
    composite (geometry/render.render_at) on the card against the CPU at
    the same lookups and the same bf16 rgba_layers (RERENDER_TOL); the
    whole function's card-vs-CPU distance, lookups made on each device,
    printed. Each output's ms and the request's."""
    from matryodshka_tpu_torch import entry
    from matryodshka_tpu_torch.cli import test as cli_test
    from matryodshka_tpu_torch.geometry import grids, intersect
    from matryodshka_tpu_torch.geometry import render as render_lib
    from matryodshka_tpu_torch.models import msi as msi_lib

    cfg = entry.flagship_cfg()
    h, w = cfg.height, cfg.width
    params = entry.make_params(cfg, seed=0, device=dev)
    batch = entry.synthetic_batch(cfg, 7, dev, tgt_pos=(0.03, -0.02, 0.01))
    outputs = "psp_src_output_image_ref_output_image"
    infer = cli_test.build_infer_fn(cfg, params, outputs)
    reset_counts()
    outs = infer(batch)
    launches = read_counts()
    print(f"launches of the re-render request: {launches}")
    check(launches["sweep"] == 1 and launches["conv"] == 18
          and launches["conv_norm"] == 17, "the re-render request's sweep "
                                           "and net kernels")
    check(sorted(outs) == sorted([f"output_psp{i}" for i in range(4)]
                                 + ["output_src", "output_ref"]),
          f"re-render outputs {sorted(outs)}")
    req_ms = time_ms(lambda: infer(batch), iters=5)
    with torch.no_grad():
        pouts = msi_lib.infer_msi_prepared(cfg, params.stages, batch,
                                           params.psv_depths)
        rgba = msi_lib.assemble_rgba(
            cfg.which_color_pred, pouts["pred"].permute(0, 2, 3, 1),
            pouts["vol"].permute(0, 2, 3, 1), cfg.num_msi_planes)[
                "rgba_layers"]
    del pouts
    cpu_batch = {k: v.cpu() for k, v in batch.items()}
    radii = params.msi_depths

    def lookups(name, device, dtype):
        """The output's lookup fields [P, h', w', 2] on device in dtype."""
        r = radii.to(device, dtype)
        if name.startswith("output_psp"):
            pose = render_lib.perspective_window_pose(int(name[-1]), device)
            return intersect.intersect_perspective(
                pose.to(dtype), batch["tgt_pose"][0].to(device, dtype), r,
                w, h, 480, 270)
        order = -1 if name == "output_src" else 1
        return intersect.intersect_ods(
            torch.eye(4, device=device, dtype=dtype), None, order,
            batch["intrinsics"][0].to(device, dtype), r, w, h)

    scale = radii.cpu().double()[:, None, None]
    errs, e2e, lookup = {}, {}, {}
    for key in ("psp", "src_output_image", "ref_output_image"):
        card = cli_test.rerender(cfg, rgba, batch, radii, key)
        cpu = cli_test.rerender(cfg, rgba.cpu(), cpu_batch, radii.cpu(), key)
        for name, img in card.items():
            shape = (1, 270, 480, 3) if "psp" in name else (1, h, w, 3)
            check(tuple(img.shape) == shape
                  and bool(torch.isfinite(img).all()),
                  f"{name} shape {tuple(img.shape)}, finite")
            check(torch.equal(img, outs[name]), f"{name}: the request's "
                                                f"output is the function's")
            e2e[name] = (img.cpu() - cpu[name]).abs().max().item()
            ref = lookups(name, "cpu", torch.float64)
            uv_card = lookups(name, dev, torch.float32).cpu()
            uv_cpu = lookups(name, "cpu", torch.float32)
            le = grids.lookup_error(uv_card[..., 0], uv_card[..., 1],
                                    ref[..., 0], ref[..., 1], scale, h, w)
            lp = grids.lookup_error(uv_cpu[..., 0], uv_cpu[..., 1],
                                    ref[..., 0], ref[..., 1], scale, h, w)
            lookup[name] = (le["u"], le["v"], lp["u"], lp["v"])
            check(le["u"] <= 1 and le["v"] <= 1, f"{name} lookups on the "
                                                 f"card vs float64")
            with torch.no_grad():
                at_card = render_lib.render_at(rgba[0], uv_cpu.to(dev))
                at_cpu = render_lib.render_at(rgba[0].cpu(), uv_cpu)
            errs[name] = (at_card.cpu() - at_cpu).abs().max().item()
    print("re-render lookups vs float64, of the f32 noise bound (u, v; the "
          "CPU's float32 beside): " + ", ".join(
              f"{k} {a:.3f} {b:.3f} ({c:.3f} {d:.3f})"
              for k, (a, b, c, d) in lookup.items()) + " (tol 1)")
    print("re-render gather and composite at the same lookups, card vs CPU, "
          "same bf16 layers, max abs: " + ", ".join(
              f"{k} {v:.3e}" for k, v in errs.items())
          + f" (tol {RERENDER_TOL:.0e}); the whole function, lookups made on "
            "each device: " + ", ".join(f"{k} {v:.3e}"
                                        for k, v in e2e.items()))
    check(max(errs.values()) <= RERENDER_TOL, "re-renders, card vs CPU")
    times = {key: time_ms(lambda: cli_test.rerender(cfg, rgba, batch, radii,
                                                    key), iters=5)
             for key in ("psp", "src_output_image", "ref_output_image")}
    print("re-render ms (CUDA events, median of 5): psp (4 windows of "
          f"270x480) {times['psp']:.3f}, src_output_image "
          f"{times['src_output_image']:.3f}, ref_output_image "
          f"{times['ref_output_image']:.3f}; the request (sweep, net, "
          f"assembly and the six images) {req_ms:.3f} {tag}")
    return launches


def export_path(dev, tag, reset_counts, read_counts):
    """Path 11: cli/export.main with the export recipe's flags
    (scripts/export/ods-wotemp-elpips-coord-reg.sh: --coord_net true
    --net_only true) and --platform cuda at the flagship, bf16 (the
    default compute dtype) and float32, into a temporary directory; the
    port's consumer tool loads each .pt2 in a subprocess, as a script
    (neither package imported), and runs it on its seeded input. Gates:
    the loaded program's atlas against atlas_pack of the eager plain net
    on that input (EXPORT_TOL by dtype; bit-equality printed), the
    consumer's run
    against the loaded program (CONSUMER_TOL); atlas_pack of the
    kernel route's bf16 prediction (ops/net.unet_forward, the conv
    kernel's coord mode) against the f32 program within max(E2E_TOL,
    TRAIN_GRAD_MARGIN x the bf16 program's distance from it): two bf16
    routes on uniform inputs sit 2.2e-2 apart in the 64 raw channels, so
    each is held to float32 as path 5 holds the trainer. The export's
    seconds, the artifact's bytes, the loaded program's and the eager
    plain net's ms per call."""
    import warnings

    from matryodshka_tpu_torch import entry, weights
    from matryodshka_tpu_torch.cli import export as export_cli
    from matryodshka_tpu_torch.models.unet import atlas_pack
    from matryodshka_tpu_torch.ops import net as net_ops

    consumer = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "matryodshka_tpu_torch", "tools",
                            "consume_export.py")
    launches, programs = {}, {}
    with tempfile.TemporaryDirectory() as d:
        for dtype in ("bfloat16", "float32"):
            flags = ["--coord_net", "true", "--net_only", "true",
                     "--platform", "cuda", "--compute_dtype", dtype,
                     "--export_dir", d, "--export_name", f"msi_{dtype}",
                     "--checkpoint_dir", os.path.join(d, "none")]
            t0 = time.perf_counter()
            with warnings.catch_warnings():
                warnings.filterwarnings("ignore", message=".*no checkpoint")
                path = export_cli.main(flags)
            secs = time.perf_counter() - t0
            size = os.path.getsize(path)
            out = os.path.join(d, f"out_{dtype}.npy")
            t0 = time.perf_counter()
            res = subprocess.run(
                [sys.executable, consumer, path, "--device", "cuda",
                 "--out", out], capture_output=True,
                text=True, timeout=600, cwd=d,
                env=dict(os.environ, PYTHONPATH=""))
            sub_secs = time.perf_counter() - t0
            print(res.stdout.strip())
            check(res.returncode == 0, f"consumer tool on {path}: "
                                       f"{res.stderr[-2000:]}")
            check("modules of either package or JAX imported: []"
                  in res.stdout, "the consumer imported no package")
            cfg = export_cli.config_from_args(
                export_cli.build_parser().parse_args(flags))
            got = torch.from_numpy(np.load(out)).to(dev)
            x = torch.from_numpy(np.random.RandomState(0).rand(
                1, cfg.height, cfg.width, cfg.num_net_inputs()).astype(
                    np.float32)).to(dev)
            tree = weights.seeded_init(cfg, 0)
            eager = export_cli.build_net_only_fn(cfg, tree, dev)
            program = torch.export.load(path).module()
            with torch.no_grad():
                want = eager(x)
                loaded = program(x)
            err = (loaded - want).abs().max().item()
            cerr = (got - loaded).abs().max().item()
            print(f"export {dtype}: loaded program vs eager plain net, same "
                  f"input: max abs {err:.3e} (tol {EXPORT_TOL[dtype]:.0e}), "
                  f"bit-equal {bool(torch.equal(loaded, want))}; the "
                  f"consumer's run (another process) vs the loaded program "
                  f"{cerr:.3e} (tol {CONSUMER_TOL:.0e}), bit-equal "
                  f"{bool(torch.equal(got, loaded))}; shape "
                  f"{tuple(got.shape)}")
            check(tuple(got.shape) == (1, 8 * cfg.height, 8 * cfg.width)
                  and bool(torch.isfinite(got).all())
                  and err <= EXPORT_TOL[dtype],
                  f"export {dtype} round trip")
            check(cerr <= CONSUMER_TOL, f"export {dtype}, the consumer's run")
            programs[dtype] = loaded
            if dtype == "bfloat16":
                params = entry.make_params(cfg, flax_params=tree, device=dev)
                reset_counts()
                with torch.no_grad():
                    pred = net_ops.unet_forward(params.stages, x.permute(
                        0, 3, 1, 2).to(cfg.torch_compute_dtype).contiguous())
                launches = read_counts()
                check(launches["conv_coord"] == 18, "the kernel route's "
                                                    "coord net: 18 stages")
                kern = atlas_pack(pred.permute(0, 2, 3, 1), cfg.height,
                                  cfg.width)
                del params, pred
            with torch.no_grad():
                prog_ms = time_ms(lambda: program(x))
                eager_ms = time_ms(lambda: eager(x))
            print(f"export {dtype} (coord net, net only, 640x320, 32+32 "
                  f"planes, ngf 64): export {secs:.2f} s, artifact {size} "
                  f"bytes, consumer subprocess {sub_secs:.2f} s; loaded "
                  f"program {prog_ms:.3f} ms per call, eager plain net "
                  f"{eager_ms:.3f} ms (CUDA events, median of 10) {tag}")
            del program, eager
        # the kernel route (bf16, K2c) no farther from the float32
        # program than the bf16 program is, with path 5's margin
        kerr = (kern - programs["float32"]).abs().max().item()
        berr = (programs["bfloat16"] - programs["float32"]).abs().max().item()
        tol = max(E2E_TOL, TRAIN_GRAD_MARGIN * berr)
        print(f"export: the kernel route (K2c, {launches['conv_coord']} conv "
              f"launches, bf16) vs the f32 program max abs {kerr:.3e}, the "
              f"bf16 program vs the f32 one {berr:.3e} (gate max({E2E_TOL:.0e}"
              f", {TRAIN_GRAD_MARGIN} x that) = {tol:.3e}); kernel route vs "
              f"the bf16 program "
              f"{(kern - programs['bfloat16']).abs().max().item():.3e}")
        check(kerr <= tol, "export vs the kernel route")
    return launches


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
        for k in ("sweep", "conv_coord", "conv_norm", "render",
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


def recipe_flags(name: str):
    """The flags scripts/train/<name>.sh passes ("$@" left out), without
    its --elpips_weight_path (the calibrated weights are not in the
    repository: E-LPIPS runs on its random features, as in path 7)."""
    import shlex
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "scripts", "train", f"{name}.sh")
    with open(path) as fh:
        text = fh.read().replace("\\\n", " ")
    line = next(ln for ln in text.splitlines() if ln.startswith("python "))
    flags = [t for t in shlex.split(line)[2:] if t != "$@"]
    i = flags.index("--elpips_weight_path")
    return flags[:i] + flags[i + 2:]


def mpi_path(dev, tag, reset_counts, read_counts, k7_per_step):
    """Path 12: the PP and RealEstate recipes at the flagship width
    (640x320, 32 + 32 planes, 32 MSI planes, ngf 64, bf16, batch 1) on the
    port's synthetic fixtures written under a temporary directory (the
    RealEstate clip MPI_RE_FRAMES frames long, as its training loader's
    admission rule asks). For each recipe (scripts/train/pp-wotemp-elpips-
    coord.sh, realestate-wotemp-elpips-coord.sh: coord net, E-LPIPS on
    random features) cli/train.main for MPI_STEPS steps, the launch counts
    zeroed before and read after (the gather sweep once a step and once
    for the image summary; K1 never: it reads no pose; the coord net
    trains through PyTorch convs, as the JAX trainer's XLA convs); then
    the step in parts at one level-1 draw, TRAIN_WARMUP + MPI_STEPS times
    on the loader's first batch. Then the wrap net's PP pixel step through
    training/loop.train on the loader's batches for MPI_WRAP_STEPS steps,
    K7a/b/c and wgrad at path 5's count a step (k7_per_step). Then one
    test-CLI request of each recipe's checkpoint (cli/test.main): 18 conv
    launches (all in the coord mode), 17 of them with their inputs' layer
    norm fused and 17 writing their statistics, no sweep, K3 or
    layer-stack render kernel, one MPI render kernel launch; the request's
    view against the all-plain f32 route
    (E2E_TOL) and its first conv (Cin' 193, 196) against its plain
    version (one bf16 step); its ms; one entry.forward of the request's
    example repeated to the MPI cell's batch (MPI_CELL_BATCH), the counts
    zeroed just before: one MPI render launch. Then cli/evaluate.main
    (E-LPIPS on random features) on the two requests' outputs. Returns
    that forward's counts, {input type: {"launches": MPI render launches,
    "frames": MPI_CELL_BATCH}}."""
    import warnings

    from matryodshka_tpu_torch import entry
    from matryodshka_tpu_torch.cli import evaluate as cli_evaluate
    from matryodshka_tpu_torch.cli import test as cli_test
    from matryodshka_tpu_torch.cli import train as cli_train
    from matryodshka_tpu_torch.config import config_from_args
    from matryodshka_tpu_torch.data import synthetic
    from matryodshka_tpu_torch.data.loader import make_loader
    from matryodshka_tpu_torch.models import msi as msi_lib
    from matryodshka_tpu_torch.ops import conv as conv_ops
    from matryodshka_tpu_torch.ops import wrap_conv as wc
    from matryodshka_tpu_torch.training import state as state_lib
    from matryodshka_tpu_torch.training import step as step_lib
    from matryodshka_tpu_torch.training.checkpoint import restore_params

    fcfg = entry.flagship_cfg()
    h, w = fcfg.height, fcfg.width
    nsteps = TRAIN_WARMUP + MPI_STEPS
    recipes = {"PP": "pp-wotemp-elpips-coord",
               "REALESTATE_PP": "realestate-wotemp-elpips-coord"}
    with tempfile.TemporaryDirectory() as tmp, warnings.catch_warnings():
        warnings.filterwarnings("ignore", message="elpips: no weight_path")
        t0 = time.perf_counter()
        globs = {
            "PP": synthetic.make_perspective_fixture(
                f"{tmp}/pp", height=h, width=w),
            "REALESTATE_PP": synthetic.make_realestate_fixture(
                f"{tmp}/re", frames=MPI_RE_FRAMES, height=h, width=w)}
        print(f"path 12 fixtures written in {time.perf_counter() - t0:.2f} "
              f"s (PP: 2 scenes x 3 images; RealEstate: 1 clip x "
              f"{MPI_RE_FRAMES} frames; {w}x{h})")
        data = {k: ["--cameras_glob", g, "--image_dir",
                    os.path.join(os.path.dirname(os.path.dirname(g)),
                                 "images"),
                    "--checkpoint_dir", f"{tmp}/ckpt"]
                for k, g in globs.items()}
        outs, served = {}, {}
        for input_type, recipe in recipes.items():
            flags = recipe_flags(recipe) + data[input_type]
            cfg = config_from_args(cli_train.build_parser().parse_args(flags))
            check(cfg.input_type == input_type and cfg.coord_net
                  and cfg.which_loss == "elpips"
                  and (cfg.height, cfg.width, cfg.ngf) == (h, w, fcfg.ngf),
                  f"{recipe}'s flags")

            # the recipe through the train CLI
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            mem0 = torch.cuda.memory_allocated()
            reset_counts()
            t0 = time.perf_counter()
            cli_train.main(flags + ["--max_steps", str(MPI_STEPS),
                                    "--summary_freq", str(MPI_STEPS),
                                    "--save_latest_freq", str(MPI_STEPS)])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = read_counts()
            peak = torch.cuda.max_memory_allocated()
            with open(f"{tmp}/ckpt/{recipe}/logs/metrics.jsonl") as fh:
                records = [json.loads(line) for line in fh]
            print(f"{recipe}: launches over {MPI_STEPS} train CLI steps: "
                  f"{launches}")
            check(launches["sweep"] == 0, f"{recipe}: K1 never (posed input)")
            check(launches["gather_sweep"] == MPI_STEPS + 1,
                  f"{recipe}: one gather sweep a step and one for the "
                  f"image summary")
            check(len(records) == 1 and records[0]["step"] == MPI_STEPS
                  and math.isfinite(records[0]["total_loss"])
                  and records[0]["elpips_calibrated"] is False,
                  f"{recipe}: metrics record {records}")
            check(os.path.exists(f"{tmp}/ckpt/{recipe}/{MPI_STEPS}/"
                                 f"params.npz"), f"{recipe}: checkpoint")
            print(f"{recipe} train CLI: {MPI_STEPS} steps in {wall:.2f} s "
                  f"(E-LPIPS features, checkpoint and image summary "
                  f"included; sec_per_step "
                  f"{records[0]['sec_per_step'] * 1e3:.1f} ms, host), "
                  f"loss {records[0]['total_loss']:.5f}, peak device "
                  f"memory {peak / 2**30:.3f} GiB "
                  f"({(peak - mem0) / 2**30:.3f} above the "
                  f"{mem0 / 2**30:.3f} held before) {tag}")

            # the step in parts, CUDA events between, at one level-1 draw
            np_batch = next(make_loader(cfg, training=True).batches())
            tbatch = {k: torch.from_numpy(v).to(dev)
                      for k, v in np_batch.items()
                      if isinstance(v, np.ndarray)}
            tstate = state_lib.init_state(cfg, 0, dev)
            metric = step_lib.build_elpips(cfg, dev)
            loss_fn = step_lib.make_loss_fn(cfg, tstate.net, elpips=metric)
            draw = metric.draw(1, torch.Generator().manual_seed(5), scale=1)
            tgt = msi_lib.preprocess_image(tbatch["tgt_image"])
            net = tstate.net
            steps = [
                ("sweep", lambda t: loss_fn.sweep(tbatch)),
                ("net_forward", lambda t: net(t["sweep"])),
                ("assemble_mpi_render", lambda t: loss_fn.render(
                    t["sweep"], t["net_forward"], tbatch)["output_image"]),
                ("elpips", lambda t: torch.mean(metric(
                    t["assemble_mpi_render"], tgt, draws=[draw]))),
                ("backward", lambda t: t["elpips"].backward()),
                ("adam", lambda t: tstate.optimizer.step())]
            parts = {k: [] for k, _ in steps}
            for i in range(nsteps):
                tstate.optimizer.zero_grad(set_to_none=True)
                ev = [torch.cuda.Event(enable_timing=True)
                      for _ in range(len(steps) + 1)]
                vals = {}
                ev[0].record()
                for j, (k, fn) in enumerate(steps):
                    vals[k] = fn(vals)
                    ev[j + 1].record()
                torch.cuda.synchronize()
                check(math.isfinite(vals["elpips"].item()),
                      f"{recipe} step loss")
                if i >= TRAIN_WARMUP:
                    for j, k in enumerate(parts):
                        parts[k].append(ev[j].elapsed_time(ev[j + 1]))
                del vals
            sums = [sum(v[i] for v in parts.values())
                    for i in range(MPI_STEPS)]
            print(f"{recipe} train step {statistics.median(sums):.3f} ms "
                  f"(sum of its parts, median of {MPI_STEPS} after "
                  f"{TRAIN_WARMUP} warm-up; coord net, E-LPIPS level 1, "
                  f"640x320, 32+32 planes, ngf 64, bf16, batch 1); parts "
                  + " ".join(f"{k} {statistics.median(v):.3f}"
                             for k, v in parts.items()) + f" ms {tag}")
            del tstate, loss_fn, net, metric

            # one test-CLI request of the recipe's checkpoint
            out_root = f"{tmp}/out"
            reset_counts()
            t0 = time.perf_counter()
            cli_test.main(flags + ["--output_root", out_root,
                                   "--num_runs", "1", "--test_outputs",
                                   "tgt_image_blend_weights_alphas"])
            torch.cuda.synchronize()
            cli_wall = time.perf_counter() - t0
            rl = read_counts()
            print(f"{recipe} test CLI request launches: {rl}")
            check(rl["conv"] == 18 and rl["conv_coord"] == 18
                  and rl["conv_norm"] == rl["conv_stats"] == 17
                  and rl["conv_cl"] == 17,
                  f"{recipe}: 18 conv launches (coord mode) per request, "
                  f"17 with the layer norm fused, reading a channels-last "
                  f"window")
            check(rl["sweep"] == 0 and rl["render"] == 0
                  and rl["render_layers"] == 0 and rl["gather_sweep"] == 1
                  and rl["mpi_render"] == 1,
                  f"{recipe}: the gather sweep, no sweep, K3 or layer-stack "
                  f"render, one MPI render kernel launch")
            outs[input_type] = f"{out_root}/{recipe}"

            tree, _ = restore_params(f"{tmp}/ckpt/{recipe}/{MPI_STEPS}/"
                                     f"params.npz")
            params = entry.make_params(cfg, flax_params=tree, device=dev)
            ebatch = {k: torch.from_numpy(v).to(dev) for k, v in
                      next(make_loader(cfg, training=False).batches()).items()
                      if isinstance(v, np.ndarray)}
            infer = cli_test.build_infer_fn(cfg, params, "tgt_image")
            got = infer(ebatch)["output_image"]
            want = cli_test.infer_plain(cfg, params, ebatch)["output_image"]
            check(tuple(got.shape) == (1, h, w, 3)
                  and bool(torch.isfinite(got).all()),
                  f"{recipe} request output {tuple(got.shape)}")
            err = 2 * (got - want).abs()
            print(f"{recipe} request output_image: |bf16 kernels - f32 "
                  f"plain| max {err.max().item():.3e} mean "
                  f"{err.mean().item():.3e} on [-1, 1] (gate {E2E_TOL:.0e})")
            check(err.max().item() <= E2E_TOL,
                  f"{recipe} request vs all-plain f32 route")
            vol = msi_lib.sweep_stage(cfg, ebatch, params.psv_depths)
            st = params.stages[0]
            c = conv_ops.conv(vol, st["w"], st["b"], **st["args"],
                              memory_format=st["memory_format"]).float()
            cp = conv_ops.conv_plain(vol, st["w"], st["b"],
                                     **st["args"]).float()
            cerr = (c - cp).abs().max().item()
            ctol = 2.0 ** -7 * cp.abs().max().item()
            print(f"{recipe} first conv (Cin {vol.shape[1]} + the coord "
                  f"channel = Cin' {st['w'].shape[1] // 9}, bf16) vs plain: "
                  f"max_abs_err {cerr:.3e} tol {ctol:.3e} "
                  f"{'ok' if cerr <= ctol else 'FAIL'}")
            check(st["w"].shape[1] == 9 * (cfg.num_net_inputs() + 1)
                  and cerr <= ctol, f"{recipe} first conv vs plain")
            # the served path at realestate-coord.mpi-video's batch of 4
            fbatch = {k: v.repeat(MPI_CELL_BATCH, *([1] * (v.dim() - 1)))
                      for k, v in ebatch.items()}
            reset_counts()
            fview = entry.forward(params, fbatch)
            torch.cuda.synchronize()
            fl = read_counts()
            print(f"{recipe} entry.forward at batch {MPI_CELL_BATCH} "
                  f"launches: {fl}")
            check(tuple(fview.shape) == (MPI_CELL_BATCH, h, w, 3)
                  and bool(torch.isfinite(fview).all())
                  and fl["mpi_render"] == 1 and fl["render_layers"] == 0,
                  f"{recipe}: one MPI render launch a batch of "
                  f"{MPI_CELL_BATCH}, no layer stack")
            served[input_type] = {"launches": fl["mpi_render"],
                                  "frames": MPI_CELL_BATCH}
            req_ms = time_ms(lambda: infer(ebatch), iters=5)
            with torch.no_grad():
                pred = msi_lib.net_stage(params.stages, vol)
                rgba = msi_lib.assemble_train(cfg, vol, pred)["rgba_layers"]
                rel = msi_lib.mpi_view_pose(ebatch)
                stages = {
                    "sweep": lambda: msi_lib.sweep_stage(
                        cfg, ebatch, params.psv_depths),
                    "net": lambda: msi_lib.net_stage(params.stages, vol),
                    "mpi_render": lambda: msi_lib.mpi_render_stage(
                        cfg, vol, pred, ebatch, params.msi_depths),
                    "bf16_stack_assemble": lambda: msi_lib.assemble_train(
                        cfg, vol, pred),
                    "bf16_stack_render": lambda: msi_lib.render_mpi_view(
                        rgba, rel, params.msi_depths, ebatch["intrinsics"])}
                stage_ms = {k: time_ms(fn, iters=5)
                            for k, fn in stages.items()}
            print(f"{recipe} request {req_ms:.3f} ms (median of 5); stages "
                  + " ".join(f"{k} {v:.3f}" for k, v in stage_ms.items())
                  + f" ms; test CLI main {cli_wall:.2f} s (params restored, "
                    f"one example written) {tag}")
            del params, vol, c, cp, pred, rgba, fbatch, fview

        # the wrap net's PP pixel step: K7 at path 5's count a step
        wcfg = dataclasses.replace(config_from_args(
            cli_train.build_parser().parse_args(
                recipe_flags(recipes["PP"]) + data["PP"])),
            coord_net=False, which_loss="pixel")
        wl_state, wl, wevents, wrecs, wpeak, wmem0 = run_train_loop(
            wcfg, dev, reset_counts, read_counts, None, MPI_WRAP_STEPS,
            np_batches=make_loader(wcfg, training=True).batches())
        print(f"launches over {MPI_WRAP_STEPS} PP wrap-net pixel steps: {wl}")
        for k in K7_COUNTS:
            want_n = k7_per_step[k] * MPI_WRAP_STEPS
            check(wl[k] == want_n, f"{k}: {wl[k]} launches in "
                                   f"{MPI_WRAP_STEPS} PP wrap steps, want "
                                   f"{want_n} (path 5's a step)")
        check(wl["sweep"] == 0 and wl["gather_sweep"] == MPI_WRAP_STEPS,
              "PP wrap steps: the gather sweep once a step, K1 never")
        check(all(math.isfinite(r["total_loss"]) for r in wrecs),
              "PP wrap records")
        print("PP wrap-net pixel steps ms " + " ".join(
            f"{s_.elapsed_time(e_):.3f}" for s_, e_ in wevents)
              + f", peak {wpeak / 2**30:.3f} GiB "
                f"({(wpeak - wmem0) / 2**30:.3f} above the held) {tag}")
        del wl_state

        # the evaluator on the two requests' outputs
        for input_type, root in outs.items():
            t0 = time.perf_counter()
            table = cli_evaluate.main(["--result_root", root, "--with_elpips",
                                       "--allow_uncalibrated", "--device",
                                       str(dev)])
            check(len(table["per_example"]) == 1
                  and all(math.isfinite(table[f"avg_{k}"])
                          for k in ("ssim", "psnr", "elpips")),
                  f"{input_type} evaluator scores {table}")
            print(f"{input_type} evaluator: ssim {table['avg_ssim']:.4f} "
                  f"psnr {table['avg_psnr']:.3f} elpips "
                  f"{table['avg_elpips']:.5f} in "
                  f"{time.perf_counter() - t0:.2f} s {tag}")
    return served


#: The MPI render kernel's f32 operations a (pixel, plane) sample, as
#: msi_bench/work/mpi_render.py counts them: the homography and the divide
#: (15), the bilinear weights (8), four taps of 4 channels (32), the blend
#: (9) and the over step (8).
OPS_MPI_RENDER = 15 + 8 + 32 + 9 + 8
#: Bound on |MPI render kernel - its plain version| (f32, the same
#: homographies; the sums in another order).
MPI_RENDER_TOL = 2e-4


def mpi_render_row(dev, tag, served):
    """The MPI render kernel (csrc/mpi_render.cu) at
    realestate-coord.mpi-video's shape: batch 4, 640x320, 32 planes, the
    195-channel bf16 volume and an f32 prediction uniform in [-1, 1], each
    viewer's target within 0.1 m and 5 degrees (the cell's intrinsics):
    gated against its plain version in f32 (MPI_RENDER_TOL) and against a
    second launch bit for bit, then its time by CUDA events and by
    profiler device time, the plain version's time, and its bound (the
    volume's fg and bg channels, the prediction and the view once;
    OPS_MPI_RENDER a sample). Returns its row of the kernel table, its
    launches and launches a frame those of the served path's counted
    forward (served: mpi_path's count of the REALESTATE_PP forward)."""
    from matryodshka_tpu_torch.geometry.sweep import inv_depths
    from matryodshka_tpu_torch.ops import mpi_render as mpi_ops

    b, c, h, w, p = MPI_CELL_BATCH, 195, 320, 640, 32
    gen = torch.Generator(device=dev).manual_seed(2609)
    vol = (torch.rand((b, c, h, w), generator=gen, device=dev) * 2
           - 1).to(torch.bfloat16)
    pred = torch.rand((b, 2 * p, h, w), generator=gen, device=dev) * 2 - 1
    k = torch.tensor([[0.9 * w, 0.0, 0.5 * w], [0.0, 1.2 * h, 0.5 * h],
                      [0.0, 0.0, 1.0]], device=dev).repeat(b, 1, 1)
    pose = torch.eye(4, device=dev).repeat(b, 1, 1)
    for i in range(b):
        a, e = (math.radians(5.0) * (2 * torch.rand(
            (2,), generator=gen, device=dev) - 1)).tolist()
        pitch = torch.tensor([[1.0, 0.0, 0.0],
                              [0.0, math.cos(e), -math.sin(e)],
                              [0.0, math.sin(e), math.cos(e)]], device=dev)
        pose[i, :3, :3] = rot_y(math.degrees(a), dev)[0, :3, :3] @ pitch
        pose[i, :3, 3] = 0.1 / math.sqrt(3) * (2 * torch.rand(
            (3,), generator=gen, device=dev) - 1)
    depths = torch.tensor(inv_depths(1.0, 100.0, p), dtype=torch.float32,
                          device=dev)
    args = (vol, pred, pose, k, depths)
    mpi_ops.launches = 0
    got = mpi_ops.render_mpi_blend(*args)
    torch.cuda.synchronize()
    check(mpi_ops.launches == 1, "mpi_render: one launch a render")
    want = mpi_ops.render_mpi_blend_plain(vol.float(), pred, pose, k, depths)
    err = (got - want).abs().max().item()
    print(f"mpi_render kernel vs plain (f32, same values) at {b}x{w}x{h}, "
          f"{p} planes, C {c}: max_abs_err {err:.3e} tol "
          f"{MPI_RENDER_TOL:.0e} {'ok' if err <= MPI_RENDER_TOL else 'FAIL'}")
    check(bool(torch.isfinite(got).all()) and err <= MPI_RENDER_TOL,
          "mpi_render kernel vs plain")
    check(torch.equal(got, mpi_ops.render_mpi_blend(*args)),
          "mpi_render: two launches bit-identical")
    kern = functools.partial(mpi_ops.render_mpi_blend, *args)
    ms = time_ms(kern)
    _, dev_ms, seen = device_ms([kern], [1], r"\bmpi_render_kernel\b")
    plain_ms = time_ms(lambda: mpi_ops.render_mpi_blend_plain(*args),
                       iters=3, warmup=1)
    nb = (b * 6 * p * h * w * vol.element_size() + nbytes(pred)
          + b * h * w * 3 * 4)
    bms, bby = bound(nb, OPS_MPI_RENDER * b * p * h * w, F32_FLOPS)
    print(f"kernel mpi_render device {dev_ms:.4f} ms per launch ({seen:g} "
          f"of 1 kept), CUDA events {ms:.4f} ms; plain {plain_ms:.3f} ms; "
          f"bound {bms:.4f} ms ({bby}, {nb / 1e6:.1f} MB), "
          f"{100 * bms / dev_ms:.1f}% of it; per call of {b} views {tag}")
    return {"name": "mpi_render", "route": "cuda",
            "source": "matryodshka_tpu_torch/csrc/mpi_render.cu",
            "replaces": "none (the JAX package renders an MPI with XLA "
                        "gathers: geometry/homography.py:mpi_render_view)",
            "launches": served["launches"],
            "launches_per_frame": served["launches"] / served["frames"],
            "max_abs_err": err, "ms": ms, "device_ms": dev_ms,
            "plain_ms": plain_ms, "bound_ms": bms, "bound_by": bby,
            "library_ms": None}


def hres_training_batch(cfg):
    """training_batch(cfg) with the high-res pair and target: the same
    texture at hres_height x hres_width, rolled alike."""
    from matryodshka_tpu_torch.data.synthetic import erp_texture
    batch = training_batch(cfg)
    tex = erp_texture(cfg.hres_height, cfg.hres_width, seed=0)
    for k, name in enumerate(("ref", "src", "tgt")):
        shift = int(round((k - 1) * cfg.hres_width * 0.01))
        batch[f"hres_{name}_image"] = np.roll(tex, shift, axis=1)[None].copy()
    return batch


def timed_parts(steps, reps, before=None):
    """Run steps, a list of (name, fn(values so far) -> value), reps times
    with CUDA events between (before() first each time, untimed). Returns
    the medians of the reps after the first, the peak device memory above
    what was held before the first rep, and the last rep's 0-d values as
    floats."""
    torch.cuda.synchronize()
    mem0 = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    parts = {k: [] for k, _ in steps}
    for i in range(reps):
        if before is not None:
            before()
        ev = [torch.cuda.Event(enable_timing=True)
              for _ in range(len(steps) + 1)]
        vals = {}
        ev[0].record()
        for j, (k, fn) in enumerate(steps):
            vals[k] = fn(vals)
            ev[j + 1].record()
        torch.cuda.synchronize()
        if i > 0:
            for j, k in enumerate(parts):
                parts[k].append(ev[j].elapsed_time(ev[j + 1]))
        last = {k: v.item() for k, v in vals.items()
                if torch.is_tensor(v) and v.dim() == 0}
        del vals
    peak = torch.cuda.max_memory_allocated() - mem0
    return {k: statistics.median(v) for k, v in parts.items()}, peak, last


def options_path(dev, tag, reset_counts, read_counts, k7_per_step):
    """Path 13: the trainer's remaining options at the flagship width
    (640x320, 32 + 32 planes, ngf 64, bf16; high res 4096x2048), on an
    ODS fixture written at 640x320 under a temporary directory:
    (a) the released recipe's flags (coord net, E-LPIPS on random
        features) with --supervision tgt_src_ref through cli/train.main
        for OPT_CLI_STEPS steps, then with --transform_inverse_reg true;
        each through training/loop.train on one in-memory batch for the
        step's time and peak; one step against the all-plain f32 route at
        a fixed draw (and pose);
    (b) the wrap net's pixel step with --supervision tgt_hrestgt for
        OPT_STEPS steps: K1 twice a step (640x320 and 4096x2048), K7 at
        path 5's count; the step's time, peak and parts; one step against
        the all-plain f32 route; then the coord net's E-LPIPS hrestgt step
        at a level-1 draw (the largest images the metric sees): its time
        and peak;
    (c) remat_network on path 5's step: K7b/K7c twice path 5's count,
        dgrad and wgrad as often; the gradients against the step without
        it (bit-equal, or within what two runs of that step differ by);
        the time and the peak of both;
    (d) param_dtype bfloat16 for OPT_STEPS steps: parameters and Adam's
        moments bfloat16, losses finite;
    (e) cli/train.main --dry_run (tgt_hrestgt), --dry_run_inference on
        (a)'s checkpoint and --profile_steps 2,3: the files, the launches
        of the inference dump (K1, 18 coord-mode convs, 17 of them with
        the layer norm fused, one layer-stack render for image and
        depth), a trace with device events;
    (f) use_pallas false: one test-CLI request and one train step with
        every kernel count at 0; the view within E2E_TOL of its all-plain
        f32 twin and, but for the far shell's park flips (PARK_SHARE), of
        the default route's; the loss within TRAIN_LOSS_TOL of the default
        route's."""
    import warnings

    from matryodshka_tpu_torch import entry
    from matryodshka_tpu_torch.cli import test as cli_test
    from matryodshka_tpu_torch.cli import train as cli_train
    from matryodshka_tpu_torch.config import config_from_args
    from matryodshka_tpu_torch.data import synthetic
    from matryodshka_tpu_torch.geometry import cameras
    from matryodshka_tpu_torch.losses.elpips import api as elpips_api
    from matryodshka_tpu_torch.models import msi as msi_lib
    from matryodshka_tpu_torch.ops import sweep as sweep_ops
    from matryodshka_tpu_torch.ops import wrap_conv as wc
    from matryodshka_tpu_torch.training import state as state_lib
    from matryodshka_tpu_torch.training import step as step_lib

    fcfg = entry.flagship_cfg()
    h, w = fcfg.height, fcfg.width
    nsteps = TRAIN_WARMUP + TRAIN_STEPS
    kernels = ("sweep", "conv", "conv_norm", "render", "render_layers",
               "render_depth", "render_layers_ftb", "render_layers_both",
               "conv_coord", *K7_COUNTS)

    def zero_all():
        reset_counts()
        for a in K7_COUNTS.values():
            setattr(wc, a, 0)

    def all_counts():
        got = read_counts()
        got.update({k: getattr(wc, a) for k, a in K7_COUNTS.items()})
        return got

    def dev_batch(np_batch):
        return {k: torch.from_numpy(v).to(dev) for k, v in np_batch.items()
                if isinstance(v, np.ndarray)}

    def step_line(what, events, peak, mem0, extra=""):
        ms = [s.elapsed_time(e) for s, e in events]
        med = statistics.median(ms[1:]) if len(ms) > 2 else ms[-1]
        print(f"{what} step {med:.3f} ms (median after the first; steps "
              + " ".join(f"{t:.1f}" for t in ms) + f" ms{extra}), peak "
              f"{peak / 2**30:.3f} GiB ({(peak - mem0) / 2**30:.3f} above "
              f"the {mem0 / 2**30:.3f} held) {tag}")
        return med

    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp, warnings.catch_warnings():
        warnings.filterwarnings("ignore", message="elpips: no weight_path")
        glob_pat = synthetic.make_ods_fixture(f"{tmp}/fix", num_scenes=2,
                                              height=h, width=w)
        data = ["--cameras_glob", glob_pat, "--image_dir", f"{tmp}/fix/images",
                "--hres_image_dir", f"{tmp}/fix/images", "--checkpoint_dir",
                f"{tmp}/ckpt"]
        tbatch = dev_batch(training_batch(fcfg))

        # ---- (a) the released recipe with src/ref supervision ----------
        for reg in (False, True):
            name = "srcref-reg" if reg else "srcref"
            flags = (recipe_flags("ods-wotemp-elpips-coord") + data
                     + ["--supervision", "tgt_src_ref",
                        "--transform_inverse_reg", str(reg).lower(),
                        "--experiment_name", name])
            cfg = config_from_args(cli_train.build_parser().parse_args(flags))
            check(cfg.coord_net and cfg.which_loss == "elpips"
                  and cfg.supervise_src and cfg.supervise_ref
                  and cfg.transform_inverse_reg == reg, f"{name} flags")
            zero_all()
            t0 = time.perf_counter()
            cli_train.main(flags + ["--max_steps", str(OPT_CLI_STEPS),
                                    "--summary_freq", "1",
                                    "--save_latest_freq",
                                    str(OPT_CLI_STEPS)])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            got = all_counts()
            with open(f"{tmp}/ckpt/{name}/logs/metrics.jsonl") as fh:
                recs = [json.loads(line) for line in fh]
            print(f"{name}: launches over {OPT_CLI_STEPS} train CLI steps "
                  f"(and {OPT_CLI_STEPS} image summaries): {got}")
            check(len(recs) == OPT_CLI_STEPS and all(
                math.isfinite(r["total_loss"]) and r["elpips_calibrated"]
                is False for r in recs), f"{name} records")
            check(got["sweep"] == 2 * OPT_CLI_STEPS
                  and got["gather_sweep"] == OPT_CLI_STEPS * reg,
                  f"{name}: K1 once a step and once a summary, a gather "
                  f"sweep a step with the regularizer")
            print(f"{name} train CLI: {OPT_CLI_STEPS} steps in {wall:.2f} s "
                  f"(E-LPIPS features, summaries and checkpoint included) "
                  f"{tag}")
            metric = step_lib.build_elpips(cfg, dev)
            tstate, _, events, recs, peak, mem0 = run_train_loop(
                cfg, dev, reset_counts, read_counts, metric, nsteps)
            check(all(math.isfinite(r["total_loss"]) for r in recs),
                  f"{name} losses finite")
            step_line(f"{name} train", events[TRAIN_WARMUP - 1:], peak, mem0,
                      "; coord net, E-LPIPS, tgt_src_ref"
                      + (", transform_inverse_reg" if reg else ""))
            draw = metric.draw(1, torch.Generator().manual_seed(5), scale=1)
            pose = cameras.random_jitter_pose(
                torch.Generator().manual_seed(9), device=dev) if reg else None
            route_gate(f"{name} train step", cfg, tstate.net, tbatch, dev,
                       elpips=lambda p, t, g: metric(p, t, draws=[draw]),
                       loss_tol=None, jitter_pose=pose)
            del tstate, metric
        torch.cuda.empty_cache()

        # ---- (b) the high-res target ------------------------------------
        hcfg = entry.flagship_cfg(supervision="tgt_hrestgt")
        np_hb = hres_training_batch(hcfg)
        tstate, got, events, recs, peak, mem0 = run_train_loop(
            hcfg, dev, reset_counts, read_counts, None, OPT_STEPS,
            np_batches=itertools.repeat(np_hb))
        got.update({k: getattr(wc, a) for k, a in K7_COUNTS.items()})
        print(f"launches over {OPT_STEPS} hrestgt steps (wrap net, pixel "
              f"loss): {got}")
        check(got["sweep"] == 2 * OPT_STEPS, "hrestgt: K1 twice a step")
        for k in K7_COUNTS:
            check(got[k] == k7_per_step[k] * OPT_STEPS,
                  f"hrestgt: {k} {got[k]} launches, want path 5's "
                  f"{k7_per_step[k]} a step")
        check(all(math.isfinite(r["total_loss"]) for r in recs),
              "hrestgt losses finite")
        step_line("hrestgt train", events, peak, mem0,
                  f"; wrap net, pixel loss, {hcfg.hres_width}x"
                  f"{hcfg.hres_height} target")
        hb = dev_batch(np_hb)
        shapes = []
        real = sweep_ops.sweep_volume

        def spy(ref, *a, **k):
            shapes.append(tuple(ref.shape[1:3]))
            return real(ref, *a, **k)

        loss_fn = step_lib.make_loss_fn(hcfg, tstate.net)
        sweep_ops.sweep_volume = spy
        try:
            loss_fn(hb)[0].backward()
        finally:
            sweep_ops.sweep_volume = real
        check(shapes == [(h, w), (hcfg.hres_height, hcfg.hres_width)],
              f"hrestgt: K1 at {shapes}")
        eye = torch.eye(4, device=dev)[None]
        hres_tgt = msi_lib.preprocess_image(hb["hres_tgt_image"])
        tgt = msi_lib.preprocess_image(hb["tgt_image"])
        net = tstate.net
        steps = [
            ("sweep", lambda t: loss_fn.sweep(hb)),
            ("net_forward", lambda t: net(t["sweep"])),
            ("assemble_render", lambda t: loss_fn.render(
                t["sweep"], t["net_forward"], hb)),
            ("hres_sweep", lambda t: loss_fn.sweep_hres(hb)),
            ("hres_upsample_assemble", lambda t: msi_lib.assemble_hres_rgba(
                hcfg.which_color_pred, t["assemble_render"],
                t["hres_sweep"], hcfg.num_msi_planes)),
            ("hres_render", lambda t: msi_lib.render_equirect_view(
                t["hres_upsample_assemble"], eye, hb["tgt_pose"],
                loss_fn.msi_depths)),
            ("losses", lambda t: loss_fn.distance(
                t["assemble_render"]["output_image"], tgt)
                + loss_fn.distance(t["hres_render"], hres_tgt)),
            ("backward", lambda t: t["losses"].backward()),
            ("adam", lambda t: tstate.optimizer.step())]
        med, ppeak, _ = timed_parts(
            steps, OPT_REPS,
            lambda: tstate.optimizer.zero_grad(set_to_none=True))
        print("hrestgt train step parts " + " ".join(
            f"{k} {v:.3f}" for k, v in med.items())
              + f" ms (sum {sum(med.values()):.3f}; median of "
                f"{OPT_REPS - 1}), peak {ppeak / 2**30:.3f} GiB above the "
                f"held {tag}")
        del loss_fn
        route_gate("hrestgt train step", hcfg, tstate.net, hb, dev)
        del tstate
        torch.cuda.empty_cache()

        ecfg = entry.flagship_cfg(supervision="tgt_hrestgt",
                                  which_loss="elpips", coord_net=True)
        estate = state_lib.init_state(ecfg, 0, dev)
        metric = step_lib.build_elpips(ecfg, dev)
        draw = metric.draw(1, torch.Generator().manual_seed(5), scale=1)
        # a fresh Draw of the same transforms and mask seed for each term:
        # a Draw keeps the masks of the first images it saw, and the two
        # terms' images differ in size
        eloss = step_lib.make_loss_fn(
            ecfg, estate.net, elpips=lambda p, t, g: metric(
                p, t, draws=[elpips_api.Draw(draw.params, draw.seed)]))
        med, epeak, last = timed_parts(
            [("loss", lambda t: eloss(hb)[0]),
             ("backward", lambda t: t["loss"].backward()),
             ("adam", lambda t: estate.optimizer.step())], OPT_REPS,
            lambda: estate.optimizer.zero_grad(set_to_none=True))
        check(math.isfinite(last["loss"]), "E-LPIPS hrestgt loss finite")
        print(f"elpips hrestgt train step at a level-1 draw (coord net, "
              f"{ecfg.hres_width}x{ecfg.hres_height} target): "
              + " ".join(f"{k} {v:.3f}" for k, v in med.items())
              + f" ms (sum {sum(med.values()):.3f}), peak "
                f"{epeak / 2**30:.3f} GiB above the held {tag}")
        del estate, metric, eloss, hb
        torch.cuda.empty_cache()

        # ---- (c) remat_network on path 5's step -------------------------
        rstate = state_lib.init_state(fcfg, 0, dev)
        rcfg = dataclasses.replace(fcfg, remat_network=True)
        runs = {}
        for key, cfg in (("plain", fcfg), ("plain_again", fcfg),
                         ("remat", rcfg)):
            loss_fn = step_lib.make_loss_fn(cfg, rstate.net)
            counts = []

            def before(c=counts):
                rstate.net.zero_grad(set_to_none=True)
                torch.cuda.synchronize()
                c.append({k: getattr(wc, a) for k, a in K7_COUNTS.items()})

            med, rpeak, _ = timed_parts(
                [("forward", lambda t, f=loss_fn: f(tbatch)[0]),
                 ("backward", lambda t: t["forward"].backward())],
                OPT_REPS, before)
            torch.cuda.synchronize()
            per = {k: getattr(wc, a) - counts[-1][k]
                   for k, a in K7_COUNTS.items()}
            runs[key] = (med, rpeak, per, {
                n: p.grad.detach().clone()
                for n, p in rstate.net.named_parameters()})
        (pm, ppk, pper, g0), (_, _, _, g1), (rm, rpk, rper, gr) = (
            runs[k] for k in ("plain", "plain_again", "remat"))
        print(f"remat: K7 launches a step {rper} (without remat {pper})")
        for k in K7_COUNTS:
            want = k7_per_step[k] * (2 if k in ("wrap_conv_k7b",
                                                "wrap_conv_k7c") else 1)
            check(rper[k] == want and pper[k] == k7_per_step[k],
                  f"remat: {k} {rper[k]} a step, want {want}")
        noise = {n: (g1[n] - g0[n]).abs().max().item() for n in g0}
        diff = {n: (gr[n] - g0[n]).abs().max().item() for n in g0}
        bad = [n for n in g0 if diff[n] > 2 * noise[n]]
        print(f"remat gradients vs the step without it: max |diff| "
              f"{max(diff.values()):.3e} (two runs without remat differ by "
              f"{max(noise.values()):.3e}; "
              f"{sum(v == 0 for v in diff.values())} of {len(diff)} "
              f"parameters bit-equal) "
              f"{'ok' if not bad else 'FAIL ' + ', '.join(bad)}")
        check(not bad, f"remat gradients {bad}")
        print(f"remat step: forward {rm['forward']:.3f} backward "
              f"{rm['backward']:.3f} ms, peak {rpk / 2**30:.3f} GiB above "
              f"the held; without remat forward {pm['forward']:.3f} "
              f"backward {pm['backward']:.3f} ms, peak "
              f"{ppk / 2**30:.3f} GiB {tag}")
        check(rpk < ppk, "remat: the peak is lower")
        del rstate, runs, g0, g1, gr
        torch.cuda.empty_cache()

        # ---- (d) bfloat16 parameters ------------------------------------
        bcfg = entry.flagship_cfg(param_dtype="bfloat16")
        bstate, got, events, recs, peak, mem0 = run_train_loop(
            bcfg, dev, reset_counts, read_counts, None, OPT_STEPS)
        moments = [t for st in bstate.optimizer.state.values()
                   for t in (st["exp_avg"], st["exp_avg_sq"])]
        check(all(p.dtype == torch.bfloat16
                  for p in bstate.net.parameters())
              and len(moments) == 2 * len(list(bstate.net.parameters()))
              and all(t.dtype == torch.bfloat16 for t in moments),
              "param_dtype bfloat16: parameters and Adam moments")
        check(all(math.isfinite(r["total_loss"]) for r in recs),
              "bfloat16-parameter losses finite")
        step_line("bf16-parameter train", events, peak, mem0,
                  "; wrap net, pixel loss; losses " + " ".join(
                      f"{r['total_loss']:.2f}" for r in recs))
        del bstate, moments

        # ---- (e) dry runs and the profiler window -----------------------
        os.chdir(tmp)
        try:
            zero_all()
            cli_train.main(data + ["--experiment_name", "dry",
                                   "--supervision", "tgt_hrestgt",
                                   "--dry_run"])
            got = all_counts()
            files = set(os.listdir(f"{tmp}/dryrun/dry"))
            want = ({f"{p}{n}.png" for p in ("", "hres_")
                     for n in ("tgt", "src", "ref")}
                    | {f"formatInput_{i}.png"
                       for i in range(2 * fcfg.num_psv_planes)})
            check(files == want and got["sweep"] == 1,
                  f"--dry_run: {len(files)} files, {got['sweep']} K1")
            a_flags = (recipe_flags("ods-wotemp-elpips-coord") + data
                       + ["--supervision", "tgt_src_ref",
                          "--experiment_name", "srcref"])
            zero_all()
            cli_train.main(a_flags + ["--dry_run_inference"])
            got = all_counts()
            files = set(os.listdir(f"{tmp}/dryrun/srcref"))
            want_inf = (want - {f"hres_{n}.png" for n in ("tgt", "src",
                                                         "ref")}
                        | {f"msi_{k}_{i:02d}.png" for k in ("alpha", "rgb")
                           for i in range(fcfg.num_msi_planes)}
                        | {"tgt_rendered.png", "depth_rendered.png"})
            print(f"--dry_run_inference launches: {got}")
            check(files == want_inf, f"--dry_run_inference files "
                                     f"{sorted(files ^ want_inf)[:6]}")
            check(got["sweep"] == 1 and got["conv"] == 18
                  and got["conv_coord"] == 18 and got["conv_norm"] == 17
                  and got["render_layers"] == 1
                  and got["render_layers_both"] == 1,
                  "--dry_run_inference: K1, 18 coord convs, 17 layer "
                  "norms, one layer-stack render for image and depth")
        finally:
            os.chdir(cwd)
        cli_train.main(data + ["--experiment_name", "prof", "--max_steps",
                               "3", "--summary_freq", "3",
                               "--profile_steps", "2,3"])
        trace = f"{tmp}/ckpt/prof/profile/trace_2_3.json"
        with open(trace) as fh:
            events = json.load(fh)["traceEvents"]
        dev_events = [e for e in events if e.get("cat") == "kernel"]
        print(f"--profile_steps 2,3: {trace.rsplit('/', 1)[1]}, "
              f"{len(events)} events, {len(dev_events)} device kernels")
        check(len(dev_events) > 0, "--profile_steps trace has device "
                                   "kernels")

        # ---- (f) use_pallas false ---------------------------------------
        ucfg = dataclasses.replace(fcfg, use_pallas=False)
        batch = entry.synthetic_batch(fcfg, 0, dev,
                                      tgt_pos=(0.03, 0.01, -0.02))
        outs, params = {}, None
        for key, cfg in (("default", fcfg), ("use_pallas_false", ucfg)):
            params = entry.make_params(cfg, seed=0, device=dev)
            infer = cli_test.build_infer_fn(cfg, params, "tgt_image")
            zero_all()
            t_ms = time_ms(lambda: infer(batch), iters=3, warmup=1)
            zero_all()
            outs[key] = infer(batch)
            got = all_counts()
            print(f"test CLI request, {key} route: {t_ms:.3f} ms; "
                  f"launches {got} {tag}")
        check(all(got[k] == 0 for k in kernels) and got["gather_sweep"] == 1,
              "use_pallas false request: no kernel, one gather sweep")
        # its all-plain f32 twin: the gather sweep, the plain net and the
        # gather renders in float32
        with torch.no_grad():
            asm = msi_lib.infer_msi(params.net, ucfg, batch,
                                    params.psv_depths, dtype=torch.float32)
            eye = torch.eye(4, device=dev)[None]
            twin = {"output_image": msi_lib.deprocess_image(
                msi_lib.render_equirect_view(
                    asm["rgba_layers"], eye, batch["tgt_pose"],
                    params.msi_depths)),
                "output_depth": msi_lib.render_equirect_depth(
                    asm["rgba_layers"], eye, batch["tgt_pose"],
                    params.msi_depths)}
        del asm, params
        for k in ("output_image", "output_depth"):
            got = outs["use_pallas_false"][k]
            err = (got - twin[k]).abs()
            print(f"use_pallas false {k} vs its all-plain f32 twin: max "
                  f"{err.max().item():.3e} mean {err.mean().item():.3e} "
                  f"(gate {E2E_TOL:.0e})")
            check(err.max().item() <= E2E_TOL, f"use_pallas false {k}")
            # against the default route the far shell parks other pixels:
            # the gather takes the f32 discriminant's sign, K1 the
            # analytic validity (ROADMAP Queue 3, park-flip noise)
            err = (got - outs["default"][k]).abs()
            share = (err > E2E_TOL).float().mean().item()
            print(f"use_pallas false {k} vs the default route: max "
                  f"{err.max().item():.3e} mean {err.mean().item():.3e}, "
                  f"{share:.2e} of the values beyond {E2E_TOL:.0e} (gate "
                  f"{PARK_SHARE:.0e})")
            check(share <= PARK_SHARE, f"use_pallas false {k} vs default")
        losses = {}
        for key, cfg in (("default", fcfg), ("use_pallas_false", ucfg)):
            st = state_lib.init_state(cfg, 0, dev)
            step_fn = step_lib.make_train_step(cfg, st.net)
            zero_all()
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
            st, m = step_fn(st, tbatch)
            ev[1].record()
            got = all_counts()
            losses[key] = float(m["total_loss"])
            print(f"train step, {key} route: "
                  f"{ev[0].elapsed_time(ev[1]):.3f} ms (first step), loss "
                  f"{losses[key]:.4f}; launches {got} {tag}")
        check(all(got[k] == 0 for k in kernels) and got["gather_sweep"] == 1,
              "use_pallas false train step: no kernel, one gather sweep")
        rel = abs(losses["use_pallas_false"] - losses["default"]) / abs(
            losses["default"])
        print(f"use_pallas false train loss vs the default route: rel "
              f"{rel:.3e} (gate {TRAIN_LOSS_TOL:.0e})")
        check(rel <= TRAIN_LOSS_TOL, "use_pallas false train loss")


def export_full_path(dev, tag, reset_counts, read_counts):
    """Path 14a: cli/export.main --net_only false --platform cuda, coord
    net, float32 and bfloat16, and bfloat16 again with --with_preprocess
    and a seeded remap field (an ERP warp jittered by up to half a pixel)
    for both eyes, into a temporary directory. First the op itself: the
    op library's matry::sweep_volume on the flagship batch equals
    sweep_ops.sweep_volume bit for bit, float32 and bfloat16, one launch
    each. The three consumer-tool runs (subprocesses, as scripts, with
    PYTHONPATH="", each loading the op library copied beside its program
    and no module) run side by side, each with --count_kernels: per call
    K1's kernel once and no other kernel of the port, read from the
    consumer's printout, and no module of either package or JAX imported.
    Per program in this process: K1 once a call (the op library's count;
    no launch of the Python wrappers); within EXPORT_TOL of the eager
    function (the
    same operations; cuDNN may pick other f32 algorithms in the loaded
    graph, as path 11 measured); in bf16 the test CLI's kernel-route
    rgba_layers on the same (processed) images held to the float32
    function within max(E2E_TOL, TRAIN_GRAD_MARGIN x the bf16 program's
    distance from it), path 11's rule (two bf16 routes' errors from
    float32 add, so they are not held to each other); the export's
    seconds, the artifact's bytes, the program's and the eager function's
    ms a call (CUDA events, median of 10)."""
    import warnings

    import re

    from matryodshka_tpu_torch import entry, weights
    from matryodshka_tpu_torch.cli import export as export_cli
    from matryodshka_tpu_torch.cli import test as cli_test
    from matryodshka_tpu_torch.geometry.sweep import inv_depths
    from matryodshka_tpu_torch.ops import sweep as sweep_ops
    from matryodshka_tpu_torch.trace import PORT_KERNELS

    base = entry.flagship_cfg()
    b0 = entry.synthetic_batch(base, 14, dev)
    depths = torch.tensor(inv_depths(base.min_depth, base.max_depth,
                                     base.num_psv_planes), device=dev)
    for dt in (torch.float32, torch.bfloat16):
        sweep_in = (b0["ref_image"], b0["src_image"], depths,
                    b0["intrinsics"])
        n = sweep_ops.op_launches()
        got = sweep_ops.sweep_volume_op(*sweep_in, dt)
        torch.cuda.synchronize()
        check(sweep_ops.op_launches() == n + 1,
              "the op library's sweep_volume is one launch")
        want = sweep_ops.sweep_volume(*sweep_in, dt)
        same = bool(torch.equal(got, want))
        print(f"op library matry::sweep_volume {str(dt)[6:]} "
              f"{tuple(got.shape)}: bit-equal to sweep_volume {same}")
        check(same, f"the op library's sweep_volume ({dt}) against "
                    f"sweep_volume")
    del b0, got, want, sweep_in

    consumer = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "matryodshka_tpu_torch", "tools",
                            "consume_export.py")
    h, w, p = base.height, base.width, base.num_msi_planes
    with tempfile.TemporaryDirectory() as d:
        rng = np.random.RandomState(14)
        y, x = np.mgrid[0:h, 0:w].astype(np.float32)
        field = np.stack([x, y], -1) + rng.uniform(
            -0.5, 0.5, (h, w, 2)).astype(np.float32)
        remap = os.path.join(d, "remap.npy")
        np.save(remap, field)
        runs = [("full_float32", "float32", []),
                ("full_bfloat16", "bfloat16", []),
                ("preprocess_bfloat16", "bfloat16",
                 ["--with_preprocess", "--remap_ref", remap,
                  "--remap_src", remap])]
        paths, procs, results = {}, {}, {}
        for name, dtype, extra in runs:
            flags = ["--height", str(h), "--width", str(w),
                     "--num_psv_planes", str(p), "--num_msi_planes", str(p),
                     "--ngf", str(base.ngf), "--coord_net", "true",
                     "--net_only", "false", "--platform", "cuda",
                     "--compute_dtype", dtype, "--export_dir", d,
                     "--export_name", name,
                     "--checkpoint_dir", os.path.join(d, "none")] + extra
            t0 = time.perf_counter()
            with warnings.catch_warnings():
                warnings.filterwarnings("ignore", message=".*no checkpoint")
                paths[name] = export_cli.main(flags)
            secs = time.perf_counter() - t0
            size = os.path.getsize(paths[name])
            procs[name] = subprocess.Popen(
                [sys.executable, consumer, paths[name], "--device", "cuda",
                 "--out", os.path.join(d, f"out_{name}.npy"),
                 "--count_kernels"],
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                cwd=d, env=dict(os.environ, PYTHONPATH="",
                                PYTHONFAULTHANDLER="1"))
            args = export_cli.build_parser().parse_args(flags)
            cfg = export_cli.config_from_args(args)
            tree = weights.seeded_init(cfg, 0)
            b = entry.synthetic_batch(cfg, 14, dev)
            cfg32 = dataclasses.replace(cfg, compute_dtype="float32")
            if args.with_preprocess:
                inputs = [(b[k][0] * 255.0).to(torch.uint8).reshape(-1)
                          for k in ("ref_image", "src_image")]
                eager = export_cli.build_preprocessed_fn(cfg, tree, args, dev)
                eager32 = export_cli.build_preprocessed_fn(cfg32, tree, args,
                                                           dev)
                with torch.no_grad():
                    b = dict(b, ref_image=eager.proc_ref(inputs[0])[None],
                             src_image=eager.proc_src(inputs[1])[None])
            else:
                inputs = [b[k].contiguous() for k in (
                    "ref_image", "src_image", "ref_pose", "src_pose",
                    "ref_pose_inv", "intrinsics")]
                eager = export_cli.build_full_fn(cfg, tree, dev)
                eager32 = export_cli.build_full_fn(cfg32, tree, dev)
            program = torch.export.load(paths[name]).module()
            with torch.no_grad():
                reset_counts()
                n = sweep_ops.op_launches()
                got = program(*inputs)
                launches = read_counts()
                launches["sweep_op"] = sweep_ops.op_launches() - n
                want = eager(*inputs)
                want32 = eager32(*inputs)
            err = (got.float() - want.float()).abs().max().item()
            print(f"export {name}: launches of one call of the loaded "
                  f"program {launches}; vs the eager function max abs "
                  f"{err:.3e} (tol {EXPORT_TOL[dtype]:.0e}), bit-equal "
                  f"{bool(torch.equal(got, want))}; shape "
                  f"{tuple(got.shape)} {str(got.dtype)[6:]}")
            check(launches["sweep_op"] == 1 and launches["sweep"] == 0
                  and launches["conv"] == 0,
                  f"export {name}: K1 once a call through the op library, "
                  f"no conv kernel")
            check(tuple(got.shape) == (1, h, w, p, 4)
                  and got.dtype == cfg.torch_compute_dtype
                  and bool(torch.isfinite(got.float()).all())
                  and err <= EXPORT_TOL[dtype], f"export {name} round trip")
            if dtype == "bfloat16":
                params = entry.make_params(cfg, flax_params=tree, device=dev)
                reset_counts()
                kern = cli_test.build_infer_fn(cfg, params, "rgba_layers")(
                    b)["rgba_layers"].float()
                kl = read_counts()
                check(kl["sweep"] == 1 and kl["conv_coord"] == 18,
                      f"export {name}: the kernel route's K1 and 18 coord "
                      f"convs")
                berr = (got.float() - want32.float()).abs().max().item()
                kerr = (kern - want32.float()).abs().max().item()
                tol = max(E2E_TOL, TRAIN_GRAD_MARGIN * berr)
                print(f"export {name}: the test CLI's kernel-route "
                      f"rgba_layers (K1, K2c) vs the f32 function max abs "
                      f"{kerr:.3e}, the bf16 program vs it {berr:.3e} (gate "
                      f"max({E2E_TOL:.0e}, {TRAIN_GRAD_MARGIN} x that) = "
                      f"{tol:.3e}); kernel route vs the bf16 program "
                      f"{(kern - got.float()).abs().max().item():.3e}")
                check(kerr <= tol, f"export {name} vs the kernel route")
                del params, kern
            with torch.no_grad():
                prog_ms = time_ms(lambda: program(*inputs))
                eager_ms = time_ms(lambda: eager(*inputs))
            results[name] = got.float()
            print(f"export {name} (coord net, full pipeline, {w}x{h}, {p}+{p} "
                  f"planes, ngf {base.ngf}): export {secs:.2f} s, artifact {size} "
                  f"bytes; loaded program {prog_ms:.3f} ms per call, eager "
                  f"function {eager_ms:.3f} ms (CUDA events, median of 10) "
                  f"{tag}")
            del program, eager, eager32, got, want, want32
        for name, proc in procs.items():
            out, errs = proc.communicate(timeout=600)
            print(out.strip())
            check(proc.returncode == 0, f"consumer tool on {name}: exit "
                                        f"{proc.returncode}; {errs[-2000:]}")
            imported = out.split("imported: ")[-1].strip()
            check("loaded op library libmatry_ops-" in out
                  and imported == "[]",
                  f"the consumer of {name} loaded the op library and "
                  f"imported no module: {imported}")
            counts = json.loads(out.split("device kernels of one call: ")[1]
                                .splitlines()[0])
            k1 = sum(n for k, n in counts.items()
                     if re.search(r"\bsweep_kernel\b", k))
            port = {k: n for k, n in counts.items()
                    if re.search(r"\b(" + "|".join(PORT_KERNELS) + r")\b",
                                 k) and not re.search(r"\bsweep_kernel\b",
                                                      k)}
            print(f"consumer {name}: {sum(counts.values())} device kernels "
                  f"in one call, K1's {k1}, other kernels of the port "
                  f"{port or 'none'}")
            check(k1 == 1 and not port,
                  f"the consumer of {name}: K1 once a call, no other kernel "
                  f"of the port")


def smoothed_path(dev, tag, reset_counts, read_counts, k7_per_step, gate):
    """Path 14b-c: the smoothed net (nearest 2x and a 4x4 conv in place of
    each transposed conv). (b) entry.forward, wrap and coord net, one
    request each: 18 conv launches (the three upsampling stages in the
    conv kernel's folded parity form), 17 with the layer norm fused, the
    view within E2E_TOL of the all-plain f32 route, the frame's ms; the
    three upsampling stages' conv kernel against its plain version (gate)
    and their kernel ms beside the transposed net's same stages on the
    same inputs. (c) The smoothed wrap net's trainer for SMOOTH_STEPS
    steps: K7 at path 5's count a step (the upsampling convs are PyTorch
    ops with autograd, as the JAX trainer's are XLA convs), the step's ms,
    and one step's loss and gradients against the all-plain routes
    (route_gate)."""
    from matryodshka_tpu_torch import entry
    from matryodshka_tpu_torch.ops import conv as conv_ops

    rng = torch.Generator(device=dev).manual_seed(1414)
    for coord in (False, True):
        net = "coord" if coord else "wrap"
        scfg = entry.flagship_cfg(smoothed=True, coord_net=coord)
        sparams = entry.make_params(scfg, seed=0, device=dev)
        tparams = entry.make_params(entry.flagship_cfg(coord_net=coord),
                                    seed=0, device=dev)
        sb = entry.synthetic_batch(scfg, 21, dev, tgt_pos=(0.03, 0.01, -0.02))
        reset_counts()
        out = entry.forward(sparams, sb)
        got = read_counts()
        print(f"launches of the smoothed {net} net's entry.forward: {got}")
        check(got["sweep"] == got["render"] == 1 and got["conv"] == 18
              and got["conv_wgmma"] == 18
              and got["conv_norm"] == got["conv_stats"] == 17
              and got["conv_coord"] == (18 if coord else 0),
              f"smoothed {net}: one sweep, 18 conv (17 with the layer norm "
              f"fused), one render")
        err = (out - entry.forward_plain(sparams, sb)).abs()
        print(f"smoothed {net} request: |bf16 kernels - f32 plain| max "
              f"{err.max().item():.3e} mean {err.mean().item():.3e} (gate "
              f"{E2E_TOL:.0e})")
        check(bool(torch.isfinite(out).all())
              and err.max().item() <= E2E_TOL, f"smoothed {net} vs plain")
        frame_ms = time_ms(lambda: entry.forward(sparams, sb))
        line = []
        for plan, st, tt in zip(sparams.net.plan, sparams.stages,
                                tparams.stages):
            name, _, _, cins, _, ind, _, _ = plan
            if name not in UP_STAGES:
                continue
            cin = sum(cins)
            x = (torch.rand((1, cin, scfg.height // ind, scfg.width // ind),
                            generator=rng, device=dev) * 2 - 1).to(
                                torch.bfloat16)
            y = conv_ops.conv(x, st["w"], st["b"], **st["args"])
            yp = conv_ops.conv_plain(x, st["w"], st["b"], **st["args"])
            gate("conv_coord" if coord else "conv",
                 f"{name} smoothed {tuple(x.shape[1:])}", y, yp,
                 2.0 ** -7 * yp.float().abs().max().item())
            sm = time_ms(lambda: conv_ops.conv(x, st["w"], st["b"],
                                               **st["args"]))
            tm = time_ms(lambda: conv_ops.conv(x, tt["w"], tt["b"],
                                               **tt["args"]))
            # GFLOP: the four parities' 9 + 6 + 6 + 4 folded taps, against
            # the transposed form's 4 x 4, per input pixel
            gf = 2.0 * cin * st["w"].shape[2] * x.shape[2] * x.shape[3] / 1e9
            line.append(f"{name} {sm:.3f} ({25 * gf:.2f} GFLOP, "
                        f"{25 * gf / sm:.1f} TFLOP/s) vs transposed {tm:.3f} "
                        f"({16 * gf:.2f} GFLOP, {16 * gf / tm:.1f} TFLOP/s)")
        print(f"smoothed {net} frame {frame_ms:.3f} ms (entry.forward, CUDA "
              f"events, median of 10); upsampling stages, conv kernel ms: "
              + "; ".join(line) + f" {tag}")
        del sparams, tparams

    tcfg = entry.flagship_cfg(smoothed=True)
    tstate, launches, events, records, peak, mem0 = run_train_loop(
        tcfg, dev, reset_counts, read_counts, None, SMOOTH_STEPS)
    print(f"launches over {SMOOTH_STEPS} smoothed wrap-net training steps: "
          f"{launches}")
    for k in K7_COUNTS:
        check(launches[k] == k7_per_step[k] * SMOOTH_STEPS,
              f"smoothed trainer: {k} {launches[k]}, path 5's "
              f"{k7_per_step[k]} a step")
    check(launches["sweep"] == SMOOTH_STEPS, "smoothed trainer: K1 a step")
    losses = [r["total_loss"] for r in records]
    check(len(losses) == SMOOTH_STEPS
          and all(math.isfinite(v) for v in losses),
          "smoothed trainer: finite losses")
    step_ms = [s.elapsed_time(e) for s, e in events]
    print(f"smoothed train step {statistics.median(step_ms[1:]):.3f} ms "
          f"(median of {SMOOTH_STEPS - 1} after 1 warm-up; wrap net, pixel "
          f"loss, 640x320, 32+32 planes, ngf 64, bf16, batch 1), peak "
          f"{(peak - mem0) / 2**30:.3f} GiB above the held {tag}")
    tbatch = {k: torch.from_numpy(v).to(dev)
              for k, v in training_batch(tcfg).items()}
    route_gate("smoothed train step", tcfg, tstate.net, tbatch, dev)


def hres_schemes_path(dev, tag, cli, cli_outs, hres_images, reset_counts,
                      read_counts, gate_e2e):
    """Path 14d: the test CLI's 4096x2048 re-render for blend_bg,
    blend_bg_psv and alpha_only from path 2's requests of those schemes
    (their saved outputs: alphas, blend_weights where the scheme's rule
    blends, bg_rgb for blend_bg), each with its colour rule
    (cli/test.py:HRES_ASSEMBLY): one launch of the sweep's assembled mode
    at 4096x2048 (no K1 volume) and one K5 launch for image and depth, no
    uv_tables; image and depth against hres_render_plain (path 3's gates);
    ms (median of 3) and peak memory, whole and in SHELL_BLOCKS shell
    blocks (one assembled-sweep and one partial-mode launch a block)."""
    from matryodshka_tpu_torch.cli import test as cli_test

    eye = torch.eye(4, device=dev)[None]
    for (scheme, c, _, b), o in zip(cli, cli_outs):
        if scheme == "blend_psv":
            continue
        low = {k: o[k] for k in cli_test.hres_inputs(scheme)}
        args = (*hres_images, low.get("blend_weights"), low["alphas"], eye,
                eye, eye, b["intrinsics"], b["tgt_pose"])
        render = cli_test.build_hres_render_fn(c)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        mem0 = torch.cuda.memory_allocated()
        reset_counts()
        rgb, depth = render(*args, bg_rgb=low.get("bg_rgb"))
        got = read_counts()
        peak = torch.cuda.max_memory_allocated()
        print(f"launches of the {scheme} 4096x2048 re-render (reads "
              f"{sorted(low)}): {got}")
        check(got["sweep_assembled"] == got["render_layers"] == got[
            "render_layers_both"] == 1 and got["uv_tables"] == 0
              and got["sweep"] == got["conv"] == 0,
              f"hres {scheme}: one assembled-sweep and one K5 launch, no "
              f"K1 volume, no lookup tables")
        rgb_p, depth_p = cli_test.hres_render_plain(
            c, hres_images[0], hres_images[1], low.get("blend_weights"),
            low["alphas"], b["intrinsics"], b["tgt_pose"],
            bg_rgb=low.get("bg_rgb"))
        gate_e2e(f"hres {scheme} 4096x2048",
                 {"output_image": rgb, "output_depth": depth},
                 {"output_image": rgb_p, "output_depth": depth_p})
        del rgb, depth, rgb_p, depth_p
        ms = time_ms(lambda: render(*args, bg_rgb=low.get("bg_rgb")),
                     iters=3, warmup=1)
        print(f"hres {scheme} 4096x2048 e2e {ms:.3f} ms (median of 3); "
              f"peak {peak / 2**30:.3f} GiB ({(peak - mem0) / 2**30:.3f} "
              f"GiB above the {mem0 / 2**30:.3f} GiB held before) {tag}")
        blocks = cli_test.build_hres_render_fn(c, shards=SHELL_BLOCKS)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        mem0 = torch.cuda.memory_allocated()
        reset_counts()
        brgb, bdepth = blocks(*args, bg_rgb=low.get("bg_rgb"))
        got = read_counts()
        bpeak = torch.cuda.max_memory_allocated()
        check(got["sweep_assembled"] == got["render_layers_partial"]
              == SHELL_BLOCKS and got["sweep"] == got["render_layers"] == 0,
              f"hres {scheme} in {SHELL_BLOCKS} blocks: one assembled-sweep "
              f"and one partial-mode launch a block")
        whole = render(*args, bg_rgb=low.get("bg_rgb"))
        berr = max((brgb - whole[0]).abs().max().item(),
                   (bdepth - whole[1]).abs().max().item())
        check(berr <= 1e-5, f"hres {scheme}: {SHELL_BLOCKS} blocks vs the "
                            f"whole render {berr:.3e}")
        del brgb, bdepth, whole
        bms = time_ms(lambda: blocks(*args, bg_rgb=low.get("bg_rgb")),
                      iters=3, warmup=1)
        print(f"hres {scheme} 4096x2048 in {SHELL_BLOCKS} shell blocks e2e "
              f"{bms:.3f} ms (median of 3); peak {bpeak / 2**30:.3f} GiB "
              f"({(bpeak - mem0) / 2**30:.3f} GiB above the "
              f"{mem0 / 2**30:.3f} GiB held before); vs the whole "
              f"{berr:.3e} {tag}")


def start_mesh_generation(cfg):
    """Start generating the GCN's mesh cache (geometry/icosphere.py at
    cfg.subdiv for cfg's grid, numpy on the host: minutes of CPU at subdiv
    7) in a subprocess, so it overlaps the kernels' build; None when
    cfg.mesh_dir holds it already. The subprocess prints its wall time;
    finish_mesh_generation waits for it."""
    path = os.path.join(cfg.mesh_dir, f"sphere{cfg.subdiv}_{cfg.height}x"
                                      f"{cfg.width}.npz")
    if os.path.exists(path):
        return None
    code = ("import time; t = time.perf_counter(); "
            "from matryodshka_tpu_torch.geometry import icosphere; "
            f"icosphere.load_mesh_input({cfg.subdiv}, {cfg.height}, "
            f"{cfg.width}, {cfg.mesh_dir!r}); "
            "print(f'{time.perf_counter() - t:.1f}')")
    proc = subprocess.Popen([sys.executable, "-c", code],
                            cwd=os.path.dirname(os.path.abspath(__file__)),
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
    # stopped at exit if a check ends the run first
    atexit.register(lambda: proc.poll() is None and proc.kill())
    return proc


def finish_mesh_generation(proc, cfg, tag, since: float) -> None:
    """Wait for start_mesh_generation's subprocess (if any), so that no
    timed path shares the host's cores with it; print its wall time and
    how long the run waited for it after the build (since: the clock when
    the build ended)."""
    if proc is None:
        return
    out = proc.communicate(timeout=900)[0]
    check(proc.returncode == 0, f"mesh generation failed: {out}")
    print(f"gcn mesh subdiv {cfg.subdiv} {cfg.width}x{cfg.height} generated "
          f"in {out.strip()} s (a subprocess beside the kernels' build, into "
          f"{cfg.mesh_dir}); the run waited {time.perf_counter() - since:.1f}"
          f" s for it after the build {tag}")


def gcn_path(dev, tag, reset_counts, read_counts, gate_e2e):
    """Path 15a-b: the GCN (--gcn true) at full width, subdiv GCN_SUBDIV.
    (a) The test CLI's request for blend_psv (image and depth through K3's
    two modes) and blend_bg (the prepared assembly and one layer-stack
    launch for both): one K1 launch each, no conv launch, no
    lookup tables; each view and depth within E2E_TOL of the all-plain f32
    route (infer_plain); the request's stages and the GCN forward timed.
    (b) The GCN trainer through training/loop.train for GCN_STEPS steps on
    one in-memory batch (K1 once a step), the step's median, peak memory
    and parts, and one step's loss and gradients against the all-plain
    f32 route (the plain sweep in place of K1; the GCN is float32 in both,
    as the JAX GCN is). Returns the launches of (a) and (b)."""
    from matryodshka_tpu_torch import entry
    from matryodshka_tpu_torch.cli import test as cli_test
    from matryodshka_tpu_torch.models import gcn as gcn_lib
    from matryodshka_tpu_torch.models import msi as msi_lib
    from matryodshka_tpu_torch.ops import sweep as sweep_ops
    from matryodshka_tpu_torch.training import step as step_lib

    gcfg = entry.flagship_cfg(gcn=True, subdiv=GCN_SUBDIV)
    launches = {}
    for scheme, seed, pos in CLI_REQUESTS[:2]:
        c = dataclasses.replace(gcfg, which_color_pred=scheme)
        t0 = time.perf_counter()
        prm = entry.make_params(c, seed=0, device=dev)
        load_s = time.perf_counter() - t0
        coords, p2v = prm.gcn_inputs
        print(f"gcn {scheme}: mesh loaded from the cache and the GCN built "
              f"in {load_s:.2f} s: V {coords.shape[0]}, edges "
              f"{prm.net.supports[1].rows.numel()}, "
              f"{sum(q.numel() for q in prm.net.parameters())} parameters")
        b = entry.synthetic_batch(c, seed, dev, tgt_pos=pos)
        infer = cli_test.build_infer_fn(c, prm, "tgt_image")
        reset_counts()
        got = infer(b)
        n = read_counts()
        launches[scheme] = n
        print(f"launches of the gcn {scheme} test CLI request: {n}")
        want = ({"render": 1, "render_depth": 1, "render_layers": 0}
                if scheme == "blend_psv" else
                {"render": 0, "render_layers": 1, "render_layers_both": 1})
        check(n["sweep"] == 1 and n["conv"] == n["conv_norm"] == 0
              and n["uv_tables"] == 0
              and all(n[k] == v for k, v in want.items()),
              f"gcn {scheme}: one K1 and one render launch per output set")
        gate_e2e(f"gcn cli {scheme} tgt_pos {pos}", got,
                 cli_test.infer_plain(c, prm, b))
        with torch.no_grad():
            x = msi_lib.gcn_vertex_input(b, prm.psv_depths, coords)
            y = prm.net(x)
            pred = gcn_lib.mesh_to_equirect(y, p2v).permute(0, 3, 1, 2)
            vol = sweep_ops.sweep_volume(b["ref_image"], b["src_image"],
                                         prm.psv_depths, b["intrinsics"])
            po = msi_lib.assemble_outputs_planar(msi_lib.gcn_cfg(c), vol,
                                                 pred.contiguous())
            eye = torch.eye(4, device=dev)[None]
            ms = {
                "sweep_k1": time_ms(lambda: sweep_ops.sweep_volume(
                    b["ref_image"], b["src_image"], prm.psv_depths,
                    b["intrinsics"])),
                "vertex_sweep": time_ms(lambda: msi_lib.gcn_vertex_input(
                    b, prm.psv_depths, coords)),
                "gcn_forward": time_ms(lambda: prm.net(x)),
                "mesh_to_equirect": time_ms(
                    lambda: gcn_lib.mesh_to_equirect(y, p2v)),
                "assemble": time_ms(lambda: msi_lib.assemble_outputs_planar(
                    msi_lib.gcn_cfg(c), vol, pred.contiguous())),
                "render_depth": time_ms(
                    lambda: msi_lib.render_view_and_depth_from_prepared(
                        po, eye, b["tgt_pose"], prm.msi_depths)),
                "e2e": time_ms(lambda: infer(b), iters=5),
                "e2e_plain_f32": time_ms(
                    lambda: cli_test.infer_plain(c, prm, b), iters=3),
            }
        print(f"gcn cli {scheme:9s} " + " ".join(
            f"{k} {t:.3f}" for k, t in ms.items()) + f" ms {tag}")
        del x, y, pred, vol, po

    # (b) the GCN trainer
    tstate, tl, step_events, records, peak, mem0 = run_train_loop(
        gcfg, dev, reset_counts, read_counts, None, GCN_STEPS)
    launches["train"] = tl
    losses = [r["total_loss"] for r in records]
    print(f"launches over {GCN_STEPS} gcn training steps: {tl}")
    check(tstate.step == GCN_STEPS and tl["sweep"] == GCN_STEPS
          and tl["conv"] == 0 and tl["wrap_conv_k7c"] == 0,
          "gcn trainer: one K1 launch a step, no conv kernel")
    check(all(math.isfinite(v) for v in losses), "gcn losses are finite")
    step_ms = statistics.median(s.elapsed_time(e) for s, e in step_events[1:])
    print(f"gcn train step {step_ms:.3f} ms (median of {GCN_STEPS - 1} after "
          f"1 warm-up; 640x320, 32+32 planes, subdiv {GCN_SUBDIV}, ngf 64, "
          f"f32 GCN, batch 1), peak device memory {peak / 2**30:.3f} GiB "
          f"({(peak - mem0) / 2**30:.3f} GiB above the {mem0 / 2**30:.3f} "
          f"GiB held before) {tag}")
    print("gcn train losses on one repeated batch: "
          + " ".join(f"{v:.3f}" for v in losses))
    tb = {k: torch.from_numpy(v).to(dev)
          for k, v in training_batch(gcfg).items()}
    coords, p2v = tstate.gcn_inputs
    loss_fn = step_lib.make_loss_fn(gcfg, tstate.net,
                                    gcn_inputs=tstate.gcn_inputs)
    opt = tstate.optimizer
    parts, ppeak, _ = timed_parts([
        ("sweep", lambda v: loss_fn.sweep(tb)),
        ("vertex_sweep", lambda v: msi_lib.gcn_vertex_input(
            tb, loss_fn.psv_depths, coords)),
        ("gcn_forward", lambda v: tstate.net(v["vertex_sweep"])),
        ("mesh_to_equirect", lambda v: gcn_lib.mesh_to_equirect(
            v["gcn_forward"], p2v).permute(0, 3, 1, 2)),
        ("assemble_render_loss", lambda v: loss_fn.tail(
            tb, v["sweep"], v["mesh_to_equirect"])[0]),
        ("backward", lambda v: v["assemble_render_loss"].backward()),
        ("optimizer", lambda v: opt.step())], GCN_STEPS,
        before=lambda: opt.zero_grad(set_to_none=True))
    print("gcn train step parts " + " ".join(
        f"{k} {t:.3f}" for k, t in parts.items())
          + f" ms (median of {GCN_STEPS - 1}); peak "
            f"{ppeak / 2**30:.3f} GiB above the held {tag}")

    def plain_sweep(c, b, d):
        imgs, rowp = sweep_ops.sweep_inputs(
            msi_lib.preprocess_image(b["ref_image"]),
            msi_lib.preprocess_image(b["src_image"]), d, b["intrinsics"])
        return sweep_ops.ods_sweep_plain(imgs, rowp, torch.float32)

    routes = {}
    for key, sweep in (("kernel", None), ("plain", plain_sweep)):
        tstate.net.zero_grad(set_to_none=True)
        loss_r, _ = step_lib.make_loss_fn(
            gcfg, tstate.net, sweep, gcn_inputs=tstate.gcn_inputs)(tb)
        loss_r.backward()
        routes[key] = (loss_r.item(), {n: q.grad.detach().clone()
                                       for n, q in
                                       tstate.net.named_parameters()})
    (lk, gk), (lp, gp) = routes["kernel"], routes["plain"]
    rel = {n: ((gk[n] - gp[n]).norm() / gp[n].norm()).item() for n in gp}
    worst = max(rel.values())
    print(f"gcn train step kernel route vs all-plain f32: loss {lk:.4f} vs "
          f"{lp:.4f}, rel {abs(lk - lp) / abs(lp):.3e} (tol "
          f"{TRAIN_LOSS_TOL:.0e}); gradients rel L2 median "
          f"{statistics.median(rel.values()):.3e}, worst {worst:.3e} (tol "
          f"{TRAIN_GRAD_TOL:.0e}) over {len(rel)} parameters")
    check(abs(lk - lp) / abs(lp) <= TRAIN_LOSS_TOL and worst
          <= TRAIN_GRAD_TOL, "gcn step, kernel vs all-plain f32 route")
    return launches


def dp_path(dev, tag, reset_counts, read_counts):
    """Path 15c: a one-rank NCCL process group (parallel/mesh.init, a file
    store): dp.make_dp_train_step on the default ODS trainer (K1, K7, the
    gradients all-reduced) against the single-device step from the same
    parameters on the same batch, then the chained call
    (make_dp_train_multi_step, steps_per_call=DP_STEPS) against DP_STEPS
    single steps; launch counts and times beside the single step's."""
    import torch.distributed as dist

    from matryodshka_tpu_torch import entry
    from matryodshka_tpu_torch.ops import wrap_conv as wc
    from matryodshka_tpu_torch.parallel import dp, mesh
    from matryodshka_tpu_torch.training import state as state_lib
    from matryodshka_tpu_torch.training import step as step_lib

    tcfg = entry.flagship_cfg()
    batches = []
    for i in range(DP_STEPS):
        nb = training_batch(tcfg)
        nb["tgt_pose"] = nb["tgt_pose"] * (1.0 + 0.1 * i)
        batches.append({k: torch.from_numpy(v).to(dev)
                        for k, v in nb.items()})
    # the single steps, built outside a process group: make_train_step
    # built in one is data-parallel
    s_pl = state_lib.init_state(tcfg, 0, dev)
    step_pl = step_lib.make_train_step(tcfg, s_pl.net)
    s_s = state_lib.init_state(tcfg, 0, dev)
    single = step_lib.make_train_step(tcfg, s_s.net)
    with tempfile.TemporaryDirectory() as store:
        mesh.init(0, 1, f"file://{store}/store", dev)
        try:
            check(dist.get_backend() == "nccl", "the group's backend is NCCL")
            s_dp = state_lib.init_state(tcfg, 0, dev)
            step_dp = dp.make_dp_train_step(tcfg, s_dp.net)
            reset_counts()
            for attr in K7_COUNTS.values():
                setattr(wc, attr, 0)
            s_dp, m_dp = step_dp(s_dp, batches[0])
            n = read_counts()
            n.update({k: getattr(wc, a) for k, a in K7_COUNTS.items()})
            print(f"launches of one data-parallel step (one NCCL rank): {n}")
            check(n["sweep"] == 1 and n["wrap_conv_k7c"] > 0,
                  "dp step: one K1 launch and the K7 kernels")
            s_pl, m_pl = step_pl(s_pl, batches[0])
            ld, lp = m_dp["total_loss"].item(), m_pl["total_loss"].item()
            grel = {nm: ((a.grad - b.grad).norm() / b.grad.norm()).item()
                    for (nm, a), b in zip(s_dp.net.named_parameters(),
                                          s_pl.net.parameters())}
            worst = max(grel.values())
            print(f"dp step vs single step: loss {ld:.4f} vs {lp:.4f} rel "
                  f"{abs(ld - lp) / abs(lp):.3e} (tol {DP_LOSS_TOL:.0e}); "
                  f"grad_norm {m_dp['grad_norm'].item():.4f} vs "
                  f"{m_pl['grad_norm'].item():.4f}; gradients rel L2 worst "
                  f"{worst:.3e} (tol {DP_GRAD_TOL:.0e})")
            check(abs(ld - lp) / abs(lp) <= DP_LOSS_TOL
                  and worst <= DP_GRAD_TOL, "dp step vs single step")
            dp_ms = time_ms(lambda: step_dp(s_dp, batches[0]), iters=6)
            pl_ms = time_ms(lambda: step_pl(s_pl, batches[0]), iters=6)
            print(f"dp step (one NCCL rank) {dp_ms:.3f} ms, single step "
                  f"{pl_ms:.3f} ms (median of 6 after 2 warm-up) {tag}")

            s_m = state_lib.init_state(tcfg, 0, dev)
            multi = dp.make_dp_train_multi_step(tcfg, s_m.net,
                                                steps_per_call=DP_STEPS)
            reset_counts()
            s_m, mm = multi(s_m, dp.stack_batches(batches))
            n = read_counts()
            seq = []
            for b in batches:
                s_s, m = single(s_s, b)
                seq.append(m["total_loss"].item())
            chain = mm["total_loss"].tolist()
            rels = [abs(a - b) / abs(b) for a, b in zip(chain, seq)]
            fmt = " ".join
            print(f"steps_per_call={DP_STEPS}: K1 launches {n['sweep']}, "
                  f"losses {fmt(f'{v:.4f}' for v in chain)} vs {DP_STEPS} "
                  f"single steps {fmt(f'{v:.4f}' for v in seq)}, rel worst "
                  f"{max(rels):.3e} (tol {DP_CHAIN_TOL:.0e})")
            check(s_m.step == s_s.step == DP_STEPS
                  and n["sweep"] == DP_STEPS and max(rels) <= DP_CHAIN_TOL,
                  "chained steps vs single steps")
            stacked = dp.stack_batches(batches)
            c_ms = time_ms(lambda: multi(s_m, stacked), iters=3, warmup=1)
            print(f"chained call of {DP_STEPS} steps {c_ms:.3f} ms "
                  f"({c_ms / DP_STEPS:.3f} ms a step) {tag}")
        finally:
            dist.destroy_process_group()


def sharded_hres_path(dev, tag, cfg, hargs, depths, rng, reset_counts,
                      read_counts, gate, gate_e2e, k5_ms):
    """Path 15d: the test CLI's 4096x2048 re-render (path 3's request) in
    SHELL_BLOCKS contiguous shell blocks on the one card
    (build_hres_render_fn(shards=SHELL_BLOCKS): per block one launch of
    the sweep's assembled mode over its planes and one partial-mode
    launch; then combine_partials), against the unsharded render (one K5
    launch)
    within 1e-5 and the all-plain f32 re-render within E2E_TOL; then the
    partial mode on one block's shapes (BLOCK_SHELLS shells at 4096x2048,
    bf16 and f32 stacks, the first block, with global shell 0, and an
    inner one) against its plain version (partial_composite) fed the
    kernel's lookups, 1e-5; its time, bound and plain time. Returns the
    partial mode's row of the kernels line."""
    from matryodshka_tpu_torch.cli import test as cli_test
    from matryodshka_tpu_torch.geometry import render as render_lib
    from matryodshka_tpu_torch.ops import render as render_ops
    from matryodshka_tpu_torch.ops import render_layers as rl_ops

    hh, hw = cfg.hres_height, cfg.hres_width
    p = cfg.num_psv_planes
    sharded = cli_test.build_hres_render_fn(cfg, shards=SHELL_BLOCKS)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    mem0 = torch.cuda.memory_allocated()
    reset_counts()
    rgb, depth = sharded(*hargs)
    n = read_counts()
    peak = torch.cuda.max_memory_allocated()
    print(f"launches of the {hw}x{hh} re-render in {SHELL_BLOCKS} shell "
          f"blocks: {n}")
    check(n["sweep_assembled"] == SHELL_BLOCKS
          and n["render_layers_partial"] == SHELL_BLOCKS
          and n["sweep"] == n["render_layers"] == 0 and n["uv_tables"] == 0,
          "sharded re-render: one assembled-sweep and one partial-mode "
          "launch a block")
    whole = cli_test.build_hres_render_fn(cfg)(*hargs)
    gate("render_layers_partial", f"{SHELL_BLOCKS} blocks vs K5", rgb,
         whole[0], 1e-5)
    gate("render_layers_partial", f"{SHELL_BLOCKS} blocks vs K5 (depth)",
         depth, whole[1], 1e-5)
    err = max((rgb - whole[0]).abs().max().item(),
              (depth - whole[1]).abs().max().item())
    rgb_p, depth_p = cli_test.hres_render_plain(
        cfg, hargs[0], hargs[1], hargs[2], hargs[3], hargs[7], hargs[8])
    gate_e2e(f"hres {hw}x{hh} in {SHELL_BLOCKS} shell blocks",
             {"output_image": rgb, "output_depth": depth},
             {"output_image": rgb_p, "output_depth": depth_p})
    del rgb, depth, whole, rgb_p, depth_p
    eye = torch.eye(4, device=dev)[None]
    tgt = hargs[8]
    for dtype, p0 in ((torch.bfloat16, 0), (torch.bfloat16, BLOCK_SHELLS),
                      (torch.float32, BLOCK_SHELLS)):
        stack = random_stack(rng, BLOCK_SHELLS, hh, hw, dev).to(dtype)
        radii = depths[p0:p0 + BLOCK_SHELLS].contiguous()
        u, v = render_ops.uv_project(eye, tgt, radii, hh, hw)
        want = rl_ops.render_layers_partial_plain(stack, u, v, p0, p)
        del u, v
        got = rl_ops.render_layers_partial(stack, eye, tgt, radii, p0, p)
        for name, g, wnt in zip(("", " (depth)", " (T)"), got, want):
            gate("render_layers_partial", f"{hw}x{hh}x{BLOCK_SHELLS} "
                 f"{str(dtype)[6:]} p0 {p0}{name}", g, wnt, 1e-5)
            err = max(err, (g - wnt).abs().max().item())
        del want, got
    fn = functools.partial(rl_ops.render_layers_partial, stack.to(
        torch.bfloat16), eye, tgt, radii, BLOCK_SHELLS, p)
    del stack
    st = fn.args[0]
    # CUDA events, as K5's k5_ms: the launch takes ~0.9 ms, far longer
    # than its launch path
    k_ms = time_ms(fn, iters=5)

    def plain():
        uu, vv = render_lib.uv_tables(eye, tgt, radii, hh, hw)
        return rl_ops.render_layers_partial_plain(st, uu, vv, BLOCK_SHELLS, p)

    p_ms = time_ms(plain, iters=1, warmup=1)
    bnd = bound(nbytes(st) + (3 + 3 + 1) * 4 * hh * hw + nbytes(eye, tgt,
                                                                radii),
                (OPS_RENDER_BOTH + 1 + OPS_SHELL_UV) * BLOCK_SHELLS * hh * hw,
                F32_FLOPS)
    print(f"kernel render_layers_partial {hw}x{hh}x{BLOCK_SHELLS} bf16 "
          f"{k_ms:.4f} ms per launch (CUDA events); {SHELL_BLOCKS} blocks "
          f"{SHELL_BLOCKS * k_ms:.4f} ms against K5's {k5_ms:.4f} ms (CUDA "
          f"events) for all {p} shells; plain {p_ms:.3f} ms; bound "
          f"{bnd[0]:.4f} ms ({bnd[1]}) {tag}")
    e_sh = time_ms(lambda: sharded(*hargs), iters=3, warmup=1)
    print(f"hres {hw}x{hh} in {SHELL_BLOCKS} shell blocks e2e {e_sh:.3f} ms "
          f"(median of 3); peak {peak / 2**30:.3f} GiB "
          f"({(peak - mem0) / 2**30:.3f} GiB above the {mem0 / 2**30:.3f} "
          f"GiB held before) {tag}")
    return {"name": "render_layers_partial", "route": "cuda",
            "source": "matryodshka_tpu_torch/csrc/render_layers.cu",
            "replaces": "matryodshka_tpu/ops/pallas_render.py:132",
            "launches": n["render_layers_partial"],
            "launches_per_frame": n["render_layers_partial"],
            "max_abs_err": err, "ms": k_ms, "plain_ms": p_ms,
            "bound_ms": bnd[0], "bound_by": bnd[1], "library_ms": None}


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
    t_run = time.perf_counter()
    walls, since = {}, [t_run]

    def lap(name):
        """Print and keep the wall of the part that ends here."""
        now = time.perf_counter()
        walls[name] = now - since[0]
        since[0] = now
        print(f"{name} wall {walls[name]:.1f} s")

    card = nvidia_smi_line()
    tag = f"[{card}]"
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from matryodshka_tpu_torch import entry
    from matryodshka_tpu_torch.cli import test as cli_test
    from matryodshka_tpu_torch.geometry import render as render_lib
    from matryodshka_tpu_torch.geometry import sweep as sweep_lib
    from matryodshka_tpu_torch.models import msi as msi_lib
    from matryodshka_tpu_torch.ops import _build
    from matryodshka_tpu_torch.ops import conv as conv_ops
    from matryodshka_tpu_torch.ops import mpi_render as mpi_ops
    from matryodshka_tpu_torch.ops.layernorm import \
        layer_norm_relu_plain as ln_plain_fn
    from matryodshka_tpu_torch.ops import render as render_ops
    from matryodshka_tpu_torch.ops import render_layers as rl_ops
    from matryodshka_tpu_torch.ops import sweep as sweep_ops
    from matryodshka_tpu_torch.ops.resample import resample_layers_uv

    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]} {tag}")
    # path 15's mesh, generated beside the build unless cached
    mesh_cfg = entry.flagship_cfg(gcn=True, subdiv=GCN_SUBDIV)
    mesh_proc = start_mesh_generation(mesh_cfg)

    # ---- build -----------------------------------------------------------
    # the op library (csrc/sweep_op.cpp with K1: nvcc and g++) in a thread
    # beside the kernel library's nvcc processes
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        op_build = pool.submit(
            lambda: (_build.op_library(), time.perf_counter() - t0))
        so = _build.build()
        _build.lib()
        print(f"kernels built/loaded in {time.perf_counter() - t0:.2f} s: "
              f"{so.name}")
        op_so, op_secs = op_build.result()
    sweep_ops.load_op_library()
    print(f"op library built/loaded in {op_secs:.2f} s beside the kernels: "
          f"{op_so.name} {tag}")
    log = so.with_suffix(".log")
    if log.exists():
        for line in log.read_text().splitlines():
            if "registers" in line or "spill" in line:
                print("  ptxas:", line.strip())
    kernel_build_report(so)
    finish_mesh_generation(mesh_proc, mesh_cfg, tag, time.perf_counter())
    lap("build and path 15's mesh")

    # ---- flagship operands -------------------------------------------------
    cfg = entry.flagship_cfg()
    params = entry.make_params(cfg, seed=0, device=dev)
    batch = entry.synthetic_batch(cfg, 0, dev)
    rng = torch.Generator(device=dev).manual_seed(1234)
    h, w, p = cfg.height, cfg.width, cfg.num_msi_planes
    errs = {"sweep": 0.0, "conv": 0.0, "conv_coord": 0.0, "conv_ln": 0.0,
            "render": 0.0, "render_depth": 0.0, "render_layers_k4": 0.0,
            "render_layers_k5": 0.0, "render_layers_k6": 0.0,
            "wrap_conv_k7a": 0.0, "wrap_conv_k7b": 0.0,
            "wrap_conv_k7c": 0.0, "wrap_conv_wgrad": 0.0,
            "render_layers_partial": 0.0, "sweep_assembled": 0.0}

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

    # conv: every stage of unet_plan at ngf 64 on bf16 inputs of the
    # stage's shape, the conv alone. Kernel and plain version see the same
    # rounded operands, accumulate in f32 (in different orders) and round
    # to bf16 once each, so an output may land one bf16 step apart where
    # the two sums straddle a rounding boundary: tolerance 2^-7 of the
    # output's largest magnitude, which is at least one bf16 step there.
    # conv1_1 reads the sweep's volume and writes its output as the net
    # does, channels-last; the other stages' NCHW x without the norm
    # writes NCHW (their channels-last form reads normed inputs:
    # fused_norm_gates).
    stage_inputs = {}

    def first_fmt(name, st):
        return (st["memory_format"] if name == "conv1_1"
                else torch.contiguous_format)

    for plan, st in zip(params.net.plan, params.stages):
        name, kind, _, cins, cout, ind, _, _ = plan
        x = (torch.rand((1, sum(cins), h // ind, w // ind), generator=rng,
                        device=dev) * 2 - 1).to(torch.bfloat16)
        if name == "conv1_1":
            x = vol
        stage_inputs[name] = x
        fmt = first_fmt(name, st)
        nw = conv_ops.wgmma_launches
        y = conv_ops.conv(x, st["w"], st["b"], **st["args"],
                          memory_format=fmt)
        check(conv_ops.wgmma_launches == nw + 1
              and y.is_contiguous(memory_format=fmt),
              f"conv {name}: one launch of the wgmma kernel, its output "
              f"{fmt}")
        yp = conv_ops.conv_plain(x, st["w"], st["b"], **st["args"])
        gate("conv", f"{name} {kind} {tuple(x.shape[1:])}->{cout}", y, yp,
             2.0 ** -7 * yp.float().abs().max().item())
        check(torch.equal(y, conv_ops.conv(x, st["w"], st["b"],
                                           **st["args"])),
              f"conv {name}: two launches differ")

    # the coord net's conv kernel mode: every stage of its plan at ngf 64,
    # on the wrap stages' inputs (same shapes), with the same tolerance.
    # Convs and downs read the coord channel (Cin + 1 weights) and pad with
    # zeros (downs SAME: 320x640 -> 160x320); deconvs pad with zeros.
    ccfg = entry.flagship_cfg(coord_net=True)
    cparams = entry.make_params(ccfg, seed=0, device=dev)
    for plan, st in zip(cparams.net.plan, cparams.stages):
        name, kind, _, _, cout, _, outd, _ = plan
        x = stage_inputs[name]
        fmt = first_fmt(name, st)
        nw = conv_ops.wgmma_launches
        y = conv_ops.conv(x, st["w"], st["b"], **st["args"],
                          memory_format=fmt)
        check(conv_ops.wgmma_launches == nw + 1
              and y.is_contiguous(memory_format=fmt),
              f"coord {name}: one launch of the wgmma kernel, its output "
              f"{fmt}")
        check(tuple(y.shape[2:]) == (h // outd, w // outd),
              f"coord {name} output {tuple(y.shape)}")
        check(torch.equal(y, conv_ops.conv(x, st["w"], st["b"],
                                           **st["args"])),
              f"coord {name}: two launches differ")
        yp = conv_ops.conv_plain(x, st["w"], st["b"], **st["args"])
        gate("conv_coord", f"{name} {kind} {tuple(x.shape[1:])}->{cout}"
             f"{' +coord' if 'coord' in st['args'] else ''}", y, yp,
             2.0 ** -7 * yp.float().abs().max().item())

    # the layer norm + ReLU fused into the conv (K2's LN+ReLU stage): the
    # 17 stages that read layer-normed inputs, wrap and coord net, bf16
    # and f32, each against conv_plain of layer_norm_relu_plain of its
    # sources; each stage's device time with and without it
    # (fused_norm_gates)
    fused = {key: fused_norm_gates(prm, key, stage_inputs, gate, rng, tag)
             for key, prm in (("conv", params), ("conv_coord", cparams))}

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

    lap("kernel gates")

    # ---- the slice: three requests through entry.forward -----------------
    mods = {"sweep": sweep_ops, "conv": conv_ops, "render": render_ops}
    batches = [entry.synthetic_batch(cfg, seed, dev, tgt_pos=pos)
               for seed, pos in REQUESTS]
    torch.cuda.synchronize()
    for m in mods.values():
        m.launches = 0
    sweep_ops.row_params_launches = render_ops.uv_launches = 0
    conv_ops.wgmma_launches = conv_ops.cl_launches = 0
    conv_ops.norm_launches = conv_ops.stats_launches = 0
    outs = [entry.forward(params, b) for b in batches]
    torch.cuda.synchronize()
    launches = {k: m.launches for k, m in mods.items()}
    launches["conv_norm"] = conv_ops.norm_launches
    launches["conv_stats"] = conv_ops.stats_launches
    launches["conv_cl"] = conv_ops.cl_launches
    check(conv_ops.wgmma_launches == launches["conv"] == 18 * len(batches),
          f"every conv stage of the {len(batches)} requests launched the "
          f"wgmma kernel: {conv_ops.wgmma_launches} of {launches['conv']}")
    check(launches["conv_norm"] == launches["conv_stats"]
          == 17 * len(batches),
          "17 conv launches a frame with their inputs' layer norm fused and "
          "17 writing their statistics, no layer-norm launch")
    check(launches["conv_cl"] == 17 * len(batches),
          "17 conv launches a frame reading a channels-last window (all "
          "but conv1_1, which reads the sweep's NCHW volume)")
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
    import re

    from matryodshka_tpu_torch.trace import CALLS, port_kernels
    b0, rt0 = batches[0], torch.eye(4, device=dev)[None]
    with torch.no_grad():
        vq = msi_lib.sweep_stage(cfg, b0, params.psv_depths)
        pq = msi_lib.net_stage(params.stages, vq)
        for name, fn, want_ops, mod in (
                ("sweep", lambda: msi_lib.sweep_stage(cfg, b0,
                                                      params.psv_depths), 1,
                 sweep_ops),
                ("net", lambda: msi_lib.net_stage(params.stages, vq), None,
                 conv_ops),
                ("render", lambda: msi_lib.render_stage(
                    vq, pq, rt0, b0["tgt_pose"], params.msi_depths), 1,
                 render_ops),
                ("frame", lambda: entry.forward(params, b0), None, None)):
            wall, busy, idle, ops, by_name, counts = trace_counted(
                fn, mod and (lambda m=mod: m.launches))
            print(f"stage {name:6s} {ops:g} device ops/frame (trace: host "
                  f"wall {wall:.3f} ms, device busy {busy:.3f} ms, idle "
                  f"share {idle:.3f}) {tag}")
            if name == "net" or (want_ops is not None and ops != want_ops):
                for op, n in counts.most_common():
                    print(f"  {n} x {op[:100]} ({by_name[op]:.1f} us)")
            check(want_ops is None or ops == want_ops,
                  f"the {name} stage is {want_ops} device operation")
            if name in ("net", "frame"):
                ln = [op for op in counts if re.search(LN_KERNEL_NAMES, op)]
                convs = port_kernels(by_name, counts).get(
                    "conv_wgmma_kernel", (0, 0.0))[0] / CALLS
                print(f"stage {name}: {convs:g} conv kernel launches a "
                      f"frame, {len(ln)} layer-norm kernels in its trace")
                check(convs == 18 and not ln,
                      f"the {name} stage launches 18 port kernels, the "
                      f"conv's, and no layer-norm kernel")
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

    lap("path 1")

    # ---- path 2: the test CLI, one request per colour scheme ---------------
    counted = {"sweep": sweep_ops, "conv": conv_ops, "render": render_ops,
               "render_layers": rl_ops, "mpi_render": mpi_ops}

    def reset_counts():
        torch.cuda.synchronize()
        for m in counted.values():
            m.launches = 0
        render_ops.depth_launches = 0
        rl_ops.ftb_launches = rl_ops.both_launches = 0
        render_lib.uv_builds = 0
        conv_ops.coord_launches = 0
        conv_ops.wgmma_launches = conv_ops.cl_launches = 0
        conv_ops.norm_launches = conv_ops.stats_launches = 0
        sweep_lib.gather_sweeps = 0
        rl_ops.partial_launches = 0
        sweep_ops.assembled_launches = 0

    def read_counts():
        torch.cuda.synchronize()
        got = {k: m.launches for k, m in counted.items()}
        got["render_depth"] = render_ops.depth_launches
        got["render_layers_ftb"] = rl_ops.ftb_launches
        got["render_layers_both"] = rl_ops.both_launches
        got["uv_tables"] = render_lib.uv_builds
        got["conv_coord"] = conv_ops.coord_launches
        got["conv_wgmma"] = conv_ops.wgmma_launches
        got["conv_norm"] = conv_ops.norm_launches
        got["conv_stats"] = conv_ops.stats_launches
        got["conv_cl"] = conv_ops.cl_launches
        got["gather_sweep"] = sweep_lib.gather_sweeps
        got["render_layers_partial"] = rl_ops.partial_launches
        got["sweep_assembled"] = sweep_ops.assembled_launches
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
    cli_outputs = "tgt_image_blend_weights_alphas_bg_rgb"
    reset_counts()
    cli_outs = [cli_test.build_infer_fn(c, prm, cli_outputs)(b)
                for _, c, prm, b in cli]
    cli_launches = read_counts()
    print(f"launches over the {len(cli)} test CLI requests: {cli_launches}")
    for k in ("sweep", "conv", "conv_norm", "render", "render_depth",
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

    lap("path 2")

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
    for k in ("sweep_assembled", "render_layers"):
        check(hres_launches[k] > 0, f"kernel {k} was not launched on the "
                                    f"high-res path")
    check(hres_launches["sweep_assembled"] == 1
          and hres_launches["sweep"] == 0,
          "the high-res sweep and assembly: one assembled-sweep launch, no "
          "K1 volume")
    check(hres_launches["render_layers"] == hres_launches[
        "render_layers_both"] == 1 and hres_launches["uv_tables"] == 0,
        "the high-res render: one layer-stack launch, no lookup tables")
    rerender_trace(lambda: hres_render(*hargs), f"{hw}x{hh} re-render", tag)
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
    # the sweep's assembled mode at the re-render's shapes: the whole stack
    # and one of the 4-block re-render's shell blocks, each colour rule,
    # on the blend_psv request's alphas and blend weights (its background
    # colour a seeded one: blend_psv saves none)
    hlow = (cli_outs[0]["alphas"].float().contiguous(),
            cli_outs[0]["blend_weights"].float().contiguous(),
            (torch.rand((1, h, w, 3), generator=rng, device=dev) * 2 - 1))
    assembled_gates(gate, f"{hw}x{hh}", hres_images[0], hres_images[1],
                    params.psv_depths, bq["intrinsics"], hlow,
                    ((0, p), (BLOCK_SHELLS, 2 * BLOCK_SHELLS)))

    lap("path 3")

    # ---- path 4: the coord net through entry.forward and the test CLI ------
    cbatches = [entry.synthetic_batch(ccfg, seed, dev, tgt_pos=pos)
                for seed, pos in REQUESTS[:2]]
    reset_counts()
    couts = [entry.forward(cparams, b) for b in cbatches]
    coord_launches = read_counts()
    print(f"launches over {len(cbatches)} coord-net requests: "
          f"{coord_launches}")
    for k in ("sweep", "conv_coord", "conv_norm", "render"):
        check(coord_launches[k] > 0, f"kernel {k} was not launched on the "
                                     f"coord net's entry.forward path")
    check(coord_launches["conv_wgmma"] == coord_launches["conv_coord"]
          == 18 * len(cbatches), "every coord conv stage launched the wgmma "
                                 "kernel")
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
    for k in ("sweep", "conv_coord", "conv_norm", "render", "render_depth"):
        check(ccli_launches[k] > 0, f"kernel {k} was not launched on the "
                                    f"coord net's test CLI path")
    gate_e2e(f"cli coord {cscheme} tgt_pos {cpos}", ccli_out,
             cli_test.infer_plain(ccfg, cparams, cb_cli))

    lap("path 4")

    # ---- path 5: training, the default ODS trainer -------------------------
    k7_ms = wrap_conv_kernels(dev, h, w, gate, errs, tag)
    train_launches = training_path(dev, tag, reset_counts, read_counts)
    nsteps = TRAIN_WARMUP + TRAIN_STEPS

    lap("path 5")

    # ---- path 6: the lowering probes (K8, K9) ------------------------------
    probe_rows = probe_path(dev, tag)

    lap("path 6")

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
        """Per stage, as the net runs it on fused[key]'s operands (its
        inputs' layer norm fused, its output's statistics written): the
        kernel, its plain version (conv_plain after layer_norm_relu_plain
        of each source) and the library calls: cuDNN in bf16 on the same
        input, zero padded (F.conv2d on the input with the coord channel
        appended for coord stages, F.conv_transpose2d for deconvs), and on
        each output but the head's F.group_norm with one group and
        F.layer_norm over (C, H, W), each + relu_. Sums into kernel_ms /
        plain_ms / lib_ms (cuDNN's alone) and the bounds; the 18 stages
        beside the parent's conv + LN (PARENT_NET_MS) and cuDNN beside
        cuDNN + the faster library norm. For the wrap net also the fused
        layer norm's row, conv_ln: its device ms the 18 stages' fused
        device time less the convs' alone (fused_norm_gates' trace), its
        plain ms layer_norm_relu_plain's on the 17 normed outputs, its
        library ms the faster library norm's, its bound what the fusion
        adds to the convs: the epilogue's sums over the 17 outputs, each
        consumer's fold of its sources' partials (f64, at half the f32
        rate) and relu(a * y + b) once per element it reads, and the
        partials' bytes (written once, read once per consumer) and the
        vectors' gamma and beta."""
        kernel_ms[key] = plain_ms[key] = lib_ms[key] = 0.0
        ln_lib = {"group_norm": 0.0, "layer_norm": 0.0}
        ln_plain = 0.0
        flops = cbytes = ln_bytes = ln_ops = 0.0
        for plan, st in zip(prm.net.plan, prm.stages):
            name, kind, _, cins, cout, _, _, rate = plan
            args = st["args"]
            x, norm, _ = fused[key]["stages"][name]
            fn = functools.partial(conv_ops.conv, x, st["w"], st["b"],
                                   **args, norm=norm, stats=st["stats"],
                                   memory_format=st["memory_format"])
            y, part = fn() if st["stats"] else (fn(), None)
            kt = time_ms(fn)
            for n in norm or ():
                # the consumer: its fold (a sum a partial, ~8 per channel
                # and sample; f64) and relu(a * y + b) per element read
                ln_ops += 2 * (n.partial.numel()
                              + 8 * x.shape[0] * n.gamma.numel())
                ln_bytes += nbytes(n.partial, n.gamma, n.beta)
            if norm:
                ln_ops += OPS_LN_APPLY * x.numel()
            xn = x if norm is None else conv_ops.normalize_plain(x, norm)
            pt = time_ms(lambda: conv_ops.conv_plain(
                x if norm is None else conv_ops.normalize_plain(x, norm),
                st["w"], st["b"], **args))
            layer = getattr(prm.net, name)
            wb = layer.weight.detach().to(torch.bfloat16)
            bb = st["b"].to(torch.bfloat16)
            if kind == "deconv":
                wt = wb.flip(2, 3).transpose(0, 1).contiguous()
                lt = time_ms(lambda: torch.nn.functional.conv_transpose2d(
                    xn, wt, bb, stride=2, padding=1))
            else:
                xl = (conv_ops.with_coord(xn, args["coord"])
                      if "coord" in args else xn)
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
            tile = conv_ops.tile_config(x, cout, **args, norm=norm)
            line = (f"{key} {name:10s} kernel {kt:8.3f} ms "
                    f"({f / kt / 1e9:6.2f} TFLOP/s, tile {tile}"
                    f"{', norm' if norm else ''}"
                    f"{', stats' if st['stats'] else ''}) plain "
                    f"{pt:8.3f} ms library bf16 {lt:7.3f} ms")
            kernel_ms[key] += kt
            plain_ms[key] += pt
            lib_ms[key] += lt
            if st["stats"]:
                g = torch.ones(cout, device=dev)
                bt = torch.zeros(cout, device=dev)
                npt = time_ms(lambda: ln_plain_fn(y, g, bt))
                gnt = time_ms(lambda: torch.relu_(
                    torch.nn.functional.group_norm(
                        y, 1, g.to(y.dtype), bt.to(y.dtype), eps=1e-12)))
                chw = y.shape[1:]
                ge = torch.ones(chw, dtype=y.dtype, device=dev)
                be = torch.zeros(chw, dtype=y.dtype, device=dev)
                lnt = time_ms(lambda: torch.relu_(
                    torch.nn.functional.layer_norm(y, chw, ge, be,
                                                   eps=1e-12)))
                ln_plain += npt
                ln_lib["group_norm"] += gnt
                ln_lib["layer_norm"] += lnt
                ln_bytes += nbytes(part)
                ln_ops += OPS_LN_STATS * y.numel()
                line += (f" | its layer norm: plain {npt:7.3f} ms library "
                         f"group_norm {gnt:7.3f} ms layer_norm {lnt:7.3f} "
                         f"ms")
            print(line, tag)
        call = min(ln_lib, key=ln_lib.get)
        bounds[key] = bound(cbytes, flops, BF16_FLOPS)
        fz, al = fused[key]["fused_ms"], fused[key]["alone_ms"]
        nm_ms = fused[key]["net_ms"]
        dev_ms = sum(nm_ms) if nm_ms else None
        device_only[key] = (dev_ms, 18)
        pc, pl = PARENT_NET_MS[key]
        print(f"net {key} 18 stages {flops / 1e9:.1f} GFLOP: kernel "
              f"{kernel_ms[key]:.3f} ms events = "
              f"{flops / kernel_ms[key] / 1e9:.2f} TFLOP/s, device "
              + ("not measured" if dev_ms is None else f"{dev_ms:.4f} ms")
              + f" in 18 launches (the parent's conv {pc} + layer norm {pl}"
              f" = {pc + pl:.3f} ms device, PERF.md); library cuDNN bf16 "
              f"{lib_ms[key]:.3f} ms, + F.{call} of the 17 outputs "
              f"{lib_ms[key] + ln_lib[call]:.3f} ms; bound "
              f"{bounds[key][0]:.3f} ms ({bounds[key][1]}) {tag}")
        if key != "conv":
            return
        kernel_ms["conv_ln"] = (sum(fz) - sum(al)) if fz else None
        plain_ms["conv_ln"] = ln_plain
        lib_ms["conv_ln"] = ln_lib[call]
        bounds["conv_ln"] = bound(ln_bytes, ln_ops, F32_FLOPS)
        print(f"net conv_ln (the fused layer norm of 17 stages): device "
              + ("not measured" if fz is None else
                 f"{kernel_ms['conv_ln']:.4f} ms added to the convs' "
                 f"{sum(al):.4f}")
              + f"; plain {ln_plain:.3f} ms; library F.group_norm "
              f"{ln_lib['group_norm']:.3f} ms, F.layer_norm "
              f"{ln_lib['layer_norm']:.3f} ms; bound "
              f"{bounds['conv_ln'][0]:.4f} ms ({bounds['conv_ln'][1]}) "
              f"{tag}")

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
        sh, sw = st.shape[2:4]
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
            frac = visited(st[0, ..., 3].float(), u0[0], v0[0])
            print(f"K6 front to back takes {frac:.4f} of the (pixel, shell) "
                  f"samples on this stack")
        bounds[name] = bound(
            frac * nbytes(st) + 2 * 3 * 4 * sh * sw + nbytes(*tgt),
            frac * (OPS_RENDER_BOTH + OPS_SHELL_UV) * p * sh * sw, F32_FLOPS)
        print(f"kernel {name} {sw}x{sh} device time (trace) {how}; CUDA "
              f"events {kernel_ms[name]:.4f} ms; bound "
              f"{bounds[name][0]:.4f} ms ({bounds[name][1]}) {tag}")
    # the sweep's assembled mode at the re-render's shapes (blend_psv, the
    # whole bf16 stack): CUDA events and profiler device time; its plain
    # version (sweep_assembled_plain, four blocks of 8 shells in turn);
    # its bound: the stack written, the images and the low-res arrays it
    # reads once, and OPS_ASSEMBLED per texel
    asm_in = (*hres_images, params.psv_depths, bq["intrinsics"], hlow[0],
              hlow[1])
    asm_fn = functools.partial(sweep_ops.sweep_assembled, *asm_in,
                               rule="blend_psv", out_dtype=torch.bfloat16)
    kernel_ms["sweep_assembled"] = time_ms(asm_fn, iters=5)

    def asm_plain():
        return torch.cat([sweep_ops.sweep_assembled_plain(
            *asm_in[:2], params.psv_depths[q:q + BLOCK_SHELLS].contiguous(),
            *asm_in[3:], rule="blend_psv", p0=q,
            out_dtype=torch.bfloat16) for q in range(0, p, BLOCK_SHELLS)],
            dim=1)

    plain_ms["sweep_assembled"] = time_ms(asm_plain, iters=1, warmup=1)
    _, total, seen = device_ms([asm_fn], [1], r"\bassembled_kernel\b",
                               calls=5)
    device_only["sweep_assembled"] = (total / seen, 1)
    stack_bytes = p * hh * hw * 4 * 2
    bounds["sweep_assembled"] = bound(
        stack_bytes + nbytes(*asm_in),
        OPS_ASSEMBLED["blend_psv"] * p * hh * hw
        + OPS_ROW_PARAM * 2 * p * hh * math.ceil(hw / 512), F32_FLOPS)
    print(f"kernel sweep_assembled {hw}x{hh}x{p} bf16 blend_psv device time "
          f"(trace) {total / seen:.4f} ms per launch; CUDA events "
          f"{kernel_ms['sweep_assembled']:.4f} ms; plain "
          f"{plain_ms['sweep_assembled']:.3f} ms; bound "
          f"{bounds['sweep_assembled'][0]:.4f} ms "
          f"({bounds['sweep_assembled'][1]}) {tag}")
    for k in ("render", "render_depth", "render_layers_k4",
              "render_layers_k5", "render_layers_k6", "sweep_assembled"):
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

    # the 4096x2048 re-render: stages (the render on the assembled stack)
    # and end to end (median of 3)
    hs = {"sweep_assembled": functools.partial(
        sweep_ops.sweep_assembled, *hargs[:2], params.psv_depths,
        bq["intrinsics"], hargs[3].float().contiguous(),
        hargs[2].float().contiguous(), rule="blend_psv",
        out_dtype=torch.bfloat16)}
    hlayers = hs["sweep_assembled"]()
    hs["render_depth"] = lambda: render_lib.render_equirect_view_prepared_both(
        hlayers, eye, bq["tgt_pose"], params.psv_depths)
    hms = {k: time_ms(fn, iters=3) for k, fn in hs.items()}
    del hlayers
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
    launches["sweep_assembled"] = hres_launches["sweep_assembled"]
    launches["conv_coord"] = (coord_launches["conv_coord"]
                              + ccli_launches["conv_coord"])
    launches["conv_ln"] = launches.pop("conv_norm")
    frames = {"sweep": len(batches), "conv": len(batches),
              "conv_ln": len(batches), "render": len(batches),
              "render_depth": 1, "render_layers_k4": len(cli) - 1,
              "render_layers_k5": 1, "render_layers_k6": 1,
              "sweep_assembled": 1, "conv_coord": len(cbatches) + 1}
    sources = {
        "sweep": ("matryodshka_tpu_torch/csrc/sweep.cu",
                  "matryodshka_tpu/ops/pallas_sweep.py:230"),
        "conv": ("matryodshka_tpu_torch/csrc/conv.cu",
                 "matryodshka_tpu/ops/pallas_net.py:356"),
        "conv_coord": ("matryodshka_tpu_torch/csrc/conv.cu",
                       "matryodshka_tpu/ops/pallas_net.py:356 "
                       "(variant=coord)"),
        "conv_ln": ("matryodshka_tpu_torch/csrc/conv.cu",
                    "matryodshka_tpu/ops/pallas_net.py:356 (the LN+ReLU "
                    "stage: norm_vectors :644, norm_row :680)"),
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
        "sweep_assembled": ("matryodshka_tpu_torch/csrc/sweep_assembled.cu",
                            "matryodshka_tpu/ops/pallas_sweep.py:230 (K1 as "
                            "ods_sweep_identity_chunked, :669, runs it at "
                            "high res, with the XLA upsample and "
                            "models/msi.py:284 assemble_hres_prepared)"),
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
        kt, pt, lt, (bms, bby), dms, lds = k7_ms[k]
        print(f"kernel {k:16s} {kt:9.3f} ms (device {dms})  plain "
              f"{pt:9.3f} ms  library {lt:9.3f} ms (device {lds})  bound "
              f"{bms:.4f} ms ({bby}) per step, "
              f"{train_launches[k] / nsteps:g} launches per step {tag}")
        rows.append({"name": k, "route": "cuda", "source": src,
                     "replaces": rep, "launches": train_launches[k],
                     "launches_per_step": train_launches[k] / nsteps,
                     "max_abs_err": errs[k], "ms": kt, "plain_ms": pt,
                     "bound_ms": bms, "bound_by": bby, "library_ms": lt,
                     "device_ms": dms, "library_device_ms": lds})
    rows.extend(probe_rows)

    lap("times and traces")

    # ---- path 7: the E-LPIPS trainer (released recipe, then the wrap net) --
    # (after the profiler traces above: no trace follows these paths)
    elpips_training_path(dev, tag, reset_counts, read_counts)

    lap("path 7")

    # ---- path 8: the evaluator on the coord net's test CLI outputs ---------
    evaluator_path(dev, tag, reset_counts, read_counts)

    lap("path 8")

    # ---- path 9: the ods-temp recipe (transform-inverse regularizer) -------
    reg_training_path(dev, tag, reset_counts, read_counts,
                      {k: train_launches[k] // nsteps for k in K7_COUNTS})

    lap("path 9")

    # ---- path 10: the test CLI's perspective and ODS-eye re-renders --------
    rerender_path(dev, tag, reset_counts, read_counts)

    lap("path 10")

    # ---- path 11: the net-only export and its consumer ---------------------
    export_path(dev, tag, reset_counts, read_counts)
    lap("path 11")

    # ---- path 12: the PP and RealEstate recipes ----------------------------
    served = mpi_path(dev, tag, reset_counts, read_counts,
                      {k: train_launches[k] // nsteps for k in K7_COUNTS})
    rows.append(mpi_render_row(dev, tag, served["REALESTATE_PP"]))
    lap("path 12")

    # ---- path 13: the rest of the trainer's options ------------------------
    options_path(dev, tag, reset_counts, read_counts,
                 {k: train_launches[k] // nsteps for k in K7_COUNTS})
    lap("path 13")

    # ---- path 14: full export, smoothed net, high res for every scheme ----
    export_full_path(dev, tag, reset_counts, read_counts)
    smoothed_path(dev, tag, reset_counts, read_counts,
                  {k: train_launches[k] // nsteps for k in K7_COUNTS}, gate)
    hres_schemes_path(dev, tag, cli, cli_outs, hres_images, reset_counts,
                      read_counts, gate_e2e)
    lap("path 14")

    # ---- path 15: the GCN, data parallelism, the sharded re-render -------
    gcn_launches = gcn_path(dev, tag, reset_counts, read_counts, gate_e2e)
    rows.append(sharded_hres_path(
        dev, tag, c0, hargs, params.psv_depths, rng, reset_counts,
        read_counts, gate, gate_e2e, kernel_ms["render_layers_k5"]))
    dp_path(dev, tag, reset_counts, read_counts)
    for r in rows:
        if r["name"] in ("sweep", "render", "render_depth",
                         "render_layers_k4"):
            key = {"render_layers_k4": "render_layers"}.get(r["name"],
                                                            r["name"])
            r["launches_gcn_requests"] = sum(
                gcn_launches[k][key] for k in ("blend_psv", "blend_bg"))
        if r["name"] == "sweep":
            r["launches_gcn_train"] = gcn_launches["train"]["sweep"]
    lap("path 15")
    print("walls, s: " + ", ".join(f"{k} {v:.1f}" for k, v in walls.items())
          + f"; the whole run {time.perf_counter() - t_run:.1f} {tag}")

    print(json.dumps({"kernels": rows}))
    print(nvidia_smi_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
