"""Design alternatives of the sweep, render, conv and weight-gradient
kernels, timed on the card.

    python -m matryodshka_tpu_torch.tools.variants [NAME ...]

(with names, only the variants whose name contains one of them; =NAME
selects the one variant so named). Builds
`csrc/sweep.cu`, `csrc/sweep_assembled.cu`, `csrc/render.cu`,
`csrc/render_layers.cu`, `csrc/conv.cu` and `csrc/conv_wgrad.cu` once as
they are and once per variant (a textual
edit of a constant or a line, into `_build/variants/<name>/`, one `nvcc`
each, all started together),
loads each build with `ctypes` and times its C entry at the flagship
shapes (640x320, 32 planes and shells, bf16 volume or stack; the sweep and
the layer-stack render also at 4096x2048, the sweep's assembled mode there
alone) with CUDA events around 30
back-to-back launches (5 at 4096x2048) after 5 warm-up, all inputs made
from seeds. Each line carries the card's name and power
limit. The variants:

- sweep: 4 rows x 8 planes and 2 x 16 per block (each with the staged
  window it needs) against the built 1 x 32; 16 columns a thread; plain
  stores in place of streaming ones; and two parts of its time: the
  row-parameter prologue alone, and everything but the shared-memory
  reads of the taps;
- render: 32 x 8 pixel tiles against the built 32 x 4; the taps and
  composite alone, the projection replaced by a fixed lookup, which splits
  its time between the two halves;
- sweep_assembled (4096x2048x32, bf16 stack, each colour rule, the
  low-res 640x320 weights): 256-column tiles and 16 planes a block
  against the built 512 x 32; windows of 5 source rows and 8 columns a
  lane (and both, the first design) against the built 3 rows and 4
  columns; 4 blocks an SM; plain stores in place of streaming ones;
- render_layers (the interleaved stack, 640x320x32 and 4096x2048x32,
  bf16; image and depth in one launch, the same as two one-output
  launches, and front to back): 32 x 8, 64 x 2 and 128 x 1 pixel tiles
  against the built 32 x 4; one and four shells a step against two; the
  taps and composite alone, the projection replaced by a fixed lookup;
- conv (the bf16 wgmma kernel at the 18 stages of the 640x320 ngf-64 wrap
  and coord nets on the raw activations and partials of one forward of a
  seeded input, in the layouts the net gives them (channels-last past the
  first conv), CUDA events per layer): each stage as the net runs it (its
  inputs' layer norm fused, its output's statistics written); every layer
  on the 64-Cout tile
  against the plan's choice (128 wherever Cout > 64); the patch windows
  gathered by the producer's threads in place of TMA; rings of 3, 4 and
  up to 8 stages (as many as 220 KB hold) in place of 2; the producer at
  40 registers and the consumers at 232; and a part, the channels-last
  taps' fragments without the layer norm.
- wgrad (the bf16 weight-gradient kernel, csrc/conv_wgrad.cu, at the
  trainer's eight wrap-conv layers, batch 1, CUDA events per layer): rings
  of 2, 3 and up to 8 stages (as many as 200 KB hold) in place of 4; the
  window addresses held across the loop in place of recomputed each
  k-slice; and parts of its time: without the halo loads, without the
  fold, the grid barrier without the fold, without the MMAs, the loads
  alone, without the A fragments' shared loads.

A variant that computes something else says so ("part"); the others must
equal the built kernel's output bit for bit, or the tool raises.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys

import torch

from matryodshka_tpu_torch import entry
from matryodshka_tpu_torch.geometry import grids
from matryodshka_tpu_torch.ops import _build
from matryodshka_tpu_torch.ops import render as render_ops
from matryodshka_tpu_torch.ops import render_layers as rl_ops
from matryodshka_tpu_torch.ops import sweep as sweep_ops

_SYNC_END = "  __syncthreads();\n\n  const int ngroups"
_TAP_READ = ("          col[t] = fmaf(q.fy, rb[c * stride + pos[t]] - a, a);")

#: conv.cu's choice of tile in make_plan.
_PLAN_TILE = "  p.tile = Cout > 64 ? 0 : 1;"



#: name -> (source, [(old, new)], part): part variants time a piece of the
#: kernel and are not compared with it.
VARIANTS = {
    "sweep": ("sweep.cu", [], False),
    "sweep 4 rows x 8 planes": ("sweep.cu", [
        ("int ROWS = 1;", "int ROWS = 4;"), ("int PLANES = 32;",
                                             "int PLANES = 8;"),
        ("int WIN_ROWS = 5;", "int WIN_ROWS = 8;")], False),
    "sweep 2 rows x 16 planes": ("sweep.cu", [
        ("int ROWS = 1;", "int ROWS = 2;"), ("int PLANES = 32;",
                                             "int PLANES = 16;"),
        ("int WIN_ROWS = 5;", "int WIN_ROWS = 6;")], False),
    "sweep 16 columns a thread": ("sweep.cu", [
        ("int COLS = 8;", "int COLS = 16;")], False),
    "sweep without streaming stores": ("sweep.cu", [
        ("__stcs(reinterpret_cast<uint4*>(o + t), w);",
         "*reinterpret_cast<uint4*>(o + t) = w;")], False),
    "sweep prologue only": ("sweep.cu", [
        (_SYNC_END, "  __syncthreads();\n  if (g.B > 0) return;\n"
                    "  const int ngroups")], True),
    "sweep without tap reads": ("sweep.cu", [
        ("          const float a = ra[c * stride + pos[t]];\n" + _TAP_READ,
         "          col[t] = (float)pos[t];")], True),
    "sweep_assembled": ("sweep_assembled.cu", [], False),
    "sweep_assembled 256-column tiles": ("sweep_assembled.cu", [
        ("int TILE_W = 512;", "int TILE_W = 256;")], False),
    "sweep_assembled 16 planes a block": ("sweep_assembled.cu", [
        ("int PLANES = 32;", "int PLANES = 16;")], False),
    "sweep_assembled 5 window rows": ("sweep_assembled.cu", [
        ("int WIN_ROWS = 3;", "int WIN_ROWS = 5;")], False),
    "sweep_assembled 8 columns a lane": ("sweep_assembled.cu", [
        ("int COLS = 4;", "int COLS = 8;")], False),
    "sweep_assembled 8 columns a lane, 5 window rows": (
        "sweep_assembled.cu", [("int COLS = 4;", "int COLS = 8;"),
                               ("int WIN_ROWS = 3;", "int WIN_ROWS = 5;")],
        False),
    "sweep_assembled 4 blocks an SM": ("sweep_assembled.cu", [
        ("__launch_bounds__(THREADS)", "__launch_bounds__(THREADS, 4)")],
        False),
    "sweep_assembled without streaming stores": ("sweep_assembled.cu", [
        ("__stcs(reinterpret_cast<uint4*>(o + 4 * t), w);",
         "*reinterpret_cast<uint4*>(o + 4 * t) = w;")], False),
    "render": ("render.cu", [], False),
    "render 32 x 8 tiles": ("render.cu", [
        ("TILE_X = 32, TILE_Y = 4;", "TILE_X = 32, TILE_Y = 8;")], False),
    "render without projection": ("render.cu", [
        ("    matry::shell_uv(q, g.radii[p], m, u, v);\n",
         "    u = j + 0.37f * p;\n    v = i + 0.21f;\n")], True),
    "render_layers": ("render_layers.cu", [], False),
    "render_layers 1 shell a step": ("render_layers.cu", [
        ("int SHELLS = 2;", "int SHELLS = 1;")], False),
    "render_layers 4 shells a step": ("render_layers.cu", [
        ("int SHELLS = 2;", "int SHELLS = 4;")], False),
    "render_layers 12 blocks an SM": ("render_layers.cu", [
        ("__launch_bounds__(TILE_X* TILE_Y)",
         "__launch_bounds__(TILE_X* TILE_Y, 12)")], False),
    "render_layers 128 x 1 rows": ("render_layers.cu", [
        ("TILE_X = 32, TILE_Y = 4;", "TILE_X = 128, TILE_Y = 1;")], False),
    "render_layers 32 x 8 tiles": ("render_layers.cu", [
        ("TILE_X = 32, TILE_Y = 4;", "TILE_X = 32, TILE_Y = 8;")], False),
    "render_layers 64 x 2 tiles": ("render_layers.cu", [
        ("TILE_X = 32, TILE_Y = 4;", "TILE_X = 64, TILE_Y = 2;")], False),
    "render_layers without projection": ("render_layers.cu", [
        ("  matry::shell_uv(q, radius, m, u, v);\n",
         "  u = blockIdx.x * TILE_X + threadIdx.x + 0.37f * p;\n"
         "  v = blockIdx.y * TILE_Y + threadIdx.y + 0.21f;\n")], True),
    "conv": ("conv.cu", [], False),
    "conv 64-Cout tiles": ("conv.cu", [(_PLAN_TILE, "  p.tile = 1;")],
                           False),
    "conv windows gathered": ("conv.cu", [
        ("  p.tma_x = (stride == 1 || stride == 2) && (cl ? Cin : Wi) % 8 == "
         "0 &&", "  p.tma_x = 0 &&")], False),
    "conv ring of 3 stages": ("conv.cu", [
        ("constexpr int kStages = 2;", "constexpr int kStages = 3;")],
        False),
    "conv ring of 4 stages": ("conv.cu", [
        ("constexpr int kStages = 2;", "constexpr int kStages = 4;")],
        False),
    "conv ring of up to 8 stages": ("conv.cu", [
        ("constexpr int kStages = 2;", "constexpr int kStages = 8;")],
        False),
    "conv producer 40 registers": ("conv.cu", [
        ("reg_dealloc<56>", "reg_dealloc<40>"),
        ("reg_alloc<224>", "reg_alloc<232>")], False),
    "conv without the norm": ("conv.cu", [
        ("            for (int i = 0; i < 4 && NORM; ++i)\n"
         "              af[kw][kk][i] = norm_frag(af[kw][kk][i], "
         "ab[kk][i >> 1]);", "            ;")], True),
    "wgrad": ("conv_wgrad.cu", [], False),
    "wgrad ring of 2 stages": ("conv_wgrad.cu", [
        ("constexpr int kStages = 4;", "constexpr int kStages = 2;")], False),
    "wgrad ring of 3 stages": ("conv_wgrad.cu", [
        ("constexpr int kStages = 4;", "constexpr int kStages = 3;")], False),
    "wgrad ring of up to 8 stages": ("conv_wgrad.cu", [
        ("constexpr int kStages = 4;", "constexpr int kStages = 8;")], False),
    "wgrad addresses held": ("conv_wgrad.cu", [
        ('  asm volatile("" : "+r"(v));\n', "")], False),
    "wgrad without halo loads": ("conv_wgrad.cu", [
        ("  mbar_arrive_tx(&full[s], G::kStage);",
         "  mbar_arrive_tx(&full[s], G::kStage - 2 * G::kH);"),
        ("  tma_load_4d(st + G::kHL, tmh, &full[s],\n"
         "              x0 == 0 ? p.W - kHalo : x0 - kHalo, blk.c0, y - 1, "
         "b);\n"
         "  tma_load_4d(st + G::kHR, tmh, &full[s], x0 + KP >= p.W ? 0 : "
         "x0 + KP,\n"
         "              blk.c0, y - 1, b);\n", "")], True),
    "wgrad without fold": ("conv_wgrad.cu", [
        ("  sync_all(p.coop);\n", ""),
        ("  fold(partial, dw, db, p, b2.tile, lo, hi, tid, kThreads);\n",
         "")], True),
    "wgrad barrier without fold": ("conv_wgrad.cu", [
        ("  fold(partial, dw, db, p, b2.tile, lo, hi, tid, kThreads);\n",
         "")], True),
    "wgrad without wgmma": ("conv_wgrad.cu", [
        ("        wgmma_rs<BN, 0>(acc[t], af[j & 1][t],\n"
         "                        dB + (uint64_t)((j * 32) >> 4));",
         "        acc[t][0] += __uint_as_float(af[j & 1][t][0] ^ "
         "af[j & 1][t][3]) + (float)dB;")], True),
    "wgrad loads only": ("conv_wgrad.cu", [
        ("    load_a<KP>(af[0], opaque(base + s * G::kStage), "
         "lines_of<KP>(opaque(tid)),\n               0);\n", ""),
        ("    for (int j = 0; j < G::kSlices; ++j) {",
         "    for (int j = 0; j < 0; ++j) {"),
        ("    if (bias) {\n      if (tid < kChunks)",
         "    if (bias && !bias) {\n      if (tid < kChunks)")], True),
    "wgrad without A loads": ("conv_wgrad.cu", [
        ("  const int q4 = (int)ln.q4;\n",
         "  for (int t = 0; t < 3; ++t)\n"
         "    for (int e = 0; e < 4; ++e)\n"
         "      af[t][e] = st + ln.row + e + t + ks;\n"
         "  if (st != 0xffffffffu) return;\n"
         "  const int q4 = (int)ln.q4;\n")], True),
}


def _sources(names):
    """[(name, variant source path)]: every named variant's source written
    into its directory; raises before any build if an edit does not
    apply."""
    root = _build.BUILD_DIR / "variants"
    out = []
    for name in names:
        src, edits, _ = VARIANTS[name]
        text = (_build.CSRC / src).read_text()
        for old, new in edits:
            if old not in text:
                raise RuntimeError(f"variant {name!r}: {old!r} not in {src}")
            text = text.replace(old, new)
        d = root / name.replace(" ", "_")
        d.mkdir(parents=True, exist_ok=True)
        for f in _build.CSRC.glob("*.cuh"):
            (d / f.name).write_text(f.read_text())
        (d / src).write_text(text)
        out.append((name, d / src))
    return out


def _build_all(names):
    """{name: ctypes library} of the named variants, built in parallel."""
    procs = []
    try:
        for name, src in _sources(names):
            so = src.parent / "lib.so"
            cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o",
                   str(so), str(src)]
            procs.append((name, so, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        libs = {}
        for name, so, proc in procs:
            out = proc.communicate()[0]
            if proc.returncode != 0:
                raise RuntimeError(f"variant {name!r} failed to build:\n"
                                   f"{out[-3000:]}")
            lib = ctypes.CDLL(str(so))
            for fn in ("matry_sweep", "matry_sweep_assembled",
                       "matry_render", "matry_render_layers",
                       "matry_conv", "matry_conv_plan",
                       "matry_conv_smem", "matry_conv_stats_blocks",
                       "matry_conv_wgrad",
                       "matry_wgrad_plan"):
                if hasattr(lib, fn):
                    getattr(lib, fn).argtypes = _build.SIGNATURES[fn]
                    getattr(lib, fn).restype = ctypes.c_int
            libs[name] = lib
        return libs
    finally:
        for _, _, proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()


def _time_us(fn, iters: int = 30) -> float:
    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    s = torch.cuda.Event(enable_timing=True)
    e = torch.cuda.Event(enable_timing=True)
    s.record()
    for _ in range(iters):
        fn()
    e.record()
    torch.cuda.synchronize()
    return s.elapsed_time(e) * 1e3 / iters


def _stack(gen, p, h, w):
    """A bf16 interleaved layer stack [1, P, H, W, 4]: colours uniform in
    [-1, 1], alphas sigmoid(3 U(-1, 1))."""
    stack = torch.rand((1, p, h, w, 4), generator=gen, device="cuda") * 2 - 1
    stack[..., 3] = torch.sigmoid(3.0 * stack[..., 3])
    return stack.to(torch.bfloat16)


def _layer_stack_times(lib, stack, target, part):
    """One variant of the layer-stack render on one stack: back to front,
    image and depth in one launch against the two one-output launches,
    and front to back in one launch; each output must equal the built
    kernel's bit for bit unless the variant is a part. -> text."""
    _, p, h, w, _ = stack.shape
    dev = stack.device
    lat, lon = grids.lat_long_vectors(h, w, dev)
    stream = _build.stream_ptr(dev)
    iters = 30 if h <= 320 else 5
    want = {ftb: rl_ops.render_layers_both(stack, *target, ftb=ftb)
            for ftb in (False, True)}

    def call(rgb, depth, ftb):
        return lambda: _build.check(lib.matry_render_layers(
            stack.data_ptr(), target[0].data_ptr(), 0, target[1].data_ptr(),
            3, target[2].data_ptr(), lat.data_ptr(), lon.data_ptr(),
            None if rgb is None else rgb.data_ptr(),
            None if depth is None else depth.data_ptr(), 1, p, h, w, 1,
            int(ftb), rl_ops.EPS, stream), "matry_render_layers")

    out = {ftb: tuple(torch.empty_like(t) for t in want[ftb])
           for ftb in (False, True)}
    both = _time_us(call(*out[False], False), iters)
    rgb_only = call(out[False][0], None, False)
    depth_only = call(None, out[False][1], False)
    two = _time_us(lambda: (rgb_only(), depth_only()), iters)
    ftb = _time_us(call(*out[True], True), iters)
    if not part:
        for f in (False, True):
            for got, ref in zip(out[f], want[f]):
                if not torch.equal(got, ref):
                    raise RuntimeError("a layer-stack variant differs")
    return (f"{w}x{h}x{p} bf16 both {both:9.2f} us, rgb + depth launches "
            f"{two:9.2f} us, ftb both {ftb:9.2f} us")


def _assembled_times(lib, hres, depths, intr, low, part):
    """One variant of the sweep's assembled mode at 4096x2048x32, bf16
    stack, each colour rule (CUDA events, 5 launches after 5), each output
    equal to the built kernel's bit for bit unless the variant is a part.
    -> text."""
    ref, src = hres
    _, h, w, _ = ref.shape
    _, lh, lw, p = low[0].shape
    dev = ref.device
    lat, lon = grids.lat_long_vectors(h, w, dev)
    stream = _build.stream_ptr(dev)
    out = []
    for rule, code in sweep_ops.RULES.items():
        want = sweep_ops.sweep_assembled(ref, src, depths, intr, *low,
                                         rule=rule,
                                         out_dtype=torch.bfloat16)
        got = torch.empty_like(want)

        def call(code=code):
            _build.check(lib.matry_sweep_assembled(
                ref.data_ptr(), src.data_ptr(), depths.data_ptr(),
                intr.data_ptr(), lat.data_ptr(), lon.data_ptr(),
                *(t.data_ptr() for t in low), got.data_ptr(), 1, p, h, w,
                lh, lw, p, 0, code, 1, stream), "matry_sweep_assembled")

        out.append(f"{rule} {_time_us(call, 5):9.2f} us")
        if not part and not torch.equal(got, want):
            raise RuntimeError(f"an assembled variant differs ({rule})")
        del want, got
    return f"{w}x{h}x{p} bf16 " + ", ".join(out)


def _conv_times(lib, nets, want, part=False):
    """One conv variant at every stage of the two nets (CUDA events, 30
    launches after 5): ops/conv.conv run on the variant's library (its own
    count of partials, matry_conv_stats_blocks, where its plan differs) as
    the net runs it (norm, stats and layouts), the output equal to the
    built kernel's bit for bit, and its partials where the tiles are the
    same, unless the variant is a part. -> (text, ms per layer)."""
    from matryodshka_tpu_torch.ops import conv as conv_ops

    def stats_blocks(x_shape, cout, kh, kw, stride=1, dil=1, pad=0, npar=1,
                     hpad="wrap", dtype=torch.bfloat16):
        ho, wo = conv_ops.grid_of(x_shape, kh, kw, stride, dil, pad, npar)
        return lib.matry_conv_stats_blocks(
            x_shape[3], cout, ho, wo, stride, npar, int(hpad == "zero"),
            int(dtype == torch.float32))

    saved = _build._lib, conv_ops.stats_blocks
    _build._lib, conv_ops.stats_blocks = lib, stats_blocks
    try:
        per = []
        for key, stages in nets.items():
            for (name, x, norm, st), ref in zip(stages, want[key]):
                def call():
                    return conv_ops.conv(x, st["w"], st["b"], **st["args"],
                                         norm=norm, stats=st["stats"],
                                         memory_format=st["memory_format"])
                per.append(_time_us(call) / 1e3)
                got = call()
                got = got if st["stats"] else (got, None)
                if part:
                    continue
                if not torch.equal(got[0], ref[0]) or (
                        ref[1] is not None and got[1].shape == ref[1].shape
                        and not torch.equal(got[1], ref[1])):
                    raise RuntimeError(f"conv variant differs at {key} "
                                       f"{name}")
    finally:
        _build._lib, conv_ops.stats_blocks = saved
    n = len(per) // 2

    def nets_sum(t):
        return f"wrap {sum(t[:n]):7.3f} coord {sum(t[n:]):7.3f} ms"
    return ("fused " + nets_sum(per) + "; per layer "
            + " ".join(f"{t:.3f}" for t in per)), per


def _wgrad_layers(dev):
    """[(layer, g, x)] of the trainer's eight wrap-conv layers at 640x320,
    batch 1, bf16: x post-ReLU-like, g normal, from a seed."""
    import chip_smoke as cs
    gen = torch.Generator(device=dev).manual_seed(4321)
    out = []
    for name, cin, cout, ind in cs.wrap_conv_layers(64, 192):
        h, w = 320 // ind, 640 // ind
        x = torch.relu(torch.rand((1, cin, h, w), generator=gen, device=dev)
                       * 2 - 1).to(torch.bfloat16)
        g = torch.randn((1, cout, h, w), generator=gen,
                        device=dev).to(torch.bfloat16)
        out.append((name, g, x))
    return out


def _wgrad_times(lib, layers, want, part):
    """One weight-gradient variant at the eight layers (CUDA events, 30
    launches after 5), its dW and db equal to the built kernel's bit for
    bit unless it is a part. -> text."""
    from matryodshka_tpu_torch.ops import wrap_conv as wc
    per = []
    for (name, g, x), (dw0, db0) in zip(layers, want):
        b, cin, h, w = x.shape
        cout = g.shape[1]
        sms = wc._sm_count(x.device.index)
        plan = wc.wgrad_plan(b, h, w, cout, cin, sms)
        partial = torch.empty((plan.splits, plan.tiles,
                               wc.WGRAD_TILE_ENTRIES), dtype=torch.float32,
                              device=x.device)
        dw, db = torch.empty_like(dw0), torch.empty_like(db0)
        stream = _build.stream_ptr(x.device)

        def call():
            _build.check(lib.matry_conv_wgrad(
                g.data_ptr(), x.data_ptr(), partial.data_ptr(),
                dw.data_ptr(), db.data_ptr(), b, cin, cout, h, w,
                plan.splits, plan.chunk, 0, sms, stream),
                "matry_conv_wgrad")

        per.append(_time_us(call) / 1e3)
        if not part and not (torch.equal(dw, dw0) and torch.equal(db, db0)):
            raise RuntimeError(f"wgrad variant differs at {name}")
    return (f"step {sum(per):7.4f} ms; per layer "
            + " ".join(f"{t:.4f}" for t in per))


def _conv_nets(dev):
    """{wrap, coord}: [(stage, its bf16 input, its norm, stage operands)]
    of the flagship nets: the raw activations and partials of one forward
    (ops/net.py) of a net input uniform in [-1, 1] from a seed."""
    from matryodshka_tpu_torch.ops import conv as conv_ops
    from matryodshka_tpu_torch.ops import net as net_ops
    gen = torch.Generator(device=dev).manual_seed(1234)
    nets = {}
    for key, coord in (("wrap", False), ("coord", True)):
        cfg = entry.flagship_cfg(coord_net=coord)
        prm = entry.make_params(cfg, seed=0, device=dev)
        x0 = (torch.rand((1, cfg.num_net_inputs(), cfg.height, cfg.width),
                         generator=gen, device=dev) * 2 - 1).to(
                             torch.bfloat16)
        acts, stages = {"x": (x0, None)}, []
        for st in prm.stages:
            x, norm = net_ops.stage_input(st, acts)
            out = conv_ops.conv(x, st["w"], st["b"], **st["args"], norm=norm,
                                stats=st["stats"],
                                memory_format=st["memory_format"])
            acts[st["name"]] = out if st["stats"] else (out, None)
            stages.append((st["name"], x, norm, st))
        nets[key] = stages
    return nets


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    names = [n for n in VARIANTS
             if not argv or any(a[1:] == n if a.startswith("=") else a in n
                                for a in argv)]
    if not torch.cuda.is_available():
        print("variants: no CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    dev = torch.device("cuda", 0)
    libs = _build_all(names)
    cfg = entry.flagship_cfg()
    params = entry.make_params(cfg, seed=0, device=dev)
    batch = entry.synthetic_batch(cfg, 0, dev)
    gen = torch.Generator(device=dev).manual_seed(77)
    hres = [torch.rand((1, 2048, 4096, 3), generator=gen, device=dev)
            for _ in range(2)]
    depths, intr = params.psv_depths, batch["intrinsics"]
    p = depths.shape[0]
    stream = _build.stream_ptr(dev)

    def sweep_call(lib, ref, src, out):
        h, w = ref.shape[1:3]
        lat, lon = grids.lat_long_vectors(h, w, dev)
        return lambda: _build.check(lib.matry_sweep(
            ref.data_ptr(), src.data_ptr(), depths.data_ptr(),
            intr.data_ptr(), lat.data_ptr(), lon.data_ptr(), out.data_ptr(),
            1, p, h, w, 1, stream), "matry_sweep")

    shapes = [(batch["ref_image"], batch["src_image"]), tuple(hres)]
    built = [sweep_ops.sweep_volume(r, s, depths, intr, torch.bfloat16)
             for r, s in shapes]
    vol = built[0]
    pred = torch.tanh(1.5 * torch.randn((1, 2 * p, 320, 640),
                                        generator=gen, device=dev))
    target = (torch.eye(4, device=dev)[None], batch["tgt_pose"],
              params.msi_depths)
    lat, lon = grids.lat_long_vectors(320, 640, dev)
    stacks = [_stack(gen, p, h, w) for h, w in ((320, 640), (2048, 4096))]
    low = (torch.rand((1, 320, 640, p), generator=gen, device=dev),
           torch.rand((1, 320, 640, p), generator=gen, device=dev),
           torch.rand((1, 320, 640, 3), generator=gen, device=dev) * 2 - 1)
    conv_nets = conv_want = wgrad_layers = wgrad_want = None
    for name in names:
        src, _, part = VARIANTS[name]
        lib = libs[name]
        if src == "conv_wgrad.cu":
            if wgrad_layers is None:
                from matryodshka_tpu_torch.ops import wrap_conv as wc
                wgrad_layers = _wgrad_layers(dev)
                wgrad_want = [wc.conv3x3_wrap_wgrad(g, x)
                              for _, g, x in wgrad_layers]
            print(f"variant {name:28s} "
                  f"{_wgrad_times(lib, wgrad_layers, wgrad_want, part)}"
                  f"{' (part)' if part else ''} [{card}]")
            continue
        if src == "conv.cu":
            if conv_nets is None:
                from matryodshka_tpu_torch.ops import conv as conv_ops
                conv_nets = _conv_nets(dev)
                conv_want = {k: [conv_ops.conv(
                    x, st["w"], st["b"], **st["args"], norm=norm,
                    stats=st["stats"], memory_format=st["memory_format"])
                    if st["stats"] else
                    (conv_ops.conv(x, st["w"], st["b"], **st["args"],
                                   norm=norm,
                                   memory_format=st["memory_format"]), None)
                    for _, x, norm, st in v]
                    for k, v in conv_nets.items()}
            text, _ = _conv_times(lib, conv_nets, conv_want, part)
            print(f"variant {name:28s} {text}{' (part)' if part else ''} "
                  f"[{card}]")
            continue
        if src == "sweep_assembled.cu":
            print(f"variant {name:28s} "
                  + _assembled_times(lib, hres, depths, intr, low, part)
                  + f"{' (part)' if part else ''} [{card}]")
            continue
        if src == "render_layers.cu":
            print(f"variant {name:28s} "
                  + "; ".join(_layer_stack_times(lib, st, target, part)
                              for st in stacks)
                  + f"{' (part)' if part else ''} [{card}]")
            continue
        if src == "sweep.cu":
            times = []
            for (r, s), want in zip(shapes, built):
                out = torch.empty_like(want)
                fn = sweep_call(lib, r, s, out)
                times.append(_time_us(fn, 30 if r.shape[1] == 320 else 5))
                if not part and not torch.equal(out, want):
                    raise RuntimeError(f"variant {name!r} differs")
            print(f"variant {name:28s} 640x320x32 bf16 {times[0]:8.2f} us, "
                  f"4096x2048x32 {times[1]:9.2f} us"
                  f"{' (part)' if part else ''} [{card}]")
            continue
        for depth in (False, True):
            want = render_ops.render_blend(vol, pred, *target, depth=depth)
            out = torch.empty_like(want)
            fn = (lambda lib=lib, depth=depth: _build.check(
                lib.matry_render(
                    vol.data_ptr(), pred.data_ptr(), target[0].data_ptr(), 0,
                    target[1].data_ptr(), 3, target[2].data_ptr(),
                    lat.data_ptr(), lon.data_ptr(), out.data_ptr(), 1, p,
                    320, 640, 1, int(depth), render_ops.EPS, stream),
                "matry_render"))
            t = _time_us(fn)
            if not part and not torch.equal(out, want):
                raise RuntimeError(f"variant {name!r} differs")
            print(f"variant {name + (' depth' if depth else ''):28s} "
                  f"640x320x32 bf16 {t:8.2f} us"
                  f"{' (part)' if part else ''} [{card}]")
    return 0


if __name__ == "__main__":
    sys.exit(main())
