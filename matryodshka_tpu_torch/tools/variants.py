"""Design alternatives of the sweep and render kernels, timed on the card.

    python -m matryodshka_tpu_torch.tools.variants

Builds `csrc/sweep.cu` and `csrc/render.cu` once as they are and once per
variant (a textual edit of a constant or a line, into
`_build/variants/<name>/`, one `nvcc` each, all started together), loads
each build with `ctypes` and times its C entry at the flagship shapes
(640x320, 32 planes and shells, bf16 volume; the sweep also at 4096x2048)
with CUDA events around 30 back-to-back launches after 5 warm-up, all
inputs made from seeds. Each line carries the card's name and power
limit. The variants:

- sweep: 4 rows x 8 planes and 2 x 16 per block (each with the staged
  window it needs) against the built 1 x 32; 16 columns a thread; plain
  stores in place of streaming ones; and two parts of its time: the
  row-parameter prologue alone, and everything but the shared-memory
  reads of the taps;
- render: 32 x 8 pixel tiles against the built 32 x 4; the taps and
  composite alone, the projection replaced by a fixed lookup, which splits
  its time between the two halves.

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
from matryodshka_tpu_torch.ops import sweep as sweep_ops

_SYNC_END = "  __syncthreads();\n\n  const int ngroups"
_TAP_READ = ("          col[t] = fmaf(q.fy, rb[c * stride + pos[t]] - a, a);")

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
    "render": ("render.cu", [], False),
    "render 32 x 8 tiles": ("render.cu", [
        ("TILE_X = 32, TILE_Y = 4;", "TILE_X = 32, TILE_Y = 8;")], False),
    "render without projection": ("render.cu", [
        ("    matry::shell_uv(q, g.radii[p], m, u, v);\n",
         "    u = j + 0.37f * p;\n    v = i + 0.21f;\n")], True),
}


def _build_all():
    """{name: ctypes library} of every variant, built in parallel."""
    root = _build.BUILD_DIR / "variants"
    procs = []
    for name, (src, edits, _) in VARIANTS.items():
        d = root / name.replace(" ", "_")
        d.mkdir(parents=True, exist_ok=True)
        for f in _build.CSRC.glob("*.cuh"):
            (d / f.name).write_text(f.read_text())
        text = (_build.CSRC / src).read_text()
        for old, new in edits:
            if old not in text:
                raise RuntimeError(f"variant {name!r}: {old!r} not in {src}")
            text = text.replace(old, new)
        (d / src).write_text(text)
        so = d / "lib.so"
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o", str(so),
               str(d / src)]
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
        for fn in ("matry_sweep", "matry_render"):
            if hasattr(lib, fn):
                getattr(lib, fn).argtypes = _build.SIGNATURES[fn]
                getattr(lib, fn).restype = ctypes.c_int
        libs[name] = lib
    return libs


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


def main(argv=None) -> int:
    del argv
    if not torch.cuda.is_available():
        print("variants: no CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    dev = torch.device("cuda", 0)
    libs = _build_all()
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
    for name, (src, _, part) in VARIANTS.items():
        lib = libs[name]
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
