"""Drive the PyTorch port's inference path once on an NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from matryodshka_tpu_torch/csrc, checks each
kernel against its plain PyTorch version at the shapes of the flagship
configuration (640x320 ODS input, 32 planes per eye, 32 shells, ngf 64,
blend_psv, bf16), renders three requests through entry.forward with seeded
random weights, and times the stages and kernels with CUDA events.

Needs one CUDA device; without one it exits non-zero and prints no result.
Every check that fails raises, so the script exits non-zero before its last
line. Output: one line per check and timing (each timing line carries the
card's name and power limit), then a JSON line of kernels, then the
`nvidia-smi` name/power-limit line, then the result line
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time

import torch

#: Bound on |kernel path (bf16) - all-plain path (f32)| over a rendered
#: frame in [-1, 1]. bf16 stores the sweep volume (relative rounding 2^-9)
#: and every activation of the 18 net layers; the JAX package's bf16 hot
#: path differs from its own f32 reference by 9.46e-3 at this shape, and
#: the gate allows about twice that.
E2E_TOL = 2e-2
REQUESTS = [(0, (0.05, 0.0, 0.0)), (1, (-0.03, 0.02, 0.04)),
            (2, (0.0, -0.05, -0.02))]


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


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


def rot_y(deg: float, device) -> torch.Tensor:
    a = math.radians(deg)
    rt = torch.eye(4, device=device)
    rt[0, 0], rt[0, 2], rt[2, 0], rt[2, 2] = (math.cos(a), math.sin(a),
                                              -math.sin(a), math.cos(a))
    return rt[None]


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
    from matryodshka_tpu_torch.geometry import render as render_lib
    from matryodshka_tpu_torch.models import msi as msi_lib
    from matryodshka_tpu_torch.ops import _build
    from matryodshka_tpu_torch.ops import conv as conv_ops
    from matryodshka_tpu_torch.ops import layernorm as ln_ops
    from matryodshka_tpu_torch.ops import render as render_ops
    from matryodshka_tpu_torch.ops import sweep as sweep_ops

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

    # ---- flagship operands -------------------------------------------------
    cfg = entry.flagship_cfg()
    params = entry.make_params(cfg, seed=0, device=dev)
    batch = entry.synthetic_batch(cfg, 0, dev)
    rng = torch.Generator(device=dev).manual_seed(1234)
    h, w, p = cfg.height, cfg.width, cfg.num_msi_planes
    errs = {"sweep": 0.0, "conv": 0.0, "layernorm": 0.0, "render": 0.0}

    def gate(name, what, got, want, tol_abs):
        err = (got.float() - want.float()).abs().max().item()
        fin = bool(torch.isfinite(got.float()).all())
        print(f"{name:9s} {what:34s} max_abs_err {err:.3e} tol "
              f"{tol_abs:.3e} {'ok' if err <= tol_abs and fin else 'FAIL'}")
        check(fin and err <= tol_abs, f"{name} {what}")
        errs[name] = max(errs[name], err)

    # sweep: both eyes x 32 planes at 640x320, f32 and bf16 output.
    # f32: the same taps and weights, only FMA contraction differs (1e-5);
    # bf16: one rounding of values in [-1, 1] (2^-8).
    images, rowp = sweep_ops.sweep_inputs(
        msi_lib.preprocess_image(batch["ref_image"]),
        msi_lib.preprocess_image(batch["src_image"]), params.psv_depths,
        batch["intrinsics"])
    want = sweep_ops.ods_sweep_plain(images, rowp, torch.float32)
    for dt, tol in ((torch.float32, 1e-5), (torch.bfloat16, 2.0 ** -8)):
        gate("sweep", f"2x32 planes {h}x{w} -> {str(dt)[6:]}",
             sweep_ops.ods_sweep(images, rowp, dt), want, tol)
    vol = sweep_ops.ods_sweep(images, rowp, torch.bfloat16)

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
        if name in ("conv1_1", "conv4_1"):
            g = st["gamma"] * (1 + 0.1 * torch.randn(
                cout, generator=rng, device=dev))
            bt = 0.1 * torch.randn(cout, generator=rng, device=dev)
            zp = ln_ops.layer_norm_relu_plain(y, g, bt)
            gate("layernorm", f"{name} {tuple(y.shape[1:])}",
                 ln_ops.layer_norm_relu(y, g, bt), zp,
                 2.0 ** -7 * zp.float().abs().max().item())

    # render: translated and rotated target, bf16 volume, f32 prediction.
    # The same f32 math in another order, plus early termination at
    # T < 1e-6: 1e-5 on values in [-1, 1].
    pred = torch.tanh(1.5 * torch.randn((1, 2 * p, h, w), generator=rng,
                                        device=dev))
    for what, rt, pos in (("translated (0.05, 0, 0)", torch.eye(4)[None],
                           (0.05, 0.0, 0.0)),
                          ("rotated 30 deg + (0.02, 0, 0)", rot_y(30, "cpu"),
                           (0.02, 0.0, 0.0))):
        u, v = render_lib.uv_tables(
            rt.to(dev), torch.tensor([pos], device=dev), params.msi_depths,
            h, w)
        gate("render", what, render_ops.render_blend(vol, pred, u, v),
             render_ops.render_blend_plain(vol, pred, u, v), 1e-5)

    # ---- the slice: three requests through entry.forward -----------------
    mods = {"sweep": sweep_ops, "conv": conv_ops, "layernorm": ln_ops,
            "render": render_ops}
    batches = [entry.synthetic_batch(cfg, seed, dev, tgt_pos=pos)
               for seed, pos in REQUESTS]
    torch.cuda.synchronize()
    for m in mods.values():
        m.launches = 0
    outs = [entry.forward(params, b) for b in batches]
    torch.cuda.synchronize()
    launches = {k: m.launches for k, m in mods.items()}
    print(f"launches over {len(batches)} requests: {launches}")
    for k, n in launches.items():
        check(n > 0, f"kernel {k} was not launched on the main path")
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

    # ---- times (CUDA events, 2 warm-up, median of 10) ----------------------
    b0 = batches[0]
    rt0 = torch.eye(4, device=dev)[None]
    vol0 = msi_lib.sweep_stage(cfg, b0, params.psv_depths)
    pred0 = msi_lib.net_stage(params.stages, vol0)
    stage_ms = {
        "sweep": time_ms(lambda: msi_lib.sweep_stage(cfg, b0,
                                                     params.psv_depths)),
        "net": time_ms(lambda: msi_lib.net_stage(params.stages, vol0)),
        "render": time_ms(lambda: msi_lib.render_stage(
            vol0, pred0, rt0, b0["tgt_pose"], params.msi_depths)),
        "e2e": time_ms(lambda: entry.forward(params, b0)),
        "e2e_plain_f32": time_ms(lambda: entry.forward_plain(params, b0),
                                 iters=5),
    }
    for k, t in stage_ms.items():
        print(f"stage {k:14s} {t:9.3f} ms {tag}")
    print(f"e2e {1000.0 / stage_ms['e2e']:.2f} frames/s {tag}")

    kernel_ms, plain_ms = {}, {}
    kernel_ms["sweep"] = time_ms(
        lambda: sweep_ops.ods_sweep(images, rowp, torch.bfloat16))
    plain_ms["sweep"] = time_ms(
        lambda: sweep_ops.ods_sweep_plain(images, rowp, torch.bfloat16))
    kernel_ms["conv"] = plain_ms["conv"] = 0.0
    kernel_ms["layernorm"] = plain_ms["layernorm"] = 0.0
    flops = 0.0
    for plan, st in zip(params.net.plan, params.stages):
        name, kind, _, cins, cout, _, _, _ = plan
        x = stage_inputs[name]
        y = conv_ops.conv(x, st["w"], st["b"], **st["args"])
        kt = time_ms(lambda: conv_ops.conv(x, st["w"], st["b"],
                                           **st["args"]))
        pt = time_ms(lambda: conv_ops.conv_plain(x, st["w"], st["b"],
                                                 **st["args"]))
        kk = st["w"].shape[0] * st["w"].shape[1]      # taps x Cin per pixel
        f = 2.0 * kk * cout * y.shape[2] * y.shape[3] / st["w"].shape[0]
        flops += f
        line = (f"conv {name:10s} kernel {kt:8.3f} ms ({f / kt / 1e9:6.2f} "
                f"TFLOP/s) plain {pt:8.3f} ms")
        kernel_ms["conv"] += kt
        plain_ms["conv"] += pt
        if "gamma" in st:
            lt = time_ms(lambda: ln_ops.layer_norm_relu(y, st["gamma"],
                                                        st["beta"]))
            lp = time_ms(lambda: ln_ops.layer_norm_relu_plain(
                y, st["gamma"], st["beta"]))
            kernel_ms["layernorm"] += lt
            plain_ms["layernorm"] += lp
            line += f" | layernorm kernel {lt:7.3f} ms plain {lp:7.3f} ms"
        print(line, tag)
    print(f"net conv total {flops / 1e9:.1f} GFLOP: kernel "
          f"{kernel_ms['conv']:.3f} ms = "
          f"{flops / kernel_ms['conv'] / 1e9:.2f} TFLOP/s {tag}")
    u0, v0 = render_lib.uv_tables(rt0, b0["tgt_pose"], params.msi_depths,
                                  h, w)
    kernel_ms["render"] = time_ms(
        lambda: render_ops.render_blend(vol0, pred0, u0, v0))
    plain_ms["render"] = time_ms(
        lambda: render_ops.render_blend_plain(vol0, pred0, u0, v0))
    for k in kernel_ms:
        print(f"kernel {k:9s} {kernel_ms[k]:9.3f} ms  plain "
              f"{plain_ms[k]:9.3f} ms {tag}")

    sources = {
        "sweep": ("matryodshka_tpu_torch/csrc/sweep.cu",
                  "matryodshka_tpu/ops/pallas_sweep.py:230"),
        "conv": ("matryodshka_tpu_torch/csrc/conv.cu",
                 "matryodshka_tpu/ops/pallas_net.py:356"),
        "layernorm": ("matryodshka_tpu_torch/csrc/layernorm.cu",
                      "matryodshka_tpu/ops/pallas_net.py:356"),
        "render": ("matryodshka_tpu_torch/csrc/render.cu",
                   "matryodshka_tpu/ops/pallas_render.py:920"),
    }
    print(json.dumps({"kernels": [
        {"name": k, "route": "cuda", "source": sources[k][0],
         "replaces": sources[k][1], "launches": launches[k],
         "max_abs_err": errs[k], "ms": kernel_ms[k], "plain_ms": plain_ms[k]}
        for k in sources]}))
    print(nvidia_smi_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
