"""The RealEstate10K MPI cell (`realestate-coord.mpi-video`) on the CPU at a
tiny size: a run reports its end-to-end metrics and is correct, a render
that drops the nearest plane is not, and the cell's five per-layer metrics
are read in it alone."""

from __future__ import annotations

import json
from pathlib import Path

import pytest
import torch

import msi_tiny
from matryodshka_tpu_torch.models import msi as msi_lib
from msi_bench import harness

SEED = 2**31 + 977
CELL = "tiny_mpi.tiny_mpi_video"
NEW = ("mpi_sweep_roofline.mpi-video", "mpi_render_roofline.mpi-video",
       "mfu.mpi-video", "idle_share.mpi-video",
       "mpi_render_host_us.mpi-video")
#: The tiny mix's limits: the CPU's plain routes in bfloat16 against the
#: reference at 32x64, 4 planes, ngf 8 read ~6e-3 / 8e-4; the fp8 control
#: and a view without its nearest plane read 0.1 or more.
LIMITS = {"view_max_abs": 0.03, "view_mean_abs": 0.003}


def make_tiny_mpi(tmp: Path) -> Path:
    """msi_tiny's copy plus the config "tiny_mpi" (realestate-coord at
    msi_tiny's sizes) and the cell CELL (the mpi-video mix with fewer
    examples and LIMITS); the new per-layer metrics list it too."""
    bench_dir = msi_tiny.make_tiny(tmp)
    conf = json.loads((msi_tiny.BENCH / "configs"
                       / "realestate-coord.json").read_text())
    conf.update(name="tiny_mpi", **{k: v for k, v in msi_tiny.TINY_SIZES
                                    .items() if not k.startswith("hres")})
    (bench_dir / "configs" / "tiny_mpi.json").write_text(json.dumps(conf))
    mix = json.loads((msi_tiny.BENCH / "traffic" / "mpi-video.json")
                     .read_text())
    mix.update(ring=8, poses=16, warmup=2, sample=2, trace_requests=2,
               limits=LIMITS)
    (bench_dir / "traffic" / "tiny_mpi_video.json").write_text(
        json.dumps(mix))
    bench = json.loads((tmp / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "tiny_mpi", "source": conf["source"],
                             "file": "msi_bench/configs/tiny_mpi.json",
                             "reduced": [], "why": "CPU tests"})
    bench["workloads"].append({"name": CELL, "config": "tiny_mpi",
                               "traffic": "tiny_mpi_video", "chips": 1,
                               "why": "CPU tests"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "realestate-coord.mpi-video" in m.get("workloads", ()):
            m["workloads"].append(CELL)
    (tmp / "BENCHMARK.json").write_text(json.dumps(bench))
    return bench_dir


def test_tiny_cell_reports_its_metrics_and_is_correct(tmp_path):
    bench_dir = make_tiny_mpi(tmp_path)
    result, checks = harness.run_cell(CELL, SEED, 0.5, 0, "cpu",
                                      bench_dir=bench_dir)
    assert result["correct"], checks
    assert result["attempted"] > 0
    assert set(result["metrics"]) == {"frames_per_s", "frame_ms_p95",
                                      "setup_s"}
    assert all(v["value"] > 0 for v in result["metrics"].values())
    assert set(checks) == set(LIMITS)


def test_dropping_the_nearest_plane_is_not_correct(tmp_path, monkeypatch):
    render = msi_lib.render_mpi_view

    def broken(rgba_layers, tgt_pose, radii, intrinsics):
        return render(rgba_layers[..., :-1, :], tgt_pose, radii[:-1],
                      intrinsics)

    monkeypatch.setattr(msi_lib, "render_mpi_view", broken)
    bench_dir = make_tiny_mpi(tmp_path)
    result, checks = harness.run_cell(CELL, SEED, 0.3, 0, "cpu",
                                      bench_dir=bench_dir)
    assert not result["correct"], checks
    assert checks["view_max_abs"][0] > checks["view_max_abs"][1]


@pytest.mark.parametrize("kind", ["video", "mpi"])
def test_new_metrics_are_read_in_the_mpi_cell_only(tmp_path, monkeypatch,
                                                   kind):
    """Device traces need a card, so the readers' context stands in for
    them; what is tested is which metrics a cell reports."""
    bench_dir = make_tiny_mpi(tmp_path)
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    workload = CELL if kind == "mpi" else "tiny.tiny_video"
    _, cell, config, traffic, mod = harness.load_cell(workload, bench_dir)
    ctx = harness.Ctx(bench_dir, cell, config, traffic, SEED, "cpu")
    ctx.driver = mod.Driver(ctx)
    ctx.window = ctx.driver.window(0.3)
    monkeypatch.setattr(ctx, "stage_busy_s", lambda stage: 1.0)
    monkeypatch.setattr(ctx, "traffic_trace", lambda: (0.01, 0.02, []))
    host = [("msi.mpi_render_stage", 0.0, 40.0),
            ("msi.mpi_render_stage", 90.0, 60.0)]
    ctx._memo["program_spans"] = ([], host)
    got = harness.per_layer(bench, cell, ctx)
    if kind == "video":
        assert not set(NEW) & set(got)
        return
    assert set(NEW) <= set(got)
    assert got["mpi_render_host_us.mpi-video"]["value"] == 50.0
    for name in NEW[:3]:
        assert 0.0 < got[name]["value"] < 100.0, name


def test_mpi_work_counts_by_hand():
    from types import SimpleNamespace

    from matryodshka_tpu_torch import entry
    from msi_bench import peaks

    cfg = entry.flagship_cfg(input_type="REALESTATE_PP", coord_net=True)
    meta = torch.device("meta")
    img = torch.empty((4, 320, 640, 3), device=meta)
    vol = torch.empty((4, 195, 320, 640), dtype=torch.bfloat16, device=meta)
    pred = torch.empty((4, 64, 320, 640), device=meta)
    ctx = SimpleNamespace(cfg=cfg, driver=SimpleNamespace(stage_io={
        "batch": {"ref_image": img}, "vol": vol, "pred": pred}))
    px = 320 * 640
    flops, nbytes, peak = harness.load_module(
        msi_tiny.BENCH, "work", "mpi_sweep").count(ctx)
    assert (flops, peak) == (47 * 4 * 64 * px, "f32")
    assert nbytes == 2 * 4 * px * 3 * 4 + 4 * 195 * px * 2
    assert peaks.least_s(flops, nbytes, peak) == pytest.approx(
        nbytes / 3.35e12)
    flops, nbytes, peak = harness.load_module(
        msi_tiny.BENCH, "work", "mpi_render").count(ctx)
    assert (flops, peak) == (72 * 4 * 32 * px, "f32")
    assert nbytes == 4 * px * (192 * 2 + 64 * 4 + 3 * 4)
