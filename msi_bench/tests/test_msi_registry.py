"""A cell, a configuration, a traffic mix and a per-layer metric are added
as files and entries only, and the harness finds each by its name."""

from __future__ import annotations

import json

import msi_tiny
from msi_bench import harness

SEED = 2**31 + 12345


def _dummy_metric(tmp_path, bench_dir):
    (bench_dir / "metrics" / "dummy_frames.tiny.py").write_text(
        "def read(ctx):\n    return float(ctx.window['requests'])\n")
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    bench["per_layer"].append({
        "name": "dummy_frames.tiny", "unit": "frames", "better": "higher",
        "source": "host_clock", "layer": "stages", "moves": "setup_s",
        "workloads": ["tiny.tiny_video"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    return bench


def test_added_files_leave_the_benchmark_unchanged(tmp_path):
    bench_dir = msi_tiny.make_tiny(tmp_path)
    _dummy_metric(tmp_path, bench_dir)
    for f in msi_tiny.BENCH.rglob("*"):
        rel = f.relative_to(msi_tiny.BENCH)
        if f.is_file() and not {"tests", "__pycache__"} & set(
                rel.parts):
            assert (bench_dir / rel).read_bytes() == f.read_bytes(), rel


def test_run_finds_the_added_config_and_mixes(tmp_path):
    bench_dir = msi_tiny.make_tiny(tmp_path)
    for kind in ("video", "hres"):
        result, checks = harness.run_cell(f"tiny.tiny_{kind}", SEED, 0.5, 0,
                                          "cpu", bench_dir=bench_dir)
        assert result["correct"], checks
        assert result["attempted"] > 0
        assert list(result["metrics"]) == ["setup_s"]
        assert list(result)[-1] == "checks"
        assert set(checks) == set(msi_tiny.TINY_LIMITS[kind])


def test_added_metric_is_read_in_its_cell_only(tmp_path):
    bench_dir = msi_tiny.make_tiny(tmp_path)
    bench = _dummy_metric(tmp_path, bench_dir)
    got = {}
    for kind in ("video", "hres"):
        _, cell, config, traffic, mod = harness.load_cell(f"tiny.tiny_{kind}",
                                                          bench_dir)
        ctx = harness.Ctx(bench_dir, cell, config, traffic, SEED, "cpu")
        ctx.driver = mod.Driver(ctx)
        ctx.window = ctx.driver.window(0.3)
        got[kind] = harness.per_layer(bench, cell, ctx)
    assert got["video"] == {"dummy_frames.tiny": {
        "value": float(got["video"]["dummy_frames.tiny"]["value"]),
        "unit": "frames"}}
    assert got["video"]["dummy_frames.tiny"]["value"] > 0
    assert got["hres"] == {}


def test_missing_reader_reads_nothing(tmp_path):
    assert harness.load_module(msi_tiny.BENCH, "metrics", "no_such") is None
    assert harness.load_module(msi_tiny.BENCH, "work", "no_such") is None


def test_every_listed_file_and_reader_exists():
    bench = json.loads((msi_tiny.ROOT / "BENCHMARK.json").read_text())
    for conf in bench["configs"]:
        data = json.loads((msi_tiny.ROOT / conf["file"]).read_text())
        assert data["name"] == conf["name"]
        assert data["reduced"] == conf["reduced"] == []
    for cell in bench["workloads"]:
        mix = json.loads((msi_tiny.BENCH / "traffic"
                          / f"{cell['traffic']}.json").read_text())
        assert harness.load_module(msi_tiny.BENCH, "drivers",
                                   mix["driver"]) is not None
    for m in bench["per_layer"]:
        assert harness.load_module(msi_tiny.BENCH, "metrics",
                                   m["name"]) is not None, m["name"]
