"""A copy of the benchmark with a tiny configuration and two tiny mixes
added as files only, as a later change would add a cell, for CPU tests."""

from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parent.parent
ROOT = BENCH.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

#: The tiny mixes' limits: the CPU's plain routes in bfloat16 against the
#: reference at 64x32, 4 planes, ngf 8 read up to ~7e-3 / 6e-4 (view) and
#: ~1.5e-3 / 2.5e-4 (re-render); an altered answer reads 0.1 or more.
TINY_LIMITS = {
    "video": {"view_max_abs": 0.03, "view_mean_abs": 0.003},
    "hres": {"rgb_max_abs": 0.01, "rgb_mean_abs": 0.002,
             "depth_max_abs": 0.01, "depth_mean_abs": 0.002},
}
TINY_SIZES = dict(height=32, width=64, hres_height=64, hres_width=128,
                  num_psv_planes=4, num_msi_planes=4, ngf=8)


def make_tiny(tmp: Path, config: str = "ods-coord") -> Path:
    """tmp/msi_bench (the benchmark's files, unchanged) + tmp/BENCHMARK.json
    with the config "tiny" (a copy of `config` at TINY_SIZES) and the cells
    "tiny.tiny_video" and "tiny.tiny_hres" (copies of the mixes with fewer
    examples and TINY_LIMITS). Returns the copy's bench directory."""
    bench_dir = tmp / "msi_bench"
    shutil.copytree(BENCH, bench_dir, ignore=shutil.ignore_patterns(
        "__pycache__", "tests"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    conf = json.loads((BENCH / "configs" / f"{config}.json").read_text())
    conf.update(name="tiny", **TINY_SIZES)
    (bench_dir / "configs" / "tiny.json").write_text(json.dumps(conf))
    bench["configs"].append({"name": "tiny", "source": conf["source"],
                             "file": "msi_bench/configs/tiny.json",
                             "reduced": [], "why": "CPU tests"})
    for kind in ("video", "hres"):
        mix = json.loads((BENCH / "traffic" / f"{kind}.json").read_text())
        mix.update(ring=2 * mix.get("viewers", 1), poses=16, warmup=2,
                   sample=2,
                   limits=TINY_LIMITS[kind])
        (bench_dir / "traffic" / f"tiny_{kind}.json").write_text(
            json.dumps(mix))
        bench["workloads"].append({"name": f"tiny.tiny_{kind}",
                                   "config": "tiny",
                                   "traffic": f"tiny_{kind}", "chips": 1,
                                   "why": "CPU tests"})
    (tmp / "BENCHMARK.json").write_text(json.dumps(bench))
    return bench_dir
