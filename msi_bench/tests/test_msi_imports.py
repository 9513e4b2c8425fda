"""What a run and the reference load: no module whose top-level name,
compared whole, is jax, jaxlib, flax or matryodshka_tpu; and the reference
loads nothing of the port (matryodshka_tpu_torch) either."""

from __future__ import annotations

import json
import subprocess
import sys
import textwrap

import msi_tiny
from msi_bench import harness

FORBIDDEN = {"jax", "jaxlib", "flax", "matryodshka_tpu"}


def _top_level(code: str):
    """The top-level names of every module a fresh interpreter holds after
    running code."""
    out = subprocess.run(
        [sys.executable, "-c", textwrap.dedent(code) + textwrap.dedent("""
            import json, sys
            print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
            """)],
        cwd=msi_tiny.ROOT, capture_output=True, text=True, timeout=600,
        check=True)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_a_run_loads_no_jax(tmp_path):
    names = _top_level(f"""
        import sys
        sys.path.insert(0, {str(msi_tiny.BENCH / 'tests')!r})
        import msi_tiny
        from pathlib import Path
        from msi_bench import harness
        bench_dir = msi_tiny.make_tiny(Path({str(tmp_path)!r}))
        for kind in ("video", "hres"):
            harness.run_cell("tiny.tiny_" + kind, 7, 0.2, 0, "cpu",
                             bench_dir=bench_dir)
        assert harness.forbidden_modules() == []
        """)
    assert "matryodshka_tpu_torch" in names
    assert not names & FORBIDDEN


def test_the_reference_loads_nothing_of_the_program():
    names = _top_level("""
        import torch
        from msi_bench import reference
        from msi_bench.reference import geometry, quant, unet
        tree = {k: {l: torch.ones(s) * 0.1 for l, s in v.items()}
                for k, v in unet.layer_shapes(4, 12, 4, "coord").items()}
        d = torch.tensor(geometry.inv_depths(1.0, 100.0, 2))
        img = torch.rand(16, 32, 3)
        reference.video_view(tree, "coord", 4, img, img, d, d, 0.032,
                             torch.eye(4), torch.zeros(3), q=quant.fp8)
        reference.hres_render(img, img, torch.rand(8, 16, 2),
                              torch.rand(8, 16, 2), d, 0.032, torch.zeros(3))
        """)
    assert "msi_bench" in names
    assert not names & (FORBIDDEN | {"matryodshka_tpu_torch"})


def test_forbidden_names_are_compared_whole(monkeypatch):
    base = harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "matryodshka_tpu_torch_extra", sys)
    monkeypatch.setitem(sys.modules, "jaxlike", sys)
    assert harness.forbidden_modules() == base
    monkeypatch.setitem(sys.modules, "matryodshka_tpu.fake", sys)
    monkeypatch.setitem(sys.modules, "flax.linen", sys)
    assert set(harness.forbidden_modules()) == set(base) | {
        "matryodshka_tpu", "flax"}
