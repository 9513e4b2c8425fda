"""A run whose timed path is broken underneath comes out not correct: the
harness's CUDA check is skipped (the CPU runs the port's plain routes at a
tiny size) and the rest of a run is driven, with an answer altered where it
is produced, a stale answer handed back, or one viewer's answer handed to
every viewer of a batched call. The cells have no state that a step
updates and one chip, so those are the faults they can have."""

from __future__ import annotations

import pytest

import msi_tiny
from matryodshka_tpu_torch import entry
from matryodshka_tpu_torch.cli import test as cli_test
from msi_bench import harness

SEED = 3 * 2**30 + 17


def _run(tmp_path, kind):
    bench_dir = msi_tiny.make_tiny(tmp_path)
    return harness.run_cell(f"tiny.tiny_{kind}", SEED, 0.3, 0, "cpu",
                            bench_dir=bench_dir)


@pytest.mark.parametrize("fault", ["altered", "stale", "one_viewer"])
def test_video_fault_is_not_correct(tmp_path, monkeypatch, fault):
    forward = entry.forward
    last = []

    def broken(params, batch, rot=None):
        out = forward(params, batch, rot)
        if fault == "altered":
            out[:, :4, :4] += 0.5
            return out
        if fault == "one_viewer":
            return out[:1].expand_as(out)
        last.append(out)
        return last[-2] if len(last) > 1 else out

    monkeypatch.setattr(entry, "forward", broken)
    result, checks = _run(tmp_path, "video")
    assert not result["correct"], checks
    assert checks["view_max_abs"][0] > checks["view_max_abs"][1]


@pytest.mark.parametrize("output", [0, 1])
def test_hres_fault_is_not_correct(tmp_path, monkeypatch, output):
    build = cli_test.build_hres_render_fn

    def broken_build(cfg, *args, **kwargs):
        render = build(cfg, *args, **kwargs)

        def broken(*a, **k):
            outs = list(render(*a, **k))
            outs[output] = outs[output].clone()
            outs[output][:, :4, :4] += 0.2
            return tuple(outs)
        return broken

    monkeypatch.setattr(cli_test, "build_hres_render_fn", broken_build)
    result, checks = _run(tmp_path, "hres")
    assert not result["correct"], checks
    name = ("rgb", "depth")[output] + "_max_abs"
    assert checks[name][0] > checks[name][1]
