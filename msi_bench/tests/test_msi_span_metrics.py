"""The readers of the program's spans, on hand-built event lists: the conv
host path's median, the re-render's idle time and the program's set-up."""

from __future__ import annotations

from types import SimpleNamespace

import pytest

import msi_tiny  # noqa: F401  (puts the repository on sys.path)
from matryodshka_tpu_torch import trace
from msi_bench import harness


def _reader(name):
    return harness.load_module(msi_tiny.BENCH, "metrics", name)


def _ctx(dev, host):
    """A run whose program trace holds these device and host events."""
    def once(key, fn):
        assert key == "program_spans"
        return dev, host
    return SimpleNamespace(traffic={"trace_requests": 2}, _once=once)


def test_conv_host_us_is_the_median_of_conv_spans_only():
    host = [("entry.forward", 0.0, 900.0), ("msi.net_stage", 10.0, 800.0),
            ("conv.conv", 20.0, 70.0), ("launch.matry_conv", 30.0, 40.0),
            ("conv.conv", 100.0, 90.0), ("conv.conv", 200.0, 500.0),
            ("aten::empty", 210.0, 1.0)]
    assert _reader("conv_host_us.video").read(_ctx([], host)) == 90.0


def test_conv_host_us_reads_nothing_without_conv_spans():
    host = [("msi.net_stage", 10.0, 800.0)]
    assert _reader("conv_host_us.video").read(_ctx([], host)) is None


def test_request_idle_counts_the_gap_before_the_first_op_only():
    host = [("test.hres_render", 0.0, 30.0),
            ("test.hres_render", 100.0, 30.0),
            ("sweep.sweep_assembled", 1.0, 10.0)]
    dev = [  # request 0: idle 5 before, 2 between; then 40 us to the next
        ("assembled_kernel", 5.0, 40.0), ("render_layers_kernel", 47.0,
                                          13.0),
        # request 1: idle 10 before, none between (overlapping ops)
        ("assembled_kernel", 110.0, 30.0), ("copy", 120.0, 30.0),
        ("render_layers_kernel", 150.0, 10.0)]
    got = _reader("request_idle_ms.hres").read(_ctx(dev, host))
    assert got == pytest.approx((7.0 + 10.0) / 2 / 1e3)


def test_request_idle_reads_nothing_without_request_spans():
    dev = [("assembled_kernel", 5.0, 40.0)]
    assert _reader("request_idle_ms.hres").read(_ctx(dev, [])) is None


def test_setup_program_sums_top_level_spans_only(monkeypatch):
    spans = [trace.SetupSpan("weights.from_flax", 1.0, 2.0, 1),
             trace.SetupSpan("net.prepare", 2.0, 2.5, 1),
             trace.SetupSpan("entry.make_params", 0.5, 3.0, 0),
             trace.SetupSpan("_build.build", 3.5, 4.0, 1),
             trace.SetupSpan("_build.lib", 3.25, 4.25, 0)]
    monkeypatch.setattr(trace, "setup_spans", lambda: spans)
    got = _reader("setup_program_s").read(None)
    assert got == pytest.approx(2.5 + 1.0)


def test_readers_read_nothing_from_a_program_without_spans(monkeypatch):
    """The parent of the spans: no trace.span, no trace.setup_spans."""
    monkeypatch.delattr(trace, "span")
    monkeypatch.delattr(trace, "setup_spans")

    def never(key, fn):
        raise AssertionError("no trace is taken")
    ctx = SimpleNamespace(traffic={"trace_requests": 2}, _once=never)
    for name in ("conv_host_us.video", "request_idle_ms.hres",
                 "setup_program_s"):
        assert _reader(name).read(ctx) is None
