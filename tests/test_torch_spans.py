"""The port's spans (matryodshka_tpu_torch/trace.py): the hot-path spans'
no-op without a profiler, their nesting in a traced frame and re-render,
the setup spans, and `_build.launch`.

The file imports neither JAX nor the JAX package. The CPU tests run the
plain routes at tiny shapes under a CPU-only profiler; the test marked
`cuda` checks, on the card, that every port kernel of a traced frame and
re-render belongs to a `launch.*` span inside its stage span:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_spans.py
"""

from __future__ import annotations

import json
import os
import re
import tempfile
import time
from types import SimpleNamespace

import pytest
import torch

from matryodshka_tpu_torch import entry, trace
from matryodshka_tpu_torch.cli import test as cli_test
from matryodshka_tpu_torch.ops import _build

SIZES = dict(height=32, width=64, hres_height=64, hres_width=128,
             num_psv_planes=4, num_msi_planes=4, ngf=8)
STAGES = ("msi.sweep_stage", "msi.net_stage", "msi.render_stage")
HRES_STAGES = ("sweep.sweep_assembled",
               "render.render_equirect_view_prepared_both")


def _cfg(**kw):
    return entry.flagship_cfg(**SIZES, **kw)


def _trace(fn, cuda=False):
    """fn() under torch.profiler -> the Chrome trace's complete events."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if cuda:
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        fn()
        if cuda:
            torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as fh:
            events = json.load(fh)["traceEvents"]
    return [e for e in events if e.get("ph") == "X"]


def _spans(events):
    """The program's spans: [(name, start, end)] in order of start."""
    return sorted(((e["name"], e["ts"], e["ts"] + e["dur"]) for e in events
                   if e.get("cat") == trace.SPAN_CAT), key=lambda s: s[1])


def _inside(inner, outer):
    return outer[1] <= inner[1] and inner[2] <= outer[2]


def _hres_args(cfg, dev, seed=0):
    gen = torch.Generator(device=dev).manual_seed(seed)
    p = cfg.num_psv_planes
    big = [torch.rand((1, cfg.hres_height, cfg.hres_width, 3), generator=gen,
                      device=dev) for _ in range(2)]
    low = [torch.rand((1, cfg.height, cfg.width, p), generator=gen,
                      device=dev) for _ in range(2)]
    intr = torch.eye(3, device=dev)[None].contiguous()
    intr[0, 0, 0] = 0.032
    pos = torch.tensor([[0.02, 0.0, 0.01]], device=dev)
    return (*big, *low, None, None, None, intr, pos)


def test_span_without_a_profiler_is_the_shared_no_op():
    a, b = trace.span("conv.conv"), trace.span("launch.matry_conv")
    assert a is b is trace._NO_SPAN
    with a:
        with b:
            pass


@pytest.mark.parametrize("coord_net", [False, True])
def test_forward_spans_nest_in_the_profiler_trace(coord_net):
    """entry.forward > the three stages in order, net_stage > 18 conv.conv;
    no launch span on the CPU (its plain routes launch nothing)."""
    cfg = _cfg(coord_net=coord_net)
    params = entry.make_params(cfg, seed=0, device="cpu")
    batch = entry.synthetic_batch(cfg, 0, "cpu")
    spans = _spans(_trace(lambda: entry.forward(params, batch)))
    names = [s[0] for s in spans]
    assert sorted(set(names)) == sorted({"entry.forward", "conv.conv",
                                         *STAGES})
    assert names.count("entry.forward") == 1
    fwd = spans[names.index("entry.forward")]
    stages = [s for s in spans if s[0] in STAGES]
    assert [s[0] for s in stages] == list(STAGES)
    assert all(_inside(s, fwd) for s in stages)
    assert all(a[2] <= b[1] for a, b in zip(stages, stages[1:]))
    convs = [s for s in spans if s[0] == "conv.conv"]
    assert len(convs) == 18
    assert all(_inside(c, stages[1]) for c in convs)


def test_hres_render_spans_nest_in_the_profiler_trace():
    cfg = _cfg()
    before = len(trace.setup_spans())
    render = cli_test.build_hres_render_fn(cfg)
    made = trace.setup_spans()[before:]
    assert [(s.name, s.depth) for s in made] == [
        ("test.build_hres_render_fn", 0)]
    args = _hres_args(cfg, "cpu")
    spans = _spans(_trace(lambda: render(*args)))
    assert [s[0] for s in spans] == ["test.hres_render", *HRES_STAGES]
    assert all(_inside(s, spans[0]) for s in spans[1:])


def test_make_params_records_nested_setup_spans_on_perf_counter():
    cfg = _cfg()
    before = len(trace.setup_spans())
    t0 = time.perf_counter()
    entry.make_params(cfg, seed=0, device="cpu")
    t1 = time.perf_counter()
    made = trace.setup_spans()[before:]
    top = [s for s in made if s.depth == 0]
    assert [s.name for s in top] == ["entry.make_params"]
    parts = [s for s in made if s.depth == 1]
    assert [s.name for s in parts] == ["weights.seeded_init",
                                       "weights.from_flax", "unet.MSIUNet",
                                       "net.prepare"]
    assert t0 <= top[0].start and top[0].end <= t1
    assert all(top[0].start <= s.start <= s.end <= top[0].end
               for s in parts)
    assert all(a.end <= b.start for a, b in zip(parts, parts[1:]))


def test_setup_spans_stay_bounded_and_keep_the_newest():
    for i in range(trace.SETUP_SPANS_MAX + 10):
        with trace.setup_span(f"t.{i}"):
            pass
    got = trace.setup_spans()
    assert len(got) == trace.SETUP_SPANS_MAX
    assert got[-1].name == f"t.{trace.SETUP_SPANS_MAX + 9}"


def test_setup_span_is_a_profiler_span_too():
    def cold():
        with trace.setup_span("entry.make_params"):
            with trace.setup_span("net.prepare"):
                pass
    spans = _spans(_trace(cold))
    assert [s[0] for s in spans] == ["entry.make_params", "net.prepare"]
    assert _inside(spans[1], spans[0])


def test_launch_checks_the_entrys_code(monkeypatch):
    calls = []

    def entry_fn(code):
        def call(*args):
            calls.append(args)
            return code
        return call
    monkeypatch.setattr(_build, "_lib", SimpleNamespace(
        matry_probe_trig=entry_fn(0), matry_probe_roll=entry_fn(700)))
    assert _build.launch("matry_probe_trig", 1, None, 3) is None
    assert calls == [(1, None, 3)]
    with pytest.raises(RuntimeError, match=r"matry_probe_roll: .*700"):
        _build.launch("matry_probe_roll", 4)


def test_launch_leaves_a_launch_span(monkeypatch):
    monkeypatch.setattr(_build, "_lib", SimpleNamespace(
        matry_sweep=lambda *args: 0))
    spans = _spans(_trace(lambda: _build.launch("matry_sweep", 1, 2)))
    assert [s[0] for s in spans] == ["launch.matry_sweep"]


def test_span_self_time_subtracts_direct_children_only():
    spans = [("a", 0.0, 100.0, 1), ("b", 10.0, 50.0, 1),
             ("c", 20.0, 10.0, 1), ("b", 70.0, 20.0, 1),
             ("a", 0.0, 5.0, 2)]
    assert trace.span_self_us(spans) == {"a": (2, 35.0), "b": (2, 60.0),
                                         "c": (1, 10.0)}


# ---------------------------------------------------------------------------
# On the card.
# ---------------------------------------------------------------------------

def _port_kernels_attributed(events, stages):
    """Each port kernel's launch span and stage span, found through its
    runtime launch event (args.correlation) -> [(kernel, launch span,
    stage span or None)]."""
    runtime = {e["args"]["correlation"]: e for e in events
               if e.get("cat") in ("cuda_runtime", "cuda_driver")
               and "correlation" in e.get("args", {})}
    spans = [e for e in events if e.get("cat") == trace.SPAN_CAT]
    pat = re.compile(r"\b(" + "|".join(trace.PORT_KERNELS) + r")\b")
    out = []
    for k in events:
        if k.get("cat") != "kernel" or not pat.search(k.get("name", "")):
            continue
        rt = runtime[k["args"]["correlation"]]
        holding = sorted((s for s in spans if s["tid"] == rt["tid"]
                          and s["ts"] <= rt["ts"]
                          and rt["ts"] + rt.get("dur", 0)
                          <= s["ts"] + s["dur"]),
                         key=lambda s: s["dur"])
        stage = next((s["name"] for s in holding if s["name"] in stages),
                     None)
        out.append((k["name"], holding[0]["name"] if holding else None,
                    stage))
    return out


@pytest.mark.cuda
def test_every_port_kernel_belongs_to_a_launch_span_in_its_stage():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    dev = torch.device("cuda")
    cfg = _cfg()
    params = entry.make_params(cfg, seed=0, device=dev)
    batch = entry.synthetic_batch(cfg, 0, dev)
    render = cli_test.build_hres_render_fn(cfg)
    args = _hres_args(cfg, dev)
    for fn, stages, kernels in (
            (lambda: entry.forward(params, batch), STAGES, 20),
            (lambda: render(*args), HRES_STAGES, 2)):
        fn()
        torch.cuda.synchronize()
        got = _port_kernels_attributed(_trace(fn, cuda=True), stages)
        assert len(got) >= kernels, got
        for kern, lname, stage in got:
            assert lname is not None and lname.startswith("launch."), (
                kern, lname)
            assert stage is not None, (kern, lname)
