"""The metric arithmetic: the tail over all requests, the interval union,
and the stages' work against hand counts."""

from __future__ import annotations

from types import SimpleNamespace

import pytest
import torch

import msi_tiny  # noqa: F401  (puts the repository on sys.path)
from matryodshka_tpu_torch import entry
from msi_bench import harness, peaks, reference, stats

META = torch.device("meta")


def test_percentile_is_the_nearest_rank_over_all_values():
    values = list(range(1, 101))           # 1 .. 100
    assert stats.percentile(values, 95) == 95
    assert stats.percentile(values[::-1], 95) == 95
    assert stats.percentile([3.0], 95) == 3.0
    assert stats.percentile([1, 2, 3, 4, 100], 95) == 100
    with pytest.raises(ValueError):
        stats.percentile([], 95)


def test_union_length():
    assert stats.union_length([]) == 0.0
    assert stats.union_length([(0, 2), (1, 2), (5, 1)]) == 4.0
    assert stats.union_length([(5, 1), (0, 10)]) == 10.0
    assert stats.union_length([(0, 1), (1, 1)]) == 2.0


def _ctx(cfg, io):
    shapes = reference.unet.layer_shapes(cfg.ngf, cfg.num_net_inputs(),
                                         cfg.num_net_outputs(),
                                         cfg.net_variant)
    tree = {layer: {leaf: torch.empty(s, device=META)
                    for leaf, s in leaves.items()}
            for layer, leaves in shapes.items()}
    return SimpleNamespace(cfg=cfg, tree=tree,
                           driver=SimpleNamespace(stage_io=io))


def _work(stage, ctx):
    return harness.load_module(msi_tiny.BENCH, "work", stage).count(ctx)


#: The U-Net at 640x320, ngf 64, 192 inputs, 64 outputs, by hand:
#: (output rows, columns, Cout, Cin, taps) per stage.
UNET = [(320, 640, 64, 192, 9), (160, 320, 128, 64, 9),
        (160, 320, 128, 128, 9), (80, 160, 256, 128, 9),
        (80, 160, 256, 256, 9), (80, 160, 256, 256, 9),
        (40, 80, 512, 256, 9)] + [(40, 80, 512, 512, 9)] * 3 + [
        (80, 160, 256, 1024, 4), (80, 160, 256, 256, 9),
        (80, 160, 256, 256, 9), (160, 320, 128, 512, 4),
        (160, 320, 128, 128, 9), (320, 640, 64, 256, 4),
        (320, 640, 64, 64, 9), (320, 640, 64, 64, 1)]


@pytest.mark.parametrize("coord", [False, True])
def test_net_work_is_301_gflop(coord):
    cfg = entry.flagship_cfg(coord_net=coord)
    vol = torch.empty((1, 192, 320, 640), dtype=torch.bfloat16, device=META)
    pred = torch.empty((1, 64, 320, 640), device=META)
    flops, nbytes, peak = _work("net", _ctx(cfg, {"vol": vol, "pred": pred}))
    macs = 0
    for i, (h, w, co, ci, taps) in enumerate(UNET):
        extra = int(coord and taps == 9)   # the coord channel: convs, downs
        macs += h * w * co * (ci + extra) * taps
    assert peak == "bf16"
    assert 2 * macs == pytest.approx(301.1e9 if not coord else 302.4e9,
                                     rel=2e-3)
    # + the layer norms and ReLUs (5 an element) and the head's tanh
    assert 2 * macs < flops < 2 * macs * 1.01
    assert peaks.least_s(flops, nbytes, peak) == pytest.approx(
        flops / 989e12)
    assert peaks.least_s(flops, nbytes, peak) == pytest.approx(
        3.045e-4 if not coord else 3.058e-4, rel=2e-3)


def test_sweep_work():
    cfg = entry.flagship_cfg()
    img = torch.empty((1, 320, 640, 3), device=META)
    vol = torch.empty((1, 192, 320, 640), dtype=torch.bfloat16, device=META)
    flops, nbytes, peak = _work("sweep", _ctx(cfg, {
        "batch": {"ref_image": img}, "vol": vol}))
    assert nbytes == 2 * 320 * 640 * 3 * 4 + 192 * 320 * 640 * 2
    assert flops == 9 * 192 * 320 * 640
    assert peaks.least_s(flops, nbytes, peak) == pytest.approx(24.94e-6,
                                                               rel=1e-3)


def test_hres_work():
    cfg = entry.flagship_cfg()
    big = torch.empty((1, 2048, 4096, 3), device=META)
    low = torch.empty((1, 320, 640, 32), device=META)
    stack = torch.empty((1, 32, 2048, 4096, 4), dtype=torch.bfloat16,
                        device=META)
    ctx = _ctx(cfg, {"args": (big, big, None, None, low, low),
                     "stack": stack})
    flops, nbytes, peak = _work("sweep_assembled", ctx)
    assert nbytes == 4 * (2 * 2048 * 4096 * 3 + 2 * 320 * 640 * 32) \
        + 32 * 2048 * 4096 * 8
    assert peaks.least_s(flops, nbytes, peak) == pytest.approx(7.168e-4,
                                                               rel=1e-3)
    flops, nbytes, peak = _work("render_layers", ctx)
    assert nbytes == 32 * 2048 * 4096 * 8 + 2 * 2048 * 4096 * 3 * 4
    assert peaks.least_s(flops, nbytes, peak) == pytest.approx(7.011e-4,
                                                               rel=1e-3)


def test_render_counts_the_samples_front_to_back_needs():
    render = harness.load_module(msi_tiny.BENCH, "work", "render")
    p, h, w = 4, 16, 32
    radii = torch.tensor([8.0, 4.0, 2.0, 1.0])
    eye, pos = torch.eye(4), torch.zeros(3)
    # opaque nearest shell: only it is needed
    alpha = torch.zeros((p, h, w))
    alpha[-1] = 1.0
    assert render.visited(alpha, eye, pos, radii) == pytest.approx(1 / p)
    # transparent shells: every one is needed
    assert render.visited(torch.zeros((p, h, w)), eye, pos,
                          radii) == pytest.approx(1.0)
    # about half the rays stopped at the nearest shell (the bilinear taps
    # blur the edge between the halves)
    alpha[-1, :, : w // 2] = 0.0
    share = render.visited(alpha, eye, pos, radii)
    assert share == pytest.approx((1 / p + 1) / 2, abs=0.05)
    cfg = entry.flagship_cfg(height=h, width=w, num_psv_planes=p,
                             num_msi_planes=p)
    vol = torch.zeros((1, 6 * p, h, w), dtype=torch.bfloat16)
    pred = torch.cat([torch.zeros((1, p, h, w)), 2 * alpha[None] - 1], 1)
    flops, nbytes, peak = _work("render", _ctx(cfg, {
        "vol": vol, "pred": pred, "rot": eye[None], "pos": pos[None],
        "msi_depths": radii}))
    assert nbytes == pytest.approx(share * (vol.numel() * 2
                                            + pred.numel() * 4)
                                   + h * w * 3 * 4)
    assert flops == pytest.approx(share * 121 * p * h * w)
    assert peak == "f32"


def test_video_rate_and_tail_are_over_the_whole_window():
    video = harness.load_module(msi_tiny.BENCH, "drivers", "video")
    # 3 calls of 4 viewers: each frame carries its call's latency
    lat = [0.010] * 4 + [0.020] * 4 + [0.015] * 4
    win = {"requests": 3, "answers": 12, "window_s": 0.05,
           "latencies_s": lat}
    e2e = video.Driver.e2e(None, win)
    assert e2e["frames_per_s"]() == pytest.approx(240.0)
    assert e2e["frame_ms_p95"]() == pytest.approx(20.0)


def _reader(name):
    return harness.load_module(msi_tiny.BENCH, "metrics", name).read


def test_video_device_readers():
    ctx = harness.Ctx.__new__(harness.Ctx)
    ctx.traffic = {"trace_requests": 50, "viewers": 4}
    ctx.traffic_trace = lambda: (0.4, 0.41, [])
    ctx.window = {"requests": 1000, "window_s": 10.0,
                  "submit_s": [0.002, 0.001, 0.003]}
    ctx.least_s = {"sweep": 1e-4, "net": 1.2e-3, "render": 2e-4}.get
    ctx.stage_busy_s = {"sweep": 4e-4, "net": 6e-3, "render": None}.get
    ctx.driver = SimpleNamespace(request_stages=("sweep", "net", "render"))
    # 0.4 s busy over 50 calls of 4 frames
    assert _reader("frame_device_ms")(ctx) == pytest.approx(2.0)
    # 8 ms busy a call against 10 ms of window a call
    assert _reader("idle_share.video")(ctx) == pytest.approx(20.0)
    assert _reader("mfu.video")(ctx) == pytest.approx(15.0)
    assert _reader("host_submit_ms.video")(ctx) == pytest.approx(2.0)
    assert _reader("sweep_roofline.video")(ctx) == pytest.approx(25.0)
    assert _reader("net_roofline.video")(ctx) == pytest.approx(20.0)
    assert _reader("render_roofline.video")(ctx) is None
    ctx.least_s = {"sweep": 1e-4, "net": None, "render": 2e-4}.get
    assert _reader("mfu.video")(ctx) is None


def test_trace_fails_rather_than_read_a_window_that_lost_a_spin(
        monkeypatch):
    from msi_bench import devtrace
    tries = []

    def lost_spin(fn, host):
        tries.append(1)
        return 1, [("op", 0.0, 1.0)], [], 0.0
    monkeypatch.setattr(devtrace, "_window", lost_spin)
    with pytest.raises(RuntimeError):
        devtrace.trace(lambda: None, 1)
    assert len(tries) == devtrace.TRIES


def test_render_share_of_a_batch_is_the_mean_of_its_views():
    p, h, w = 4, 16, 32
    radii = torch.tensor([8.0, 4.0, 2.0, 1.0])
    eye, pos = torch.eye(4), torch.zeros(3)
    opaque = torch.zeros((p, h, w))
    opaque[-1] = 1.0
    clear = torch.zeros((p, h, w))
    cfg = entry.flagship_cfg(height=h, width=w, num_psv_planes=p,
                             num_msi_planes=p)
    vol = torch.zeros((2, 6 * p, h, w), dtype=torch.bfloat16)
    pred = torch.cat([torch.zeros((2, p, h, w)),
                      2 * torch.stack([opaque, clear]) - 1], 1)
    flops, _, _ = _work("render", _ctx(cfg, {
        "vol": vol, "pred": pred, "rot": eye.repeat(2, 1, 1),
        "pos": pos.repeat(2, 1), "msi_depths": radii}))
    assert flops == pytest.approx((1 / p + 1) / 2 * 121 * 2 * p * h * w)
