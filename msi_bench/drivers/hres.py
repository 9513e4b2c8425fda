"""Closed-loop high-res re-render: one client, one request in flight.

A request is the test CLI's `--test_type high_res_only` step: the render of
`matryodshka_tpu_torch.cli.test.build_hres_render_fn(cfg)` re-renders one
example at hres_height x hres_width from its saved low-res alphas and blend
weights, and the client waits for it (a synchronize). It is timed from the
call to the synchronize's return. The outputs stay on the device.

Inputs, all from the run's generator on the device: a ring of `ring`
examples (request i takes example i mod ring), each a high-res ODS pair in
[0, 1] and low-res blend weights and alphas [1, h, w, P] in (0, 1) as the
net's heads give them, sigmoid(2 z) with z ~ N(0, 1); and `poses` target
positions uniform in the ball of radius `max_offset_m` (request i takes
position i mod poses). The re-render looks straight ahead, as the CLI's does.
"""

from __future__ import annotations

import random
import time

import torch

from matryodshka_tpu_torch.cli import test as cli_test
from matryodshka_tpu_torch.geometry import render as render_lib
from matryodshka_tpu_torch.ops import sweep as sweep_ops
from msi_bench import reference, stats
from msi_bench.inputs import targets
from msi_bench.reference.geometry import inv_depths


class Driver:
    request_stages = ("sweep_assembled", "render_layers")
    span_targets = ((sweep_ops, "sweep_assembled"),
                    (render_lib, "render_equirect_view_prepared_both"))

    def __init__(self, ctx):
        t, cfg, dev, gen = ctx.traffic, ctx.cfg, ctx.device, ctx.gen
        self.ctx, self.cfg = ctx, cfg
        self.render = cli_test.build_hres_render_fn(cfg)
        n, p = t["ring"], cfg.num_psv_planes
        hshape = (n, 1, cfg.hres_height, cfg.hres_width, 3)
        lshape = (n, 1, cfg.height, cfg.width, p)
        self.ref = torch.rand(hshape, generator=gen, device=dev)
        self.src = torch.rand(hshape, generator=gen, device=dev)
        self.blend = torch.sigmoid(2 * torch.randn(lshape, generator=gen,
                                                   device=dev))
        self.alphas = torch.sigmoid(2 * torch.randn(lshape, generator=gen,
                                                    device=dev))
        _, self.pos = targets(gen, t["poses"], t["max_offset_m"], dev)
        self.radius = ctx.config["rig_radius_m"]
        self.intr = torch.eye(3, device=dev)[None].contiguous()
        self.intr[0, 0, 0] = self.radius
        self.depths = torch.tensor(inv_depths(cfg.min_depth, cfg.max_depth,
                                              p), device=dev)
        self.rng = random.Random(ctx.seed)
        self._stages = None
        self._loop(count=t["warmup"])

    def _request(self, i):
        k, j = i % self.ref.shape[0], i % self.pos.shape[0]
        return self.render(self.ref[k], self.src[k], self.blend[k],
                           self.alphas[k], None, None, None, self.intr,
                           self.pos[j:j + 1])

    def _loop(self, seconds=None, count=None, sample_size=0):
        lat, sample = [], []
        start = time.perf_counter()
        stop = None if seconds is None else start + seconds
        i, t1 = 0, start
        while True:
            t0 = time.perf_counter()
            if (stop is not None and t0 >= stop) or i == count:
                break
            out = self._request(i)
            self.ctx.sync()
            t1 = time.perf_counter()
            lat.append(t1 - t0)
            if len(sample) < sample_size:
                sample.append((i, out))
            elif sample_size:
                slot = self.rng.randrange(i + 1)
                if slot < sample_size:
                    sample[slot] = (i, out)
            i += 1
        return {"requests": i, "window_s": t1 - start, "latencies_s": lat,
                "submit_s": [], "sample": sample}

    def window(self, seconds):
        return self._loop(seconds=seconds,
                          sample_size=self.ctx.traffic["sample"])

    def traffic(self, n):
        return self._loop(count=n)["window_s"]

    def e2e(self, win):
        return {"hres_ms_p95": lambda: stats.percentile(
            win["latencies_s"], 95) * 1e3}

    @property
    def stage_io(self):
        self.stages()
        return self._io

    def stages(self):
        """The request's two kernels on request 0's inputs, as the render
        calls them: the sweep's assembled mode, then the layer-stack
        render of colour and depth."""
        if self._stages is None:
            cfg = self.cfg
            rule = cli_test.HRES_ASSEMBLY[cfg.which_color_pred]
            args = (self.ref[0], self.src[0], self.depths, self.intr,
                    self.alphas[0], self.blend[0])
            eye = torch.eye(4, device=self.ctx.device)[None]
            pos = self.pos[0:1]

            def assemble():
                return sweep_ops.sweep_assembled(
                    *args, None, rule=rule, p0=0,
                    out_dtype=cfg.torch_compute_dtype)

            stack = assemble()
            self._io = {"args": args, "stack": stack, "pos": pos}
            self._stages = {
                "sweep_assembled": assemble,
                "render_layers": lambda: (
                    render_lib.render_equirect_view_prepared_both(
                        stack, eye, pos, self.depths))}
        return self._stages

    def free(self):
        self.render = self._stages = self._io = None
        if self.ctx.device.type == "cuda":
            torch.cuda.empty_cache()

    def check(self, sample, q=None):
        """Each sampled re-render against the reference's: the widest and
        the mean absolute gap of the colour ([0, 1]) and of the depth proxy
        ([0, 1)), worst over the sample. With q the reference computed
        through q stands in for the program."""
        worst = dict.fromkeys(("rgb_max_abs", "rgb_mean_abs",
                               "depth_max_abs", "depth_mean_abs"), 0.0)
        for i, (rgb, depth) in sample:
            k, j = i % self.ref.shape[0], i % self.pos.shape[0]
            args = (self.ref[k][0], self.src[k][0], self.blend[k][0],
                    self.alphas[k][0], self.depths, self.radius, self.pos[j])
            want = reference.hres_render(*args)
            got = ((rgb[0], depth[0]) if q is None
                   else reference.hres_render(*args, q=q))
            for name, g, w in (("rgb", got[0], want[0]),
                               ("depth", got[1], want[1])):
                gap = (g.float() - w).abs()
                worst[f"{name}_max_abs"] = max(worst[f"{name}_max_abs"],
                                               gap.max().item())
                worst[f"{name}_mean_abs"] = max(worst[f"{name}_mean_abs"],
                                                gap.mean().item())
        return worst
