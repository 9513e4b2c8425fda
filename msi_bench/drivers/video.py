"""Closed-loop 6DoF video serving: one server renders the next frame of
`viewers` viewers in one call, with a fixed number of calls in flight.

The server submits call i+1 while the card runs call i: it takes a slot
(one of `in_flight`), starts the clock, calls the port's `entry.forward`
on the viewers' ODS pairs and targets as one batch, records a CUDA event
and hands it to a waiter thread, which blocks on the event, stops the clock
and frees the slot. So each frame of a call is timed from the start of the
call's submission to the moment its completion is seen on the host, and the
server is never held up by the wait. The views stay on the device.

Inputs, all from the run's generator on the device: a ring of `ring`
distinct ODS pairs and `poses` targets, each a position uniform in the ball
of radius `max_offset_m` about the rig centre and a yaw uniform in
[-pi, pi). Frame n (call n // viewers, viewer n % viewers) takes pair
n mod ring and target n mod poses; both counts are multiples of `viewers`,
so a call's inputs are contiguous slices.
"""

from __future__ import annotations

import queue
import random
import threading
import time

import torch

from matryodshka_tpu_torch import entry
from matryodshka_tpu_torch.models import msi as msi_lib
from matryodshka_tpu_torch.ops import conv as conv_ops
from msi_bench import reference, seeding, stats
from msi_bench.inputs import targets
from msi_bench.reference.geometry import inv_depths


class _HostEvent:
    """On the CPU a call has finished when it returns."""

    def record(self):
        pass

    def synchronize(self):
        pass


class Driver:
    request_stages = ("sweep", "net", "render")
    span_targets = ((msi_lib, "sweep_stage"), (msi_lib, "net_stage"),
                    (msi_lib, "render_stage"), (conv_ops, "conv"))

    def __init__(self, ctx):
        t, cfg, dev, gen = ctx.traffic, ctx.cfg, ctx.device, ctx.gen
        self.ctx, self.cfg = ctx, cfg
        self.params = entry.make_params(
            cfg, flax_params=seeding.to_numpy(ctx.tree), device=dev)
        self.viewers = v = t["viewers"]
        if t["ring"] % v or t["poses"] % v:
            raise ValueError("ring and poses must be multiples of viewers")
        shape = (t["ring"], cfg.height, cfg.width, 3)
        self.ref = torch.rand(shape, generator=gen, device=dev)
        self.src = torch.rand(shape, generator=gen, device=dev)
        self.rot, self.pos = targets(gen, t["poses"], t["max_offset_m"], dev)
        self.radius = ctx.config["rig_radius_m"]
        self.intr = torch.eye(3, device=dev).repeat(v, 1, 1)
        self.intr[:, 0, 0] = self.radius
        self.in_flight = t["in_flight"]
        # Blocking events: the waiter sleeps until the call is done. A
        # spinning wait (CUDA's default with few contexts) takes the CPU
        # from the server whenever the two share a core.
        self.events = ([torch.cuda.Event(blocking=True)
                        for _ in range(self.in_flight + 2)]
                       if dev.type == "cuda" else [_HostEvent()])
        self.rng = random.Random(ctx.seed)
        self._stages = None
        self._loop(count=t["warmup"])

    def _call(self, i):
        n, v = i * self.viewers, self.viewers
        k, j = n % self.ref.shape[0], n % self.pos.shape[0]
        batch = {"ref_image": self.ref[k:k + v], "src_image": self.src[k:k + v],
                 "intrinsics": self.intr, "tgt_pose": self.pos[j:j + v]}
        return batch, self.rot[j:j + v]

    def _loop(self, seconds=None, count=None, sample_size=0):
        lat, sub, ends, sample = [], [], [], []
        slots = threading.Semaphore(self.in_flight)
        done = queue.SimpleQueue()

        def waiter():
            while True:
                item = done.get()
                if item is None:
                    return
                t0, ev = item
                ev.synchronize()
                ends.append(time.perf_counter())
                lat.extend([ends[-1] - t0] * self.viewers)
                slots.release()

        th = threading.Thread(target=waiter, name="msi_bench-waiter")
        th.start()
        start = time.perf_counter()
        stop = None if seconds is None else start + seconds
        i = 0
        try:
            while True:
                slots.acquire()
                t0 = time.perf_counter()
                if (stop is not None and t0 >= stop) or i == count:
                    break
                batch, rot = self._call(i)
                out = entry.forward(self.params, batch, rot)
                sub.append(time.perf_counter() - t0)
                ev = self.events[i % len(self.events)]
                ev.record()
                done.put((t0, ev))
                for v in range(self.viewers if sample_size else 0):
                    n = i * self.viewers + v
                    if len(sample) < sample_size:
                        sample.append((n, out[v]))
                    else:
                        slot = self.rng.randrange(n + 1)
                        if slot < sample_size:
                            sample[slot] = (n, out[v])
                i += 1
        finally:
            done.put(None)
            th.join()
        return {"requests": i, "answers": i * self.viewers,
                "window_s": (ends[-1] if ends else start) - start,
                "latencies_s": lat, "submit_s": sub, "sample": sample}

    def window(self, seconds):
        return self._loop(seconds=seconds,
                          sample_size=self.ctx.traffic["sample"])

    def traffic(self, n):
        return self._loop(count=n)["window_s"]

    def e2e(self, win):
        """frames_per_s: every frame completed over the whole window;
        frame_ms_p95: the nearest-rank 95th percentile over all of them."""
        return {"frames_per_s": lambda: win["answers"] / win["window_s"],
                "frame_ms_p95": lambda: stats.percentile(
                    win["latencies_s"], 95) * 1e3}

    @property
    def stage_io(self):
        self.stages()
        return self._io

    def stages(self):
        """The request's three stages on call 0's inputs."""
        if self._stages is None:
            cfg, prm = self.cfg, self.params
            batch, rot = self._call(0)
            vol = msi_lib.sweep_stage(cfg, batch, prm.psv_depths)
            pred = msi_lib.net_stage(prm.stages, vol)
            pos = batch["tgt_pose"]
            self._io = {"batch": batch, "rot": rot, "pos": pos, "vol": vol,
                        "pred": pred, "msi_depths": prm.msi_depths}
            self._stages = {
                "sweep": lambda: msi_lib.sweep_stage(cfg, batch,
                                                     prm.psv_depths),
                "net": lambda: msi_lib.net_stage(prm.stages, vol),
                "render": lambda: msi_lib.render_stage(
                    vol, pred, rot, pos, prm.msi_depths)}
        return self._stages

    def free(self):
        self.params = self._stages = self._io = None
        if self.ctx.device.type == "cuda":
            torch.cuda.empty_cache()

    def check(self, sample, q=None):
        """Each sampled view against the reference's: the widest and the
        mean absolute gap (values in [-1, 1]), worst over the sample. With
        q the reference computed through q stands in for the program."""
        cfg, dev = self.cfg, self.ctx.device
        psv = torch.tensor(inv_depths(cfg.min_depth, cfg.max_depth,
                                      cfg.num_psv_planes), device=dev)
        msi = torch.tensor(inv_depths(cfg.min_depth, cfg.max_depth,
                                      cfg.num_msi_planes), device=dev)
        widest = mean = 0.0
        for n, out in sample:
            k, j = n % self.ref.shape[0], n % self.pos.shape[0]
            args = (self.ctx.tree, cfg.net_variant, cfg.ngf, self.ref[k],
                    self.src[k], psv, msi, self.radius, self.rot[j],
                    self.pos[j])
            want = reference.video_view(*args)
            got = out if q is None else reference.video_view(*args, q=q)
            gap = (got.float() - want).abs()
            widest = max(widest, gap.max().item())
            mean = max(mean, gap.mean().item())
        return {"view_max_abs": widest, "view_mean_abs": mean}
