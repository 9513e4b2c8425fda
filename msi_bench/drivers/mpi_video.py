"""Closed-loop stereo-magnification playback: one server turns each viewer's
stereo frames of a walk-through clip into an MPI and renders that viewer's
next head pose, the next frame of `viewers` viewers in one call, with a
fixed number of calls in flight.

The loop, the clocks, the sample and the end-to-end metrics are
`drivers/video.py`'s; each call is `entry.forward` on the viewers' pairs,
poses and intrinsics as one PP/RealEstate batch (no target rotation
argument: the rotation is in tgt_pose). The views stay on the device.

Inputs, all from the run's generator on the device: a ring of `ring`
distinct stereo pairs in [0, 1], the ref camera at identity and the src
camera translated along -x by a baseline uniform in `baseline_m`; every
camera has the fixture's intrinsics (fx = 0.9 W, fy = 1.2 H, the principal
point at the centre); and `poses` targets, each a world-to-camera pose
[R | t] with t uniform in the ball of radius `max_offset_m` about the ref
camera and R a yaw about y then a pitch about x, each uniform in
+-`max_angle_deg`. Frame n takes pair n mod ring and target n mod poses.
"""

from __future__ import annotations

import math
import random
from pathlib import Path

import torch

from matryodshka_tpu_torch import entry
from matryodshka_tpu_torch.models import msi as msi_lib
from matryodshka_tpu_torch.ops import conv as conv_ops
from msi_bench import harness, seeding
from msi_bench.reference.geometry import inv_depths
from msi_bench.reference.mpi import mpi_view

video = harness.load_module(Path(__file__).resolve().parent.parent,
                            "drivers", "video")


def intrinsics(h: int, w: int, device):
    return torch.tensor([[0.9 * w, 0.0, 0.5 * w], [0.0, 1.2 * h, 0.5 * h],
                         [0.0, 0.0, 1.0]], device=device)


def target_poses(gen, n: int, radius: float, max_deg: float, device):
    """n seeded world-to-camera poses [n, 4, 4]: t uniform in the ball of
    radius about the origin, R = yaw (about y) @ pitch (about x), each
    uniform in +-max_deg."""
    d = torch.randn((n, 3), generator=gen, device=device)
    d = d / d.norm(dim=1, keepdim=True).clamp(min=1e-12)
    r = radius * torch.rand((n, 1), generator=gen, device=device) ** (1 / 3)
    yaw, pitch = ((torch.rand((2, n), generator=gen, device=device) * 2 - 1)
                  * math.radians(max_deg))
    cy, sy, cp, sp = yaw.cos(), yaw.sin(), pitch.cos(), pitch.sin()
    zero, one = torch.zeros_like(cy), torch.ones_like(cy)
    ry = torch.stack([cy, zero, sy, zero, one, zero, -sy, zero, cy],
                     -1).reshape(n, 3, 3)
    rx = torch.stack([one, zero, zero, zero, cp, -sp, zero, sp, cp],
                     -1).reshape(n, 3, 3)
    pose = torch.eye(4, device=device).repeat(n, 1, 1)
    pose[:, :3, :3] = ry @ rx
    pose[:, :3, 3] = d * r
    return pose


class Driver(video.Driver):
    request_stages = ("mpi_sweep", "net", "mpi_render")
    span_targets = ((msi_lib, "sweep_stage"), (msi_lib, "net_stage"),
                    (msi_lib, "mpi_render_stage"), (conv_ops, "conv"))

    def __init__(self, ctx):
        if not hasattr(msi_lib, "mpi_render_stage"):
            raise RuntimeError("mpi_video: the program's served path has no "
                               "planar route (msi.mpi_render_stage)")
        t, cfg, dev, gen = ctx.traffic, ctx.cfg, ctx.device, ctx.gen
        self.ctx, self.cfg = ctx, cfg
        self.params = entry.make_params(
            cfg, flax_params=seeding.to_numpy(ctx.tree), device=dev)
        self.viewers = v = t["viewers"]
        if t["ring"] % v or t["poses"] % v:
            raise ValueError("ring and poses must be multiples of viewers")
        n = t["ring"]
        shape = (n, cfg.height, cfg.width, 3)
        self.ref = torch.rand(shape, generator=gen, device=dev)
        self.src = torch.rand(shape, generator=gen, device=dev)
        lo, hi = t["baseline_m"]
        self.src_pose = torch.eye(4, device=dev).repeat(n, 1, 1)
        self.src_pose[:, 0, 3] = -(lo + (hi - lo) * torch.rand(
            (n,), generator=gen, device=dev))
        self.tgt_pose = target_poses(gen, t["poses"], t["max_offset_m"],
                                     t["max_angle_deg"], dev)
        self.eye = torch.eye(4, device=dev).repeat(v, 1, 1)
        self.intr = intrinsics(cfg.height, cfg.width, dev).repeat(v, 1, 1)
        # video.Driver's completion events, sampler and warm-up
        self.in_flight = t["in_flight"]
        self.events = ([torch.cuda.Event(blocking=True)
                        for _ in range(self.in_flight + 2)]
                       if dev.type == "cuda" else [video._HostEvent()])
        self.rng = random.Random(ctx.seed)
        self._stages = None
        self._loop(count=t["warmup"])

    def _call(self, i):
        n, v = i * self.viewers, self.viewers
        k, j = n % self.ref.shape[0], n % self.tgt_pose.shape[0]
        batch = {"ref_image": self.ref[k:k + v],
                 "src_image": self.src[k:k + v], "ref_pose": self.eye,
                 "ref_pose_inv": self.eye, "src_pose": self.src_pose[k:k + v],
                 "tgt_pose": self.tgt_pose[j:j + v], "intrinsics": self.intr}
        return batch, None

    def stages(self):
        """The request's three stages on call 0's inputs."""
        if self._stages is None:
            cfg, prm = self.cfg, self.params
            batch, _ = self._call(0)
            vol = msi_lib.sweep_stage(cfg, batch, prm.psv_depths)
            pred = msi_lib.net_stage(prm.stages, vol)
            self._io = {"batch": batch, "vol": vol, "pred": pred,
                        "msi_depths": prm.msi_depths}
            self._stages = {
                "mpi_sweep": lambda: msi_lib.sweep_stage(cfg, batch,
                                                         prm.psv_depths),
                "net": lambda: msi_lib.net_stage(prm.stages, vol),
                "mpi_render": lambda: msi_lib.mpi_render_stage(
                    cfg, vol, pred, batch, prm.msi_depths)}
        return self._stages

    def check(self, sample, q=None):
        """Each sampled view against the reference's (reference/mpi.py):
        the widest and the mean absolute gap (values in [-1, 1]), worst
        over the sample. With q the reference computed through q stands in
        for the program."""
        cfg, dev = self.cfg, self.ctx.device
        psv = torch.tensor(inv_depths(cfg.min_depth, cfg.max_depth,
                                      cfg.num_psv_planes), device=dev)
        msi = torch.tensor(inv_depths(cfg.min_depth, cfg.max_depth,
                                      cfg.num_msi_planes), device=dev)
        k_mat = intrinsics(cfg.height, cfg.width, dev)
        eye = torch.eye(4, device=dev)
        widest = mean = 0.0
        for n, out in sample:
            k, j = n % self.ref.shape[0], n % self.tgt_pose.shape[0]
            args = (self.ctx.tree, cfg.ngf, self.ref[k], self.src[k], eye,
                    self.src_pose[k], self.tgt_pose[j], k_mat, psv, msi)
            want = mpi_view(*args)
            got = out if q is None else mpi_view(*args, q=q)
            gap = (got.float() - want).abs()
            widest = max(widest, gap.max().item())
            mean = max(mean, gap.mean().item())
        return {"view_max_abs": widest, "view_mean_abs": mean}
