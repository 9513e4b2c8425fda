"""The flagship forward: single-frame ODS inference at 640x320, 32 planes.

Counterpart of `__graft_entry__.py` (`_flagship_cfg`, `_synthetic_batch`,
`entry`). `forward(params, batch)` runs the hot path -- sweep kernel, U-Net
(the wrap net, or the coord net with `coord_net=True`) through the conv
kernel (its layer norms fused), blend-fused render kernel; for PP and
REALESTATE_PP input the planar route (gather sweep, the same net, MPI
render), the test CLI's;
`forward_plain(params, batch)` the same path with each kernel's plain
version in float32; `forward_reference(params, batch)` the
reference-semantics path (general-pose gather sweep, plain MSIUNet,
assembled layers, gather render) in float32. The ref and src poses of an
ODS batch are identity (the ODS loaders fix them so), which the sweep
kernel relies on; the target pose and position are free.
`dryrun_multichip(n)` runs one data-parallel train step over n ranks.
"""

from __future__ import annotations

import os
import tempfile
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from matryodshka_tpu_torch import trace, weights
from matryodshka_tpu_torch.config import MatryConfig
from matryodshka_tpu_torch.geometry.cameras import interpolate_pose
from matryodshka_tpu_torch.geometry import render as render_lib
from matryodshka_tpu_torch.geometry import sweep as sweep_lib
from matryodshka_tpu_torch.models import msi as msi_lib
from matryodshka_tpu_torch.models.unet import MSIUNet
from matryodshka_tpu_torch.ops import net as net_ops
from matryodshka_tpu_torch.ops import render as render_ops
from matryodshka_tpu_torch.ops import sweep as sweep_ops
from matryodshka_tpu_torch.parallel import dp
from matryodshka_tpu_torch.parallel.mesh import rank_device, run_ranks
from matryodshka_tpu_torch.training.state import build_gcn, init_state


def flagship_cfg(**kw) -> MatryConfig:
    base = dict(height=320, width=640, num_psv_planes=32, num_msi_planes=32,
                ngf=64, batch_size=1, compute_dtype="bfloat16")
    base.update(kw)
    return MatryConfig(**base).validate()


def synthetic_batch(cfg: MatryConfig, seed: int = 0, device="cuda",
                    tgt_pos=(0.05, 0.0, 0.0)) -> Dict[str, torch.Tensor]:
    """Random ODS pair + target, drawn from np.random.RandomState(seed) in
    the same order as the JAX package's synthetic batch (ref, src, tgt
    images), so one seed gives both packages the same images; on device
    (the card unless the caller asks for the CPU). For PP and
    REALESTATE_PP input the same images with a batch of that type's poses
    (mpi_poses) in place of the ODS ones."""
    rng = np.random.RandomState(seed)
    b, h, w = cfg.batch_size, cfg.height, cfg.width
    eye = torch.eye(4, device=device).expand(b, 4, 4).contiguous()
    intr = np.tile(np.eye(3, dtype=np.float32)[None], (b, 1, 1))
    intr[:, 0, 0] = 0.032

    def img():
        return torch.from_numpy(
            rng.rand(b, h, w, 3).astype(np.float32)).to(device)

    images = {"ref_image": img(), "src_image": img(), "tgt_image": img()}
    if cfg.input_type != "ODS":
        return {**images, **{k: torch.from_numpy(v).to(device) for k, v in
                             mpi_poses(cfg).items()}}
    return {
        **images, "ref_pose": eye, "src_pose": eye, "ref_pose_inv": eye,
        "tgt_pose": torch.tensor([tgt_pos], dtype=torch.float32,
                                 device=device).expand(b, 3).contiguous(),
        "intrinsics": torch.from_numpy(intr).to(device),
    }


def mpi_poses(cfg: MatryConfig) -> Dict[str, np.ndarray]:
    """The pose fields of a PP or RealEstate batch as the loaders give them
    (numpy, batch cfg.batch_size): PP the synthetic fixture's line (src
    0.1 m and tgt 0.05 m to the left of ref, the reference frame their
    slerp midpoint, K with fx = cx = W/2, fy = cy = H/2); RealEstate a
    clip's frames 0, 3 and 2 of the synthetic fixture (0.02 m a frame
    along x) with its normalized intrinsics (0.9, 1.2, 0.5, 0.5) and the
    reference frame ref_pose."""
    b, h, w = cfg.batch_size, cfg.height, cfg.width

    def poses(*xs):
        out = []
        for x in xs:
            p = np.tile(np.eye(4, dtype=np.float32)[None], (b, 1, 1))
            p[:, 0, 3] = x
            out.append(p)
        return out

    if cfg.input_type == "PP":
        ref, src, tgt = poses(0.0, -0.1, -0.05)
        k = np.asarray([[w / 2, 0, w / 2], [0, h / 2, h / 2], [0, 0, 1]],
                       np.float32)
        interp = interpolate_pose(torch.from_numpy(ref[0]),
                                  torch.from_numpy(src[0])).numpy()
        ref_inv = np.tile(np.linalg.inv(interp)[None], (b, 1, 1))
    else:
        ref, src, tgt = poses(0.0, -0.06, -0.04)
        k = np.asarray([[0.9 * w, 0, 0.5 * w], [0, 1.2 * h, 0.5 * h],
                        [0, 0, 1]], np.float32)
        ref_inv = np.linalg.inv(ref)
    return {"ref_pose": ref, "src_pose": src, "tgt_pose": tgt,
            "ref_pose_inv": ref_inv,
            "intrinsics": np.tile(k[None], (b, 1, 1))}


@dataclass
class Params:
    """What a forward needs besides the batch."""
    cfg: MatryConfig
    #: the U-Net, or the GCN (cfg.gcn)
    net: torch.nn.Module
    stages: List[Dict]           # kernel operands (ops.net.prepare)
    psv_depths: torch.Tensor
    msi_depths: torch.Tensor
    #: the GCN's mesh (coords [V, 3], p2v [W, H, 3, 2]) with cfg.gcn
    gcn_inputs: Optional[Tuple[torch.Tensor, torch.Tensor]] = None


@trace.setup_span("entry.make_params")
def make_params(cfg: MatryConfig, flax_params=None, seed: int = 0,
                device="cuda") -> Params:
    """Net of cfg's variant (cfg.coord_net, cfg.smoothed; the GCN and its
    mesh with cfg.gcn, which has no kernel stages) from a flax parameter
    tree (numpy leaves), or from weights.seeded_init(cfg, seed) when none
    is given, on device (the card unless the caller asks for the CPU).
    Its parts are setup spans: weights.seeded_init, weights.from_flax,
    unet.MSIUNet (the module built, loaded and moved), net.prepare."""
    if flax_params is None:
        with trace.setup_span("weights.seeded_init"):
            tree = weights.seeded_init(cfg, seed)
    else:
        tree = flax_params

    def depths(n):
        return torch.tensor(sweep_lib.inv_depths(cfg.min_depth,
                                                 cfg.max_depth, n),
                            dtype=torch.float32, device=device)

    if cfg.gcn:
        net, coords, p2v = build_gcn(cfg, device)
        net.load_state_dict(weights.gcn_from_flax(tree))
        return Params(cfg, net.eval(), [], depths(cfg.num_psv_planes),
                      depths(cfg.num_msi_planes), (coords, p2v))
    with trace.setup_span("weights.from_flax"):
        state = weights.from_flax(tree)
    with trace.setup_span("unet.MSIUNet"):
        net = MSIUNet(cfg.num_net_inputs(), cfg.num_net_outputs(), cfg.ngf,
                      dtype=cfg.torch_compute_dtype, variant=cfg.net_variant,
                      smoothed=cfg.smoothed)
        net.load_state_dict(state)
        net = net.to(device).eval()
    with trace.setup_span("net.prepare"):
        stages = net_ops.prepare(net, cfg.torch_compute_dtype, cfg.height)
    return Params(cfg, net, stages, depths(cfg.num_psv_planes),
                  depths(cfg.num_msi_planes))


def _identity_rt(batch):
    b = batch["tgt_pose"].shape[0]
    return torch.eye(4, device=batch["tgt_pose"].device).expand(b, 4, 4)


@torch.no_grad()
def forward(params: Params, batch, tgt_pose_rt=None) -> torch.Tensor:
    """Hot path -> rendered view [B, H, W, 3] float32 (values in [-1, 1]).
    ODS input: tgt_pose_rt [B, 4, 4] rotates the target view (identity by
    default); batch['tgt_pose'] [B, 3] is the target position. PP and
    REALESTATE_PP input: the planar route (msi.infer_mpi: the gather
    sweep, the net, the assembly and the MPI render at
    msi.mpi_view_pose(batch)); the batch carries ref_pose, src_pose,
    tgt_pose, ref_pose_inv [B, 4, 4] and intrinsics [B, 3, 3], as
    mpi_poses and the loaders give them, and tgt_pose_rt is refused (the
    target's rotation is in tgt_pose)."""
    with trace.span("entry.forward"):
        cfg = params.cfg
        if cfg.input_type != "ODS":
            if tgt_pose_rt is not None:
                raise ValueError(f"forward: tgt_pose_rt with input_type "
                                 f"{cfg.input_type}; the target's rotation "
                                 f"is in batch['tgt_pose']")
            return msi_lib.infer_mpi(cfg, params.stages, batch,
                                     params.psv_depths,
                                     params.msi_depths)["output_image"]
        rt = _identity_rt(batch) if tgt_pose_rt is None else tgt_pose_rt
        vol = msi_lib.sweep_stage(params.cfg, batch, params.psv_depths)
        pred = msi_lib.net_stage(params.stages, vol)
        return msi_lib.render_stage(vol, pred, rt, batch["tgt_pose"],
                                    params.msi_depths)


@torch.no_grad()
def forward_plain(params: Params, batch, tgt_pose_rt=None) -> torch.Tensor:
    """The hot path with every kernel replaced by its plain version, in
    float32: ods_sweep_plain, the plain MSIUNet, render_blend_plain."""
    rt = _identity_rt(batch) if tgt_pose_rt is None else tgt_pose_rt
    images, rowp = sweep_ops.sweep_inputs(
        msi_lib.preprocess_image(batch["ref_image"]),
        msi_lib.preprocess_image(batch["src_image"]), params.psv_depths,
        batch["intrinsics"])
    vol = sweep_ops.ods_sweep_plain(images, rowp, torch.float32)
    pred = params.net(vol, dtype=torch.float32)
    u, v = render_lib.uv_tables(rt, batch["tgt_pose"], params.msi_depths,
                                params.cfg.height, params.cfg.width)
    return render_ops.render_blend_plain(vol, pred, u, v)


@torch.no_grad()
def forward_reference(params: Params, batch, tgt_pose_rt=None):
    """The reference-semantics path in float32 (the JAX package's
    e2e_reference): general-pose gather sweep, plain MSIUNet, assembled
    [B, H, W, P, 4] layers, gather render."""
    rt = _identity_rt(batch) if tgt_pose_rt is None else tgt_pose_rt
    outs = msi_lib.infer_msi(params.net, params.cfg, batch,
                             params.psv_depths, dtype=torch.float32)
    return msi_lib.render_equirect_view(outs["rgba_layers"].float(), rt,
                                        batch["tgt_pose"], params.msi_depths)


def entry(device="cuda", seed: int = 0):
    """(forward, (params, batch)) for the flagship configuration with
    seeded random weights."""
    cfg = flagship_cfg()
    return forward, (make_params(cfg, seed=seed, device=device),
                     synthetic_batch(cfg, seed, device))


def dryrun_multichip(n: int) -> None:
    """The port's counterpart of __graft_entry__.dryrun_multichip: one
    full data-parallel train step (parallel/dp.py) over n ranks on tiny
    shapes, with the transform-inverse regularizer, tgt_src_ref
    supervision and the weight regularizer; each rank asserts a finite
    loss and step 1. n NCCL ranks, one a card, where n cards exist, else
    n gloo ranks on the CPU."""
    device_type = "cuda" if torch.cuda.device_count() >= n else "cpu"
    with tempfile.TemporaryDirectory() as d:
        run_ranks(_dryrun_rank, n, os.path.join(d, "store"), device_type,
                  args=(device_type,))


def _dryrun_rank(rank: int, world: int, device_type: str) -> None:
    device = rank_device(device_type, rank)
    cfg = flagship_cfg(height=32, width=64, num_psv_planes=4,
                       num_msi_planes=4, ngf=8, batch_size=max(world, 2),
                       compute_dtype="float32", transform_inverse_reg=True,
                       supervision="tgt_src_ref", wreg=True,
                       num_data_shards=world)
    state = init_state(cfg, 0, device)
    step = dp.make_dp_train_step(cfg, state.net)
    batch = dp.shard_batch(synthetic_batch(cfg, 0, device), rank, world)
    state, metrics = step(state, batch)
    loss = float(metrics["total_loss"])
    assert np.isfinite(loss), loss
    assert state.step == 1, state.step
    print(f"[dryrun_multichip] rank {rank} of {world} ({device}): loss "
          f"{loss:.6f}, step {state.step}")
