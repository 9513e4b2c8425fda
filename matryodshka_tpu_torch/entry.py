"""The flagship forward: single-frame ODS inference at 640x320, 32 planes.

Counterpart of `__graft_entry__.py` (`_flagship_cfg`, `_synthetic_batch`,
`entry`). `forward(params, batch)` runs the hot path -- sweep kernel, U-Net
through the conv and layer-norm kernels, blend-fused render kernel;
`forward_plain(params, batch)` the same path with each kernel's plain
version in float32; `forward_reference(params, batch)` the
reference-semantics path (general-pose gather sweep, plain MSIUNet,
assembled layers, gather render) in float32. The ref and src poses of an
ODS batch are identity (the ODS loaders fix them so), which the sweep
kernel relies on; the target pose and position are free.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List

import numpy as np
import torch

from matryodshka_tpu_torch import weights
from matryodshka_tpu_torch.config import MatryConfig
from matryodshka_tpu_torch.geometry import render as render_lib
from matryodshka_tpu_torch.geometry import sweep as sweep_lib
from matryodshka_tpu_torch.models import msi as msi_lib
from matryodshka_tpu_torch.models.unet import MSIUNet
from matryodshka_tpu_torch.ops import net as net_ops
from matryodshka_tpu_torch.ops import render as render_ops
from matryodshka_tpu_torch.ops import sweep as sweep_ops


def flagship_cfg(**kw) -> MatryConfig:
    base = dict(height=320, width=640, num_psv_planes=32, num_msi_planes=32,
                ngf=64, batch_size=1, compute_dtype="bfloat16")
    base.update(kw)
    return MatryConfig(**base).validate()


def synthetic_batch(cfg: MatryConfig, seed: int = 0, device="cpu",
                    tgt_pos=(0.05, 0.0, 0.0)) -> Dict[str, torch.Tensor]:
    """Random ODS pair + target, drawn from np.random.RandomState(seed) in
    the same order as the JAX package's synthetic batch (ref, src, tgt
    images), so one seed gives both packages the same images."""
    rng = np.random.RandomState(seed)
    b, h, w = cfg.batch_size, cfg.height, cfg.width
    eye = torch.eye(4, device=device).expand(b, 4, 4).contiguous()
    intr = np.tile(np.eye(3, dtype=np.float32)[None], (b, 1, 1))
    intr[:, 0, 0] = 0.032

    def img():
        return torch.from_numpy(
            rng.rand(b, h, w, 3).astype(np.float32)).to(device)

    return {
        "ref_image": img(), "src_image": img(), "tgt_image": img(),
        "ref_pose": eye, "src_pose": eye, "ref_pose_inv": eye,
        "tgt_pose": torch.tensor([tgt_pos], dtype=torch.float32,
                                 device=device).expand(b, 3).contiguous(),
        "intrinsics": torch.from_numpy(intr).to(device),
    }


@dataclass
class Params:
    """What a forward needs besides the batch."""
    cfg: MatryConfig
    net: MSIUNet
    stages: List[Dict]           # kernel operands (ops.net.prepare)
    psv_depths: torch.Tensor
    msi_depths: torch.Tensor


def make_params(cfg: MatryConfig, flax_params=None, seed: int = 0,
                device="cpu") -> Params:
    """Net from a flax parameter tree (numpy leaves), or from
    weights.seeded_init(cfg, seed) when none is given."""
    tree = weights.seeded_init(cfg, seed) if flax_params is None \
        else flax_params
    net = MSIUNet(cfg.num_net_inputs(), cfg.num_net_outputs(), cfg.ngf,
                  dtype=cfg.torch_compute_dtype)
    net.load_state_dict(weights.from_flax(tree))
    net = net.to(device).eval()

    def depths(n):
        return torch.tensor(sweep_lib.inv_depths(cfg.min_depth,
                                                 cfg.max_depth, n),
                            dtype=torch.float32, device=device)

    return Params(cfg, net, net_ops.prepare(net, cfg.torch_compute_dtype),
                  depths(cfg.num_psv_planes), depths(cfg.num_msi_planes))


def _identity_rt(batch):
    b = batch["tgt_pose"].shape[0]
    return torch.eye(4, device=batch["tgt_pose"].device).expand(b, 4, 4)


@torch.no_grad()
def forward(params: Params, batch, tgt_pose_rt=None) -> torch.Tensor:
    """Hot path -> rendered view [B, H, W, 3] float32 (values in [-1, 1]).
    tgt_pose_rt [B, 4, 4] rotates the target view (identity by default);
    batch['tgt_pose'] [B, 3] is the target position."""
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
