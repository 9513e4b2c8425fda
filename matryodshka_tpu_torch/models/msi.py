"""MSI inference and rendering: the plain reference path and the fused hot
path.

Counterpart of `matryodshka_tpu/models/msi.py`. The reference path
(`infer_msi` + `render_equirect_view`) sweeps by gather, runs the plain
MSIUNet and assembles [B, H, W, P, 4] layers, in the JAX layouts. The hot
path (`sweep_stage` -> `net_stage` -> `render_stage`) replaces
`infer_msi_prepared`, `assemble_outputs_planar` and
`render_equirect_view_from_prepared`: the sweep kernel writes the net input
channels first, the net runs through the conv and layer-norm kernels, and
the render kernel blends, samples and composites straight from the sweep
volume and the prediction -- no layer stack is ever written.
"""

from __future__ import annotations

from typing import Dict

import torch

from matryodshka_tpu_torch.geometry import render as render_lib
from matryodshka_tpu_torch.geometry import sweep as sweep_lib
from matryodshka_tpu_torch.ops import net as net_ops
from matryodshka_tpu_torch.ops import sweep as sweep_ops


def preprocess_image(image):
    """[0, 1] -> [-1, 1]."""
    return image * 2.0 - 1.0


def assemble_rgba(which_color_pred: str, msi_pred, net_input,
                  num_planes: int) -> Dict[str, torch.Tensor]:
    """blend_psv: msi_pred [B, H, W, 2P] + net_input [B, H, W, 2*P*3] ->
    {'rgba_layers' [B, H, W, P, 4] (net_input's dtype), 'blend_weights',
    'alphas'}."""
    if which_color_pred != "blend_psv":
        raise ValueError(f"which_color_pred {which_color_pred!r} is not "
                         f"ported")
    b, h, w, _ = net_input.shape
    p = num_planes
    fg = net_input[..., :p * 3].reshape(b, h, w, p, 3)
    bg = net_input[..., p * 3:2 * p * 3].reshape(b, h, w, p, 3)
    blend = (msi_pred[..., :p] + 1.0) / 2.0
    alphas = (msi_pred[..., p:2 * p] + 1.0) / 2.0
    wgt = blend[..., None]
    rgb = wgt * fg + (1.0 - wgt) * bg
    return {"blend_weights": blend, "alphas": alphas,
            "rgba_layers": torch.cat([rgb, alphas[..., None]],
                                     dim=-1).to(net_input.dtype)}


def infer_msi(net, cfg, batch, psv_depths, dtype=None):
    """Reference path: gather sweep + plain MSIUNet + assembly. dtype
    overrides the net's compute dtype. Returns the assemble_rgba dict plus
    'psv' (the net input [B, H, W, 2*P*3])."""
    net_input = sweep_lib.format_network_input(
        preprocess_image(batch["ref_image"]),
        preprocess_image(batch["src_image"]), batch["ref_pose"],
        batch["src_pose"], batch["ref_pose_inv"], psv_depths,
        batch["intrinsics"])
    msi_pred = net(net_input.permute(0, 3, 1, 2), dtype=dtype)
    outputs = assemble_rgba(cfg.which_color_pred, msi_pred.permute(0, 2, 3, 1),
                            net_input, cfg.num_msi_planes)
    outputs["psv"] = net_input
    return outputs


def render_equirect_view(rgba_layers, tgt_pose_rt, tgt_pos, radii):
    """Gather render of a batch: [B, H, W, P, 4] + [B, 4, 4] + [B, 3] ->
    [B, H, W, 3]."""
    return torch.stack([
        render_lib.render_equirect_view(rgba_layers[i], tgt_pose_rt[i],
                                        tgt_pos[i], radii)
        for i in range(rgba_layers.shape[0])])


def sweep_stage(cfg, batch, psv_depths):
    """Hot path, stage 1: identity-pose dual-eye sweep of the batch's ODS
    pair -> net input [B, 2*P*3, H, W] in the compute dtype."""
    return sweep_ops.sweep_volume(preprocess_image(batch["ref_image"]),
                                  preprocess_image(batch["src_image"]),
                                  psv_depths, batch["intrinsics"],
                                  out_dtype=cfg.torch_compute_dtype)


def net_stage(stages, vol):
    """Hot path, stage 2: the U-Net -> prediction [B, 2P, H, W] f32."""
    return net_ops.unet_forward(stages, vol)


def render_stage(vol, pred, tgt_pose_rt, tgt_pos, msi_depths):
    """Hot path, stage 3: blend-fused render -> [B, H, W, 3] f32."""
    return render_lib.render_equirect_view_fused_blend(
        vol, pred, tgt_pose_rt, tgt_pos, msi_depths)
