"""MSI inference and rendering: the plain reference path and the kernel
paths.

Counterpart of `matryodshka_tpu/models/msi.py`. The reference path
(`infer_msi` + `render_equirect_view` / `render_equirect_depth`) sweeps by
gather, runs the plain MSIUNet and assembles [B, H, W, P, 4] layers, in the
JAX layouts. The kernel path (`infer_msi_prepared` ->
`render_view_and_depth_from_prepared`, or one output at a time through
`render_equirect_view_from_prepared` / `render_equirect_depth_from_prepared`)
runs the sweep kernel, which writes the net input channels first, and the
net (either variant: its stages carry their padding mode and coord
vectors, `ops/net.py:prepare`) through the conv kernel, its layer norms
fused into the convs;
then

* blend_psv: the blend-fused render kernel blends, samples and composites
  straight from the sweep volume and the prediction (no layer stack);
* the other schemes: the prepared assembly writes the layer stack
  [B, P, H, W, 4] (interleaved, the channels r, g, b, alpha innermost, so
  that each of the render's taps is one vector load; unflipped, unpadded,
  in the compute dtype) and the layer-stack render kernel draws it, image
  and depth in one launch. The high-res re-render takes its stack of the
  same layout from the sweep's assembled mode (ops/sweep.py:
  sweep_assembled) in one launch; assemble_hres_prepared is that mode's
  plain version's last step.

The JAX prepared stack is W-flipped, row-padded and split from two pole-cap
bands for the TPU ladder kernels; none of that is needed here.

The trainer (`training/step.py`) runs infer_msi (msi.py:346-395) as the
JAX train step calls it: the sweep kernel (`sweep_stage`), the trainer's
MSIUNet (its stride-1 wrap convs through K7, with autograd), then
`assemble_train` (assemble_rgba) and the gather render.

PP and REALESTATE_PP input make an MPI, not an MSI: `sweep_stage` takes
the perspective or homography plane sweep by gather (the JAX package has
no TPU kernel for either), the net runs as for ODS (the conv kernel reads
the 192 or 195 input channels), and `mpi_render_stage` assembles the
layers (assemble_rgba's) and renders the view with `render_mpi_view`
(homography warps and the over-composite, plain PyTorch: no TPU kernel
either). `infer_mpi` chains the three stages; the served path
(`entry.forward` on a PP or REALESTATE_PP batch) and the test CLI both
run it, so there is one planar route.

The GCN variant (`infer_gcn_msi`, the reference path; `infer_gcn_prepared`,
the kernel route) predicts on icosphere vertices from a per-vertex sweep
(plain PyTorch: the JAX package runs the GCN in XLA), scatters the
prediction onto the pixel grid (`models/gcn.mesh_to_equirect`) and
assembles it against the pixel-grid sweep volume, which on the card is
one K1 launch; the renders are the U-Net's.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch
import torch.nn.functional as F

from matryodshka_tpu_torch import trace
from matryodshka_tpu_torch.geometry import homography
from matryodshka_tpu_torch.geometry import render as render_lib
from matryodshka_tpu_torch.geometry import sweep as sweep_lib
from matryodshka_tpu_torch.models import gcn as gcn_lib
from matryodshka_tpu_torch.ops import net as net_ops
from matryodshka_tpu_torch.ops import sweep as sweep_ops


def preprocess_image(image):
    """[0, 1] -> [-1, 1]."""
    return image * 2.0 - 1.0


def deprocess_image(image):
    """[-1, 1] -> [0, 1] (clipping deferred to image IO)."""
    return (image + 1.0) / 2.0


def upsample_align_corners_cf(img, out_h: int, out_w: int):
    """Bilinear resize of [B, C, H, W] with align_corners=True semantics
    (msi.py:151-152, tf.image.resize(..., align_corners=True)) -> float32
    [B, C, out_h, out_w]."""
    return F.interpolate(img.float(), size=(out_h, out_w), mode="bilinear",
                         align_corners=True)


def upsample_align_corners(img, out_h: int, out_w: int):
    """As upsample_align_corners_cf in the JAX layout [B, H, W, C]."""
    return upsample_align_corners_cf(img.permute(0, 3, 1, 2), out_h,
                                     out_w).permute(0, 2, 3, 1)


# ---------------------------------------------------------------------------
# RGBA assembly, the four colour schemes (msi.py:108-273).
# ---------------------------------------------------------------------------

def assemble_rgba(which_color_pred: str, msi_pred, net_input,
                  num_planes: int) -> Dict[str, torch.Tensor]:
    """msi_pred [B, H, W, K] tanh + net_input [B, H, W, >= 2*P*3] (fg =
    channels [0, 3P), bg = [3P, 6P), the JAX slices also for the
    195-channel REALESTATE_PP input, msi.py:97, 103) ->
    {'rgba_layers' [B, H, W, P, 4] (net_input's dtype), 'alphas' and the
    scheme's intermediates: 'blend_weights' (all but alpha_only), 'bg_rgb'
    (blend_bg: the raw tanh of the last 3 channels), 'bg_blend_weights'
    (blend_bg_psv, which blends twice)}."""
    b, h, w, _ = net_input.shape
    p = num_planes
    fg = net_input[..., :p * 3].reshape(b, h, w, p, 3)
    out: Dict[str, torch.Tensor] = {}
    if which_color_pred == "alpha_only":
        out["alphas"] = (msi_pred[..., :p] + 1.0) / 2.0
        rgb = fg
    else:
        blend = (msi_pred[..., :p] + 1.0) / 2.0
        out["blend_weights"] = blend
        out["alphas"] = (msi_pred[..., p:2 * p] + 1.0) / 2.0
        wgt = blend[..., None]
        if which_color_pred == "blend_bg":
            bg_rgb = msi_pred[..., -3:]
            out["bg_rgb"] = bg_rgb
            rgb = wgt * fg + (1.0 - wgt) * bg_rgb[..., None, :]
        elif which_color_pred in ("blend_psv", "blend_bg_psv"):
            bg = net_input[..., p * 3:2 * p * 3].reshape(b, h, w, p, 3)
            rgb = wgt * fg + (1.0 - wgt) * bg
            if which_color_pred == "blend_bg_psv":
                bg_blend = (msi_pred[..., 2 * p:3 * p] + 1.0) / 2.0
                out["bg_blend_weights"] = bg_blend
                bgw = bg_blend[..., None]
                rgb = bgw * rgb + (1.0 - bgw) * msi_pred[..., None, -3:]
        else:
            raise ValueError(which_color_pred)
    out["rgba_layers"] = torch.cat([rgb, out["alphas"][..., None]],
                                   dim=-1).to(net_input.dtype)
    return out


def _shell_rgb(which_color_pred: str, vol, num_planes: int, blend,
               bg_blend=None, bg_rgb=None):
    """Shell colours [B, P, 3, H, W] float32 from the sweep volume
    vol [B, >= 2*P*3, H, W] (its channels [0, 3P) are fg, [3P, 6P) bg:
    the ref and src eyes, or for REALESTATE_PP the ref image and the first
    P-1 ref planes, then the rest, as JAX assemble_rgba reads them) and
    the scheme's
    weights [B, P, H, W] in [0, 1]; bg_rgb [B, 3, H, W]."""
    b, _, h, w = vol.shape
    v6 = vol[:, :2 * num_planes * 3].reshape(b, 2, num_planes, 3, h, w)
    fg = v6[:, 0].to(torch.float32, copy=True)
    if which_color_pred == "alpha_only":
        return fg
    wgt = blend[:, :, None]
    if which_color_pred == "blend_bg":
        return fg.mul_(wgt).add_((1.0 - wgt) * bg_rgb[:, None])
    rgb = fg.mul_(wgt).add_(
        v6[:, 1].to(torch.float32, copy=True).mul_(1.0 - wgt))
    if bg_blend is not None:
        bgw = bg_blend[:, :, None]
        rgb = rgb.mul_(bgw).add_((1.0 - bgw) * bg_rgb[:, None])
    return rgb


def _layer_stack(rgb, alpha, dtype):
    """[B, P, 3, H, W] + [B, P, H, W] float32 -> the interleaved stack
    [B, P, H, W, 4] in dtype, one rounding (the storage cast of
    _finish_prepared, msi.py:217-242)."""
    b, p, _, h, w = rgb.shape
    out = torch.empty((b, p, h, w, 4), dtype=dtype, device=rgb.device)
    out[..., :3] = rgb.permute(0, 1, 3, 4, 2)
    out[..., 3] = alpha
    return out


def assemble_rgba_prepared(which_color_pred: str, pred, vol,
                           num_planes: int, dtype=None):
    """Counterpart of assemble_rgba_prepared (msi.py:146): the net's tanh
    prediction pred [B, K, H, W] + the sweep volume vol [B, 2*P*3, H, W] ->
    the interleaved layer stack [B, P, H, W, 4] in dtype (default vol's),
    blended in float32. Same colour math as assemble_rgba."""
    p = num_planes
    pred = pred.float()
    if which_color_pred == "alpha_only":
        blend, alpha = None, (pred[:, :p] + 1.0) / 2.0
    else:
        blend = (pred[:, :p] + 1.0) / 2.0
        alpha = (pred[:, p:2 * p] + 1.0) / 2.0
    bg_blend = ((pred[:, 2 * p:3 * p] + 1.0) / 2.0
                if which_color_pred == "blend_bg_psv" else None)
    rgb = _shell_rgb(which_color_pred, vol, p, blend, bg_blend,
                     pred[:, -3:])
    return _layer_stack(rgb, alpha, vol.dtype if dtype is None else dtype)


def assemble_hres_prepared(which_color_pred: str, u_blend, u_alphas, vol,
                           u_bg_rgb: Optional[torch.Tensor] = None,
                           dtype=None):
    """Counterpart of assemble_hres_prepared (msi.py:284): upsampled blend
    weights and alphas [B, P, H, W] (already in [0, 1], msi.py:149-165)
    applied to the high-res sweep volume vol [B, 2*P*3, H, W] -> the
    interleaved layer stack [B, P, H, W, 4] in dtype (default vol's). As in
    the JAX function, blend_bg_psv blends with the src eye only (no
    background blend), and blend_bg takes the upsampled background u_bg_rgb
    [B, 3, H, W]."""
    which = "blend_psv" if which_color_pred == "blend_bg_psv" \
        else which_color_pred
    rgb = _shell_rgb(which, vol, u_alphas.shape[1], u_blend,
                     bg_rgb=u_bg_rgb)
    return _layer_stack(rgb, u_alphas.float(),
                        vol.dtype if dtype is None else dtype)


# ---------------------------------------------------------------------------
# The reference path (gather sweep, plain MSIUNet, gather render).
# ---------------------------------------------------------------------------

def format_input(cfg, batch, psv_depths, jitter_pose_inv=None):
    """The net input of the batch by gather, in the JAX layout
    [B, H, W, C] float32, as JAX infer_msi routes it (msi.py:365-375): the
    double ODS sphere sweep or the double perspective plane sweep (PP),
    C = 2*P*3; for REALESTATE_PP the ref image and the two homography
    plane sweeps, C = 3 + 2*P*3. jitter_pose_inv [B, 4, 4]: the
    regularizer's jittered forward."""
    ref = preprocess_image(batch["ref_image"])
    src = preprocess_image(batch["src_image"])
    if cfg.input_type == "REALESTATE_PP":
        return sweep_lib.format_realestate_network_input(
            ref, src, batch["ref_pose"], batch["src_pose"], psv_depths,
            batch["intrinsics"], jitter_pose_inv=jitter_pose_inv)
    return sweep_lib.format_network_input(
        ref, src, batch["ref_pose"], batch["src_pose"], batch["ref_pose_inv"],
        psv_depths, batch["intrinsics"], input_type=cfg.input_type,
        jitter_pose_inv=jitter_pose_inv)


def infer_msi(net, cfg, batch, psv_depths, dtype=None):
    """Reference path: gather sweep (format_input) + plain MSIUNet +
    assembly. dtype overrides the net's compute dtype. Returns the
    assemble_rgba dict plus 'psv' (the net input [B, H, W, C])."""
    net_input = format_input(cfg, batch, psv_depths)
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


def render_equirect_depth(rgba_layers, tgt_pose_rt, tgt_pos, radii):
    """Gather depth-proxy render of a batch: [B, H, W, P, 4] ->
    [B, H, W, 3]."""
    return torch.stack([
        render_lib.render_equirect_depth(rgba_layers[i], tgt_pose_rt[i],
                                         tgt_pos[i], radii)
        for i in range(rgba_layers.shape[0])])


def render_ods_view(rgba_layers, order: int, pose, tgt_pos, radii,
                    intrinsics):
    """ODS eye re-render of a batch (JAX msi.py:779): [B, H, W, P, 4],
    pose [B, 4, 4], intrinsics [B, 3, 3] -> [B, H, W, 3]. As in the JAX
    function, tgt_pos is not read: the rays start on the viewing
    circle."""
    return torch.stack([
        render_lib.render_ods_view(rgba_layers[i], order, pose[i], None,
                                   radii, intrinsics[i])
        for i in range(rgba_layers.shape[0])])


def mpi_view_pose(batch, jitter_pose_inv=None):
    """The PP / RealEstate target view's pose relative to the layers'
    frame: tgt_pose @ ref_pose_inv [@ jitter_pose_inv], [B, 4, 4] (JAX
    step.py:166-167, 175-178)."""
    rel = batch["ref_pose_inv"]
    if jitter_pose_inv is not None:
        rel = torch.einsum("bij,bjk->bik", rel, jitter_pose_inv)
    return torch.einsum("bij,bjk->bik", batch["tgt_pose"], rel)


def render_mpi_view(rgba_layers, tgt_pose, radii, intrinsics):
    """Perspective MPI render of a batch (JAX msi.py:803, msi.py:527-548):
    rgba_layers [B, H, W, P, 4], tgt_pose [B, 4, 4] (relative),
    intrinsics [B, 3, 3] -> [B, H, W, 3] float32; plane p at radii[p]. The
    batch's B x P homography warps are one gather."""
    return homography.mpi_render_view(rgba_layers, tgt_pose, radii,
                                      intrinsics)


def render_perspective_view(rgba_layers, tgt_pos, radii,
                            viewing_window: int = 3, psp_height: int = 270,
                            psp_width: int = 480):
    """Perspective crop render of a batch (JAX msi.py:788; the test CLI's
    270 x 480 window, unlike geometry/render.py's 320 x 640 default):
    [B, H, W, P, 4], tgt_pos [B, 3] -> [B, psp_height, psp_width, 3]."""
    return torch.stack([
        render_lib.render_perspective_view(rgba_layers[i], tgt_pos[i], radii,
                                           viewing_window, psp_height,
                                           psp_width)
        for i in range(rgba_layers.shape[0])])


# ---------------------------------------------------------------------------
# The kernel path.
# ---------------------------------------------------------------------------

def sweep_stage(cfg, batch, psv_depths, jitter_pose_inv=None):
    """Stage 1: the net input [B, C, H, W] in the compute dtype, at the
    size of the batch's images. For ODS input without jitter the
    identity-pose sweep of the batch's pair (it preprocesses the images;
    on the card one kernel launch, which reads no pose). Otherwise the
    gather route of format_input: for ODS with the transform-inverse
    regularizer's jitter_pose_inv [B, 4, 4] the general-pose sphere sweep
    at ref_pose_inv @ jitter_pose_inv, as the JAX package takes its kernel
    only without jitter (JAX sweep.py:150-151); for PP the perspective
    plane sweep and for REALESTATE_PP the ref image and the homography
    plane sweeps (no TPU kernel exists for either; inside the span
    msi.mpi_sweep); with cfg.use_pallas false the gather always (JAX
    sweep.py:150). The arguments pick the route, so the kernel never sees
    a posed batch."""
    with trace.span("msi.sweep_stage"):
        if cfg.input_type == "ODS":
            if jitter_pose_inv is None and cfg.use_pallas:
                return sweep_ops.sweep_volume(
                    batch["ref_image"], batch["src_image"], psv_depths,
                    batch["intrinsics"], out_dtype=cfg.torch_compute_dtype)
            return _gather_volume(cfg, batch, psv_depths, jitter_pose_inv)
        with trace.span("msi.mpi_sweep"):
            return _gather_volume(cfg, batch, psv_depths, jitter_pose_inv)


def _gather_volume(cfg, batch, psv_depths, jitter_pose_inv):
    """format_input's volume [B, C, H, W] in the compute dtype."""
    vol = format_input(cfg, batch, psv_depths, jitter_pose_inv)
    return vol.permute(0, 3, 1, 2).to(cfg.torch_compute_dtype).contiguous()


def net_stage(stages, vol):
    """Stage 2: the U-Net -> prediction [B, K, H, W] f32."""
    with trace.span("msi.net_stage"):
        return net_ops.unet_forward(stages, vol)


def render_stage(vol, pred, tgt_pose_rt, tgt_pos, msi_depths):
    """Stage 3 of blend_psv: blend-fused render -> [B, H, W, 3] f32."""
    with trace.span("msi.render_stage"):
        return render_lib.render_equirect_view_fused_blend(
            vol, pred, tgt_pose_rt, tgt_pos, msi_depths)


def assemble_outputs_planar(cfg, vol, pred) -> Dict[str, torch.Tensor]:
    """The post-net tail (msi.py:578): {'vol', 'pred'} for blend_psv,
    which the blend-fused render reads as they are; plus 'layers', the
    prepared layer stack, for the other schemes."""
    out = {"vol": vol, "pred": pred}
    if cfg.which_color_pred != "blend_psv":
        out["layers"] = assemble_rgba_prepared(
            cfg.which_color_pred, pred, vol, cfg.num_msi_planes,
            cfg.torch_compute_dtype)
    return out


def mpi_render_stage(cfg, vol, pred, batch, msi_depths):
    """Stage 3 of PP and REALESTATE_PP input: assemble_rgba in the compute
    dtype (vol's; fg = channels [0, 3P), bg = [3P, 6P)), then the MPI
    render at mpi_view_pose(batch) with the batch's intrinsics. Returns
    assemble_rgba's dict plus 'psv' ([B, H, W, C]) and 'output_image'
    ([B, H, W, 3] float32 in [-1, 1])."""
    with trace.span("msi.mpi_render_stage"):
        outs = assemble_train(cfg, vol, pred)
        outs["output_image"] = render_mpi_view(
            outs["rgba_layers"], mpi_view_pose(batch), msi_depths,
            batch["intrinsics"])
        return outs


def infer_mpi(cfg, stages, batch, psv_depths, msi_depths):
    """The PP / RealEstate kernel route (the non-spherical branch of JAX
    cli/test.py:137-147), which the served path (`entry.forward`) and the
    test CLI share: sweep_stage (the gather sweep), net_stage (the conv
    kernel with its fused layer norms) and mpi_render_stage. Returns
    mpi_render_stage's dict."""
    vol = sweep_stage(cfg, batch, psv_depths)
    if vol.shape[2] != cfg.height:
        raise ValueError(f"net input height {vol.shape[2]}: the prepared "
                         f"coord column is for {cfg.height} rows")
    return mpi_render_stage(cfg, vol, net_stage(stages, vol), batch,
                            msi_depths)


def infer_msi_prepared(cfg, stages, batch, psv_depths):
    """Sweep kernel -> net kernels -> assemble_outputs_planar."""
    vol = sweep_stage(cfg, batch, psv_depths)
    return assemble_outputs_planar(cfg, vol, net_stage(stages, vol))


# ---------------------------------------------------------------------------
# The GCN variant.
# ---------------------------------------------------------------------------

def gcn_cfg(cfg):
    """cfg for the GCN's assembly: float32 throughout, as JAX
    infer_gcn_msi sweeps and assembles in float32 (the GCN replaces the
    U-Net, whose compute dtype compute_dtype is)."""
    return dataclasses.replace(cfg, compute_dtype="float32")


def gcn_vertex_input(batch, psv_depths, coords):
    """The GCN's input [V, 2*P*3]: the per-vertex double sweep of the
    batch's first example (JAX msi.py:687-727, batch size 1). The eye
    orders are the pixel path's reversed, ref -1 and src +1
    (format_gcn_network_input, reference msi.py:1087)."""
    ref = preprocess_image(batch["ref_image"])
    src = preprocess_image(batch["src_image"])
    vols = [sweep_lib.gcn_sphere_sweep(img, order, psv_depths, coords,
                                       batch["intrinsics"])
            for img, order in ((ref, -1), (src, 1))]
    return torch.cat(vols, dim=-1)[0]


def gcn_predict(gcn, batch, psv_depths, coords, p2v, apply=None):
    """The GCN's prediction on the pixel grid, channels first [B, K, H, W]
    float32: the vertex sweep, the GCN (through apply(gcn, x) when given,
    the trainer's remat), mesh_to_equirect. The GCN sees the first
    example only, as in JAX, whose [1, H, W, K] prediction broadcasts
    over the batch in the assembly; here it is expanded to B."""
    x = gcn_vertex_input(batch, psv_depths, coords)
    mesh_pred = gcn(x) if apply is None else apply(gcn, x)
    pred = gcn_lib.mesh_to_equirect(mesh_pred, p2v).permute(0, 3, 1, 2)
    return pred.expand(batch["ref_image"].shape[0], -1, -1, -1)


def infer_gcn_msi(gcn, cfg, batch, psv_depths, coords, p2v):
    """Reference path of the GCN variant (JAX msi.py:687-727): the vertex
    sweep, the GCN, mesh_to_equirect, and assemble_rgba against the
    pixel-grid PSV by gather (format_input), in float32. Returns
    assemble_rgba's dict plus 'psv'."""
    pred = gcn_predict(gcn, batch, psv_depths, coords, p2v)
    net_input = format_input(cfg, batch, psv_depths)
    outputs = assemble_rgba(cfg.which_color_pred, pred.permute(0, 2, 3, 1),
                            net_input, cfg.num_msi_planes)
    outputs["psv"] = net_input
    return outputs


def infer_gcn_prepared(cfg, gcn, batch, psv_depths, coords, p2v):
    """The GCN's kernel route: sweep_stage in float32 (on the card one K1
    launch) for the pixel-grid PSV, gcn_predict, then
    assemble_outputs_planar in float32, which
    render_view_and_depth_from_prepared draws with K3 (blend_psv) or the
    layer-stack kernel (the other schemes)."""
    gc = gcn_cfg(cfg)
    vol = sweep_stage(gc, batch, psv_depths)
    pred = gcn_predict(gcn, batch, psv_depths, coords, p2v).contiguous()
    return assemble_outputs_planar(gc, vol, pred)


# ---------------------------------------------------------------------------
# The training forward.
# ---------------------------------------------------------------------------

def assemble_hres_rgba(which_color_pred: str, outputs, vol,
                       num_planes: int):
    """Counterpart of assemble_hres_rgba (JAX msi.py:312-339, the
    reference's msi.py:149-165, 196-212): the low-res blend weights and
    alphas of assemble_rgba's outputs ([B, h, w, P]) upsampled bilinearly
    with aligned corners to the high-res sweep volume vol [B, 2*P*3, Hh, Ww]
    (sweep_stage's planar layout, in the compute dtype) and applied to it:
    blend_psv blends the ref eye's planes (fg) with the src eye's (bg),
    blend_bg fg with the upsampled background colour, and alpha_only and
    blend_bg_psv take fg as it is (as the JAX function does: its
    blend_bg_psv does not blend). -> [B, Hh, Ww, P, 4] float32, the JAX
    layout, as a view of a planar [B, P, 4, Hh, Ww] tensor. Differentiable
    in the outputs. The volume is read through views of its planes and
    promoted to float32 only inside the products: no float32 copy of its
    2*P*3 channels is made."""
    b, _, hh, ww = vol.shape
    p = num_planes

    def up(x):
        return upsample_align_corners_cf(x.permute(0, 3, 1, 2), hh, ww)

    fg = vol[:, :p * 3].reshape(b, p, 3, hh, ww)
    if which_color_pred == "blend_psv":
        wgt = up(outputs["blend_weights"])[:, :, None]
        bg = vol[:, p * 3:2 * p * 3].reshape(b, p, 3, hh, ww)
        rgb = wgt * fg + (1.0 - wgt) * bg
    elif which_color_pred == "blend_bg":
        wgt = up(outputs["blend_weights"])[:, :, None]
        rgb = wgt * fg + (1.0 - wgt) * up(outputs["bg_rgb"])[:, None]
    else:
        rgb = fg.float()
    rgba = torch.cat([rgb, up(outputs["alphas"])[:, :, None]], dim=2)
    return rgba.permute(0, 3, 4, 1, 2)


def assemble_train(cfg, vol, pred) -> Dict[str, torch.Tensor]:
    """The differentiable tail of infer_msi as the JAX train step runs it
    (msi.py:379-382): the sweep volume vol [B, 2*P*3, H, W] and the net's
    prediction pred [B, K, H, W] -> assemble_rgba's dict (rgba_layers
    [B, H, W, P, 4] in vol's dtype) plus 'psv' [B, H, W, 2*P*3]."""
    net_input = vol.permute(0, 2, 3, 1)
    outputs = assemble_rgba(cfg.which_color_pred, pred.permute(0, 2, 3, 1),
                            net_input, cfg.num_msi_planes)
    outputs["psv"] = net_input
    return outputs


def render_view_and_depth_from_prepared(outputs, tgt_pose_rt, tgt_pos,
                                        radii, ftb: bool = False):
    """Image and depth proxy of infer_msi_prepared's outputs -> (rgb,
    depth), each [B, H, W, 3] float32: where there is a layer stack, one
    launch of the layer-stack kernel writes both (front to back when ftb);
    else the blend-fused kernel's colour and depth modes."""
    if "layers" in outputs:
        return render_lib.render_equirect_view_prepared_both(
            outputs["layers"], tgt_pose_rt, tgt_pos, radii, ftb=ftb)
    return tuple(render_lib.render_equirect_view_fused_blend(
        outputs["vol"], outputs["pred"], tgt_pose_rt, tgt_pos, radii,
        depth=depth) for depth in (False, True))


def render_equirect_view_from_prepared(outputs, tgt_pose_rt, tgt_pos, radii,
                                       ftb: bool = False,
                                       depth: bool = False):
    """Batched render of infer_msi_prepared's outputs -> [B, H, W, 3]
    float32: the layer-stack kernel (front to back when ftb) where there
    is a stack, else the blend-fused kernel."""
    if "layers" in outputs:
        return render_lib.render_equirect_view_prepared(
            outputs["layers"], tgt_pose_rt, tgt_pos, radii, ftb=ftb,
            depth=depth)
    return render_lib.render_equirect_view_fused_blend(
        outputs["vol"], outputs["pred"], tgt_pose_rt, tgt_pos, radii,
        depth=depth)


def render_equirect_depth_from_prepared(outputs, tgt_pose_rt, tgt_pos,
                                        radii, ftb: bool = False):
    """The depth proxy through the same kernels' depth modes (only the
    alphas are read; msi.py:639-659)."""
    return render_equirect_view_from_prepared(outputs, tgt_pose_rt, tgt_pos,
                                              radii, ftb=ftb, depth=True)
