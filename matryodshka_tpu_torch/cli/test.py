"""Inference entry point (the reference's test.py).

    python -m matryodshka_tpu_torch.cli.test --image_dir DIR \
        --cameras_glob 'CAMS/*.txt' [--params net.npz] [--coord_net true] \
        [--input_type ODS|PP|REALESTATE_PP] [--device cuda] \
        [--test_type high_res] [--test_outputs ...] [--num_runs N]

Counterpart of `matryodshka_tpu/cli/test.py`. Runs batch-1 inference over
the camera files, renders the requested outputs and writes PNGs plus
blend_weights.npy / alphas.npy per example, under the JAX CLI's file names
(test.py:87-281), and for blend_bg also bg_rgb.npy (the predicted
background colour). `--test_type high_res` then re-renders every example
at hres_height x hres_width (4096x2048 by default) from its saved weights
and the high-res image pair (test.py:284-394), for every colour scheme,
with the colour rule of JAX `assemble_hres_rgba` (models/msi.py:312-339,
the rule the hrestgt trainer supervises with; `HRES_ASSEMBLY`): blend_psv
blends the ref eye's shells with the src eye's, blend_bg with the
upsampled background colour, and alpha_only and blend_bg_psv take the ref
eye's shells as they are. (The JAX CLI's shell scan blends with the src
eye for every scheme, cli/test.py:262-266, and fails for alpha_only,
which saves no blend_weights.npy; the port does not follow it there,
ROADMAP Queue 3.)

Every stage runs through the port's kernels on a CUDA device: the sweep
(csrc/sweep.cu), the U-Net (conv.cu in the wrap net's mode, or in the coord
net's with `--coord_net true`; the layer norms fused into the convs),
then for blend_psv the blend-fused render (render.cu, colour and depth
mode) and for the other
schemes the prepared assembly and the layer-stack render
(render_layers.cu, one launch for image and depth, lookups made in the
kernel); the high-res re-render of every scheme sweeps, upsamples and
assembles its interleaved stack at full size in one launch of the sweep's
assembled mode (sweep_assembled.cu) and draws through render_layers.cu the
same way (one launch). `--device cpu` runs each kernel's plain
version. `--use_pallas false` takes the JAX CLI's routes without Pallas
and none of the port's kernels: the gather sweep, the plain net in the
compute dtype and the gather renders, and for high_res the shell-streamed
gather (hres_render_plain at the batch's poses).

PP and REALESTATE_PP input (the non-spherical branch of JAX
cli/test.py:137-147): the gather sweep (perspective or homography plane
sweep; the JAX package has no TPU kernel for it), the net through the same
conv kernel, the assembly, and the MPI render of the target
view at tgt_pose @ ref_pose_inv (homography warps, plain PyTorch), written
as output_tgt_*; there is no depth output, and psp, src_output_image,
ref_output_image and high_res are ODS outputs, as in the JAX CLI.

The GCN (`--gcn true --subdiv S --mesh_dir DIR`, JAX cli/test.py:57-70):
the per-vertex sweep and the GCN (plain PyTorch: the JAX package runs
them in XLA), mesh_to_equirect, then the sweep kernel for the pixel-grid
volume and the same renders as the U-Net's (render.cu for blend_psv, the
prepared assembly and render_layers.cu for the other schemes), in
float32 as JAX infer_gcn_msi assembles.

`--shard_shells true` in a process group (the CLI started as ranks by
`torchrun --nproc_per_node N`; NCCL, one card a rank, or gloo with
`--device cpu`): rank 0 writes the low-res outputs, then every rank
sweeps, assembles and renders its contiguous block of the high-res
shells (the layer-stack kernel's partial mode), the partials are
all_gathered and combined, and rank 0 writes the view. In one process
the flag is ignored, as the JAX CLI ignores it on one device.

The net's weights come from `--params`, an .npz of the flax parameter tree
(training/checkpoint.py; `python -m matryodshka_tpu_torch.tf_import` writes
one from a reference TF checkpoint), or, as in the JAX CLI, from the latest
checkpoint under <checkpoint_dir>/<experiment_name> (the trainer's); with
neither, main raises FileNotFoundError.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch
import torch.distributed as dist

from matryodshka_tpu_torch import entry, trace
from matryodshka_tpu_torch.config import (MatryConfig, add_config_args,
                                          config_from_args)
from matryodshka_tpu_torch.data.images import write_image
from matryodshka_tpu_torch.data.loader import OdsLoader, make_loader
from matryodshka_tpu_torch.geometry import render as render_lib
from matryodshka_tpu_torch.geometry import sweep as sweep_lib
from matryodshka_tpu_torch.models import msi as msi_lib
from matryodshka_tpu_torch.ops import render as render_ops
from matryodshka_tpu_torch.ops import render_layers as rl_ops
from matryodshka_tpu_torch.ops import sweep as sweep_ops
from matryodshka_tpu_torch.ops.resample import resample_layers_uv
from matryodshka_tpu_torch.parallel import mesh, sharded_render
from matryodshka_tpu_torch.training.checkpoint import (CheckpointManager,
                                                       restore_params)

DEFAULT_TEST_OUTPUTS = ("rgba_layers_src_image_ref_image_tgt_image_"
                        "blend_weights_alphas")


def _eye(b, device):
    return torch.eye(4, device=device).expand(b, 4, 4)


def build_infer_fn(cfg: MatryConfig, params: entry.Params,
                   test_outputs: str, ftb: bool = False):
    """infer(batch) -> dict of the requested outputs, each [B, ...] on the
    batch's device: output_image ([0, 1]) and output_depth (tgt_image),
    rgba_layers, blend_weights, bg_rgb (blend_bg's predicted background
    colour [B, H, W, 3], the high-res re-render's third input), alphas,
    psv, output_psp0..3 (psp: the four
    270 x 480 perspective windows, yaw 0, 90, 180, 270 degrees),
    output_src and output_ref (src_output_image, ref_output_image: the
    ODS eyes re-rendered), the last three in [0, 1]. The target view is
    the ERP view at batch['tgt_pose']; ftb renders the layer stack front
    to back with early termination (schemes other than blend_psv). The
    perspective and ODS-eye re-renders gather from the rgba_layers
    assembled from the kernel route's volume and prediction: the JAX
    package has no TPU kernel for them either (it gathers in XLA)."""
    rerenders = ("psp", "src_output_image", "ref_output_image")
    if cfg.input_type != "ODS":
        if any(k in test_outputs for k in rerenders):
            raise ValueError(f"{rerenders} re-render an ODS MSI; input_type "
                             f"{cfg.input_type} makes an MPI")
    if not cfg.use_pallas:
        return _build_gather_infer_fn(cfg, params, test_outputs)
    if cfg.input_type != "ODS":
        return _build_mpi_infer_fn(cfg, params, test_outputs)

    @torch.no_grad()
    def infer(batch):
        if cfg.gcn:
            pouts = msi_lib.infer_gcn_prepared(cfg, params.net, batch,
                                               params.psv_depths,
                                               *params.gcn_inputs)
        else:
            pouts = msi_lib.infer_msi_prepared(cfg, params.stages, batch,
                                               params.psv_depths)
        vol, pred = pouts["vol"], pouts["pred"]
        outs = {}
        if any(k in test_outputs for k in
               ("rgba_layers", "blend_weights", "alphas", *rerenders)):
            asm = msi_lib.assemble_rgba(
                cfg.which_color_pred, pred.permute(0, 2, 3, 1),
                vol.permute(0, 2, 3, 1), cfg.num_msi_planes)
            outs.update(_assembly_outputs(asm, test_outputs))
            outs.update(rerender(cfg, asm["rgba_layers"], batch,
                                 params.msi_depths, test_outputs))
        if "psv" in test_outputs:
            outs["psv"] = vol.permute(0, 2, 3, 1)
        if "tgt_image" in test_outputs:
            img, depth = msi_lib.render_view_and_depth_from_prepared(
                pouts, _eye(vol.shape[0], vol.device), batch["tgt_pose"],
                params.msi_depths, ftb=ftb)
            outs["output_image"] = msi_lib.deprocess_image(img)
            outs["output_depth"] = depth
        return outs

    return infer


def _build_mpi_infer_fn(cfg: MatryConfig, params: entry.Params,
                        test_outputs: str):
    """build_infer_fn for PP and REALESTATE_PP input (JAX
    cli/test.py:137-147): msi_lib.infer_mpi, the gather sweep, the net
    through the conv kernel, the assembly and the MPI
    render at tgt_pose @ ref_pose_inv -> output_image ([0, 1]; no depth
    output, as in the JAX CLI), rgba_layers, blend_weights, alphas, psv."""

    @torch.no_grad()
    def infer(batch):
        asm = msi_lib.infer_mpi(cfg, params.stages, batch, params.psv_depths,
                                params.msi_depths)
        outs = _assembly_outputs(asm, test_outputs)
        if "tgt_image" in test_outputs:
            outs["output_image"] = msi_lib.deprocess_image(
                asm["output_image"])
        return outs

    return infer


def _build_gather_infer_fn(cfg: MatryConfig, params: entry.Params,
                           test_outputs: str):
    """build_infer_fn with use_pallas false, the JAX CLI's route without
    Pallas (cli/test.py:95-116): msi_lib.infer_msi (the gather sweep and
    the plain MSIUNet in the compute dtype), then for ODS the gather
    renders of the target view and its depth and the re-renders, for PP
    and REALESTATE_PP the MPI render. None of the port's kernels runs."""

    @torch.no_grad()
    def infer(batch):
        asm = _reference_assembly(cfg, params, batch)
        rgba = asm["rgba_layers"]
        outs = _assembly_outputs(asm, test_outputs)
        if cfg.input_type != "ODS":
            if "tgt_image" in test_outputs:
                outs["output_image"] = msi_lib.deprocess_image(
                    msi_lib.render_mpi_view(rgba, msi_lib.mpi_view_pose(batch),
                                            params.msi_depths,
                                            batch["intrinsics"]))
            return outs
        if "tgt_image" in test_outputs:
            eye = _eye(rgba.shape[0], rgba.device)
            outs["output_image"] = msi_lib.deprocess_image(
                msi_lib.render_equirect_view(rgba, eye, batch["tgt_pose"],
                                             params.msi_depths))
            outs["output_depth"] = msi_lib.render_equirect_depth(
                rgba, eye, batch["tgt_pose"], params.msi_depths)
        outs.update(rerender(cfg, rgba, batch, params.msi_depths,
                             test_outputs))
        return outs

    return infer


def _reference_assembly(cfg: MatryConfig, params: entry.Params, batch,
                        dtype=None):
    """The reference path's assembly: msi_lib.infer_gcn_msi with cfg.gcn,
    else msi_lib.infer_msi (dtype overriding the net's compute dtype)."""
    if cfg.gcn:
        return msi_lib.infer_gcn_msi(params.net, cfg, batch,
                                     params.psv_depths, *params.gcn_inputs)
    return msi_lib.infer_msi(params.net, cfg, batch, params.psv_depths,
                             dtype=dtype)


def _assembly_outputs(asm, test_outputs: str):
    """The assembly's outputs that test_outputs asks for, where the scheme
    has them: rgba_layers, blend_weights, bg_rgb, alphas, psv."""
    return {k: asm[k] for k in ("rgba_layers", "blend_weights", "bg_rgb",
                                "alphas", "psv")
            if k in asm and k in test_outputs}


def rerender(cfg: MatryConfig, rgba_layers, batch, msi_depths,
             test_outputs: str):
    """The test CLI's perspective and ODS-eye re-renders of rgba_layers
    [B, H, W, P, 4] (JAX cli/test.py:120-136), those that test_outputs
    asks for: {output_psp0..3, output_src, output_ref}, [0, 1]."""
    outs = {}
    if "psp" in test_outputs:
        for win in range(4):
            outs[f"output_psp{win}"] = msi_lib.deprocess_image(
                msi_lib.render_perspective_view(
                    rgba_layers, batch["tgt_pose"], msi_depths,
                    viewing_window=win))
    eye = _eye(rgba_layers.shape[0], rgba_layers.device)
    for key, name, order in (("src_output_image", "output_src", -1),
                             ("ref_output_image", "output_ref", 1)):
        if key in test_outputs:
            outs[name] = msi_lib.deprocess_image(msi_lib.render_ods_view(
                rgba_layers, order, eye, batch["tgt_pose"], msi_depths,
                batch["intrinsics"]))
    return outs


@torch.no_grad()
def infer_plain(cfg: MatryConfig, params: entry.Params, batch):
    """build_infer_fn's output_image and output_depth with every kernel
    replaced by its plain version, in float32: ods_sweep_plain, the plain
    MSIUNet (or gcn_predict), then render_blend_plain (blend_psv) or the
    prepared assembly and render_layers_plain. For PP and REALESTATE_PP,
    output_image of msi_lib.infer_msi (the gather sweep and the plain
    MSIUNet) and the MPI render."""
    if cfg.input_type != "ODS":
        asm = _reference_assembly(cfg, params, batch, dtype=torch.float32)
        return {"output_image": msi_lib.deprocess_image(
            msi_lib.render_mpi_view(asm["rgba_layers"],
                                    msi_lib.mpi_view_pose(batch),
                                    params.msi_depths, batch["intrinsics"]))}
    images, rowp = sweep_ops.sweep_inputs(
        msi_lib.preprocess_image(batch["ref_image"]),
        msi_lib.preprocess_image(batch["src_image"]), params.psv_depths,
        batch["intrinsics"])
    vol = sweep_ops.ods_sweep_plain(images, rowp, torch.float32)
    if cfg.gcn:
        pred = msi_lib.gcn_predict(params.net, batch, params.psv_depths,
                                   *params.gcn_inputs)
    else:
        pred = params.net(vol, dtype=torch.float32)
    u, v = render_lib.uv_tables(_eye(vol.shape[0], vol.device),
                                batch["tgt_pose"], params.msi_depths,
                                cfg.height, cfg.width)
    if cfg.which_color_pred == "blend_psv":
        img = render_ops.render_blend_plain(vol, pred, u, v)
        depth = render_ops.render_blend_plain(vol, pred, u, v, depth=True)
    else:
        layers = msi_lib.assemble_rgba_prepared(
            cfg.which_color_pred, pred, vol, cfg.num_msi_planes,
            torch.float32)
        img = rl_ops.render_layers_plain(layers, u, v)
        depth = rl_ops.render_layers_plain(layers, u, v, depth=True)
    return {"output_image": msi_lib.deprocess_image(img),
            "output_depth": depth}


def _psv_depths(cfg: MatryConfig, device):
    return torch.tensor(sweep_lib.inv_depths(cfg.min_depth, cfg.max_depth,
                                             cfg.num_psv_planes),
                        dtype=torch.float32, device=device)


#: The high-res re-render's colour rule per scheme, as the rule the sweep's
#: assembled mode (ops/sweep.py:sweep_assembled) and assemble_hres_prepared
#: are called with (JAX models/msi.py:312-339 assemble_hres_rgba):
#: blend_psv blends the ref eye's shells (fg) with the src eye's, blend_bg
#: fg with the upsampled background colour, and alpha_only and blend_bg_psv
#: take fg as it is.
HRES_ASSEMBLY = {"blend_psv": "blend_psv", "blend_bg": "blend_bg",
                 "blend_bg_psv": "alpha_only", "alpha_only": "alpha_only"}


def hres_inputs(which_color_pred: str):
    """The saved low-res outputs the high-res re-render of a scheme reads:
    alphas always, blend_weights where it blends, bg_rgb for blend_bg."""
    assembly = HRES_ASSEMBLY[which_color_pred]
    return (("alphas",)
            + (("blend_weights",) if assembly != "alpha_only" else ())
            + (("bg_rgb",) if assembly == "blend_bg" else ()))


@trace.setup_span("test.build_hres_render_fn")
def build_hres_render_fn(cfg: MatryConfig, shards: int = 1):
    """High-res re-render with the semantics of the JAX
    build_hres_render_fn_fused (cli/test.py:178-229) and, per scheme, the
    colour rule of HRES_ASSEMBLY: the identity-pose dual sweep at
    hres_height x hres_width (the sweep kernel has no VMEM bound, so no
    row chunks), the low-res blend weights, alphas and background colour
    upsampled (align corners), the high-res prepared assembly, and the
    layer-stack render of colour and depth (on the card one launch for
    both) with the PSV depths as radii. The sweep, upsample and assembly
    are one call of the sweep's assembled mode (ops/sweep.py:
    sweep_assembled; on the card one launch, which writes the interleaved
    stack and builds no upsampled weights or f32 stack).

    shards > 1: the shells split into that many contiguous back-to-front
    blocks (JAX build_hres_render_fn with a 'shell' mesh, cli/test.py:
    241-330; parallel/sharded_render.py): each block is swept and
    assembled (one assembled-sweep launch over its planes) and rendered by
    the layer-stack kernel's partial mode (one launch: partial colour,
    depth and transmittance), and the blocks' partials are combined
    (combine_partials). In a process group of `shards` ranks each rank
    renders its own block and the partials are all_gathered, so every
    rank returns the view; in one process it renders every block in turn.

    render(hres_ref, hres_src, blend_weights, alphas, ref_pose, src_pose,
    ref_pose_inv, intrinsics, tgt_pose, bg_rgb=None) -> (rgb [B, Hh, Wh, 3]
    in [0, 1], depth [B, Hh, Wh, 3]); blend_weights and alphas [B, h, w,
    P], bg_rgb [B, h, w, 3]; blend_weights may be None where the scheme's
    rule does not blend (hres_inputs), bg_rgb is read for blend_bg only.
    As in the fused JAX path, the ODS loader's identity ref/src poses are
    assumed, not read. With use_pallas false, hres_render_plain with the
    gather sweep (the JAX CLI's shell scan, cli/test.py:232-334)."""
    p = cfg.num_psv_planes
    dtype = cfg.torch_compute_dtype
    assembly = HRES_ASSEMBLY[cfg.which_color_pred]
    if not cfg.use_pallas:
        def render_gather(hres_ref, hres_src, blend_weights, alphas,
                          ref_pose, src_pose, ref_pose_inv, intrinsics,
                          tgt_pose, bg_rgb=None):
            return hres_render_plain(
                cfg, hres_ref, hres_src, blend_weights, alphas, intrinsics,
                tgt_pose, poses=(ref_pose, src_pose, ref_pose_inv),
                bg_rgb=bg_rgb)
        return render_gather
    blocks = sharded_render.shell_blocks(p, shards)
    rank, world = mesh.rank_and_size()
    if world > 1 and world != shards:
        raise ValueError(f"{shards} shell blocks over {world} ranks")

    @torch.no_grad()
    def render(hres_ref, hres_src, blend_weights, alphas, ref_pose,
               src_pose, ref_pose_inv, intrinsics, tgt_pose, bg_rgb=None):
        with trace.span("test.hres_render"):
            del ref_pose, src_pose, ref_pose_inv
            depths = _psv_depths(cfg, hres_ref.device)
            read = hres_inputs(cfg.which_color_pred)
            low = {k: (x.float().contiguous() if k in read else None)
                   for k, x in (("alphas", alphas),
                                ("blend_weights", blend_weights),
                                ("bg_rgb", bg_rgb))}
            eye = _eye(hres_ref.shape[0], hres_ref.device)

            def block(p0, p1):
                """The interleaved layer stack of shells p0 .. p1-1 [B, p1-p0,
                Hh, Wh, 4]: their sweep, upsampled weights and assembly, one
                call of the assembled mode."""
                return sweep_ops.sweep_assembled(
                    hres_ref, hres_src, depths[p0:p1], intrinsics,
                    low["alphas"], low["blend_weights"], low["bg_rgb"],
                    rule=assembly, p0=p0, out_dtype=dtype)

            if shards == 1:
                layers = block(0, p)
                rgb, depth = render_lib.render_equirect_view_prepared_both(
                    layers, eye, tgt_pose, depths)
                return msi_lib.deprocess_image(rgb), depth
            mine = [blocks[rank]] if world > 1 else blocks
            parts = [rl_ops.render_layers_partial(block(p0, p1), eye, tgt_pose,
                                                  depths[p0:p1], p0, p)
                     for p0, p1 in mine]
            if world > 1:
                c, d, t = sharded_render.gather_partials(parts[0])
            else:
                c, d, t = (torch.stack(x) for x in zip(*parts))
            return (msi_lib.deprocess_image(
                sharded_render.combine_partials(c, t)),
                sharded_render.combine_partials(d, t))

    return render


@torch.no_grad()
def hres_render_plain(cfg: MatryConfig, hres_ref, hres_src, blend_weights,
                      alphas, intrinsics, tgt_pose, poses=None, bg_rgb=None):
    """build_hres_render_fn's (rgb, depth) from the plain versions in
    float32, streamed one shell at a time as the JAX shell scan does
    (cli/test.py:232-334), so memory stays at one high-res shell (and for
    blend_bg the upsampled background colour): per shell the plain sweep
    of both eyes, the scheme's colour rule (HRES_ASSEMBLY) with the
    upsampled weights, a gather of the shell at its lookup table, and a
    nearest-first composite. poses=(ref_pose, src_pose, ref_pose_inv):
    the sweep is the gather sweep at those poses (format_network_input,
    as the JAX scan sweeps), else the identity-pose sweep's plain
    version."""
    hh, hw, p = cfg.hres_height, cfg.hres_width, cfg.num_psv_planes
    b = hres_ref.shape[0]
    dev = hres_ref.device
    depths = _psv_depths(cfg, dev)
    assembly = HRES_ASSEMBLY[cfg.which_color_pred]
    u_bg = (msi_lib.upsample_align_corners_cf(bg_rgb.permute(0, 3, 1, 2),
                                              hh, hw)
            if assembly == "blend_bg" else None)
    ref = msi_lib.preprocess_image(hres_ref)
    src = msi_lib.preprocess_image(hres_src)
    eye = _eye(b, dev)
    rgb = torch.zeros((b, hh, hw, 3), device=dev)
    dep = torch.zeros((b, hh, hw, 3), device=dev)
    trans = torch.ones((b, hh, hw, 1), device=dev)
    for s in range(p - 1, -1, -1):
        d = depths[s:s + 1]
        if poses is None:
            images, rowp = sweep_ops.sweep_inputs(ref, src, d, intrinsics)
            vol = sweep_ops.ods_sweep_plain(images, rowp, torch.float32)
        else:
            vol = sweep_lib.format_network_input(
                ref, src, *poses, d, intrinsics).permute(0, 3, 1, 2)
        low = [alphas[..., s]] + ([blend_weights[..., s]]
                                  if assembly != "alpha_only" else [])
        wa = msi_lib.upsample_align_corners_cf(torch.stack(low, dim=1), hh,
                                               hw)
        layer = msi_lib.assemble_hres_prepared(
            assembly, wa[:, 1:] if assembly != "alpha_only" else None,
            wa[:, :1], vol, u_bg_rgb=u_bg, dtype=torch.float32)
        u, v = render_lib.uv_tables(eye, tgt_pose, d, hh, hw)
        for i in range(b):
            img = resample_layers_uv(layer[i, 0][None], u[i], v[i])[0]
            a = img[..., 3:] if s > 0 else 1.0
            rgb[i] += img[..., :3] * a * trans[i]
            dep[i] += (s / p) * a * trans[i]
            trans[i] *= 1.0 - a
    return msi_lib.deprocess_image(rgb), dep


def save_outputs(cfg: MatryConfig, out_dir: str, dirname: str, batch, outs,
                 test_outputs: str):
    """Write the outputs (numpy, batch 1) under the JAX CLI's names
    (matryodshka_tpu/cli/test.py:save_outputs)."""
    os.makedirs(out_dir, exist_ok=True)
    if "tgt_image" in test_outputs:
        write_image(f"{out_dir}/tgt_image_{dirname}.png",
                    batch["tgt_image"][0] * 255.0)
        write_image(f"{out_dir}/output_tgt_{dirname}.png",
                    outs["output_image"][0] * 255.0)
        if "output_depth" in outs:
            write_image(f"{out_dir}/output_depth_{dirname}.png",
                        outs["output_depth"][0] * 255.0)
    for key in ("src_image", "ref_image"):
        if key in test_outputs:
            write_image(f"{out_dir}/{key}_{dirname}.png",
                        batch[key][0] * 255.0)
    if "psp" in test_outputs:
        for win in range(4):
            write_image(f"{out_dir}/output_ptgt{win}_{dirname}.png",
                        outs[f"output_psp{win}"][0] * 255.0)
    for key, name in (("src_output_image", "src"),
                      ("ref_output_image", "ref")):
        if key in test_outputs:
            write_image(f"{out_dir}/output_{name}_{dirname}.png",
                        outs[f"output_{name}"][0] * 255.0)
    if "psv" in outs:
        psv = outs["psv"][0]
        for j in range(cfg.num_psv_planes):
            write_image(f"{out_dir}/psv_plane_{j:03d}.png",
                        (psv[:, :, j * 3:(j + 1) * 3] + 1) / 2 * 255)
    if "blend_weights" in outs:
        np.save(f"{out_dir}/blend_weights.npy", outs["blend_weights"])
        for i in range(cfg.num_msi_planes):
            write_image(f"{out_dir}/blend_weight_{i:03d}.png",
                        outs["blend_weights"][0, :, :, i] * 255.0)
    if "alphas" in outs:
        np.save(f"{out_dir}/alphas.npy", outs["alphas"])
    if "bg_rgb" in outs:
        np.save(f"{out_dir}/bg_rgb.npy", outs["bg_rgb"])
    if "rgba_layers" in outs:
        rgba = outs["rgba_layers"][0]
        for i in range(cfg.num_msi_planes):
            write_image(f"{out_dir}/msi_alpha_{i:02d}.png",
                        rgba[:, :, i, 3] * 255.0)
            write_image(f"{out_dir}/msi_rgb_{i:02d}.png",
                        (rgba[:, :, i, :3] + 1) / 2 * 255.0)


def example_dirname(batch, video: bool, prefix: str) -> str:
    dirname = ""
    if video:
        dirname += "video_"
        if prefix:
            dirname += f"{prefix}_"
    dirname += batch["scene_id"][0]
    dirname += "_" + "".join(batch["image_ids"][0])
    return dirname


def _to_device(batch, device):
    return {k: torch.from_numpy(v).to(device) for k, v in batch.items()
            if isinstance(v, np.ndarray)}


def _to_numpy(t):
    return t.float().cpu().numpy()


def main(argv=None):
    parser = argparse.ArgumentParser(description="matryodshka test (torch)")
    add_config_args(parser)
    parser.add_argument("--test_type", type=str, default="")
    parser.add_argument("--prefix", type=str, default="")
    parser.add_argument("--test_outputs", type=str,
                        default=DEFAULT_TEST_OUTPUTS)
    parser.add_argument("--num_runs", type=int, default=-1)
    parser.add_argument("--params", type=str, default="",
                        help=".npz of the flax parameter tree; empty: the "
                             "latest checkpoint under "
                             "<checkpoint_dir>/<experiment_name>")
    parser.add_argument("--device", type=str, default="cuda")
    args = parser.parse_args(argv)
    cfg = config_from_args(args)
    if cfg.batch_size != 1:
        raise ValueError("batch_size must be 1 when testing")
    device = torch.device(args.device)
    rank, world = 0, 1
    if cfg.shard_shells:
        # started as ranks (torchrun): the high-res shells split over
        # them; in one process the JAX CLI's one-device case, ignored
        # (cli/test.py:452)
        rank_device = mesh.init_from_env(device.type)
        if rank_device is not None:
            device = rank_device
            rank, world = mesh.rank_and_size()

    if args.params:
        tree, step = restore_params(args.params)
        print(f"[test] restored {args.params} @ step {step}")
    else:
        tree, step = CheckpointManager(os.path.join(
            cfg.checkpoint_dir, cfg.experiment_name)).restore_params()
        print(f"[test] restored checkpoint @ step {step}")
    params = entry.make_params(cfg, flax_params=tree, device=device)

    out_root = os.path.join(cfg.output_root, cfg.experiment_name)
    if rank == 0:
        os.makedirs(out_root, exist_ok=True)
        with open(os.path.join(out_root, "step.txt"), "w") as fh:
            fh.write(str(step))

    video = "on_video" in args.test_type
    outputs = args.test_outputs
    if cfg.which_color_pred == "blend_bg" and "blend_weights" in outputs:
        # blend_bg's high-res re-render also reads its background colour
        outputs += "_bg_rgb"
    if "high_res_only" not in args.test_type and rank == 0:
        loader = make_loader(cfg, training=False)
        infer = build_infer_fn(cfg, params, outputs)
        for run, batch in enumerate(loader.batches()):
            if 0 <= args.num_runs <= run:
                break
            outs = infer(_to_device(batch, device))
            outs = {k: _to_numpy(v) for k, v in outs.items()}
            dirname = example_dirname(batch, video, args.prefix)
            out_dir = os.path.join(out_root, dirname)
            print(f"[test] saving to {out_dir}")
            save_outputs(cfg, out_dir, dirname, batch, outs, outputs)

    if "high_res" in args.test_type:
        if cfg.input_type != "ODS":
            raise ValueError("high_res re-renders an ODS MSI (JAX "
                             "cli/test.py:447)")
        if world > 1:
            dist.barrier()      # rank 0's low-res outputs are written
            if rank == 0:
                print(f"[test] sharding {cfg.num_psv_planes} shells over "
                      f"{world} ranks")
        loader = OdsLoader(cfg, training=False, load_hres=True)
        render = build_hres_render_fn(cfg, shards=world)
        for run, batch in enumerate(loader.batches()):
            if 0 <= args.num_runs <= run:
                break
            dirname = example_dirname(batch, video, args.prefix)
            out_dir = os.path.join(out_root, dirname)
            t = _to_device(batch, device)
            low = {k: torch.from_numpy(np.load(os.path.join(
                out_dir, f"{k}.npy"))).to(device)
                for k in hres_inputs(cfg.which_color_pred)}
            rgb, depth = render(t["hres_ref_image"], t["hres_src_image"],
                                low.get("blend_weights"), low["alphas"],
                                t["ref_pose"], t["src_pose"],
                                t["ref_pose_inv"], t["intrinsics"],
                                t["tgt_pose"], bg_rgb=low.get("bg_rgb"))
            if rank:
                continue
            print(f"[test] saving hres render to {out_dir}")
            write_image(f"{out_dir}/output_hrestgt_{dirname}.png",
                        _to_numpy(rgb[0]) * 255.0)
            write_image(f"{out_dir}/output_hresdepth_{dirname}.png",
                        _to_numpy(depth[0]) * 255.0)


if __name__ == "__main__":
    main()
