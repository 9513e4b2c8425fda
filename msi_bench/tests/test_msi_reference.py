"""The benchmark's reference against the port's plain path at a small size:
the video frame (sweep, U-Net, blend-fused render) and the high-res
re-render (sweep, upsample, blend_psv assembly, colour and depth), both
nets, in float32 on the CPU."""

from __future__ import annotations

import math

import pytest
import torch

import msi_tiny  # noqa: F401  (puts the repository on sys.path)
from matryodshka_tpu_torch import entry
from matryodshka_tpu_torch.cli import test as cli_test
from msi_bench import reference
from msi_bench.reference import geometry, unet

TOL = 1e-5


def _tree(variant, gen):
    shapes = unet.layer_shapes(8, 24, 8, variant)
    return {layer: {leaf: torch.randn(s, generator=gen)
                    * (0.3 if leaf == "kernel" else 0.1)
                    + (1.0 if leaf == "gamma" else 0.0)
                    for leaf, s in leaves.items()}
            for layer, leaves in shapes.items()}


def _cfg(coord):
    return entry.flagship_cfg(height=32, width=64, num_psv_planes=4,
                              num_msi_planes=4, ngf=8, coord_net=coord,
                              compute_dtype="float32", hres_height=64,
                              hres_width=128)


@pytest.mark.parametrize("coord", [False, True])
def test_video_view_matches_the_port_plain_path(coord):
    gen = torch.Generator().manual_seed(3)
    cfg = _cfg(coord)
    tree = _tree(cfg.net_variant, gen)
    params = entry.make_params(cfg, flax_params={"params": {
        k: {leaf: t.numpy() for leaf, t in v.items()}
        for k, v in tree.items()}}, device="cpu")
    batch = entry.synthetic_batch(cfg, 5, "cpu", tgt_pos=(0.02, -0.01, 0.03))
    yaw = 0.7
    rot = torch.eye(4)
    rot[0, 0] = rot[2, 2] = math.cos(yaw)
    rot[0, 2], rot[2, 0] = math.sin(yaw), -math.sin(yaw)
    want = entry.forward_plain(params, batch, rot[None])[0]
    depths = torch.tensor(geometry.inv_depths(1.0, 100.0, 4))
    got = reference.video_view(tree, cfg.net_variant, 8, batch["ref_image"][0],
                               batch["src_image"][0], depths, depths, 0.032,
                               rot, batch["tgt_pose"][0])
    assert (got - want).abs().max().item() <= TOL


def test_hres_render_matches_the_port_plain_path():
    gen = torch.Generator().manual_seed(4)
    cfg = _cfg(True)
    ref, src = (torch.rand((1, 64, 128, 3), generator=gen) for _ in "ab")
    blend, alphas = (torch.sigmoid(2 * torch.randn((1, 32, 64, 4),
                                                   generator=gen))
                     for _ in "ab")
    intr = torch.eye(3)[None].clone()
    intr[0, 0, 0] = 0.032
    pos = torch.tensor([[0.01, 0.02, -0.03]])
    rgb, depth = cli_test.hres_render_plain(cfg, ref, src, blend, alphas,
                                            intr, pos)
    depths = torch.tensor(geometry.inv_depths(1.0, 100.0, 4))
    got_rgb, got_depth = reference.hres_render(ref[0], src[0], blend[0],
                                               alphas[0], depths, 0.032,
                                               pos[0])
    assert (got_rgb - rgb[0]).abs().max().item() <= TOL
    assert (got_depth - depth[0]).abs().max().item() <= TOL


def test_fp8_control_rounds_to_e4m3_with_one_scale():
    from msi_bench.reference.quant import fp8
    x = torch.tensor([448.0, 1.0, -3.0, 0.1])
    assert torch.equal(fp8(x), x.to(torch.float8_e4m3fn).float())
    y = torch.linspace(-1, 1, 101)
    err = (fp8(y) - y).abs().max().item()
    assert 0 < err <= 2 ** -4 * 1.0
