"""The served path on RealEstate10K input: `entry.forward` on a
REALESTATE_PP batch runs the planar route (gather sweep, the coord net,
the assembly and the MPI render), held to the benchmark's plain reference
(`msi_bench/reference/mpi.py`) and to the test CLI's `infer_mpi`; its
spans; and the ODS branch left as it was.

The file imports neither JAX nor the JAX package. On the CPU the net runs
its plain route; the test marked `cuda` runs the kernels at batch 4:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_mpi_entry.py
"""

from __future__ import annotations

import json
import math
import os
import tempfile

import pytest
import torch

from matryodshka_tpu_torch import entry, trace
from matryodshka_tpu_torch.models import msi as msi_lib
from msi_bench import reference, seeding
from msi_bench.reference import mpi, quant
from msi_bench.reference.geometry import inv_depths

H, W, P, NGF = 32, 64, 4, 8
#: bf16 compute against the f32 reference at this size reads ~6e-3 widest
#: and ~8e-4 mean (the volume, the net's stores and the layers rounded to
#: bf16); the same reference with those stores rounded to fp8 e4m3 reads
#: 0.13 / 0.012 or more, so each limit sits 3-5x from both.
BF16_MAX, BF16_MEAN = 0.03, 0.003
#: f32 compute: the same equations in another order of operations (the
#: conv as F.conv2d against the port's plain conv) read ~6e-6.
F32_MAX = 1e-4


def _cfg(dtype="bfloat16", b=2):
    return entry.flagship_cfg(height=H, width=W, num_psv_planes=P,
                              num_msi_planes=P, ngf=NGF, batch_size=b,
                              input_type="REALESTATE_PP", coord_net=True,
                              compute_dtype=dtype)


def _setup(cfg, dev, seed=5):
    """(seeded flax-layout tree, params, batch): a different src baseline,
    target position and rotation per example."""
    b = cfg.batch_size
    gen = seeding.generator(seed, dev)
    tree = seeding.weight_tree(reference.unet.layer_shapes(
        NGF, cfg.num_net_inputs(), cfg.num_net_outputs(), "coord"), gen, dev)
    params = entry.make_params(cfg, flax_params=seeding.to_numpy(tree),
                               device=dev)
    eye = torch.eye(4, device=dev).repeat(b, 1, 1)
    src, tgt = eye.clone(), eye.clone()
    src[:, 0, 3] = -torch.linspace(0.08, 0.2, b, device=dev)
    tgt[:, :3, 3] = torch.tensor([0.05, -0.02, 0.03], device=dev) \
        * torch.linspace(1.0, -1.0, b, device=dev)[:, None]
    for i in range(b):
        a = math.radians(4.0) * (i + 1) / b
        tgt[i, :3, :3] = torch.tensor([[math.cos(a), 0.0, math.sin(a)],
                                       [0.0, 1.0, 0.0],
                                       [-math.sin(a), 0.0, math.cos(a)]],
                                      device=dev)
    k = torch.tensor([[0.9 * W, 0.0, 0.5 * W], [0.0, 1.2 * H, 0.5 * H],
                      [0.0, 0.0, 1.0]], device=dev).repeat(b, 1, 1)
    batch = {"ref_image": torch.rand((b, H, W, 3), generator=gen, device=dev),
             "src_image": torch.rand((b, H, W, 3), generator=gen, device=dev),
             "ref_pose": eye, "ref_pose_inv": eye, "src_pose": src,
             "tgt_pose": tgt, "intrinsics": k}
    return tree, params, batch


def _gaps(tree, batch, out, q=None):
    """(widest, mean) of each example's view against the reference's,
    worst over the batch; with q the reference through q in out's place."""
    d = torch.tensor(inv_depths(1.0, 100.0, P), device=out.device)
    widest = mean = 0.0
    for i in range(out.shape[0]):
        args = (tree, NGF, batch["ref_image"][i], batch["src_image"][i],
                batch["ref_pose"][i], batch["src_pose"][i],
                batch["tgt_pose"][i], batch["intrinsics"][i], d, d)
        want = mpi.mpi_view(*args)
        got = out[i] if q is None else mpi.mpi_view(*args, q=q)
        gap = (got - want).abs()
        widest, mean = max(widest, gap.max().item()), max(mean,
                                                          gap.mean().item())
    return widest, mean


def test_forward_f32_matches_the_reference():
    tree, params, batch = _setup(_cfg("float32"), "cpu")
    out = entry.forward(params, batch)
    assert out.shape == (2, H, W, 3) and out.dtype == torch.float32
    widest, _ = _gaps(tree, batch, out)
    assert widest <= F32_MAX


def test_forward_bf16_is_within_limits_the_fp8_control_fails():
    tree, params, batch = _setup(_cfg(), "cpu")
    out = entry.forward(params, batch)
    widest, mean = _gaps(tree, batch, out)
    assert widest <= BF16_MAX and mean <= BF16_MEAN, (widest, mean)
    widest, mean = _gaps(tree, batch, out, q=quant.fp8)
    assert widest > BF16_MAX and mean > BF16_MEAN, (widest, mean)


def test_forward_is_the_test_clis_infer_mpi():
    cfg = _cfg()
    _, params, batch = _setup(cfg, "cpu")
    got = entry.forward(params, batch)
    want = msi_lib.infer_mpi(cfg, params.stages, batch, params.psv_depths,
                             params.msi_depths)["output_image"]
    assert torch.equal(got, want)


def test_forward_refuses_a_target_rotation_for_planar_input():
    _, params, batch = _setup(_cfg(), "cpu")
    with pytest.raises(ValueError, match="tgt_pose_rt"):
        entry.forward(params, batch, torch.eye(4).repeat(2, 1, 1))


@pytest.mark.parametrize("coord", [False, True])
def test_ods_forward_is_its_three_stages(coord):
    """The ODS branch: the sweep, the net and the blend-fused render, as
    before the planar route, bit for bit, with and without a rotation."""
    cfg = entry.flagship_cfg(height=H, width=W, num_psv_planes=P,
                             num_msi_planes=P, ngf=NGF, batch_size=2,
                             coord_net=coord)
    params = entry.make_params(cfg, seed=3, device="cpu")
    batch = entry.synthetic_batch(cfg, 3, "cpu", tgt_pos=(0.03, 0.01, 0.0))
    rot = torch.eye(4).repeat(2, 1, 1)
    rot[1, :3, :3] = torch.tensor([[0.0, 0.0, 1.0], [0.0, 1.0, 0.0],
                                   [-1.0, 0.0, 0.0]])
    for rt in (None, rot):
        got = entry.forward(params, batch, rt)
        vol = msi_lib.sweep_stage(cfg, batch, params.psv_depths)
        pred = msi_lib.net_stage(params.stages, vol)
        want = msi_lib.render_stage(
            vol, pred, torch.eye(4).expand(2, 4, 4) if rt is None else rt,
            batch["tgt_pose"], params.msi_depths)
        assert torch.equal(got, want)


def test_planar_spans_nest_in_a_traced_forward():
    _, params, batch = _setup(_cfg(), "cpu")
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        entry.forward(params, batch)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as fh:
            events = json.load(fh)["traceEvents"]
    spans = {}
    for e in events:
        if e.get("ph") == "X" and e.get("cat") == trace.SPAN_CAT:
            spans.setdefault(e["name"], []).append((e["ts"],
                                                    e["ts"] + e["dur"]))
    for name in ("entry.forward", "msi.sweep_stage", "msi.mpi_sweep",
                 "msi.net_stage", "msi.mpi_render_stage"):
        assert len(spans.get(name, ())) == 1, name
    assert "msi.render_stage" not in spans

    def inside(inner, outer):
        (a, b), = spans[inner]
        (c, d), = spans[outer]
        return c <= a and b <= d

    assert inside("msi.mpi_sweep", "msi.sweep_stage")
    for name in ("msi.sweep_stage", "msi.net_stage", "msi.mpi_render_stage"):
        assert inside(name, "entry.forward")


@pytest.mark.cuda
def test_forward_on_the_card_at_batch_4():
    """The planar route on the card at batch 4 (the conv kernel in coord
    mode reads the 3 + 6P inputs and the coord channel at conv1_1), each
    view within the bf16 limits of the reference."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    tree, params, batch = _setup(_cfg(b=4), torch.device("cuda"))
    assert params.stages[0]["w"].shape[1] == 9 * (3 + 6 * P + 1)
    out = entry.forward(params, batch)
    torch.cuda.synchronize()
    assert out.shape == (4, H, W, 3) and bool(torch.isfinite(out).all())
    widest, mean = _gaps(tree, batch, out)
    assert widest <= BF16_MAX and mean <= BF16_MEAN, (widest, mean)
