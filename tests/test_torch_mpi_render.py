"""The blend-fused MPI render's plain version and the routes around its
kernel, on the CPU (`ops/mpi_render.py`; the kernel itself,
`csrc/mpi_render.cu`, is held to this plain version by the `cuda` tests
of `tests/test_torch_kernels_cuda.py`).

* The plain version is assemble_rgba("blend_psv") in float32 followed by
  render_mpi_view, within 1e-6 (the same arithmetic with the blend's
  layout changed), for 6P and 6P + 3 volume channels, near, outside and
  edge-on poses.
* `mpi_homographies`, the port's one form of the plane homography, holds
  to the JAX package's inv_homography at a float32 tolerance, and to the
  kernel's own steps bit for bit.
* On the CPU `mpi_render_stage` keeps its route (assemble_train, then
  `msi_lib.render_mpi_view`, looked up on the module) for every scheme,
  and the test CLI's kernel route keeps its outputs' keys and values.
* Where the stage takes the kernel (blend_psv on the card: stood in for
  here by the plain version), the CLI assembles the layers only for the
  outputs that need them, with the same values.
"""

from __future__ import annotations

import math

import numpy as np
import pytest
import torch

from matryodshka_tpu_torch import entry
from matryodshka_tpu_torch.cli import test as cli_test
from matryodshka_tpu_torch.geometry import homography
from matryodshka_tpu_torch.geometry.sweep import inv_depths
from matryodshka_tpu_torch.models import msi as msi_lib
from matryodshka_tpu_torch.ops import mpi_render

H, W, P, NGF = 32, 128, 4, 8


def _yaw_pitch(yaw, pitch):
    cy, sy, cp, sp = (math.cos(yaw), math.sin(yaw), math.cos(pitch),
                      math.sin(pitch))
    ry = torch.tensor([[cy, 0.0, sy], [0.0, 1.0, 0.0], [-sy, 0.0, cy]])
    rx = torch.tensor([[1.0, 0.0, 0.0], [0.0, cp, -sp], [0.0, sp, cp]])
    return ry @ rx


def _case(b, c, kind, seed=0):
    """vol [b, c, H, W] and pred [b, 2P, H, W] uniform in [-1, 1], target
    poses [b, 4, 4], intrinsics [b, 3, 3], depths [P] (1-100 m). near: a
    viewer's head motion; outside: 0.7 m and 25 degrees off, so most near
    taps fall outside the image; edge_on: the target turned 90 degrees
    about y with a wide field of view (f = W/4), so the planes are seen
    edge-on down the middle column (coordinates beyond any integer) and
    obliquely beside it."""
    g = torch.Generator().manual_seed(seed)
    vol = torch.rand((b, c, H, W), generator=g) * 2 - 1
    pred = torch.rand((b, 2 * P, H, W), generator=g) * 2 - 1
    f = (W / 4, W / 4) if kind == "edge_on" else (0.9 * W, 1.2 * H)
    k = torch.tensor([[f[0], 0.0, W / 2], [0.0, f[1], H / 2],
                      [0.0, 0.0, 1.0]]).repeat(b, 1, 1)
    pose = torch.eye(4).repeat(b, 1, 1)
    for i in range(b):
        s = (i + 1) / b
        if kind == "near":
            pose[i, :3, :3] = _yaw_pitch(math.radians(4 * s),
                                         math.radians(-3 * s))
            pose[i, :3, 3] = torch.tensor([0.06, -0.03, 0.05]) * s
        elif kind == "outside":
            pose[i, :3, :3] = _yaw_pitch(math.radians(25 * s),
                                         math.radians(10))
            pose[i, :3, 3] = torch.tensor([0.6, -0.3, 0.2]) * s
        else:
            pose[i, :3, :3] = torch.tensor([[0.0, 0.0, 1.0], [0.0, 1.0, 0.0],
                                            [-1.0, 0.0, 0.0]])
            pose[i, :3, 3] = torch.tensor([0.0, 0.02, 0.0]) * s
    depths = torch.tensor(inv_depths(1.0, 100.0, P), dtype=torch.float32)
    return vol, pred, pose, k, depths


def _cfg(scheme="blend_psv", dtype="float32", b=1):
    return entry.flagship_cfg(height=H, width=W, num_psv_planes=P,
                              num_msi_planes=P, ngf=NGF, batch_size=b,
                              input_type="REALESTATE_PP", coord_net=True,
                              compute_dtype=dtype, which_color_pred=scheme)


@pytest.mark.parametrize("kind", ["near", "outside", "edge_on"])
@pytest.mark.parametrize("b,c", [(1, 6 * P), (3, 6 * P + 3)])
def test_plain_is_the_assembly_then_render_mpi_view(b, c, kind):
    vol, pred, pose, k, depths = _case(b, c, kind)
    got = mpi_render.render_mpi_blend_plain(vol, pred, pose, k, depths)
    layers = msi_lib.assemble_train(_cfg(), vol, pred)["rgba_layers"]
    want = msi_lib.render_mpi_view(layers, pose, depths, k)
    assert got.shape == (b, H, W, 3) and got.dtype == torch.float32
    assert (got - want).abs().max().item() <= 1e-6
    assert got.abs().max().item() > 0.1


def test_edge_on_case_reaches_coordinates_beyond_any_integer():
    """The edge-on case holds what the kernel decides in float: samples
    whose coordinates exceed 2^31, beside samples inside the image."""
    _, _, pose, k, depths = _case(1, 6 * P, "edge_on")
    hom = homography.mpi_homographies(k, torch.linalg.inv(k), pose, depths)
    grid = homography.meshgrid_abs(H, W).permute(1, 2, 0).expand(
        1, P, H, W, 3)
    uv = homography.normalize_homogeneous(
        homography.transform_points(grid, hom))
    far = (uv.abs() > 2.0 ** 31).any(-1)
    inside = ((uv[..., 0] >= 0) & (uv[..., 0] <= W - 1)
              & (uv[..., 1] >= 0) & (uv[..., 1] <= H - 1))
    assert far.any() and inside.float().mean().item() > 0.3


def _kernel_homography_entry(pose, k, kinv, depth, r, c):
    """csrc/mpi_render.cu's homography_entry in numpy float32 scalars, one
    rounding a step as the kernel's __fmul_rn, __fadd_rn, ... take them."""
    f = np.float32
    pose, k, kinv = (np.ascontiguousarray(x, np.float32).reshape(-1)
                     for x in (pose, k, kinv))
    rtt = [(pose[j] * pose[3] + pose[4 + j] * pose[7]) + pose[8 + j]
           * pose[11] for j in range(3)]
    den = f(-depth) - rtt[2]
    den = f(1e-8) if den == 0 else den
    h = None
    for q in range(3):
        km = None
        for j in range(3):
            term = k[r * 3 + j] * (pose[q * 4 + j]
                                   + (rtt[j] * pose[q * 4 + 2]) / den)
            km = term if j == 0 else km + term
        h = km * kinv[q * 3 + c] if q == 0 else h + km * kinv[q * 3 + c]
    return h


@pytest.mark.parametrize("kind", ["near", "outside", "edge_on"])
def test_mpi_homographies_take_the_kernels_steps(kind):
    """mpi_homographies (the plain route's matrices) bit for bit against
    the kernel's steps, so that the kernel warps by the same matrices."""
    _, _, pose, k, depths = _case(3, 6 * P, kind, seed=4)
    pose[:, :3, 3] += torch.randn((3, 3), generator=torch.Generator()
                                  .manual_seed(4)) * 0.05
    kinv = torch.linalg.inv_ex(k).inverse
    got = homography.mpi_homographies(k, kinv, pose, depths).numpy()
    for b in range(3):
        for p in range(P):
            want = [[_kernel_homography_entry(
                pose[b].numpy(), k[b].numpy(), kinv[b].numpy(),
                depths[p].item(), r, c) for c in range(3)] for r in range(3)]
            assert np.array_equal(got[b, p], np.asarray(want, np.float32))


@pytest.mark.parametrize("kind", ["near", "outside", "edge_on"])
def test_mpi_homographies_match_jax_inv_homography(kind):
    """mpi_homographies (the port's only form of the plane homography)
    against the JAX package's inv_homography with n_hat = +z and
    a = -depth, at a float32 tolerance: the same matrices, their sums in
    another order."""
    import jax.numpy as jnp
    from matryodshka_tpu.geometry import homography as jhom

    _, _, pose, k, depths = _case(3, 6 * P, kind, seed=5)
    pose[:, :3, 3] += torch.randn((3, 3), generator=torch.Generator()
                                  .manual_seed(5)) * 0.05
    kinv = torch.linalg.inv(k)
    got = homography.mpi_homographies(k, kinv, pose, depths).numpy()

    def per_example(x):
        return jnp.asarray(x.numpy())[:, None]

    want = np.asarray(jhom.inv_homography(
        per_example(k), per_example(kinv), per_example(pose[:, :3, :3]),
        per_example(pose[:, :3, 3:]), jnp.asarray([[0.0, 0.0, 1.0]]),
        jnp.asarray(-depths.numpy()).reshape(1, P, 1, 1)))
    assert got.shape == want.shape == (3, P, 3, 3)
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-6 * np.abs(want).max())


def test_render_mpi_blend_on_the_cpu_is_its_plain_version():
    vol, pred, pose, k, depths = _case(2, 6 * P + 3, "near", seed=1)
    n = mpi_render.launches
    got = mpi_render.render_mpi_blend(vol, pred, pose, k, depths)
    want = mpi_render.render_mpi_blend_plain(vol, pred, pose, k, depths)
    assert torch.equal(got, want) and mpi_render.launches == n


def _setup(cfg, seed=2):
    params = entry.make_params(cfg, seed=seed, device="cpu")
    return params, entry.synthetic_batch(cfg, seed, "cpu")


@pytest.mark.parametrize("scheme", ["blend_psv", "alpha_only"])
def test_mpi_render_stage_on_the_cpu_calls_render_mpi_view(monkeypatch,
                                                           scheme):
    cfg = _cfg(scheme, "bfloat16", b=2)
    params, batch = _setup(cfg)
    vol = msi_lib.sweep_stage(cfg, batch, params.psv_depths)
    pred = msi_lib.net_stage(params.stages, vol)
    calls = []
    render = msi_lib.render_mpi_view

    def spy(*args):
        calls.append(args)
        return render(*args)

    monkeypatch.setattr(msi_lib, "render_mpi_view", spy)
    n = mpi_render.launches
    outs = msi_lib.mpi_render_stage(cfg, vol, pred, batch, params.msi_depths)
    assert len(calls) == 1 and mpi_render.launches == n
    assert set(outs) == {"vol", "pred", "output_image"}
    layers = msi_lib.assemble_train(cfg, vol, pred)["rgba_layers"]
    assert calls[0][0].dtype == torch.bfloat16
    assert torch.equal(calls[0][0], layers)
    assert torch.equal(outs["output_image"], render(*calls[0]))


ALL_OUTPUTS = "tgt_image_rgba_layers_blend_weights_alphas_psv"


def _lean_stage(cfg, vol, pred, batch, msi_depths):
    """mpi_render_stage's kernel route, its kernel stood in for by the
    plain version."""
    return {"vol": vol, "pred": pred,
            "output_image": mpi_render.render_mpi_blend(
                vol, pred, msi_lib.mpi_view_pose(batch), batch["intrinsics"],
                msi_depths)}


def test_cli_kernel_route_keeps_its_outputs_on_the_cpu():
    cfg = _cfg(b=2)
    params, batch = _setup(cfg)
    got = cli_test.build_infer_fn(cfg, params, ALL_OUTPUTS)(batch)
    assert set(got) == {"output_image", "rgba_layers", "blend_weights",
                        "alphas", "psv"}
    vol = msi_lib.sweep_stage(cfg, batch, params.psv_depths)
    pred = msi_lib.net_stage(params.stages, vol)
    asm = msi_lib.assemble_train(cfg, vol, pred)
    for key in ("rgba_layers", "blend_weights", "alphas", "psv"):
        assert torch.equal(got[key], asm[key]), key
    want = msi_lib.render_mpi_view(asm["rgba_layers"],
                                   msi_lib.mpi_view_pose(batch),
                                   params.msi_depths, batch["intrinsics"])
    assert torch.equal(got["output_image"], msi_lib.deprocess_image(want))


@pytest.mark.parametrize("route", ["kernel", "plain"])
@pytest.mark.parametrize("outputs,assembles",
                         [("tgt_image", False), (ALL_OUTPUTS, True),
                          ("tgt_image_alphas", True), ("psv", True)])
def test_cli_assembles_after_the_kernel_route_only_on_demand(
        monkeypatch, outputs, assembles, route):
    """The CLI assembles the layers for its outputs only when asked, after
    either route of the stage (the plain route assembles once for its
    render)."""
    cfg = _cfg(b=2)
    params, batch = _setup(cfg)
    want = cli_test.build_infer_fn(cfg, params, outputs)(batch)
    calls = []
    assemble = msi_lib.assemble_train

    def spy(*args):
        calls.append(args)
        return assemble(*args)

    if route == "kernel":
        monkeypatch.setattr(msi_lib, "mpi_render_stage", _lean_stage)
    monkeypatch.setattr(msi_lib, "assemble_train", spy)
    got = cli_test.build_infer_fn(cfg, params, outputs)(batch)
    assert len(calls) == int(assembles) + int(route == "plain")
    assert set(got) == set(want)
    for key, val in want.items():
        if key == "output_image":
            assert (got[key] - val).abs().max().item() <= 1e-6
        else:
            assert torch.equal(got[key], val), key
