"""The port's whole inference slice against the JAX package, on CPU.

entry.forward (sweep -> U-Net -> blend-fused render; on CPU tensors every
kernel wrapper runs its plain version) and entry.forward_reference (gather
sweep, MSIUNet, gather render) against:

* bench.py's e2e_reference (infer_msi + render_equirect_view with
  use_pallas=False) at 32x64, 4 planes, ngf 8, float32;
* the JAX hot path with K1's semantics: infer_msi_prepared(interpret=True,
  fused_net=None) + render_equirect_view_from_prepared(interpret=True),
  as tests/test_prepared_path.py runs it, at 96x128 (its ladder render
  needs W % 128 == 0).

Same flax weights (init_state -> weights.from_flax) and the same numpy
images in both.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from matryodshka_tpu.config import MatryConfig as JaxConfig
from matryodshka_tpu.geometry import sweep as jsweep
from matryodshka_tpu.models import msi as jmsi
from matryodshka_tpu.training import state as state_lib
from matryodshka_tpu_torch import entry
from matryodshka_tpu_torch.models import msi as tmsi
from matryodshka_tpu_torch.ops import conv as conv_ops
from matryodshka_tpu_torch.ops import render as render_ops
from matryodshka_tpu_torch.ops import render_layers as rl_ops
from matryodshka_tpu_torch.ops import sweep as sweep_ops

torch.set_num_threads(1)

P, NGF = 4, 8
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _setup(h, w, max_depth):
    jcfg = JaxConfig(height=h, width=w, num_psv_planes=P, num_msi_planes=P,
                     ngf=NGF, compute_dtype="float32", max_depth=max_depth,
                     use_pallas=True).validate()
    state, model = state_lib.init_state(jcfg, jax.random.PRNGKey(0))
    tcfg = entry.flagship_cfg(height=h, width=w, num_psv_planes=P,
                              num_msi_planes=P, ngf=NGF,
                              compute_dtype="float32", max_depth=max_depth)
    params = entry.make_params(
        tcfg, flax_params=jax.tree.map(np.asarray, state.params), device="cpu")
    batch = entry.synthetic_batch(tcfg, seed=0, device="cpu")
    jbatch = {k: jnp.asarray(v.numpy()) for k, v in batch.items()}
    depths = jnp.asarray(jsweep.inv_depths(1.0, max_depth, P))
    return jcfg, state, model, params, batch, jbatch, depths


@pytest.fixture(scope="module", params=[20.0, 100.0])
def e2e(request):
    """bench.py e2e_reference on a 32x64 batch, with shells out to
    max_depth; returns the JAX render and psv plus the port's inputs."""
    jcfg, state, model, params, batch, jbatch, depths = _setup(
        32, 64, request.param)
    outs = jmsi.infer_msi(lambda p, x: model.apply(p, x), state.params, jcfg,
                          jbatch, depths)
    ref = jmsi.render_equirect_view(outs["rgba_layers"].astype(jnp.float32),
                                    jnp.eye(4)[None], jbatch["tgt_pose"],
                                    depths, use_pallas=False)
    return (request.param, params, batch, np.asarray(ref),
            np.array(outs["psv"]))


@pytest.mark.parametrize("path", ["forward", "forward_reference"])
def test_slice_matches_e2e_reference(e2e, path):
    """Shells out to 20 m: each package's f32 projection carries ~2.5e-5 *
    depth px of noise (test_torch_geometry), <= 5e-4 px here, which moves
    the sweep by ~1e-3 and the render, through the random net, by up to
    measured 8.3e-4: bound 2e-3.

    Shells out to 100 m (the flagship range): the gather sweep parks single
    far-shell pixels where the tangent quadratic's discriminant is f32
    noise, differently in the two packages (PARITY.md park-flip noise), and
    the random net spreads each flip over its receptive field. The JAX
    package's own hot path differs from this same reference by a mean of
    9.3e-3 (max 0.90) at 96x128. Measured here: mean 1.3e-2 to 1.6e-2,
    median 4.2e-3 to 4.8e-3; bounds: mean 3e-2, median 1e-2."""
    max_depth, params, batch, ref, _ = e2e
    got = getattr(entry, path)(params, batch).numpy()
    assert got.shape == ref.shape == (1, 32, 64, 3)
    assert np.isfinite(got).all()
    err = np.abs(got - ref)
    if max_depth <= 20.0:
        assert err.max() < 2e-3, err.max()
    else:
        assert err.mean() < 3e-2, err.mean()
        assert np.median(err) < 1e-2, np.median(err)


def test_post_sweep_matches_jax_on_same_psv(e2e):
    """Fed the JAX reference's own sweep volume, the port's net, assembly
    and gather render match it to 2e-4 (18 f32 layers, then a composite
    of values in [-1, 1]; measured 6e-5): every gap above is the sweep's."""
    _, params, batch, ref, psv = e2e
    psv_t = torch.from_numpy(psv)
    with torch.no_grad():
        pred = params.net(psv_t.permute(0, 3, 1, 2), dtype=torch.float32)
    layers = tmsi.assemble_rgba("blend_psv", pred.permute(0, 2, 3, 1), psv_t,
                                P)["rgba_layers"]
    got = tmsi.render_equirect_view(layers, torch.eye(4)[None],
                                    batch["tgt_pose"], params.msi_depths)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=2e-4)


def test_slice_matches_jax_k1_path():
    """Against the JAX hot path with K1's identity-pose sweep semantics
    (no park-flip noise in either). The two packages' row parameters
    differ by the far-shell projection noise (<= 4e-3 px on the 100 m
    shell, test_torch_sweep), which moves sweep values by up to 1e-2 and
    the render by measured 4.7e-3 max, 2.5e-4 mean: bounds 1e-2 and 1e-3."""
    jcfg, state, model, params, batch, jbatch, depths = _setup(96, 128,
                                                               100.0)
    outs = jmsi.infer_msi_prepared(lambda p, x: model.apply(p, x),
                                   state.params, jcfg, jbatch, depths,
                                   interpret=True, fused_net=None)
    ref = np.asarray(jmsi.render_equirect_view_from_prepared(
        outs, jnp.eye(4)[None], jbatch["tgt_pose"], depths, 96,
        interpret=True))
    got = entry.forward(params, batch).numpy()
    err = np.abs(got - ref)
    assert err.max() < 1e-2, err.max()
    assert err.mean() < 1e-3, err.mean()


@pytest.mark.parametrize("kind", ["translated", "rotated"])
def test_forward_matches_forward_plain(kind):
    """The hot path's route (packed weights, parity deconvs, the
    layer-norm stage, the uv tables) against the plain MSIUNet in the same
    path, float32 at 32x64: 5e-5 as for the net alone (test_torch_net)."""
    cfg = entry.flagship_cfg(height=32, width=64, num_psv_planes=P,
                             num_msi_planes=P, ngf=NGF,
                             compute_dtype="float32")
    params = entry.make_params(cfg, seed=3, device="cpu")
    batch = entry.synthetic_batch(cfg, seed=4, device="cpu",
                                  tgt_pos=(0.03, -0.01, 0.02))
    rt = torch.eye(4)[None]
    if kind == "rotated":
        a = 0.6
        rt[0, :3, :3] = torch.tensor([[np.cos(a), 0, np.sin(a)], [0, 1, 0],
                                      [-np.sin(a), 0, np.cos(a)]])
    got = entry.forward(params, batch, rt)
    want = entry.forward_plain(params, batch, rt)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=5e-5)


def test_import_leaves_jax_out():
    code = ("import sys, matryodshka_tpu_torch.entry, "
            "matryodshka_tpu_torch.ops.net, matryodshka_tpu_torch.cli.test, "
            "matryodshka_tpu_torch.data.loader, "
            "matryodshka_tpu_torch.ops.render_layers; "
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'matryodshka_tpu', 'PIL')); "
            "print(bad); sys.exit(1 if bad else 0)")
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_wrappers_raise_off_cpu_and_cuda():
    """A tensor on neither the CPU nor a CUDA device gets no fallback: the
    wrappers raise instead of running the plain version."""
    meta = torch.device("meta")
    x = torch.empty((1, 4, 8, 16), device=meta)
    norm = [conv_ops.Norm(torch.empty((1, 4, 2), device=meta),
                          torch.ones(4, device=meta),
                          torch.zeros(4, device=meta))]
    with pytest.raises(ValueError):
        conv_ops.conv(x, torch.empty((1, 36, 4), device=meta),
                      torch.empty(4, device=meta), kh=3, kw=3, pad=1,
                      norm=norm, stats=True)
    with pytest.raises(ValueError):
        conv_ops.conv(x, torch.empty((1, 36, 4), device=meta),
                      torch.empty(4, device=meta), kh=3, kw=3, pad=1)
    img = torch.empty((1, 8, 16, 3), device=meta)
    depths = torch.ones(2, device=meta)
    intr = torch.eye(3, device=meta)[None]
    with pytest.raises(ValueError):
        sweep_ops.sweep_volume(img, img, depths, intr)
    with pytest.raises(ValueError):
        sweep_ops.sweep_row_params(depths, intr, 8, 16)
    vol = torch.empty((1, 12, 8, 16), device=meta)
    pose = torch.eye(4, device=meta)[None]
    pos = torch.zeros((1, 3), device=meta)
    with pytest.raises(ValueError):
        render_ops.render_blend(vol, vol[:, :4], pose, pos, depths)
    with pytest.raises(ValueError):
        render_ops.render_blend(vol, vol[:, :4], pose, pos, depths,
                                depth=True)
    with pytest.raises(ValueError):
        render_ops.uv_project(pose, pos, depths, 8, 16)
    layers = torch.empty((1, 2, 8, 16, 4), device=meta)
    for ftb in (False, True):
        for depth in (False, True):
            with pytest.raises(ValueError):
                rl_ops.render_layers(layers, pose, pos, depths, ftb=ftb,
                                     depth=depth)
        with pytest.raises(ValueError):
            rl_ops.render_layers_both(layers, pose, pos, depths, ftb=ftb)


def test_config_accepts_only_blend_psv():
    """All four colour schemes of the JAX package are accepted, with its
    head widths; the three input types with their net input widths (PP
    192, REALESTATE_PP 3 + 192, JAX config.py:152-157); an unknown scheme,
    an unknown input type and unequal plane counts are rejected."""
    widths = {"blend_psv": 64, "blend_bg": 67, "blend_bg_psv": 99,
              "alpha_only": 32}
    for scheme, k in widths.items():
        cfg = entry.flagship_cfg(which_color_pred=scheme)
        assert cfg.num_net_outputs() == k and cfg.num_net_inputs() == 192
    for input_type, cin in (("PP", 192), ("REALESTATE_PP", 195)):
        assert entry.flagship_cfg(
            input_type=input_type).num_net_inputs() == cin
    for bad in (dict(which_color_pred="blend_nothing"),
                dict(input_type="CYLINDER"), dict(num_msi_planes=16)):
        with pytest.raises(ValueError):
            entry.flagship_cfg(**bad)
