"""The port's coord U-Net (the released checkpoints' architecture) against
the JAX package, on CPU, where every kernel wrapper runs its plain version.

* each coord stage kind (3x3 conv, rate-2 conv, stride-2 down with the
  coord channel; SAME transposed conv) of ops.conv against flax's own
  layer on the same inputs;
* the plain MSIUNet(variant="coord") and the kernel route
  (net_ops.unet_forward) against flax MSIUNet(variant="coord"), and the
  kernel route against the whole-net Pallas kernel's coord variant
  (interpret mode, unflipped, at the shape tests/test_pallas_net.py runs
  it);
* the coord slice end to end (entry.forward, forward_plain,
  forward_reference with coord_net=True) against the JAX infer_msi +
  render_equirect_view with the same weights;
* the test CLI with --coord_net true against the JAX CLI, on weights that
  went through a reference TF checkpoint and the port's importer.

Float32 throughout. Net tolerance atol 5e-5, as tests/test_pallas_net.py
holds the TPU net kernel (18 f32 layers with per-layer normalization keep
accumulation-order differences around 1e-5).
"""

import os
import sys

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from matryodshka_tpu.cli import test as jcli
from matryodshka_tpu.config import MatryConfig as JaxConfig
from matryodshka_tpu.geometry import sweep as jsweep
from matryodshka_tpu.models import msi as jmsi
from matryodshka_tpu.models import unet as junet
from matryodshka_tpu.ops import pallas_net
from matryodshka_tpu.training import state as state_lib
from matryodshka_tpu_torch import entry, weights
from matryodshka_tpu_torch.cli import test as tcli
from matryodshka_tpu_torch.config import MatryConfig
from matryodshka_tpu_torch.models.unet import MSIUNet
from matryodshka_tpu_torch.ops import conv as conv_ops
from matryodshka_tpu_torch.ops import net as net_ops

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
H, W, P, NGF = 32, 64, 4, 8
ATOL = 5e-5


def _jax_cfg(h=H, w=W, **kw):
    return JaxConfig(height=h, width=w, num_psv_planes=P, num_msi_planes=P,
                     ngf=NGF, compute_dtype="float32", coord_net=True,
                     **kw).validate()


@pytest.fixture(scope="module")
def flax_coord_net():
    cfg = _jax_cfg()
    state, model = state_lib.init_state(cfg, jax.random.PRNGKey(0))
    assert model.variant == "coord"
    params = jax.tree.map(np.asarray, state.params)
    x = np.random.RandomState(0).uniform(
        -1, 1, (1, H, W, cfg.num_net_inputs())).astype(np.float32)
    ref = np.asarray(model.apply(state.params, jnp.asarray(x)))
    return cfg, params, x, ref


def _torch_net(cin, cout, params, ngf=NGF):
    net = MSIUNet(cin, cout, ngf, dtype=torch.float32, variant="coord")
    net.load_state_dict(weights.from_flax(params))
    return net


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(a)).permute(0, 3, 1, 2)


@pytest.mark.parametrize("kind,rate", [("conv", 1), ("conv", 2),
                                       ("down", 1)])
def test_coord_conv_stage_matches_flax(kind, rate):
    """ops.conv with the coord net's arguments (SAME zero pads, the coord
    vector of the input height) against flax's Conv(padding="SAME") on the
    input with sph_coord_channel appended: the coord channel at the pole
    rows, zero padding at the edge columns, the stride-2 SAME size."""
    rng = np.random.RandomState(1)
    x = rng.randn(2, 12, 16, 5).astype(np.float32)
    stride = 2 if kind == "down" else 1
    mod = nn.Conv(7, (3, 3), strides=(stride, stride), padding="SAME",
                  kernel_dilation=(rate, rate))
    xc = jnp.concatenate([x, jnp.broadcast_to(
        junet.sph_coord_channel(12, 16), (2, 12, 16, 1))], axis=-1)
    variables = {"params": {
        "kernel": jnp.asarray(rng.randn(3, 3, 6, 7).astype(np.float32)),
        "bias": jnp.asarray(rng.randn(7).astype(np.float32))}}
    want = np.asarray(mod.apply(variables, xc))
    wt = torch.from_numpy(np.array(variables["params"]["kernel"])).permute(
        3, 2, 0, 1)
    args = net_ops.conv_args(kind, rate, "coord")
    got = conv_ops.conv(_nchw(x), conv_ops.pack_conv(wt, torch.float32),
                        torch.from_numpy(np.array(
                            variables["params"]["bias"])),
                        coord=conv_ops.coord_column(12), **args)
    assert got.shape == (2, 7, 12 // stride, 16 // stride)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want,
                               rtol=0, atol=1e-5)


def test_coord_deconv_stage_matches_flax():
    """The parity form in zero mode against flax's
    ConvTranspose(padding="SAME"), which the coord net uses."""
    rng = np.random.RandomState(2)
    x = rng.randn(2, 6, 8, 5).astype(np.float32)
    k = rng.randn(4, 4, 5, 3).astype(np.float32)
    b = rng.randn(3).astype(np.float32)
    mod = nn.ConvTranspose(3, (4, 4), strides=(2, 2), padding="SAME")
    want = np.asarray(mod.apply({"params": {"kernel": jnp.asarray(k),
                                            "bias": jnp.asarray(b)}},
                                jnp.asarray(x)))
    wt = torch.from_numpy(k).permute(3, 2, 0, 1)
    got = conv_ops.conv(_nchw(x), conv_ops.pack_deconv(wt, torch.float32,
                                                       smoothed=False),
                        torch.from_numpy(b),
                        **net_ops.conv_args("deconv", 1, "coord"))
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want,
                               rtol=0, atol=1e-5)


def test_coord_msiunet_matches_flax(flax_coord_net):
    cfg, params, x, ref = flax_coord_net
    net = _torch_net(cfg.num_net_inputs(), cfg.num_net_outputs(), params)
    with torch.no_grad():
        got = net(_nchw(x))
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), ref, rtol=0,
                               atol=ATOL)


def test_coord_unet_forward_matches_flax(flax_coord_net):
    """The kernel route (packed Cin+1 weights, coord vectors, zero-mode
    parity deconvs, the LN+ReLU stage) through the plain versions."""
    cfg, params, x, ref = flax_coord_net
    net = _torch_net(cfg.num_net_inputs(), cfg.num_net_outputs(), params)
    stages = net_ops.prepare(net, torch.float32, H)
    assert sum("coord" in st["args"] for st in stages) == 14
    got = net_ops.unet_forward(stages, _nchw(x))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), ref, rtol=0,
                               atol=ATOL)


def test_coord_unet_forward_matches_pallas_kernel():
    """Against the TPU kernel's coord variant (pallas_net.unet_forward,
    variant="coord", interpret mode, unflipped) on the same weights and
    input, at the shape tests/test_pallas_net.py runs it: 32x128, ngf 8,
    24 input channels."""
    h, w, cin0, nout = 32, 128, 24, 8
    rng = np.random.RandomState(11)
    x = (rng.randn(1, h, w, cin0) * 0.3).astype(np.float32)
    model = junet.MSIUNet(num_outputs=nout, ngf=NGF, variant="coord",
                          dtype=jnp.float32)
    params = model.init(jax.random.PRNGKey(0), jnp.asarray(x))
    ops = pallas_net.prepare_params(params, NGF, cin0, nout,
                                    dtype=jnp.float32, variant="coord")
    want = pallas_net.unet_forward(
        jnp.asarray(x[0].transpose(0, 2, 1)), ops, NGF, nout,
        interpret=True, variant="coord")              # [H, K, W]
    net = _torch_net(cin0, nout, jax.tree.map(np.asarray, params))
    got = net_ops.unet_forward(net_ops.prepare(net, torch.float32, h),
                               _nchw(x))               # [1, K, H, W]
    np.testing.assert_allclose(got[0].permute(1, 0, 2).numpy(),
                               np.asarray(want), rtol=0, atol=ATOL)


def test_coord_weights_have_flax_shapes(flax_coord_net):
    """seeded_init and from_flax for the coord net: conv and down kernels
    read Cin + 1 channels, deconvs and the head do not."""
    cfg, params, _, _ = flax_coord_net
    tcfg = MatryConfig(height=H, width=W, num_psv_planes=P,
                       num_msi_planes=P, ngf=NGF, coord_net=True)
    mine = weights.seeded_init(tcfg, 0)
    assert jax.tree.map(np.shape, mine) == jax.tree.map(np.shape, params)
    assert mine["params"]["conv1_1"]["kernel"].shape == (3, 3, 6 * P + 1,
                                                          NGF)
    assert mine["params"]["conv6_1"]["kernel"].shape == (4, 4, 16 * NGF,
                                                          4 * NGF)
    sd = weights.from_flax(params)
    net = MSIUNet(6 * P, 2 * P, NGF, variant="coord")
    assert set(sd) == set(net.state_dict())
    net.load_state_dict(sd, strict=True)
    with pytest.raises(RuntimeError):
        MSIUNet(6 * P, 2 * P, NGF).load_state_dict(sd)


def test_coord_config_and_prepare_checks():
    """--coord_net reaches the config; the variant is checked; the coord
    net's kernel operands need the input height."""
    import argparse

    from matryodshka_tpu_torch.config import add_config_args, \
        config_from_args
    parser = argparse.ArgumentParser()
    add_config_args(parser)
    cfg = config_from_args(parser.parse_args(["--coord_net", "true"]))
    assert cfg.coord_net and cfg.net_variant == "coord"
    assert entry.flagship_cfg().net_variant == "wrap"
    with pytest.raises(ValueError):
        MSIUNet(24, 8, NGF, variant="smooth")
    with pytest.raises(ValueError):
        net_ops.prepare(MSIUNet(24, 8, NGF, variant="coord"), torch.float32)


def test_coord_conv_raises_off_cpu_and_cuda():
    meta = torch.device("meta")
    x = torch.empty((1, 4, 8, 16), device=meta)
    with pytest.raises(ValueError):
        conv_ops.conv(x, torch.empty((1, 45, 4), device=meta),
                      torch.empty(4, device=meta), kh=3, kw=3, pad=(1, 1),
                      hpad="zero", coord=torch.empty(8, device=meta))


def _slice_setup(max_depth):
    jcfg = _jax_cfg(max_depth=max_depth, use_pallas=True)
    state, model = state_lib.init_state(jcfg, jax.random.PRNGKey(0))
    tcfg = entry.flagship_cfg(height=H, width=W, num_psv_planes=P,
                              num_msi_planes=P, ngf=NGF,
                              compute_dtype="float32", max_depth=max_depth,
                              coord_net=True)
    params = entry.make_params(
        tcfg, flax_params=jax.tree.map(np.asarray, state.params), device="cpu")
    batch = entry.synthetic_batch(tcfg, seed=0, device="cpu")
    return jcfg, state, model, params, batch


@pytest.fixture(scope="module", params=[20.0, 100.0])
def coord_e2e(request):
    """The JAX e2e reference (infer_msi + gather render_equirect_view) of
    the coord net on a 32x64 batch, shells out to max_depth."""
    jcfg, state, model, params, batch = _slice_setup(request.param)
    jbatch = {k: jnp.asarray(v.numpy()) for k, v in batch.items()}
    depths = jnp.asarray(jsweep.inv_depths(1.0, request.param, P))
    outs = jmsi.infer_msi(lambda p, x: model.apply(p, x), state.params, jcfg,
                          jbatch, depths)
    ref = jmsi.render_equirect_view(outs["rgba_layers"].astype(jnp.float32),
                                    jnp.eye(4)[None], jbatch["tgt_pose"],
                                    depths, use_pallas=False)
    return request.param, params, batch, np.asarray(ref)


@pytest.mark.parametrize("path", ["forward", "forward_plain",
                                  "forward_reference"])
def test_coord_slice_matches_e2e_reference(coord_e2e, path):
    """The bounds and their reasons are tests/test_torch_pipeline.py's for
    the wrap net: at 20 m both packages' f32 projection noise (<= 5e-4 px)
    through the random net, max 2e-3; at 100 m the gather sweep's
    park-flip noise (PARITY.md), mean 3e-2 and median 1e-2."""
    max_depth, params, batch, ref = coord_e2e
    assert params.net.variant == "coord"
    got = getattr(entry, path)(params, batch).numpy()
    assert got.shape == ref.shape == (1, H, W, 3)
    assert np.isfinite(got).all()
    err = np.abs(got - ref)
    if max_depth <= 20.0:
        assert err.max() < 2e-3, err.max()
    else:
        assert err.mean() < 3e-2, err.mean()
        assert np.median(err) < 1e-2, np.median(err)


def test_coord_forward_matches_forward_plain():
    """The kernel route (packed weights, coord vectors, zero-mode parity
    deconvs) against the plain coord MSIUNet in the same path: 5e-5."""
    cfg = entry.flagship_cfg(height=H, width=W, num_psv_planes=P,
                             num_msi_planes=P, ngf=NGF,
                             compute_dtype="float32", coord_net=True)
    params = entry.make_params(cfg, seed=3, device="cpu")
    batch = entry.synthetic_batch(cfg, seed=4, device="cpu",
                                  tgt_pos=(0.03, -0.01, 0.02))
    before = conv_ops.coord_launches
    got = entry.forward(params, batch)
    assert conv_ops.coord_launches == before      # CPU: no kernel launch
    np.testing.assert_allclose(got.numpy(),
                               entry.forward_plain(params, batch).numpy(),
                               rtol=0, atol=5e-5)


def test_coord_cli_main_matches_jax_main(tmp_path):
    """Both CLIs with --coord_net true over one example of the synthetic
    fixture, low-res then high_res (128x256): the JAX CLI on an orbax
    checkpoint of the flax coord parameters, the port's on the .npz that
    its importer wrote from a TF-v1 checkpoint of the same parameters
    (tools/import_tf_checkpoint.to_tf_vars + tools/tensor_bundle.save).
    The same files with the bounds of tests/test_torch_cli.py: .npy within
    2e-3, every PNG within 2 of 255 levels per pixel, mean under 0.1."""
    from PIL import Image

    from matryodshka_tpu.data import synthetic
    from matryodshka_tpu.training.checkpoint import CheckpointManager
    from matryodshka_tpu_torch import tf_import

    sys.path.insert(0, os.path.join(REPO, "tools"))
    import tensor_bundle
    from import_tf_checkpoint import to_tf_vars

    glob_pat = synthetic.make_ods_fixture(str(tmp_path / "fix"),
                                          num_scenes=1, height=64,
                                          width=128)
    jcfg = _jax_cfg(64, 128, min_depth=2.0, max_depth=20.0, use_pallas=True)
    state, _ = state_lib.init_state(jcfg, jax.random.PRNGKey(0))
    CheckpointManager(str(tmp_path / "ckpt" / "t")).save(state)
    prefix = str(tmp_path / "tf" / "model.latest-0")
    tensor_bundle.save(prefix, to_tf_vars(jax.tree.map(np.asarray,
                                                       state.params)))
    tf_import.main([prefix, str(tmp_path / "params.npz")])

    flags = ["--image_dir", str(tmp_path / "fix" / "images"),
             "--hres_image_dir", str(tmp_path / "fix" / "images"),
             "--cameras_glob", glob_pat, "--height", "64", "--width", "128",
             "--hres_height", "128", "--hres_width", "256",
             "--num_psv_planes", str(P), "--num_msi_planes", str(P),
             "--ngf", str(NGF), "--compute_dtype", "float32",
             "--min_depth", "2", "--max_depth", "20", "--coord_net", "true",
             "--experiment_name", "t", "--num_runs", "1",
             "--test_type", "high_res"]
    jcli.main(flags + ["--output_root", str(tmp_path / "jax"),
                       "--checkpoint_dir", str(tmp_path / "ckpt")])
    tcli.main(flags + ["--output_root", str(tmp_path / "torch"),
                       "--params", str(tmp_path / "params.npz"),
                       "--device", "cpu"])

    jroot, troot = tmp_path / "jax" / "t", tmp_path / "torch" / "t"
    names = sorted(os.path.relpath(os.path.join(d, f), jroot)
                   for d, _, fs in os.walk(jroot) for f in fs)
    assert names == sorted(os.path.relpath(os.path.join(d, f), troot)
                           for d, _, fs in os.walk(troot) for f in fs)
    assert any("output_hrestgt_" in n for n in names)
    for name in names:
        if name.endswith(".npy"):
            np.testing.assert_allclose(np.load(troot / name),
                                       np.load(jroot / name), rtol=0,
                                       atol=2e-3, err_msg=name)
        elif name.endswith(".png"):
            a = np.asarray(Image.open(troot / name), np.int32)
            b = np.asarray(Image.open(jroot / name), np.int32)
            diff = np.abs(a - b)
            assert diff.max() <= 2 and diff.mean() < 0.1, (name, diff.max())
