"""The port's TF-checkpoint importer (matryodshka_tpu_torch.tf_import and
its tensor_bundle reader) against the JAX package's tools, on CPU.

The dress rehearsal of tests/test_tf_import.py, through the port: flax
parameters -> reference-named TF variables (tools/import_tf_checkpoint.
to_tf_vars) -> a TF-v1 checkpoint (tools/tensor_bundle.save) -> the port's
reader and converter -> the flax tree bit for bit, and the port's net on
it within 5e-5 of the flax net. No real checkpoint is in the repository;
the day one is, only the checkpoint prefix changes.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from matryodshka_tpu.config import MatryConfig as JaxConfig
from matryodshka_tpu.training import state as state_lib
from matryodshka_tpu_torch import tensor_bundle as ttb
from matryodshka_tpu_torch import tf_import, weights
from matryodshka_tpu_torch.models.unet import MSIUNet
from matryodshka_tpu_torch.ops import conv as conv_ops
from matryodshka_tpu_torch.ops import net as net_ops
from matryodshka_tpu_torch.training.checkpoint import restore_params

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "tools"))
import import_tf_checkpoint as jimport  # noqa: E402
import tensor_bundle as jtb  # noqa: E402

torch.set_num_threads(1)

H, W, P, NGF = 32, 64, 4, 8


def _flax(variant):
    cfg = JaxConfig(height=H, width=W, num_psv_planes=P, num_msi_planes=P,
                    ngf=NGF, compute_dtype="float32",
                    coord_net=variant == "coord").validate()
    state, model = state_lib.init_state(cfg, jax.random.PRNGKey(0))
    return cfg, jax.tree.map(np.asarray, state.params), model


def _assert_trees_equal(want, got):
    want, got = want["params"], got["params"]
    assert sorted(want) == sorted(got)
    for layer in want:
        assert sorted(want[layer]) == sorted(got[layer]), layer
        for leaf in want[layer]:
            a, b = np.asarray(want[layer][leaf]), np.asarray(got[layer][leaf])
            assert a.dtype == b.dtype and a.shape == b.shape, (layer, leaf)
            np.testing.assert_array_equal(a, b, err_msg=f"{layer}/{leaf}")


@pytest.mark.parametrize("variant", ["coord", "wrap"])
def test_dress_rehearsal(tmp_path, variant):
    """TF-v1 checkpoint of flax params -> the port's importer: the flax
    tree bit for bit; the port's net (plain and kernel route) on the
    imported weights within 5e-5 of the flax net; variant_of names the
    variant."""
    cfg, params, model = _flax(variant)
    prefix = str(tmp_path / "model.latest-0")
    jtb.save(prefix, jimport.to_tf_vars(params))
    got = tf_import.convert(tf_import.load_tf_vars(prefix))
    _assert_trees_equal(params, got)
    assert tf_import.variant_of(got) == variant

    x = np.random.RandomState(1).uniform(
        -1, 1, (1, H, W, cfg.num_net_inputs())).astype(np.float32)
    ref = np.asarray(model.apply(params, jnp.asarray(x)))
    net = MSIUNet(cfg.num_net_inputs(), cfg.num_net_outputs(), NGF,
                  dtype=torch.float32, variant=variant)
    net.load_state_dict(weights.from_flax(got))
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    with torch.no_grad():
        plain = net(xt)
    route = net_ops.unet_forward(net_ops.prepare(net, torch.float32, H), xt)
    for out in (plain, route):
        np.testing.assert_allclose(out.permute(0, 2, 3, 1).numpy(), ref,
                                   rtol=0, atol=5e-5)


@pytest.mark.parametrize("source", ["checkpoint", "npz_slash", "npz_pipe"])
def test_main_writes_params_npz(tmp_path, source):
    """`python -m matryodshka_tpu_torch.tf_import SRC OUT.npz --step N`
    from a checkpoint prefix or an .npz dump of its variables (`/` or `|`
    names): restore_params (what cli/test.py --params reads) gives the flax
    tree bit for bit and the step."""
    _, params, _ = _flax("coord")
    tf_vars = jimport.to_tf_vars(params)
    if source == "checkpoint":
        src = str(tmp_path / "model.latest-140000")
        jtb.save(src, tf_vars)
    else:
        src = str(tmp_path / "tf_weights.npz")
        sep = "/" if source == "npz_slash" else "|"
        np.savez(src, **{k.replace("/", sep): v for k, v in tf_vars.items()})
    out = str(tmp_path / "out.npz")
    tf_import.main([src, out, "--step", "140000"])
    tree, step = restore_params(out)
    assert step == 140000
    _assert_trees_equal(params, tree)


def test_reader_matches_tools_reader(tmp_path):
    """The port's copy of the TensorBundle reader against
    tools/tensor_bundle.load, bit for bit: several sstable blocks (>4 KB
    of index entries), mixed dtypes, a scalar."""
    rng = np.random.RandomState(0)
    tensors = {f"net/layer_{i:03d}/weights": rng.randn(3, 3, 8, 8).astype(
        np.float32) for i in range(40)}
    tensors["global_step"] = np.asarray(140000, np.int64).reshape(())
    tensors["a/int_vec"] = rng.randint(-5, 5, (17,)).astype(np.int32)
    tensors["a/f16"] = rng.randn(5, 2).astype(np.float16)
    tensors["a/f64"] = rng.randn(4).astype(np.float64)
    prefix = str(tmp_path / "ckpt")
    jtb.save(prefix, tensors)
    got, want = ttb.load(prefix), jtb.load(prefix)
    assert sorted(got) == sorted(want) == sorted(tensors)
    for k in tensors:
        assert got[k].dtype == want[k].dtype == tensors[k].dtype, k
        np.testing.assert_array_equal(got[k], tensors[k])
        np.testing.assert_array_equal(got[k], want[k])


def test_reader_rejects_corrupt_data(tmp_path):
    prefix = str(tmp_path / "ckpt")
    jtb.save(prefix, {"w": np.arange(64, dtype=np.float32)})
    data = tmp_path / "ckpt.data-00000-of-00001"
    raw = bytearray(data.read_bytes())
    raw[10] ^= 0xFF
    data.write_bytes(bytes(raw))
    with pytest.raises(ValueError):
        ttb.load(prefix)
    ttb.load(prefix, check_crc=False)
    with pytest.raises(KeyError):
        tf_import.convert({"net/conv1_1/weights": np.zeros((3, 3, 2, 2))})


def test_same_deconv_convention():
    """A TF conv2d_transpose with SAME padding (the gradient of a SAME
    stride-2 4x4 conv, as tests/test_tf_import.py builds the VALID one),
    its kernel imported by the port (tf_import.convert's flip + swap, then
    weights.from_flax), equals the port's coord deconv (the zero-mode
    parity form of ops.conv)."""
    _, params, _ = _flax("coord")
    tf_vars = jimport.to_tf_vars(params)
    rng = np.random.RandomState(1)
    cout, cin = tf_vars["net/conv6_1/weights"].shape[2:]
    k_tf = rng.randn(4, 4, cout, cin).astype(np.float32)
    tf_vars["net/conv6_1/weights"] = k_tf
    tf_vars["net/conv6_1/biases"] = np.zeros(cout, np.float32)
    x = rng.randn(1, 6, 8, cin).astype(np.float32)

    def fwd_conv(y):
        return jax.lax.conv_general_dilated(
            y, jnp.asarray(k_tf), (2, 2), "SAME",
            dimension_numbers=("NHWC", "HWIO", "NHWC"))
    y0 = jnp.zeros((1, 12, 16, cout))
    assert fwd_conv(y0).shape == x.shape
    want = np.asarray(jax.vjp(fwd_conv, y0)[1](jnp.asarray(x))[0])

    sd = weights.from_flax(tf_import.convert(tf_vars))
    got = conv_ops.conv(torch.from_numpy(x).permute(0, 3, 1, 2),
                        conv_ops.pack_deconv(sd["conv6_1.weight"],
                                             torch.float32, smoothed=False),
                        sd["conv6_1.bias"],
                        **net_ops.conv_args("deconv", 1, "coord"))
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want,
                               rtol=0, atol=1e-4)


def test_importer_leaves_jax_out():
    """The importer, its reader and the trace tool import neither JAX nor
    the JAX package (nor tools/)."""
    import subprocess
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    code = ("import sys, matryodshka_tpu_torch.tf_import, "
            "matryodshka_tpu_torch.tensor_bundle, "
            "matryodshka_tpu_torch.trace; "
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'matryodshka_tpu', 'tensor_bundle', "
            "'import_tf_checkpoint')); print(bad); sys.exit(1 if bad else 0)")
    proc = subprocess.run([sys.executable, "-c", code],
                          env=dict(os.environ, PYTHONPATH=repo), cwd=repo,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
