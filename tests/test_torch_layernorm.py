"""The layer-norm kernel's form choice (ops/layernorm.py ln_plan) at the
flagship net's shapes, and its plain version against the JAX package's
SpatialLayerNorm + ReLU at a batch of two.

The kernel itself runs only on the card (tests/test_torch_kernels_cuda.py);
the plan is plain Python, so the shapes that decide which form a layer
takes are checked here.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from matryodshka_tpu.models import unet as junet
from matryodshka_tpu_torch.ops import layernorm as ln_ops
from matryodshka_tpu_torch.ops.net import unet_plan

#: The 17 layer-normed outputs of the flagship net (ngf 64, 640x320):
#: (name, C, H, W) of every stage but the head.
FLAGSHIP_LN = [(name, cout, 320 // outd, 640 // outd)
               for (name, kind, _, _, cout, _, outd, _)
               in unet_plan(64, 192, 64) if kind != "head"]


def test_flagship_ln_layers():
    assert len(FLAGSHIP_LN) == 17
    mb = sum(c * h * w * 2 for _, c, h, w in FLAGSHIP_LN) / 1e6
    assert abs(mb - 183.5) < 0.05


@pytest.mark.parametrize("layer", FLAGSHIP_LN, ids=[s[0] for s in FLAGSHIP_LN])
def test_ln_plan_flagship_takes_onchip(layer):
    """Batch 1, bf16, 132 SMs: every layer keeps its example on chip, one
    block per SM, each share at most 232,448 bytes (an H100 block's
    shared memory) and a whole number of 16-byte vectors, the shares
    covering the example."""
    _, c, h, w = layer
    form, nblk, share = ln_ops.ln_plan(1, c, h, w, 2, 132)
    assert form == "onchip" and nblk == 132
    assert share * 2 <= 232_448 and share % 8 == 0
    assert nblk * share >= c * h * w > (nblk - 1) * share - 8 * nblk
    assert ln_ops.ln_plan(1, c, h, w, 2, 132) == (form, nblk, share)


@pytest.mark.parametrize("case", [(2, 2), (1, 4)], ids=["batch2", "f32"])
def test_ln_plan_conv1_1_two_pass(case):
    """conv1_1's output (64 x 320 x 640) at batch 2, or in float32 at batch
    1 (52 MB, 397 KB a block), takes the two-pass form: at most 1024
    chunks of whole 16-byte vectors that cover the example, the last one
    not empty."""
    b, itemsize = case
    n = 64 * 320 * 640
    form, nblk, chunk = ln_ops.ln_plan(b, 64, 320, 640, itemsize, 132)
    assert form == "two_pass"
    assert 1 <= nblk <= 1024 and chunk % 8 == 0
    assert nblk * chunk >= n > (nblk - 1) * chunk


def test_ln_plan_small_shapes():
    """A tiny example still takes the on-chip form at batch 1 (most blocks
    then hold nothing); any batch above 1 takes the two-pass form."""
    assert ln_ops.ln_plan(1, 3, 5, 7, 2, 132) == ("onchip", 132, 8)
    form, nblk, chunk = ln_ops.ln_plan(3, 3, 5, 7, 4, 132)
    assert (form, nblk, chunk) == ("two_pass", 1, 112)


def test_layer_norm_relu_plain_matches_flax_batch2():
    """The plain version (what every CPU tensor takes) against flax's
    SpatialLayerNorm + ReLU, two examples of different scale, float32."""
    rng = np.random.RandomState(11)
    x = np.concatenate([rng.randn(1, 8, 6, 5) * 3 + 1,
                        rng.randn(1, 8, 6, 5) * 0.1 - 2]).astype(np.float32)
    gamma = rng.randn(5).astype(np.float32)
    beta = rng.randn(5).astype(np.float32)
    ln = junet.SpatialLayerNorm()
    ref = jax.nn.relu(ln.apply({"params": {"gamma": gamma, "beta": beta}},
                               jnp.asarray(x)))
    got = ln_ops.layer_norm_relu(
        torch.from_numpy(x).permute(0, 3, 1, 2), torch.from_numpy(gamma),
        torch.from_numpy(beta))
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(),
                               np.asarray(ref), rtol=0, atol=1e-5)
