"""The plain layer norm + ReLU (ops/layernorm.py layer_norm_relu_plain,
what the CPU route runs and the card's gates hold the conv kernel's fused
layer norm to) against the JAX package's SpatialLayerNorm + ReLU at a batch
of two. The fused algorithm itself is tests/test_torch_conv_ln.py's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from matryodshka_tpu.models import unet as junet
from matryodshka_tpu_torch.ops import layernorm as ln_ops


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
    got = ln_ops.layer_norm_relu_plain(
        torch.from_numpy(x).permute(0, 3, 1, 2), torch.from_numpy(gamma),
        torch.from_numpy(beta))
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(),
                               np.asarray(ref), rtol=0, atol=1e-5)
