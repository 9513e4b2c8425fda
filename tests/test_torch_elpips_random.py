"""The port's random E-LPIPS features against the JAX package's, on CPU.

Without a weight file both packages build the metric on random conv
features. The JAX package draws them with `jax.random.normal` from a key
chain that starts at `PRNGKey(0)`; the port draws the same values without
JAX (`losses/elpips/threefry.py`). Every comparison here is bit for bit:

* the primitives: `split`, `random_bits`, `uniform` and `normal` against
  jax.random (jax_threefry_partitionable, the default), and `erf_inv`
  against XLA's float32 erf_inv on a dense grid of [-1, 1];
* `random_vgg_weights` and `random_squeeze_weights` against JAX's, every
  conv's weight and bias;
* `load_weights(None, metric)` against JAX's for each of the four
  metrics: conv weights (as the port's OIHW tensors), linear weights and
  the `calibrated` flag.
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from matryodshka_tpu.losses.elpips import api as japi
from matryodshka_tpu.losses.elpips import networks as jnetworks
from matryodshka_tpu_torch.losses.elpips import api as tapi
from matryodshka_tpu_torch.losses.elpips import networks as tnetworks
from matryodshka_tpu_torch.losses.elpips import threefry
from matryodshka_tpu_torch.weights import elpips_from_jax

METRICS = ["vgg_ensemble", "vgg", "squeeze_ensemble_maxpool", "squeeze"]


def _jax_key(key):
    return jax.random.wrap_key_data(jnp.asarray(key), impl="threefry2x32")


def test_split_and_bits_match_jax():
    assert jax.config.jax_threefry_partitionable
    key = threefry.prng_key(0)
    jkey = jax.random.PRNGKey(0)
    np.testing.assert_array_equal(key, np.asarray(jkey))
    for n in (2, 3, 6):
        got = threefry.split(key, n)
        want = np.asarray(jax.random.split(jkey, n))
        np.testing.assert_array_equal(np.stack(got), want)
    for k in threefry.split(threefry.prng_key(7), 3):
        for shape in ((5,), (3, 4, 7), (2, 3, 3, 9)):
            np.testing.assert_array_equal(
                threefry.random_bits(k, shape),
                np.asarray(jax.random.bits(_jax_key(k), shape)))


@pytest.mark.parametrize("shape", [(1000,), (3, 3, 64, 17)])
def test_uniform_and_normal_match_jax(shape):
    for k in threefry.split(threefry.prng_key(3), 2):
        np.testing.assert_array_equal(
            threefry.uniform(k, shape, -0.03, 0.03),
            np.asarray(jax.random.uniform(_jax_key(k), shape, minval=-0.03,
                                          maxval=0.03)))
        np.testing.assert_array_equal(
            threefry.normal(k, shape),
            np.asarray(jax.random.normal(_jax_key(k), shape)))


def test_erf_inv_matches_xla():
    """2^20 + 6 points across [-1, 1], both of Giles' branches (w < 5 and
    w >= 5, |x| above ~0.9966) and both of log1p's (|x^2| below and
    above sqrt(2) - 1), the extremes next to +-1, and +-1 (+-inf)."""
    x = np.concatenate([np.linspace(-1, 1, 1 << 20, dtype=np.float32)[1:-1],
                        np.nextafter(np.float32([-1, 1]), np.float32(0)),
                        np.float32([0.0, -0.0, 0.99660, 0.64359, -1, 1])])
    want = np.asarray(jax.jit(jax.lax.erf_inv)(x))
    np.testing.assert_array_equal(threefry.erf_inv(x), want)


def test_random_vgg_weights_match_jax():
    want = jnetworks.random_vgg_weights(jax.random.PRNGKey(0))
    got = tnetworks.random_vgg_weights()
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == np.float32 and got[k].shape == want[k].shape
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_random_squeeze_weights_match_jax():
    for seed in (0, 5):
        want = jnetworks.random_squeeze_weights(jax.random.PRNGKey(seed))
        got = tnetworks.random_squeeze_weights(threefry.prng_key(seed))
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("metric", METRICS)
def test_load_weights_without_a_file_matches_jax(metric):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jnet, jlin, jcal = japi.load_weights(None, metric)
        tnet, tlin, tcal = tapi.load_weights(None, metric)
    assert jcal is False and tcal is False
    want = elpips_from_jax(jnet)
    assert sorted(tnet) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(tnet[k].numpy(), want[k].numpy(),
                                      err_msg=k)
    assert sorted(tlin) == sorted(jlin)
    for k in jlin:
        np.testing.assert_array_equal(np.asarray(tlin[k]),
                                      np.asarray(jlin[k]), err_msg=k)
