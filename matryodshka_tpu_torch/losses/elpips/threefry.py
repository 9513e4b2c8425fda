"""jax.random's key split and normal draw, in numpy, bit for bit.

The E-LPIPS random conv features of the JAX package
(`matryodshka_tpu/losses/elpips/networks.py`: `random_vgg_weights`,
`random_squeeze_weights`) are `jax.random.normal` draws from a key chain
that starts at `PRNGKey(0)`. This module reproduces those draws without
JAX, so the port's uncalibrated metric is the JAX package's:

* `threefry2x32`: the Threefry-2x32 block cipher (20 rounds, key
  schedule constant 0x1BD11BDA), vectorised over numpy uint32 arrays;
* `split(key, n)`: JAX's partitionable ("foldlike") split, the cipher of
  the counters (hi 0, lo 0..n-1);
* `random_bits(key, shape)`: the cipher of (hi, lo) of each element's
  flat index, the two words xor-ed;
* `uniform(key, shape, lo, hi)`: JAX's float construction (the top 23
  bits as a mantissa of [1, 2), minus 1, times hi - lo plus lo in one
  fused multiply-add, then max(lo, .));
* `normal(key, shape)`: sqrt(2) * erf_inv(uniform(nextafter(-1, 0), 1)),
  with XLA's float32 `ErfInv` (Giles' polynomial) over XLA's float32
  `log1p` (the Cephes rational below sqrt(2) - 1, Cephes' `logf` of 1 + x
  above), operation by operation as the CPU backend emits them: float32
  products and sums, and a fused multiply-add wherever its compiler fuses
  one (`_fma`).

The flag `jax_threefry_partitionable` (True by default since JAX 0.5) is
assumed; the test holds every draw of the metric against JAX.
"""

from __future__ import annotations

import struct
from typing import List

import numpy as np

_U = np.uint32
_F = np.float32
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def threefry2x32(k0, k1, x0, x1):
    """Threefry-2x32 of the counter words (x0, x1) (uint32 arrays of one
    shape) under the key (k0, k1) -> two uint32 arrays."""
    k0, k1 = _U(k0), _U(k1)
    ks = (k0, k1, _U(k0 ^ k1 ^ _U(0x1BD11BDA)))
    x0 = x0 + ks[0]
    x1 = x1 + ks[1]
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 += x1
            x1 = (x1 << _U(r)) | (x1 >> _U(32 - r))
            x1 ^= x0
        x0 += ks[(i + 1) % 3]
        x1 += ks[(i + 2) % 3] + _U(i + 1)
    return x0, x1


def prng_key(seed: int) -> np.ndarray:
    """jax.random.PRNGKey(seed) for 0 <= seed < 2^32: [0, seed] uint32."""
    return np.array([0, seed], np.uint32)


def split(key, n: int = 2) -> List[np.ndarray]:
    """jax.random.split(key, n) as n keys ([2] uint32 each)."""
    a, b = threefry2x32(key[0], key[1], np.zeros(n, np.uint32),
                        np.arange(n, dtype=np.uint32))
    return [np.array([a[i], b[i]], np.uint32) for i in range(n)]


def _bits(key, start: int, stop: int) -> np.ndarray:
    """Elements start..stop-1 of a flat jax.random.bits draw."""
    if stop > 1 << 32:
        raise ValueError("more than 2^32 elements")
    a, b = threefry2x32(key[0], key[1], np.zeros(stop - start, np.uint32),
                        np.arange(start, stop, dtype=np.uint32))
    return a ^ b


def random_bits(key, shape) -> np.ndarray:
    """jax.random.bits(key, shape) (32-bit): uint32 array of shape."""
    return _bits(key, 0, int(np.prod(shape))).reshape(shape)


def _uniform(bits, lo, hi) -> np.ndarray:
    f = ((bits >> _U(9)) | _U(0x3F800000)).view(_F) - _F(1)
    lo, hi = _F(lo), _F(hi)
    return np.maximum(lo, _fma(f, hi - lo, lo))


def uniform(key, shape, lo, hi) -> np.ndarray:
    """jax.random.uniform(key, shape, float32, lo, hi)."""
    return _uniform(random_bits(key, shape), lo, hi)


def _c(hex64: str) -> np.float32:
    """A float32 constant from its float64 hex (as LLVM prints it)."""
    return _F(struct.unpack(">d", bytes.fromhex(hex64))[0])


def _fma(a, b, c) -> np.ndarray:
    """float32 fused multiply-add, correctly rounded: the product of two
    float32 is exact in float64; where the float64 sum lies exactly
    halfway between two float32 numbers, its own rounding error
    (two-sum) breaks the tie."""
    p = np.asarray(a, np.float64) * np.asarray(b, np.float64)
    s = p + c
    tie = (s.view(np.uint64) & np.uint64(0x1FFFFFFF)) == np.uint64(0x10000000)
    if tie.any():
        i = np.nonzero(tie)
        pi, si = p[i], s[i]
        ci = np.broadcast_to(np.asarray(c, np.float64), s.shape)[i]
        bb = si - pi
        err = (pi - (si - bb)) + (ci - bb)
        s[i] = np.where(err == 0, si, np.nextafter(
            si, np.where(err > 0, np.inf, -np.inf)))
    return s.astype(_F)


# Cephes logf (XLA's float32 log): the three Estrin chains of its
# polynomial, the ln 2 split and sqrt(1/2).
_LOG_C = [_c(s) for s in (
    "3FB2043760000000", "BFBD7A3700000000", "BFBFCBA9E0000000",
    "3FC23D37E0000000", "3FC999D580000000", "BFCFFFFF80000000",
    "3FBDE4A340000000", "BFC555CA00000000", "3FD5555540000000")]
_LN2_LO = _c("BF2BD01060000000")
_LN2_HI = _c("3FE6300000000000")
_SQRT_HALF = _c("3FE6A09E60000000")
# Cephes log1p's rational for |x| < sqrt(2) - 1 (highest degree first).
_L1P_DEN = [_F(1)] + [_c(s) for s in (
    "402E2035A0000000", "4054C30B60000000", "406BB865A0000000",
    "4073519460000000", "406B0DB140000000", "404E0F3040000000")]
_L1P_NUM = [_c(s) for s in (
    "3F07BC0960000000", "3FDFE818A0000000", "401A509F40000000",
    "403DE97380000000", "404E798EC0000000", "404C8E75A0000000",
    "40340A2020000000")]
_L1P_SMALL = _c("3FDA8279A0000000")
# Giles' erf_inv polynomials, w < 5 and w >= 5 (highest degree first).
_ERFINV_LT5 = np.array([
    2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06,
    0.00021858087, -0.00125372503, -0.00417768164, 0.246640727,
    1.50140941], _F)
_ERFINV_GE5 = np.array([
    -0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844,
    0.00573950773, -0.0076224613, 0.00943887047, 1.00167406,
    2.83297682], _F)


def _logf(v):
    """XLA's float32 log of positive v (Cephes logf)."""
    bits = np.maximum(v, _F(2.0 ** -126)).view(np.uint32)
    e = ((bits >> _U(23)).astype(np.int32) - 127).astype(_F)
    m = ((bits & _U(0x7FFFFF)) | _U(0x3F000000)).view(_F)
    small = m < _SQRT_HALF
    e = (e + _F(1)) - np.where(small, _F(1), _F(0))
    x = (m - _F(1)) + np.where(small, m, _F(0))
    z = x * x
    x3 = z * x
    a = _fma(_fma(x, _LOG_C[0], _LOG_C[1]), x, _LOG_C[6])
    b = _fma(_fma(x, _LOG_C[2], _LOG_C[3]), x, _LOG_C[7])
    c = _fma(_fma(x, _LOG_C[4], _LOG_C[5]), x, _LOG_C[8])
    t = _fma(_fma(a, x3, b), x3, c)
    s = _fma(t, x3, e * _LN2_LO)
    r = _fma(-z, _F(0.5), x)
    return _fma(e, _LN2_HI, r + s)


def _log1p(x):
    """XLA's float32 log1p of x in (-1, 0]."""
    out = np.empty_like(x)
    small = np.abs(x) < _L1P_SMALL
    xs = x[small]
    den = np.full_like(xs, _L1P_DEN[0])
    num = np.full_like(xs, _L1P_NUM[0])
    for c in _L1P_DEN[1:]:
        den = _fma(den, xs, c)
    for c in _L1P_NUM[1:]:
        num = _fma(num, xs, c)
    x2 = xs * xs
    out[small] = xs + _fma(x2, _F(-0.5), (xs * x2) * (num / den))
    out[~small] = _logf(x[~small] + _F(1))
    return out


def erf_inv(x) -> np.ndarray:
    """XLA's float32 erf_inv of x in [-1, 1] (+-inf at +-1)."""
    x = np.asarray(x, _F)
    ell = _log1p(x * -x)
    out = np.empty_like(x)
    for lt, coef in ((ell > _F(-5), _ERFINV_LT5),
                     (~(ell > _F(-5)), _ERFINV_GE5)):
        e = ell[lt]
        w = (_F(-2.5) - e) if coef is _ERFINV_LT5 \
            else np.sqrt(-e) + _F(-3)
        p = np.full_like(w, coef[0])
        for c in coef[1:]:
            p = _fma(p, w, c)
        out[lt] = p * x[lt]
    edge = np.abs(x) == 1
    out[edge] = x[edge] * _F(np.inf)
    return out


#: Elements drawn at a time by `normal`, so its float64 temporaries stay
#: in cache.
_CHUNK = 1 << 16


def normal(key, shape) -> np.ndarray:
    """jax.random.normal(key, shape) in float32."""
    n = int(np.prod(shape))
    out = np.empty(n, _F)
    lo = np.nextafter(_F(-1), _F(0))
    for i in range(0, n, _CHUNK):
        u = _uniform(_bits(key, i, min(n, i + _CHUNK)), lo, 1.0)
        out[i:i + _CHUNK] = _F(np.sqrt(2)) * erf_inv(u)
    return out.reshape(shape)
