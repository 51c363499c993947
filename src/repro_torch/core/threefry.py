"""Threefry-2x32 random numbers on the host, as the JAX package draws them.

The §IV-F feature maps (``core/features.py``) are identified by a seed:
every participant regenerates the same sketch R, or the same RFF (W, c),
from it. The JAX package draws those arrays with ``jax.random``'s default
generator, so this module reproduces that generator in numpy, for the
configuration the reference runs (``jax_threefry_partitionable=True``, the
default of current JAX releases):

- ``key(seed)``: the raw uint32 key pair ``[0, seed & 0xFFFFFFFF]``; with
  64-bit mode off (the reference's setting) JAX keeps the seed's low 32 bits.
- ``split(key, n)``: threefry of the (hi, lo) halves of a 64-bit iota of
  shape (n,); key i is ``(bits1[i], bits2[i])``.
- ``random_bits(key, shape)``: the same iota over ``shape``,
  ``bits1 ^ bits2``.
- ``uniform(key, shape, minval, maxval)``: float32 from the top 23 bits,
  ``(bits >> 9 | 0x3F800000) - 1``, scaled and shifted by one fused
  multiply-add, and clamped below at ``minval``.
- ``normal(key, shape)``: ``sqrt(2) * erfinv(u)`` for u uniform on
  (nextafter(-1, 0), 1), with XLA's float32 erfinv polynomial (Giles) and
  each Horner step one fused multiply-add.

Keys, bits and uniforms are bitwise equal to JAX's. Normals are not: ``w =
-log1p(-x^2)`` uses numpy's float32 ``log1p``, whose last bit differs from
XLA's CPU ``log1p`` in about 16% of entries; the polynomial carries that to
about 1.3% of the normals, by at most 2 ulp, except about 0.07% at 3 ulp,
all with |z| in [0.873, 1) where float32 spacing halves (4.8e-7 absolute at
most, at (4096, 1024)). Given XLA's ``w``, the polynomial here reproduces
JAX's normals bitwise. A Horner step is a float64 product and sum rounded once to
float32, which differs from a true fused multiply-add only where that
double rounding matters.
"""
from __future__ import annotations

import math

import numpy as np

_U32 = np.uint32
_MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA

# XLA's float32 erfinv (chlo.erf_inv): Horner coefficients, highest degree
# first, for w = -log1p(-x^2) below 5 and at or above 5.
_ERFINV_LT5 = np.array(
    [2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06,
     0.00021858087, -0.00125372503, -0.00417768164, 0.246640727, 1.50140941],
    np.float32)
_ERFINV_GE5 = np.array(
    [-0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844,
     0.00573950773, -0.0076224613, 0.00943887047, 1.00167406, 2.83297682],
    np.float32)


def key(seed: int) -> np.ndarray:
    """The raw key of ``jax.random.PRNGKey(seed)``: uint32 ``[0, seed mod 2^32]``."""
    seed = int(seed)
    if not -2**63 <= seed < 2**63:
        raise OverflowError(f"seed {seed} does not fit in a signed 64-bit integer")
    return np.array([0, seed & _MASK], dtype=_U32)


def _as_key(k) -> tuple[np.ndarray, np.ndarray]:
    arr = np.asarray(k)
    if arr.shape != (2,) or arr.dtype != _U32:
        raise TypeError(f"a key is a uint32 pair of shape (2,), got "
                        f"{arr.dtype} {arr.shape}")
    return arr[0:1].copy(), arr[1:2].copy()


def _rotl(x: np.ndarray, r: int) -> np.ndarray:
    return (x << _U32(r)) | (x >> _U32(32 - r))


def threefry_2x32(k1, k2, x1: np.ndarray, x2: np.ndarray
                  ) -> tuple[np.ndarray, np.ndarray]:
    """Threefry-2x32 with 20 rounds of the counter pair (x1, x2) under (k1, k2).

    All arguments are uint32 (keys broadcast against the counters).
    """
    ks = (k1, k2, k1 ^ k2 ^ _U32(_PARITY))
    x1 = x1 + ks[0]
    x2 = x2 + ks[1]
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x1 = x1 + x2
            x2 = _rotl(x2, r)
            x2 = x1 ^ x2
        x1 = x1 + ks[(i + 1) % 3]
        x2 = x2 + ks[(i + 2) % 3] + _U32(i + 1)
    return x1, x2


def _iota_2x32(shape: tuple[int, ...]) -> tuple[np.ndarray, np.ndarray]:
    """(hi, lo) uint32 halves of a row-major 64-bit iota of ``shape``."""
    idx = np.arange(math.prod(shape), dtype=np.uint64).reshape(shape)
    return ((idx >> np.uint64(32)).astype(_U32),
            (idx & np.uint64(_MASK)).astype(_U32))


def _hash(k, shape) -> tuple[np.ndarray, np.ndarray]:
    k1, k2 = _as_key(k)
    hi, lo = _iota_2x32(tuple(int(s) for s in shape))
    with np.errstate(over="ignore"):
        return threefry_2x32(k1, k2, hi, lo)


def split(k, num: int = 2) -> np.ndarray:
    """``jax.random.split(k, num)``: a (num, 2) uint32 array of keys."""
    bits1, bits2 = _hash(k, (int(num),))
    return np.stack([bits1, bits2], axis=-1)


def random_bits(k, shape) -> np.ndarray:
    """``jax.random.bits(k, shape)`` (32-bit): uint32 of ``shape``."""
    bits1, bits2 = _hash(k, tuple(shape))
    return bits1 ^ bits2


def _fma32(a, b, c) -> np.ndarray:
    """float32 a*b + c with the product exact (float64) and one final rounding."""
    return (np.asarray(a, np.float64) * np.asarray(b, np.float64)
            + np.asarray(c, np.float64)).astype(np.float32)


def uniform(k, shape, minval: float = 0.0, maxval: float = 1.0) -> np.ndarray:
    """``jax.random.uniform(k, shape, float32, minval, maxval)``."""
    lo, hi = np.float32(minval), np.float32(maxval)
    bits = random_bits(k, shape)
    one = np.array(1.0, np.float32).view(_U32)
    floats = ((bits >> _U32(9)) | one).view(np.float32) - np.float32(1.0)
    # XLA contracts floats * (hi - lo) + lo into one fused multiply-add
    return np.maximum(lo, _fma32(floats, hi - lo, lo))


def erfinv(x: np.ndarray) -> np.ndarray:
    """XLA's float32 erfinv polynomial, elementwise on float32 ``x``."""
    x = np.asarray(x, np.float32)
    with np.errstate(divide="ignore", invalid="ignore"):
        w = -np.log1p(x * -x)
        lt = w < np.float32(5.0)
        w = np.where(lt, w - np.float32(2.5),
                     np.sqrt(w) - np.float32(3.0)).astype(np.float32)
        p = np.where(lt, _ERFINV_LT5[0], _ERFINV_GE5[0]).astype(np.float32)
        for c_lt, c_ge in zip(_ERFINV_LT5[1:], _ERFINV_GE5[1:]):
            coef = np.where(lt, c_lt, c_ge).astype(np.float32)
            p = _fma32(p, w, coef)
        out = p * x
        return np.where(np.abs(x) == np.float32(1.0),
                        x * np.float32(np.inf), out).astype(np.float32)


def normal(k, shape) -> np.ndarray:
    """``jax.random.normal(k, shape, float32)``, within 2 ulp (3 just below 1)."""
    lo = np.nextafter(np.float32(-1.0), np.float32(0.0))
    u = uniform(k, shape, lo, 1.0)
    return (np.float32(math.sqrt(2.0)) * erfinv(u)).astype(np.float32)
