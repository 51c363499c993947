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
- ``fold_in(key, data)``: threefry of the counter pair ``(0, data)``, as
  ``jax.random.fold_in`` hashes ``threefry_seed(data)`` under the key.
- ``permutation(key, n)``: ``arange(n)`` stably sorted by 32 random bits
  per round, ``ceil(3 ln n / ln(2^32 - 1))`` rounds, the key split each
  round (``jax.random.permutation``'s ``_shuffle``).
- ``uniform(key, shape, minval, maxval)``: float32 from the top 23 bits,
  ``(bits >> 9 | 0x3F800000) - 1``, scaled and shifted by one fused
  multiply-add, and clamped below at ``minval``.
- ``normal(key, shape)``: ``sqrt(2) * erfinv(u)`` for u uniform on
  (nextafter(-1, 0), 1), with XLA's float32 erfinv polynomial (Giles), each
  Horner step one fused multiply-add, and ``w = -log1p(-x^2)`` computed as
  XLA's CPU backend computes it (``_log1p32``, ``_log32``).

Keys, bits, uniforms and normals are bitwise equal to JAX's; the tests
check the normal on every uniform the draw can produce. So the §IV-F maps'
bytes, and their ``fhash``, are the reference's for the same seed.
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

# Cephes' float32 log (XLA's CPU ``log``): polynomial, highest degree first,
# and the split of log(2) into q2 + q1.
_LOG_P = np.array(
    [7.0376836292e-2, -1.1514610310e-1, 1.1676998740e-1, -1.2420140846e-1,
     1.4249322787e-1, -1.6668057665e-1, 2.0000714765e-1, -2.4999993993e-1,
     3.3333331174e-1], np.float32)
_LOG_Q1 = np.float32(-2.12194440e-4)
_LOG_Q2 = np.float32(0.693359375)
_MIN_NORMAL = np.array(0x00800000, _U32).view(np.float32)
# Cephes' log1p rational approximation (XLA's CPU ``log1p`` below
# sqrt(2) - 1): numerator and denominator, highest degree first.
_LOG1P_NUM = np.array(
    [4.5270000862445199635215e-5, 4.9854102823193375972212e-1,
     6.5787325942061044846969e0, 2.9911919328553073277375e1,
     6.0949667980987787057556e1, 5.7112963590585538103336e1,
     2.0039553499201281259648e1], np.float32)
_LOG1P_DEN = np.array(
    [1.0, 1.5062909083469192043167e1, 8.3047565967967209469434e1,
     2.2176239823732856465394e2, 3.0909872225312059774938e2,
     2.1642788614495947685003e2, 6.0118660497603843919306e1], np.float32)


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


def fold_in(k, data: int) -> np.ndarray:
    """``jax.random.fold_in(k, data)``: a new key from ``k`` and a uint32."""
    k1, k2 = _as_key(k)
    x1, x2 = np.zeros(1, _U32), np.array([int(data) & _MASK], _U32)
    with np.errstate(over="ignore"):
        bits1, bits2 = threefry_2x32(k1, k2, x1, x2)
    return np.concatenate([bits1, bits2])


def permutation(k, n: int) -> np.ndarray:
    """``jax.random.permutation(k, n)``: a shuffled ``arange(n)`` (int32).

    Each round splits the key, draws 32 bits per element from the subkey and
    sorts by them stably, as ``lax.sort_key_val`` does.
    """
    n = int(n)
    x = np.arange(n, dtype=np.int32)
    rounds = int(np.ceil(3 * np.log(max(1, n)) / np.log(_MASK)))
    for _ in range(rounds):
        k, sub = split(k)
        x = x[np.argsort(random_bits(sub, (n,)), kind="stable")]
    return x


def _fma32(a, b, c) -> np.ndarray:
    """float32 a*b + c rounded once, as a fused multiply-add rounds it.

    The product of two float32 values is exact in float64, so only the sum
    rounds twice: to float64, then to float32. That double rounding errs
    only where the float64 sum lands exactly halfway between two float32
    neighbours; there the sum's own rounding error says which way the exact
    value lies, and the sum is nudged one float64 step towards it.
    """
    p = np.asarray(a, np.float32).astype(np.float64) * np.asarray(b, np.float32)
    c = np.broadcast_to(np.asarray(c, np.float32).astype(np.float64), p.shape)
    s = p + c
    tie = (s.view(np.uint64) & np.uint64(0x1FFFFFFF)) == np.uint64(0x10000000)
    if tie.any():
        pt, ct, st = p[tie], c[tie], s[tie]
        bt = st - pt
        err = (pt - (st - bt)) + (ct - bt)
        s[tie] = np.where(err == 0, st, np.nextafter(st, np.where(err > 0, np.inf, -np.inf)))
    return s.astype(np.float32)


def _mul32(a, b) -> np.ndarray:
    return (np.asarray(a, np.float32) * np.asarray(b, np.float32)).astype(np.float32)


def _add32(a, b) -> np.ndarray:
    return (np.asarray(a, np.float32) + np.asarray(b, np.float32)).astype(np.float32)


def _log32(v: np.ndarray) -> np.ndarray:
    """XLA's CPU float32 ``log``: Cephes' ``logf`` as XLA emits it.

    ``frexp`` with the mantissa in [sqrt(1/2), sqrt(2)), the degree-8
    polynomial split in three (Estrin) with every step one fused
    multiply-add, ``y * x^3 + q1 * e`` fused too, then float32 adds of
    ``-x^2 / 2`` and ``q2 * e``. Zero and subnormals give -inf (XLA's CPU
    code treats subnormals as zero), negatives and NaN give NaN, +inf stays
    +inf.
    """
    v = np.asarray(v, np.float32)
    bits = np.maximum(v, _MIN_NORMAL).view(_U32)
    e = _add32(np.float32(1.0),
               ((bits >> _U32(23)).astype(np.int32) - 0x7F).astype(np.float32))
    x = ((bits & _U32(0x807FFFFF)) | _U32(0x3F000000)).view(np.float32)
    small = x < np.float32(0.707106781186547524)
    x_small = np.where(small, x, np.float32(0.0))
    x = _add32(_add32(x, np.float32(-1.0)), x_small)
    e = _add32(e, np.where(small, np.float32(-1.0), np.float32(0.0)))
    x2 = _mul32(x, x)
    x3 = _mul32(x2, x)
    p = _LOG_P
    y = _fma32(_fma32(x, p[0], p[1]), x, p[2])
    y1 = _fma32(_fma32(x, p[3], p[4]), x, p[5])
    y2 = _fma32(_fma32(x, p[6], p[7]), x, p[8])
    y = _fma32(_fma32(y, x3, y1), x3, y2)
    y = _fma32(y, x3, _mul32(_LOG_Q1, e))
    out = _add32(_add32(_add32(x, -_mul32(np.float32(0.5), x2)), y),
                 _mul32(_LOG_Q2, e))
    out = np.where(v < _MIN_NORMAL, np.float32(-np.inf), out)
    out = np.where(v == np.float32(np.inf), np.float32(np.inf), out)
    return np.where(~(v >= np.float32(0.0)), np.float32(np.nan),
                    out).astype(np.float32)


def _log1p32(x: np.ndarray) -> np.ndarray:
    """XLA's CPU float32 ``log1p``: Cephes' rational approximation below
    |x| = sqrt(2) - 1 (every Horner step and the ``-x^2/2`` term fused),
    ``log(1 + x)`` at and above it."""
    x = np.asarray(x, np.float32)
    out = np.empty_like(x)
    near = np.abs(x) < np.float32(0.41421356237309504880)
    xn = x[near]
    x2 = _mul32(xn, xn)
    num = np.full_like(xn, _LOG1P_NUM[0])
    for c in _LOG1P_NUM[1:]:
        num = _fma32(num, xn, c)
    den = np.full_like(xn, _LOG1P_DEN[0])
    for c in _LOG1P_DEN[1:]:
        den = _fma32(den, xn, c)
    ratio = (num / den).astype(np.float32)
    out[near] = _add32(xn, _fma32(np.float32(-0.5), x2,
                                  _mul32(_mul32(xn, x2), ratio)))
    far = ~near
    out[far] = _log32(_add32(x[far], np.float32(1.0)))
    return out


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
        w = -_log1p32(_mul32(x, -x))
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
    """``jax.random.normal(k, shape, float32)``."""
    lo = np.nextafter(np.float32(-1.0), np.float32(0.0))
    u = uniform(k, shape, lo, 1.0)
    return (np.float32(math.sqrt(2.0)) * erfinv(u)).astype(np.float32)
