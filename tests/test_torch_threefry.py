"""The port's host threefry (``repro_torch.core.threefry``) against ``jax.random``.

Keys, splits, raw bits and uniforms must be bitwise equal to what this
JAX release draws (``jax_threefry_partitionable=True``); so must the RFF
phases c. Gaussian draws go through erfinv, whose ``w = -log1p(-x^2)`` the
port computes with numpy's float32 ``log1p``: XLA's CPU ``log1p`` differs in
its last bit for about 16% of arguments, which moves about 1.3% of the
normals, by at most 2.4e-7 where |z| < 1 and 4.8e-7 where |z| >= 1
(measured over seeds 0, 7, 2^31-1 up to (4096, 1024)).

In ulp that is at most 2, except for about 0.07% of entries at 3 ulp. These
all have |u| in [0.617, 0.683] and |z| in [0.873, 1): just below 1, where
float32 spacing halves, so the same absolute step of up to 1.8e-7 counts as
3 ulp (1.5 ulp of 1.0). A correctly rounded ``log1p`` (float64, rounded to
float32) gives the same 3-ulp entries, so only XLA's own ``log1p`` bits
would remove them. So normals are held within 2 ulp wherever |z| is outside
[0.75, 1) and within 3 ulp inside it, and at most 2% of entries may differ
at all. R and W are the port's normals divided as the reference divides
them (checked bitwise) and so within 3 ulp of the reference's.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro import core as jcore
from repro_torch.core import projection, rff, threefry

SEEDS = [0, 7, 2**31 - 1]
SHAPES = [(1,), (7,), (3, 5), (33, 17), (4096, 1024)]
MAX_ULP = 2
MAX_ULP_BELOW_ONE = 3        # where 0.75 <= |z| < 1, see the module docstring
MAX_DIFF_FRACTION = 0.02


def _jkey(seed):
    return jax.random.PRNGKey(seed)


def _assert_ulp_close(port, ref):
    port, ref = np.asarray(port, np.float32), np.asarray(ref, np.float32)
    assert port.shape == ref.shape and port.dtype == ref.dtype
    diff = np.abs(port.astype(np.float64) - ref.astype(np.float64))
    ulps = diff / np.spacing(np.abs(ref)).astype(np.float64)
    below_one = (np.abs(ref) >= 0.75) & (np.abs(ref) < 1.0)
    assert ulps[~below_one].max(initial=0.0) <= MAX_ULP, ulps[~below_one].max()
    assert ulps[below_one].max(initial=0.0) <= MAX_ULP_BELOW_ONE, ulps.max()
    assert (diff > 0).mean() <= MAX_DIFF_FRACTION, (diff > 0).mean()


def _assert_map_close(port, ref, key, divisor):
    """A map is a normal divided by a float32 constant, as the reference
    divides it: bitwise so from the port's own normal; against the
    reference's map the division's rounding moves the binade edges, so its
    3-ulp entries are not confined as the normals' are."""
    port, ref = np.asarray(port, np.float32), np.asarray(ref, np.float32)
    z = threefry.normal(key, port.shape)
    np.testing.assert_array_equal(port.view(np.uint32),
                                  (z / np.float32(divisor)).view(np.uint32))
    diff = np.abs(port.astype(np.float64) - ref.astype(np.float64))
    ulps = diff / np.spacing(np.abs(ref)).astype(np.float64)
    assert ulps.max() <= MAX_ULP_BELOW_ONE, ulps.max()
    assert (diff > 0).mean() <= MAX_DIFF_FRACTION, (diff > 0).mean()


class TestKeysAndBits:
    @pytest.mark.parametrize("seed", SEEDS + [-1, -5, 2**31, 2**32 + 5, 2**63 - 1])
    def test_key_equals_prngkey(self, seed):
        np.testing.assert_array_equal(threefry.key(seed),
                                      np.asarray(_jkey(seed)))

    def test_key_range_and_type_checks(self):
        with pytest.raises(OverflowError):
            threefry.key(2**63)
        with pytest.raises(TypeError, match="uint32"):
            threefry.split(np.array([1, 2], np.int64))

    @pytest.mark.parametrize("seed", SEEDS)
    @pytest.mark.parametrize("num", [1, 2, 3, 5, 8])
    def test_split_bitwise(self, seed, num):
        np.testing.assert_array_equal(
            threefry.split(threefry.key(seed), num),
            np.asarray(jax.random.split(_jkey(seed), num)))

    @pytest.mark.parametrize("seed", SEEDS)
    def test_nested_split_bitwise(self, seed):
        kt = threefry.split(threefry.split(threefry.key(seed), 3)[2], 2)[1]
        kj = jax.random.split(jax.random.split(_jkey(seed), 3)[2], 2)[1]
        np.testing.assert_array_equal(kt, np.asarray(kj))

    @pytest.mark.parametrize("seed", SEEDS)
    @pytest.mark.parametrize("shape", SHAPES)
    def test_random_bits_bitwise(self, seed, shape):
        np.testing.assert_array_equal(
            threefry.random_bits(threefry.key(seed), shape),
            np.asarray(jax.random.bits(_jkey(seed), shape)))


class TestFloats:
    @pytest.mark.parametrize("seed", SEEDS)
    @pytest.mark.parametrize("shape", SHAPES)
    @pytest.mark.parametrize("lo,hi", [(0.0, 1.0), (0.0, 2.0 * np.pi),
                                       (-3.0, 0.5)])
    def test_uniform_bitwise(self, seed, shape, lo, hi):
        port = threefry.uniform(threefry.key(seed), shape, lo, hi)
        ref = np.asarray(jax.random.uniform(_jkey(seed), shape, jnp.float32,
                                            lo, hi))
        assert port.dtype == np.float32
        np.testing.assert_array_equal(port.view(np.uint32), ref.view(np.uint32))

    @pytest.mark.parametrize("seed", SEEDS)
    @pytest.mark.parametrize("shape", SHAPES)
    def test_normal_within_ulp(self, seed, shape):
        _assert_ulp_close(threefry.normal(threefry.key(seed), shape),
                          jax.random.normal(_jkey(seed), shape))

    def test_erfinv_edges(self):
        x = np.array([-1.0, 1.0, 0.0], np.float32)
        out = threefry.erfinv(x)
        np.testing.assert_array_equal(out, np.asarray(jax.lax.erf_inv(jnp.asarray(x))))


class TestMaps:
    @pytest.mark.parametrize("seed,d,m", [(0, 64, 16), (7, 100, 12),
                                          (2**31 - 1, 33, 33), (3, 4096, 1024)])
    def test_make_projection_within_ulp(self, seed, d, m):
        R = projection.make_projection(threefry.key(seed), d, m, device="cpu")
        _assert_map_close(R.numpy(), jcore.make_projection(_jkey(seed), d, m),
                          threefry.key(seed), np.sqrt(np.float32(m)))

    @pytest.mark.parametrize("seed,d,D,ls", [(0, 24, 64, 1.5), (7, 3, 200, 1.0),
                                             (2**31 - 1, 128, 4096, 128 ** 0.5)])
    def test_make_rff_c_bitwise_W_within_ulp(self, seed, d, D, ls):
        ft = rff.make_rff(threefry.key(seed), d, D, lengthscale=ls, device="cpu")
        fj = jcore.make_rff(_jkey(seed), d, D, lengthscale=ls)
        np.testing.assert_array_equal(ft.c.numpy().view(np.uint32),
                                      np.asarray(fj.c).view(np.uint32))
        _assert_map_close(ft.W.numpy(), fj.W, threefry.split(threefry.key(seed))[0],
                          ls)

    def test_jax_key_is_accepted_as_numpy(self):
        jk = jax.random.split(_jkey(11))[1]
        R = projection.make_projection(np.asarray(jk), 20, 5, device="cpu")
        _assert_map_close(R.numpy(), jcore.make_projection(jk, 20, 5),
                          np.asarray(jk), np.sqrt(np.float32(5)))
