"""The port's host threefry (``repro_torch.core.threefry``) against ``jax.random``.

Keys, splits, raw bits, uniforms and normals must be bitwise equal to what
this JAX release draws (``jax_threefry_partitionable=True``), and so must
the sketch R, the RFF (W, c) and the feature maps' ``fhash``. Normals go
through erfinv, whose ``w = -log1p(-x^2)`` the port computes as XLA's CPU
backend does (Cephes' rational ``log1p`` below sqrt(2) - 1, Cephes' ``logf``
of 1 + x above, every fused step rounded once). A normal is a function of
one float32 uniform, so ``TestExhaustive`` checks ``log1p``, erfinv and the
normal on all 2^23 uniforms the draw can produce.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro import core as jcore
from repro.core import features as jfeatures
from repro_torch.core import features, projection, rff, threefry

SEEDS = [0, 7, 2**31 - 1]
SHAPES = [(1,), (7,), (3, 5), (33, 17), (4096, 1024)]
SKETCHES = [(0, 64, 16), (7, 100, 12), (2**31 - 1, 33, 33), (3, 4096, 1024)]
RFFS = [(0, 24, 64, 1.5), (7, 3, 200, 1.0), (2**31 - 1, 128, 4096, 128 ** 0.5)]


def _jkey(seed):
    return jax.random.PRNGKey(seed)


def _assert_bitwise(port, ref):
    port, ref = np.asarray(port), np.asarray(ref)
    assert port.shape == ref.shape and port.dtype == ref.dtype == np.float32
    np.testing.assert_array_equal(port.view(np.uint32), ref.view(np.uint32))


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
        """Within 0 ulp: bitwise."""
        _assert_bitwise(threefry.normal(threefry.key(seed), shape),
                        jax.random.normal(_jkey(seed), shape))

    def test_erfinv_edges(self):
        x = np.array([-1.0, 1.0, 0.0], np.float32)
        out = threefry.erfinv(x)
        np.testing.assert_array_equal(out, np.asarray(jax.lax.erf_inv(jnp.asarray(x))))


class TestExhaustive:
    """Every float32 uniform ``normal`` can draw: the 2^23 mantissas of
    ``uniform(k, shape, nextafter(-1, 0), 1)``, in four slices."""

    @staticmethod
    def _uniforms(part, parts=4):
        n = (1 << 23) // parts
        mant = np.arange(part * n, (part + 1) * n, dtype=np.uint32)
        floats = (mant | np.float32(1.0).view(np.uint32)).view(np.float32) - \
            np.float32(1.0)
        lo = np.nextafter(np.float32(-1.0), np.float32(0.0))
        u = np.maximum(lo, threefry._fma32(floats, np.float32(1.0) - lo, lo))
        return u.astype(np.float32)

    @pytest.mark.parametrize("part", range(4))
    def test_log1p_erfinv_normal_bitwise(self, part):
        u = self._uniforms(part)
        x = threefry._mul32(u, -u)
        _assert_bitwise(threefry._log1p32(x), jax.jit(jnp.log1p)(x))
        z = threefry.erfinv(u)
        _assert_bitwise(z, jax.jit(jax.lax.erf_inv)(u))
        _assert_bitwise((np.float32(np.sqrt(2.0)) * z).astype(np.float32),
                        jax.jit(lambda v: np.float32(np.sqrt(2.0))
                                * jax.lax.erf_inv(v))(u))

    def test_uniforms_are_the_draws(self):
        """The slices hold what ``uniform`` draws: a draw's values are among
        them, the lower end of the range is, and nothing reaches 1."""
        u = np.concatenate([self._uniforms(p) for p in range(4)])
        drawn = threefry.uniform(threefry.key(5), (4096,),
                                 np.nextafter(np.float32(-1.0), np.float32(0.0)))
        assert np.isin(drawn, u).all()
        assert u.min() == np.nextafter(np.float32(-1.0), np.float32(0.0))
        assert u.max() < np.float32(1.0)

    def test_log_edges(self):
        v = np.array([0.0, -0.0, -1.0, np.inf, np.nan, 1.0, 2.0**-126, 1e-40,
                      3.0e38], np.float32)
        np.testing.assert_array_equal(threefry._log32(v),
                                      np.asarray(jax.jit(jnp.log)(v)))


class TestMaps:
    @pytest.mark.parametrize("seed,d,m", SKETCHES)
    def test_make_projection_within_ulp(self, seed, d, m):
        """Within 0 ulp: bitwise."""
        R = projection.make_projection(threefry.key(seed), d, m, device="cpu")
        _assert_bitwise(R.numpy(), jcore.make_projection(_jkey(seed), d, m))

    @pytest.mark.parametrize("seed,d,D,ls", RFFS)
    def test_make_rff_c_bitwise_W_within_ulp(self, seed, d, D, ls):
        """c and W both bitwise (W within 0 ulp)."""
        ft = rff.make_rff(threefry.key(seed), d, D, lengthscale=ls, device="cpu")
        fj = jcore.make_rff(_jkey(seed), d, D, lengthscale=ls)
        _assert_bitwise(ft.c.numpy(), fj.c)
        _assert_bitwise(ft.W.numpy(), fj.W)

    def test_jax_key_is_accepted_as_numpy(self):
        jk = jax.random.split(_jkey(11))[1]
        R = projection.make_projection(np.asarray(jk), 20, 5, device="cpu")
        _assert_bitwise(R.numpy(), jcore.make_projection(jk, 20, 5))


class TestFeatureHash:
    """A map's ``fhash`` (what PROJ and RFF frames carry) is the reference's
    for the same seed, so either package's frames admit into the other's
    tenant."""

    @pytest.mark.parametrize("seed,d,m", SKETCHES)
    def test_sketch_fhash(self, seed, d, m):
        assert (features.FeatureMap("sketch", seed, d, m).fhash
                == jfeatures.FeatureMap("sketch", seed, d, m).fhash)

    @pytest.mark.parametrize("seed,d,D,ls", RFFS)
    def test_rff_fhash(self, seed, d, D, ls):
        assert (features.FeatureMap("rff", seed, d, D, ls).fhash
                == jfeatures.FeatureMap("rff", seed, d, D, ls).fhash)
