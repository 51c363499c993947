"""Algorithm 2 in the port (``repro_torch.core.privacy``) against the reference.

The reference's own privacy tests run on the port first (Gaussian mechanism,
composition, PSD repair). Then the two packages side by side, fed the same
numpy-made inputs: the formulas are equal, ``threefry.fold_in`` and
``threefry.permutation`` are ``jax.random``'s bits, the Gaussian mechanism's
noise is JAX's bit for bit for the same key (and so is the noisy statistic
when both packages start from the same statistics), statistics computed by
each package from the same rows agree at 1e-6, and ``psd_repair`` (LAPACK's
``eigh`` on both sides, through different builds) agrees at 1e-5.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _hypo import hypothesis, st
from repro import core as jcore
from repro.core import privacy as jpriv
from repro_torch import core
from repro_torch.convert import key_from, suffstats_from
from repro_torch.core import privacy, threefry


def _normal(shape, seed, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)
            ).astype(np.float32)


def _stats(n=100, d=6, seed=0):
    A, b = _normal((n, d), seed), _normal((n,), seed + 1)
    return core.compute_stats(torch.from_numpy(A), torch.from_numpy(b))


# -- tests/test_privacy.py, on the port ----------------------------------------

class TestGaussianMechanism:
    def test_tau_formula(self):
        # Alg 2 line 1: tau = Delta sqrt(2 ln(1.25/delta)) / eps
        tau = privacy.gaussian_tau(2.0, 1e-5)
        assert abs(tau - math.sqrt(2 * math.log(1.25e5)) / 2.0) < 1e-12

    @hypothesis.given(eps=st.floats(0.05, 20.0), delta=st.floats(1e-8, 0.5,
                                                                 exclude_max=True))
    @hypothesis.settings(max_examples=30, deadline=None)
    def test_tau_monotonicity(self, eps, delta):
        """More privacy (smaller eps/delta) always means more noise."""
        tau = privacy.gaussian_tau(eps, delta)
        assert tau > 0
        assert privacy.gaussian_tau(eps / 2, delta) > tau
        assert privacy.gaussian_tau(eps, delta / 10) > tau

    def test_invalid_params(self):
        with pytest.raises(ValueError):
            privacy.gaussian_tau(0.0, 1e-5)
        with pytest.raises(ValueError):
            privacy.gaussian_tau(1.0, 1.5)

    def test_clip_enforces_sensitivity(self):
        A = torch.from_numpy(_normal((50, 8), 0, 100.0))
        b = torch.from_numpy(_normal((50,), 1, 100.0))
        Ac, bc = privacy.clip_rows(A, b)
        assert float(torch.linalg.vector_norm(Ac, dim=1).max()) <= 1.0 + 1e-5
        assert float(bc.abs().max()) <= 1.0

    def test_privatize_symmetric_and_unbiased(self):
        s = _stats()
        outs = [privacy.privatize_stats(threefry.key(i), s, 1.0, 1e-5)
                for i in range(64)]
        for o in outs[:4]:
            np.testing.assert_allclose(o.gram, o.gram.T, atol=1e-4)
        mean_g = np.mean([o.gram.numpy() for o in outs], axis=0)
        tau = privacy.gaussian_tau(1.0, 1e-5)
        assert np.abs(mean_g - s.gram.numpy()).max() < 4 * tau / math.sqrt(64) * 3

    def test_noise_scale_matches_tau(self):
        d = 50
        s = core.SuffStats(torch.zeros((d, d)), torch.zeros((d,)),
                           torch.tensor(0, dtype=torch.int32))
        o = privacy.privatize_stats(threefry.key(0), s, 0.5, 1e-5)
        tau = privacy.gaussian_tau(0.5, 1e-5)
        emp = float(o.gram.numpy().std())
        assert 0.8 * tau < emp < 1.2 * tau  # symmetrization preserves variance


class TestComposition:
    def test_theorem_7_formula(self):
        eps0, delta0, R = 0.1, 1e-5, 100
        total = privacy.advanced_composition(eps0, delta0, R)
        manual = math.sqrt(2 * R * math.log(1 / delta0)) * eps0 + \
            R * eps0 * (math.e ** eps0 - 1)
        assert abs(total - manual) < 1e-9

    def test_composition_grows_sqrt(self):
        # O(sqrt(R)) growth: eps(4R)/eps(R) ~ 2 in the sqrt-dominated regime
        e1 = privacy.advanced_composition(0.01, 1e-6, 100)
        e4 = privacy.advanced_composition(0.01, 1e-6, 400)
        assert 1.8 < e4 / e1 < 2.3

    def test_one_shot_has_no_composition(self):
        """Same total budget: per-round noise for R rounds >> one-shot noise."""
        eps = 2.0
        tau_oneshot = privacy.gaussian_tau(eps, 1e-5)
        tau_per_round = privacy.gaussian_tau(
            privacy.per_round_budget(eps, 100), 1e-5)
        assert tau_per_round > 5 * tau_oneshot


class TestPSDRepair:
    def test_projects_to_psd(self):
        A = torch.from_numpy(_normal((40, 12), 0))
        s = core.compute_stats(A, torch.zeros(40))
        noisy = privacy.privatize_stats(threefry.key(1), s, 0.05, 1e-5)
        fixed = privacy.psd_repair(noisy)
        evals = np.linalg.eigvalsh(fixed.gram.numpy())
        assert evals.min() >= -1e-4

    def test_noop_on_psd_input(self):
        A = torch.from_numpy(_normal((40, 12), 0))
        s = core.compute_stats(A, torch.zeros(40))
        fixed = privacy.psd_repair(s)
        np.testing.assert_allclose(fixed.gram, s.gram, rtol=1e-3, atol=1e-3)


# -- the port against the reference --------------------------------------------

SEEDS = [0, 1, 7, 42, 2**31 - 1, 123456789]


class TestFormulasMatch:
    @pytest.mark.parametrize("eps,delta,sens", [(1.0, 1e-5, 1.0), (0.05, 1e-8, 3.0),
                                                (20.0, 0.4, 0.5)])
    def test_gaussian_tau(self, eps, delta, sens):
        assert privacy.gaussian_tau(eps, delta, sens) == \
            jpriv.gaussian_tau(eps, delta, sens)

    @pytest.mark.parametrize("eps0,delta0,rounds", [(0.1, 1e-5, 100), (0.01, 1e-6, 400),
                                                    (1.0, 1e-3, 1)])
    def test_advanced_composition_and_budget(self, eps0, delta0, rounds):
        assert privacy.advanced_composition(eps0, delta0, rounds) == \
            jpriv.advanced_composition(eps0, delta0, rounds)
        assert privacy.per_round_budget(eps0, rounds) == \
            jpriv.per_round_budget(eps0, rounds)

    @pytest.mark.parametrize("clip", [(1.0, 1.0), (3.0, 0.5)])
    def test_sensitivities_and_clip_rows(self, clip):
        assert privacy.sensitivities(*clip) == jpriv.sensitivities(*clip)
        A, b = _normal((40, 9), 3, 2.0), _normal((40,), 4, 2.0)
        At, bt = privacy.clip_rows(torch.from_numpy(A), torch.from_numpy(b),
                                   clip_a=clip[0], clip_b=clip[1])
        Aj, bj = jpriv.clip_rows(jnp.asarray(A), jnp.asarray(b),
                                 clip_a=clip[0], clip_b=clip[1])
        np.testing.assert_allclose(At.numpy(), np.asarray(Aj), rtol=1e-6, atol=1e-7)
        np.testing.assert_array_equal(bt.numpy(), np.asarray(bj))


class TestThreefryDraws:
    @pytest.mark.parametrize("seed", SEEDS)
    def test_fold_in_bits(self, seed):
        for data in (0, 1, 2, 3, 19, 255, 1000, 2**31 - 1, 2**32 - 1):
            np.testing.assert_array_equal(
                threefry.fold_in(threefry.key(seed), data),
                np.asarray(jax.random.fold_in(jax.random.PRNGKey(seed), data)))

    @pytest.mark.parametrize("seed", SEEDS)
    @pytest.mark.parametrize("n", [1, 2, 5, 8, 20, 97, 1700])
    def test_permutation_bits(self, seed, n):
        """Below ~1600 elements one sort round, above it two."""
        got = threefry.permutation(threefry.key(seed), n)
        want = np.asarray(jax.random.permutation(jax.random.PRNGKey(seed), n))
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)

    def test_key_from_a_jax_key(self):
        k = jax.random.fold_in(jax.random.PRNGKey(3), 5)
        np.testing.assert_array_equal(
            threefry.fold_in(key_from(k), 9),
            np.asarray(jax.random.fold_in(k, 9)))


def _both_stats(n=60, d=12, seed=0):
    A, b = _normal((n, d), seed), _normal((n,), seed + 1)
    js = jcore.compute_stats(jnp.asarray(A), jnp.asarray(b))
    return js, suffstats_from(js, device="cpu"), (A, b)


class TestMechanismMatches:
    @pytest.mark.parametrize("d", [1, 12, 64, 129])
    @pytest.mark.parametrize("seed", [0, 5, 2**31 - 1])
    def test_privatize_stats_bitwise(self, d, seed):
        """Same statistics in, same key: the noisy statistics are equal
        bitwise, so the noise is."""
        js, ts, _ = _both_stats(d=d, seed=seed % 97)
        kw = dict(sensitivity_g=2.5, sensitivity_h=1.5)
        jo = jpriv.privatize_stats(jax.random.PRNGKey(seed), js, 0.7, 1e-5, **kw)
        to = privacy.privatize_stats(threefry.key(seed), ts, 0.7, 1e-5, **kw)
        np.testing.assert_array_equal(to.gram.numpy(), np.asarray(jo.gram))
        np.testing.assert_array_equal(to.moment.numpy(), np.asarray(jo.moment))
        assert int(to.count) == int(jo.count)
        np.testing.assert_array_equal(to.gram.numpy(), to.gram.numpy().T)

    @pytest.mark.parametrize("seed", [0, 3])
    def test_privatize_own_stats_close(self, seed):
        """Each package's own Phase 1 on the same rows, then the mechanism:
        the noise terms are equal bitwise, the statistics within 1e-6."""
        _, _, (A, b) = _both_stats(seed=seed)
        js = jcore.compute_stats(jnp.asarray(A), jnp.asarray(b))
        ts = core.compute_stats(torch.from_numpy(A), torch.from_numpy(b))
        jo = jpriv.privatize_stats(jax.random.PRNGKey(seed), js, 2.0, 1e-5)
        to = privacy.privatize_stats(threefry.key(seed), ts, 2.0, 1e-5)
        kg, kh = threefry.split(threefry.key(seed))
        tau = privacy.gaussian_tau(2.0, 1e-5)
        E = threefry.normal(kg, (12, 12)) * np.float32(tau)
        E = (E + E.T) / np.float32(math.sqrt(2.0))
        jE = np.asarray(jax.random.normal(jax.random.split(jax.random.PRNGKey(seed))[0],
                                          (12, 12)) * tau)
        np.testing.assert_array_equal(E, (jE + jE.T) / jnp.sqrt(2.0))
        scale = float(np.abs(np.asarray(jo.gram)).max())
        np.testing.assert_allclose(to.gram.numpy(), np.asarray(jo.gram),
                                   rtol=0, atol=1e-6 * scale)
        np.testing.assert_allclose(to.moment.numpy(), np.asarray(jo.moment),
                                   rtol=0, atol=1e-6 * scale)

    @pytest.mark.parametrize("d", [4, 33])
    def test_make_dp_noise_fn_bitwise(self, d):
        js, ts, _ = _both_stats(d=d, seed=d)
        jfn = jpriv.make_dp_noise_fn(jax.random.PRNGKey(77), 1.0, 1e-5, d)
        tfn = privacy.make_dp_noise_fn(threefry.key(77), 1.0, 1e-5, d)
        for i in (0, 1, 2, 7, 31):
            gj, hj = jfn(jnp.asarray(i, jnp.int32), js.gram, js.moment)
            gt, ht = tfn(i, ts.gram, ts.moment)
            np.testing.assert_array_equal(gt.numpy(), np.asarray(gj))
            np.testing.assert_array_equal(ht.numpy(), np.asarray(hj))

    def test_central_dp_stats_bitwise(self):
        js, ts, _ = _both_stats(d=10, seed=9)
        jo = jpriv.central_dp_stats(jax.random.PRNGKey(9), js, 1.0, 1e-5, n_clients=3)
        to = privacy.central_dp_stats(threefry.key(9), ts, 1.0, 1e-5, n_clients=3)
        np.testing.assert_array_equal(to.gram.numpy(), np.asarray(jo.gram))
        np.testing.assert_array_equal(to.moment.numpy(), np.asarray(jo.moment))

    @pytest.mark.parametrize("eps", [0.05, 1.0])
    @pytest.mark.parametrize("floor", [0.0, 0.5])
    def test_psd_repair_close(self, eps, floor):
        js, ts, _ = _both_stats(d=12, seed=4)
        jn = jpriv.privatize_stats(jax.random.PRNGKey(1), js, eps, 1e-5)
        tn = privacy.privatize_stats(threefry.key(1), ts, eps, 1e-5)
        jr, tr = jpriv.psd_repair(jn, floor), privacy.psd_repair(tn, floor)
        scale = float(np.abs(np.asarray(jr.gram)).max())
        np.testing.assert_allclose(tr.gram.numpy(), np.asarray(jr.gram),
                                   rtol=0, atol=1e-5 * scale)
        np.testing.assert_array_equal(tr.moment.numpy(), tn.moment.numpy())
        assert np.linalg.eigvalsh(tr.gram.numpy().astype(np.float64)).min() \
            >= floor - 1e-4 * scale

    def test_psd_repair_keeps_yty(self):
        s = _stats()
        assert privacy.psd_repair(s).yty is s.yty

    def test_privatization_drops_moments(self):
        """tests/test_inference.py's check: an un-noised sum y^2 next to
        privatized (G, h) leaks, so both packages drop it."""
        js, ts, _ = _both_stats()
        assert ts.yty is not None and js.yty is not None
        assert privacy.privatize_stats(threefry.key(0), ts, 1.0, 1e-5).yty is None
        assert jpriv.privatize_stats(jax.random.PRNGKey(0), js, 1.0, 1e-5).yty is None

    @pytest.mark.parametrize("which", ["privatize", "noise_fn"])
    def test_float64_statistics_raise(self, which):
        s = _stats()
        s64 = core.SuffStats(s.gram.double(), s.moment.double(), s.count)
        with pytest.raises(ValueError, match="float32"):
            if which == "privatize":
                privacy.privatize_stats(threefry.key(0), s64, 1.0, 1e-5)
            else:
                privacy.make_dp_noise_fn(threefry.key(0), 1.0, 1e-5, 6)(
                    0, s64.gram, s64.moment)

    def test_core_exports_the_reference_names(self):
        # distributed_stats came with the sharded backend: every name now
        assert set(core.__all__) == set(jcore.__all__)
