"""The §III equilibrium certificate and its CG solve in the port
(``repro_torch.core.equilibrium``) against the reference.

The reference's two equilibrium tests run on the port, on the reference's
own rows (``jax.random``, carried over as numpy). Then both packages take the
same statistics: the residual, its error bound and the CG weights agree at
1e-5, for iteration caps that stop CG before it converges, for the default
cap, and for a tolerance that the stop rule meets first.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import core as jcore
from repro_torch import core
from repro_torch.convert import suffstats_from


def _problem(seed=0, n=240, d=12):
    k1, k2 = jax.random.split(jax.random.PRNGKey(seed))
    A = jax.random.normal(k1, (n, d))
    b = jax.random.normal(k2, (n,))
    return A, b


def _stats(seed=0, n=240, d=12):
    """The reference's statistics of ``_problem`` and the port's copy."""
    js = jcore.compute_stats(*_problem(seed, n, d))
    return js, suffstats_from(js, device="cpu")


def _rel(x, ref) -> float:
    x, ref = np.asarray(x, np.float64), np.asarray(ref, np.float64)
    return float(np.abs(x - ref).max() / max(np.abs(ref).max(), 1e-30))


class TestReferenceChecks:
    """tests/test_core_fusion.py's equilibrium tests, on the port."""

    def test_equilibrium_certificate(self):
        """The solution is the unique zero of the stationarity residual."""
        A, b = (torch.from_numpy(np.array(x)) for x in _problem())
        s = core.compute_stats(A, b)
        w = core.solve_ridge(s, 0.1)
        r = core.equilibrium_residual(s, 0.1, w)
        assert float(torch.linalg.vector_norm(r)) < 1e-3
        bound = core.residual_bound(s, 0.1, w + 0.01)
        true_err = float(torch.linalg.vector_norm(0.01 * torch.ones_like(w)))
        assert float(bound) >= true_err * 0.99

    def test_cg_matches_cholesky(self):
        A, b = (torch.from_numpy(np.array(x)) for x in _problem())
        s = core.compute_stats(A, b)
        w_chol = core.solve_ridge(s, 0.05)
        w_cg = core.solve_cg(s, 0.05, iters=200)
        np.testing.assert_allclose(w_cg, w_chol, rtol=1e-3, atol=1e-5)


class TestAgainstReference:
    @pytest.mark.parametrize("sigma", [0.01, 0.1, 10.0])
    def test_residual_and_bound(self, sigma):
        js, ts = _stats(seed=1)
        w = np.random.default_rng(1).standard_normal(12).astype(np.float32)
        rj = jcore.equilibrium_residual(js, sigma, jnp.asarray(w))
        rt = core.equilibrium_residual(ts, sigma, torch.from_numpy(w))
        assert _rel(rt, rj) <= 1e-5
        bj = jcore.residual_bound(js, sigma, jnp.asarray(w))
        bt = core.residual_bound(ts, sigma, torch.from_numpy(w))
        assert bt.dtype == torch.float32 and bt.shape == ()
        assert abs(float(bt) - float(bj)) <= 1e-5 * abs(float(bj))

    @pytest.mark.parametrize("iters", [1, 3, 7, 100])
    @pytest.mark.parametrize("d,sigma", [(12, 0.05), (40, 1.0)])
    def test_cg_iteration_caps(self, iters, d, sigma):
        """Caps below d stop CG before it converges; the default runs on."""
        js, ts = _stats(seed=d, n=6 * d, d=d)
        wj = jcore.solve_cg(js, sigma, iters=iters)
        wt = core.solve_cg(ts, sigma, iters=iters)
        assert wt.dtype == torch.float32 and wt.shape == (d,)
        assert _rel(wt, wj) <= 1e-5

    @pytest.mark.parametrize("tol", [1e-1, 1e-2, 1e-3])
    def test_cg_stops_where_the_reference_stops(self, tol):
        """With ``tol`` met before the cap, both stop on ``rs <= tol**2``."""
        js, ts = _stats(seed=3, n=200, d=30)
        wj = jcore.solve_cg(js, 0.5, tol=tol)
        wt = core.solve_cg(ts, 0.5, tol=tol)
        assert _rel(wt, wj) <= 1e-5
        # the residual at the stop is below tol, and one more iteration
        # would have moved w: the stop rule decided, not the cap
        r = core.equilibrium_residual(ts, 0.5, wt)
        assert float(torch.linalg.vector_norm(r)) <= tol * 1.01
        assert not torch.equal(core.solve_cg(ts, 0.5, tol=tol / 1e3), wt)

    def test_cg_zero_moment_returns_zero(self):
        js, ts = _stats()
        zj = jcore.SuffStats(js.gram, jnp.zeros_like(js.moment), js.count)
        zt = core.SuffStats(ts.gram, torch.zeros_like(ts.moment), ts.count)
        assert np.array_equal(core.solve_cg(zt, 0.1).numpy(),
                              np.asarray(jcore.solve_cg(zj, 0.1)))
        assert not core.solve_cg(zt, 0.1).any()

    def test_cg_float64(self):
        """Float64 statistics: CG matches a float64 solve to 1e-10."""
        _, ts = _stats(seed=2)
        s64 = core.SuffStats(ts.gram.double(), ts.moment.double(), ts.count)
        w = core.solve_cg(s64, 0.1, iters=200, tol=1e-12)
        ref = torch.linalg.solve(s64.gram + 0.1 * torch.eye(12, dtype=torch.float64),
                                 s64.moment)
        assert w.dtype == torch.float64
        assert _rel(w, ref) <= 1e-10
