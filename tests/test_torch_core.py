"""Port parity for core/: sufficient statistics and the fusion references.

The same numpy inputs go through ``repro.core`` and ``repro_torch.core`` on
the CPU. Tolerances are the JAX suites' own (tests/test_core_fusion.py,
tests/test_fusion_engine.py).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import core as jcore
from repro_torch import core as tcore
from repro_torch.convert import suffstats_from

RTOL, ATOL = 1e-5, 1e-5


def _data(n, d, seed=0, clients=1):
    rng = np.random.default_rng([n, d, seed])
    out = []
    for _ in range(clients):
        A = rng.standard_normal((n, d)).astype(np.float32)
        w = rng.standard_normal(d).astype(np.float32)
        b = (A @ w + 0.1 * rng.standard_normal(n)).astype(np.float32)
        out.append((A, b))
    return out


def _pair(stats_j):
    """A JAX SuffStats and its carried-over port copy."""
    return stats_j, suffstats_from(stats_j, device="cpu")


def _assert_stats_close(st, sj, rtol=1e-5, atol=1e-4):
    np.testing.assert_allclose(st.gram.numpy(), np.asarray(sj.gram), rtol=rtol, atol=atol)
    np.testing.assert_allclose(st.moment.numpy(), np.asarray(sj.moment), rtol=rtol, atol=atol)
    assert int(st.count) == int(sj.count)
    if sj.yty is None:
        assert st.yty is None
    else:
        np.testing.assert_allclose(float(st.yty), float(sj.yty), rtol=rtol)


class TestComputeStats:
    @pytest.mark.parametrize("n,d", [(1, 8), (64, 16), (200, 33), (256, 64)])
    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    def test_matches_jax(self, n, d, dtype):
        (A, b), = _data(n, d)
        At, bt, Aj, bj = torch.from_numpy(A), torch.from_numpy(b), jnp.asarray(A), jnp.asarray(b)
        if dtype == "bfloat16":
            At, bt = At.bfloat16(), bt.bfloat16()
            Aj, bj = Aj.astype(jnp.bfloat16), bj.astype(jnp.bfloat16)
        st, sj = tcore.compute_stats(At, bt), jcore.compute_stats(Aj, bj)
        assert st.gram.dtype == st.yty.dtype == torch.float32
        assert st.count.dtype == torch.int32
        _assert_stats_close(st, sj, rtol=1e-4, atol=1e-3)

    def test_rejects_bad_shapes(self):
        with pytest.raises(ValueError):
            tcore.compute_stats(torch.zeros(3), torch.zeros(3))
        with pytest.raises(ValueError):
            tcore.compute_stats(torch.zeros(3, 2), torch.zeros(4))

    @pytest.mark.parametrize("n,chunk", [(100, 32), (64, 64), (10, 32), (257, 50)])
    def test_streaming_matches_jax(self, n, chunk):
        (A, b), = _data(n, 12)
        st = tcore.compute_stats_streaming(torch.from_numpy(A), torch.from_numpy(b), chunk=chunk)
        sj = jcore.compute_stats_streaming(jnp.asarray(A), jnp.asarray(b), chunk=chunk)
        _assert_stats_close(st, sj, rtol=1e-4, atol=1e-3)

    def test_streaming_update(self):
        (A, b), = _data(50, 6)
        old = tcore.compute_stats(torch.from_numpy(A[:30]), torch.from_numpy(b[:30]))
        new = tcore.streaming_update(old, torch.from_numpy(A[30:]), torch.from_numpy(b[30:]))
        full = tcore.compute_stats(torch.from_numpy(A), torch.from_numpy(b))
        _assert_stats_close(new, full)

    def test_zeros_like_stats(self):
        z = tcore.zeros_like_stats(5, torch.float64, device="cpu")
        zj = jcore.zeros_like_stats(5)
        assert z.gram.shape == zj.gram.shape and z.gram.dtype == torch.float64
        assert int(z.count) == 0 and float(z.yty) == 0.0


class TestSuffStatsAlgebra:
    def _stats(self, clients=3):
        return [tcore.compute_stats(torch.from_numpy(A), torch.from_numpy(b))
                for A, b in _data(40, 7, clients=clients)]

    def test_add_sub_bitwise_vs_jax(self):
        a, b = self._stats(2)
        ja, jb = (jcore.SuffStats(jnp.asarray(s.gram.numpy()), jnp.asarray(s.moment.numpy()),
                                  jnp.asarray(int(s.count)), jnp.asarray(s.yty.numpy()))
                  for s in (a, b))
        for t, j in ((a + b, ja + jb), (a - b, ja - jb)):
            np.testing.assert_array_equal(t.gram.numpy(), np.asarray(j.gram))
            np.testing.assert_array_equal(t.moment.numpy(), np.asarray(j.moment))
            np.testing.assert_array_equal(t.yty.numpy(), np.asarray(j.yty))
            assert int(t.count) == int(j.count)

    def test_yty_none_degrades(self):
        a, b = self._stats(2)
        legacy = b.without_moments()
        assert (a + legacy).yty is None and (legacy - a).yty is None
        assert a.scale(0.0).yty is not None and legacy.scale(1.0).yty is None
        fused = tcore.fuse_stats([a, legacy, b])
        assert fused.yty is None
        np.testing.assert_allclose(fused.gram.numpy(), (a + legacy + b).gram.numpy(),
                                   rtol=1e-6)

    @pytest.mark.parametrize("k,chunk", [(1, 8), (3, 8), (8, 8), (11, 4), (20, 3)])
    def test_fuse_stats_matches_jax(self, k, chunk):
        stats = [jcore.compute_stats(jnp.asarray(A), jnp.asarray(b))
                 for A, b in _data(30, 6, clients=k)]
        sj = jcore.fuse_stats(stats, chunk=chunk)
        st = tcore.fuse_stats([suffstats_from(s, device="cpu") for s in stats], chunk=chunk)
        _assert_stats_close(st, sj, rtol=1e-6, atol=1e-5)
        assert st.count.dtype == torch.int32

    def test_fuse_stats_empty_raises(self):
        with pytest.raises(ValueError):
            tcore.fuse_stats([])


class TestFusion:
    def _clients(self, k=4, n=60, d=10):
        data = _data(n, d, seed=3, clients=k)
        sj = [jcore.compute_stats(jnp.asarray(A), jnp.asarray(b)) for A, b in data]
        st = [suffstats_from(s, device="cpu") for s in sj]
        return data, sj, st

    @pytest.mark.parametrize("sigma", [1e-3, 0.1, 10.0])
    def test_solve_and_one_shot(self, sigma):
        _, sj, st = self._clients()
        np.testing.assert_allclose(tcore.solve_ridge(st[0], sigma).numpy(),
                                   np.asarray(jcore.solve_ridge(sj[0], sigma)),
                                   rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(tcore.one_shot_fusion(st, sigma).numpy(),
                                   np.asarray(jcore.one_shot_fusion(sj, sigma)),
                                   rtol=RTOL, atol=ATOL)

    def test_dropout_fusion(self):
        _, sj, st = self._clients()
        mask = [True, False, True, True]
        np.testing.assert_allclose(tcore.dropout_fusion(st, mask, 0.1).numpy(),
                                   np.asarray(jcore.dropout_fusion(sj, mask, 0.1)),
                                   rtol=RTOL, atol=ATOL)
        with pytest.raises(ValueError):
            tcore.dropout_fusion(st, [False] * 4, 0.1)

    def test_condition_number_and_coverage(self):
        _, sj, st = self._clients()
        fused_t, fused_j = tcore.fuse_stats(st), jcore.fuse_stats(sj)
        np.testing.assert_allclose(float(tcore.condition_number(fused_t, 0.1)),
                                   float(jcore.condition_number(fused_j, 0.1)), rtol=1e-4)
        np.testing.assert_allclose(float(tcore.coverage(fused_t)),
                                   float(jcore.coverage(fused_j)), rtol=1e-3)

    def test_loco_cv_and_mse(self):
        data, sj, st = self._clients()
        sigmas = [0.01, 0.1, 1.0, 10.0]
        best_t, losses_t = tcore.loco_cv(
            st, [(torch.from_numpy(A), torch.from_numpy(b)) for A, b in data], sigmas)
        best_j, losses_j = jcore.loco_cv(
            sj, [(jnp.asarray(A), jnp.asarray(b)) for A, b in data], sigmas)
        assert best_t == best_j
        np.testing.assert_allclose(losses_t.numpy(), np.asarray(losses_j), rtol=1e-4, atol=1e-5)
        A, b = data[0]
        w = np.ones(A.shape[1], np.float32)
        np.testing.assert_allclose(
            float(tcore.mse(torch.from_numpy(A), torch.from_numpy(b), torch.from_numpy(w))),
            float(jcore.mse(jnp.asarray(A), jnp.asarray(b), jnp.asarray(w))), rtol=1e-5)
