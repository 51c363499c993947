"""Port parity for the fusion engine, its dense backend and served inference.

One scenario runs on both packages from the same numpy data: ingest, async
rows through the coalescer, flush, drop, restore, solve, solve_batch (chol
and spectral), LOCO CV, predict, inference. Fused (G, h) after the same
ingest sequence are pinned bitwise (elementwise IEEE adds in the same
order); solves use tests/test_fusion_engine.py's tolerances. Inside the
port, the reference's own bit-identity contracts are pinned:
``engine.solve == solve_snapshot(*solve_operands)`` and served inference ==
``reference_inference``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import core as jcore
from repro import server as jserver
from repro.server import inference as jinf
from repro_torch import core as tcore
from repro_torch import server as tserver
from repro_torch.convert import engine_from_ledger, suffstats_from
from repro_torch.server import inference as tinf

RTOL, ATOL = 1e-5, 1e-5
D, K, N = 24, 4, 60
SIGMAS = [0.01, 0.1, 1.0]


def _data(seed=0):
    rng = np.random.default_rng(seed)
    w = rng.standard_normal(D).astype(np.float32)
    clients = []
    for k in range(K):
        A = (rng.standard_normal((N, D)) + 0.3 * k).astype(np.float32)
        clients.append((A, (A @ w + 0.1 * rng.standard_normal(N)).astype(np.float32)))
    rows = rng.standard_normal((16, D)).astype(np.float32)
    return clients, rows, (rows @ w).astype(np.float32)


def _engines(**kwargs):
    clients, rows, rows_b = _data()
    sj = [jcore.compute_stats(jnp.asarray(A), jnp.asarray(b)) for A, b in clients]
    st = [suffstats_from(s, device="cpu") for s in sj]
    ej = jserver.FusionEngine.from_clients(sj, **kwargs)
    et = tserver.FusionEngine.from_clients(st, **kwargs)
    return ej, et, clients, rows, rows_b


def _close(t, j, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=rtol, atol=atol)


class TestEngineParity:
    def test_fused_stats_bitwise_after_ingest(self):
        ej, et, *_ = _engines()
        for field in ("gram", "moment", "yty"):
            np.testing.assert_array_equal(getattr(et.stats, field).numpy(),
                                          np.asarray(getattr(ej.stats, field)))
        assert et.count == ej.count == K * N

    def test_scenario(self):
        policy = dict(max_update_rank=64)
        ej, et, clients, rows, rows_b = _engines(**policy)
        ej.coalesce = et.coalesce = tserver.CoalescerPolicy(max_rank=8)
        for s in SIGMAS:
            _close(et.solve(s), ej.solve(s))
        for i in range(len(rows)):
            ej.ingest_rows_async(jnp.asarray(rows[i:i + 1]), jnp.asarray(rows_b[i:i + 1]),
                                 client_id=2)
            et.ingest_rows_async(torch.from_numpy(rows[i:i + 1]),
                                 torch.from_numpy(rows_b[i:i + 1]), client_id=2)
        ej.flush(), et.flush()
        for s in SIGMAS:
            _close(et.solve(s), ej.solve(s), rtol=1e-4, atol=1e-4)
        ej.drop(1), et.drop(1)
        _close(et.solve(0.1), ej.solve(0.1), rtol=1e-4, atol=1e-4)
        assert et.dropped_ids == ej.dropped_ids == (1,)
        ej.restore(1), et.restore(1)
        _close(et.solve(0.1), ej.solve(0.1), rtol=1e-4, atol=1e-4)
        _close(et.solve_batch(SIGMAS, method="chol"), ej.solve_batch(SIGMAS, method="chol"))
        _close(et.solve_batch(SIGMAS, method="spectral"),
               ej.solve_batch(SIGMAS, method="spectral"), rtol=1e-4, atol=1e-4)
        q = np.random.default_rng(3).standard_normal((5, D)).astype(np.float32)
        _close(et.predict(torch.from_numpy(q), 0.1), ej.predict(jnp.asarray(q), 0.1),
               rtol=1e-4, atol=1e-4)
        best_t, losses_t = et.loco_cv(
            [(torch.from_numpy(A), torch.from_numpy(b)) for A, b in clients], SIGMAS)
        best_j, losses_j = ej.loco_cv(
            [(jnp.asarray(A), jnp.asarray(b)) for A, b in clients], SIGMAS)
        assert best_t == best_j
        _close(losses_t, losses_j, rtol=1e-4, atol=1e-5)
        rt = et.inference(0.1, queries=torch.from_numpy(q))
        rj = ej.inference(0.1, queries=jnp.asarray(q))
        assert rt["n"] == rj["n"]
        for key in ("dof", "rss", "sigma2"):
            np.testing.assert_allclose(rt[key], rj[key], rtol=1e-3)
        for key in ("stderr", "ci", "pi"):
            np.testing.assert_allclose(rt[key], rj[key], rtol=1e-3, atol=1e-4)
        summary_t, summary_j = et.summary(), ej.summary()
        assert summary_t.keys() == summary_j.keys()
        for key in ("rows", "clients", "dropped", "flushes", "coalesced_deltas",
                    "incremental_updates", "cold_factorizations", "stats_version"):
            assert summary_t[key] == summary_j[key], key

    def test_loco_weights(self):
        ej, et, *_ = _engines()
        ids_t, Wt = et.loco_weights(SIGMAS)
        ids_j, Wj = ej.loco_weights(SIGMAS)
        assert ids_t == ids_j and Wt.shape == (K, len(SIGMAS), D)
        _close(Wt, Wj, rtol=1e-4, atol=1e-4)

    def test_cache_accounting_and_apply(self):
        ej, et, *_ = _engines()
        for eng in (ej, et):
            eng.solve(0.1), eng.solve_batch(SIGMAS, method="spectral")
        assert et.cached_factor_count == ej.cached_factor_count == 1
        assert et.resident_bytes == ej.resident_bytes
        assert et.retained_clients == ej.retained_clients == K
        assert et.release_factors() == ej.release_factors() == 2
        q = np.ones((2, D), np.float32)
        _close(et.predict_batch(torch.from_numpy(q), SIGMAS),
               ej.predict_batch(jnp.asarray(q), SIGMAS), rtol=1e-4, atol=1e-4)
        et.apply(lambda s: s.scale(2.0))
        ej.apply(lambda s: s.scale(2.0))
        _close(et.solve(0.1), ej.solve(0.1))
        assert et.stats_version == ej.stats_version

    def test_sync_rows_take_the_rank1_path(self):
        ej, et, _, rows, rows_b = _engines()
        ej.solve(0.1), et.solve(0.1)
        ej.ingest_rows(jnp.asarray(rows[:3]), jnp.asarray(rows_b[:3]), client_id=0)
        et.ingest_rows(torch.from_numpy(rows[:3]), torch.from_numpy(rows_b[:3]), client_id=0)
        assert et.incremental_updates == ej.incremental_updates == 1
        _close(et.solve(0.1), ej.solve(0.1), rtol=1e-4, atol=1e-4)


class TestPortContracts:
    def test_solve_equals_snapshot_bitwise(self):
        _, et, _, rows, rows_b = _engines(max_update_rank=64)
        et.solve(0.1)
        et.ingest_rows(torch.from_numpy(rows), torch.from_numpy(rows_b))
        ops = et.backend.solve_operands(et.factor(0.1), 0.1)
        assert torch.equal(et.solve(0.1), tserver.solve_snapshot(*ops))
        assert et.cold_factorizations == 1 and et.incremental_updates == 1

    def test_float32_solve_is_refined(self):
        """A float32 RFF-like Gram at kappa ~ 3e4: one factor solve is off
        float64 by ~kappa 2^-24, so the engine refines it once with a
        float64 residual, cold and after a streamed rank-16 factor update;
        batched and lone solves agree bitwise."""
        rng = np.random.default_rng(0)
        X, W = rng.standard_normal((4000, 8)), rng.standard_normal((8, 128)) / 8 ** 0.5
        T = (np.sqrt(2 / 128) * np.cos(X @ W + rng.uniform(0, 2 * np.pi, 128))).astype(np.float32)
        y = rng.standard_normal(4000).astype(np.float32)
        stats = [tcore.compute_stats(torch.from_numpy(T[:3000]), torch.from_numpy(y[:3000]))]
        et = tserver.FusionEngine.from_clients(stats, max_update_rank=64)

        def err(s):
            G, h = et.stats.gram.double(), et.stats.moment.double()
            w64 = torch.linalg.solve(G + s * torch.eye(128, dtype=torch.float64), h)
            return float((et.solve(s).double() - w64).abs().max() / w64.abs().max()), w64

        L = et.factor(0.01)
        e, w64 = err(0.01)
        plain = torch.cholesky_solve(et.stats.moment[:, None], L)[:, 0].double()
        plain_err = float((plain - w64).abs().max() / w64.abs().max())
        assert plain_err > 1e-5 and e <= 1e-6 and 100 * e < plain_err
        et.ingest_rows(torch.from_numpy(T[3000:3016]), torch.from_numpy(y[3000:3016]))
        assert et.incremental_updates == 1 and err(0.01)[0] <= 1e-6
        ws = et.solve_batch([0.01, 0.1], method="chol")
        assert torch.equal(ws[1], et.solve(0.1)) and err(0.1)[0] <= 1e-6

    def test_inference_equals_reference_bitwise(self):
        _, et, *_ = _engines()
        q = torch.from_numpy(np.random.default_rng(4).standard_normal((3, D)).astype(np.float32))
        rep = et.inference(0.1, queries=q)
        cold = et.cold_factorizations
        assert et.inference(0.1) is not None and et.cold_factorizations == cold
        w, ref = tinf.reference_inference(et.stats, 0.1, queries=q)
        assert torch.equal(w, et.solve(0.1))
        for key in ("n", "dof", "rss", "sigma2"):
            assert rep[key] == ref[key]
        for key in ("stderr", "ci", "pi", "pi_mean"):
            np.testing.assert_array_equal(rep[key], ref[key])

    def test_inference_degrades_without_moments(self):
        st = [tcore.compute_stats(torch.ones(5, 3), torch.ones(5)).without_moments()]
        assert tserver.FusionEngine.from_clients(st).inference(0.1) is None

    @pytest.mark.parametrize("level", [0.5, 0.9, 0.95, 0.99])
    def test_z_value(self, level):
        assert tinf.z_value(level) == pytest.approx(jinf.z_value(level), rel=1e-6)

    def test_not_ported_paths_raise(self):
        """The paths that waited for the sharded backend now run: "auto"
        resolves in from_clients (dense without a threshold, sharded past
        one), a string backend in the constructor is refused, and only a
        backend with on-mesh fusion takes ingest_distributed."""
        from repro_torch.launch.mesh import make_cpu_mesh

        st = [tcore.compute_stats(torch.ones(5, 3), torch.ones(5))]
        with pytest.raises(ValueError, match="backend='auto'"):
            tserver.FusionEngine(3, backend="auto", device="cpu")
        assert tserver.FusionEngine.from_clients(
            st, backend="auto").backend.name == "dense"
        mesh = make_cpu_mesh(8)
        eng = tserver.FusionEngine.from_clients(st, backend="auto", mesh=mesh,
                                                threshold=3)
        assert eng.backend.name == "sharded" and eng.count == 5
        with pytest.raises(ValueError, match="no on-mesh fusion"):
            tserver.FusionEngine.from_clients(st).ingest_distributed(
                torch.ones(8, 3), torch.ones(8))
        eng.ingest_distributed(torch.ones(8, 3), torch.ones(8))
        assert eng.count == 13

    def test_rejects_populated_backend_and_dim_mismatch(self):
        st = tcore.compute_stats(torch.ones(5, 3), torch.ones(5))
        be = tserver.DenseBackend(3, device="cpu")
        be.fuse(st)
        with pytest.raises(ValueError, match="already holds"):
            tserver.FusionEngine.from_clients([st], backend=be)
        with pytest.raises(ValueError):
            tserver.FusionEngine(4, backend=tserver.DenseBackend(3, device="cpu"))

    def test_engine_from_jax_ledger(self):
        ej, *_ = _engines()
        ej.drop(2)
        clients, dropped = ej.export_ledger()
        et = engine_from_ledger(clients, dropped, device="cpu")
        assert et.client_ids == ej.client_ids and et.dropped_ids == ej.dropped_ids
        _close(et.stats.gram, ej.stats.gram, rtol=1e-5, atol=1e-3)
        _close(et.solve(0.1), ej.solve(0.1), rtol=1e-4, atol=1e-4)
        et.restore(2), ej.restore(2)
        _close(et.solve(0.1), ej.solve(0.1), rtol=1e-4, atol=1e-4)
