"""Algorithm 2 and the Remark-4 guard through the port's production path
(``fed.run_one_shot(dp=...)``, ``PackedStats``, ``FusionEngine``,
``EnginePool(psd_guard=True)``), inside the port and against the reference.

Inside the port, the reference's single-device DP-path tests: noisy payloads
fuse bit for bit as the sequential fuse of the same statistics, and the
guard fires on the server, behind the engine API. Across packages: payloads
noised by the reference fuse in the port's pool to the reference pool's
bits; ``run_one_shot(dp=...)`` on the reference's dataset with the same key
uploads the same noise bit for bit (statistics at K1's tolerance, since each
package clips and sums its own rows); the guard fires with the same count
and the repaired weights agree at 1e-4. The guard is not journaled in
either package: a restored tenant holds the repaired statistics of its
snapshot, with its guard counters reset.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import core as jcore
from repro import data as jdata
from repro import fed as jfed
from repro import server as jserver
from repro.core import privacy as jpriv
from repro_torch import core, fed
from repro_torch.convert import dataset_from_numpy, key_from, suffstats_from
from repro_torch.core import fusion, privacy, threefry
from repro_torch.fed import protocol
from repro_torch.server import EnginePool, FusionEngine

D = 10
SIGMA = 0.3
EPS, DELTA = 1.0, 1e-5
EPS_TINY = 0.05   # enough noise to push eigenvalues well below zero


def _client_rows(k, n=30):
    """The reference test's rows (``jax.random``), as numpy."""
    k1, k2 = jax.random.split(jax.random.PRNGKey(k))
    return (np.asarray(jax.random.normal(k1, (n, D))),
            np.asarray(jax.random.normal(k2, (n,))))


def _rows_t(k, n=30):
    return tuple(torch.from_numpy(x.copy()) for x in _client_rows(k, n))


def _noisy_client_stats(eps=EPS):
    """Alg 2 per-client pipeline in the port: clip -> stats -> mechanism."""
    out = []
    for k in range(3):
        A, b = privacy.clip_rows(*_rows_t(k))
        out.append(privacy.privatize_stats(threefry.key(500 + k),
                                           core.compute_stats(A, b), eps, DELTA))
    return out


def _jax_noisy_client_stats(eps=EPS):
    out = []
    for k in range(3):
        A, b = jpriv.clip_rows(*map(jnp.asarray, _client_rows(k)))
        out.append(jpriv.privatize_stats(jax.random.PRNGKey(500 + k),
                                         jcore.compute_stats(A, b), eps, DELTA))
    return out


def _sequential_fuse(stats_list):
    """The engine's exact float-addition order: zeros + s_0 + s_1 + ..."""
    acc = core.zeros_like_stats(D, stats_list[0].gram.dtype, device="cpu")
    for s in stats_list:
        acc = acc + s
    return acc


def _datasets(seed=3, num_clients=4, n=40, d=D):
    dj = jdata.generate(jax.random.PRNGKey(seed), num_clients=num_clients,
                        samples_per_client=n, dim=d)
    dt = dataset_from_numpy([(np.asarray(A), np.asarray(b)) for A, b in dj.clients],
                            dj.test_A, dj.test_b, dj.w_star, dj.gamma, device="cpu")
    return dj, dt


# -- tests/test_dp_engine_path.py, on the port ---------------------------------

class TestNoisyPayloadsBitExact:
    def test_per_client_dp_payloads_through_pool(self):
        noisy = _noisy_client_stats()
        payloads = {k: fed.PackedStats.pack(s) for k, s in enumerate(noisy)}
        pool = EnginePool(device="cpu")
        eng = pool.create_tenant("dp", payloads=payloads, placement="dense")
        ref = _sequential_fuse(noisy)
        assert torch.equal(eng.stats.gram, ref.gram)
        assert torch.equal(eng.stats.moment, ref.moment)
        np.testing.assert_allclose(pool.solve("dp", SIGMA).numpy(),
                                   fusion.solve_ridge(ref, SIGMA).numpy(),
                                   rtol=1e-5, atol=1e-5)

    def test_central_dp_stats_through_pool(self):
        clean = [core.compute_stats(*_rows_t(k)) for k in range(3)]
        noisy = privacy.central_dp_stats(threefry.key(9), _sequential_fuse(clean),
                                         EPS, DELTA, n_clients=3)
        pool = EnginePool(device="cpu")
        eng = pool.create_tenant("central", stats=noisy, placement="dense")
        assert torch.equal(eng.stats.gram, noisy.gram)
        assert torch.equal(eng.stats.moment, noisy.moment)
        np.testing.assert_allclose(pool.solve("central", SIGMA).numpy(),
                                   fusion.solve_ridge(noisy, SIGMA).numpy(),
                                   rtol=1e-5, atol=1e-5)

    def test_make_dp_noise_fn_into_engine(self):
        """The per-client noise hook on one device, then served."""
        noise_fn = privacy.make_dp_noise_fn(threefry.key(77), EPS, DELTA, D)
        s = core.compute_stats(*_rows_t(42, n=32))
        G, h = noise_fn(0, s.gram, s.moment)
        noisy = core.SuffStats(G, h, s.count)
        eng = FusionEngine.from_stats(noisy)
        np.testing.assert_allclose(eng.solve(SIGMA).numpy(),
                                   fusion.solve_ridge(noisy, SIGMA).numpy(),
                                   rtol=1e-5, atol=1e-5)


class TestRemark4Guard:
    """Heavy noise makes (G~ + sigma I) indefinite (Remark 4); the repair
    must fire through the engine/pool path, not just the pure function."""

    def test_guard_fires_on_indefinite_admission(self):
        noisy = _noisy_client_stats(eps=EPS_TINY)
        ref = _sequential_fuse(noisy)
        min_eig = float(torch.linalg.eigvalsh(ref.gram)[0])
        assert min_eig < 0, "test setup: noise too weak to trigger Remark 4"
        pool = EnginePool(device="cpu")
        eng = pool.create_tenant(
            "noisy", payloads={k: fed.PackedStats.pack(s) for k, s in enumerate(noisy)},
            placement="dense", psd_guard=True)
        t = pool.tenant("noisy")
        assert t.psd_repairs == 1
        assert t.guard_min_eig == pytest.approx(min_eig)
        assert torch.equal(eng.stats.gram, privacy.psd_repair(ref).gram)
        assert np.linalg.eigvalsh(eng.stats.gram.numpy()).min() >= -1e-4
        assert torch.isfinite(pool.solve("noisy", SIGMA)).all()
        assert pool.summary()["psd_repairs"] == 1
        assert pool.summary()["per_tenant"]["noisy"]["psd_repairs"] == 1

    def test_guard_quiet_on_clean_statistics(self):
        clean = [core.compute_stats(*_rows_t(k)) for k in range(3)]
        pool = EnginePool(device="cpu")
        eng = pool.create_tenant(
            "clean", payloads={k: fed.PackedStats.pack(s) for k, s in enumerate(clean)},
            placement="dense", psd_guard=True)
        t = pool.tenant("clean")
        assert t.psd_repairs == 0
        assert t.guard_min_eig is not None and t.guard_min_eig >= 0
        assert torch.equal(eng.stats.gram, _sequential_fuse(clean).gram)
        assert pool.summary()["psd_repairs"] == 0

    def test_run_one_shot_psd_repair_matches_reference(self):
        """run_one_shot(psd_repair=True) IS engine.apply: its output equals
        psd_repair of the unrepaired run's fused stats (same dp_key ->
        identical noise draws)."""
        _, ds = _datasets()
        raw = fed.run_one_shot(ds, SIGMA, dp=(EPS_TINY, DELTA), dp_key=threefry.key(11))
        noisy = raw.extras["fused_stats"]
        assert float(torch.linalg.eigvalsh(noisy.gram)[0]) < 0
        rep = fed.run_one_shot(ds, SIGMA, dp=(EPS_TINY, DELTA), dp_key=threefry.key(11),
                               psd_repair=True)
        assert torch.equal(rep.extras["fused_stats"].gram,
                           privacy.psd_repair(noisy).gram)
        assert torch.isfinite(rep.weights).all()


# -- the port against the reference --------------------------------------------

class TestAgainstReference:
    @pytest.mark.parametrize("eps", [EPS, EPS_TINY])
    def test_jax_payloads_fuse_to_the_jax_pools_bits(self, eps):
        jnoisy = _jax_noisy_client_stats(eps)
        jpool = jserver.EnginePool()
        jeng = jpool.create_tenant("dp", payloads={k: jfed.PackedStats.pack(s)
                                                   for k, s in enumerate(jnoisy)},
                                   placement="dense")
        pool = EnginePool(device="cpu")
        eng = pool.create_tenant(
            "dp", payloads={k: fed.PackedStats.pack(suffstats_from(s, device="cpu"))
                            for k, s in enumerate(jnoisy)}, placement="dense")
        np.testing.assert_array_equal(eng.stats.gram.numpy(), np.asarray(jeng.stats.gram))
        np.testing.assert_array_equal(eng.stats.moment.numpy(), np.asarray(jeng.stats.moment))
        assert eng.stats.yty is None and jeng.stats.yty is None

    @pytest.mark.parametrize("participating", [None, [True, False, True, True]])
    def test_uploads_carry_the_reference_noise(self, participating, monkeypatch):
        """With the reference's clipped-row statistics in place of the
        port's own, ``client_phase`` uploads the reference's bytes: the key
        is split over all K clients and each client's noise is JAX's."""
        dj, dt = _datasets()
        key = jax.random.PRNGKey(11)
        jup = jfed.protocol.client_phase(dj, participating=participating,
                                         dp=(EPS, DELTA), dp_key=key)
        clip = (1.2 * D ** 0.5, 4.0)
        jclean = iter([jcore.compute_stats(*jpriv.clip_rows(A, b, clip_a=clip[0],
                                                            clip_b=clip[1]))
                       for k, (A, b) in enumerate(dj.clients)
                       if participating is None or participating[k]])
        monkeypatch.setattr(protocol, "compute_stats",
                            lambda A, b: suffstats_from(next(jclean), device="cpu"))
        tup = fed.client_phase(dt, participating=participating, dp=(EPS, DELTA),
                               dp_key=key_from(key))
        assert sorted(tup) == sorted(jup)
        for k in jup:
            np.testing.assert_array_equal(tup[k].tri.numpy(), np.asarray(jup[k].tri))
            np.testing.assert_array_equal(tup[k].moment.numpy(), np.asarray(jup[k].moment))
            assert tup[k].yty is None and jup[k].yty is None

    @pytest.mark.parametrize("psd_repair", [False, True])
    def test_run_one_shot_dp_matches(self, psd_repair):
        dj, dt = _datasets()
        rj = jfed.run_one_shot(dj, SIGMA, dp=(EPS, DELTA),
                               dp_key=jax.random.PRNGKey(11), psd_repair=psd_repair)
        rt = fed.run_one_shot(dt, SIGMA, dp=(EPS, DELTA),
                              dp_key=key_from(jax.random.PRNGKey(11)),
                              psd_repair=psd_repair)
        gj, gt = np.asarray(rj.extras["fused_stats"].gram), rt.extras["fused_stats"].gram
        np.testing.assert_allclose(gt.numpy(), gj, rtol=0, atol=1e-5 * np.abs(gj).max())
        np.testing.assert_allclose(rt.weights.numpy(), np.asarray(rj.weights),
                                   rtol=1e-4, atol=1e-4 * np.abs(np.asarray(rj.weights)).max())
        assert rt.comm == type(rt.comm)(**vars(rj.comm))

    def test_uploads_match_at_k1_tolerance(self):
        dj, dt = _datasets()
        key = jax.random.PRNGKey(11)
        jup = jfed.protocol.client_phase(dj, dp=(EPS, DELTA), dp_key=key)
        tup = fed.client_phase(dt, dp=(EPS, DELTA), dp_key=key_from(key))
        for k in jup:
            tri = np.asarray(jup[k].tri)
            np.testing.assert_allclose(tup[k].tri.numpy(), tri, rtol=0,
                                       atol=1e-5 * np.abs(tri).max())
            np.testing.assert_allclose(tup[k].moment.numpy(), np.asarray(jup[k].moment),
                                       rtol=1e-5, atol=1e-5)

    def test_dp_ignores_client_stats(self):
        """Clipping must see the raw rows: reused statistics are ignored
        under DP, in both packages."""
        _, dt = _datasets()
        clean = [core.compute_stats(A, b) for A, b in dt.clients]
        a = fed.client_phase(dt, dp=(EPS, DELTA), dp_key=threefry.key(4),
                             client_stats=clean)
        b = fed.client_phase(dt, dp=(EPS, DELTA), dp_key=threefry.key(4))
        for k in a:
            assert torch.equal(a[k].tri, b[k].tri)

    def test_guard_fires_alike(self):
        jnoisy = _jax_noisy_client_stats(EPS_TINY)
        jpool = jserver.EnginePool()
        jpool.create_tenant("g", payloads={k: jfed.PackedStats.pack(s)
                                           for k, s in enumerate(jnoisy)},
                            placement="dense", psd_guard=True)
        pool = EnginePool(device="cpu")
        pool.create_tenant("g", payloads={k: fed.PackedStats.pack(
            suffstats_from(s, device="cpu")) for k, s in enumerate(jnoisy)},
            placement="dense", psd_guard=True)
        jt, t = jpool.tenant("g"), pool.tenant("g")
        assert t.psd_repairs == jt.psd_repairs == 1
        assert t.guard_min_eig == pytest.approx(jt.guard_min_eig, rel=1e-5)
        assert pool.summary()["psd_repairs"] == jpool.summary()["psd_repairs"] == 1
        gj = np.asarray(jt.engine.stats.gram)
        np.testing.assert_allclose(t.engine.stats.gram.numpy(), gj, rtol=0,
                                   atol=1e-5 * np.abs(gj).max())
        wj = np.asarray(jpool.solve("g", SIGMA))
        np.testing.assert_allclose(pool.solve("g", SIGMA).numpy(), wj, rtol=1e-4,
                                   atol=1e-4 * np.abs(wj).max())


class TestGuardUnderAJournal:
    """The reference journals frames, not ``create_tenant``: a guarded
    tenant becomes durable at the next snapshot, which holds its repaired
    statistics; restore re-admits them without the guard, so its counters
    start again at 0 / None. The port does the same, and reads the
    reference's directory the same way."""

    def _guarded(self, pool, jax_side: bool):
        jnoisy = _jax_noisy_client_stats(EPS_TINY)
        if jax_side:
            pay = {k: jfed.PackedStats.pack(s) for k, s in enumerate(jnoisy)}
        else:
            pay = {k: fed.PackedStats.pack(suffstats_from(s, device="cpu"))
                   for k, s in enumerate(jnoisy)}
        pool.create_tenant("g", payloads=pay, placement="dense", psd_guard=True)
        return np.array(pool.get("g").stats.gram)

    @pytest.mark.parametrize("writer", ["port", "jax"])
    def test_restore_keeps_the_repair_not_the_counters(self, writer, tmp_path):
        if writer == "port":
            src = EnginePool(device="cpu", journal_dir=str(tmp_path))
            G = self._guarded(src, jax_side=False)
        else:
            src = jserver.EnginePool(journal_dir=str(tmp_path))
            G = self._guarded(src, jax_side=True)
        assert src.tenant("g").psd_repairs == 1
        src.close()                               # the final snapshot
        for make in (lambda: EnginePool(device="cpu", journal_dir=str(tmp_path)),
                     lambda: jserver.EnginePool(journal_dir=str(tmp_path))):
            p = make()                            # each close snapshots again
            try:
                t = p.tenant("g")
                np.testing.assert_array_equal(np.asarray(t.engine.stats.gram), G)
                assert t.psd_repairs == 0 and t.guard_min_eig is None
                assert p.summary()["psd_repairs"] == 0
                assert p.summary()["restored_tenants"] == 1
            finally:
                p.close()
