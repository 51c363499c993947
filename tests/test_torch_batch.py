"""Port parity for cross-tenant batched solves (``server/batch.py``) and the
admission controls of the pool they run on.

Mirrors tests/test_batch_solve.py without its wire classes. The contract
inside the port is exactness, as in the reference: every lane of a
``solve_stacked`` sweep, of ``EnginePool.solve_many`` and of a
``SolveBatcher`` answer equals, bit for bit, the tenant's lone ``solve`` at
the same state (each lane runs ``backends._factor_solve``). Against the
reference, the same numpy data and the same operations go through a JAX
pool and a port pool (on the CPU); the port's weights match within
tests/test_torch_engine.py's RTOL = ATOL = 1e-5. Statistics are made by the
reference and carried over (``convert.suffstats_from``), so the two pools
fuse the same bits; rows ingested as rows are featurized by each package.
"""
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _hypo import hypothesis, st
from repro import core as jcore
from repro import server as jserver
from repro_torch.convert import suffstats_from
from repro_torch.server import (AdmissionError, CoalescerPolicy, EnginePool,
                                SolveBatcher, solve_snapshot, solve_stacked)
from repro_torch.server.backends import _cold_factor

RTOL = ATOL = 1e-5
D = 6
SIGMA = 0.1
SIGMA2 = 0.5
TENANTS = ("dense0", "dense1", "dense2")


def _rows(seed, n=8, d=D):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, d)).astype(np.float32),
            rng.standard_normal(n).astype(np.float32))


def _jstats(seed, n=8):
    A, b = _rows(seed, n)
    return jcore.compute_stats(jnp.asarray(A), jnp.asarray(b))


def _port_pool():
    """The three tenants on a port pool (CPU) alone."""
    pool = EnginePool(default_coalesce=CoalescerPolicy(max_rank=5), device="cpu")
    for i, name in enumerate(TENANTS):
        pool.create_tenant(name, clients={0: suffstats_from(_jstats(1000 + i),
                                                            device="cpu")},
                           placement="dense", max_update_rank=100)
    return pool


def _port_stats(A, b):
    from repro_torch.core import compute_stats

    return compute_stats(A, b)


class Pools:
    """One JAX pool and one port pool (CPU) driven by the same operations."""

    def __init__(self, **kw):
        self.j = jserver.EnginePool(default_coalesce=jserver.CoalescerPolicy(
            max_rank=5), **kw)
        for i, name in enumerate(TENANTS):
            self.j.create_tenant(name, clients={0: _jstats(1000 + i)},
                                 placement="dense", max_update_rank=100)
        self.t = _port_pool()

    def ingest(self, name, seed, cid):
        s = _jstats(seed)
        self.j.ingest(name, s, client_id=cid)
        self.t.ingest(name, suffstats_from(s, device="cpu"), client_id=cid)

    def rows(self, name, seed, sync=True):
        A, b = _rows(seed, n=3)
        if sync:
            self.j.ingest_rows(name, jnp.asarray(A), jnp.asarray(b))
            self.t.ingest_rows(name, torch.from_numpy(A), torch.from_numpy(b))
        else:
            self.j.ingest_rows_async(name, jnp.asarray(A), jnp.asarray(b))
            self.t.ingest_rows_async(name, torch.from_numpy(A),
                                     torch.from_numpy(b))

    def both(self, op, /, *args):
        getattr(self.j, op)(*args)
        getattr(self.t, op)(*args)

    def close(self):
        self.j.close()
        self.t.close()


def _assert_bitwise_matches_lone(pool, sigmas=(SIGMA, SIGMA2)):
    """solve_many reproduces every tenant's lone solve bit for bit (lone
    solves run first: they drain queued deltas, so both see one state)."""
    names = pool.tenant_names
    for sigma in sigmas:
        lone = [pool.solve(n, sigma) for n in names]
        many = pool.solve_many([(n, sigma) for n in names])
        for name, w_lone, w_many in zip(names, lone, many):
            assert torch.equal(w_many, w_lone), \
                f"tenant {name} sigma {sigma}: batched bits != lone bits"


def _assert_matches_reference(pools, sigmas=(SIGMA,), tol=RTOL):
    """Port weights against the JAX pool's within ``tol``, and against a
    float64 solve of the port's own fused statistics within RTOL."""
    for name in TENANTS:
        for sigma in sigmas:
            w = pools.t.solve(name, sigma)
            np.testing.assert_allclose(
                w.numpy(), np.asarray(pools.j.solve(name, sigma)),
                rtol=tol, atol=tol)
            s = pools.t.stats(name)
            G = s.gram.double()
            w64 = torch.linalg.solve(G + sigma * torch.eye(G.shape[0], dtype=G.dtype),
                                     s.moment.double())
            np.testing.assert_allclose(w.double().numpy(), w64.numpy(),
                                       rtol=RTOL, atol=ATOL)


# -- solve_stacked -----------------------------------------------------------

class TestSolveStacked:
    def test_empty(self):
        assert solve_stacked([]) == []

    @pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
    @pytest.mark.parametrize("T", range(1, 10))
    def test_lanes_bit_identical(self, T, dtype):
        """Any batch extent returns each lane's exact lone solve."""
        entries = []
        for i in range(T):
            A, b = (torch.from_numpy(x).to(dtype) for x in _rows(i, n=3 * D))
            G, h = A.T @ A + (1.0 + i) * torch.eye(D, dtype=dtype), A.T @ b
            sigma = 0.1 * (i + 1)
            entries.append((_cold_factor(G, sigma), G, h, sigma))
        ws = solve_stacked(entries)
        assert len(ws) == T
        for ops, w in zip(entries, ws):
            assert w.dtype == dtype
            assert torch.equal(w, solve_snapshot(*ops))

    def test_one_bucket_only(self):
        G = torch.eye(D)
        e = (_cold_factor(G, 0.1), G, torch.ones(D), 0.1)
        G2 = torch.eye(D + 1)
        with pytest.raises(ValueError, match="bucket"):
            solve_stacked([e, (_cold_factor(G2, 0.1), G2, torch.ones(D + 1), 0.1)])
        with pytest.raises(ValueError, match="bucket"):
            solve_stacked([e, tuple(x.double() if torch.is_tensor(x) else x
                                    for x in e)])


# -- solve_many ---------------------------------------------------------------

class TestSolveMany:
    def test_bitwise_vs_lone_and_reference(self):
        pools = Pools()
        _assert_bitwise_matches_lone(pools.t)
        assert pools.t.batched_sweeps >= 1
        assert pools.t.batched_solves >= 3
        _assert_matches_reference(pools, (SIGMA, SIGMA2))
        many_j = pools.j.solve_many([(n, SIGMA) for n in TENANTS])
        many_t = pools.t.solve_many([(n, SIGMA) for n in TENANTS])
        for wt, wj in zip(many_t, many_j):
            np.testing.assert_allclose(wt.numpy(), np.asarray(wj),
                                       rtol=RTOL, atol=ATOL)
        pools.close()

    def test_duplicate_and_multi_sigma_requests(self):
        pools = Pools()
        pool = pools.t
        reqs = [("dense0", SIGMA), ("dense1", SIGMA2), ("dense0", SIGMA2),
                ("dense0", SIGMA), ("dense2", SIGMA)]
        lone = [pool.solve(n, s) for n, s in reqs]
        sweeps = pool.batched_sweeps
        many = pool.solve_many(reqs)
        assert pool.batched_sweeps == sweeps + 1       # one (d, dtype) bucket
        for (n, s), w_lone, w_many in zip(reqs, lone, many):
            assert torch.equal(w_many, w_lone), (n, s)
        pools.close()

    def test_buckets_by_dim_and_dtype(self):
        pool = EnginePool(device="cpu")
        for name, d, dt in (("a", D, torch.float32), ("b", D + 2, torch.float32),
                            ("c", D, torch.float64), ("e", D, torch.float32)):
            A, b = (torch.from_numpy(x).to(dt) for x in _rows(len(name), 12, d))
            pool.create_tenant(name, clients=[_port_stats(A, b)],
                               placement="dense")
        reqs = [(n, SIGMA) for n in ("a", "b", "c", "e")]
        lone = [pool.solve(n, s) for n, s in reqs]
        many = pool.solve_many(reqs)
        assert pool.batched_sweeps == 3 and pool.batched_solves == 4
        for w_lone, w_many in zip(lone, many):
            assert torch.equal(w_many, w_lone)

    def test_unknown_tenant_raises(self):
        pools = Pools()
        with pytest.raises(KeyError):
            pools.t.solve_many([("dense0", SIGMA), ("nope", SIGMA)])
        pools.close()


# -- interleavings: solve_many vs mutations ----------------------------------

# (kind, tenant slot, client slot, data seed). Kinds: 0 ingest a new client,
# 1 drop, 2 restore, 3 ingest_rows, 4 ingest_rows_async, 5 flush, 6 solve.
_OP = st.tuples(st.integers(0, 6), st.integers(0, 2), st.integers(0, 7),
                st.integers(0, 2**16))


def _interpret(ops):
    """After EVERY op, the port's batched sweep equals its lone solves for
    all tenants, bitwise, and its weights match the reference pool's."""
    pools = Pools()
    active = {n: [0] for n in TENANTS}
    dropped = {n: [] for n in TENANTS}
    next_id = {n: 1 for n in TENANTS}
    for kind, tslot, cslot, seed in ops:
        name = TENANTS[tslot % len(TENANTS)]
        if kind == 0:
            pools.ingest(name, seed, next_id[name])
            active[name].append(next_id[name])
            next_id[name] += 1
        elif kind == 1 and active[name]:
            cid = sorted(active[name])[cslot % len(active[name])]
            pools.both("drop", name, cid)
            active[name].remove(cid)
            dropped[name].append(cid)
        elif kind == 2 and dropped[name]:
            cid = sorted(dropped[name])[cslot % len(dropped[name])]
            pools.both("restore", name, cid)
            dropped[name].remove(cid)
            active[name].append(cid)
        elif kind == 3:
            pools.rows(name, seed)
        elif kind == 4:
            pools.rows(name, seed, sync=False)
        elif kind == 5:
            pools.both("flush", name)
        elif kind == 6:
            pools.both("solve", name, SIGMA)
        _assert_bitwise_matches_lone(pools.t, sigmas=(SIGMA,))
        # The reference solves once off factors that up/downdates have
        # moved (the port refines against G): after a drop its float32
        # weights can sit ~1e-5 off, so the JAX comparison takes the
        # reference interpreter's own 2e-4 (tests/test_pool_properties.py).
        _assert_matches_reference(pools, tol=2e-4)
    _assert_bitwise_matches_lone(pools.t)
    for name in TENANTS:
        assert pools.t.get(name).count == pools.j.get(name).count
    pools.close()


@hypothesis.given(ops=st.lists(_OP, min_size=1, max_size=5))
@hypothesis.settings(max_examples=10, deadline=None)
def test_solve_many_bitwise_under_random_interleavings(ops):
    _interpret(ops)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_solve_many_bitwise_seeded_interleavings(seed):
    rng = np.random.default_rng(seed)
    ops = [(int(rng.integers(7)), int(rng.integers(3)),
            int(rng.integers(8)), int(rng.integers(2**16)))
           for _ in range(6)]
    _interpret(ops)


# -- SolveBatcher ---------------------------------------------------------------

class TestSolveBatcher:
    def test_lone_request(self):
        pool = _port_pool()
        with SolveBatcher(pool) as batcher:
            w = batcher.solve("dense0", SIGMA)
            assert torch.equal(w, pool.solve("dense0", SIGMA))
            s = batcher.summary()
            assert s["requests"] == 1 and s["lone_dispatches"] == 1
        assert s.keys() == jserver.SolveBatcher(None).summary().keys()
        pool.close()

    def test_burst_coalesces_and_is_exact(self):
        pool = _port_pool()
        lone = {(n, s): pool.solve(n, s) for n in TENANTS for s in (SIGMA, SIGMA2)}
        with SolveBatcher(pool, window_s=0.05) as batcher:
            barrier = threading.Barrier(len(lone))
            results: dict = {}

            def ask(key):
                barrier.wait()
                results[key] = batcher.solve(*key)

            threads = [threading.Thread(target=ask, args=(k,)) for k in lone]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=30)
                assert not t.is_alive()
            stats = batcher.summary()
        for key, w in results.items():
            assert torch.equal(w, lone[key]), key
        assert stats["requests"] == len(lone)
        assert stats["sweeps"] < stats["requests"]
        assert stats["max_batch_seen"] >= 2
        pool.close()

    def test_bad_tenant_fails_alone(self):
        pool = _port_pool()
        with SolveBatcher(pool, window_s=0.05) as batcher:
            barrier = threading.Barrier(2)
            out: dict = {}

            def good():
                barrier.wait()
                out["good"] = batcher.solve("dense0", SIGMA)

            def bad():
                barrier.wait()
                try:
                    batcher.solve("missing", SIGMA)
                    out["bad"] = None
                except KeyError as e:
                    out["bad"] = e

            ts = [threading.Thread(target=good), threading.Thread(target=bad)]
            for t in ts:
                t.start()
            for t in ts:
                t.join(timeout=30)
        assert isinstance(out["bad"], KeyError)
        assert torch.equal(out["good"], pool.solve("dense0", SIGMA))
        pool.close()

    def test_solver_error_reaches_every_caller(self):
        """A failure of the solve itself (as a kernel error would be) is set
        on each request's future; nothing is answered in its place."""
        class Failing:
            def solve_many(self, requests, lifted=False):
                raise RuntimeError("kernel launch failed")

            def solve_lifted(self, name, sigma):
                raise RuntimeError(f"kernel launch failed for {name}")

        with SolveBatcher(Failing()) as batcher:
            futures = [batcher.submit(n, SIGMA) for n in TENANTS]
            for n, f in zip(TENANTS, futures):
                with pytest.raises(RuntimeError, match=n):
                    f.result(timeout=30)
            assert batcher.summary()["fallbacks"] >= 1

    def test_submit_requires_running(self):
        pool = _port_pool()
        batcher = SolveBatcher(pool)
        with pytest.raises(RuntimeError, match="not running"):
            batcher.submit("dense0", SIGMA)
        batcher.start()
        assert batcher.alive
        batcher.stop()
        assert not batcher.alive
        pool.close()


# -- admission control / quotas --------------------------------------------------

class TestAdmissionControl:
    def test_admission_error_is_value_error(self):
        assert issubclass(AdmissionError, ValueError)

    def _both(self, **kw):
        return (jserver.EnginePool(**kw), EnginePool(device="cpu", **kw))

    def test_max_tenants(self):
        for pool in self._both(max_tenants=2):
            conv = ((lambda s: s) if isinstance(pool, jserver.EnginePool)
                    else (lambda s: suffstats_from(s, device="cpu")))
            pool.create_tenant("a", clients=[conv(_jstats(0))], placement="dense")
            pool.create_tenant("b", clients=[conv(_jstats(1))], placement="dense")
            with pytest.raises(ValueError, match="max_tenants"):
                pool.create_tenant("c", clients=[conv(_jstats(2))],
                                   placement="dense")
            assert pool.admission_rejections == 1
            pool.drop_tenant("a")          # frees the slot
            pool.create_tenant("c", clients=[conv(_jstats(2))], placement="dense")
            pool.close()

    def test_stat_budget_bytes(self):
        one_tenant = (D * D + D) * 4
        jp, tp = self._both(stat_budget_bytes=int(one_tenant * 1.5))
        jp.create_tenant("a", clients=[_jstats(0)], placement="dense")
        tp.create_tenant("a", clients=[suffstats_from(_jstats(0), device="cpu")],
                         placement="dense")
        assert tp.resident_stat_bytes() == jp.resident_stat_bytes() >= one_tenant
        with pytest.raises(AdmissionError, match="stat_budget_bytes"):
            tp.create_tenant("b", clients=[suffstats_from(_jstats(1), device="cpu")],
                             placement="dense")
        assert tp.resident_bytes() >= tp.resident_stat_bytes()
        assert tp.resident_bytes() == jp.resident_bytes()
        # float64 statistics are priced at their own width
        tp64 = EnginePool(stat_budget_bytes=int(one_tenant * 1.5), device="cpu")
        with pytest.raises(AdmissionError, match="stat_budget_bytes"):
            tp64.create_tenant("w", dim=D, dtype=torch.float64)
        jp.close(), tp.close()

    def test_max_clients_per_tenant(self):
        pools = []
        for pool in self._both(max_clients_per_tenant=2):
            conv = ((lambda s: s) if isinstance(pool, jserver.EnginePool)
                    else (lambda s: suffstats_from(s, device="cpu")))
            arr = jnp.asarray if isinstance(pool, jserver.EnginePool) \
                else torch.from_numpy
            pool.create_tenant("a", clients={0: conv(_jstats(0))},
                               placement="dense")
            pool.ingest("a", conv(_jstats(1)), client_id=1)
            pool.ingest("a", conv(_jstats(2)), client_id=1)   # existing id
            A, b = _rows(3, n=2)
            pool.ingest_rows("a", arr(A), arr(b))             # anonymous
            with pytest.raises(ValueError, match="max_clients_per_tenant"):
                pool.ingest("a", conv(_jstats(4)), client_id=2)
            pool.drop("a", 1)          # a dropped client still counts
            with pytest.raises(ValueError, match="max_clients_per_tenant"):
                pool.ingest("a", conv(_jstats(5)), client_id=2)
            pools.append(pool)
        jp, tp = pools
        assert tp.admission_rejections == jp.admission_rejections == 2
        with pytest.raises(AdmissionError):
            tp.ingest("a", suffstats_from(_jstats(6), device="cpu"), client_id=3)
        assert tp.ledger() == jp.ledger()
        np.testing.assert_allclose(tp.stats("a").moment.numpy(),
                                   np.asarray(jp.stats("a").moment),
                                   rtol=RTOL, atol=ATOL)
        jp.close(), tp.close()
