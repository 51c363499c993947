"""Port parity for the serving pool (``server/pool.py``).

Mirrors tests/test_pool_properties.py (with its sharded and auto
placements on one shared mesh per pool), tests/test_pool_stress.py's
producer, staleness and shutdown classes, and the pool half of
tests/test_feature_tenants.py. The same numpy data and the same operations
go through a JAX pool and a port pool on the CPU:

  * fused (G, h) and every integer and byte of ``ledger()`` and
    ``summary()`` are equal bitwise where the statistics are made by the
    reference and carried over (elementwise IEEE adds in the same order);
  * weights, ``solve_report`` bounds and inference fields match within
    tests/test_torch_engine.py's 1e-5;
  * every tenant matches its own cold ``core.fusion`` reference after every
    operation (tenant isolation), as in the reference's interpreter.

Feature tenants use the reference's map arrays (``convert.feature_map_from``)
and rows the reference featurized, so both pools solve in the same space.
"""
import dataclasses
import threading
import warnings
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _hypo import hypothesis, st
from repro import core as jcore
from repro import server as jserver
from repro.core.features import FeatureMap as JFeatureMap
from repro.fed.protocol import PackedStats as JPackedStats
from repro_torch import core as tcore
from repro_torch.convert import feature_map_from, pool_from, suffstats_from
from repro_torch.core import features as tfeatures
from repro_torch.core import fusion
from repro_torch.fed import comm
from repro_torch.fed.protocol import PackedStats
from repro_torch.server import (CoalescerPolicy, EnginePool, solve_snapshot)

RTOL = ATOL = 1e-5
D = 6
SIGMA = 0.1
TENANTS = ("dense0", "dense1", "auto0", "sketch0", "rff0")
PLACEMENT = {"dense0": "dense", "dense1": "dense", "auto0": "auto",
             "sketch0": "dense", "rff0": "dense"}
JMAPS = {"sketch0": JFeatureMap("sketch", seed=123, d_orig=D, m=4),
         "rff0": JFeatureMap("rff", seed=321, d_orig=D, m=8)}
TMAPS = {name: feature_map_from(fm, fm.materialize(), device="cpu")
         for name, fm in JMAPS.items()}


def _np_rows(seed, n=8, d=D):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, d)).astype(np.float32),
            rng.standard_normal(n).astype(np.float32))


def _tenant_rows(name, seed, n=8):
    """Rows in ``name``'s solve space as numpy: featurized by the reference's
    map for §IV-F tenants."""
    A, b = _np_rows(seed, n)
    fm = JMAPS.get(name)
    if fm is not None:
        A = np.array(fm(jnp.asarray(A)))
    return A, b


def _jstats(A, b):
    return jcore.compute_stats(jnp.asarray(A), jnp.asarray(b))


def _t(s):
    return suffstats_from(s, device="cpu")


def _close(t, j, rtol=RTOL, atol=ATOL, err_msg=""):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=rtol, atol=atol,
                               err_msg=err_msg)


class Pools:
    """A JAX pool and a port pool (CPU), same tenants, same operations."""

    def __init__(self, tenants=TENANTS, **kw):
        self.j = jserver.EnginePool(
            default_coalesce=jserver.CoalescerPolicy(max_rank=5), **kw)
        self.t = EnginePool(default_coalesce=CoalescerPolicy(max_rank=5),
                            device="cpu", **kw)
        for i, name in enumerate(tenants):
            s = _jstats(*_tenant_rows(name, 1000 + i))
            self.j.create_tenant(name, clients={0: s}, placement=PLACEMENT[name],
                                 max_update_rank=100, features=JMAPS.get(name))
            self.t.create_tenant(name, clients={0: _t(s)},
                                 placement=PLACEMENT[name], max_update_rank=100,
                                 features=TMAPS.get(name))

    def both(self, op, /, *args, **kw):
        getattr(self.j, op)(*args, **kw)
        getattr(self.t, op)(*args, **kw)

    def close(self):
        self.j.close()
        self.t.close()


# -- tenant isolation under random interleavings ------------------------------

# (kind, tenant slot, client slot, data seed). Kinds: 0 ingest a new client,
# 1 drop, 2 restore, 3 ingest_rows, 4 ingest_rows_async, 5 flush, 6 solve.
_OP = st.tuples(st.integers(0, 6), st.integers(0, 4), st.integers(0, 7),
                st.integers(0, 2**16))


def _interpret(ops):
    """Drive ops against both pools; after every op, every port tenant
    matches its cold reference over its own rows and the JAX pool."""
    pools = Pools()
    active = {n: {0: [_tenant_rows(n, 1000 + t)]} for t, n in enumerate(TENANTS)}
    dropped = {n: {} for n in TENANTS}
    anon = {n: [] for n in TENANTS}
    next_id = {n: 1 for n in TENANTS}
    for kind, tslot, cslot, seed in ops:
        name = TENANTS[tslot % len(TENANTS)]
        if kind == 0:
            A, b = _tenant_rows(name, seed)
            s = _jstats(A, b)
            cid = next_id[name]
            pools.j.ingest(name, s, client_id=cid)
            pools.t.ingest(name, _t(s), client_id=cid)
            active[name][cid] = [(A, b)]
            next_id[name] += 1
        elif kind == 1 and active[name]:
            cid = sorted(active[name])[cslot % len(active[name])]
            pools.both("drop", name, cid)
            dropped[name][cid] = active[name].pop(cid)
        elif kind == 2 and dropped[name]:
            cid = sorted(dropped[name])[cslot % len(dropped[name])]
            pools.both("restore", name, cid)
            active[name][cid] = dropped[name].pop(cid)
        elif kind in (3, 4):
            A, b = _tenant_rows(name, seed, n=3)
            method = "ingest_rows" if kind == 3 else "ingest_rows_async"
            getattr(pools.j, method)(name, jnp.asarray(A), jnp.asarray(b))
            getattr(pools.t, method)(name, torch.from_numpy(A),
                                     torch.from_numpy(b))
            anon[name].append((A, b))
        elif kind == 5:
            pools.both("flush", name)
        elif kind == 6:
            pools.both("solve", name, SIGMA)
        else:
            continue
        for other in TENANTS:
            chunks = [c for cs in active[other].values() for c in cs] + anon[other]
            if not chunks:
                continue
            A_all = torch.from_numpy(np.concatenate([a for a, _ in chunks]))
            b_all = torch.from_numpy(np.concatenate([b for _, b in chunks]))
            w_ref = fusion.solve_ridge(tcore.compute_stats(A_all, b_all), SIGMA)
            w = pools.t.solve(other, SIGMA)
            msg = f"tenant {other} after {kind=} on {name}"
            np.testing.assert_allclose(w.numpy(), w_ref.numpy(), rtol=2e-4,
                                       atol=2e-4, err_msg=msg)
            # The reference solves once off factors that up/downdates have
            # moved (the port refines against G), so its weights take the
            # same 2e-4; the port is held to float64 of its own state at 1e-5.
            _close(w, pools.j.solve(other, SIGMA), 2e-4, 2e-4, err_msg=msg)
            s = pools.t.stats(other)
            G = s.gram.double()
            _close(w.double(), torch.linalg.solve(
                G + SIGMA * torch.eye(G.shape[0], dtype=G.dtype),
                s.moment.double()), err_msg=msg)
            assert pools.t.get(other).count == A_all.shape[0] == \
                pools.j.get(other).count
            if other in TMAPS:
                _close(pools.t.solve_lifted(other, SIGMA),
                       pools.j.solve_lifted(other, SIGMA), 2e-4, 5e-4,
                       err_msg=msg)
    pools.close()


@hypothesis.given(ops=st.lists(_OP, min_size=1, max_size=6))
@hypothesis.settings(max_examples=10, deadline=None)
def test_tenant_isolation_under_random_interleavings(ops):
    _interpret(ops)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_tenant_isolation_seeded_interleavings(seed):
    rng = np.random.default_rng(seed)
    ops = [(int(rng.integers(7)), int(rng.integers(5)),
            int(rng.integers(8)), int(rng.integers(2**16)))
           for _ in range(8)]
    _interpret(ops)


# -- ledger, summary and fused statistics, bitwise -------------------------------

def _summary_without_clock(s):
    s = dict(s)
    s.pop("max_flush_age_s")
    s["per_tenant"] = {n: {k: v for k, v in t.items() if k != "max_flush_age_s"}
                       for n, t in s["per_tenant"].items()}
    return s


def _mixed_scenario():
    """Admissions of every kind and the same mutations on both pools; only
    statistics the reference made reach either pool's fused state."""
    pools = Pools(tenants=())
    j, t = pools.j, pools.t
    payloads = {k: JPackedStats.pack(_jstats(*_np_rows(k))) for k in range(3)}
    j.create_tenant("pay", payloads=payloads, placement="dense")
    t.create_tenant("pay", payloads={k: PackedStats.pack(_t(p.unpack()))
                                     for k, p in payloads.items()},
                    placement="dense")
    cl = {f"c{k}": _jstats(*_np_rows(10 + k)) for k in range(3)}
    j.create_tenant("cli", clients=cl, placement="auto")
    t.create_tenant("cli", clients={k: _t(s) for k, s in cl.items()},
                    placement="auto")
    s = _jstats(*_np_rows(20, n=30))
    j.create_tenant("pre", stats=s, placement="dense")
    t.create_tenant("pre", stats=_t(s), placement="dense")
    pools.both("create_tenant", "empty", dim=D, placement="dense")
    for name in ("sketch0", "rff0"):
        fs = {k: _jstats(*_tenant_rows(name, 30 + k)) for k in range(2)}
        j.create_tenant(name, payloads={k: JPackedStats.pack(v)
                                        for k, v in fs.items()},
                        features=JMAPS[name])
        t.create_tenant(name, payloads={k: PackedStats.pack(_t(v))
                                        for k, v in fs.items()},
                        features=TMAPS[name])
    for i, name in enumerate(("pay", "cli", "empty", "sketch0")):
        d = 4 if name == "sketch0" else D
        s = _jstats(*_tenant_rows(name, 40 + i)) if d != D \
            else _jstats(*_np_rows(40 + i))
        j.ingest(name, s, client_id="new")
        t.ingest(name, _t(s), client_id="new")
    pools.both("solve_batch", "cli", [0.1, 0.5, 1.0], method="chol")
    pools.both("solve", "pay", SIGMA)
    pools.both("drop", "cli", "c1")
    pools.both("solve", "cli", SIGMA)
    s = _jstats(*_np_rows(50, n=2))
    j.ingest_async("pay", s)
    t.ingest_async("pay", _t(s))
    pools.both("flush")
    pools.both("restore", "cli", "c1")
    A, b = _np_rows(60, n=3)
    j.ingest_rows("pre", jnp.asarray(A), jnp.asarray(b))   # streamed bytes
    t.ingest_rows("pre", torch.from_numpy(A), torch.from_numpy(b))
    for name in ("pay", "cli", "sketch0", "rff0", "empty"):
        pools.both("solve", name, SIGMA)
    pools.both("solve_many", [("pay", SIGMA), ("cli", 0.5), ("rff0", SIGMA),
                              ("sketch0", SIGMA), ("empty", SIGMA)])
    return pools


class TestLedgerAndSummary:
    def test_fused_stats_bitwise(self):
        pools = _mixed_scenario()
        for name in ("pay", "cli", "empty", "sketch0", "rff0"):
            st_, sj = pools.t.stats(name), pools.j.stats(name)
            for field in ("gram", "moment", "yty"):
                np.testing.assert_array_equal(
                    getattr(st_, field).numpy(), np.asarray(getattr(sj, field)),
                    err_msg=f"{name}.{field}")
            assert int(st_.count) == int(sj.count)
        pools.close()

    def test_ledger_and_summary_equal(self):
        pools = _mixed_scenario()
        assert pools.t.ledger() == pools.j.ledger()
        sj, st_ = pools.j.summary(), pools.t.summary()
        assert st_.keys() == sj.keys()
        assert _summary_without_clock(st_) == _summary_without_clock(sj)
        assert st_["batched_sweeps"] == 3 and st_["batched_solves"] == 5
        by_kind = pools.t.ledger()["by_kind"]
        assert set(by_kind) == {"dense", "sketched", "rff"}
        assert by_kind["sketched"]["upload_bytes"] < by_kind["dense"]["upload_bytes"]
        pools.close()

    def test_apply_and_batched_reads_match(self):
        pools = _mixed_scenario()
        pools.both("apply", "pay", lambda s: s + s)    # post-processing
        st_, sj = pools.t.stats("pay"), pools.j.stats("pay")
        np.testing.assert_array_equal(st_.gram.numpy(), np.asarray(sj.gram))
        assert pools.t.get("pay").cached_factor_count == 0
        _close(pools.t.solve("pay", SIGMA), pools.j.solve("pay", SIGMA))
        q = _np_rows(71, n=5)[0]
        for name in ("pay", "cli"):
            _close(pools.t.solve_batch(name, [0.1, 1.0], method="chol"),
                   pools.j.solve_batch(name, [0.1, 1.0], method="chol"))
            _close(pools.t.predict(name, torch.from_numpy(q), SIGMA),
                   pools.j.predict(name, jnp.asarray(q), SIGMA), rtol=1e-4,
                   atol=1e-4)
            _close(pools.t.predict_batch(name, torch.from_numpy(q), [0.1, 1.0]),
                   pools.j.predict_batch(name, jnp.asarray(q), [0.1, 1.0]),
                   rtol=1e-4, atol=1e-4)
        assert pools.t.resident_bytes() == pools.j.resident_bytes()
        pools.close()

    def test_weights_and_reports_match(self):
        pools = _mixed_scenario()
        q = _np_rows(70, n=3)[0]
        for name in ("pay", "cli", "pre", "sketch0", "rff0"):
            _close(pools.t.solve_lifted(name, SIGMA),
                   pools.j.solve_lifted(name, SIGMA))
            rt = pools.t.solve_report(name, SIGMA, queries=torch.from_numpy(q))
            rj = pools.j.solve_report(name, SIGMA, queries=jnp.asarray(q))
            assert rt.keys() == rj.keys()
            for key in ("sigma", "kind", "solve_dim", "d_orig", "m",
                        "upload_floats"):
                assert rt.get(key) == rj.get(key), key
            _close(rt["weights"], rj["weights"])
            if "error_bound" in rj:
                assert rt["error_bound"] == pytest.approx(rj["error_bound"],
                                                          rel=RTOL)
            for key in ("stderr", "ci", "pi"):
                np.testing.assert_allclose(rt[key], np.asarray(rj[key]),
                                           rtol=RTOL, atol=ATOL, err_msg=key)
            assert rt["inference"]["n"] == rj["inference"]["n"]
            for key in ("level", "dof", "rss", "sigma2"):
                assert rt["inference"][key] == pytest.approx(
                    rj["inference"][key], rel=RTOL), key
        pools.close()


# -- admission, placement, not-yet-ported paths ------------------------------------

class TestAdmission:
    def _stats(self, seed=0):
        return _t(_jstats(*_np_rows(seed)))

    def test_exactly_one_source(self):
        pool = EnginePool(device="cpu")
        s = self._stats()
        with pytest.raises(ValueError, match="at most one"):
            pool.create_tenant("x", clients=[s], stats=s)
        with pytest.raises(ValueError, match="clients, payloads, stats"):
            pool.create_tenant("x")

    def test_duplicate_name_rejected(self):
        pool = EnginePool(device="cpu")
        pool.create_tenant("x", clients=[self._stats()], placement="dense")
        with pytest.raises(ValueError, match="already exists"):
            pool.create_tenant("x", clients=[self._stats()])

    def test_unknown_placement_rejected(self):
        with pytest.raises(ValueError, match="placement"):
            EnginePool(device="cpu").create_tenant(
                "x", clients=[self._stats()], placement="tpu")

    def test_payload_admission_measures_wire_bytes(self):
        pool = EnginePool(device="cpu")
        payloads = {k: PackedStats.pack(self._stats(k)) for k in range(3)}
        pool.create_tenant("x", payloads=payloads, placement="dense")
        rec = pool.tenant("x").comm
        assert rec.upload_floats_per_client == D * (D + 1) // 2 + D
        assert rec.num_clients == 3
        led = pool.ledger()
        assert led["upload_download_bytes"] == rec.total_bytes
        assert led["per_tenant"]["x"]["streamed_bytes"] == 0
        A, b = _np_rows(9, n=4)
        pool.ingest_rows("x", torch.from_numpy(A), torch.from_numpy(b))
        assert pool.ledger()["per_tenant"]["x"]["streamed_bytes"] == \
            4 * (D + 1) * comm.FLOAT_BYTES

    def test_empty_payloads_rejected(self):
        with pytest.raises(ValueError, match="at least one client's payload"):
            EnginePool(device="cpu").create_tenant("x", payloads=[])

    def test_stats_admission_records_no_upload_bytes(self):
        pool = EnginePool(device="cpu")
        pool.create_tenant("x", stats=self._stats(), placement="dense")
        pool.create_tenant("y", dim=D, placement="dense")
        assert pool.tenant("x").comm is None
        assert pool.ledger()["upload_download_bytes"] == 0

    def test_empty_tenant_from_dim(self):
        pool = EnginePool(device="cpu")
        pool.create_tenant("x", dim=D, placement="dense", dtype=torch.float64)
        eng = pool.get("x")
        assert eng.dtype == torch.float64
        assert eng.stats.gram.device == torch.device("cpu")
        A, b = (torch.from_numpy(x).double() for x in _np_rows(3))
        pool.ingest("x", tcore.compute_stats(A, b), client_id=0)
        w_ref = fusion.solve_ridge(tcore.compute_stats(A, b), SIGMA)
        np.testing.assert_allclose(pool.solve("x", SIGMA).numpy(),
                                   w_ref.numpy(), rtol=1e-10, atol=1e-12)

    def test_entry_points_default_to_the_card(self):
        assert EnginePool().device == torch.device("cuda")

    def test_statistics_on_another_device_raise(self):
        pool = EnginePool()        # the card
        with pytest.raises(ValueError, match="statistics on cpu"):
            pool.create_tenant("x", clients=[self._stats()], placement="dense")
        assert len(pool) == 0

    @pytest.mark.parametrize("case", ["mesh", "sharded"])
    def test_mesh_and_sharded_placement_admit(self, case):
        """A given mesh is the one every sharded tenant shares (none is
        built); without one the pool builds its own at the first sharded
        placement, on its device. ``backend_kwargs`` reach the backend."""
        from repro_torch.launch.mesh import make_cpu_mesh

        mesh = make_cpu_mesh(4) if case == "mesh" else None
        pool = EnginePool(device="cpu", mesh=mesh)
        pool.create_tenant("x", dim=D, placement="sharded",
                           backend_kwargs={"block_size": 4})
        be = pool.get("x").backend
        assert be.name == "sharded" and be.block_size == 4
        assert be.mesh is pool.shared_mesh()
        assert pool.meshes_built == (0 if case == "mesh" else 1)
        assert be.mesh.shape == ({"data": 2, "model": 2} if case == "mesh"
                                 else {"data": 4, "model": 2})
        A, b = (torch.from_numpy(x) for x in _np_rows(3))
        pool.ingest_rows("x", A, b, client_id=0)
        w_ref = fusion.solve_ridge(tcore.compute_stats(A, b), SIGMA)
        np.testing.assert_allclose(pool.solve("x", SIGMA).numpy(),
                                   w_ref.numpy(), rtol=1e-5, atol=1e-6)
        with pytest.raises(ValueError, match="journal_placement"):
            EnginePool(device="cpu", journal_placement="nowhere")

    def test_psd_guard_admission(self):
        """``psd_guard=True`` checks the admitted Gram: PSD statistics pass
        untouched (bitwise), and the pool counts no repair."""
        pool = EnginePool(device="cpu")
        s = self._stats()
        eng = pool.create_tenant("x", stats=s, psd_guard=True)
        t = pool.tenant("x")
        assert t.psd_repairs == 0 and t.guard_min_eig >= 0
        assert torch.equal(eng.stats.gram, s.gram)
        assert pool.summary()["psd_repairs"] == 0
        assert pool.summary()["per_tenant"]["x"]["psd_repairs"] == 0

    @pytest.mark.parametrize("case", ["journal_dir", "snapshot"])
    def test_the_pool_journals_and_snapshots(self, case, tmp_path):
        """Durability is ported: ``journal_dir`` journals an admitted frame
        before it fuses, and ``snapshot()`` commits the tenant; a pool
        without a journal snapshots nothing."""
        from repro_torch.fed import wire
        from repro_torch.server.durability import DurableStore, scan_segment

        assert EnginePool(device="cpu").snapshot() is None
        raw = wire.encode_frame(wire.StatsFrame.from_stats(
            self._stats(), client_id="c0"))
        pool = EnginePool(device="cpu", journal_dir=tmp_path)
        assert pool.journaled and pool.summary()["journaled"]
        assert pool.admit_frame("x", wire.decode_frame(raw),
                                encoded_len=len(raw), raw=raw).ok
        if case == "journal_dir":
            (rec,) = scan_segment(tmp_path / "wal_00000000.log").records
            assert (rec.tenant, rec.raw) == ("x", raw)
        else:
            seq = pool.snapshot()
            assert DurableStore(tmp_path).committed_snapshot_seqs() == [seq]
            assert pool.summary()["snapshots_taken"] == 1
        pool.close()
        restored = EnginePool(device="cpu", journal_dir=tmp_path)
        assert torch.equal(restored.stats("x").gram, pool.stats("x").gram)
        restored.close()


class TestPlacement:
    def test_dense_pool_builds_no_mesh(self):
        for pool in (jserver.EnginePool(), EnginePool(device="cpu")):
            s = _jstats(*_np_rows(0))
            s = s if isinstance(pool, jserver.EnginePool) else _t(s)
            pool.create_tenant("d0", clients=[s], placement="dense")
            pool.create_tenant("a0", clients=[s], placement="auto")
            assert pool.summary()["meshes_built"] == 0
            assert pool.tenant("a0").backend_name == "dense"
            assert pool.tenant("a0").placement == "auto"
            assert pool.summary()["placements"] == {"dense": 2}

    def test_auto_threshold_override_would_place_sharded(self):
        """tests/test_pool_properties.py's override: every tenant at or
        above the threshold goes sharded, on one mesh built for it; the
        reference pool here (its mesh as wide as this process's host
        devices, 1 x 1 on one) and a port pool whose mesh has that shape
        agree on the ledger, the summary and the fused statistics."""
        import jax

        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            jp = jserver.EnginePool(threshold=D)
            s = _jstats(*_np_rows(0))
            jp.create_tenant("a0", clients=[s], placement="auto")
        tp = EnginePool(threshold=D, device="cpu",
                        mesh_devices=min(8, jax.device_count()))
        tp.create_tenant("a0", clients=[_t(s)], placement="auto")
        for pool in (jp, tp):
            assert pool.tenant("a0").backend_name == "sharded"
            assert pool.meshes_built == 1
        assert tp.summary() == jp.summary()
        assert tp.ledger() == jp.ledger()
        np.testing.assert_array_equal(tp.stats("a0").gram.numpy(),
                                      np.asarray(jp.stats("a0").gram))

    def test_auto_threshold_override_places_sharded(self):
        pool = EnginePool(threshold=D, device="cpu")   # every d >= D: sharded
        pool.create_tenant("a0", clients=[_t(_jstats(*_np_rows(0)))],
                           placement="auto")
        assert pool.tenant("a0").backend_name == "sharded"
        assert pool.tenant("a0").placement == "auto"
        assert pool.meshes_built == 1

    def test_sharded_tenants_share_one_mesh(self):
        pool = EnginePool(device="cpu")
        s = _t(_jstats(*_np_rows(0)))
        for i in range(3):
            pool.create_tenant(f"s{i}", clients=[s], placement="sharded")
        meshes = {id(pool.get(f"s{i}").backend.mesh) for i in range(3)}
        assert len(meshes) == 1
        assert pool.meshes_built == 1
        assert pool.summary()["placements"] == {"sharded": 3}
        assert pool.summary()["meshes_built"] == 1

    def test_sharded_admission_ledger_is_the_references_record(self):
        """On the (4, 2) mesh the reduction crosses the 4-way data axis: the
        admission record is the reference's ShardedCommRecord for it, field
        for field, and the pool ledger counts its cross-shard bytes."""
        from repro.fed import comm as jcomm

        pool = EnginePool(device="cpu")
        stats = {k: _t(_jstats(*_np_rows(k))) for k in range(3)}
        pool.create_tenant("s", clients=stats, placement="sharded")
        rec = pool.tenant("s").comm
        assert isinstance(rec, comm.ShardedCommRecord)
        base = jcomm.one_shot_comm(D, 3)
        want = jcomm.ShardedCommRecord(
            upload_floats_per_client=base.upload_floats_per_client,
            download_floats_per_client=base.download_floats_per_client,
            num_clients=3, rounds=base.rounds,
            upload_wire_bytes_per_client=base.upload_wire_bytes_per_client,
            download_wire_bytes_per_client=base.download_wire_bytes_per_client,
            psum_floats_per_axis=jcomm.sharded_oneshot_record(
                D, 3, {"data": 4}).psum_floats_per_axis)
        assert dataclasses.asdict(rec) == dataclasses.asdict(want)
        assert pool.ledger()["cross_shard_bytes"] == want.cross_shard_bytes > 0

    def test_sharded_tenants_solve_under_their_lock_outside_stacks(self):
        pool = EnginePool(device="cpu", mesh_devices=4)
        for name, placement in (("d0", "dense"), ("d1", "dense"), ("s0", "sharded")):
            pool.create_tenant(name, clients=[_t(_jstats(*_np_rows(7)))],
                               placement=placement)
        ws = pool.solve_many([("d0", SIGMA), ("s0", SIGMA), ("d1", SIGMA)])
        assert pool.batched_solves == 2 and pool.batched_sweeps == 1
        assert torch.equal(ws[1], pool.solve("s0", SIGMA))
        np.testing.assert_allclose(ws[1].numpy(), ws[0].numpy(), rtol=1e-5,
                                   atol=1e-6)


class TestEviction:
    def test_lru_evicts_coldest_factor_cache(self):
        jp, tp = jserver.EnginePool(max_warm=1), EnginePool(max_warm=1, device="cpu")
        for i in range(3):
            s = _jstats(*_np_rows(i))
            jp.create_tenant(f"t{i}", clients=[s], placement="dense")
            tp.create_tenant(f"t{i}", clients=[_t(s)], placement="dense")
        for pool in (jp, tp):
            pool.solve("t0", SIGMA)
            assert pool.warm_tenants() == ("t0",)
            pool.solve("t1", SIGMA)
            assert pool.warm_tenants() == ("t1",)
            assert pool.get("t0").cached_factor_count == 0
            assert pool.tenant("t0").factor_evictions == 1
        w_ref = fusion.solve_ridge(tcore.compute_stats(
            *(torch.from_numpy(x) for x in _np_rows(0))), SIGMA)
        np.testing.assert_allclose(tp.solve("t0", SIGMA).numpy(), w_ref.numpy(),
                                   rtol=1e-4, atol=1e-4)
        _close(tp.solve("t0", SIGMA), jp.solve("t0", SIGMA))
        assert tp.summary()["factor_evictions"] == jp.summary()["factor_evictions"]

    def test_no_eviction_without_bound(self):
        pool = EnginePool(device="cpu")
        for i in range(3):
            pool.create_tenant(f"t{i}", clients=[_t(_jstats(*_np_rows(i)))],
                               placement="dense")
            pool.solve(f"t{i}", SIGMA)
        assert len(pool.warm_tenants()) == 3
        assert pool.summary()["factor_evictions"] == 0


class TestRegistry:
    def test_drop_tenant(self):
        pool = EnginePool(device="cpu")
        pool.create_tenant("x", clients=[_t(_jstats(*_np_rows(0)))],
                           placement="dense")
        assert "x" in pool and len(pool) == 1
        eng = pool.drop_tenant("x")
        assert "x" not in pool and len(pool) == 0
        assert eng.count == 8
        with pytest.raises(KeyError):
            pool.solve("x", SIGMA)

    def test_snapshot_survives_a_flush(self):
        """Operands snapshotted before a flush still solve to their old bits
        after it: the blocked update (rank >= 8) works on copies."""
        pool = EnginePool(default_coalesce=CoalescerPolicy(max_rank=64),
                          device="cpu")
        pool.create_tenant("x", clients=[_t(_jstats(*_np_rows(0, n=40)))],
                           placement="dense", max_update_rank=64)
        factor = pool.get("x").factor(SIGMA)
        ops = pool.get("x").backend.solve_operands(factor, SIGMA)
        copies = [o.clone() for o in ops[:3]]
        w0 = solve_snapshot(*ops)
        A, b = _np_rows(1, n=16)
        pool.ingest_rows_async("x", torch.from_numpy(A), torch.from_numpy(b))
        pool.flush("x")
        assert pool.get("x").incremental_updates == 1
        assert pool.get("x").flush_ranks == {16: 1}
        assert not torch.equal(pool.get("x").factor(SIGMA), factor)
        assert all(torch.equal(o, c) for o, c in zip(ops, copies))
        assert torch.equal(solve_snapshot(*ops), w0)


# -- §IV-F feature tenants on the pool ------------------------------------------------

class TestFeatureTenants:
    def test_solve_report_rff_has_no_weightspace_bound(self):
        pool = EnginePool(device="cpu")
        fs = _t(_jstats(*_tenant_rows("rff0", 0)))
        pool.create_tenant("rf", payloads=[PackedStats.pack(fs)],
                           features=TMAPS["rff0"])
        rep = pool.solve_report("rf", SIGMA)
        assert rep["kind"] == "rff" and rep["solve_dim"] == 8
        assert "error_bound" not in rep
        pool.create_tenant("dense", stats=_t(_jstats(*_np_rows(1))))
        rep = pool.solve_report("dense", SIGMA)
        assert rep["kind"] == "dense"
        assert "error_bound" not in rep and "m" not in rep
        assert pool.tenant("rf").projection is None

    def test_solve_report_carries_prop3_bound(self):
        pool = EnginePool(device="cpu")
        fm = TMAPS["sketch0"]
        pool.create_tenant("sk", payloads=[PackedStats.pack(fm.stats(
            *(torch.from_numpy(x) for x in _np_rows(k, n=20)))) for k in range(3)],
            features=fm)
        rep = pool.solve_report("sk", SIGMA)
        w = rep["weights"]
        assert w.shape == (D,)
        assert torch.equal(w, pool.solve_lifted("sk", SIGMA))
        assert rep["error_bound"] == pytest.approx(
            np.sqrt(D / 4) * float(torch.linalg.norm(w)), rel=1e-6)
        assert pool.tenant("sk").projection == {
            "seed": 123, "d_orig": D, "m": 4, "rhash": fm.fhash}

    def test_solve_many_buckets_sketched_with_dense_same_dim(self):
        pool = EnginePool(device="cpu")
        fm = TMAPS["sketch0"]
        pool.create_tenant("sk", payloads=[PackedStats.pack(fm.stats(
            *(torch.from_numpy(x) for x in _np_rows(k, n=20)))) for k in range(3)],
            features=fm)
        pool.create_tenant("dense_m", stats=_t(_jstats(*_np_rows(9, d=4))))
        lone = [pool.solve_lifted("sk", SIGMA), pool.solve("dense_m", SIGMA)]
        before = pool.batched_sweeps
        ws = pool.solve_many([("sk", SIGMA), ("dense_m", SIGMA)], lifted=True)
        assert pool.batched_sweeps == before + 1
        assert ws[0].shape == (D,) and ws[1].shape == (4,)
        assert torch.equal(ws[0], lone[0]) and torch.equal(ws[1], lone[1])

    def test_create_tenant_rejects_original_space_stats(self):
        pool = EnginePool(device="cpu")
        with pytest.raises(ValueError, match="feature-space statistics"):
            pool.create_tenant("bad", stats=_t(_jstats(*_np_rows(0))),
                               features=TMAPS["sketch0"])

    def test_feature_tenant_streams_feature_space_rows(self):
        A, b = (torch.from_numpy(x) for x in _np_rows(0, n=32))
        fm = TMAPS["sketch0"]
        pool = EnginePool(device="cpu")
        pool.create_tenant("sk", payloads=[PackedStats.pack(fm.stats(A[:20], b[:20]))],
                           features=fm)
        pool.ingest_rows("sk", fm(A[20:]), b[20:])
        ref = fm.lift(fusion.solve_ridge(fm.stats(A, b), SIGMA))
        np.testing.assert_allclose(pool.solve_lifted("sk", SIGMA).numpy(),
                                   ref.numpy(), rtol=1e-4, atol=1e-5)

    def test_two_threads_materialize_one_map_alike(self):
        """The map caches are shared: two threads that draw one fresh map
        at once may both draw it, and must get the same arrays."""
        for kind, m in (("sketch", 5), ("rff", 7)):
            fm = tcore.FeatureMap(kind, seed=90210, d_orig=11, m=m)
            tfeatures._drawn.cache_clear()
            tfeatures._on_device.cache_clear()
            barrier, out = threading.Barrier(4), [None] * 4

            def draw(i):
                barrier.wait()
                out[i] = fm.materialize("cpu")

            threads = [threading.Thread(target=draw, args=(i,)) for i in range(4)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
                assert not t.is_alive()
            for arrays in out[1:]:
                assert all(torch.equal(a, b) for a, b in zip(arrays, out[0]))


# -- convert.pool_from ---------------------------------------------------------------------

def test_pool_from_keeps_a_sharded_placement():
    """A reference pool's sharded tenant comes over sharded, on a mesh of
    the reference mesh's shape (``convert.mesh_from``), with its block size
    and method; fused statistics, summary and ledger equal."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")       # a 1 x 1 mesh in this process
        jp = jserver.EnginePool()
        s = _jstats(*_np_rows(11))
        jp.create_tenant("s0", clients={0: s}, placement="sharded",
                         backend_kwargs={"block_size": 4})
        jp.create_tenant("d0", clients={0: s}, placement="dense")
    tp = pool_from(jp, device="cpu")
    t = tp.tenant("s0")
    assert t.backend_name == "sharded" and t.placement == "sharded"
    assert t.engine.backend.block_size == 4
    assert t.engine.backend.mesh.shape == dict(jp.shared_mesh().shape)
    assert tp.meshes_built == jp.meshes_built == 1
    assert tp.summary() == jp.summary() and tp.ledger() == jp.ledger()
    np.testing.assert_array_equal(tp.stats("s0").gram.numpy(),
                                  np.asarray(jp.stats("s0").gram))
    _close(tp.solve("s0", SIGMA), jp.solve("s0", SIGMA))


def test_pool_from_round_trips_a_mixed_pool():
    jp = jserver.EnginePool(max_warm=3, max_tenants=9, max_clients_per_tenant=6,
                            default_coalesce=jserver.CoalescerPolicy(
                                max_rank=7, max_staleness_s=2.0), tier="relay")
    payloads = {k: JPackedStats.pack(_jstats(*_np_rows(k))) for k in range(3)}
    jp.create_tenant("pay", payloads=payloads, placement="dense")
    jp.create_tenant("cli", clients={f"c{k}": _jstats(*_np_rows(10 + k))
                                     for k in range(3)}, placement="auto",
                     coalesce=jserver.CoalescerPolicy(max_rank=3),
                     max_update_rank=50)
    for name in ("sketch0", "rff0"):
        jp.create_tenant(name, clients={k: _jstats(*_tenant_rows(name, 30 + k))
                                        for k in range(2)},
                         features=JMAPS[name])
    jp.drop("cli", "c1")
    A, b = _np_rows(5, n=3)
    jp.ingest_rows("pay", jnp.asarray(A), jnp.asarray(b))        # anonymous
    jp.ingest_rows_async("sketch0", jnp.asarray(_tenant_rows("sketch0", 6, 2)[0]),
                         jnp.asarray(b[:2]))                      # queued
    tp = pool_from(jp, {"rff0": JMAPS["rff0"].materialize()}, device="cpu")
    assert tp.tenant_names == jp.tenant_names
    assert (tp.max_warm, tp.max_tenants, tp.max_clients_per_tenant, tp.tier) == \
        (3, 9, 6, "relay")
    assert tp.tenant("cli").placement == "auto"
    assert tp.get("cli").coalesce == CoalescerPolicy(max_rank=3)
    assert tp.get("cli").max_update_rank == 50
    assert tp.get("pay").coalesce == CoalescerPolicy(max_rank=7, max_staleness_s=2.0)
    assert tp.ledger() == jp.ledger()
    for name in jp.tenant_names:
        st_, sj = tp.stats(name), jp.stats(name)
        for field in ("gram", "moment", "yty"):
            np.testing.assert_array_equal(getattr(st_, field).numpy(),
                                          np.asarray(getattr(sj, field)))
        assert tp.tenant(name).kind == jp.tenant(name).kind
        assert tp.get(name).client_ids == jp.get(name).client_ids
        assert tp.get(name).dropped_ids == jp.get(name).dropped_ids
        _close(tp.solve_lifted(name, SIGMA), jp.solve_lifted(name, SIGMA))
    # the ledger keeps working: Thm-8 restore on both sides
    jp.restore("cli", "c1")
    tp.restore("cli", "c1")
    _close(tp.solve("cli", SIGMA), jp.solve("cli", SIGMA))
    jp.close(), tp.close()


# -- the background flusher (tests/test_pool_stress.py) -----------------------------

SD = 12
STALENESS = 0.1
SMAPS = {"dense": None,
         "sketch": JFeatureMap("sketch", seed=77, d_orig=SD, m=6),
         "rff": JFeatureMap("rff", seed=78, d_orig=SD, m=8)}


def _flusher_threads():
    return [t for t in threading.enumerate()
            if t.name.startswith("EnginePool-flusher")]


@pytest.fixture
def no_flusher_leak():
    assert not _flusher_threads(), "flusher leaked into this test"
    yield
    assert not _flusher_threads(), "flusher leaked out of this test"


def _solve_rows(seed, n, fm=None):
    A, b = _np_rows(seed, n, d=SD)
    if fm is not None:
        A = np.array(fm(jnp.asarray(A)))
    return torch.from_numpy(A), torch.from_numpy(b)


def _stress_pool(fm=None):
    pool = EnginePool(default_coalesce=CoalescerPolicy(
        max_rank=10**6, max_staleness_s=STALENESS), device="cpu")
    A, b = _solve_rows(0, 24, fm)
    tfm = None if fm is None else feature_map_from(fm, fm.materialize(),
                                                   device="cpu")
    pool.create_tenant("t", clients={0: tcore.compute_stats(A, b)},
                       placement="dense", max_update_rank=10**6, features=tfm)
    return pool, (A, b)


@pytest.mark.usefixtures("no_flusher_leak")
class TestConcurrentProducer:
    N_DELTAS = 32

    @pytest.mark.parametrize("kind", list(SMAPS))
    def test_reads_always_see_exact_prefix_state(self, kind):
        fm = SMAPS[kind]
        pool, (A0, b0) = _stress_pool(fm)
        deltas = [_solve_rows(100 + i, 1, fm) for i in range(self.N_DELTAS)]
        pool.solve("t", SIGMA)
        base_rows = int(pool.get("t").count)

        def prefix_ref(n_extra):
            A = torch.cat([A0] + [a for a, _ in deltas[:n_extra]])
            b = torch.cat([b0] + [b for _, b in deltas[:n_extra]])
            return fusion.solve_ridge(tcore.compute_stats(A, b), SIGMA)

        stop = threading.Event()
        errors: list[str] = []

        def produce():
            try:
                for dA, db in deltas:
                    pool.ingest_rows_async("t", dA, db)
                    time.sleep(0.003)
            except Exception as e:   # pragma: no cover - surfaced below
                errors.append(f"producer: {e!r}")
            finally:
                stop.set()

        pool.start_flusher()
        try:
            producer = threading.Thread(target=produce)
            producer.start()
            checked = 0
            t_rec = pool.tenant("t")
            while not stop.is_set() or checked == 0:
                with t_rec.lock:
                    w = t_rec.engine.solve(SIGMA)
                    n_extra = int(t_rec.engine.backend.count) - base_rows
                    assert t_rec.engine.pending_deltas == 0
                assert 0 <= n_extra <= self.N_DELTAS
                np.testing.assert_allclose(
                    w.numpy(), prefix_ref(n_extra).numpy(), rtol=5e-4,
                    atol=5e-4, err_msg=f"read at prefix {n_extra} not exact")
                checked += 1
                time.sleep(0.01)
            producer.join(timeout=10)
            assert not producer.is_alive()
        finally:
            pool.close()
        assert not errors, errors
        assert checked >= 1
        np.testing.assert_allclose(pool.solve("t", SIGMA).numpy(),
                                   prefix_ref(self.N_DELTAS).numpy(),
                                   rtol=5e-4, atol=5e-4)


@pytest.mark.usefixtures("no_flusher_leak")
def test_concurrent_producers_and_readers_lose_no_rows():
    """More threads than cores stream rows into one tenant, read it and let
    the flusher drain it, with a tiny switch interval: every row lands
    exactly once, and the final state is the cold solve over all of them."""
    import sys

    pool, (A0, b0) = _stress_pool()
    base = int(pool.get("t").count)
    n_threads, per = 12, 15
    rows = [[_solve_rows(5000 + k * per + i, 1) for i in range(per)]
            for k in range(n_threads)]
    errors: list[str] = []

    def work(k):
        try:
            for i, (dA, db) in enumerate(rows[k]):
                pool.ingest_rows_async("t", dA, db)
                if i % 4 == 0:
                    pool.solve("t", SIGMA)
        except Exception as e:   # pragma: no cover - surfaced below
            errors.append(repr(e))

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    pool.start_flusher(0.002)
    try:
        threads = [threading.Thread(target=work, args=(k,)) for k in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
            assert not t.is_alive()
    finally:
        sys.setswitchinterval(interval)
        pool.close()
    assert not errors, errors
    assert int(pool.get("t").count) == base + n_threads * per
    A = torch.cat([A0] + [a for rs in rows for a, _ in rs])
    b = torch.cat([b0] + [y for rs in rows for _, y in rs])
    np.testing.assert_allclose(
        pool.solve("t", SIGMA).numpy(),
        fusion.solve_ridge(tcore.compute_stats(A, b), SIGMA).numpy(),
        rtol=5e-4, atol=5e-4)


@pytest.mark.usefixtures("no_flusher_leak")
class TestStalenessBound:
    def test_background_flush_drains_without_reads(self):
        pool, _ = _stress_pool()
        pool.solve("t", SIGMA)
        pool.start_flusher()
        try:
            queued_at = time.monotonic()
            for i in range(6):
                pool.ingest_rows_async("t", *_solve_rows(200 + i, 1))
            deadline = queued_at + STALENESS + 3.0
            while pool.pending_deltas and time.monotonic() < deadline:
                time.sleep(STALENESS / 10)
            drained_at = time.monotonic()
            assert pool.pending_deltas == 0, \
                "background flusher never drained the queue"
            t = pool.tenant("t")
            assert t.background_flushes >= 1
            assert drained_at - queued_at <= STALENESS + 3.0
            assert t.max_flush_age_s >= 0.9 * STALENESS
            assert t.max_flush_age_s <= STALENESS + 3.0
            assert pool.summary()["flusher_alive"]
        finally:
            pool.close()

    def test_zero_staleness_policy_no_phantom_flushes(self):
        pool = EnginePool(default_coalesce=CoalescerPolicy(
            max_rank=10**6, max_staleness_s=0.0), device="cpu")
        pool.create_tenant("t", clients={0: tcore.compute_stats(
            *_solve_rows(0, 24))}, placement="dense")
        for _ in range(5):
            assert pool.flush_stale() == 0
        assert pool.tenant("t").background_flushes == 0
        pool.ingest_rows_async("t", *_solve_rows(1, 1))   # autoflushes at once
        assert pool.pending_deltas == 0
        assert pool.flush_stale() == 0
        assert pool.tenant("t").background_flushes == 0
        pool.close()

    def test_no_flush_before_staleness_when_rank_unbounded(self):
        pool, _ = _stress_pool()
        pool.solve("t", SIGMA)
        pool.ingest_rows_async("t", *_solve_rows(300, 1))
        assert pool.flush_stale() == 0
        assert pool.pending_deltas == 1
        time.sleep(STALENESS * 1.5)
        assert pool.flush_stale() == 1
        assert pool.pending_deltas == 0
        pool.close()


@pytest.mark.usefixtures("no_flusher_leak")
class TestShutdown:
    def test_close_joins_daemon(self):
        pool, _ = _stress_pool()
        thread = pool.start_flusher()
        assert thread.daemon and thread.is_alive()
        assert pool.flusher_alive
        pool.close()
        assert not pool.flusher_alive
        assert not thread.is_alive()

    def test_close_is_idempotent_and_restartable(self):
        pool, _ = _stress_pool()
        pool.close()
        pool.start_flusher()
        first = pool._flusher
        assert pool.start_flusher() is first
        pool.close()
        pool.close()
        pool.start_flusher()
        assert pool.flusher_alive
        pool.close()

    def test_context_manager_stops_flusher(self):
        pool, _ = _stress_pool()
        with pool:
            pool.start_flusher()
            assert pool.flusher_alive
        assert not pool.flusher_alive
