"""Port parity for the sharded backend (``server/distributed.py``).

Mirrors tests/test_sharded_backend.py on the port's (4, 2) CPU mesh (8
shards on the CPU, ``launch.mesh.make_cpu_mesh(8)``):

  * against the reference's own 8-device run: jax locks its device count
    at first init, so one child process per module runs the reference with
    ``--xla_force_host_platform_device_count=8`` on numpy inputs made here
    and writes its arrays to an npz; the port runs the same operations in
    process. The padded block Gram after fusing dense deltas and the layout
    (``padded``, ``block_size``, local rows / cols, the spec) are equal
    bitwise; solves, incremental up/downdates, drop/restore/streaming,
    ``fuse_distributed``, ``solve_batch`` and ``run_one_shot(mesh=)`` within
    the reference's RTOL = ATOL = 3e-4, CG within 1e-3 (as the reference);
  * against the reference in this process, where its mesh degrades to
    1 x 1: every in-process test of the reference's file, with the port on
    its (4, 2) mesh;
  * inside the port: a cached factor's solve repeats bitwise, every solve
    is held to a float64 solve of its own state, the card's sub-panel
    composition of kernel P (``composed_panel_transform``, here on the
    plain versions) equals ``panel_transform_ref`` over the whole tile, and
    ``convert.sharded_backend_from`` carries a reference backend's state.
"""
import os
import pathlib
import subprocess
import sys
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import core as jcore
from repro.core import fusion as jfusion
from repro.launch import mesh as jmesh_lib
from repro.server import FusionEngine as JEngine
from repro.server import ShardedBackend as JSharded
from repro_torch import convert
from repro_torch import core as tcore
from repro_torch import fed as tfed
from repro_torch.core import fusion
from repro_torch.fed import comm
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch.sharding import P, ShardedTensor
from repro_torch.server import FusionEngine, ShardedBackend
from repro_torch.server.cholesky import panel_transform_ref
from repro_torch.server.distributed import (composed_panel_transform,
                                            tile_transform)

RTOL, ATOL = 3e-4, 3e-4
LAYOUTS = ((3, 8), (16, None), (21, None), (21, 8), (100, None), (4096, None))

_CHILD = r"""
import sys
import jax, jax.numpy as jnp, numpy as np
from repro import core, fed
from repro.launch import mesh as mesh_lib
from repro.server import FusionEngine, ShardedBackend
from repro.data.synthetic import FederatedDataset

assert jax.device_count() == 8, jax.device_count()
mesh = mesh_lib.make_cpu_mesh(8)
assert dict(mesh.shape) == {"data": 4, "model": 2}
inp = dict(np.load(sys.argv[1]))
out = {}
A, b = jnp.asarray(inp["A"]), jnp.asarray(inp["b"])
d = A.shape[1]
stats = {i: core.compute_stats(A[i * 100:(i + 1) * 100], b[i * 100:(i + 1) * 100])
         for i in range(4)}
for i, s in stats.items():
    out[f"c{i}_gram"], out[f"c{i}_moment"] = np.asarray(s.gram), np.asarray(s.moment)
    out[f"c{i}_count"] = np.asarray(s.count)
be = ShardedBackend(d, mesh)
eng = FusionEngine.from_clients(stats, backend=be)
out["G_fused"] = np.asarray(be.gram)
out["w"] = np.asarray(eng.solve(0.1))
eng.drop(1); eng.drop(3)
out["w_drop"] = np.asarray(eng.solve(0.1))
eng.restore(1); eng.restore(3)
eng.ingest_rows(jnp.asarray(inp["eA"]), jnp.asarray(inp["eb"]))
out["w_stream"] = np.asarray(eng.solve(0.1))
eng4 = FusionEngine.from_stats(core.compute_stats(A, b),
                               backend=ShardedBackend(d, mesh), max_update_rank=64)
eng4.solve(0.1)
cold0 = eng4.cold_factorizations
for i in range(8):
    eng4.ingest_rows_async(jnp.asarray(inp["dA"][i]), jnp.asarray(inp["db"][i]))
out["w4"] = np.asarray(eng4.solve(0.1))
out["w4_counts"] = np.array([eng4.cold_factorizations - cold0,
                             eng4.incremental_updates, eng4.coalesced_deltas])
be2 = ShardedBackend(d, mesh)
eng2 = FusionEngine(d, backend=be2)
eng2.ingest_distributed(A[:256], b[:256], participation=jnp.array([1., 1., 0., 1.]))
out["w_dist"] = np.asarray(eng2.solve(0.1))
out["dist_count"] = np.asarray(eng2.count)
out["G_dist"] = np.asarray(be2.gram)
eng3 = FusionEngine.from_stats(core.compute_stats(A, b),
                               backend=ShardedBackend(d, mesh, method="cg"))
out["w_cg"] = np.asarray(eng3.solve(0.1))
out["ws_batch"] = np.asarray(FusionEngine.from_stats(
    core.compute_stats(A, b), backend=ShardedBackend(d, mesh)
).solve_batch([0.05, 0.5, 5.0]))
for dim, bsz in %(layouts)s:
    bb = ShardedBackend(dim, mesh, block_size=bsz)
    out[f"layout_{dim}_{bsz}"] = np.array([bb.padded, bb.block_size, bb._rl,
                                           bb._cl, bb._nb])
    out[f"spec_{dim}_{bsz}"] = np.array(repr(tuple(bb.spec)))
    out[f"method_{dim}_{bsz}"] = np.array(bb._resolve_method())
ds = FederatedDataset(
    clients=tuple((jnp.asarray(inp[f"ds_A{k}"]), jnp.asarray(inp[f"ds_b{k}"]))
                  for k in range(4)),
    test_A=jnp.asarray(inp["ds_tA"]), test_b=jnp.asarray(inp["ds_tb"]),
    w_star=jnp.asarray(inp["ds_w"]), gamma=0.5)
res = fed.run_one_shot(ds, 0.1, mesh=mesh)
out["ros_w"] = np.asarray(res.weights)
out["ros_psum"] = np.array(repr(res.comm.psum_floats_per_axis))
out["ros_cross"] = np.array(res.comm.cross_shard_bytes)
np.savez(sys.argv[2], **out)
print("CHILD-OK")
"""


def _inputs(seed=0):
    rng = np.random.default_rng(seed)

    def f(*s):
        return rng.standard_normal(s).astype(np.float32)

    out = dict(A=f(400, 100), b=f(400), eA=f(64, 100), eb=f(64),
               dA=f(8, 2, 100), db=f(8, 2), ds_tA=f(32, 32), ds_tb=f(32),
               ds_w=f(32))
    for k in range(4):
        out[f"ds_A{k}"], out[f"ds_b{k}"] = f(64, 32), f(64)
    return out


@pytest.fixture(scope="module")
def ref8(tmp_path_factory):
    """The reference's arrays from its 8-device (4, 2) run, and the inputs."""
    tmp = tmp_path_factory.mktemp("sharded8")
    inp = _inputs()
    np.savez(tmp / "in.npz", **inp)
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = str(pathlib.Path(__file__).resolve().parents[1] / "src")
    run = subprocess.run(
        [sys.executable, "-c", _CHILD % {"layouts": repr(LAYOUTS)},
         str(tmp / "in.npz"), str(tmp / "out.npz")],
        env=env, capture_output=True, text=True, timeout=600)
    assert "CHILD-OK" in run.stdout, run.stdout + run.stderr
    return inp, dict(np.load(tmp / "out.npz"))


@pytest.fixture(scope="module")
def mesh():
    return mesh_lib.make_cpu_mesh(8)


@pytest.fixture(scope="module")
def jmesh():
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")     # one host device: degrades to 1x1
        return jmesh_lib.make_cpu_mesh(8)


def _t(x):
    return torch.from_numpy(np.asarray(x).copy())


def _stats(x):
    return convert.suffstats_from(x, device="cpu")


def _f64_solve(stats, sigma):
    G = stats.gram.double()
    return torch.linalg.solve(G + sigma * torch.eye(G.shape[0], dtype=G.dtype),
                              stats.moment.double())


def _close(a, b, tol=RTOL):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=tol, atol=tol)


# ---------------------------------------------------------------------------
# Against the reference's 8-device run (child process).
# ---------------------------------------------------------------------------

class TestAgainstEightDevices:
    @pytest.mark.parametrize("dim,bs", LAYOUTS)
    def test_layout_pins(self, ref8, mesh, dim, bs):
        _, out = ref8
        be = ShardedBackend(dim, mesh, block_size=bs)
        got = [be.padded, be.block_size, be._rl, be._cl, be._nb]
        assert got == out[f"layout_{dim}_{bs}"].tolist()
        assert repr(tuple(be.spec)) == str(out[f"spec_{dim}_{bs}"])
        assert be._resolve_method() == str(out[f"method_{dim}_{bs}"])

    def _engine(self, ref8, mesh, **kw):
        _, out = ref8
        stats = {i: convert.stats_from_numpy(out[f"c{i}_gram"], out[f"c{i}_moment"],
                                             out[f"c{i}_count"], device="cpu")
                 for i in range(4)}
        be = ShardedBackend(100, mesh)
        return FusionEngine.from_clients(stats, backend=be, **kw), be

    def test_fused_block_gram_bitwise(self, ref8, mesh):
        """Fusing the reference's client statistics as dense deltas gives
        the reference's padded block Gram bit for bit, in its layout."""
        _, out = ref8
        eng, be = self._engine(ref8, mesh)
        assert be.gram.spec == P("data", "model")
        assert len(be.gram.blocks) == 8
        assert all(tuple(b.shape) == (32, 64) for b in be.gram.blocks.values())
        np.testing.assert_array_equal(be.gram.full().numpy(), out["G_fused"])
        assert eng.count == 400

    def test_solve_drop_restore_stream(self, ref8, mesh):
        inp, out = ref8
        eng, be = self._engine(ref8, mesh)
        _close(eng.solve(0.1), out["w"])
        fac = eng._factors[0.1].factor
        assert fac.L.spec == P("data", "model") and len(fac.L.blocks) == 8
        eng.drop(1)
        eng.drop(3)
        _close(eng.solve(0.1), out["w_drop"])
        eng.restore(1)
        eng.restore(3)
        eng.ingest_rows(_t(inp["eA"]), _t(inp["eb"]))
        _close(eng.solve(0.1), out["w_stream"])
        assert be.gram.spec == P("data", "model")

    def test_coalesced_low_rank_update(self, ref8, mesh):
        inp, out = ref8
        eng = FusionEngine.from_stats(
            tcore.compute_stats(_t(inp["A"]), _t(inp["b"])),
            backend=ShardedBackend(100, mesh), max_update_rank=64)
        eng.solve(0.1)
        cold0 = eng.cold_factorizations
        for i in range(8):
            eng.ingest_rows_async(_t(inp["dA"][i]), _t(inp["db"][i]))
        _close(eng.solve(0.1), out["w4"])
        assert [eng.cold_factorizations - cold0, eng.incremental_updates,
                eng.coalesced_deltas] == out["w4_counts"].tolist() == [0, 1, 8]
        assert eng.backend.update_buckets == {(16, True): 1}

    def test_fuse_distributed(self, ref8, mesh):
        inp, out = ref8
        be = ShardedBackend(100, mesh)
        eng = FusionEngine(100, backend=be, device="cpu")
        eng.ingest_distributed(_t(inp["A"][:256]), _t(inp["b"][:256]),
                               participation=[1.0, 1.0, 0.0, 1.0])
        _close(eng.solve(0.1), out["w_dist"])
        assert eng.count == int(out["dist_count"]) == 192
        assert be.count.dtype == torch.int32
        G = be.gram.full().numpy()
        np.testing.assert_allclose(G, out["G_dist"], rtol=1e-5, atol=1e-4)

    def test_cg_and_solve_batch(self, ref8, mesh):
        inp, out = ref8
        stats = tcore.compute_stats(_t(inp["A"]), _t(inp["b"]))
        eng = FusionEngine.from_stats(stats, backend=ShardedBackend(100, mesh,
                                                                    method="cg"))
        _close(eng.solve(0.1), out["w_cg"], tol=1e-3)
        ws = FusionEngine.from_stats(stats, backend=ShardedBackend(100, mesh)
                                     ).solve_batch([0.05, 0.5, 5.0])
        _close(ws, out["ws_batch"])

    def test_run_one_shot_on_the_mesh(self, ref8, mesh):
        inp, out = ref8
        ds = convert.dataset_from_numpy(
            [(inp[f"ds_A{k}"], inp[f"ds_b{k}"]) for k in range(4)],
            inp["ds_tA"], inp["ds_tb"], inp["ds_w"], 0.5, device="cpu")
        res = tfed.run_one_shot(ds, 0.1, mesh=mesh)
        _close(res.weights, out["ros_w"])
        assert isinstance(res.comm, comm.ShardedCommRecord)
        assert repr(res.comm.psum_floats_per_axis) == str(out["ros_psum"])
        assert res.comm.cross_shard_bytes == int(out["ros_cross"]) > 0
        assert "fused_stats" not in res.extras
        assert res.extras["engine"].summary()["backend"] == "sharded"


# ---------------------------------------------------------------------------
# tests/test_sharded_backend.py's in-process tests: the reference on its
# degraded 1 x 1 mesh, the port on its (4, 2) mesh.
# ---------------------------------------------------------------------------

def _problem(seed=0, n=200, d=21):
    k1, k2 = jax.random.split(jax.random.PRNGKey(seed))
    A = jax.random.normal(k1, (n, d))
    b = jax.random.normal(k2, (n,))
    return A, b, jcore.compute_stats(A, b)


def _port(A, b):
    return _t(A), _t(b)


class TestShardedSolves:
    def test_block_chol_matches_reference_with_padding(self, mesh, jmesh):
        _, _, stats = _problem(d=21)
        be = ShardedBackend(21, mesh, block_size=8)
        assert be.padded % 8 == 0 and be.padded >= 21
        eng = FusionEngine.from_stats(_stats(stats), backend=be)
        jeng = JEngine.from_stats(stats, backend=JSharded(21, jmesh, block_size=8))
        for sigma in (1e-2, 0.5, 10.0):
            w = eng.solve(sigma)
            _close(w, jfusion.solve_ridge(stats, sigma))
            _close(w, jeng.solve(sigma))
            # the second call hits the cached sharded factor: identical
            assert torch.equal(eng.solve(sigma), eng.solve(sigma))

    def test_solve_batch_warms_sharded_cache(self, mesh, jmesh):
        _, _, stats = _problem()
        eng = FusionEngine.from_stats(_stats(stats), backend=ShardedBackend(21, mesh))
        sigmas = [0.05, 0.5, 5.0]
        ws = eng.solve_batch(sigmas)
        assert tuple(ws.shape) == (3, 21)
        assert sorted(eng._factors) == sorted(sigmas)
        jws = JEngine.from_stats(stats, backend=JSharded(21, jmesh)).solve_batch(sigmas)
        for i, s in enumerate(sigmas):
            _close(ws[i], jfusion.solve_ridge(stats, s))
            _close(ws[i], jws[i])

    def test_cg_fallback_matches_reference(self, mesh, jmesh):
        _, _, stats = _problem()
        eng = FusionEngine.from_stats(_stats(stats),
                                      backend=ShardedBackend(21, mesh, method="cg"))
        jeng = JEngine.from_stats(stats, backend=JSharded(21, jmesh, method="cg"))
        _close(eng.solve(0.1), jfusion.solve_ridge(stats, 0.1), tol=1e-3)
        _close(eng.solve(0.1), jeng.solve(0.1), tol=1e-3)

    def test_auto_prefers_cg_when_padding_explodes(self, mesh, jmesh):
        be = ShardedBackend(3, mesh, block_size=8)
        assert be.padded == 32 and be._resolve_method() == "cg"
        jbe = JSharded(3, jmesh, block_size=8)
        if jbe.padded >= 2 * 3:
            assert jbe._resolve_method() == "cg"

    def test_pallas_tile_path_matches(self, mesh, jmesh):
        """The reference's Pallas tile route (TRSM as a GEMM against the
        inverted tile, SYRK on K2) is the port's only route."""
        _, _, stats = _problem(d=16)
        eng = FusionEngine.from_stats(_stats(stats),
                                      backend=ShardedBackend(16, mesh, block_size=8))
        jeng = JEngine.from_stats(stats, backend=JSharded(16, jmesh, block_size=8,
                                                          use_pallas=True))
        _close(eng.solve(0.2), jfusion.solve_ridge(stats, 0.2))
        _close(eng.solve(0.2), jeng.solve(0.2))

    def test_sigma_zero_rejected(self, mesh):
        _, _, stats = _problem()
        eng = FusionEngine.from_stats(_stats(stats), backend=ShardedBackend(21, mesh))
        with pytest.raises(ValueError, match="sigma > 0"):
            eng.solve(0.0)


class TestShardedIncrementalUpdate:
    def test_low_rank_mutation_skips_refactorization(self, mesh):
        A, b, stats = _problem(n=200, d=21)
        eng = FusionEngine.from_stats(
            _stats(stats), backend=ShardedBackend(21, mesh, block_size=8),
            max_update_rank=40)
        eng.solve(0.1)
        cold0 = eng.cold_factorizations
        eA, eb, _ = _problem(seed=5, n=6)
        eng.ingest_rows(*_port(eA, eb))      # rank 6 <= 40: incremental
        assert eng.cold_factorizations == cold0, "mutation refactorized"
        assert eng.incremental_updates == 1
        ref = jfusion.solve_ridge(jcore.compute_stats(
            jnp.concatenate([A, eA]), jnp.concatenate([b, eb])), 0.1)
        _close(eng.solve(0.1), ref)

    def test_incremental_downdate_on_drop(self, mesh):
        A, b, _ = _problem(n=240)
        stats = {i: jcore.compute_stats(A[i * 60:(i + 1) * 60], b[i * 60:(i + 1) * 60])
                 for i in range(4)}
        eng = FusionEngine.from_clients(
            {i: _stats(s) for i, s in stats.items()},
            backend=ShardedBackend(21, mesh, block_size=8), max_update_rank=100)
        eng.solve(0.1)
        cold0 = eng.cold_factorizations
        eng.drop(1)                          # rank(G_1) = 21 <= 100
        w = eng.solve(0.1)
        assert eng.cold_factorizations == cold0
        assert eng.backend.update_buckets == {(32, False): 1}
        w_ref = jfusion.dropout_fusion(list(stats.values()),
                                       [True, False, True, True], 0.1)
        _close(w, w_ref)

    def test_update_ranks_bucket_compiled_programs(self, mesh):
        """Flush ranks 5, 6 and 8 all run at the rank bucket 8 (zero-row
        rank padding is exact)."""
        A, b, stats = _problem(n=200, d=21)
        be = ShardedBackend(21, mesh, block_size=8)
        eng = FusionEngine.from_stats(_stats(stats), backend=be, max_update_rank=40)
        eng.solve(0.1)
        rows = []
        for i, r in enumerate((5, 6, 8)):
            eA, eb, _ = _problem(seed=20 + i, n=r)
            eng.ingest_rows(*_port(eA, eb))
            rows.append((eA, eb))
        assert list(be.update_buckets) == [(8, True)]
        assert be.update_buckets[(8, True)] == 3
        A_all = jnp.concatenate([A] + [a for a, _ in rows])
        b_all = jnp.concatenate([b] + [bb for _, bb in rows])
        _close(eng.solve(0.1), jfusion.solve_ridge(jcore.compute_stats(A_all, b_all), 0.1))

    def test_high_rank_mutation_still_evicts(self, mesh):
        _, _, stats = _problem(n=200, d=21)
        eng = FusionEngine.from_stats(
            _stats(stats), backend=ShardedBackend(21, mesh, block_size=8),
            max_update_rank=4)
        eng.solve(0.1)
        cold0 = eng.cold_factorizations
        eA, eb, _ = _problem(seed=6, n=30)
        eng.ingest_rows(*_port(eA, eb))      # rank 30 > 4: evict
        eng.solve(0.1)
        assert eng.cold_factorizations == cold0 + 1
        assert eng.incremental_updates == 0

    def test_cg_factor_declines_update(self, mesh):
        A, b, stats = _problem()
        be = ShardedBackend(21, mesh, method="cg")
        eng = FusionEngine.from_stats(_stats(stats), backend=be, max_update_rank=40)
        eng.solve(0.1)
        eA, eb, _ = _problem(seed=8, n=4)
        eng.ingest_rows(*_port(eA, eb))      # the CG marker: evicted, re-solved
        assert eng.incremental_updates == 0
        ref = jfusion.solve_ridge(jcore.compute_stats(
            jnp.concatenate([A, eA]), jnp.concatenate([b, eb])), 0.1)
        _close(eng.solve(0.1), ref, tol=1e-3)


class TestShardedEngineIntegration:
    def test_drop_restore_streaming(self, mesh, jmesh):
        A, b, _ = _problem(n=240)
        stats = {i: jcore.compute_stats(A[i * 60:(i + 1) * 60], b[i * 60:(i + 1) * 60])
                 for i in range(4)}
        eng = FusionEngine.from_clients({i: _stats(s) for i, s in stats.items()},
                                        backend=ShardedBackend(21, mesh))
        jeng = JEngine.from_clients(stats, backend=JSharded(21, jmesh))
        eng.solve(0.1)
        jeng.solve(0.1)
        eng.drop(2)
        jeng.drop(2)
        w_ref = jfusion.dropout_fusion(list(stats.values()),
                                       [True, True, False, True], 0.1)
        _close(eng.solve(0.1), w_ref)
        _close(eng.solve(0.1), jeng.solve(0.1))
        eng.restore(2)
        extra_A, extra_b, _ = _problem(seed=7, n=40)
        eng.ingest_rows(*_port(extra_A, extra_b))
        ref = jfusion.solve_ridge(jcore.compute_stats(
            jnp.concatenate([A, extra_A]), jnp.concatenate([b, extra_b])), 0.1)
        _close(eng.solve(0.1), ref)
        assert eng.count == 280

    def test_spectral_falls_back_to_chol(self, mesh):
        _, _, stats = _problem()
        eng = FusionEngine.from_stats(_stats(stats), backend=ShardedBackend(21, mesh))
        ws = eng.solve_batch([0.1, 1.0], method="spectral")
        _close(ws[0], jfusion.solve_ridge(stats, 0.1))
        assert eng.summary()["spectral_cached"] is False

    def test_summary_names_backend(self, mesh):
        _, _, stats = _problem()
        eng = FusionEngine.from_stats(_stats(stats), backend=ShardedBackend(21, mesh))
        assert eng.summary()["backend"] == "sharded"
        assert FusionEngine.from_stats(_stats(stats)).summary()["backend"] == "dense"
        assert eng.inference(0.1) is None       # no dense operands, no yty
        eng.solve(0.1)
        assert eng.resident_bytes == (eng.backend.state_bytes
                                      + eng._factors[0.1].factor.nbytes)


class TestShardedCommAndGuards:
    def test_backend_reports_row_axes_only(self, mesh, jmesh):
        be = ShardedBackend(16, mesh)
        assert be.fusion_axis_sizes == {"data": 4}
        assert "model" not in JSharded(16, jmesh).fusion_axis_sizes

    def test_from_clients_rejects_populated_backend(self, mesh):
        _, _, stats = _problem()
        be = ShardedBackend(21, mesh)
        FusionEngine.from_clients({0: _stats(stats)}, backend=be)
        with pytest.raises(ValueError, match="already holds"):
            FusionEngine.from_clients({0: _stats(stats)}, backend=be)

    def test_dtype_mismatch_is_loud(self, mesh):
        be = ShardedBackend(4, mesh)  # float32
        with pytest.raises(ValueError, match="dtype"):
            FusionEngine(4, dtype=torch.bfloat16, backend=be)

    def test_sharded_run_omits_eager_dense_stats(self, mesh, jmesh):
        from repro import data as jdata
        from repro import fed as jfed

        jds = jdata.generate(jax.random.PRNGKey(0), num_clients=3,
                             samples_per_client=30, dim=8)
        ds = convert.dataset_from_numpy(jds.clients, jds.test_A, jds.test_b,
                                        jds.w_star, jds.gamma, device="cpu")
        res = tfed.run_one_shot(ds, 0.1, mesh=mesh)
        assert "fused_stats" not in res.extras
        assert isinstance(res.comm, comm.ShardedCommRecord)
        dense = tfed.run_one_shot(ds, 0.1)
        assert "fused_stats" in dense.extras
        _close(res.weights, dense.weights)
        jres = jfed.run_one_shot(jds, 0.1, mesh=jmesh)
        _close(res.weights, jres.weights)
        auto = tfed.run_one_shot(ds, 0.1, backend="auto", mesh=mesh)
        assert auto.extras["engine"].backend.name == "dense"   # no table


# ---------------------------------------------------------------------------
# Inside the port.
# ---------------------------------------------------------------------------

class TestPortContracts:
    @pytest.mark.parametrize("dim,bs", LAYOUTS)
    def test_layout_on_one_shard_matches_reference_in_process(self, jmesh, dim, bs):
        """On a mesh of the in-process reference mesh's shape (1 x 1 on one
        host device; wider where an earlier module in this process set the
        host device count)."""
        be = ShardedBackend(dim, convert.mesh_from(jmesh, device="cpu"),
                            block_size=bs)
        jbe = JSharded(dim, jmesh, block_size=bs)
        assert (be.padded, be.block_size, be._rl, be._cl) == \
            (jbe.padded, jbe.block_size, jbe._rl, jbe._cl)
        assert tuple(be.spec) == tuple(jbe.spec)

    @pytest.mark.parametrize("method", ["block_chol", "cg"])
    @pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
    def test_every_solve_held_to_float64_of_its_state(self, mesh, method, dtype):
        A, b, _ = _problem(n=300, d=37)
        A, b = _port(A, b)
        eng = FusionEngine.from_stats(
            tcore.compute_stats(A.to(dtype), b.to(dtype)),
            backend=ShardedBackend(37, mesh, dtype=dtype, method=method),
            max_update_rank=16)
        # CG stops at a relative residual of cg_tol (1e-6) times kappa
        tol = 1e-4 if method == "cg" else 1e-5 if dtype == torch.float32 else 1e-11
        for sigma in (0.01, 1.0):
            w = eng.solve(sigma)
            ref = _f64_solve(eng.stats, sigma)
            assert float((w.double() - ref).abs().max() / ref.abs().max()) <= tol
            assert torch.equal(w, eng.solve(sigma))   # cached: bitwise again
        eng.ingest_rows(A[:5].to(dtype), b[:5].to(dtype))
        w = eng.solve(0.01)
        ref = _f64_solve(eng.stats, 0.01)
        assert float((w.double() - ref).abs().max() / ref.abs().max()) <= tol

    @pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-6),
                                           (torch.float64, 1e-14)])
    def test_updated_factor_is_the_factor_of_its_gram(self, mesh, dtype, tol):
        """The factor that streamed rows, a drop and a restore leave behind,
        held itself (not a solve off it): tril(L) tril(L)^T equals the live
        padded G + sigma I."""
        A, b, _ = _problem(n=320, d=50)
        A, b = _port(A, b)
        A, b = A.to(dtype), b.to(dtype)
        eng = FusionEngine.from_clients(
            {k: tcore.compute_stats(A[k * 80:(k + 1) * 80], b[k * 80:(k + 1) * 80])
             for k in range(4)},
            backend=ShardedBackend(50, mesh, dtype=dtype, block_size=8),
            max_update_rank=200)
        sigma = 0.1

        def residual():
            L = torch.tril(eng.factor(sigma).L.full()).double()
            Gs = eng.backend.gram.full().double()
            Gs = Gs + sigma * torch.eye(Gs.shape[0], dtype=Gs.dtype)
            return float(torch.linalg.norm(L @ L.T - Gs) / torch.linalg.norm(Gs))

        assert residual() <= tol
        cold0 = eng.cold_factorizations
        eng.ingest_rows(A[:7], b[:7], client_id=9)
        assert residual() <= tol
        eng.drop(2)
        assert residual() <= tol
        eng.restore(2)
        assert residual() <= tol
        assert eng.cold_factorizations == cold0 and eng.incremental_updates == 3

    @pytest.mark.parametrize("dim,bs", [(50, 8), (100, None), (300, 32)])
    def test_factor_skips_blocks_above_the_diagonal(self, mesh, monkeypatch,
                                                    dim, bs):
        """A cold factor's K2 calls: a SYRK on each shard holding rows and
        columns at or below the panel and not wholly above the diagonal, a
        TRSM for every panel but the last."""
        from repro_torch.server import distributed

        be = ShardedBackend(dim, mesh, block_size=bs)
        calls = []
        real = distributed.kernel_ops.gemm_nt
        monkeypatch.setattr(distributed.kernel_ops, "gemm_nt",
                            lambda *a, **kw: calls.append(1) or real(*a, **kw))
        A, b = _port(*_problem(n=4 * dim, d=dim)[:2])
        be.fuse(tcore.compute_stats(A, b))
        f = be.factor(0.1)
        rl, cl, w = be._rl, be._cl, be.block_size
        syrk = sum(1 for k in range(be._nb) for ri in range(be._nrows)
                   for ci in range(be._ncols)
                   if (ri + 1) * rl > k * w and (ci + 1) * cl > k * w
                   and (ri + 1) * rl > ci * cl)
        assert len(calls) == syrk + be._nb - 1
        G = be.gram.full().double()
        L = f.L.full().double()
        eye = torch.eye(G.shape[0], dtype=G.dtype)
        assert float(torch.linalg.norm(L @ L.T - G - 0.1 * eye)
                     / torch.linalg.norm(G)) <= 1e-6

    @pytest.mark.parametrize("bs,r", [(64, 1), (64, 8), (128, 16), (96, 40)])
    @pytest.mark.parametrize("sign", [1.0, -1.0])
    def test_composed_panel_transform_matches_plain(self, bs, r, sign):
        """The card's tile transform: 32-wide sub-panels, K2's panel entry
        inside the tile, the embedded transforms multiplied (here on the
        plain versions), against the plain loop over the whole tile."""
        rng = np.random.default_rng(bs + r)
        W = rng.standard_normal((bs, 3 * bs))
        L = torch.from_numpy(np.linalg.cholesky(W @ W.T / bs + 4 * np.eye(bs)))
        # a downdate keeps L L^T - X^T X positive definite: ||X||^2 < 4
        X = torch.from_numpy(rng.standard_normal((r, bs)) * (0.05 if sign < 0 else 1))
        La, Ta = composed_panel_transform(L, X, sign=sign)
        Lb, Tb = panel_transform_ref(L, X, sign=sign)
        np.testing.assert_allclose(torch.tril(La).numpy(), torch.tril(Lb).numpy(),
                                   rtol=1e-10, atol=1e-10)
        np.testing.assert_allclose(Ta.numpy(), Tb.numpy(), rtol=1e-10, atol=1e-10)
        La32, Ta32 = composed_panel_transform(L.float(), X.float(), sign=sign)
        assert float((Ta32.double() - Tb).abs().max()) <= 1e-4 * float(Tb.abs().max())

    def test_cpu_tile_transform_is_the_reference_loop(self):
        rng = np.random.default_rng(3)
        W = rng.standard_normal((16, 40)).astype(np.float32)
        L = torch.linalg.cholesky(torch.from_numpy(W @ W.T + 4 * np.eye(16, dtype=np.float32)))
        X = torch.from_numpy(rng.standard_normal((4, 16)).astype(np.float32))
        a, Ta = tile_transform(L, X, sign=1.0)
        b, Tb = panel_transform_ref(L, X, sign=1.0)
        assert torch.equal(a, b) and torch.equal(Ta, Tb)

    def test_sharded_backend_from(self, mesh, jmesh):
        _, _, stats = _problem(d=21)
        jbe = JSharded(21, jmesh, block_size=8)
        JEngine.from_stats(stats, backend=jbe)
        be = convert.sharded_backend_from(jbe, device="cpu")
        assert be.mesh.shape == dict(jmesh.shape)
        assert (be.padded, be.block_size, be.method) == (jbe.padded, 8, jbe.method)
        s, js = be.stats(), jbe.stats()
        np.testing.assert_array_equal(s.gram.numpy(), np.asarray(js.gram))
        np.testing.assert_array_equal(s.moment.numpy(), np.asarray(js.moment))
        assert int(s.count) == int(js.count)
        onto = convert.sharded_backend_from(jbe, mesh)
        assert onto.mesh is mesh and onto._rl == onto.padded // 4
        np.testing.assert_array_equal(onto.stats().gram.numpy(), np.asarray(js.gram))
        eng = FusionEngine.from_stats(onto.stats(), backend=ShardedBackend(21, mesh))
        _close(eng.solve(0.1), jfusion.solve_ridge(stats, 0.1))

    def test_auto_backend_and_from_clients_auto(self, mesh):
        _, _, stats = _problem(d=21)
        eng = FusionEngine.from_clients([_stats(stats)], backend="auto", mesh=mesh,
                                        threshold=16)
        assert eng.backend.name == "sharded"
        eng = FusionEngine.from_clients([_stats(stats)], backend="auto", mesh=mesh)
        assert eng.backend.name == "dense"
        with pytest.raises(ValueError, match="backend='auto'"):
            FusionEngine(21, backend="auto", device="cpu")

    def test_gram_blocks_live_on_their_shards(self):
        devices = np.array([[torch.device("cpu"), torch.device("meta")]] * 2,
                           dtype=object)
        m = mesh_lib.Mesh(devices, ("data", "model"))
        be = ShardedBackend(8, m, block_size=4)
        assert be.gram.blocks[(0, 0)].device.type == "cpu"
        assert be.gram.blocks[(1, 1)].device.type == "meta"
        assert isinstance(be.gram, ShardedTensor)
