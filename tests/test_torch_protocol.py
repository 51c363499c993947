"""Port parity for fed/ (protocol, comm ledger) and data/, end to end.

``run_one_shot`` on data made by the reference's ``synthetic.generate``,
carried over through ``repro_torch.convert``, matches the reference's
weights, and its CommRecord matches field by field. The copied comm ledger
and its frame-length closed forms are held against ``repro.fed``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import fed as jfed
from repro.data import synthetic as jsyn
from repro.fed import wire as jwire
from repro_torch import fed as tfed
from repro_torch.convert import dataset_from_numpy, stats_from_numpy
from repro_torch.core import compute_stats
from repro_torch.data import synthetic as tsyn
from repro_torch.fed import comm as tcomm

RTOL, ATOL = 1e-5, 1e-5


def _datasets(num_clients=5, n=80, d=12, seed=0, gamma=0.5):
    dj = jsyn.generate(jax.random.PRNGKey(seed), num_clients=num_clients,
                       samples_per_client=n, dim=d, gamma=gamma)
    dt = dataset_from_numpy([(np.asarray(A), np.asarray(b)) for A, b in dj.clients],
                            dj.test_A, dj.test_b, dj.w_star, dj.gamma, device="cpu")
    return dj, dt


def _fields(record):
    return dataclasses.asdict(record)


class TestRunOneShot:
    @pytest.mark.parametrize("sigma", [0.01, 1.0])
    @pytest.mark.parametrize("participating", [None, [True, False, True, True, False]])
    def test_matches_jax(self, sigma, participating):
        dj, dt = _datasets()
        rj = jfed.run_one_shot(dj, sigma, participating=participating)
        rt = tfed.run_one_shot(dt, sigma, participating=participating)
        np.testing.assert_allclose(rt.weights.numpy(), np.asarray(rj.weights),
                                   rtol=RTOL, atol=ATOL)
        assert _fields(rt.comm) == _fields(rj.comm)
        assert rt.rounds == rj.rounds == 1
        assert rt.extras["participating_clients"] == rj.extras["participating_clients"]
        assert int(rt.extras["fused_stats"].count) == int(rj.extras["fused_stats"].count)

    def test_centralized_matches_and_equals_one_shot(self):
        dj, dt = _datasets(d=20)
        ct, cj = tfed.run_centralized(dt, 0.1), jfed.run_centralized(dj, 0.1)
        np.testing.assert_allclose(ct.weights.numpy(), np.asarray(cj.weights),
                                   rtol=RTOL, atol=ATOL)
        assert _fields(ct.comm) == _fields(cj.comm)
        # Thm 1 exactness inside the port
        np.testing.assert_allclose(tfed.run_one_shot(dt, 0.1).weights.numpy(),
                                   ct.weights.numpy(), rtol=1e-4, atol=1e-5)

    def test_loco_cv_matches_jax(self):
        dj, dt = _datasets(num_clients=4)
        sigmas = [0.01, 0.1, 1.0, 10.0]
        bt, rt = tfed.run_loco_cv(dt, sigmas)
        bj, rj = jfed.run_loco_cv(dj, sigmas)
        assert bt == bj
        assert _fields(rt.comm) == _fields(rj.comm)
        np.testing.assert_allclose(rt.extras["cv_losses"].numpy(),
                                   np.asarray(rj.extras["cv_losses"]), rtol=1e-4, atol=1e-6)

    def test_not_ported_options_raise(self):
        """mesh= and backend="auto" (item 15) run: the mesh fuses into a
        sharded engine with the cross-shard record, auto without a table
        stays dense; both give the dense weights."""
        from repro_torch.launch.mesh import make_cpu_mesh

        _, dt = _datasets(num_clients=2, n=20, d=4)
        dense = tfed.run_one_shot(dt, 0.1)
        res = tfed.run_one_shot(dt, 0.1, mesh=make_cpu_mesh(8))
        assert res.extras["engine"].backend.name == "sharded"
        assert res.comm.cross_shard_bytes > 0 and "fused_stats" not in res.extras
        auto = tfed.run_one_shot(dt, 0.1, backend="auto")
        assert auto.extras["engine"].backend.name == "dense"
        for r in (res, auto):
            np.testing.assert_allclose(r.weights.numpy(), dense.weights.numpy(),
                                       rtol=1e-5, atol=1e-6)

    def test_dp_and_psd_repair_run(self):
        """Algorithm 2 runs (noisy, finite, the count kept), and
        ``psd_repair=True`` is ``privacy.psd_repair`` of the fused stats."""
        from repro_torch.core import privacy, threefry

        _, dt = _datasets(num_clients=3, n=30, d=6)
        clean = tfed.run_one_shot(dt, 0.1)
        raw = tfed.run_one_shot(dt, 0.1, dp=(0.05, 1e-5), dp_key=threefry.key(1))
        rep = tfed.run_one_shot(dt, 0.1, dp=(0.05, 1e-5), dp_key=threefry.key(1),
                                psd_repair=True)
        noisy = raw.extras["fused_stats"]
        assert not torch.equal(noisy.gram, clean.extras["fused_stats"].gram)
        assert int(noisy.count) == 90 and noisy.yty is None
        assert torch.equal(rep.extras["fused_stats"].gram,
                           privacy.psd_repair(noisy).gram)
        assert torch.isfinite(rep.weights).all()
        assert _fields(rep.comm) == _fields(clean.comm)


class TestPackedStats:
    @pytest.mark.parametrize("d", [1, 5, 16])
    def test_pack_unpack_matches_jax(self, d):
        A = np.random.default_rng(d).standard_normal((3 * d, d)).astype(np.float32)
        b = A.sum(1)
        pt = tfed.PackedStats.pack(compute_stats(torch.from_numpy(A), torch.from_numpy(b)))
        pj = jfed.PackedStats.pack(jfed.protocol.compute_stats(jnp.asarray(A), jnp.asarray(b)))
        assert pt.wire_floats == pj.wire_floats == d * (d + 1) // 2 + d
        back = pt.unpack()
        np.testing.assert_array_equal(back.gram.numpy(), np.asarray(pj.unpack().gram))
        assert back.yty.dtype == back.gram.dtype

    def test_client_phase_reuses_stats(self):
        _, dt = _datasets(num_clients=3, n=20, d=6)
        stats = [compute_stats(A, b) for A, b in dt.clients]
        ups = tfed.client_phase(dt, client_stats=stats, participating=[True, False, True])
        assert sorted(ups) == [0, 2]
        assert torch.equal(ups[2].unpack().gram, stats[2].gram)


class TestCommLedger:
    @pytest.mark.parametrize("frame", ["tri", "proj", "rff"])
    @pytest.mark.parametrize("dtype", ["float32", "float64", "bfloat16"])
    @pytest.mark.parametrize("d", [1, 7, 100])
    def test_frame_lengths_match_wire_codec(self, frame, dtype, d):
        tri_t = torch.zeros(d * (d + 1) // 2, dtype=getattr(torch, dtype))
        payload_t = tfed.PackedStats(tri_t, torch.zeros(d), torch.tensor(1), d)
        tri_j = np.zeros(d * (d + 1) // 2, jnp.dtype(dtype))
        payload_j = jfed.PackedStats(tri_j, np.zeros(d), 1, d)
        assert tcomm._encoded_nbytes(payload_t, frame=frame) == \
            jwire.encoded_nbytes(payload_j, frame=frame)

    def test_measured_matches_jax_and_falls_back_for_f16(self):
        for dtype in ("float32", "float16"):
            pt = [tfed.PackedStats(torch.zeros(10, dtype=getattr(torch, dtype)),
                                   torch.zeros(4), torch.tensor(3), 4)] * 3
            pj = [jfed.PackedStats(np.zeros(10, dtype), np.zeros(4), 3, 4)] * 3
            assert _fields(tcomm.measured_one_shot(pt, 4)) == \
                _fields(jfed.measured_one_shot(pj, 4))

    def test_closed_forms_match(self):
        assert _fields(tcomm.one_shot_comm(30, 5)) == _fields(jfed.one_shot_comm(30, 5))
        assert _fields(tcomm.one_shot_comm(30, 5, projected_m=8)) == \
            _fields(jfed.one_shot_comm(30, 5, projected_m=8))
        assert _fields(tcomm.fedavg_comm(30, 5, 7)) == _fields(jfed.fedavg_comm(30, 5, 7))
        assert tcomm.crossover_rounds(30) == jfed.crossover_rounds(30)
        rec_t = tcomm.sharded_oneshot_record(30, 5, {"data": 4, "pod": 2})
        rec_j = jfed.sharded_oneshot_record(30, 5, {"data": 4, "pod": 2})
        assert _fields(rec_t) == _fields(rec_j)
        assert tcomm.aggregate_records({"a": rec_t}, kinds={"a": "dense"}) == \
            jfed.comm.aggregate_records({"a": rec_j}, kinds={"a": "dense"})
        assert tcomm.hierarchical_ingress(30, 10, 2) == \
            jfed.comm.hierarchical_ingress(30, 10, 2)


class TestSynthetic:
    def test_generate_shapes_and_determinism(self):
        a = tsyn.generate(3, num_clients=3, samples_per_client=40, dim=8, device="cpu")
        b = tsyn.generate(3, num_clients=3, samples_per_client=40, dim=8, device="cpu")
        assert a.num_clients == 3 and a.dim == 8 and a.test_A.shape == (24, 8)
        assert all(torch.equal(x, y) for (x, _), (y, _) in zip(a.clients, b.clients))
        A, bb = a.stacked()
        assert A.shape == (120, 8) and bb.shape == (120,)
        assert float(torch.linalg.norm(a.w_star)) == pytest.approx(1.0, rel=1e-6)

    def test_recovers_noise_floor(self):
        ds = tsyn.generate(0, num_clients=4, samples_per_client=500, dim=20,
                           effective_rank=10, device="cpu")
        w = tfed.run_one_shot(ds, 1e-3).weights
        mse = float(torch.mean((ds.test_A @ w - ds.test_b) ** 2))
        assert mse == pytest.approx(tsyn.NOISE_STD ** 2, rel=0.3)

    def test_stats_from_numpy(self):
        s = stats_from_numpy(np.eye(3), np.ones(3), 5, 2.0, dtype=torch.float32,
                             device="cpu")
        assert s.gram.dtype == s.moment.dtype == s.yty.dtype == torch.float32
        assert int(s.count) == 5 and s.count.dtype == torch.int32
