"""The port's transport and the pool's wire half against the JAX package's.

Mirrors the loopback and in-process TCP halves of tests/test_wire_e2e.py
on ``repro_torch.fed.transport`` with a port pool on the CPU, and holds the
port to the reference where the two meet:

  * **Pool wire ledger**: the same encoded frames, sent through each
    package's dispatcher, give equal reply bytes (ACKs and HELLOs), equal
    ``ledger()``, ``summary()`` and dispatcher counters, and bitwise-equal
    fused ``(G, h)``; weights agree within tests/test_torch_pool.py's 1e-5.
  * **Dedup**: a byte-identical re-send is answered duplicate=True and
    fuses once; CRC32 collisions that the reference's key
    ``(client_id, type byte, length, crc)`` tells apart are fused, and the
    one it cannot tell apart (same client, type and length) is treated as
    the reference treats it.
  * **TCP**: STATS frames over sockets fuse to the bits of an in-process
    admission of the same statistics, and the two packages interoperate: a
    reference ``FrameClient`` against a port ``FrameServer`` and a port
    client against a reference server both leave bitwise-equal fused stats.

The subprocess half of tests/test_wire_e2e.py (``launch/client.py`` and
``serve --listen`` as processes) is in tests/test_torch_serve_wire.py.
"""
import logging
import struct
import threading
import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import core as jcore
from repro import server as jserver
from repro.fed import transport as jtransport
from repro.fed import wire as jwire
from repro.core.features import FeatureMap as JFeatureMap
from repro.fed.protocol import PackedStats as JPackedStats
from repro_torch.core import fusion, projection, rff, threefry
from repro_torch.core.features import FeatureMap
from repro_torch.core.sufficient_stats import SuffStats, compute_stats
from repro_torch.fed import transport, wire
from repro_torch.fed.protocol import PackedStats
from repro_torch.server import EnginePool, SolveBatcher

SIGMA = 0.1
D = 16
RTOL = ATOL = 1e-5


def _rows(seed, n=64, d=D):
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((n, d)).astype(np.float32)
    w = rng.standard_normal(d).astype(np.float32)
    b = (A @ w + 0.1 * rng.standard_normal(n)).astype(np.float32)
    return A, b


def _int_rows(seed, n, d):
    """Small-integer rows: their statistics are exact in float32 whoever
    computes them, so both packages' fused sums stay bitwise comparable."""
    rng = np.random.default_rng(seed)
    return (rng.integers(-3, 4, (n, d)).astype(np.float32),
            rng.integers(-3, 4, (n,)).astype(np.float32))


def _stats(A, b):
    return compute_stats(torch.from_numpy(A), torch.from_numpy(b))


def _jstats(A, b):
    return jcore.compute_stats(jnp.asarray(A), jnp.asarray(b))


def _pool(**kw):
    return EnginePool(device="cpu", **kw)


def _loopback_client(dispatcher, tenant, offers=("f32",), mod=transport):
    c = mod.FrameClient(mod.LoopbackChannel(dispatcher))
    c.hello(tenant, offers)
    return c


def _bf16_quantized(stats):
    p = PackedStats.pack(stats)
    return PackedStats(p.tri.to(torch.bfloat16).float(),
                       p.moment.to(torch.bfloat16).float(), p.count,
                       p.dim).unpack()


def _f64_solve(stats, sigma=SIGMA):
    G = stats.gram.double()
    return torch.linalg.solve(G + sigma * torch.eye(G.shape[0],
                                                    dtype=torch.float64),
                              stats.moment.double())


def _sum(stats):
    out = stats[0]
    for s in stats[1:]:
        out = out + s
    return out


def _bits_equal(a, b):
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    b = b.numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    assert a.tobytes() == b.tobytes()


class TestLoopbackFederation:
    def test_mixed_dtype_clients_recover_centralized(self):
        data = [_rows(i) for i in range(3)]
        with _pool() as pool:
            disp = transport.WireDispatcher(pool)
            offers = [("f32",), ("f64", "f32"), ("bf16",)]
            clients = []
            for i, (A, b) in enumerate(data):
                c = _loopback_client(disp, "ridge", offers[i])
                c.upload_stats(_stats(A, b), client_id=f"c{i}")
                clients.append(c)
            # A float32 pool negotiates f64-capable clients down to f32.
            assert [c.dtype for c in clients] == ["f32", "f32", "bf16"]
            w = clients[0].solve(SIGMA)

            stats = [_stats(A, b) for A, b in data]
            stats[2] = _bf16_quantized(stats[2])
            ref = fusion.solve_ridge(_sum(stats), SIGMA)
            np.testing.assert_allclose(w, ref.numpy(), rtol=RTOL, atol=ATOL)

            led = pool.ledger()
            sent = sum(c.bytes_uploaded for c in clients)
            assert led["wire_upload_bytes"] == sent
            floats = D * (D + 1) // 2 + D
            for c, dt in zip(clients, ("f32", "f32", "bf16")):
                assert c.bytes_uploaded >= floats * wire.wire_itemsize(dt)
            assert sent == sum(
                wire.stats_frame_nbytes(D, dt, client_id=f"c{i}")
                for i, dt in enumerate(("f32", "f32", "bf16")))

    def test_float64_pool_negotiates_and_fuses_f64(self):
        """A float64 pool prefers f64 (the reference's x64 mode): f64 frames
        fuse unrounded, f32 and bf16 ones widen exactly."""
        data = [_rows(10 + i) for i in range(3)]
        with _pool(dtype=torch.float64) as pool:
            disp = transport.WireDispatcher(pool)
            offers = [("f64", "f32"), ("f32",), ("bf16",)]
            stats = []
            for i, (A, b) in enumerate(data):
                c = _loopback_client(disp, "x64", offers[i])
                s = compute_stats(torch.from_numpy(A).double(),
                                  torch.from_numpy(b).double())
                c.upload_stats(s, client_id=f"c{i}")
                stats.append(s)
            assert pool.get("x64").dtype == torch.float64
            q = [stats[0],
                 SuffStats(stats[1].gram.float().double(),
                           stats[1].moment.float().double(), stats[1].count),
                 SuffStats(stats[2].gram.to(torch.bfloat16).double(),
                           stats[2].moment.to(torch.bfloat16).double(),
                           stats[2].count)]
            fused = pool.stats("x64")
            _bits_equal(fused.gram, (q[0] + q[1] + q[2]).gram)
            np.testing.assert_allclose(c.solve(SIGMA), _f64_solve(fused),
                                       rtol=1e-10, atol=1e-10)

    def test_f64_frame_truncates_into_a_float32_pool(self):
        A, b = _rows(3)
        s64 = compute_stats(torch.from_numpy(A).double(),
                            torch.from_numpy(b).double())
        with _pool() as pool:
            disp = transport.WireDispatcher(pool)
            c = _loopback_client(disp, "t", ("f64",))
            assert c.dtype == "f64"
            c.upload_stats(s64, client_id="c0")
            fused = pool.stats("t")
            assert fused.gram.dtype == torch.float32
            _bits_equal(fused.gram, s64.gram.float())
            c.stream_rows(A[:4].astype(np.float64), b[:4].astype(np.float64),
                          client_id="c1")
            assert pool.stats("t").gram.dtype == torch.float32

    def test_drop_restore_over_control_frames(self):
        stats = [_stats(*_rows(i)) for i in range(3)]
        with _pool() as pool:
            disp = transport.WireDispatcher(pool)
            c = _loopback_client(disp, "ridge")
            for i, s in enumerate(stats):
                c.upload_stats(s, client_id=f"c{i}")
            c.control("drop", "c1")
            ref = fusion.solve_ridge(stats[0] + stats[2], SIGMA)
            np.testing.assert_allclose(c.solve(SIGMA), ref.numpy(),
                                       rtol=RTOL, atol=1e-6)
            assert c.control("drop", "c1").duplicate
            c.control("restore", "c1")
            ref = fusion.solve_ridge(_sum(stats), SIGMA)
            np.testing.assert_allclose(c.solve(SIGMA), ref.numpy(),
                                       rtol=RTOL, atol=1e-6)
            assert c.control("restore", "c1").duplicate
            assert pool.tenant("ridge").duplicates == 2
            with pytest.raises(transport.TransportError, match="unknown"):
                c.control("drop", "never-uploaded")

    def test_delta_rows_equal_packed_stats(self):
        A, b = _rows(5, n=48)
        with _pool() as pool:
            disp = transport.WireDispatcher(pool)
            c1 = _loopback_client(disp, "packed")
            c1.upload_stats(_stats(A, b), client_id="c")
            c2 = _loopback_client(disp, "streamed")
            for lo, hi in ((0, 16), (16, 17), (17, 48)):
                c2.stream_rows(A[lo:hi], b[lo:hi], client_id="c")
            np.testing.assert_allclose(c1.solve(SIGMA), c2.solve(SIGMA),
                                       rtol=1e-4, atol=1e-5)
            assert pool.ledger()["per_tenant"]["streamed"]["wire_frames"] == 3

    def test_projected_tenant_lifts_like_inprocess(self):
        m, seed = 6, 41
        R = projection.make_projection(threefry.key(seed), D, m, device="cpu")
        rhash = wire.projection_hash(R)
        assert rhash == FeatureMap("sketch", seed, D, m).fhash
        with _pool() as pool:
            disp = transport.WireDispatcher(pool)
            packed = []
            for i in range(3):
                A, b = _rows(20 + i)
                c = _loopback_client(disp, "sketch")
                p = PackedStats.pack(projection.projected_stats(
                    torch.from_numpy(A), torch.from_numpy(b), R))
                c.upload_projected(p, d_orig=D, seed=seed, rhash=rhash,
                                   client_id=f"p{i}")
                packed.append(p)
            w = c.solve(SIGMA)
            assert w.shape == (D,)
            fused = _sum([p.unpack() for p in packed])
            ref = projection.lift(fusion.solve_ridge(fused, SIGMA), R)
            np.testing.assert_allclose(w, ref.numpy(), rtol=RTOL, atol=1e-6)
            t = pool.tenant("sketch")
            assert t.projection == {"seed": seed, "d_orig": D, "m": m,
                                    "rhash": rhash}
            assert pool.ledger()["by_kind"]["sketched"]["wire_upload_bytes"] \
                == sum(wire.projected_frame_nbytes(m, client_id=f"p{i}")
                       for i in range(3))

    def test_rff_tenant_over_the_wire(self):
        Dm, seed, ls = 12, 9, 1.5
        fm = FeatureMap("rff", seed, D, Dm, ls)
        feat = rff.make_rff(threefry.key(seed), D, Dm, lengthscale=ls,
                            device="cpu")
        with _pool() as pool:
            disp = transport.WireDispatcher(pool)
            stats = []
            for i in range(2):
                A, b = _rows(30 + i)
                s = rff.rff_stats(torch.from_numpy(A), torch.from_numpy(b),
                                  feat)
                c = _loopback_client(disp, "rff")
                c.upload_rff(PackedStats.pack(s), d_orig=D, seed=seed,
                             fhash=fm.fhash, lengthscale=ls,
                             client_id=f"r{i}")
                stats.append(s)
            ref = fusion.solve_ridge(_sum(stats), SIGMA)
            np.testing.assert_allclose(c.solve(SIGMA), ref.numpy(),
                                       rtol=RTOL, atol=1e-6)
            assert pool.tenant("rff").kind == "rff"
            with pytest.raises(transport.TransportError, match="rff map"):
                c.upload_rff(PackedStats.pack(stats[0]), d_orig=D, seed=seed,
                             fhash=fm.fhash, lengthscale=2.0, client_id="x")

    def test_projected_hash_and_conflict_rejected(self):
        m, seed = 6, 41
        R = projection.make_projection(threefry.key(seed), D, m, device="cpu")
        rhash = wire.projection_hash(R)
        A, b = _rows(0)
        p = PackedStats.pack(projection.projected_stats(
            torch.from_numpy(A), torch.from_numpy(b), R))
        with _pool() as pool:
            disp = transport.WireDispatcher(pool)
            c = _loopback_client(disp, "sketch")
            with pytest.raises(transport.TransportError,
                               match="hash mismatch"):
                c.upload_projected(p, d_orig=D, seed=seed, rhash=rhash ^ 1,
                                   client_id="bad")
            assert int(pool.get("sketch").backend.count) == 0
            c.upload_projected(p, d_orig=D, seed=seed, rhash=rhash,
                               client_id="good")
            R2 = projection.make_projection(threefry.key(seed + 1), D, m,
                                            device="cpu")
            A1, b1 = _rows(1)
            p2 = PackedStats.pack(projection.projected_stats(
                torch.from_numpy(A1), torch.from_numpy(b1), R2))
            with pytest.raises(transport.TransportError,
                               match="conflicting sketch"):
                c.upload_projected(p2, d_orig=D, seed=seed + 1,
                                   rhash=wire.projection_hash(R2),
                                   client_id="worse")

    def test_plain_and_sketched_spaces_never_mix(self):
        m, seed = 6, 41
        R = projection.make_projection(threefry.key(seed), D, m, device="cpu")
        A, b = _rows(0)
        p = PackedStats.pack(projection.projected_stats(
            torch.from_numpy(A), torch.from_numpy(b), R))
        small = _stats(*_rows(1, d=m))
        with _pool() as pool:
            disp = transport.WireDispatcher(pool)
            c = _loopback_client(disp, "sketch")
            c.upload_projected(p, d_orig=D, seed=seed,
                               rhash=wire.projection_hash(R), client_id="p0")
            before = pool.solve_lifted("sketch", SIGMA).numpy()
            with pytest.raises(transport.TransportError,
                               match="sketched statistics"):
                c.upload_stats(small, client_id="plain")
            with pytest.raises(transport.TransportError,
                               match="sketched statistics"):
                c.stream_rows(np.zeros((2, m), np.float32),
                              np.zeros(2, np.float32), client_id="rows")
            _bits_equal(before, pool.solve_lifted("sketch", SIGMA))
            c2 = _loopback_client(disp, "plain")
            c2.upload_stats(small, client_id="c")
            with pytest.raises(transport.TransportError,
                               match="unsketched statistics"):
                c2.upload_projected(p, d_orig=D, seed=seed,
                                    rhash=wire.projection_hash(R),
                                    client_id="p1")

    def test_overflowing_count_is_typed_not_thread_killing(self):
        with pytest.raises(wire.PayloadError, match="int32 container"):
            wire.encode_frame(wire.StatsFrame(
                tri=np.zeros(3, np.float32), moment=np.zeros(2, np.float32),
                count=2**31, dim=2))
        good = wire.encode_frame(wire.StatsFrame(
            tri=np.zeros(3, np.float32), moment=np.zeros(2, np.float32),
            count=1, dim=2))
        bad = bytearray(good)
        bad[16:24] = (2**31).to_bytes(8, "little")
        body = bytes(bad[:-4])
        crafted = body + (zlib.crc32(body) & 0xFFFFFFFF).to_bytes(4, "little")
        with pytest.raises(wire.PayloadError, match="int32 container"):
            wire.decode_frame(crafted)
        with _pool() as pool:
            session = transport.WireDispatcher(pool).session()
            reply = wire.decode_frame(session.handle(crafted))
            assert isinstance(reply, wire.AckFrame) and not reply.ok
            assert "PayloadError" in reply.message and reply.retryable
            assert isinstance(wire.decode_frame(session.handle(
                wire.encode_frame(wire.Hello("t", ("f32",))))), wire.Hello)

    def test_dim_mismatch_rejected_session_survives(self):
        with _pool() as pool:
            disp = transport.WireDispatcher(pool)
            c = _loopback_client(disp, "ridge")
            c.upload_stats(_stats(*_rows(0)), client_id="c0")
            with pytest.raises(transport.TransportError, match="dim") as ei:
                c.upload_stats(_stats(*_rows(1, d=4)), client_id="c1")
            assert not ei.value.ack.retryable
            c.upload_stats(_stats(*_rows(1)), client_id="c1")
            assert pool.get("ridge").count == 128

    def test_malformed_bytes_get_error_ack_not_crash(self):
        with _pool() as pool:
            session = transport.WireDispatcher(pool).session()
            reply = wire.decode_frame(session.handle(b"garbage not a frame"))
            assert isinstance(reply, wire.AckFrame) and not reply.ok
            assert "BadMagic" in reply.message
            good = wire.encode_frame(wire.Hello("t", ("f32",)))
            assert isinstance(wire.decode_frame(session.handle(good)),
                              wire.Hello)

    def test_huge_client_id_rejection_ack_is_bounded(self):
        with _pool() as pool:
            disp = transport.WireDispatcher(pool)
            c = _loopback_client(disp, "ridge")
            c.upload_stats(_stats(*_rows(0)), client_id="c0")
            huge = "x" * 60_000
            with pytest.raises(transport.TransportError, match="unknown"):
                c.control("drop", huge)
            reply = wire.decode_frame(c.channel._session.handle(
                wire.encode_frame(wire.ControlFrame("drop", huge))))
            assert isinstance(reply, wire.AckFrame) and not reply.ok
            assert len(reply.message.encode()) <= \
                transport.MAX_ACK_MESSAGE_BYTES + len("...[truncated]")
            assert pool.get("ridge").count == 64

    def test_client_sending_server_frames_rejected(self):
        with _pool() as pool:
            session = transport.WireDispatcher(pool).session()
            data = wire.encode_frame(wire.WeightsFrame(np.zeros(3), 0.1))
            reply = wire.decode_frame(session.handle(data))
            assert isinstance(reply, wire.AckFrame) and not reply.ok
            assert "unexpected WeightsFrame" in reply.message

    def test_solve_unknown_tenant_rejected(self):
        with _pool() as pool:
            c = _loopback_client(transport.WireDispatcher(pool), "nobody")
            with pytest.raises(transport.TransportError, match="unknown"):
                c.solve(SIGMA)

    def test_hello_is_not_admitted(self):
        with _pool() as pool:
            with pytest.raises(TypeError, match="session frame"):
                pool.admit_frame("t", wire.Hello("t"))

    def test_quota_refusal_is_a_typed_ack(self):
        with _pool(max_clients_per_tenant=1) as pool:
            c = _loopback_client(transport.WireDispatcher(pool), "t")
            c.upload_stats(_stats(*_rows(0)), client_id="c0")
            with pytest.raises(transport.RejectedError, match="refused") as e:
                c.upload_stats(_stats(*_rows(1)), client_id="c1")
            assert not e.value.ack.retryable
            assert pool.tenant("t").wire_frames == 1
            assert pool.summary()["admission_rejections"] == 1

    def test_internal_error_is_counted_and_logged(self, caplog,
                                                  monkeypatch):
        """A failure inside admission (here a stand-in for a kernel that
        cannot launch) is a retryable ACK, as in the reference, and it is
        counted and logged: it never turns into a quiet path."""
        with _pool() as pool:
            disp = transport.WireDispatcher(pool)
            c = _loopback_client(disp, "t")

            def boom(*a, **kw):
                raise RuntimeError("kernel launch failed")

            monkeypatch.setattr(pool, "admit_frame", boom)
            with caplog.at_level(logging.ERROR,
                                 logger="repro_torch.fed.transport"):
                with pytest.raises(transport.RejectedError) as ei:
                    c.upload_stats(_stats(*_rows(0)), client_id="c0")
            assert ei.value.ack.retryable
            assert "kernel launch failed" in ei.value.ack.message
            assert disp.summary()["internal_errors"] == 1
            assert disp.frames_rejected == 1
            assert any("internal error admitting StatsFrame" in r.getMessage()
                       for r in caplog.records)

    def test_solve_batcher_route_equals_lone_solve(self):
        """SOLVE through the dispatcher's ``SolveBatcher`` answers the bits
        of the pool's own lifted solve."""
        with _pool() as pool:
            batcher = SolveBatcher(pool, window_s=0.001).start()
            try:
                disp = transport.WireDispatcher(pool, solve_batcher=batcher)
                c = _loopback_client(disp, "t")
                c.upload_stats(_stats(*_rows(0)), client_id="c0")
                for sigma in (0.1, 1.0):
                    _bits_equal(c.solve(sigma), pool.solve_lifted("t", sigma))
                with pytest.raises(transport.RejectedError, match="unknown"):
                    _loopback_client(disp, "nobody").solve(SIGMA)
                assert disp.summary()["solve_batcher"]["requests"] == 2
            finally:
                batcher.stop()


class TestPoolWireLedger:
    """One frame sequence through both packages' dispatchers."""

    @staticmethod
    def _frames():
        """(tenant, offers, encoded frame) in order: every frame kind, a
        bf16 and a moments upload, rows, control, solves, a duplicate, a
        refused frame and a relay-forwarded one."""
        out = []
        rng = np.random.default_rng(5)
        for i in range(3):
            A, b = _rows(40 + i)
            js = _jstats(A, b)
            f = jwire.StatsFrame.from_stats(js, client_id=f"c{i}",
                                            moments=i == 1)
            out.append(("dense", ("f32",), jwire.encode_frame(
                f, dtype="bf16" if i == 2 else "f32")))
        relay = jwire.StatsFrame.from_stats(
            _jstats(*_rows(49)), client_id=jwire.relay_client_id("r0", 1))
        out.append(("dense", ("f32",), jwire.encode_frame(relay)))
        for lo in (0, 5):
            A, b = _int_rows(50 + lo, 5, D)
            out.append(("dense", ("f32",), jwire.encode_frame(
                jwire.DeltaRowsFrame(A=A, b=b, client_id="c0"))))
        out.append(("dense", ("f32",), out[0][2]))                 # duplicate
        out.append(("dense", ("f32",), jwire.encode_frame(
            jwire.StatsFrame.from_stats(_jstats(*_rows(3, d=4)),
                                        client_id="x"))))         # dim refused
        out.append(("dense", ("f32",),
                    jwire.encode_frame(jwire.ControlFrame("drop", "c1"))))
        out.append(("dense", ("f32",),
                    jwire.encode_frame(jwire.ControlFrame("drop", "c1"))))
        out.append(("dense", ("f32",), jwire.encode_frame(jwire.SolveFrame(0.5))))
        out.append(("dense", ("f32",),
                    jwire.encode_frame(jwire.ControlFrame("restore", "c1"))))
        fm = JFeatureMap("sketch", seed=77, d_orig=D, m=6)
        for i in range(2):
            A, b = _rows(60 + i)
            ps = fm.stats(jnp.asarray(A), jnp.asarray(b))
            p = JPackedStats.pack(ps)
            out.append(("sketch", ("f32",), jwire.encode_frame(
                jwire.ProjectedFrame(
                    tri=np.asarray(p.tri), moment=np.asarray(p.moment),
                    count=int(p.count), dim=6, d_orig=D, seed=77,
                    rhash=fm.fhash, client_id=f"p{i}"))))
        rm = JFeatureMap("rff", seed=78, d_orig=D, m=10,
                                       lengthscale=2.0)
        A, b = _rows(70)
        p = JPackedStats.pack(rm.stats(jnp.asarray(A), jnp.asarray(b)))
        out.append(("rff", ("bf16",), jwire.encode_frame(jwire.RFFFrame(
            tri=np.asarray(p.tri), moment=np.asarray(p.moment),
            count=int(p.count), dim=10, d_orig=D, seed=78, fhash=rm.fhash,
            lengthscale=2.0, client_id="r0", yty=float(p.yty)),
            dtype="bf16")))
        out.append(("rff", ("f32",), jwire.encode_frame(jwire.SolveFrame(1.0))))
        out.append(("sketch", ("f32",),
                    jwire.encode_frame(jwire.SolveFrame(1.0))))
        del rng
        return out

    @staticmethod
    def _run(mod, pool, frames):
        disp = mod.WireDispatcher(pool)
        replies, sessions = [], {}
        for tenant, offers, raw in frames:
            if tenant not in sessions:
                s = disp.session()
                s.handle(mod.wire.encode_frame(mod.wire.Hello(tenant, offers)))
                sessions[tenant] = s
            replies.append(sessions[tenant].handle(raw))
        return disp, replies

    def test_replies_ledger_summary_and_fused_stats_equal(self):
        frames = self._frames()
        jpool = jserver.EnginePool()
        with _pool() as tpool:
            jdisp, jrep = self._run(jtransport, jpool, frames)
            tdisp, trep = self._run(transport, tpool, frames)
            for (_, _, raw), a, b in zip(frames, trep, jrep):
                fa, fb = wire.decode_frame(a), jwire.decode_frame(b)
                if isinstance(fa, wire.WeightsFrame):
                    assert len(a) == len(b) and fa.sigma == fb.sigma
                    np.testing.assert_allclose(fa.w, fb.w, rtol=RTOL,
                                               atol=ATOL)
                else:
                    assert a == b, (fa, fb)
            assert tpool.ledger() == jpool.ledger()
            js, ts = jpool.summary(), tpool.summary()
            for s in (js, ts):
                s.pop("max_flush_age_s")
                for t in s["per_tenant"].values():
                    t.pop("max_flush_age_s")
            assert ts == js
            jsum = jdisp.summary()
            tsum = tdisp.summary()
            assert tsum.pop("internal_errors") == 0
            assert tsum == jsum
            for name in ("dense", "sketch", "rff"):
                ts_, js_ = tpool.stats(name), jpool.stats(name)
                _bits_equal(ts_.gram, js_.gram)
                _bits_equal(ts_.moment, js_.moment)
                assert int(ts_.count) == int(js_.count)
                assert tpool.tenant(name).dedup == jpool.tenant(name).dedup
            led = tpool.ledger()
            assert led["by_tier"] == {"relay_frames": 1, "client_frames": 8}
            assert led["wire_upload_bytes"] > 0 < led["wire_download_bytes"]
        jpool.close()

    def test_pool_from_carries_wire_counters_and_dedup(self):
        """A reference pool fed over the wire, carried over with
        ``convert.pool_from``: the same ledger and summary, and a re-send of
        a frame the reference fused is a duplicate in the port."""
        from repro_torch.convert import pool_from

        frames = [f for f in self._frames() if f[0] == "dense"]
        jpool = jserver.EnginePool()
        self._run(jtransport, jpool, frames)
        with pool_from(jpool, device="cpu") as tpool:
            assert tpool.ledger() == jpool.ledger()
            assert tpool.tenant("dense").dedup == jpool.tenant("dense").dedup
            raw = frames[0][2]
            ack = tpool.admit_frame("dense", wire.decode_frame(raw),
                                    encoded_len=len(raw), raw=raw)
            assert ack.duplicate
            assert tpool.tenant("dense").duplicates == \
                jpool.tenant("dense").duplicates + 1
        jpool.close()

    def test_counters_start_at_zero_and_solve_counts_download_only(self):
        with _pool() as pool:
            c = _loopback_client(transport.WireDispatcher(pool), "t")
            c.upload_stats(_stats(*_rows(0)), client_id="c0")
            t = pool.tenant("t")
            up, down = t.wire_upload_bytes, t.wire_download_bytes
            c.solve(SIGMA)
            assert (t.wire_frames, t.wire_upload_bytes) == (1, up)
            assert t.wire_download_bytes == down + wire.OVERHEAD_BYTES + \
                12 + 4 * D
            assert pool.summary()["per_tenant"]["t"]["wire_frames"] == 1


def _forge_collision(raw_target, raw_base):
    """``raw_base`` with low mantissa bits of its DELTA rows flipped so that
    its frame CRC32 equals ``raw_target``'s (CRC32 is affine over GF(2) at a
    fixed length, so a subset of single-bit flips steers it anywhere)."""
    body = bytearray(raw_base[:-4])
    base = zlib.crc32(bytes(body)) & 0xFFFFFFFF
    target = wire.frame_crc(raw_target)
    n, d = struct.unpack("<II", body[12:20])
    (cid_len,) = struct.unpack("<H", body[20:22])
    a_off = 22 + cid_len
    positions = [a_off + 4 * i + byte for i in range(n * d) for byte in (0, 1)]
    syndromes = []
    for pos in positions:
        mod = bytearray(body)
        mod[pos] ^= 1
        syndromes.append((zlib.crc32(bytes(mod)) & 0xFFFFFFFF) ^ base)
    pivots = {}
    for i, s in enumerate(syndromes):
        v, mask = s, 1 << i
        while v:
            hb = v.bit_length() - 1
            if hb not in pivots:
                pivots[hb] = (v, mask)
                break
            pv, pm = pivots[hb]
            v, mask = v ^ pv, mask ^ pm
    v, mask = base ^ target, 0
    while v:
        pv, pm = pivots[v.bit_length() - 1]
        v, mask = v ^ pv, mask ^ pm
    for i, pos in enumerate(positions):
        if mask >> i & 1:
            body[pos] ^= 1
    return bytes(body) + struct.pack("<I", zlib.crc32(bytes(body)) & 0xFFFFFFFF)


def _delta_raw(seed, n, cid, d=16):
    A, b = _int_rows(seed, n, d)
    return wire.encode_frame(wire.DeltaRowsFrame(A=A, b=b, client_id=cid))


class TestDedup:
    def test_byte_identical_resend_fuses_once(self):
        raw = wire.encode_frame(wire.StatsFrame.from_stats(
            _stats(*_rows(0)), client_id="c0"))
        with _pool() as pool:
            first = pool.admit_frame("t", wire.decode_frame(raw),
                                     encoded_len=len(raw), raw=raw)
            again = pool.admit_frame("t", wire.decode_frame(raw),
                                     encoded_len=len(raw), raw=raw)
            assert first.ok and not first.duplicate
            assert again.ok and again.duplicate
            assert pool.get("t").count == 64
            t = pool.tenant("t")
            assert (t.wire_frames, t.duplicates) == (1, 1)
            assert t.dedup == {("c0", wire.FT_STATS, len(raw),
                                wire.frame_crc(raw))}

    def test_frames_without_bytes_are_not_deduplicated(self):
        """An in-process caller (no raw bytes) never retries blind."""
        f = wire.StatsFrame.from_stats(_stats(*_rows(0)), client_id="c0")
        with _pool() as pool:
            assert not pool.admit_frame("t", f).duplicate
            assert not pool.admit_frame("t", f).duplicate
            assert pool.get("t").count == 128 and not pool.tenant("t").dedup

    def test_legacy_two_tuple_keys_still_deduplicate(self):
        raw = _delta_raw(1, 3, "c0")
        with _pool() as pool:
            pool.create_tenant("t", dim=16)
            pool.tenant("t").dedup.add(("c0", wire.frame_crc(raw)))
            ack = pool.admit_frame("t", wire.decode_frame(raw),
                                   encoded_len=len(raw), raw=raw)
            assert ack.duplicate and pool.get("t").count == 0

    @pytest.mark.parametrize("case", ["other_length", "other_client",
                                      "same_client_type_length"])
    def test_crc_collisions(self, case):
        """CRC32-colliding DELTA uploads. The key's length and client parts
        tell the first two apart, so both frames fuse; a collision of the
        same client, type and length has the same key, and both packages
        answer it duplicate=True (the reference key's limit, pinned)."""
        raw1 = _delta_raw(11, 2, "evil")
        base = {"other_length": _delta_raw(12, 3, "evil"),
                "other_client": _delta_raw(12, 2, "evi2"),
                "same_client_type_length": _delta_raw(12, 2, "evil")}[case]
        raw2 = _forge_collision(raw1, base)
        assert raw2 != raw1 and wire.frame_crc(raw2) == wire.frame_crc(raw1)
        fused = case != "same_client_type_length"
        jpool = jserver.EnginePool()
        with _pool() as tpool:
            for pool, mod in ((tpool, wire), (jpool, jwire)):
                acks = [pool.admit_frame("t", mod.decode_frame(r),
                                         encoded_len=len(r), raw=r)
                        for r in (raw1, raw2, raw1, raw2)]
                assert [a.duplicate for a in acks] == \
                    [False, not fused, True, True]
                rows = 2 + (int(wire.decode_frame(raw2).A.shape[0])
                            if fused else 0)
                assert int(pool.get("t").backend.count) == rows
            _bits_equal(tpool.stats("t").gram, jpool.stats("t").gram)
            assert tpool.tenant("t").dedup == jpool.tenant("t").dedup
        jpool.close()


class TestTCPTransport:
    def test_tcp_roundtrip_and_corrupt_header_isolation(self):
        A, b = _rows(0)
        with _pool() as pool, transport.FrameServer(pool) as srv:
            with transport.TCPChannel("127.0.0.1", srv.port) as ch:
                c = transport.FrameClient(ch)
                assert c.hello("tcp", ("f64", "bf16")) == "f64"
                c.upload_stats(_stats(A, b), client_id="c0")
                w = c.solve(SIGMA)
            ref = fusion.solve_ridge(_stats(A, b), SIGMA)
            np.testing.assert_allclose(w, ref.numpy(), rtol=RTOL, atol=1e-6)
            with transport.TCPChannel("127.0.0.1", srv.port) as bad:
                reply = wire.decode_frame(bad.request(b"X" * 32))
                assert isinstance(reply, wire.AckFrame) and not reply.ok
            with transport.TCPChannel("127.0.0.1", srv.port) as ch2:
                c2 = transport.FrameClient(ch2)
                c2.hello("tcp", ("f32",))
                np.testing.assert_allclose(c2.solve(SIGMA), w, atol=1e-6)
            assert pool.get("tcp").count == A.shape[0]
            assert srv.connections_total == 3

    @pytest.mark.parametrize("offers", [("f32",), ("bf16",)])
    def test_stats_over_tcp_fuse_to_in_process_bits(self, offers):
        """Dense STATS frames over sockets give the fused (G, h) of an
        in-process admission of the same (wire-rounded) statistics in the
        same order, bitwise."""
        stats = [_stats(*_rows(80 + i)) for i in range(4)]
        with _pool() as pool, transport.FrameServer(pool) as srv:
            client = transport.ResilientClient(
                lambda: transport.TCPChannel(srv.host, srv.port),
                tenant="t", offers=offers)
            for i, s in enumerate(stats):
                assert client.upload_stats(s, client_id=f"c{i}",
                                           moments=i == 0).ok
            w = client.solve(SIGMA)
            client.close()
            with _pool() as ref:
                ref.create_tenant("t", dim=D)
                for i, s in enumerate(stats):
                    if offers == ("bf16",):
                        s = _bf16_quantized(s)
                    ref.ingest("t", s, client_id=f"c{i}")
                got, want = pool.stats("t"), ref.stats("t")
                _bits_equal(got.gram, want.gram)
                _bits_equal(got.moment, want.moment)
                _bits_equal(w, ref.solve_lifted("t", SIGMA))

    def test_concurrent_connections_each_fuse_once(self):
        """One thread a connection, beside each other: every upload fuses
        exactly once, into its own tenant."""
        with _pool() as pool, transport.FrameServer(pool) as srv:
            errors = []

            def run(k):
                try:
                    with transport.TCPChannel(srv.host, srv.port) as ch:
                        c = transport.FrameClient(ch)
                        c.hello(f"t{k % 2}")
                        for i in range(3):
                            A, b = _int_rows(100 * k + i, 4, 8)
                            c.upload_stats(_stats(A, b), client_id=f"{k}-{i}")
                except Exception as e:  # noqa: BLE001 - re-raised below
                    errors.append(e)

            threads = [threading.Thread(target=run, args=(k,))
                       for k in range(6)]
            for th in threads:
                th.start()
            for th in threads:
                th.join(timeout=60)
            assert not any(th.is_alive() for th in threads) and not errors
            assert srv.dispatcher.uploads_admitted == 18
            for name in ("t0", "t1"):
                assert len(pool.get(name).client_ids) == 9
                assert pool.get(name).count == 36


class TestCrossPackageTCP:
    """Each package's client against the other's server: nothing shared but
    the bytes."""

    @staticmethod
    def _upload_all(mod, host, port, uploads):
        for tenant, offers, stats, moments in uploads:
            with mod.TCPChannel(host, port) as ch:
                c = mod.FrameClient(ch)
                c.hello(tenant, offers)
                for cid, s in stats:
                    assert c.upload_stats(s, client_id=cid,
                                          moments=moments).ok
        with mod.TCPChannel(host, port) as ch:
            c = mod.FrameClient(ch)
            c.hello("dense", ("f32",))
            return c.solve(SIGMA)

    def _uploads(self, make):
        return [("dense", ("f32",), [(f"c{i}", make(*_rows(90 + i)))
                                     for i in range(3)], True),
                ("lowp", ("bf16",), [("q0", make(*_rows(95)))], False)]

    def test_reference_client_port_server(self):
        jpool = jserver.EnginePool()
        with _pool() as tpool, transport.FrameServer(tpool) as srv, \
                jtransport.FrameServer(jpool) as jsrv:
            wt = self._upload_all(jtransport, srv.host, srv.port,
                                  self._uploads(_jstats))
            wj = self._upload_all(jtransport, jsrv.host, jsrv.port,
                                  self._uploads(_jstats))
            self._assert_same(tpool, jpool, wt, wj)
        jpool.close()

    def test_port_client_reference_server(self):
        jpool = jserver.EnginePool()
        with _pool() as tpool, transport.FrameServer(tpool) as srv, \
                jtransport.FrameServer(jpool) as jsrv:
            wj = self._upload_all(transport, jsrv.host, jsrv.port,
                                  self._uploads(_stats))
            wt = self._upload_all(transport, srv.host, srv.port,
                                  self._uploads(_stats))
            self._assert_same(tpool, jpool, wt, wj)
            # The port's statistics of the same rows are the reference's
            # up to float32 summation order; what crossed the wire fused
            # identically on both servers (checked above).
        jpool.close()

    @staticmethod
    def _assert_same(tpool, jpool, wt, wj):
        for name in ("dense", "lowp"):
            ts, js = tpool.stats(name), jpool.stats(name)
            _bits_equal(ts.gram, js.gram)
            _bits_equal(ts.moment, js.moment)
            assert int(ts.count) == int(js.count)
        np.testing.assert_allclose(np.asarray(wt), np.asarray(wj),
                                   rtol=RTOL, atol=ATOL)
        assert tpool.ledger() == jpool.ledger()

    def test_reference_feature_frames_admit_into_the_port(self):
        """With bitwise maps, a JAX client's PROJ and RFF frames carry the
        hash the port derives, so they fuse; a wrong hash is refused."""
        fm = JFeatureMap("sketch", seed=5, d_orig=D, m=4)
        rm = JFeatureMap("rff", seed=6, d_orig=D, m=8,
                                       lengthscale=3.0)
        A, b = _rows(7)
        ps = JPackedStats.pack(fm.stats(jnp.asarray(A), jnp.asarray(b)))
        rs = JPackedStats.pack(rm.stats(jnp.asarray(A), jnp.asarray(b)))
        with _pool() as pool, transport.FrameServer(pool) as srv:
            with jtransport.TCPChannel(srv.host, srv.port) as ch:
                c = jtransport.FrameClient(ch)
                c.hello("sketch")
                with pytest.raises(jtransport.RejectedError,
                                   match="hash mismatch"):
                    c.upload_projected(ps, d_orig=D, seed=5,
                                       rhash=fm.fhash ^ 1, client_id="bad")
                assert c.upload_projected(ps, d_orig=D, seed=5,
                                          rhash=fm.fhash, client_id="p0").ok
                w = c.solve(SIGMA)
            with jtransport.TCPChannel(srv.host, srv.port) as ch:
                c = jtransport.FrameClient(ch)
                c.hello("rff")
                assert c.upload_rff(rs, d_orig=D, seed=6, fhash=rm.fhash,
                                    lengthscale=3.0, client_id="r0").ok
            assert pool.tenant("sketch").feature_map.fhash == fm.fhash
            assert pool.tenant("rff").feature_map.fhash == rm.fhash
            _bits_equal(pool.stats("sketch").gram, np.asarray(ps.unpack().gram))
            jR = np.asarray(fm.materialize()[0])
            v = fusion.solve_ridge(pool.stats("sketch"), SIGMA)
            np.testing.assert_allclose(w, jR @ v.numpy(), rtol=RTOL,
                                       atol=1e-6)
