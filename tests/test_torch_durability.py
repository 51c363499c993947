"""Crash-safe federation in the port: journal scan, snapshot + replay, dedup,
and the JAX package's journal directories in both directions.

The pin of the reference's ``tests/test_durability.py``, held inside the
port: a journaled ``EnginePool`` that dies at any point (mid-stream,
mid-snapshot, with a torn record on disk) restarts into a state whose
Phase-3 solve is **bitwise** that of a pool that never crashed, with **no
client re-uploading**. Layers:

  * journal / scan units (``server.durability``): record framing, tenant
    markers, torn-tail detection and truncation;
  * in-process crash and restore of dense, sketched and rff tenants,
    snapshot-covers-prefix / replay-covers-tail, automatic compaction,
    journaled Thm-8 control, and the dedup index across restarts (CRC32
    collisions and the legacy 2-tuple keys included);
  * the lost-ACK retry ledger over loopback, TCP and a resilient client;
  * subprocesses: ``python -m repro_torch.launch.serve --device cpu
    --journal-dir`` SIGKILLed mid-ingest and restarted bitwise with zero
    re-uploads, and SIGTERM -> final snapshot -> zero-replay restart;
  * across packages: a journal directory written by the JAX pool restores
    into the port's pool, and the reverse, with fused stats bitwise equal;
    the two packages write byte-identical WAL segments (and commit records
    and npz arrays) for the same frames in the same order.

Small-integer data keeps float32 sums exact wherever the order is not
already fixed by the journal. Everything runs on the CPU.
"""
import json
import os
import pathlib
import re
import signal
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro.server import EnginePool as JEnginePool
from repro.fed import wire as jwire
from repro_torch.core.features import FeatureMap
from repro_torch.core.sufficient_stats import compute_stats
from repro_torch.fed import transport, wire
from repro_torch.fed.protocol import PackedStats
from repro_torch.server import EnginePool
from repro_torch.server.durability import DurableStore, Journal, scan_segment

REPO = pathlib.Path(__file__).resolve().parents[1]
SIGMA = 0.1


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = (str(REPO / "src")
                         + os.pathsep + env.get("PYTHONPATH", ""))
    return env


def _pool(**kw):
    return EnginePool(device="cpu", **kw)


def _int_rows(rng, n, d):
    """Small-integer-valued rows: f32 sums are exact and order-free."""
    A = rng.integers(-3, 4, (n, d)).astype(np.float32)
    b = rng.integers(-3, 4, (n,)).astype(np.float32)
    return torch.from_numpy(A), torch.from_numpy(b)


def _stats_raw(A, b, client_id, dtype="f32"):
    frame = wire.StatsFrame.from_stats(compute_stats(A, b),
                                       client_id=client_id)
    return wire.encode_frame(frame, dtype=dtype)


def _admit_raw(pool, tenant, raw, *, placement="dense"):
    """What a transport does: the decoded frame + the bytes received."""
    mod = jwire if isinstance(pool, JEnginePool) else wire
    return pool.admit_frame(tenant, mod.decode_frame(raw),
                            encoded_len=len(raw), placement=placement,
                            raw=raw)


def _crash(pool):
    """SIGKILL in process: the journal's file goes away and nothing else
    runs (``_closed`` keeps ``__del__`` from a final snapshot a killed
    process never gets)."""
    if pool._journal is not None:
        pool._journal.close()
    pool._closed = True
    pool.stop_flusher()


def _w(pool, name, sigma=SIGMA):
    return pool.solve_lifted(name, sigma).numpy()


# -- journal / scan units -----------------------------------------------------

class TestJournalScan:
    def test_roundtrip_records_tenants_markers(self, tmp_path):
        j = Journal(tmp_path / "wal.log")
        rng = np.random.default_rng(0)
        raws = [_stats_raw(*_int_rows(rng, 4, 3), f"c{i}") for i in range(3)]
        j.append("alpha", raws[0])
        j.append("alpha", raws[1])   # same binding: no second marker
        j.append("beta", raws[2])
        assert (j.appends, j.markers) == (3, 2)
        j.close()

        res = scan_segment(tmp_path / "wal.log")
        assert not res.torn
        assert res.good_bytes == (tmp_path / "wal.log").stat().st_size
        assert [r.tenant for r in res.records] == ["alpha", "alpha", "beta"]
        assert [r.raw for r in res.records] == raws
        assert all(isinstance(r.frame, wire.StatsFrame)
                   for r in res.records)

    def test_torn_tail_detected_and_truncated(self, tmp_path):
        j = Journal(tmp_path / "wal_00000000.log")
        rng = np.random.default_rng(1)
        raw = _stats_raw(*_int_rows(rng, 4, 3), "c0")
        j.append("t", raw)
        j.append("t", _stats_raw(*_int_rows(rng, 4, 3), "c1"))
        j.close()
        good = (tmp_path / "wal_00000000.log").stat().st_size

        # a crash mid-write: the valid start of a third record, then nothing
        with open(tmp_path / "wal_00000000.log", "ab") as f:
            f.write(raw[:len(raw) // 2])
        res = scan_segment(tmp_path / "wal_00000000.log")
        assert res.torn and len(res.records) == 2
        assert res.good_bytes == good

        # open_journal truncates the tail in place and appends continue
        store = DurableStore(tmp_path)
        journal, plan = store.open_journal()
        assert (tmp_path / "wal_00000000.log").stat().st_size == good
        assert [seq for seq, _ in plan] == [0]
        assert len(plan[0][1].records) == 2
        journal.append("t", _stats_raw(*_int_rows(rng, 4, 3), "c2"))
        journal.close()
        assert not scan_segment(tmp_path / "wal_00000000.log").torn

    def test_corrupt_record_stops_scan(self, tmp_path):
        j = Journal(tmp_path / "wal.log")
        rng = np.random.default_rng(2)
        j.append("t", _stats_raw(*_int_rows(rng, 4, 3), "c0"))
        off_second = j.size
        j.append("t", _stats_raw(*_int_rows(rng, 4, 3), "c1"))
        j.close()
        data = bytearray((tmp_path / "wal.log").read_bytes())
        data[off_second + wire.HEADER_BYTES + 4] ^= 0x10  # payload bit flip
        (tmp_path / "wal.log").write_bytes(bytes(data))

        res = scan_segment(tmp_path / "wal.log")
        assert res.torn and len(res.records) == 1
        assert "corrupt record" in res.reason

    def test_half_header_tail(self, tmp_path):
        (tmp_path / "wal.log").write_bytes(b"\x00" * (wire.HEADER_BYTES - 3))
        res = scan_segment(tmp_path / "wal.log")
        assert res.torn and not res.records and res.good_bytes == 0


# -- in-process crash -> restore ----------------------------------------------

def _feature_raw(fm, A, b, client_id):
    packed = PackedStats.pack(fm.stats(A, b))
    common = dict(tri=wire.host_array(packed.tri),
                  moment=wire.host_array(packed.moment),
                  count=int(packed.count), dim=int(packed.dim),
                  d_orig=fm.d_orig, seed=fm.seed, client_id=client_id)
    if fm.kind == "sketch":
        frame = wire.ProjectedFrame(rhash=fm.fhash, **common)
    else:
        frame = wire.RFFFrame(fhash=fm.fhash, lengthscale=fm.lengthscale,
                              **common)
    return wire.encode_frame(frame, dtype="f32")


def _mixed_workload(seed=0):
    """(tenant, raw frame) uploads: two dense tenants, a sketched and an rff
    tenant (the reference's sharded tenant is a dense one here)."""
    rng = np.random.default_rng(seed)
    sketch = FeatureMap("sketch", seed=5, d_orig=10, m=4)
    rff = FeatureMap("rff", seed=6, d_orig=5, m=6)
    uploads = []
    for i in range(3):
        uploads.append(("dense", _stats_raw(*_int_rows(rng, 6, 8), f"d{i}")))
    for i in range(2):
        uploads.append(("wide", _stats_raw(*_int_rows(rng, 6, 8), f"s{i}")))
    for i in range(2):
        A, b = _int_rows(rng, 8, 10)
        uploads.append(("sk", _feature_raw(sketch, A, b, f"p{i}")))
    for i in range(2):
        A, b = _int_rows(rng, 8, 5)
        uploads.append(("fr", _feature_raw(rff, A, b, f"r{i}")))
    return uploads


class TestCrashRestore:
    def test_mixed_kinds_bit_identical_after_crash(self, tmp_path):
        """Dense, sketched and rff tenants, a snapshot mid-stream, a crash,
        a restore: every tenant's lifted solve equals an uncrashed pool's
        bitwise, and so does its client ledger."""
        uploads = _mixed_workload()
        ref = _pool()
        for tenant, raw in uploads:
            assert _admit_raw(ref, tenant, raw).ok
        ref_w = {t: _w(ref, t) for t in ref.tenant_names}

        p1 = _pool(journal_dir=tmp_path)
        for i, (tenant, raw) in enumerate(uploads):
            assert _admit_raw(p1, tenant, raw).ok
            if i == 4:
                p1.snapshot()        # later frames replay from the journal
        names = p1.tenant_names
        _crash(p1)

        p2 = _pool(journal_dir=tmp_path)
        # the snapshot held the 2 tenants that existed at the cut; the
        # feature tenants come back entirely through replay
        assert p2.restored_tenants == 2
        assert p2.replayed_frames == len(uploads) - 5
        assert set(p2.tenant_names) == set(names)
        assert p2.tenant("sk").kind == "sketched"
        assert p2.tenant("fr").kind == "rff"
        for t in names:
            assert _w(p2, t).tobytes() == ref_w[t].tobytes(), t
            assert (sorted(map(str, p2.get(t).client_ids))
                    == sorted(map(str, ref.get(t).client_ids)))
        assert p2.ledger() == ref.ledger()
        _crash(p2)

    def test_replay_only_no_snapshot(self, tmp_path):
        rng = np.random.default_rng(3)
        raws = [_stats_raw(*_int_rows(rng, 5, 6), f"c{i}") for i in range(3)]
        ref, p1 = _pool(), _pool(journal_dir=tmp_path)
        for raw in raws:
            _admit_raw(ref, "t", raw)
            _admit_raw(p1, "t", raw)
        w_ref = _w(ref, "t")
        _crash(p1)

        p2 = _pool(journal_dir=tmp_path)
        assert p2.restored_tenants == 0          # no snapshot existed
        assert p2.replayed_frames == 3
        assert _w(p2, "t").tobytes() == w_ref.tobytes()
        assert int(p2.get("t").backend.count) == 15
        _crash(p2)

    def test_dedup_index_survives_crash_and_snapshot(self, tmp_path):
        """A byte-identical retry is a duplicate across both persistence
        paths: keys in the snapshot and keys rebuilt by replay."""
        rng = np.random.default_rng(4)
        raw_a = _stats_raw(*_int_rows(rng, 5, 6), "a")
        raw_b = _stats_raw(*_int_rows(rng, 5, 6), "b")
        p1 = _pool(journal_dir=tmp_path)
        _admit_raw(p1, "t", raw_a)
        p1.snapshot()                    # key(a) persists in the snapshot
        _admit_raw(p1, "t", raw_b)       # key(b) persists through replay
        w1 = _w(p1, "t")
        _crash(p1)

        p2 = _pool(journal_dir=tmp_path)
        for raw in (raw_a, raw_b):
            ack = _admit_raw(p2, "t", raw)
            assert ack.ok and ack.duplicate
        assert p2.tenant("t").duplicates == 2
        assert _w(p2, "t").tobytes() == w1.tobytes()   # nothing re-fused
        _crash(p2)

    def test_clean_close_replays_nothing(self, tmp_path):
        rng = np.random.default_rng(5)
        raws = [_stats_raw(*_int_rows(rng, 5, 6), f"c{i}") for i in range(2)]
        p1 = _pool(journal_dir=tmp_path)
        for raw in raws:
            _admit_raw(p1, "t", raw)
        w1 = _w(p1, "t")
        p1.close()                       # final snapshot: a durable cut
        p1.close()                       # idempotent

        p2 = _pool(journal_dir=tmp_path)
        assert p2.restored_tenants == 1
        assert p2.replayed_frames == 0
        assert p2.summary()["journaled"] is True
        assert _w(p2, "t").tobytes() == w1.tobytes()
        p2.close()

    def test_auto_snapshot_compacts_segments(self, tmp_path):
        rng = np.random.default_rng(6)
        p1 = _pool(journal_dir=tmp_path, snapshot_every=2)
        for i in range(6):
            _admit_raw(p1, "t", _stats_raw(*_int_rows(rng, 4, 5), f"c{i}"))
        assert p1.snapshots_taken >= 2
        assert p1.summary()["snapshots_taken"] == p1.snapshots_taken
        store = DurableStore(tmp_path)
        latest = store.latest_snapshot_seq()
        assert all(s >= latest for s in store.segment_seqs())
        assert store.committed_snapshot_seqs() == [latest]
        w1 = _w(p1, "t")
        _crash(p1)

        p2 = _pool(journal_dir=tmp_path)
        assert p2.restored_tenants == 1
        assert p2.replayed_frames <= 2      # at most one snapshot interval
        assert _w(p2, "t").tobytes() == w1.tobytes()
        _crash(p2)

    def test_control_ops_journaled_and_idempotent(self, tmp_path):
        """A Thm-8 drop survives the crash; its re-send after the restore is
        a duplicate, and restoring the client is a journaled mutation."""
        rng = np.random.default_rng(7)
        raws = [_stats_raw(*_int_rows(rng, 5, 6), c) for c in ("a", "b")]
        drop = wire.encode_frame(wire.ControlFrame("drop", "a"), dtype="f32")
        ref, p1 = _pool(), _pool(journal_dir=tmp_path)
        for pool in (ref, p1):
            for raw in raws:
                _admit_raw(pool, "t", raw)
            assert _admit_raw(pool, "t", drop).ok
        w_ref = _w(ref, "t")
        _crash(p1)

        p2 = _pool(journal_dir=tmp_path)
        assert p2.replayed_frames == 3
        assert set(map(str, p2.get("t").dropped_ids)) == {"a"}
        assert _w(p2, "t").tobytes() == w_ref.tobytes()
        ack = _admit_raw(p2, "t", drop)          # a retry after a lost ACK
        assert ack.ok and ack.duplicate
        restore = wire.encode_frame(wire.ControlFrame("restore", "a"),
                                    dtype="f32")
        assert _admit_raw(p2, "t", restore).ok
        ref.restore("t", "a")
        assert _w(p2, "t").tobytes() == _w(ref, "t").tobytes()
        _crash(p2)

    def test_torn_live_tail_truncated_on_restore(self, tmp_path):
        rng = np.random.default_rng(8)
        raw = _stats_raw(*_int_rows(rng, 5, 6), "c0")
        p1 = _pool(journal_dir=tmp_path)
        _admit_raw(p1, "t", raw)
        w1 = _w(p1, "t")
        live = p1._journal.path
        _crash(p1)
        with open(live, "ab") as f:
            f.write(raw[: len(raw) - 7])     # a torn record, no CRC

        p2 = _pool(journal_dir=tmp_path)
        assert p2.replayed_frames == 1
        assert _w(p2, "t").tobytes() == w1.tobytes()
        assert _admit_raw(p2, "t",
                          _stats_raw(*_int_rows(rng, 5, 6), "c1")).ok
        _crash(p2)

    def test_frames_without_bytes_are_reencoded_and_deduplicated(self,
                                                                 tmp_path):
        """A journaled pool journals and deduplicates a frame handed over
        without its bytes (``_frame_raw`` re-encodes it at its own wire
        dtype, byte-identical to the transport's bytes)."""
        rng = np.random.default_rng(9)
        raw = _stats_raw(*_int_rows(rng, 5, 6), "c0")
        pool = _pool(journal_dir=tmp_path)
        assert pool.admit_frame("t", wire.decode_frame(raw),
                                encoded_len=len(raw)).ok
        assert _admit_raw(pool, "t", raw).duplicate
        _crash(pool)
        (rec,) = scan_segment(tmp_path / "wal_00000000.log").records
        assert rec.raw == raw

    def test_restored_tenant_lands_on_the_pools_device(self, tmp_path):
        rng = np.random.default_rng(10)
        p1 = _pool(journal_dir=tmp_path)
        _admit_raw(p1, "t", _stats_raw(*_int_rows(rng, 5, 6), "c0"))
        p1.close()
        p2 = _pool(journal_dir=tmp_path)
        s = p2.stats("t")
        assert s.gram.device == torch.device("cpu") == s.count.device
        assert s.count.dtype == torch.int32
        assert p2.get("t").export_ledger()[0]["c0"].gram.device.type == "cpu"
        p2.close()


# -- the lost-ACK retry ledger --------------------------------------------------

class TestDuplicateRetryLedger:
    def _assert_retry_exact(self, pool, dispatcher, channel):
        rng = np.random.default_rng(9)
        A, b = _int_rows(rng, 8, 6)
        client = transport.FrameClient(channel)
        client.hello("t", ("f32",))
        ack = client.upload_stats(compute_stats(A, b), client_id="c0")
        assert ack.ok and not ack.duplicate

        w0, led0 = _w(pool, "t"), pool.ledger()
        t = pool.tenant("t")
        frames0, count0 = t.wire_frames, int(pool.get("t").backend.count)
        # the lost-ACK retry: a byte-identical re-send of the same frame
        raw = _stats_raw(A, b, "c0")
        reply = wire.decode_frame(channel.request(raw))
        assert isinstance(reply, wire.AckFrame)
        assert reply.ok and reply.duplicate

        assert pool.ledger()["wire_upload_bytes"] == led0["wire_upload_bytes"]
        assert t.wire_frames == frames0
        assert int(pool.get("t").backend.count) == count0
        assert list(pool.get("t").client_ids) == ["c0"]
        assert _w(pool, "t").tobytes() == w0.tobytes()
        s = dispatcher.summary()
        assert (s["uploads_admitted"], s["duplicates_acked"],
                s["frames_rejected"]) == (1, 1, 0)
        client.close()

    @pytest.mark.parametrize("journaled", [False, True])
    def test_loopback_retry_exact(self, tmp_path, journaled):
        with _pool(journal_dir=tmp_path if journaled else None) as pool:
            disp = transport.WireDispatcher(pool)
            self._assert_retry_exact(pool, disp,
                                     transport.LoopbackChannel(disp))

    def test_tcp_retry_exact(self, tmp_path):
        with _pool(journal_dir=tmp_path) as pool, \
                transport.FrameServer(pool) as srv:
            chan = transport.TCPChannel(srv.host, srv.port)
            self._assert_retry_exact(pool, srv.dispatcher, chan)

    def test_delta_rows_retry_exact(self, tmp_path):
        A, b = _int_rows(np.random.default_rng(10), 4, 5)
        raw = wire.encode_frame(
            wire.DeltaRowsFrame(A=A.numpy(), b=b.numpy(), client_id="s0"),
            dtype="f32")
        with _pool(journal_dir=tmp_path) as pool:
            assert _admit_raw(pool, "t", raw).ok
            w0 = _w(pool, "t")
            ack = _admit_raw(pool, "t", raw)
            assert ack.ok and ack.duplicate
            assert int(pool.get("t").backend.count) == 4   # fused once
            assert _w(pool, "t").tobytes() == w0.tobytes()

    def test_resilient_client_lost_ack_fuses_once(self, tmp_path):
        """A ResilientClient whose channel eats the first ACK: the blind
        re-send lands as duplicate=True and the pool fuses one upload, also
        after a restart of the journaled pool."""
        A, b = _int_rows(np.random.default_rng(11), 8, 6)
        pool = _pool(journal_dir=tmp_path)
        disp = transport.WireDispatcher(pool)
        state = {"eaten": False}

        class AckEater:
            def __init__(self):
                self.inner = transport.LoopbackChannel(disp)
                self.bytes_sent = self.bytes_received = 0

            def request(self, data):
                out = self.inner.request(data)
                if (isinstance(wire.decode_frame(data), wire.StatsFrame)
                        and not state["eaten"]):
                    state["eaten"] = True  # applied; the ACK lost in flight
                    raise ConnectionError("ack eaten")
                return out

            def close(self):
                pass

        client = transport.ResilientClient(
            AckEater, tenant="t", retries=3, backoff_s=0.0, jitter=0.0)
        ack = client.upload_stats(compute_stats(A, b), client_id="c0")
        assert ack.ok and ack.duplicate
        assert (client.retries_used, client.duplicate_acks) == (1, 1)
        assert list(pool.get("t").client_ids) == ["c0"]
        ref = _pool()
        ref.create_tenant("t", {"c0": compute_stats(A, b)})
        assert _w(pool, "t").tobytes() == _w(ref, "t").tobytes()
        client.close()
        _crash(pool)
        p2 = _pool(journal_dir=tmp_path)
        assert p2.replayed_frames == 1
        assert _w(p2, "t").tobytes() == _w(ref, "t").tobytes()
        _crash(p2)

    def test_terminal_rejection_not_retried(self, tmp_path):
        rng = np.random.default_rng(12)
        with _pool(journal_dir=tmp_path) as pool:
            disp = transport.WireDispatcher(pool)
            client = transport.ResilientClient(
                lambda: transport.LoopbackChannel(disp), tenant="t",
                retries=5, backoff_s=0.0, jitter=0.0)
            client.upload_stats(compute_stats(*_int_rows(rng, 4, 6)))
            with pytest.raises(transport.RejectedError) as ei:
                client.upload_stats(compute_stats(*_int_rows(rng, 4, 3)))
            assert not ei.value.ack.retryable
            assert client.retries_used == 0
            client.close()
        # the refused frame was never journaled
        (seq,) = DurableStore(tmp_path).segment_seqs()
        assert scan_segment(tmp_path / f"wal_{seq:08d}.log").records == ()


# -- the dedup key across CRC32 collisions and restarts -------------------------

def _forge_crc_collision(cid="evil", d=16):
    """Two distinct same-client DELTA uploads whose frame CRC32s collide
    (the reference's construction: GF(2) elimination over mantissa bit
    flips of the longer frame's A values)."""
    import struct
    import zlib

    rng = np.random.default_rng(0xC011)
    A1 = rng.integers(-3, 4, (2, d)).astype(np.float32)
    b1 = rng.integers(-3, 4, (2,)).astype(np.float32)
    raw1 = wire.encode_frame(
        wire.DeltaRowsFrame(A=A1, b=b1, client_id=cid, wire_dtype="f32"))
    A2 = rng.integers(-3, 4, (3, d)).astype(np.float32)
    b2 = rng.integers(-3, 4, (3,)).astype(np.float32)
    raw2 = wire.encode_frame(
        wire.DeltaRowsFrame(A=A2, b=b2, client_id=cid, wire_dtype="f32"))

    body = bytearray(raw2[:-4])
    base = zlib.crc32(bytes(body)) & 0xFFFFFFFF
    target = wire.frame_crc(raw1)
    a_off = wire.HEADER_BYTES + 8 + 2 + len(cid.encode())
    positions = [a_off + 4 * i + byte for i in range(3 * d) for byte in (0, 1)]
    syndromes = []
    for byte_i in positions:
        mod = bytearray(body)
        mod[byte_i] ^= 1
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
        hb = v.bit_length() - 1
        assert hb in pivots, "syndromes did not span GF(2)^32"
        pv, pm = pivots[hb]
        v, mask = v ^ pv, mask ^ pm
    for i, byte_i in enumerate(positions):
        if mask >> i & 1:
            body[byte_i] ^= 1
    crc = zlib.crc32(bytes(body)) & 0xFFFFFFFF
    return raw1, bytes(body) + struct.pack("<I", crc)


class TestDedupCollisionResistance:
    def test_forged_collision_is_real(self):
        raw1, raw2 = _forge_crc_collision()
        assert raw1 != raw2 and len(raw1) != len(raw2)
        assert wire.frame_crc(raw1) == wire.frame_crc(raw2)
        f1, f2 = wire.decode_frame(raw1), wire.decode_frame(raw2)
        assert f1.client_id == f2.client_id == "evil"
        assert f1.A.shape == (2, 16) and f2.A.shape == (3, 16)

    def test_colliding_pair_both_fuse_neither_falsely_duplicate(self,
                                                                tmp_path):
        raw1, raw2 = _forge_crc_collision()
        pool = _pool(journal_dir=str(tmp_path / "j"))
        ack1, ack2 = _admit_raw(pool, "t", raw1), _admit_raw(pool, "t", raw2)
        assert ack1.ok and not ack1.duplicate
        assert ack2.ok and not ack2.duplicate
        assert int(pool.get("t").backend.count) == 5     # 2 + 3 rows fused
        for raw in (raw1, raw2):
            ack = _admit_raw(pool, "t", raw)
            assert ack.ok and ack.duplicate
        assert int(pool.get("t").backend.count) == 5
        pool.close()

    def test_collision_dedup_survives_restart(self, tmp_path):
        raw1, raw2 = _forge_crc_collision()
        pool = _pool(journal_dir=str(tmp_path / "j"))
        _admit_raw(pool, "t", raw1)
        _admit_raw(pool, "t", raw2)
        pool.snapshot()
        pool.close()
        p2 = _pool(journal_dir=str(tmp_path / "j"))
        assert int(p2.get("t").backend.count) == 5
        for raw in (raw1, raw2):
            ack = _admit_raw(p2, "t", raw)
            assert ack.ok and ack.duplicate
        assert int(p2.get("t").backend.count) == 5
        p2.close()

    def test_legacy_2tuple_snapshot_entries_migrate(self, tmp_path):
        """A snapshot of the JAX package's older code holds ``(client_id,
        crc)`` 2-tuples; restored, they still answer a byte-identical
        re-send duplicate=True without re-fusing."""
        A, b = _int_rows(np.random.default_rng(21), 6, 4)
        raw = _stats_raw(A, b, "c0")
        pool = _pool(journal_dir=str(tmp_path / "j"))
        _admit_raw(pool, "t", raw)
        pool.snapshot()
        pool.close()

        commits = sorted((tmp_path / "j" / "snapshots").glob("commit_*.json"))
        meta = json.loads(commits[-1].read_text())
        for tm in meta["tenants"]:
            tm["dedup"] = [[e[0], e[3]] for e in tm["dedup"]]
            tm.pop("moments", None)
        commits[-1].write_text(json.dumps(meta, sort_keys=True))

        p2 = _pool(journal_dir=str(tmp_path / "j"))
        assert int(p2.get("t").backend.count) == 6
        ack = _admit_raw(p2, "t", raw)
        assert ack.ok and ack.duplicate
        assert int(p2.get("t").backend.count) == 6
        assert list(p2.get("t").client_ids) == ["c0"]
        p2.close()


# -- across packages -----------------------------------------------------------

def _cross_workload(seed):
    """Dense STATS (one with moments), a DELTA, a drop and a restore, and a
    sketch tenant: frames both packages decode to the same state."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(3):
        A, b = _int_rows(rng, 6, 7)
        frame = wire.StatsFrame.from_stats(compute_stats(A, b),
                                           client_id=f"c{i}", moments=i == 1)
        out.append(("dense", wire.encode_frame(frame, dtype="f32")))
    A, b = _int_rows(rng, 3, 7)
    out.append(("dense", wire.encode_frame(wire.DeltaRowsFrame(
        A=A.numpy(), b=b.numpy(), client_id="rows"), dtype="f32")))
    out.append(("dense", wire.encode_frame(wire.ControlFrame("drop", "c0"))))
    out.append(("dense", wire.encode_frame(wire.ControlFrame("restore", "c0"))))
    sketch = FeatureMap("sketch", seed=5, d_orig=10, m=4)
    for i in range(2):
        out.append(("sk", _feature_raw(sketch, *_int_rows(rng, 8, 10), f"p{i}")))
    return out


def _feed(pool, frames, snapshot_at=None, placement="dense"):
    """Admit the frames in order; the "dense" tenant takes ``placement``."""
    for i, (tenant, raw) in enumerate(frames):
        assert _admit_raw(pool, tenant, raw,
                          placement=placement if tenant == "dense" else "dense").ok
        if i == snapshot_at:
            pool.snapshot()


def _fused(pool, name):
    s = pool.stats(name)
    return [np.asarray(x) for x in (s.gram, s.moment, s.count)]


class TestAcrossPackages:
    @pytest.mark.parametrize("snapshot_at", [None, 3])
    def test_jax_journal_restores_into_the_port(self, tmp_path, snapshot_at):
        frames = _cross_workload(40)
        jp = JEnginePool(journal_dir=str(tmp_path))
        _feed(jp, frames, snapshot_at)
        want = {n: _fused(jp, n) for n in jp.tenant_names}
        _crash(jp)

        pp = _pool(journal_dir=str(tmp_path))
        assert pp.restored_tenants == (0 if snapshot_at is None else 1)
        assert set(pp.tenant_names) == set(want)
        for n, arrays in want.items():
            for got, w in zip(_fused(pp, n), arrays):
                assert got.tobytes() == w.astype(got.dtype).tobytes(), n
        assert pp.tenant("sk").kind == "sketched"
        assert set(pp.get("dense").client_ids) == {"c0", "c1", "c2", "rows"}
        assert pp.ledger()["wire_upload_bytes"] == jp.ledger()["wire_upload_bytes"]
        # the JAX pool's dedup keys keep deduplicating in the port
        assert _admit_raw(pp, frames[0][0], frames[0][1]).duplicate
        _crash(pp)

    @pytest.mark.parametrize("snapshot_at", [None, 3])
    def test_port_journal_restores_into_jax(self, tmp_path, snapshot_at):
        frames = _cross_workload(41)
        pp = _pool(journal_dir=str(tmp_path))
        _feed(pp, frames, snapshot_at)
        want = {n: _fused(pp, n) for n in pp.tenant_names}
        _crash(pp)

        jp = JEnginePool(journal_dir=str(tmp_path))
        assert jp.restored_tenants == (0 if snapshot_at is None else 1)
        for n, arrays in want.items():
            for got, w in zip(_fused(jp, n), arrays):
                assert got.tobytes() == w.astype(got.dtype).tobytes(), n
        assert jp.tenant("sk").kind == "sketched"
        assert jp.ledger()["wire_upload_bytes"] == pp.ledger()["wire_upload_bytes"]
        assert _admit_raw(jp, frames[1][0], frames[1][1]).duplicate
        _crash(jp)

    @pytest.mark.parametrize("snapshot_at", [None, 3])
    @pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
    def test_sharded_tenant_restores_across_packages(self, tmp_path, direction,
                                                     snapshot_at):
        """A journal with a sharded tenant (its placement in the snapshot,
        or ``journal_placement`` for a replay no snapshot covers) restores
        in the other package as a sharded tenant, fused statistics bitwise."""
        import warnings

        def jpool():
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")   # a 1 x 1 mesh in process
                return JEnginePool(journal_dir=str(tmp_path),
                                   journal_placement="sharded")

        def ppool():
            return _pool(journal_dir=str(tmp_path), journal_placement="sharded")

        first, second = (jpool, ppool) if direction == "jax_to_port" else (ppool, jpool)
        frames = _cross_workload(44)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            a = first()
            _feed(a, frames, snapshot_at, placement="sharded")
        assert a.tenant("dense").backend_name == "sharded"
        want = {n: _fused(a, n) for n in a.tenant_names}
        _crash(a)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            b = second()
        assert b.tenant("dense").backend_name == "sharded"
        assert b.tenant("dense").placement == "sharded"
        assert b.meshes_built == 1
        for n, arrays in want.items():
            for got, w in zip(_fused(b, n), arrays):
                assert got.tobytes() == w.astype(got.dtype).tobytes(), n
        _crash(b)

    def test_restored_sharded_solves_equal_the_uncrashed_pool(self, tmp_path):
        frames = _cross_workload(45)
        never = _pool()
        _feed(never, frames, placement="sharded")
        p1 = _pool(journal_dir=str(tmp_path))
        _feed(p1, frames[:4], snapshot_at=2, placement="sharded")
        _crash(p1)
        p2 = _pool(journal_dir=str(tmp_path))
        _feed(p2, frames[4:], placement="sharded")
        assert p2.tenant("dense").backend_name == "sharded"
        assert p2.replayed_frames == 1 and p2.restored_tenants == 1
        for sigma in (0.01, SIGMA):
            w, w_never = p2.solve("dense", sigma), never.solve("dense", sigma)
            assert torch.equal(w, w_never)
        _crash(p2)

    def test_the_two_packages_write_the_same_files(self, tmp_path):
        """The same frames in the same order: byte-identical WAL segments
        (the record format is the wire encoding), the same commit record
        and the same npz arrays under the same keys."""
        frames = _cross_workload(42)
        jp = JEnginePool(journal_dir=str(tmp_path / "jax"))
        pp = _pool(journal_dir=str(tmp_path / "port"))
        for pool in (jp, pp):
            _feed(pool, frames[:5])
            pool.snapshot()
            _feed(pool, frames[5:])
            _crash(pool)
        for name in ("wal_00000001.log",):
            a = (tmp_path / "jax" / name).read_bytes()
            assert a and a == (tmp_path / "port" / name).read_bytes()
        snap = pathlib.Path("snapshots")
        for name in ("commit_00000001.json", "step_00000001.json"):
            assert ((tmp_path / "jax" / snap / name).read_text()
                    == (tmp_path / "port" / snap / name).read_text()), name
        with np.load(tmp_path / "jax" / snap / "step_00000001.npz") as a, \
                np.load(tmp_path / "port" / snap / "step_00000001.npz") as b:
            assert sorted(a.files) == sorted(b.files)
            for k in a.files:
                assert a[k].tobytes() == b[k].tobytes(), k

    def test_segments_match_before_any_snapshot(self, tmp_path):
        frames = _cross_workload(43)
        for pkg, pool in (("jax", JEnginePool(journal_dir=str(tmp_path / "jax"))),
                          ("port", _pool(journal_dir=str(tmp_path / "port")))):
            _feed(pool, frames)
            _crash(pool)
        a = (tmp_path / "jax" / "wal_00000000.log").read_bytes()
        b = (tmp_path / "port" / "wal_00000000.log").read_bytes()
        assert len(scan_segment(tmp_path / "port" / "wal_00000000.log").records) \
            == len(frames)
        assert a == b


# -- subprocesses: SIGKILL mid-ingest, restart bitwise; SIGTERM ------------------

def _spawn_serve(journal_dir, *extra):
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.serve", "--mode", "fusion",
         "--listen", "0", "--device", "cpu", "--serve-timeout", "120",
         "--sigma", str(SIGMA), "--journal-dir", str(journal_dir),
         *map(str, extra)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env=_env(), cwd=str(REPO))
    port, head = None, []
    for _ in range(50):                      # a bounded readline loop
        line = proc.stdout.readline()
        if not line:
            break
        head.append(line)
        m = re.search(r"listening on 127\.0\.0\.1:(\d+)", line)
        if m:
            port = int(m.group(1))
            break
    if port is None:
        proc.kill()
        _, err = proc.communicate(timeout=30)
        pytest.fail(f"no listening line: {''.join(head)}{err}")
    return proc, port, "".join(head)


def _serve_report(proc, timeout=120):
    out, err = proc.communicate(timeout=timeout)
    assert proc.returncode == 0, err
    m = re.search(r"\[serve_wire\] report (.*)", out)
    assert m, out + err
    return json.loads(m.group(1)), out


class TestServeCrashRecovery:
    def test_sigkill_restart_bit_identical_zero_reuploads(self, tmp_path):
        """Dense uploads to a journaled server process, SIGKILL with half a
        frame in flight, a restart on the same directory: its report's
        weights equal an uncrashed in-process pool's bitwise, and its
        ledger shows every original byte with zero re-uploads."""
        uploads = [u for u in _mixed_workload(seed=31)
                   if u[0] in ("dense", "wide")]
        jdir = tmp_path / "journal"
        proc, port, _ = _spawn_serve(jdir, "--expect-uploads", 999,
                                     "--snapshot-every", 3)
        try:
            sent_bytes = 0
            for tenant, raw in uploads:
                chan = transport.TCPChannel("127.0.0.1", port, timeout_s=60)
                client = transport.FrameClient(chan)
                client.hello(tenant, ("f32",))
                reply = wire.decode_frame(chan.request(raw))
                assert isinstance(reply, wire.AckFrame) and reply.ok
                sent_bytes += len(raw)
                client.close()
            torn = socket.create_connection(("127.0.0.1", port), timeout=10)
            torn.sendall(uploads[0][1][: len(uploads[0][1]) // 2])
            proc.kill()                                      # SIGKILL
            proc.communicate(timeout=30)
            torn.close()
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.communicate(timeout=30)

        ref = _pool()
        for tenant, raw in uploads:
            _admit_raw(ref, tenant, raw)
        ref_w = {t: _w(ref, t).astype(np.float64).tolist()
                 for t in ref.tenant_names}

        proc2, _, head = _spawn_serve(jdir, "--serve-timeout", 1)
        try:
            report, _ = _serve_report(proc2)
        finally:
            if proc2.poll() is None:
                proc2.kill()
                proc2.communicate(timeout=30)
        assert "recovered" in head
        pool = report["pool"]
        assert pool["restored_tenants"] + pool["replayed_frames"] > 0
        assert sorted(report["tenants"]) == sorted(ref_w)
        for t, w in ref_w.items():
            assert report["weights"][t] == w, t       # bitwise floats
        assert report["transport"]["uploads_admitted"] == 0
        assert report["connections_total"] == 0
        assert report["ledger"]["wire_upload_bytes"] == sent_bytes

    def test_sigterm_final_snapshot_then_zero_replay(self, tmp_path):
        raw = _stats_raw(*_int_rows(np.random.default_rng(32), 8, 6), "c0")
        jdir = tmp_path / "journal"
        proc, port, _ = _spawn_serve(jdir, "--expect-uploads", 999)
        try:
            chan = transport.TCPChannel("127.0.0.1", port, timeout_s=60)
            client = transport.FrameClient(chan)
            client.hello("t", ("f32",))
            assert wire.decode_frame(chan.request(raw)).ok
            client.close()
            proc.send_signal(signal.SIGTERM)
            report, _ = _serve_report(proc)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.communicate(timeout=30)
        assert report["sigterm"] is True
        # the final snapshot runs at pool.close(), after the report: the
        # proof it landed is a restart that replays nothing
        p2 = _pool(journal_dir=jdir)
        assert p2.restored_tenants == 1
        assert p2.replayed_frames == 0
        assert int(p2.get("t").backend.count) == 8
        _crash(p2)
