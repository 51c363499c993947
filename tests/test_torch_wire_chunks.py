"""Streaming multi-frame uploads in the port: the chunk codec and transport.

Mirrors tests/test_wire_chunks.py on ``repro_torch.fed`` with a port pool
on the CPU, and pins the codec to the reference's: ``split_frame`` cuts the
same chunks byte for byte, each package joins the other's chunks back to
the same canonical frame, and a chunked upload fuses to the bits of an
in-process admission of the same statistics.
"""
import numpy as np
import pytest
import torch

from repro.fed import wire as jwire
from repro_torch.core.sufficient_stats import compute_stats
from repro_torch.fed import transport, wire
from repro_torch.server import EnginePool

SIGMA = 0.1


def _int_rows(rng, n=8, d=6):
    A = rng.integers(-3, 4, (n, d)).astype(np.float32)
    b = rng.integers(-3, 4, (n,)).astype(np.float32)
    return torch.from_numpy(A), torch.from_numpy(b)


def _stats_raw(rng, client_id="c0", d=6):
    frame = wire.StatsFrame.from_stats(compute_stats(*_int_rows(rng, d=d)),
                                       client_id=client_id)
    return wire.encode_frame(frame, dtype="f32")


def _pool():
    return EnginePool(device="cpu")


# -- codec ---------------------------------------------------------------------

class TestChunkCodec:
    @pytest.mark.parametrize("cap", [1, 7, 64, 200])
    def test_split_join_byte_identical(self, cap):
        raw = _stats_raw(np.random.default_rng(0), d=10)
        chunks = wire.split_frame(raw, max_chunk_payload=cap)
        assert len(chunks) > 1
        parts = []
        for i, c in enumerate(chunks):
            ftype, dtag, flags, payload = wire.chunk_parts(c)
            assert ftype == wire.FT_STATS
            assert len(payload) <= cap
            assert flags == (wire.FLAG_CONTINUED
                             if i < len(chunks) - 1 else 0)
            parts.append(payload)
        assert wire.join_chunks(wire.FT_STATS, dtag, parts) == raw

    @pytest.mark.parametrize("cap", [1, 7, 64, 200, 1 << 20])
    @pytest.mark.parametrize("dtype", ["f32", "f64", "bf16"])
    def test_chunks_equal_reference(self, cap, dtype):
        """Both packages cut the same chunks, and join each other's."""
        rng = np.random.default_rng(cap)
        raw = wire.encode_frame(wire.DeltaRowsFrame(
            A=rng.standard_normal((5, 9)), b=rng.standard_normal(5),
            client_id="rows"), dtype=dtype)
        chunks = wire.split_frame(raw, max_chunk_payload=cap)
        assert chunks == jwire.split_frame(raw, max_chunk_payload=cap)
        parts = [jwire.chunk_parts(c)[3] for c in chunks]
        ftype, dtag = wire.chunk_parts(chunks[0])[:2]
        assert wire.join_chunks(ftype, dtag, parts) == raw
        assert jwire.join_chunks(ftype, dtag, parts) == raw

    def test_small_frame_passes_through_unchanged(self):
        raw = _stats_raw(np.random.default_rng(1))
        assert wire.split_frame(raw, max_chunk_payload=1 << 20) == [raw]

    def test_intermediate_chunk_decode_is_typed(self):
        raw = _stats_raw(np.random.default_rng(2), d=10)
        first = wire.split_frame(raw, max_chunk_payload=16)[0]
        with pytest.raises(wire.ContinuationChunk):
            wire.decode_frame(first)

    def test_terminal_chunk_alone_is_garbage_not_a_crash(self):
        raw = _stats_raw(np.random.default_rng(3), d=10)
        last = wire.split_frame(raw, max_chunk_payload=16)[-1]
        with pytest.raises(wire.WireError):
            wire.decode_frame(last)

    def test_nonchunkable_type_rejected(self):
        raw = wire.encode_frame(wire.SolveFrame(sigma=0.5))
        with pytest.raises(wire.BadFrameType):
            wire.split_frame(raw, max_chunk_payload=1)

    def test_already_flagged_frame_rejected(self):
        raw = _stats_raw(np.random.default_rng(4), d=10)
        chunk = wire.split_frame(raw, max_chunk_payload=16)[0]
        with pytest.raises(wire.PayloadError):
            wire.split_frame(chunk, max_chunk_payload=8)

    def test_bad_cap_rejected(self):
        raw = _stats_raw(np.random.default_rng(5))
        with pytest.raises(wire.BadLength):
            wire.split_frame(raw, max_chunk_payload=0)

    def test_join_overflow_rejected(self):
        with pytest.raises(wire.BadLength):
            wire.join_chunks(wire.FT_STATS, 0,
                             [b"\x00" * (wire.MAX_REASSEMBLED_BYTES // 4 + 1)
                              ] * 5)

    def test_chunk_crc_guards_transit_damage(self):
        raw = _stats_raw(np.random.default_rng(6), d=10)
        chunk = bytearray(wire.split_frame(raw, max_chunk_payload=16)[0])
        chunk[wire.HEADER_BYTES + 2] ^= 0x40
        with pytest.raises(wire.WireError):
            wire.chunk_parts(bytes(chunk))


# -- transport reassembly ------------------------------------------------------

def _loop_client(disp, tenant, **kw):
    cl = transport.FrameClient(transport.LoopbackChannel(disp), **kw)
    cl.hello(tenant)
    return cl


class TestTransportReassembly:
    def test_chunked_upload_admits_and_dedups_with_unchunked(self):
        rng = np.random.default_rng(0)
        stats = compute_stats(*_int_rows(rng, d=8))
        with _pool() as pool:
            disp = transport.WireDispatcher(pool)
            chunky = _loop_client(disp, "t", max_chunk_payload=16)
            ack = chunky.upload_stats(stats, client_id="c0")
            assert ack.ok and not ack.duplicate
            assert disp.chunks_received > 1
            assert disp.frames_reassembled == 1

            plain = _loop_client(disp, "t")
            ack2 = plain.upload_stats(stats, client_id="c0")
            assert ack2.ok and ack2.duplicate
            assert pool.tenant("t").wire_frames == 1

            with _pool() as ref:
                ref.create_tenant("t", {"c0": stats})
                got = pool.solve_lifted("t", SIGMA).numpy()
                want = ref.solve_lifted("t", SIGMA).numpy()
                assert got.tobytes() == want.tobytes()
                for a, b in ((pool.stats("t").gram, ref.stats("t").gram),
                             (pool.stats("t").moment, ref.stats("t").moment)):
                    assert a.numpy().tobytes() == b.numpy().tobytes()

    def test_budget_overrun_is_terminal_rejection(self):
        rng = np.random.default_rng(1)
        with _pool() as pool:
            disp = transport.WireDispatcher(pool, max_reassembly_bytes=64)
            chunky = _loop_client(disp, "t", max_chunk_payload=32)
            with pytest.raises(transport.RejectedError) as ei:
                chunky.upload_stats(compute_stats(*_int_rows(rng, d=12)),
                                    client_id="big")
            assert not ei.value.ack.retryable
            assert "budget" in ei.value.ack.message
            assert pool.tenant_names == ()

    def test_reassembly_cap_defaults_to_the_pool_budget(self):
        with EnginePool(device="cpu", stat_budget_bytes=12345) as pool:
            assert transport.WireDispatcher(pool).max_reassembly_bytes == 12345
        with _pool() as pool:
            assert transport.WireDispatcher(pool).max_reassembly_bytes == \
                4 * wire.MAX_PAYLOAD_BYTES

    def test_mid_sequence_type_change_rejected(self):
        rng = np.random.default_rng(2)
        raw = _stats_raw(rng, d=10)
        chunks = wire.split_frame(raw, max_chunk_payload=16)
        with _pool() as pool:
            disp = transport.WireDispatcher(pool)
            chan = transport.LoopbackChannel(disp)
            cl = transport.FrameClient(chan)
            cl.hello("t")
            assert wire.decode_frame(chan.request(chunks[0])).ok
            alien = wire.encode_frame(wire.DeltaRowsFrame(
                A=np.ones((2, 3), np.float32),
                b=np.ones((2,), np.float32), client_id="x"),
                dtype="f32")
            dchunk = wire.split_frame(alien, max_chunk_payload=8)[0]
            ack = wire.decode_frame(chan.request(dchunk))
            assert not ack.ok and ack.retryable
            assert "sequence violation" in ack.message
            for c in chunks[:-1]:
                assert wire.decode_frame(chan.request(c)).ok
            final = wire.decode_frame(chan.request(chunks[-1]))
            assert final.ok and pool.tenant("t").wire_frames == 1

    def test_damaged_chunk_resets_buffer(self):
        rng = np.random.default_rng(3)
        raw = _stats_raw(rng, d=10)
        chunks = wire.split_frame(raw, max_chunk_payload=16)
        with _pool() as pool:
            disp = transport.WireDispatcher(pool)
            chan = transport.LoopbackChannel(disp)
            cl = transport.FrameClient(chan)
            cl.hello("t")
            assert wire.decode_frame(chan.request(chunks[0])).ok
            bad = bytearray(chunks[1])
            bad[-1] ^= 0xFF
            ack = wire.decode_frame(chan.request(bytes(bad)))
            assert not ack.ok and ack.retryable
            for c in chunks[:-1]:
                assert wire.decode_frame(chan.request(c)).ok
            assert wire.decode_frame(chan.request(chunks[-1])).ok
            assert pool.tenant("t").wire_frames == 1

    def test_reconnect_starts_with_empty_buffer(self):
        rng = np.random.default_rng(4)
        raw = _stats_raw(rng, d=10)
        chunks = wire.split_frame(raw, max_chunk_payload=16)
        with _pool() as pool:
            disp = transport.WireDispatcher(pool)
            chan1 = transport.LoopbackChannel(disp)
            cl1 = transport.FrameClient(chan1)
            cl1.hello("t")
            for c in chunks[:2]:
                assert wire.decode_frame(chan1.request(c)).ok
            cl1.close()

            chan2 = transport.LoopbackChannel(disp)
            cl2 = transport.FrameClient(chan2)
            cl2.hello("t")
            for c in chunks[:-1]:
                assert wire.decode_frame(chan2.request(c)).ok
            assert wire.decode_frame(chan2.request(chunks[-1])).ok
            assert pool.tenant("t").wire_frames == 1

    def test_chunked_ledger_counts_chunk_bytes(self):
        """The ledger's upload bytes are what crossed the wire: every
        chunk's header and trailer, as the reference counts them."""
        rng = np.random.default_rng(8)
        raw = _stats_raw(rng, d=10)
        with _pool() as pool:
            disp = transport.WireDispatcher(pool)
            chunky = _loop_client(disp, "t", max_chunk_payload=16)
            chunky.upload_raw(raw)
            chunks = wire.split_frame(raw, max_chunk_payload=16)
            assert pool.ledger()["wire_upload_bytes"] == \
                sum(len(c) for c in chunks) == chunky.bytes_uploaded


class TestUploadRaw:
    def test_ships_exact_bytes_and_dedups(self):
        rng = np.random.default_rng(5)
        raw = _stats_raw(rng, client_id="r:0")
        with _pool() as pool:
            disp = transport.WireDispatcher(pool)
            cl = _loop_client(disp, "t")
            ack = cl.upload_raw(raw)
            assert ack.ok and not ack.duplicate
            ack2 = cl.upload_raw(raw)
            assert ack2.ok and ack2.duplicate
            assert pool.tenant("t").wire_frames == 1
            assert pool.tenant("t").duplicates == 1

    def test_chunked_upload_raw_same_dedup_key(self):
        rng = np.random.default_rng(6)
        raw = _stats_raw(rng, d=10)
        with _pool() as pool:
            disp = transport.WireDispatcher(pool)
            chunky = _loop_client(disp, "t", max_chunk_payload=16)
            assert chunky.upload_raw(raw).ok
            plain = _loop_client(disp, "t")
            assert plain.upload_raw(raw).duplicate
            assert pool.tenant("t").wire_frames == 1

    def test_resilient_upload_raw_retries_through_lost_ack(self):
        rng = np.random.default_rng(7)
        raw = _stats_raw(rng)
        with _pool() as pool:
            disp = transport.WireDispatcher(pool)
            state = {"eaten": False}

            class AckEater:
                def __init__(self):
                    self.inner = transport.LoopbackChannel(disp)

                def request(self, data):
                    out = self.inner.request(data)
                    try:
                        is_stats = isinstance(wire.decode_frame(data),
                                              wire.StatsFrame)
                    except wire.WireError:
                        is_stats = False
                    if is_stats and not state["eaten"]:
                        state["eaten"] = True
                        raise ConnectionError("ack eaten")
                    return out

                @property
                def bytes_sent(self):
                    return self.inner.bytes_sent

                @property
                def bytes_received(self):
                    return self.inner.bytes_received

                def close(self):
                    pass

            client = transport.ResilientClient(
                AckEater, tenant="t", retries=3, backoff_s=0.0, jitter=0.0)
            ack = client.upload_raw(raw)
            assert ack.ok and ack.duplicate
            assert client.duplicate_acks == 1
            assert pool.tenant("t").wire_frames == 1
            client.close()
