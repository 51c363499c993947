"""Transports for the wire protocol: in-proc loopback + length-prefixed TCP.

The protocol is strict request/reply: every frame a client sends gets exactly
one reply frame (ACK, negotiated HELLO, or WEIGHTS), so one abstraction
covers both transports — a *channel* with ``request(bytes) -> bytes``:

  * :class:`LoopbackChannel` — no sockets, no threads: the dispatcher's
    session handles the bytes in-process. Same codec, same validation, same
    ledger accounting as TCP; what it removes is only the kernel.
  * :class:`TCPChannel` / :class:`FrameServer` — real sockets over a
    length-prefixed stream. Frames are self-delimiting (the 12-byte header
    carries the payload length), so the server reads exactly one frame's
    bytes, dispatches, and writes exactly one reply; a connection is a
    session (tenant + negotiated dtype live for its duration).

Server-side state machine (:class:`WireDispatcher` -> per-connection
``_Session``): HELLO fixes the session's tenant and negotiates the dtype
(``wire.negotiate``); every other frame is handed to
``EnginePool.admit_frame``, which creates the tenant lazily, ingests
uploads, applies Thm-8 control, and answers SOLVE with a WEIGHTS frame.
Malformed bytes are answered with a typed-error ACK — a hostile or buggy
client cannot take the server down, and (for TCP) a frame whose *header*
cannot be trusted ends the connection, because stream resync is impossible.

``FrameClient`` is the client half used by the tests and ``chip_smoke.py``: negotiate, upload (Thm-4 packed / §IV-F projected / §VI-C rows),
drop/rejoin, solve. It counts its own bytes per direction, so end-to-end
tests can pin the server's ledger against what clients actually sent.
"""
from __future__ import annotations

import logging
import random
import socket
import threading
import time
import traceback
from typing import Callable, Sequence

import numpy as np
import torch

from repro_torch.fed import wire

logger = logging.getLogger(__name__)


class TransportError(RuntimeError):
    """A reply the protocol does not allow (rejection where success was
    required, or an unexpected frame type)."""


class RejectedError(TransportError):
    """A typed server rejection: the reply was a well-formed
    ``AckFrame(ok=False)``. Carries the ACK so callers can branch on its
    ``retryable`` flag — the server's claim about whether a byte-identical
    re-send could succeed (transient corruption / internal error) or is
    pointless (dim mismatch, unknown client, quota)."""

    def __init__(self, ack: wire.AckFrame):
        super().__init__(f"rejected: {ack.message}")
        self.ack = ack


# ACK messages can embed client-controlled text (a 64KB client id inside an
# "unknown client ..." rejection would overflow the codec's u16 string field
# and the encode failure would kill the session). Bound them server-side.
MAX_ACK_MESSAGE_BYTES = 1024


def _bounded_ack(frame):
    if isinstance(frame, wire.AckFrame):
        raw = frame.message.encode("utf-8")
        if len(raw) > MAX_ACK_MESSAGE_BYTES:
            msg = raw[:MAX_ACK_MESSAGE_BYTES].decode("utf-8", "ignore")
            return wire.AckFrame(frame.ok, msg + "...[truncated]",
                                 retryable=frame.retryable,
                                 duplicate=frame.duplicate)
    return frame


# -- server side -------------------------------------------------------------

def default_dtype_preference(dtype=torch.float32) -> tuple[str, ...]:
    """The server-side negotiation order for a pool whose container is
    ``dtype`` (``EnginePool.dtype``).

    A float32 pool lands every admitted array in float32, so negotiating
    f64 would make clients ship 2x the bytes for zero retained precision —
    the policy prefers f32 and keeps f64 as a fallback for f64-only
    clients. A float64 pool really holds f64, and widest-first applies.
    (The JAX package reads this from ``jax_enable_x64``.)
    """
    if dtype == torch.float64:
        return wire.DEFAULT_PREFERENCE          # ("f64", "f32", "bf16")
    return ("f32", "f64", "bf16")


class WireDispatcher:
    """Shared server state: the pool, admission policy, and counters.

    Counter semantics: ``frames_handled``/``frames_rejected`` count frames
    (every handled-and-rejected frame is also handled); ``bytes_in`` counts
    the bytes of *complete* frames received (a corrupt header that aborts
    mid-read is counted as a rejected frame but its partial bytes are not),
    ``bytes_out`` every reply byte sent.
    """

    def __init__(self, pool, *, default_tenant: str = "default",
                 placement: str = "dense",
                 dtype_preference: Sequence[str] | None = None,
                 solve_batcher=None, max_reassembly_bytes: int | None = None):
        self.pool = pool
        self.default_tenant = default_tenant
        self.placement = placement
        self.dtype_preference = (tuple(dtype_preference)
                                 if dtype_preference is not None
                                 else default_dtype_preference(
                                     getattr(pool, "dtype", torch.float32)))
        # Cap on one session's chunk-reassembly buffer (streaming multi-frame
        # uploads). Defaults to the pool's admission budget when it has one —
        # a logical frame the pool could never admit should be refused while
        # it is still arriving, not after it was buffered — else to the
        # single-frame payload cap times a small factor.
        if max_reassembly_bytes is None:
            max_reassembly_bytes = (getattr(pool, "stat_budget_bytes", None)
                                    or 4 * wire.MAX_PAYLOAD_BYTES)
        self.max_reassembly_bytes = int(max_reassembly_bytes)
        # Optional server.batch.SolveBatcher: when present, SOLVE frames
        # route through its micro-batching window so queries from many
        # concurrent sessions coalesce into one cross-tenant stacked sweep.
        # Ownership stays with whoever constructed it (FrameServer when
        # built from ``solve_window_s``).
        self.solve_batcher = solve_batcher
        self._lock = threading.Lock()
        self.frames_handled = 0
        self.frames_rejected = 0
        self.uploads_admitted = 0
        self.duplicates_acked = 0
        self.connection_errors = 0
        self.internal_errors = 0
        self.chunks_received = 0
        self.frames_reassembled = 0
        self.bytes_in = 0
        self.bytes_out = 0
        self._conn_error_logged = False

    def _count(self, **deltas: int) -> None:
        with self._lock:
            for k, v in deltas.items():
                setattr(self, k, getattr(self, k) + v)

    def session(self) -> "_Session":
        return _Session(self)

    def summary(self) -> dict:
        with self._lock:
            out = {
                "frames_handled": self.frames_handled,
                "frames_rejected": self.frames_rejected,
                "uploads_admitted": self.uploads_admitted,
                "duplicates_acked": self.duplicates_acked,
                "connection_errors": self.connection_errors,
                "internal_errors": self.internal_errors,
                "chunks_received": self.chunks_received,
                "frames_reassembled": self.frames_reassembled,
                "bytes_in": self.bytes_in,
                "bytes_out": self.bytes_out,
            }
        if self.solve_batcher is not None:
            out["solve_batcher"] = self.solve_batcher.summary()
        return out


class _Session:
    """Per-connection protocol state: tenant binding, negotiated dtype, and
    the chunk-reassembly buffer for streaming multi-frame uploads.

    Reassembly state is per-session by design: a reconnect starts from an
    empty buffer, so a retrying client that re-sends the whole chunk
    sequence on a fresh connection can never splice onto stale chunks.
    """

    def __init__(self, dispatcher: WireDispatcher):
        self.dispatcher = dispatcher
        self.tenant = dispatcher.default_tenant
        self.dtype = "f32"
        self._chunks: list[bytes] | None = None
        self._chunk_ftype = 0
        self._chunk_dtag = 0
        self._chunk_payload_bytes = 0
        self._chunk_wire_bytes = 0

    def handle(self, data: bytes) -> bytes:
        """One request frame in, one reply frame out. Never raises for
        malformed input — typed rejections come back as error ACKs."""
        d = self.dispatcher
        d._count(frames_handled=1, bytes_in=len(data))
        if self._chunks is not None:
            # Mid-sequence: every frame (including the flags-0 terminal one)
            # belongs to the reassembly until it completes or aborts.
            return self._handle_chunk(data)
        try:
            frame = wire.decode_frame(data)
        except wire.ContinuationChunk:
            return self._handle_chunk(data)
        except wire.WireError as e:
            # Decode failures are transient from the client's view: the
            # frame may have been corrupted in transit, and a clean re-send
            # of the same bytes can succeed (dedup makes the retry safe).
            d._count(frames_rejected=1)
            return self._reply(wire.AckFrame(
                False, f"{type(e).__name__}: {e}", retryable=True))
        return self._dispatch(frame, encoded_len=len(data), raw=data)

    def _reset_reassembly(self) -> None:
        self._chunks = None
        self._chunk_payload_bytes = 0
        self._chunk_wire_bytes = 0

    def _handle_chunk(self, data: bytes) -> bytes:
        """One continuation chunk in (or the terminal frame of a sequence);
        buffers payload slices until the flags-0 chunk completes the logical
        frame, then dispatches it exactly like an unchunked arrival."""
        d = self.dispatcher
        try:
            ftype, dtag, flags, payload = wire.chunk_parts(data)
        except wire.WireError as e:
            # A damaged chunk poisons the whole sequence (slices are
            # positional); the client re-sends the logical frame from the
            # top on a clean buffer.
            self._reset_reassembly()
            d._count(frames_rejected=1)
            return self._reply(wire.AckFrame(
                False, f"{type(e).__name__}: {e}", retryable=True))
        if flags & ~wire.FLAG_CONTINUED or (
                flags and ftype not in wire.CHUNKABLE_FRAME_TYPES):
            self._reset_reassembly()
            d._count(frames_rejected=1)
            return self._reply(wire.AckFrame(
                False, f"invalid chunk flags {flags:#04x} "
                       f"for frame type {ftype:#04x}", retryable=True))
        if self._chunks is None:
            self._chunks = []
            self._chunk_ftype, self._chunk_dtag = ftype, dtag
        elif ftype != self._chunk_ftype or dtag != self._chunk_dtag:
            self._reset_reassembly()
            d._count(frames_rejected=1)
            return self._reply(wire.AckFrame(
                False, "chunk sequence violation: frame type/dtype changed "
                       "mid-reassembly", retryable=True))
        cap = d.max_reassembly_bytes
        if self._chunk_payload_bytes + len(payload) > cap:
            self._reset_reassembly()
            d._count(frames_rejected=1)
            return self._reply(wire.AckFrame(
                False, f"reassembled payload would exceed the admission "
                       f"budget ({cap} bytes)", retryable=False))
        self._chunks.append(payload)
        self._chunk_payload_bytes += len(payload)
        self._chunk_wire_bytes += len(data)
        d._count(chunks_received=1)
        if flags & wire.FLAG_CONTINUED:
            return self._reply(wire.AckFrame(
                True, f"chunk {len(self._chunks)} buffered"))
        raw = wire.join_chunks(self._chunk_ftype, self._chunk_dtag,
                               self._chunks)
        encoded_len = self._chunk_wire_bytes
        self._reset_reassembly()
        try:
            frame = wire.decode_frame(
                raw, max_payload_bytes=wire.MAX_REASSEMBLED_BYTES)
        except wire.WireError as e:
            d._count(frames_rejected=1)
            return self._reply(wire.AckFrame(
                False, f"{type(e).__name__}: {e}", retryable=True))
        d._count(frames_reassembled=1)
        return self._dispatch(frame, encoded_len=encoded_len, raw=raw)

    def _dispatch(self, frame, *, encoded_len: int, raw: bytes) -> bytes:
        d = self.dispatcher
        if isinstance(frame, wire.Hello):
            self.tenant = frame.tenant or self.tenant
            try:
                self.dtype = wire.negotiate(
                    frame.offers, preference=d.dtype_preference)
            except wire.NegotiationError as e:
                d._count(frames_rejected=1)
                return self._reply(wire.AckFrame(False, str(e)))
            return self._reply(wire.Hello(self.tenant, (self.dtype,)))
        if not isinstance(frame, (wire.StatsFrame, wire.ProjectedFrame,
                                  wire.RFFFrame, wire.DeltaRowsFrame,
                                  wire.ControlFrame, wire.SolveFrame)):
            # Well-formed but server-bound-only frame (WEIGHTS/ACK): a typed
            # protocol rejection, not a thread-killing dispatch error.
            d._count(frames_rejected=1)
            return self._reply(wire.AckFrame(
                False, f"unexpected {type(frame).__name__} from client"))
        try:
            if (isinstance(frame, wire.SolveFrame)
                    and d.solve_batcher is not None):
                reply = self._batched_solve(frame)
            else:
                reply = d.pool.admit_frame(self.tenant, frame,
                                           encoded_len=encoded_len,
                                           placement=d.placement, raw=raw)
        except Exception as e:  # noqa: BLE001 - a frame must never kill the
            # session thread; the protocol contract is a typed-error ACK,
            # retryable as the JAX package's. An internal error (a kernel
            # that fails to build or launch, an exhausted card) is counted
            # and logged, never absorbed.
            d._count(frames_rejected=1, internal_errors=1)
            logger.error("internal error admitting %s for tenant %r",
                         type(frame).__name__, self.tenant, exc_info=True)
            return self._reply(wire.AckFrame(
                False, f"internal error: {type(e).__name__}: {e}",
                retryable=True))
        if isinstance(reply, wire.AckFrame) and not reply.ok:
            d._count(frames_rejected=1)
        elif isinstance(reply, wire.AckFrame) and reply.duplicate:
            # A dedup hit fused nothing: counted separately so admission
            # loops ("wait for N uploads") never double-count a retry.
            d._count(duplicates_acked=1)
        elif isinstance(frame, (wire.StatsFrame, wire.ProjectedFrame,
                                wire.RFFFrame, wire.DeltaRowsFrame)):
            d._count(uploads_admitted=1)
        out = wire.encode_frame(_bounded_ack(reply))
        d.pool.record_wire_reply(self.tenant, len(out))
        d._count(bytes_out=len(out))
        return out

    def _batched_solve(self, frame):
        """SOLVE via the micro-batching window: same reply contract as
        ``pool.admit_frame`` — a WEIGHTS frame, or a typed-error ACK for
        protocol-level problems (the session survives either way)."""
        d = self.dispatcher
        if self.tenant not in d.pool:
            return wire.AckFrame(False, f"unknown tenant {self.tenant!r}")
        try:
            w = d.solve_batcher.solve(self.tenant, frame.sigma).cpu().numpy()
        except KeyError:
            # Raced a concurrent drop_tenant between the check and the sweep.
            return wire.AckFrame(False, f"unknown tenant {self.tenant!r}")
        except ValueError as e:
            return wire.AckFrame(False, str(e))
        return wire.WeightsFrame(w=w, sigma=frame.sigma,
                                 wire_dtype=wire.dtype_name(w.dtype))

    def _reply(self, frame) -> bytes:
        out = wire.encode_frame(_bounded_ack(frame))
        self.dispatcher._count(bytes_out=len(out))
        return out


class LoopbackChannel:
    """In-process transport: one session over direct byte hand-off."""

    def __init__(self, dispatcher: WireDispatcher):
        self._session = dispatcher.session()
        self.bytes_sent = 0
        self.bytes_received = 0

    def request(self, data: bytes) -> bytes:
        self.bytes_sent += len(data)
        out = self._session.handle(data)
        self.bytes_received += len(out)
        return out

    def close(self) -> None:
        pass


# -- TCP ---------------------------------------------------------------------

def _read_exact(sock: socket.socket, n: int) -> bytes:
    chunks = []
    while n:
        chunk = sock.recv(n)
        if not chunk:
            raise ConnectionError("peer closed mid-frame"
                                  if chunks or n else "peer closed")
        chunks.append(chunk)
        n -= len(chunk)
    return b"".join(chunks)


def read_frame(sock: socket.socket) -> bytes:
    """Read exactly one frame off a stream socket.

    The header's length field is validated (magic, version, payload cap)
    *before* the payload read, so a length-prefix lie cannot make the
    reader allocate or block for gigabytes.
    """
    header = _read_exact(sock, wire.HEADER_BYTES)
    total = wire.frame_total_length(header)   # raises WireError on bad header
    return header + _read_exact(sock, total - wire.HEADER_BYTES)


class TCPChannel:
    """Client side of the length-prefixed TCP transport."""

    def __init__(self, host: str, port: int, *, timeout_s: float = 30.0):
        self.sock = socket.create_connection((host, port), timeout=timeout_s)
        self.sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self.bytes_sent = 0
        self.bytes_received = 0

    def request(self, data: bytes) -> bytes:
        self.sock.sendall(data)
        self.bytes_sent += len(data)
        out = read_frame(self.sock)
        self.bytes_received += len(out)
        return out

    def close(self) -> None:
        try:
            self.sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        self.sock.close()

    def __enter__(self) -> "TCPChannel":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


class FrameServer:
    """Threaded TCP frame server feeding an ``EnginePool``.

    One accept thread; one daemon thread per connection, each owning a
    ``_Session`` (tenant + negotiated dtype are connection-scoped). ``port=0``
    binds an ephemeral port (``self.port`` is the bound one). Use as a
    context manager or call ``start()``/``stop()``.
    """

    def __init__(self, pool, *, host: str = "127.0.0.1", port: int = 0,
                 conn_timeout_s: float = 120.0,
                 solve_window_s: float | None = None, **dispatcher_kwargs):
        self._batcher = None
        if solve_window_s is not None:
            # Deferred import: fed.transport stays importable without the
            # server package on the path (the pool is always injected).
            from repro_torch.server.batch import SolveBatcher

            self._batcher = SolveBatcher(pool, window_s=solve_window_s)
            dispatcher_kwargs.setdefault("solve_batcher", self._batcher)
        self.dispatcher = WireDispatcher(pool, **dispatcher_kwargs)
        # Per-connection idle budget: generous, because a client may spend
        # tens of seconds of *local* work (Phase 1, kernel builds) between
        # two frames of one session.
        self.conn_timeout_s = conn_timeout_s
        self._listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._listener.bind((host, port))
        self._listener.listen(32)
        self.host, self.port = self._listener.getsockname()[:2]
        self._accept_thread: threading.Thread | None = None
        self._stop = threading.Event()
        self._conn_lock = threading.Lock()
        self._active = 0
        self.connections_total = 0

    @property
    def active_connections(self) -> int:
        with self._conn_lock:
            return self._active

    def start(self) -> "FrameServer":
        if self._accept_thread is not None:
            return self
        if self._batcher is not None:
            self._batcher.start()
        self._accept_thread = threading.Thread(
            target=self._accept_loop, name=f"FrameServer-{self.port}",
            daemon=True)
        self._accept_thread.start()
        return self

    def _accept_loop(self) -> None:
        self._listener.settimeout(0.1)
        while not self._stop.is_set():
            try:
                conn, _ = self._listener.accept()
            except socket.timeout:
                continue
            except OSError:
                break
            with self._conn_lock:
                self._active += 1
                self.connections_total += 1
            threading.Thread(target=self._serve_conn, args=(conn,),
                             daemon=True).start()

    def _serve_conn(self, conn: socket.socket) -> None:
        session = self.dispatcher.session()
        conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        conn.settimeout(self.conn_timeout_s)
        try:
            while not self._stop.is_set():
                try:
                    data = read_frame(conn)
                except (ConnectionError, OSError, socket.timeout):
                    break
                except wire.WireError as e:
                    # The stream cannot be re-synchronized past a corrupt
                    # header: report the typed error, then hang up. Counted
                    # like any other rejected frame (handled + rejected +
                    # reply bytes) so the dispatcher summary stays
                    # consistent with what clients observed. Retryable: the
                    # client reconnects and re-sends on a clean stream.
                    self.dispatcher._count(frames_handled=1,
                                           frames_rejected=1)
                    ack = wire.encode_frame(_bounded_ack(wire.AckFrame(
                        False, f"{type(e).__name__}: {e}", retryable=True)))
                    self.dispatcher._count(bytes_out=len(ack))
                    try:
                        conn.sendall(ack)
                    except OSError:
                        pass
                    break
                try:
                    conn.sendall(session.handle(data))
                except OSError:
                    break
        except Exception:  # noqa: BLE001 - a connection thread must never
            # vanish silently: count the death, log the traceback once per
            # dispatcher (the first occurrence is the diagnostic; repeats
            # under load would just flood the log).
            with self.dispatcher._lock:
                self.dispatcher.connection_errors += 1
                first = not self.dispatcher._conn_error_logged
                self.dispatcher._conn_error_logged = True
            if first:
                logger.error("connection thread died unexpectedly:\n%s",
                             traceback.format_exc())
        finally:
            try:
                conn.close()
            finally:
                with self._conn_lock:
                    self._active -= 1

    def stop(self) -> None:
        self._stop.set()
        try:
            self._listener.close()
        except OSError:
            pass
        if self._accept_thread is not None:
            self._accept_thread.join(timeout=5.0)
            self._accept_thread = None
        if self._batcher is not None:
            self._batcher.stop()

    def __enter__(self) -> "FrameServer":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()


# -- client ------------------------------------------------------------------

class FrameClient:
    """One federated participant over any request/reply channel.

    Tracks bytes per direction AND per role: ``bytes_uploaded`` counts only
    the statistic-bearing frames (STATS / PROJ / DELTA) — the quantity Thm 4
    budgets — while ``bytes_sent``/``bytes_received`` include the control
    plane (HELLO, CONTROL, SOLVE) and downloads.

    ``max_chunk_payload`` turns on streaming multi-frame uploads: an upload
    whose encoded payload exceeds it is shipped as continuation chunks
    (``wire.split_frame``), each awaiting the server's buffering ACK; the
    terminal chunk's reply is the admission ACK for the whole logical frame.
    Uploads that fit stay single-frame and byte-identical.
    """

    def __init__(self, channel, *, max_chunk_payload: int | None = None):
        self.channel = channel
        self.dtype = "f32"
        self.tenant = "default"
        self.max_chunk_payload = max_chunk_payload
        self.bytes_uploaded = 0
        self.frames_sent = 0

    # -- protocol ------------------------------------------------------------

    def hello(self, tenant: str = "default",
              offers: Sequence[str] = ("f32",)) -> str:
        """Open the session: bind the tenant, negotiate the wire dtype."""
        reply = self._roundtrip(wire.Hello(tenant, tuple(offers)))
        if not isinstance(reply, wire.Hello) or len(reply.offers) != 1:
            raise TransportError(f"bad HELLO reply: {reply}")
        chosen = reply.offers[0]
        if chosen not in offers:
            raise TransportError(
                f"server chose {chosen!r}, not among offers {tuple(offers)}")
        self.tenant, self.dtype = reply.tenant, chosen
        return chosen

    def upload_stats(self, stats, client_id: str = "", *,
                     moments: bool = False) -> wire.AckFrame:
        """Thm-4 upload of one client's ``SuffStats`` (packed triangle).

        ``moments=True`` appends the 8-byte MOMENTS section (yty = Σy²) so
        the server can serve inference; the stats must carry ``yty``."""
        frame = wire.StatsFrame.from_stats(stats, client_id=client_id,
                                           moments=moments)
        return self._expect_ack(frame, upload=True)

    def upload_packed(self, packed, client_id: str = "", *,
                      moments: bool = False) -> wire.AckFrame:
        """Thm-4 upload of an already-packed ``fed.PackedStats``."""
        frame = wire.StatsFrame.from_packed(packed, client_id=client_id,
                                            moments=moments)
        return self._expect_ack(frame, upload=True)

    def upload_projected(self, packed, *, d_orig: int, seed: int, rhash: int,
                         client_id: str = "",
                         yty: float | None = None) -> wire.AckFrame:
        """§IV-F upload: m-dim packed stats plus the sketch's identity."""
        frame = wire.ProjectedFrame(
            tri=wire.host_array(packed.tri),
            moment=wire.host_array(packed.moment),
            count=int(packed.count), dim=int(packed.dim), d_orig=d_orig,
            seed=seed, rhash=rhash, client_id=client_id, yty=yty)
        return self._expect_ack(frame, upload=True)

    def upload_rff(self, packed, *, d_orig: int, seed: int, fhash: int,
                   lengthscale: float = 1.0, client_id: str = "",
                   yty: float | None = None) -> wire.AckFrame:
        """§IV-F RFF upload: D-dim packed stats plus the map's identity."""
        frame = wire.RFFFrame(
            tri=wire.host_array(packed.tri),
            moment=wire.host_array(packed.moment),
            count=int(packed.count), dim=int(packed.dim), d_orig=d_orig,
            seed=seed, fhash=fhash, lengthscale=lengthscale,
            client_id=client_id, yty=yty)
        return self._expect_ack(frame, upload=True)

    def stream_rows(self, A, b, client_id: str = "") -> wire.AckFrame:
        """§VI-C delta: ship a raw row batch."""
        frame = wire.DeltaRowsFrame(A=wire.host_array(A),
                                    b=wire.host_array(b), client_id=client_id)
        return self._expect_ack(frame, upload=True)

    def upload_raw(self, raw: bytes) -> wire.AckFrame:
        """Ship pre-encoded upload-frame bytes EXACTLY as given (chunked when
        configured — chunk boundaries never change the reassembled bytes).

        The relay tier's forward path: a durably persisted frame must reach
        upstream byte-identical across process restarts so the dedup key
        ``(client_id, frame CRC)`` is stable no matter which incarnation of
        the relay sends it. Skips the negotiated-dtype re-encode on purpose.
        """
        if self.max_chunk_payload is not None:
            chunks = wire.split_frame(raw,
                                      max_chunk_payload=self.max_chunk_payload)
        else:
            chunks = [raw]
        self.bytes_uploaded += sum(len(c) for c in chunks)
        reply = self._send_chunks(chunks)
        if not isinstance(reply, wire.AckFrame):
            raise TransportError(f"expected ACK, got {type(reply).__name__}")
        if not reply.ok:
            raise RejectedError(reply)
        return reply

    def control(self, op: str, client_id: str) -> wire.AckFrame:
        """Thm-8 control: ``op`` is "drop" or "restore"."""
        return self._expect_ack(wire.ControlFrame(op, client_id))

    def solve(self, sigma: float) -> np.ndarray:
        """Phase-3 query: the fused ridge weights at ``sigma``."""
        reply = self._roundtrip(wire.SolveFrame(float(sigma)))
        if isinstance(reply, wire.AckFrame):
            raise RejectedError(reply)
        if not isinstance(reply, wire.WeightsFrame):
            raise TransportError(f"bad SOLVE reply: {type(reply).__name__}")
        return reply.w

    def close(self) -> None:
        self.channel.close()

    @property
    def bytes_sent(self) -> int:
        return self.channel.bytes_sent

    @property
    def bytes_received(self) -> int:
        return self.channel.bytes_received

    # -- plumbing ------------------------------------------------------------

    def _roundtrip(self, frame, *, upload: bool = False):
        data = wire.encode_frame(frame, dtype=self.dtype)
        if upload and self.max_chunk_payload is not None:
            chunks = wire.split_frame(data,
                                      max_chunk_payload=self.max_chunk_payload)
        else:
            chunks = [data]
        if upload:
            self.bytes_uploaded += sum(len(c) for c in chunks)
        return self._send_chunks(chunks)

    def _send_chunks(self, chunks: Sequence[bytes]):
        for part in chunks[:-1]:
            self.frames_sent += 1
            mid = wire.decode_frame(self.channel.request(part))
            if isinstance(mid, wire.AckFrame) and not mid.ok:
                raise RejectedError(mid)
            if not isinstance(mid, wire.AckFrame):
                raise TransportError(
                    f"expected chunk ACK, got {type(mid).__name__}")
        self.frames_sent += 1
        return wire.decode_frame(self.channel.request(chunks[-1]))

    def _expect_ack(self, frame, *, upload: bool = False) -> wire.AckFrame:
        reply = self._roundtrip(frame, upload=upload)
        if not isinstance(reply, wire.AckFrame):
            raise TransportError(f"expected ACK, got {type(reply).__name__}")
        if not reply.ok:
            raise RejectedError(reply)
        return reply


# -- resilient client --------------------------------------------------------

class ResilientClient:
    """A :class:`FrameClient` that survives crashes, partitions, and lost
    ACKs: reconnect-and-resume with bounded exponential backoff.

    The retry loop leans entirely on the server's idempotency machinery —
    a re-sent frame is byte-identical (same negotiated dtype, deterministic
    encoding), so a retry whose original actually landed (the lost-ACK
    case) answers ``duplicate=True`` and fuses nothing twice. Retryable
    events: connection drops/timeouts, garbage replies, and server ACKs
    with the ``retryable`` flag (transient corruption, internal errors).
    Terminal events: rejections with ``retryable=False`` (dim mismatch,
    unknown client, quota, negotiation) — retrying those re-fails forever.

    Backoff is ``backoff_s * 2**attempt``, capped at ``max_backoff_s``,
    scaled by ``1 + jitter * U(-1, 1)`` from a dedicated seeded
    ``random.Random`` — schedules are reproducible per (seed, attempt
    sequence), never synchronized across clients (pick distinct seeds).
    """

    def __init__(self, channel_factory: Callable[[], object], *,
                 tenant: str = "default",
                 offers: Sequence[str] = ("f32",),
                 retries: int = 5, backoff_s: float = 0.05,
                 jitter: float = 0.5, max_backoff_s: float = 2.0,
                 seed: int = 0, max_chunk_payload: int | None = None,
                 sleep: Callable[[float], None] = time.sleep):
        self._factory = channel_factory
        self._tenant = tenant
        self._offers = tuple(offers)
        self._max_chunk_payload = max_chunk_payload
        self.retries = int(retries)
        self.backoff_s = float(backoff_s)
        self.jitter = float(jitter)
        self.max_backoff_s = float(max_backoff_s)
        self._rng = random.Random(seed)
        self._sleep = sleep
        self.client: FrameClient | None = None
        self.retries_used = 0
        self.reconnects = 0
        self.duplicate_acks = 0
        # Totals folded in from every connection this client has owned.
        self.bytes_uploaded = 0
        self.frames_sent = 0
        self.bytes_sent = 0
        self.bytes_received = 0

    # -- protocol (same surface as FrameClient) ------------------------------

    def hello(self) -> str:
        return self._call(lambda c: c.dtype)

    def upload_stats(self, stats, client_id: str = "", *,
                     moments: bool = False) -> wire.AckFrame:
        return self._call(
            lambda c: c.upload_stats(stats, client_id, moments=moments))

    def upload_packed(self, packed, client_id: str = "", *,
                      moments: bool = False) -> wire.AckFrame:
        return self._call(
            lambda c: c.upload_packed(packed, client_id, moments=moments))

    def upload_projected(self, packed, **kw) -> wire.AckFrame:
        return self._call(lambda c: c.upload_projected(packed, **kw))

    def upload_rff(self, packed, **kw) -> wire.AckFrame:
        return self._call(lambda c: c.upload_rff(packed, **kw))

    def stream_rows(self, A, b, client_id: str = "") -> wire.AckFrame:
        return self._call(lambda c: c.stream_rows(A, b, client_id))

    def upload_raw(self, raw: bytes) -> wire.AckFrame:
        """Byte-identical pre-encoded upload with retry/reconnect: every
        re-send ships the SAME bytes (no dtype re-encode), so a retry whose
        original landed is a guaranteed dedup hit upstream."""
        return self._call(lambda c: c.upload_raw(raw))

    def control(self, op: str, client_id: str) -> wire.AckFrame:
        return self._call(lambda c: c.control(op, client_id))

    def solve(self, sigma: float) -> np.ndarray:
        return self._call(lambda c: c.solve(sigma))

    def close(self) -> None:
        self._drop_connection()

    def __enter__(self) -> "ResilientClient":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    @property
    def dtype(self) -> str:
        return self.client.dtype if self.client is not None else "f32"

    def summary(self) -> dict:
        out = {"retries": self.retries_used,
               "reconnects": self.reconnects,
               "duplicate_acks": self.duplicate_acks,
               "bytes_uploaded": self.bytes_uploaded,
               "frames_sent": self.frames_sent,
               "bytes_sent": self.bytes_sent,
               "bytes_received": self.bytes_received}
        c = self.client
        if c is not None:    # fold the live connection's counters in
            out["bytes_uploaded"] += c.bytes_uploaded
            out["frames_sent"] += c.frames_sent
            out["bytes_sent"] += c.bytes_sent
            out["bytes_received"] += c.bytes_received
        return out

    # -- plumbing ------------------------------------------------------------

    def _connect(self) -> FrameClient:
        if self.client is None:
            client = FrameClient(self._factory(),
                                 max_chunk_payload=self._max_chunk_payload)
            try:
                # Re-HELLO on every (re)connect: the session's tenant binding
                # and negotiated dtype are connection-scoped server state.
                client.hello(self._tenant, self._offers)
            except BaseException:
                client.close()
                raise
            self.client = client
            self.reconnects += 1
        return self.client

    def _drop_connection(self) -> None:
        if self.client is not None:
            self.bytes_uploaded += self.client.bytes_uploaded
            self.frames_sent += self.client.frames_sent
            self.bytes_sent += self.client.bytes_sent
            self.bytes_received += self.client.bytes_received
            try:
                self.client.close()
            except OSError:
                pass
            self.client = None

    def _backoff(self, attempt: int) -> None:
        delay = min(self.backoff_s * (2.0 ** attempt), self.max_backoff_s)
        delay *= 1.0 + self.jitter * self._rng.uniform(-1.0, 1.0)
        if delay > 0:
            self._sleep(delay)

    def _call(self, op: Callable[[FrameClient], object]):
        """Run one protocol operation with retry/reconnect. ``op`` closes
        over frame *inputs*, not encoded bytes: a resend re-encodes under
        the (re)negotiated dtype, which the server dedups by content CRC."""
        last: BaseException | None = None
        for attempt in range(self.retries + 1):
            if attempt:
                self.retries_used += 1
                self._backoff(attempt - 1)
            try:
                out = op(self._connect())
            except RejectedError as e:
                last = e
                if not e.ack.retryable:
                    raise
                continue   # session survived a typed rejection: same conn
            except (ConnectionError, socket.timeout, OSError,
                    wire.WireError, TransportError) as e:
                # Stream-level failure: the connection's state (and whether
                # the request applied) is unknowable — reconnect and re-send;
                # the dedup index makes the ambiguity safe.
                last = e
                self._drop_connection()
                continue
            if isinstance(out, wire.AckFrame) and out.duplicate:
                self.duplicate_acks += 1
            return out
        raise TransportError(
            f"gave up after {self.retries} retries: "
            f"{type(last).__name__}: {last}") from last
