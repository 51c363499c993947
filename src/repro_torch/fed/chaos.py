"""Seeded fault injection for the wire transports (the chaos harness).

Durability and retry logic are only trustworthy under the failures they
claim to survive, so this module makes those failures *reproducible*: every
fault — dropped requests, lost ACKs, duplicated frames, bit corruption,
delays, mid-frame connection kills, stale out-of-order retransmits — is
drawn from one seeded ``random.Random``, so a failing schedule replays
exactly from its seed.

Two injection points, same :class:`ChaosConfig`:

  * :class:`ChaosChannel` — wraps any request/reply channel (loopback or
    TCP) and injects faults in-process. Fast, no sockets needed; the unit
    harness for ``ResilientClient`` + the pool's dedup index.
  * :class:`ChaosProxy` — a real TCP proxy that forwards *frames* (it
    parses the length-prefixed stream), injecting faults on the wire
    between real clients and a real :class:`~repro_torch.fed.transport.FrameServer`.
    Tests and ``chip_smoke.py`` put it in front of a server so real sockets
    carry the faults.

Fault semantics (each drawn independently per request, in a fixed order, so
schedules are stable under rate changes of later faults):

  ============  ==========================================================
  ``drop``      request never reaches the server; connection dies
  ``corrupt``   one seeded bit flipped in the payload (CRC catches it;
                the server answers a retryable error ACK)
  ``kill``      connection dies mid-frame: the server sees a torn stream
                (channel: after the request applied — the lost-ACK case)
  ``duplicate`` the request is delivered twice (retransmit); the second
                copy must come back ``duplicate=True`` server-side
  ``reorder``   the *previous* request is re-delivered after this one (a
                stale retransmit arriving late and out of order)
  ``delay``     delivery stalls for ``delay_s`` first
  ``drop_reply`` request applies, the reply is lost (lost-ACK without
                killing the stream mid-frame)
  ============  ==========================================================
"""
from __future__ import annotations

import dataclasses
import random
import socket
import threading
import time

from repro_torch.fed import wire
from repro_torch.fed.transport import read_frame

# Drawing order: one uniform per fault per request, ALWAYS in this order,
# so a schedule's decisions for fault k are independent of rates k+1..n.
FAULTS = ("drop", "corrupt", "kill", "duplicate", "reorder", "delay",
          "drop_reply")


@dataclasses.dataclass(frozen=True)
class ChaosConfig:
    """Per-fault rates in [0, 1] plus the injected latency."""

    drop: float = 0.0
    corrupt: float = 0.0
    kill: float = 0.0
    duplicate: float = 0.0
    reorder: float = 0.0
    delay: float = 0.0
    drop_reply: float = 0.0
    delay_s: float = 0.005

    def __post_init__(self):
        for f in FAULTS:
            r = getattr(self, f)
            if not 0.0 <= r <= 1.0:
                raise ValueError(f"chaos rate {f}={r} outside [0, 1]")
        if self.delay_s < 0:
            raise ValueError(f"delay_s={self.delay_s} must be >= 0")

    def rate(self, fault: str) -> float:
        return getattr(self, fault)

    @classmethod
    def uniform(cls, rate: float, *, delay_s: float = 0.005) -> "ChaosConfig":
        """Every fault at the same rate (the >=10%-everything pin)."""
        return cls(**{f: rate for f in FAULTS}, delay_s=delay_s)


class ChaosSchedule:
    """The seeded decision stream: which faults hit request #k.

    One ``random.Random(seed)`` consumed in a fixed pattern — ``len(FAULTS)``
    uniforms per request plus one more per fired ``corrupt`` (the bit index)
    — so two runs with the same seed and config fire identical faults at
    identical requests.
    """

    def __init__(self, config: ChaosConfig, seed: int):
        self.config = config
        self.seed = seed
        self._rng = random.Random(seed)
        self._lock = threading.Lock()
        self.requests = 0
        self.fired: dict[str, int] = {f: 0 for f in FAULTS}

    def draw(self, nbytes: int) -> tuple[list[str], int]:
        """Fault decisions for one request of ``nbytes`` encoded bytes.

        Returns ``(faults, corrupt_bit)`` — the faults that fired (in
        drawing order) and, when ``corrupt`` fired, which payload bit to
        flip (always past the header, so the stream stays delimited and
        the CRC — not a desync — is what catches it).
        """
        with self._lock:
            self.requests += 1
            faults = [f for f in FAULTS
                      if self._rng.random() < self.config.rate(f)]
            bit = 0
            if "corrupt" in faults:
                lo = wire.HEADER_BYTES * 8
                bit = self._rng.randrange(lo, max(nbytes * 8, lo + 1))
            for f in faults:
                self.fired[f] += 1
            return faults, bit

    def summary(self) -> dict:
        with self._lock:
            return {"seed": self.seed, "requests": self.requests,
                    "fired": dict(self.fired)}


def flip_bit(data: bytes, bit: int) -> bytes:
    """One-bit corruption (what a bad NIC or cosmic ray does)."""
    i, mask = bit // 8, 1 << (bit % 8)
    if i >= len(data):
        i, mask = len(data) - 1, 1
    out = bytearray(data)
    out[i] ^= mask
    return bytes(out)


class ChaosChannel:
    """Fault-injecting wrapper around any request/reply channel.

    The wrapped channel keeps doing the real work; this layer decides, per
    request, whether the bytes get through intact, twice, late, corrupted,
    or not at all. Failures surface as ``ConnectionError`` — exactly what
    a real dead socket raises — so ``ResilientClient`` exercises its true
    reconnect path. After a ``drop``/``kill`` the channel refuses further
    use until ``reopen()`` (the factory-level reconnect), mirroring a dead
    TCP socket.
    """

    def __init__(self, inner_factory, schedule: ChaosSchedule, *,
                 sleep=time.sleep):
        self._factory = inner_factory
        self.schedule = schedule
        self._sleep = sleep
        self._inner = inner_factory()
        self._dead = False
        self._last_request: bytes | None = None
        self.bytes_sent = 0
        self.bytes_received = 0

    def reopen(self) -> "ChaosChannel":
        if self._dead:
            self._inner.close()
            self._inner = self._factory()
            self._dead = False
        return self

    def request(self, data: bytes) -> bytes:
        if self._dead:
            raise ConnectionError("chaos: connection is dead (reopen first)")
        faults, bit = self.schedule.draw(len(data))
        self.bytes_sent += len(data)
        if "delay" in faults:
            self._sleep(self.schedule.config.delay_s)
        if "drop" in faults:
            # Never reaches the server; the connection is gone.
            self._dead = True
            raise ConnectionError("chaos: request dropped, connection lost")
        payload = flip_bit(data, bit) if "corrupt" in faults else data
        reply = self._inner.request(payload)
        if "duplicate" in faults:
            # Network-level retransmit: the server sees the frame twice;
            # the client sees one exchange. The dupe's reply is discarded.
            self._inner.request(payload)
        if "reorder" in faults and self._last_request is not None:
            # A stale copy of the PREVIOUS request arrives late, after
            # newer traffic — out-of-order delivery the dedup must absorb.
            self._inner.request(self._last_request)
        self._last_request = data
        if "kill" in faults:
            # Applied server-side, ACK lost, stream dead: the lost-ACK
            # crash window. The retry MUST come back duplicate=True.
            self._dead = True
            raise ConnectionError("chaos: connection killed before reply")
        if "drop_reply" in faults:
            raise ConnectionError("chaos: reply lost")
        self.bytes_received += len(reply)
        return reply

    def close(self) -> None:
        self._inner.close()


def chaos_channel_factory(inner_factory, schedule: ChaosSchedule, *,
                          sleep=time.sleep):
    """A channel factory for ``ResilientClient``: one persistent
    ``ChaosChannel`` whose reconnects share a single fault schedule (a
    fresh schedule per reconnect would let a retry storm reset its luck)."""
    chan = ChaosChannel(inner_factory, schedule, sleep=sleep)

    def factory():
        return chan.reopen()

    return factory


class ChaosProxy:
    """A seeded byte-mangling TCP proxy in front of a real frame server.

    Forwards at *frame* granularity (it parses the length-prefixed stream),
    so faults hit exactly one protocol unit: a dropped frame, a duplicated
    frame, a payload bit flip, a mid-frame kill (half the frame's bytes are
    sent upstream, then both sides close — the torn-write signature the
    journal's CRC scan must truncate). One upstream connection per client
    connection; strict request/reply keeps pumping trivial.
    """

    def __init__(self, upstream_host: str, upstream_port: int,
                 schedule: ChaosSchedule, *, host: str = "127.0.0.1",
                 port: int = 0, timeout_s: float = 30.0):
        self.upstream = (upstream_host, upstream_port)
        self.schedule = schedule
        self.timeout_s = timeout_s
        self._listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._listener.bind((host, port))
        self._listener.listen(32)
        self.host, self.port = self._listener.getsockname()[:2]
        self._stop = threading.Event()
        self._accept_thread: threading.Thread | None = None

    def start(self) -> "ChaosProxy":
        if self._accept_thread is None:
            self._accept_thread = threading.Thread(
                target=self._accept_loop, name=f"ChaosProxy-{self.port}",
                daemon=True)
            self._accept_thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        try:
            self._listener.close()
        except OSError:
            pass
        if self._accept_thread is not None:
            self._accept_thread.join(timeout=5.0)
            self._accept_thread = None

    def __enter__(self) -> "ChaosProxy":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    def _accept_loop(self) -> None:
        self._listener.settimeout(0.1)
        while not self._stop.is_set():
            try:
                conn, _ = self._listener.accept()
            except socket.timeout:
                continue
            except OSError:
                break
            threading.Thread(target=self._pump, args=(conn,),
                             daemon=True).start()

    def _pump(self, client: socket.socket) -> None:
        try:
            up = socket.create_connection(self.upstream,
                                          timeout=self.timeout_s)
        except OSError:
            client.close()
            return
        for s in (client, up):
            s.settimeout(self.timeout_s)
            s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        prev: bytes | None = None
        try:
            while not self._stop.is_set():
                try:
                    data = read_frame(client)
                except (ConnectionError, OSError, socket.timeout,
                        wire.WireError):
                    return
                faults, bit = self.schedule.draw(len(data))
                if "delay" in faults:
                    time.sleep(self.schedule.config.delay_s)
                if "drop" in faults:
                    return                      # frame vanishes, conn dies
                if "kill" in faults:
                    # Torn write: half a frame reaches the server, then the
                    # stream dies. What the journal scan calls a crash tail.
                    try:
                        up.sendall(data[:max(len(data) // 2, 1)])
                    except OSError:
                        pass
                    return
                payload = (flip_bit(data, bit) if "corrupt" in faults
                           else data)
                try:
                    up.sendall(payload)
                    reply = read_frame(up)
                    if "duplicate" in faults:
                        up.sendall(payload)     # retransmit; eat its reply
                        read_frame(up)
                    if "reorder" in faults and prev is not None:
                        # A stale copy of the previous frame arrives late,
                        # after newer traffic (per-connection, so frames
                        # from different sessions never interleave).
                        up.sendall(prev)
                        read_frame(up)
                except (ConnectionError, OSError, socket.timeout,
                        wire.WireError):
                    return
                prev = data
                if "drop_reply" in faults:
                    return                      # applied upstream, ACK lost
                try:
                    client.sendall(reply)
                except OSError:
                    return
        finally:
            for s in (up, client):
                try:
                    s.close()
                except OSError:
                    pass
