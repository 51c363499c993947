"""Hierarchical aggregation: a journaled pool that forwards its fusion.

Theorem 1 makes one-shot fusion *associative*: the fused ``(G, h)`` of a
group of clients is itself a valid Thm-4 upload, so aggregators compose
into a tree and the root recovers the centralized solution. This module is
the middle tier of that tree:

    clients ──> relay (EnginePool, journaled) ──> root (EnginePool)

A relay admits its regional clients' frames exactly like a root server —
same codec, same dedup, same WAL — and a :class:`RelayForwarder`
periodically ships ONE fused frame upstream per tenant: the *delta* of the
relay's fused statistics since the last forward. Deltas telescope
(``sum of deltas == current fused stats``), so the root's view converges to
the relay's regardless of forwarding cadence, and root ingress is
O(relays), not O(clients).

Crash-safe forward protocol (per tenant, per forward epoch):

  1. snapshot the drained fused stats ``now`` under the tenant lock, moved
     to the host once there, and compute ``delta = now - last`` in numpy at
     the pool's dtype (``last`` = durably recorded stats already forwarded;
     none at epoch 0, whose delta IS ``now``);
  2. durably persist a *pending* record — the exact encoded frame bytes
     plus the ``now`` arrays — via tmp -> fsync -> rename -> dir-fsync
     (the same discipline as ``server.durability``);
  3. send the persisted bytes via ``ResilientClient.upload_raw`` (no
     re-encode: retries and post-restart re-sends are byte-identical);
  4. on the upstream ACK (ok or duplicate), durably *finalize*:
     ``last = now``, epoch += 1, pending cleared.

A crash between (2) and (4) leaves the pending record on disk;
:meth:`RelayForwarder.resume` re-sends those exact bytes on restart. The
upstream dedup key ``(client_id, frame CRC)`` — with the epoch-stamped
``wire.relay_client_id`` — makes every such re-send idempotent: if the
lost-ACK forward actually landed, the root answers ``duplicate=True`` and
fuses nothing twice. The forwarded frame carries the relay's *tier
identity*, which the root's ledger surfaces as ``by_tier["relay_frames"]``.

Tenant kinds forward transparently: a dense tenant's delta ships as a
``StatsFrame``, a §IV-F sketched tenant's as a ``ProjectedFrame`` and an
RFF tenant's as an ``RFFFrame`` — each carrying the tenant's own map
identity, so the root reconstructs (and guards) the same feature space.
Frames whose triangular payload exceeds the single-frame cap stream as
continuation chunks (``max_chunk_payload``).

The frames and the forward-state records are the JAX package's byte for
byte (same file names, npz keys and dtypes), so either package resumes the
other's state directory.
"""
from __future__ import annotations

import dataclasses
import io
import json
import logging
import os
import pathlib
import threading
import time
import traceback
import zlib
from typing import Callable

import numpy as np
import torch

from repro_torch.core.sufficient_stats import SuffStats
from repro_torch.fed import wire
from repro_torch.fed.transport import ResilientClient
from repro_torch.server.durability import fsync_dir

logger = logging.getLogger(__name__)


@dataclasses.dataclass(frozen=True)
class ForwardPolicy:
    """When a tenant's accumulated admissions are worth one upstream frame.

    ``max_frames``: forward once the tenant has admitted this many upload
    frames since its last forward (size trigger). ``max_staleness_s``:
    forward once the oldest unforwarded admission is this old (staleness
    trigger — bounds how far the root can lag an idle-ish relay). Either
    may be None (trigger disabled); ``forward_all`` ignores both.
    """

    max_frames: int | None = 32
    max_staleness_s: float | None = None

    def due(self, pending_frames: int, oldest_age_s: float) -> bool:
        if pending_frames <= 0:
            return False
        if self.max_frames is not None and pending_frames >= self.max_frames:
            return True
        return (self.max_staleness_s is not None
                and oldest_age_s >= self.max_staleness_s)


class _TenantForwardState:
    """In-memory mirror of one tenant's durable forward state."""

    def __init__(self, tenant: str):
        self.tenant = tenant
        self.epoch = 0                     # next forward's epoch number
        self.last: dict | None = None      # gram/moment/count already fwd'd
        self.pending_raw: bytes | None = None
        self.pending_last: dict | None = None  # the ``now`` the pending ships
        self.frames_fwd = 0                # t.wire_frames at last forward
        self.first_unforwarded: float | None = None   # monotonic
        self.forwards = 0
        self.forwarded_bytes = 0


def _host(x) -> np.ndarray:
    """A statistic on the host: a tensor moves once (a copy, never a view
    of the pool's storage); a numpy value passes through."""
    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu", copy=True).numpy()
    return np.asarray(x)


class RelayForwarder:
    """Forwards a journaled pool's fused deltas to an upstream aggregator.

    Args:
      pool: the relay's :class:`~repro_torch.server.pool.EnginePool`
        (typically constructed with ``tier="relay"`` and a ``journal_dir``).
      channel_factory: zero-arg factory for an upstream channel
        (``lambda: TCPChannel(host, port)`` or a loopback) — one
        :class:`ResilientClient` is opened per tenant (the session's tenant
        binding is connection-scoped).
      relay_id: this relay's stable identity; stamped into every forwarded
        frame's client id (``wire.relay_client_id``). Two relays must not
        share an id — upstream dedup would eat one of their forwards.
      state_dir: directory for the durable per-tenant forward records
        (pending frames survive crashes here). Conventionally
        ``<journal_dir>/relay_state``.
      policy: :class:`ForwardPolicy` for ``poll``; default forwards every
        32 admitted frames.
      max_chunk_payload: stream forwarded frames whose payload exceeds
        this as continuation chunks (None: single-frame only).
      retries/backoff_s/jitter/max_backoff_s/seed/sleep: upstream
        ``ResilientClient`` retry knobs.
    """

    def __init__(self, pool, channel_factory: Callable[[], object], *,
                 relay_id: str, state_dir: str | os.PathLike,
                 policy: ForwardPolicy | None = None,
                 max_chunk_payload: int | None = None,
                 retries: int = 5, backoff_s: float = 0.05,
                 jitter: float = 0.5, max_backoff_s: float = 2.0,
                 seed: int = 0,
                 sleep: Callable[[float], None] = time.sleep):
        wire.relay_client_id(relay_id, 0)   # validate early, not mid-forward
        self.pool = pool
        self.relay_id = relay_id
        self.policy = policy or ForwardPolicy()
        self.state_dir = pathlib.Path(state_dir)
        self.state_dir.mkdir(parents=True, exist_ok=True)
        self._factory = channel_factory
        self._client_kw = dict(retries=retries, backoff_s=backoff_s,
                               jitter=jitter, max_backoff_s=max_backoff_s,
                               seed=seed, sleep=sleep,
                               max_chunk_payload=max_chunk_payload)
        self._states: dict[str, _TenantForwardState] = {}
        self._clients: dict[str, ResilientClient] = {}
        self._lock = threading.Lock()     # guards the two registries
        self._fwd_lock = threading.RLock()  # serializes forwards/resume
        self._thread: threading.Thread | None = None
        self._stop = threading.Event()
        self.resumed_pending = 0
        self.empty_skips = 0
        self.poll_errors = 0
        self._poll_errors_logged: set[str] = set()
        self._load_states()

    # -- durable per-tenant state ---------------------------------------------

    def _state_path(self, tenant: str) -> pathlib.Path:
        # Tenant names are arbitrary strings; the filename is a fingerprint
        # and the name itself is verified inside the record.
        tag = zlib.crc32(tenant.encode("utf-8")) & 0xFFFFFFFF
        return self.state_dir / f"fwd_{tag:08x}_{len(tenant)}.npz"

    @staticmethod
    def _stats_arrays(stats) -> dict:
        """A ``SuffStats`` as host arrays: gram / moment / yty at the
        pool's float width, count as int64 (the state record's dtypes)."""
        out = {"gram": _host(stats.gram), "moment": _host(stats.moment),
               "count": np.asarray(int(stats.count), np.int64)}
        if stats.yty is not None:
            out["yty"] = _host(stats.yty)
        return out

    def _save_state(self, st: _TenantForwardState) -> None:
        """tmp -> fsync -> rename -> dir-fsync, like ``DurableStore``: the
        record is either the complete new state or the complete old one."""
        meta = {"tenant": st.tenant, "epoch": st.epoch,
                "frames_fwd": st.frames_fwd, "forwards": st.forwards,
                "forwarded_bytes": st.forwarded_bytes}
        arrays = {"meta": np.frombuffer(json.dumps(meta).encode(), np.uint8)}
        if st.last is not None:
            arrays.update({f"last_{k}": v for k, v in st.last.items()})
        if st.pending_raw is not None:
            arrays["pending_raw"] = np.frombuffer(st.pending_raw, np.uint8)
            arrays.update({f"next_{k}": v
                           for k, v in st.pending_last.items()})
        path = self._state_path(st.tenant)
        tmp = path.with_name(path.name + ".tmp")
        with open(tmp, "wb") as f:
            np.savez(f, **arrays)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
        fsync_dir(self.state_dir)

    def _load_states(self) -> None:
        for path in sorted(self.state_dir.glob("fwd_*.npz")):
            with open(path, "rb") as f:
                data = np.load(io.BytesIO(f.read()))
            meta = json.loads(bytes(data["meta"]).decode())
            st = _TenantForwardState(meta["tenant"])
            st.epoch = int(meta["epoch"])
            st.frames_fwd = int(meta["frames_fwd"])
            st.forwards = int(meta["forwards"])
            st.forwarded_bytes = int(meta["forwarded_bytes"])
            if "last_gram" in data:
                st.last = {"gram": data["last_gram"],
                           "moment": data["last_moment"],
                           "count": data["last_count"]}
                if "last_yty" in data:
                    st.last["yty"] = data["last_yty"]
            if "pending_raw" in data:
                st.pending_raw = bytes(data["pending_raw"])
                st.pending_last = {"gram": data["next_gram"],
                                   "moment": data["next_moment"],
                                   "count": data["next_count"]}
                if "next_yty" in data:
                    st.pending_last["yty"] = data["next_yty"]
            self._states[st.tenant] = st

    def _state(self, tenant: str) -> _TenantForwardState:
        with self._lock:
            st = self._states.get(tenant)
            if st is None:
                st = self._states[tenant] = _TenantForwardState(tenant)
            return st

    def _upstream(self, tenant: str) -> ResilientClient:
        with self._lock:
            c = self._clients.get(tenant)
            if c is None:
                c = self._clients[tenant] = ResilientClient(
                    self._factory, tenant=tenant, **self._client_kw)
            return c

    # -- forward protocol -----------------------------------------------------

    def _delta(self, st: _TenantForwardState, now: dict) -> tuple | None:
        """(gram, moment, count, yty) of ``now - last``, or None when empty.

        ``now`` is :meth:`_stats_arrays` of the drained fused stats. yty
        telescopes exactly like (G, h): the first epoch's delta IS the
        fused value (``now - 0`` is never computed), so a single-forward
        two-tier chain is bit-identical to direct upload. A tenant whose
        fusion degraded to ``yty=None`` — or whose pre-moments forward
        history recorded no yty — forwards ``yty=None`` (the root's fusion
        degrades the same way a direct legacy upload would)."""
        gram = now["gram"]
        moment = now["moment"]
        count = int(now["count"])
        yty = now.get("yty")
        if st.last is not None and st.last["gram"].shape == gram.shape:
            gram = gram - st.last["gram"]
            moment = moment - st.last["moment"]
            count = count - int(st.last["count"])
            if yty is not None:
                yty = (yty - st.last["yty"] if "yty" in st.last else None)
        if count == 0 and not gram.any() and not moment.any():
            return None
        return gram, moment, count, yty

    def _build_frame(self, tenant: str, delta: tuple, epoch: int):
        # fed.protocol imports this package back (server/__init__.py)
        from repro_torch.fed.protocol import PackedStats

        gram, moment, count, yty = delta
        packed = PackedStats.pack(SuffStats(
            gram=torch.from_numpy(gram), moment=torch.from_numpy(moment),
            count=torch.tensor(count, dtype=torch.int64),
            yty=None if yty is None else torch.from_numpy(np.asarray(yty))))
        cid = wire.relay_client_id(self.relay_id, epoch)
        t = self.pool.tenant(tenant)
        fm = t.feature_map
        if fm is None:
            return wire.StatsFrame.from_packed(packed, client_id=cid,
                                               moments=yty is not None)
        common = dict(tri=wire.host_array(packed.tri),
                      moment=wire.host_array(packed.moment),
                      count=int(packed.count), dim=int(packed.dim),
                      d_orig=fm.d_orig, seed=fm.seed, client_id=cid,
                      yty=None if yty is None else float(yty))
        if fm.kind == "sketch":
            return wire.ProjectedFrame(rhash=fm.fhash, **common)
        return wire.RFFFrame(fhash=fm.fhash, lengthscale=fm.lengthscale,
                             **common)

    def _send_pending(self, st: _TenantForwardState) -> None:
        """Ship the durably persisted bytes and finalize on ACK (ok or
        duplicate — either way the frame is fused upstream exactly once).
        ``upload_raw`` raises on a refusal, so the record stays pending."""
        self._upstream(st.tenant).upload_raw(st.pending_raw)
        st.forwards += 1
        st.forwarded_bytes += len(st.pending_raw)
        st.last = st.pending_last
        st.epoch += 1
        st.pending_raw = None
        st.pending_last = None
        self._save_state(st)

    def forward_tenant(self, tenant: str) -> bool:
        """Run one forward epoch for ``tenant``; returns whether a frame
        was shipped (False: nothing new since the last forward)."""
        with self._fwd_lock:
            st = self._state(tenant)
            if st.pending_raw is not None:   # an earlier epoch never ACKed
                self.resumed_pending += 1
                self._send_pending(st)
            t = self.pool.tenant(tenant)
            with t.lock:
                # drains under the same lock; the host copy is taken here,
                # before a later admission can move the pool's arrays
                now = self._stats_arrays(self.pool.stats(tenant))
                frames_now = t.wire_frames
            delta = self._delta(st, now)
            if delta is None:
                self.empty_skips += 1
                st.first_unforwarded = None
                return False
            frame = self._build_frame(tenant, delta, st.epoch)
            raw = wire.encode_frame(frame)
            st.pending_raw = raw
            st.pending_last = now
            st.frames_fwd = frames_now
            st.first_unforwarded = None
            self._save_state(st)             # the commit point: epoch owed
            self._send_pending(st)
            return True

    def resume(self) -> int:
        """Re-send every persisted pending frame (restart path); returns
        how many were shipped. Safe to call any time — byte-identical
        re-sends of an epoch that already landed dedup upstream."""
        sent = 0
        with self._fwd_lock:
            for st in list(self._states.values()):
                if st.pending_raw is not None:
                    self.resumed_pending += 1
                    self._send_pending(st)
                    sent += 1
        return sent

    def poll(self) -> int:
        """Forward every tenant the :class:`ForwardPolicy` says is due;
        returns the number of frames shipped."""
        sent = 0
        now_mono = time.monotonic()
        for name in self.pool.tenant_names:
            st = self._state(name)
            try:
                t = self.pool.tenant(name)
            except KeyError:
                continue
            pending = t.wire_frames - st.frames_fwd
            if pending > 0 and st.first_unforwarded is None:
                st.first_unforwarded = now_mono
            age = (now_mono - st.first_unforwarded
                   if st.first_unforwarded is not None else 0.0)
            if (st.pending_raw is not None
                    or self.policy.due(pending, age)):
                sent += bool(self.forward_tenant(name))
        return sent

    def forward_all(self) -> int:
        """Unconditional forward of every tenant (SIGTERM / shutdown path);
        returns the number of frames shipped."""
        return sum(bool(self.forward_tenant(name))
                   for name in self.pool.tenant_names)

    # -- background driver ----------------------------------------------------

    def start(self, interval_s: float = 0.25) -> "RelayForwarder":
        if self._thread is not None:
            return self
        self._stop.clear()

        def loop() -> None:
            while not self._stop.wait(interval_s):
                try:
                    self.poll()
                except Exception as e:  # noqa: BLE001 - poller must survive
                    # Transient upstream outages must not kill the thread,
                    # but they must not vanish either: count every failure
                    # (``summary()["poll_errors"]``) and log the traceback
                    # once per distinct error — the same discipline as
                    # transport's connection_errors.
                    key = f"{type(e).__name__}: {e}"
                    with self._lock:
                        self.poll_errors += 1
                        first = key not in self._poll_errors_logged
                        if first:
                            self._poll_errors_logged.add(key)
                    if first:
                        logger.error(
                            "relay %s poll failed (suppressing repeats):\n%s",
                            self.relay_id, traceback.format_exc())

        self._thread = threading.Thread(
            target=loop, name=f"RelayForwarder-{self.relay_id}", daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None

    def close(self, *, forward: bool = True) -> None:
        """Stop the poller, optionally flush everything upstream, and close
        the upstream connections. ``forward=True`` is the clean-shutdown
        contract: after it returns, the root holds this relay's full fusion."""
        self.stop()
        if forward:
            self.forward_all()
        with self._lock:
            clients, self._clients = dict(self._clients), {}
        for c in clients.values():
            c.close()

    def __enter__(self) -> "RelayForwarder":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # -- observability --------------------------------------------------------

    def summary(self) -> dict:
        with self._lock:
            states = dict(self._states)
            clients = dict(self._clients)
        per_tenant = {
            name: {"epoch": st.epoch, "forwards": st.forwards,
                   "forwarded_bytes": st.forwarded_bytes,
                   "pending": st.pending_raw is not None}
            for name, st in states.items()}
        upstream = {name: c.summary() for name, c in clients.items()}
        return {
            "relay_id": self.relay_id,
            "tier": getattr(self.pool, "tier", "relay"),
            "forwards": sum(st.forwards for st in states.values()),
            "forwarded_bytes": sum(st.forwarded_bytes
                                   for st in states.values()),
            "resumed_pending": self.resumed_pending,
            "empty_skips": self.empty_skips,
            "poll_errors": self.poll_errors,
            "duplicate_acks": sum(c["duplicate_acks"]
                                  for c in upstream.values()),
            "per_tenant": per_tenant,
            "upstream": upstream,
        }
