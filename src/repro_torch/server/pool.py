"""EnginePool — multi-tenant one-shot fusion serving.

The paper's server is a pure statistic store (Thm 1: the fused ``(G, h)``
plus algebra on it), which is what lets ONE process serve MANY independent
fusion problems: tenants share nothing but the device. This module is the
registry and scheduling layer:

  * **Admission** — ``create_tenant`` builds a named ``FusionEngine`` from
    per-client :class:`SuffStats`, from Thm-4 payloads
    (``fed.PackedStats``-shaped objects; the ledger records the bytes they
    measure), from pre-fused statistics, or empty from ``dim``. Quotas on
    tenants, fused-statistic bytes and retained clients refuse with
    :class:`AdmissionError`.
  * **Placement** — each tenant picks ``"dense"``, ``"sharded"`` or
    ``"auto"`` (``server.select``: an explicit ``threshold=`` or a table's
    crossover decides; the port has no default table, so without one
    ``"auto"`` resolves dense). All sharded tenants share ONE mesh, built
    lazily at the first sharded placement (``meshes_built``) over the
    pool's device, or over every visible card when that device is
    ``"cuda"`` with no index (``launch.mesh.spread_devices``): K sharded tenants cost one mesh, and a pool that
    places everything dense builds none. Sharded tenants solve under their
    lock and stay out of cross-tenant stacks (their backend declines the
    operand snapshot).
  * **Locking** — every tenant operation goes through a per-tenant
    re-entrant lock, so producers, the background flusher and readers can
    hit one tenant concurrently and reads observe fully drained state.
  * **Background flusher** — a daemon thread that enforces each tenant's
    ``CoalescerPolicy.max_staleness_s`` when no reads arrive.
  * **LRU factor eviction** — with ``max_warm=N`` at most N tenants keep
    their per-sigma factors; colder tenants keep ``(G, h)`` and ledger.
  * **Batched solves** — ``solve_many`` snapshots each request's operands
    under its tenant's lock and solves every (d, dtype) bucket in one
    :func:`~repro_torch.server.batch.solve_stacked` sweep with no lock held.
  * **Wire admission** — ``admit_frame`` is the server half of
    ``fed.wire``: upload frames fuse into a tenant created lazily from the
    first frame, CONTROL frames drop and restore clients, SOLVE frames
    answer with weights. Uploads that arrive with their bytes are
    deduplicated, so a client's retry after a lost ACK fuses once.
  * **Durability** — with ``journal_dir`` every upload and control frame
    admitted through ``admit_frame`` is write-ahead journaled under its
    tenant's lock before it is applied (``server.durability``), the pool
    snapshots every ``snapshot_every`` appends and at ``close()``, and
    construction restores the latest committed snapshot plus a replay of
    the journal tail: the restored pool's solves equal a never-crashed
    pool's bitwise, with no client re-uploading anything.
  * **Ledger** — ``ledger()`` rolls per-tenant ``fed.comm`` records,
    streamed §VI-C bytes and the encoded bytes of wire frames into one
    account, per tenant kind and per tier.

Every tenant of a pool lives on the pool's one device (``device=``, the
card unless the caller asks for the CPU); a restored tenant's arrays land
there too. ``create_tenant(psd_guard=True)`` runs the Remark-4 guard on the
admitted Gram (``eigvalsh`` on the pool's device in the tenant's dtype; if
DP noise made it indefinite, ``privacy.psd_repair``), and ``summary()``
counts its firings. The guard is not journaled, as in the reference: a
restored tenant holds the repaired statistics of its snapshot, with
``psd_repairs`` 0 and ``guard_min_eig`` None. Relay-forwarded frames are
counted as the JAX package counts them; ``server.relay`` forwards a
``tier="relay"`` pool's fusion upstream.

Thread-safety contract: the pool's wrappers are safe for concurrent use.
``get()`` hands back the raw engine for single-threaded convenience.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from typing import Any, Callable, Hashable, Mapping, Sequence

import numpy as np
import torch

from repro_torch.core.features import FeatureMap
from repro_torch.core.privacy import psd_repair
from repro_torch.core.sufficient_stats import SuffStats
from repro_torch.server.backends import solve_snapshot
from repro_torch.server.batch import solve_stacked
from repro_torch.server.engine import CoalescerPolicy, FusionEngine
from repro_torch.server.select import prefer_sharded

PLACEMENTS = ("dense", "sharded", "auto")


class AdmissionError(ValueError):
    """A tenant or client was refused for capacity, not correctness.

    A ``ValueError``: the wire path (:meth:`EnginePool.admit_frame`) answers
    any ``ValueError`` with a typed ``AckFrame(ok=False)``, so quota
    refusals reach remote clients as protocol-level refusals.
    """


@dataclasses.dataclass
class Tenant:
    """Registry entry: one named engine plus its lock and observability."""

    name: str
    engine: FusionEngine
    placement: str                 # what was requested ("auto" stays "auto")
    lock: threading.RLock = dataclasses.field(default_factory=threading.RLock)
    last_used: float = dataclasses.field(default_factory=time.monotonic)
    comm: Any = None               # fed.comm.CommRecord from admission
    streamed_floats: int = 0       # §VI-C floats ingested after admission
    wire_frames: int = 0           # decoded wire frames admitted (fed.wire)
    relay_frames: int = 0          # of those, frames forwarded by a relay
    #                                tier (wire.is_relay_client ids)
    wire_upload_bytes: int = 0     # encoded bytes of admitted upload frames
    wire_download_bytes: int = 0   # encoded bytes of replies (weights/acks)
    feature_map: FeatureMap | None = None  # §IV-F map identity (sketch / rff)
    # Idempotent-replay index: (client_id, frame type byte, encoded length,
    # CRC32) of every upload frame fused with its bytes. A byte-identical
    # re-send (a retry after a lost ACK) hits it and is answered
    # duplicate=True instead of fusing twice.
    dedup: set = dataclasses.field(default_factory=set)
    duplicates: int = 0            # re-sent frames answered duplicate=True
    background_flushes: int = 0    # flushes driven by the pool's thread
    max_flush_age_s: float = 0.0   # oldest delta age ever seen at a drain
    factor_evictions: int = 0      # LRU evictions of this tenant's factors
    psd_repairs: int = 0           # Remark-4 guard firings
    guard_min_eig: float | None = None   # min eig seen by the last guard check

    @property
    def backend_name(self) -> str:
        return self.engine.backend.name

    @property
    def kind(self) -> str:
        """Ledger kind: "dense", "sketched" (§IV-F JL sketch), or "rff"."""
        if self.feature_map is None:
            return "dense"
        return "sketched" if self.feature_map.kind == "sketch" else "rff"

    @property
    def projection(self) -> dict | None:
        """The §IV-F sketch identity (seed/d_orig/m/rhash); None for dense
        and rff tenants."""
        fm = self.feature_map
        if fm is None or fm.kind != "sketch":
            return None
        return {"seed": fm.seed, "d_orig": fm.d_orig, "m": fm.m,
                "rhash": fm.fhash}

    def summary(self) -> dict:
        """The reference's keys."""
        with self.lock:
            return {
                "placement": self.placement,
                "backend": self.backend_name,
                "kind": self.kind,
                "streamed_floats": self.streamed_floats,
                "wire_frames": self.wire_frames,
                "relay_frames": self.relay_frames,
                "wire_upload_bytes": self.wire_upload_bytes,
                "wire_download_bytes": self.wire_download_bytes,
                "duplicates": self.duplicates,
                "background_flushes": self.background_flushes,
                "max_flush_age_s": self.max_flush_age_s,
                "factor_evictions": self.factor_evictions,
                "psd_repairs": self.psd_repairs,
                "engine": self.engine.summary(),
            }


def _same_device(a: torch.device, b: torch.device) -> bool:
    """Equal devices, where an index left unset matches any index."""
    return a.type == b.type and (a.index is None or b.index is None
                                 or a.index == b.index)


class EnginePool:
    """Named multi-tenant registry of :class:`FusionEngine` servers."""

    def __init__(self, *, mesh=None, mesh_devices: int = 8,
                 threshold: float | None = None,
                 table=None, max_warm: int | None = None,
                 max_tenants: int | None = None,
                 stat_budget_bytes: int | None = None,
                 max_clients_per_tenant: int | None = None,
                 default_coalesce: CoalescerPolicy | None = None,
                 journal_dir: str | None = None,
                 snapshot_every: int | None = None,
                 journal_fsync: bool = True,
                 journal_placement: str = "dense",
                 tier: str = "root", device="cuda", dtype=torch.float32):
        """Args:
          mesh: mesh shared by every sharded tenant; built lazily
            (``launch.mesh.make_device_mesh(mesh_devices)`` over
            ``launch.mesh.spread_devices(device)``: every visible card for
            ``"cuda"``, the one device for ``"cuda:0"`` or ``"cpu"``) when
            omitted and a tenant places sharded.
          threshold / table: forwarded to ``server.select`` for ``"auto"``
            placement (an explicit threshold beats a table's crossover).
          max_warm: LRU bound on tenants with resident factor caches
            (``None``: never evict).
          max_tenants: cap on admitted tenants (:class:`AdmissionError`).
          stat_budget_bytes: admission budget on fused-statistic residency
            (each tenant's ``backend.state_bytes``; factor caches are
            evictable and governed by ``max_warm``).
          max_clients_per_tenant: cap on retained ledger entries (active +
            dropped) per tenant; ingests under NEW client ids past it are
            refused (anonymous and repeat-id ingests always pass).
          default_coalesce: coalescer policy of tenants that pass none.
          journal_dir: directory of crash-safe state
            (``server.durability``): every upload and control frame
            admitted through :meth:`admit_frame` is journaled before it is
            applied, and construction RESTORES the pool from the directory's
            latest committed snapshot plus a replay of the journal tail (a
            torn tail is CRC-detected and truncated, never half-applied).
            ``None`` keeps the pool in memory. Python-API mutations
            (``ingest`` etc.) are not journaled; they become durable at the
            next snapshot.
          snapshot_every: journal appends between automatic snapshot and
            compaction cycles (``None``: only :meth:`snapshot` and
            ``close()`` snapshot).
          journal_fsync: fsync every journal append (an ACKed frame survives
            power loss) or only flush it to the OS (a crash may lose the
            last ACKed frames, which retrying clients re-send and the dedup
            index absorbs).
          journal_placement: placement of tenants that journal replay
            recreates and no snapshot covers yet.
          tier: accounting label ("root" / "relay"), reported by ``ledger``.
          device: where every tenant's state lives.
          dtype: the container of tenants created empty (from ``dim`` or a
            wire frame): wider wire arrays are truncated to it, and the wire
            dispatcher prefers it in negotiation (the JAX package's
            ``jax_enable_x64``).
        """
        if journal_placement not in PLACEMENTS:
            raise ValueError(f"journal_placement must be one of {PLACEMENTS}, "
                             f"got {journal_placement!r}")
        self._tenants: dict[str, Tenant] = {}
        self._reg_lock = threading.RLock()
        self._mesh = mesh
        self._mesh_devices = mesh_devices
        self.meshes_built = 0
        self._threshold = threshold
        self._table = table
        self.max_warm = max_warm
        self.max_tenants = max_tenants
        self.stat_budget_bytes = stat_budget_bytes
        self.max_clients_per_tenant = max_clients_per_tenant
        self.tier = tier
        self.device = torch.device(device)
        self.dtype = dtype
        self._default_coalesce = default_coalesce
        self.batched_sweeps = 0     # cross-tenant stacked solve sweeps run
        self.batched_solves = 0     # individual solves served by those sweeps
        self.admission_rejections = 0
        self._flusher: threading.Thread | None = None
        self._stop = threading.Event()
        # -- durability (server.durability) ---------------------------------
        self.snapshot_every = snapshot_every
        self._journal_placement = journal_placement
        self._store = None
        self._journal = None
        self._snap_lock = threading.Lock()
        self._close_lock = threading.Lock()
        self._closed = False
        self._replaying = False
        self._appends_since_snap = 0
        self.snapshots_taken = 0
        self.replayed_frames = 0
        self.restored_tenants = 0
        if journal_dir is not None:
            from repro_torch.server.durability import DurableStore

            self._store = DurableStore(journal_dir, fsync=journal_fsync)
            self._restore_durable()

    # -- registry ------------------------------------------------------------

    def __len__(self) -> int:
        with self._reg_lock:
            return len(self._tenants)

    def __contains__(self, name: str) -> bool:
        with self._reg_lock:
            return name in self._tenants

    @property
    def tenant_names(self) -> tuple[str, ...]:
        with self._reg_lock:
            return tuple(self._tenants)

    def tenant(self, name: str) -> Tenant:
        """The registry record (observability; engine access via ``get``)."""
        with self._reg_lock:
            return self._tenants[name]

    def get(self, name: str) -> FusionEngine:
        """The tenant's engine (touches the LRU clock)."""
        t = self.tenant(name)
        with t.lock:
            t.last_used = time.monotonic()
        return t.engine

    def _snapshot(self) -> list[Tenant]:
        with self._reg_lock:
            return list(self._tenants.values())

    def shared_mesh(self):
        """The one mesh every sharded tenant is placed on (built lazily)."""
        with self._reg_lock:
            if self._mesh is None:
                from repro_torch.launch import mesh as mesh_lib

                devices = mesh_lib.spread_devices(self.device)
                self._mesh = mesh_lib.make_device_mesh(
                    self._mesh_devices, devices=devices[:self._mesh_devices])
                self.meshes_built += 1
            return self._mesh

    # -- admission -----------------------------------------------------------

    def create_tenant(self, name: str,
                      clients: Mapping[Hashable, SuffStats]
                      | Sequence[SuffStats] | None = None, *,
                      payloads: Mapping[Hashable, Any] | Sequence[Any]
                      | None = None,
                      stats: SuffStats | None = None,
                      dim: int | None = None,
                      placement: str = "auto",
                      dtype=None,
                      features: FeatureMap | None = None,
                      coalesce: CoalescerPolicy | None = None,
                      max_update_rank: int | None = None,
                      psd_guard: bool = False,
                      backend_kwargs: dict | None = None) -> FusionEngine:
        """Admit a tenant from at most one of ``clients`` / ``payloads`` /
        ``stats`` (or none, with ``dim``, for an empty engine fed later).

        ``payloads`` are Thm-4 upload objects (anything with ``unpack()``
        and ``wire_floats``, e.g. ``fed.PackedStats``); the admission ledger
        records the bytes they measure. Admitted statistics must lie on the
        pool's device; an empty tenant is made there.

        ``features`` declares a §IV-F sketched / rff tenant: the engine
        lives in the map's m-dimensional solve space (``dim`` defaults to
        ``features.m`` and must equal it; statistics passed here must
        already BE feature-space statistics), serving lifts through the map
        (``solve_lifted`` / ``solve_report``), and the ledger accounts the
        tenant under its kind.

        ``psd_guard`` runs the Remark-4 check on the admitted Gram: if DP
        noise made it indefinite, ``privacy.psd_repair`` is applied (DP
        post-processing, free) and the firing is counted in the tenant
        record. ``backend_kwargs`` go to a sharded tenant's
        ``ShardedBackend`` (``block_size``, ``method``, ...).
        """
        if placement not in PLACEMENTS:
            raise ValueError(f"placement must be one of {PLACEMENTS}, "
                             f"got {placement!r}")
        given = [x is not None for x in (clients, payloads, stats)]
        if sum(given) > 1:
            raise ValueError("pass at most one of clients/payloads/stats")
        with self._reg_lock:
            if name in self._tenants:
                raise ValueError(f"tenant {name!r} already exists")

        unpacked: Mapping[Hashable, SuffStats] | None = None
        if payloads is not None:
            items = list(payloads.items() if isinstance(payloads, Mapping)
                         else enumerate(payloads))
            if not items:
                raise ValueError("need at least one client's payload")
            unpacked = {cid: p.unpack() for cid, p in items}
            dim = next(iter(unpacked.values())).dim
        elif clients is not None:
            cl = (clients if isinstance(clients, Mapping)
                  else dict(enumerate(clients)))
            if not cl:
                raise ValueError("need at least one client's statistics")
            unpacked = cl
            dim = next(iter(cl.values())).dim
        elif stats is not None:
            dim = stats.dim
        elif dim is None:
            if features is None:
                raise ValueError("need clients, payloads, stats, dim, "
                                 "or features")
            dim = features.m
        if features is not None and dim != features.m:
            raise ValueError(
                f"tenant {name!r}: admitted statistics have dim {dim} but "
                f"the feature map solves in m={features.m} — feature tenants "
                f"take feature-space statistics only")
        first = (next(iter(unpacked.values())) if unpacked is not None
                 else stats)
        if first is not None and not _same_device(first.gram.device,
                                                  self.device):
            raise ValueError(f"tenant {name!r}: statistics on "
                             f"{first.gram.device}, pool on {self.device}")

        eff_dtype = (dtype if dtype is not None
                     else first.gram.dtype if first is not None else self.dtype)
        self._check_admission(name, dim, eff_dtype)
        backend = self._place(dim, placement, eff_dtype, backend_kwargs or {})
        kwargs: dict = {"coalesce": coalesce if coalesce is not None
                        else self._default_coalesce}
        if max_update_rank is not None:
            kwargs["max_update_rank"] = max_update_rank
        if backend is not None:
            kwargs["backend"] = backend
        elif dtype is not None:
            kwargs["dtype"] = dtype
        if unpacked is not None:
            engine = FusionEngine.from_clients(unpacked, **kwargs)
        elif stats is not None:
            engine = FusionEngine.from_stats(stats, **kwargs)
        else:
            if backend is None:
                kwargs["dtype"] = eff_dtype
            engine = FusionEngine(dim, device=self.device, **kwargs)

        t = Tenant(name, engine, placement)
        if features is not None:
            t.feature_map = features
            # warm the map's cache on the device its queries will come from
            features.materialize(engine.backend.stats().gram.device)
        if unpacked is not None:
            # Uploads happened (per-client stats or payloads); stats= and
            # dim= admissions shipped nothing and record nothing.
            t.comm = self._admission_record(
                engine, dim,
                payloads=[p for _, p in items] if payloads is not None
                else None)
        if psd_guard:
            self._run_psd_guard(t)

        with self._reg_lock:
            if name in self._tenants:   # lost a create/create race
                raise ValueError(f"tenant {name!r} already exists")
            self._tenants[name] = t
        return engine

    def _check_admission(self, name: str, dim: int, dtype) -> None:
        """Capacity gate for a new tenant: tenant count and stat residency,
        estimated from (dim, dtype) before anything is allocated."""
        with self._reg_lock:
            n = len(self._tenants)
        if self.max_tenants is not None and n >= self.max_tenants:
            self.admission_rejections += 1
            raise AdmissionError(
                f"tenant {name!r} refused: pool at max_tenants="
                f"{self.max_tenants}")
        if self.stat_budget_bytes is not None:
            itemsize = torch.finfo(dtype).bits // 8
            incoming = (dim * dim + dim) * itemsize
            resident = self.resident_stat_bytes()
            if resident + incoming > self.stat_budget_bytes:
                self.admission_rejections += 1
                raise AdmissionError(
                    f"tenant {name!r} refused: fused stats would need "
                    f"{incoming} bytes on top of {resident} resident "
                    f"(stat_budget_bytes={self.stat_budget_bytes})")

    def _check_client_quota(self, t: Tenant, client_id: Hashable) -> None:
        """Refuse ingests that would retain a NEW ledger client past quota
        (called under ``t.lock``; anonymous and repeat ids always pass)."""
        if self.max_clients_per_tenant is None or client_id is None:
            return
        eng = t.engine
        if client_id in eng.client_ids or client_id in eng.dropped_ids:
            return
        if eng.retained_clients >= self.max_clients_per_tenant:
            self.admission_rejections += 1
            raise AdmissionError(
                f"client {client_id!r} refused: tenant {t.name!r} at "
                f"max_clients_per_tenant={self.max_clients_per_tenant}")

    def resident_stat_bytes(self) -> int:
        """Fused-statistic bytes pinned across all tenants (the admission
        budget's denominator; excludes evictable factor caches)."""
        return sum(int(getattr(t.engine.backend, "state_bytes", 0))
                   for t in self._snapshot())

    def resident_bytes(self) -> int:
        """Total tenant residency: fused stats + ledgers + factor caches."""
        total = 0
        for t in self._snapshot():
            with t.lock:
                total += t.engine.resident_bytes
        return total

    def _place(self, dim: int, placement: str, dtype, backend_kwargs):
        """Resolve a placement request to a backend (None = default dense)."""
        if placement == "auto":
            placement = ("sharded"
                         if prefer_sharded(dim, threshold=self._threshold,
                                           table=self._table) else "dense")
        if placement == "dense":
            return None
        from repro_torch.server.distributed import ShardedBackend

        kw = dict(backend_kwargs)
        kw.setdefault("dtype", dtype)
        return ShardedBackend(dim, self.shared_mesh(), **kw)

    def _admission_record(self, engine: FusionEngine, dim: int, *, payloads):
        from repro_torch.fed import comm as fed_comm

        if payloads is not None:
            base = fed_comm.measured_one_shot(payloads, download_floats=dim)
        else:
            base = fed_comm.one_shot_comm(dim, max(len(engine.client_ids), 1))
        axis_sizes = getattr(engine.backend, "fusion_axis_sizes", None)
        if axis_sizes:
            # sharded tenants also pay the one on-mesh fusion reduction
            base = fed_comm.ShardedCommRecord(
                upload_floats_per_client=base.upload_floats_per_client,
                download_floats_per_client=base.download_floats_per_client,
                num_clients=base.num_clients,
                rounds=base.rounds,
                upload_wire_bytes_per_client=base.upload_wire_bytes_per_client,
                download_wire_bytes_per_client=(
                    base.download_wire_bytes_per_client),
                psum_floats_per_axis=fed_comm.sharded_oneshot_record(
                    dim, base.num_clients, axis_sizes).psum_floats_per_axis)
        return base

    def _run_psd_guard(self, t: Tenant) -> bool:
        """Remark 4: repair the admitted Gram if noise made it indefinite."""
        with t.lock:
            min_eig = float(torch.linalg.eigvalsh(t.engine.stats.gram)[0])
            t.guard_min_eig = min_eig
            if min_eig < 0.0:
                t.engine.apply(psd_repair)
                t.psd_repairs += 1
                return True
        return False

    # -- durability: WAL + snapshot/compaction (server.durability) ------------

    @property
    def journaled(self) -> bool:
        return self._store is not None

    def _restore_durable(self) -> None:
        """Rebuild pool state from the journal directory (construction path).

        The latest committed snapshot first (fused arrays bitwise, ledger,
        feature maps, dedup index, wire counters), then every journaled
        frame the snapshot has not absorbed: the snapshot recorded, per
        tenant, its offset into the segment it switched to, so replay skips
        exactly the frames captured inside it. Frames re-admit through
        :meth:`admit_frame` with journaling off: the same guards, counters
        and fuse order (the journal serialized them under the tenant lock),
        and no client re-uploads.
        """
        journal, plan = self._store.open_journal()
        snap = self._store.load_snapshot(self.device)
        offsets: dict[str, int] = {}
        placements: dict[str, str] = {}
        snap_seq = None
        if snap is not None:
            snap_seq, meta, tree = snap
            self._restore_snapshot(meta, tree)
            offsets = {t["name"]: t["offset"] for t in meta["tenants"]}
            placements = {t["name"]: t["placement"]
                          for t in meta["tenants"]}
        self._journal = journal
        self._replaying = True
        try:
            for seg_seq, res in plan:
                for rec in res.records:
                    if (seg_seq == snap_seq
                            and rec.offset < offsets.get(rec.tenant, 0)):
                        continue   # already inside the snapshot
                    self.admit_frame(
                        rec.tenant, rec.frame, encoded_len=len(rec.raw),
                        placement=placements.get(rec.tenant,
                                                 self._journal_placement),
                        raw=rec.raw)
                    self.replayed_frames += 1
        finally:
            self._replaying = False

    def _restore_snapshot(self, meta: dict, tree: dict) -> None:
        from repro_torch.server.durability import _untag_id

        def unstats(entry) -> SuffStats:
            return SuffStats(gram=entry["gram"], moment=entry["moment"],
                             count=torch.tensor(int(entry["count"]),
                                                dtype=torch.int32,
                                                device=self.device),
                             yty=entry.get("yty"))

        for ti, tm in enumerate(meta["tenants"]):
            entry = tree[f"t{ti}"]
            fm = (FeatureMap(**tm["feature_map"])
                  if tm.get("feature_map") else None)
            engine = self.create_tenant(
                tm["name"], stats=unstats(entry["fused"]),
                placement=tm["placement"], dtype=getattr(torch, tm["dtype"]),
                features=fm)
            clients = {_untag_id(tag): unstats(entry["clients"][f"c{i}"])
                       for i, tag in enumerate(tm["clients"])}
            dropped = {_untag_id(tag): unstats(entry["dropped"][f"d{i}"])
                       for i, tag in enumerate(tm["dropped"])}
            engine.import_ledger(clients, dropped)
            t = self.tenant(tm["name"])
            # Entries restore as written: 4-tuples, or the JAX package's
            # legacy (client_id, crc) 2-tuples, which _dedup_hit matches too,
            # so no journaled frame fuses twice.
            t.dedup = {tuple(e) for e in tm["dedup"]}
            c = tm["counters"]
            t.wire_frames = c["wire_frames"]
            t.relay_frames = c.get("relay_frames", 0)
            t.wire_upload_bytes = c["wire_upload_bytes"]
            # Download bytes are snapshot-only: replay produces no replies,
            # so replies sent after the capture are not counted again.
            t.wire_download_bytes = c["wire_download_bytes"]
            t.streamed_floats = c["streamed_floats"]
            t.duplicates = c.get("duplicates", 0)
            self.restored_tenants += 1

    def snapshot(self) -> int | None:
        """Commit one snapshot + compaction cycle; returns its sequence
        number (``None`` on a pool without a journal).

        The journal first switches to a fresh segment, then every tenant is
        captured one lock at a time, with the new segment's offset at its
        capture, so the snapshot plus the segment's tail is always a
        consistent cut (``server.durability``). Older segments and snapshots
        are pruned after the commit record lands.
        """
        if self._store is None:
            return None
        with self._snap_lock:
            return self._snapshot_durable()

    def _snapshot_durable(self) -> int:
        from repro_torch.server.durability import _tag_id, dtype_name, stats_entry

        def entry(s: SuffStats) -> dict:
            return stats_entry(s.gram, s.moment, s.count, yty=s.yty)

        seq = self._store.next_seq()
        if self._journal is not None and not self._journal.closed:
            self._journal.switch(self._store.segment_path(seq))
        self._appends_since_snap = 0
        tree: dict = {}
        tenants_meta: list[dict] = []
        for ti, t in enumerate(self._snapshot()):
            with t.lock:
                eng = t.engine
                clients, dropped = eng.export_ledger()
                fused = eng.backend.stats()
                cids, dids = list(clients), list(dropped)
                tree[f"t{ti}"] = {
                    "fused": entry(fused),
                    "clients": {f"c{i}": entry(clients[c])
                                for i, c in enumerate(cids)},
                    "dropped": {f"d{i}": entry(dropped[c])
                                for i, c in enumerate(dids)},
                }
                tenants_meta.append({
                    "name": t.name,
                    "placement": t.placement,
                    "dim": eng.dim,
                    "dtype": dtype_name(eng.dtype),
                    "offset": (self._journal.size
                               if self._journal is not None
                               and not self._journal.closed else 0),
                    "clients": [_tag_id(c) for c in cids],
                    "dropped": [_tag_id(c) for c in dids],
                    "feature_map": (dataclasses.asdict(t.feature_map)
                                    if t.feature_map is not None else None),
                    # which entries carry a residual second moment: keeps
                    # the snapshot's load template in sync
                    "moments": {
                        "fused": fused.yty is not None,
                        "clients": [clients[c].yty is not None
                                    for c in cids],
                        "dropped": [dropped[c].yty is not None
                                    for c in dids],
                    },
                    "dedup": sorted([list(k) for k in t.dedup]),
                    "counters": {
                        "wire_frames": t.wire_frames,
                        "relay_frames": t.relay_frames,
                        "wire_upload_bytes": t.wire_upload_bytes,
                        "wire_download_bytes": t.wire_download_bytes,
                        "streamed_floats": t.streamed_floats,
                        "duplicates": t.duplicates,
                    },
                })
        self._store.commit_snapshot(seq, tree, {"seq": seq,
                                                "tenants": tenants_meta})
        self._store.prune(seq)
        self.snapshots_taken += 1
        return seq

    def _maybe_snapshot(self) -> None:
        """Deferred compaction trigger, called with NO tenant lock held (as
        ``_maybe_evict`` is); skips when a snapshot is already running."""
        if (self._store is None or self.snapshot_every is None
                or self._appends_since_snap < self.snapshot_every):
            return
        if not self._snap_lock.acquire(blocking=False):
            return
        try:
            if self._appends_since_snap >= self.snapshot_every:
                self._snapshot_durable()
        finally:
            self._snap_lock.release()

    @staticmethod
    def _frame_raw(frame, raw: bytes | None) -> bytes:
        """The frame's canonical encoded bytes: what the transport received,
        or a re-encode at the frame's own wire dtype (byte-identical by the
        decode / re-encode contract the golden fixtures pin)."""
        if raw is not None:
            return raw
        from repro_torch.fed import wire

        return wire.encode_frame(
            frame, dtype=getattr(frame, "wire_dtype", None))

    def _journal_append(self, name: str, frame, raw: bytes | None) -> None:
        """WAL order: journal BEFORE applying. Raises on an I/O failure; the
        transport then answers with a retryable internal-error ACK and
        nothing was applied, so a retry is safe."""
        if self._journal is None or self._replaying:
            return
        self._journal.append(name, self._frame_raw(frame, raw))
        self._appends_since_snap += 1

    # -- wire-frame admission (fed.wire / fed.transport) ----------------------

    def admit_frame(self, name: str, frame, *, encoded_len: int = 0,
                    placement: str = "dense", raw: bytes | None = None):
        """Feed one decoded ``fed.wire`` frame into tenant ``name``.

        The server half of the wire protocol: upload frames (STATS / PROJ /
        RFF / DELTA) are ingested into the tenant's engine — created lazily
        from the first frame's dimension with ``placement`` — CONTROL
        frames drive Thm-8 drop/rejoin, and SOLVE queries return a
        ``WeightsFrame`` (lifted through the tenant's §IV-F map when it has
        one). ``encoded_len`` is the frame's on-wire byte length; the ledger
        sums it for upload frames.

        ``raw`` is the frame's encoded bytes when the caller has them
        (transports always do). When present, or when the pool is
        journaled, uploads are deduplicated on ``(client_id, frame type
        byte, encoded length, CRC32)``: a byte-identical re-send after a lost
        ACK answers ``AckFrame(duplicate=True)`` and fuses nothing twice. A
        journaled pool writes the frame to the WAL *before* applying it, so
        a crash between the two replays the frame on restart.

        Returns the reply frame (``AckFrame`` or ``WeightsFrame``).
        Protocol-level problems (dim mismatch, unknown tenant or client,
        conflicting feature map, quota) come back as ``AckFrame(ok=False)``;
        only programming, device and journal I/O errors raise.
        """
        reply = self._admit_frame_inner(name, frame, encoded_len=encoded_len,
                                        placement=placement, raw=raw)
        if self._store is not None and not self._replaying:
            # Deferred compaction, with no tenant lock held: the snapshot's
            # one-lock-at-a-time capture cannot deadlock against the
            # admission that triggered it.
            self._maybe_snapshot()
        return reply

    def _admit_frame_inner(self, name: str, frame, *, encoded_len: int,
                           placement: str, raw: bytes | None):
        from repro_torch.fed import wire

        if isinstance(frame, wire.Hello):
            raise TypeError("HELLO is a session frame; the transport "
                            "negotiates it before admission")
        try:
            if isinstance(frame, (wire.StatsFrame, wire.ProjectedFrame,
                                  wire.RFFFrame)):
                t = self._ensure_wire_tenant(name, frame.dim, placement)
                # One lock acquisition spans guard AND ingest (RLock — the
                # nested _locked re-acquire is free): a concurrent upload
                # cannot flip the tenant's space between check and fuse.
                with t.lock:
                    if isinstance(frame, (wire.ProjectedFrame,
                                          wire.RFFFrame)):
                        err = self._check_feature_frame(t, frame)
                    else:
                        err = self._check_unsketched(t)
                    if err is not None:
                        return wire.AckFrame(False, err)
                    cid = frame.client_id or None
                    key = self._dedup_key(frame, raw)
                    if key is not None and self._dedup_hit(t, key):
                        t.duplicates += 1
                        return wire.AckFrame(
                            True, f"duplicate upload d={frame.dim} already "
                                  f"fused", duplicate=True)
                    # Quota BEFORE the WAL: the journal holds applied frames
                    # only (the check inside _locked is free under the RLock).
                    self._check_client_quota(t, cid)
                    self._journal_append(name, frame, raw)
                    packed = frame.to_packed(self.device,
                                             self._container(frame.tri))
                    self._locked(name,
                                 lambda e: e.ingest(packed.unpack(),
                                                    client_id=cid),
                                 wire_bytes=encoded_len, quota_client=cid)
                    if key is not None:
                        t.dedup.add(key)
                    if wire.is_relay_client(cid):
                        t.relay_frames += 1
                return wire.AckFrame(True, f"ingested d={frame.dim} "
                                           f"count={int(frame.count)}")
            if isinstance(frame, wire.DeltaRowsFrame):
                t = self._ensure_wire_tenant(name, frame.A.shape[1], placement)
                with t.lock:
                    err = self._check_unsketched(t)
                    if err is not None:
                        return wire.AckFrame(False, err)
                    cid = frame.client_id or None
                    key = self._dedup_key(frame, raw)
                    if key is not None and self._dedup_hit(t, key):
                        t.duplicates += 1
                        return wire.AckFrame(
                            True, "duplicate rows already fused",
                            duplicate=True)
                    self._check_client_quota(t, cid)
                    self._journal_append(name, frame, raw)
                    dt = self._container(frame.A)
                    A = torch.as_tensor(frame.A).to(self.device, dt)
                    b = torch.as_tensor(frame.b).to(self.device, dt)
                    self._locked(name,
                                 lambda e: e.ingest_rows(A, b, client_id=cid),
                                 wire_bytes=encoded_len, quota_client=cid)
                    if key is not None:
                        t.dedup.add(key)
                    if wire.is_relay_client(cid):
                        t.relay_frames += 1
                return wire.AckFrame(True, f"ingested {A.shape[0]} rows")
            if isinstance(frame, wire.ControlFrame):
                if name not in self:
                    return wire.AckFrame(False, f"unknown tenant {name!r}")
                t = self.tenant(name)
                op = (FusionEngine.drop if frame.op == "drop"
                      else FusionEngine.restore)
                with t.lock:
                    # Idempotency needs the engine's *settled* membership:
                    # drain queued deltas first (with staleness accounting).
                    self._locked(name, lambda e: e.flush())
                    eng = t.engine
                    cid = frame.client_id
                    already = (cid in eng.dropped_ids
                               and cid not in eng.client_ids
                               if frame.op == "drop"
                               else cid in eng.client_ids
                               and cid not in eng.dropped_ids)
                    if already:
                        t.duplicates += 1
                        return wire.AckFrame(
                            True, f"{frame.op} {cid!r} already applied",
                            duplicate=True)
                    if (cid not in eng.client_ids
                            and cid not in eng.dropped_ids):
                        raise KeyError(cid)
                    self._journal_append(name, frame, raw)
                    self._locked(name, lambda e: op(e, cid))
                return wire.AckFrame(True, f"{frame.op} {frame.client_id!r}")
            if isinstance(frame, wire.SolveFrame):
                if name not in self:
                    return wire.AckFrame(False, f"unknown tenant {name!r}")
                w = self.solve_lifted(name, frame.sigma).cpu().numpy()
                return wire.WeightsFrame(
                    w=w, sigma=frame.sigma,
                    wire_dtype=wire.dtype_name(w.dtype))
        except KeyError as e:
            return wire.AckFrame(False, f"unknown client {e.args[0]!r}")
        except ValueError as e:
            return wire.AckFrame(False, str(e))
        raise TypeError(f"cannot admit frame type {type(frame).__name__}")

    def _container(self, arr) -> torch.dtype:
        """The dtype a decoded wire array lands in: its own, truncated to
        the pool's ``dtype`` when wider (as the JAX package's ``asarray``
        lands it in its default float width)."""
        own = torch.float64 if arr.dtype == np.float64 else torch.float32
        return own if own.itemsize <= self.dtype.itemsize else self.dtype

    def _dedup_key(self, frame, raw: bytes | None):
        """The idempotency key for an upload, or None for a frame that came
        without its bytes to a pool without a journal (an in-process caller,
        which never retries blind).

        The key is ``(client_id, frame_type_byte, encoded_len, crc32)``:
        CRC32 alone is 32 bits of a *linear* code, so two different uploads
        of one client can share it. Frame type and encoded length make the
        cheap collisions structurally impossible and leave only same-type,
        same-length CRC collisions, which the tests pin as fused, not
        deduplicated.
        """
        if raw is None and self._store is None:
            return None
        from repro_torch.fed import wire

        raw = self._frame_raw(frame, raw)
        return (frame.client_id, raw[5], len(raw), wire.frame_crc(raw))

    @staticmethod
    def _dedup_hit(t: Tenant, key) -> bool:
        """Membership under both key generations: the 4-tuples and the
        JAX package's legacy ``(client_id, crc)`` 2-tuples."""
        return key in t.dedup or (key[0], key[3]) in t.dedup

    def record_wire_reply(self, name: str, nbytes: int) -> None:
        """Account a reply frame's encoded bytes (the download direction)."""
        with self._reg_lock:
            t = self._tenants.get(name)
        if t is not None:
            with t.lock:
                t.wire_download_bytes += nbytes

    def _ensure_wire_tenant(self, name: str, dim: int,
                            placement: str) -> Tenant:
        with self._reg_lock:
            t = self._tenants.get(name)
        if t is None:
            try:
                self.create_tenant(name, dim=dim, placement=placement)
            except ValueError as e:
                if "already exists" not in str(e):   # lost a create/create race
                    raise
            t = self.tenant(name)
        if t.engine.dim != dim:
            raise ValueError(f"frame dim {dim} != tenant {name!r} dim "
                             f"{t.engine.dim}")
        return t

    @staticmethod
    def _check_unsketched(t: Tenant) -> str | None:
        """A plain (Thm-4 / §VI-C) upload may not land on a feature tenant:
        statistics from different spaces fuse without a shape error and
        serve silent garbage. Returns an error string (reject) or None."""
        with t.lock:
            if t.feature_map is not None:
                return (f"tenant holds §IV-F {t.kind} statistics "
                        f"(seed={t.feature_map.seed}); plain uploads "
                        f"would silently mix spaces")
        return None

    @staticmethod
    def _frame_map(frame) -> tuple[FeatureMap, int]:
        """A wire feature frame's declared map identity + claimed hash."""
        from repro_torch.fed import wire

        if isinstance(frame, wire.RFFFrame):
            return (FeatureMap("rff", seed=frame.seed, d_orig=frame.d_orig,
                               m=frame.dim, lengthscale=frame.lengthscale),
                    frame.fhash)
        return (FeatureMap("sketch", seed=frame.seed, d_orig=frame.d_orig,
                           m=frame.dim), frame.rhash)

    def _check_feature_frame(self, t: Tenant, frame) -> str | None:
        """§IV-F feature-map consistency for PROJ and RFF uploads.

        Every feature upload for a tenant must declare the SAME map identity
        (kind, seed, d_orig, m, lengthscale), and the claimed hash must match
        the arrays the server derives from that identity, or the two sides
        only *believe* they share a map. A tenant already holding unsketched
        statistics rejects feature uploads outright. The map identity is
        write-once under the tenant lock. Returns an error string or None.
        """
        try:
            cand, claimed = self._frame_map(frame)
        except ValueError as e:    # un-constructible identity (bad params)
            return str(e)
        with t.lock:
            if t.feature_map is None:
                if t.engine.client_ids or int(t.engine.backend.count) != 0:
                    return ("tenant already holds unsketched statistics; "
                            "a §IV-F upload would silently mix spaces")
                if cand.fhash != claimed:
                    return (f"feature-map hash mismatch: frame says "
                            f"{claimed:#010x}, server derived "
                            f"{cand.fhash:#010x} from seed {frame.seed}")
                t.feature_map = cand
                return None
            p = t.feature_map
            if p != cand or claimed != p.fhash:
                what = "sketch" if p.kind == "sketch" else "rff map"
                return (f"conflicting {what}: tenant fused kind={p.kind} "
                        f"seed={p.seed} d_orig={p.d_orig} m={p.m}, frame "
                        f"has kind={cand.kind} seed={cand.seed} "
                        f"d_orig={cand.d_orig} m={cand.m}")
            return None

    # -- serving -------------------------------------------------------------

    def _lift(self, t: Tenant, v: torch.Tensor) -> torch.Tensor:
        """Solve-space solution -> served weights through the tenant's map
        (Prop 3's w~ = R v for sketches; identity for rff)."""
        if t.feature_map is None:
            return v
        return t.feature_map.lift(v)

    def solve_lifted(self, name: str, sigma: float) -> torch.Tensor:
        """Phase-3 solve in the tenant's serving space: ``solve``, lifted
        through the tenant's §IV-F map when it has one."""
        t = self.tenant(name)
        return self._lift(t, self.solve(name, sigma))

    def solve_report(self, name: str, sigma: float, *, level: float = 0.95,
                     queries: torch.Tensor | None = None) -> dict:
        """``solve_lifted`` plus §IV-F metadata and federated inference.

        Sketched tenants carry the Prop-3 bound c·sqrt(d/m)·||w|| at c = 1,
        with the lifted solution's own norm for ||w||. ``stderr`` / ``ci``
        / ``pi`` come off the tenant's cached factor (``server.inference``)
        and are None without a residual second moment. ``queries`` are
        raw-space rows, featurized through the tenant's map when it has one.
        """
        t = self.tenant(name)
        v = self.solve(name, sigma)
        w = self._lift(t, v)
        report = {"sigma": float(sigma), "kind": t.kind,
                  "solve_dim": int(t.engine.dim), "weights": w,
                  "stderr": None, "ci": None, "pi": None}
        fm = t.feature_map
        if fm is not None:
            report["d_orig"] = fm.d_orig
            report["m"] = fm.m
            report["upload_floats"] = fm.upload_floats()
            bound = fm.error_bound(float(torch.linalg.norm(w)))
            if bound is not None:
                report["error_bound"] = bound
        q = queries
        if q is not None and fm is not None:
            q = fm(torch.atleast_2d(q))
        inf = self._locked(
            name, lambda e: e.inference(sigma, level=level, queries=q))
        if inf is not None:
            report["stderr"] = inf["stderr"]
            report["ci"] = inf["ci"]
            report["pi"] = inf["pi"]
            report["inference"] = {k: inf[k] for k in
                                   ("level", "n", "dof", "rss", "sigma2")}
        return report

    def drop_tenant(self, name: str) -> FusionEngine:
        """Remove a tenant entirely; returns its engine (caller may archive)."""
        with self._reg_lock:
            t = self._tenants.pop(name)
        with t.lock:
            return t.engine

    # -- locked per-tenant operations ----------------------------------------

    def _locked(self, name: str, fn: Callable[[FusionEngine], Any], *,
                drains: bool = True, floats: int = 0, wire_bytes: int = 0,
                warms: bool = False, quota_client: Hashable | None = None
                ) -> Any:
        t = self.tenant(name)
        with t.lock:
            if quota_client is not None:
                # Before any accounting: a refused ingest counts no bytes.
                self._check_client_quota(t, quota_client)
            if drains:
                # A queued delta is about to be folded in: record its age.
                age = t.engine.oldest_pending_age_s
                if age > 0.0:
                    t.max_flush_age_s = max(t.max_flush_age_s, age)
            t.last_used = time.monotonic()
            t.streamed_floats += floats
            if wire_bytes:
                t.wire_frames += 1
                t.wire_upload_bytes += wire_bytes
            out = fn(t.engine)
        if warms:
            self._maybe_evict()
        return out

    @staticmethod
    def _delta_floats(stats: SuffStats) -> int:
        """Thm-4 wire floats a statistics delta would cost (packed Gram)."""
        d = stats.dim
        return d * (d + 1) // 2 + d

    def ingest(self, name: str, stats: SuffStats,
               client_id: Hashable | None = None, **kw) -> None:
        self._locked(name, lambda e: e.ingest(stats, client_id=client_id, **kw),
                     floats=self._delta_floats(stats), quota_client=client_id)

    def ingest_async(self, name: str, stats: SuffStats,
                     client_id: Hashable | None = None, **kw) -> None:
        self._locked(name,
                     lambda e: e.ingest_async(stats, client_id=client_id, **kw),
                     drains=False, floats=self._delta_floats(stats),
                     quota_client=client_id)

    def ingest_rows(self, name: str, A: torch.Tensor, b: torch.Tensor,
                    client_id: Hashable | None = None) -> SuffStats:
        return self._locked(
            name, lambda e: e.ingest_rows(A, b, client_id=client_id),
            floats=A.shape[0] * (A.shape[1] + 1), quota_client=client_id)

    def ingest_rows_async(self, name: str, A: torch.Tensor, b: torch.Tensor,
                          client_id: Hashable | None = None) -> SuffStats:
        return self._locked(
            name, lambda e: e.ingest_rows_async(A, b, client_id=client_id),
            drains=False, floats=A.shape[0] * (A.shape[1] + 1),
            quota_client=client_id)

    def drop(self, name: str, client_id: Hashable) -> None:
        self._locked(name, lambda e: e.drop(client_id))

    def restore(self, name: str, client_id: Hashable) -> None:
        self._locked(name, lambda e: e.restore(client_id))

    def apply(self, name: str, fn: Callable[[SuffStats], SuffStats]) -> None:
        self._locked(name, lambda e: e.apply(fn))

    def stats(self, name: str) -> SuffStats:
        return self._locked(name, lambda e: e.stats)

    def _snapshot_factor(self, name: str, sigma: float):
        """Under the tenant lock: drain, factor (cached), snapshot operands.

        Returns ``(w, None)`` when the backend declines the snapshot and the
        solve ran under the lock, else ``(None, (L, G, h, sigma))`` for a
        lock-free solve by the caller. The engine never writes a factor or
        a statistic in place, so the operands stay valid after the lock is
        released, whatever flushes follow.
        """
        t = self.tenant(name)
        with t.lock:
            age = t.engine.oldest_pending_age_s
            if age > 0.0:
                t.max_flush_age_s = max(t.max_flush_age_s, age)
            t.last_used = time.monotonic()
            factor = t.engine.factor(sigma)
            ops = t.engine.backend.solve_operands(factor, float(sigma))
            if ops is None:
                return t.engine.backend.solve(factor, float(sigma)), None
        return None, ops

    def solve(self, name: str, sigma: float) -> torch.Tensor:
        """Phase-3 solve holding the tenant lock only for drain + factor +
        snapshot: the solve itself runs outside the lock, through the same
        function as the engine's, so the bits are the engine's."""
        w, ops = self._snapshot_factor(name, sigma)
        if ops is not None:
            w = solve_snapshot(*ops)
        self._maybe_evict()
        return w

    def solve_many(self, requests: Sequence[tuple[str, float]], *,
                   lifted: bool = False) -> list[torch.Tensor]:
        """Cross-tenant batched Phase 3: many (tenant, sigma) solves, ONE
        stacked sweep per (solve-space d, dtype) bucket.

        Per request the tenant's lock is held only to drain its queue and
        snapshot the cached factor's operands (a cold factorization if
        needed, as in ``solve``); each bucket then runs as one
        :func:`~repro_torch.server.batch.solve_stacked` sweep with no lock
        held. Lanes are bit-identical to each tenant's lone ``solve`` at the
        same state. A sketched / rff tenant snapshots its m-space factor, so
        it rides the same sweep as dense dim-m tenants; ``lifted`` applies
        each tenant's §IV-F lift after the sweep, as ``solve_lifted`` does.
        """
        reqs = [(name, float(sigma)) for name, sigma in requests]
        results: list[torch.Tensor | None] = [None] * len(reqs)
        buckets: dict[tuple, list[tuple[int, tuple]]] = {}
        for i, (name, sigma) in enumerate(reqs):
            w, ops = self._snapshot_factor(name, sigma)
            if ops is None:
                results[i] = w
            else:
                key = (ops[0].shape[-1], ops[0].dtype)
                buckets.setdefault(key, []).append((i, ops))
        for entries in buckets.values():
            ws = solve_stacked([ops for _, ops in entries])
            for (i, _), w in zip(entries, ws):
                results[i] = w
            self.batched_sweeps += 1
            self.batched_solves += len(entries)
        if lifted:
            for i, (name, _) in enumerate(reqs):
                results[i] = self._lift(self.tenant(name), results[i])
        self._maybe_evict()
        return results

    def solve_batch(self, name: str, sigmas: Sequence[float], *,
                    method: str = "auto") -> torch.Tensor:
        return self._locked(name, lambda e: e.solve_batch(sigmas, method=method),
                            warms=True)

    def predict(self, name: str, A: torch.Tensor, sigma: float) -> torch.Tensor:
        """Hot-path predictions; rides the lock-snapshot ``solve``."""
        return A @ self.solve(name, sigma)

    def predict_batch(self, name: str, A: torch.Tensor,
                      sigmas: Sequence[float]) -> torch.Tensor:
        return self._locked(name, lambda e: e.predict_batch(A, sigmas),
                            warms=True)

    def flush(self, name: str | None = None) -> int:
        """Drain one tenant's queue (or every tenant's); returns #deltas."""
        if name is not None:
            return self._locked(name, lambda e: e.flush())
        folded = 0
        for t in self._snapshot():
            with t.lock:
                age = t.engine.oldest_pending_age_s
                if age > 0.0:
                    t.max_flush_age_s = max(t.max_flush_age_s, age)
                folded += t.engine.flush()
        return folded

    @property
    def pending_deltas(self) -> int:
        """Queued-but-unapplied deltas across all tenants (monitoring)."""
        return sum(t.engine.pending_deltas for t in self._snapshot())

    # -- LRU factor eviction --------------------------------------------------

    def _maybe_evict(self) -> None:
        """Keep at most ``max_warm`` tenants' factor caches resident.

        Called with NO tenant lock held; eviction only takes a lock that is
        free (a tenant busy enough to hold its lock is warm by definition),
        so it cannot deadlock against concurrent wrappers.
        """
        if self.max_warm is None:
            return
        warm = [t for t in self._snapshot()
                if t.engine.cached_factor_count
                or t.engine.backend.spectral_ready]
        if len(warm) <= self.max_warm:
            return
        warm.sort(key=lambda t: t.last_used)        # coldest first
        for t in warm[:len(warm) - self.max_warm]:
            if not t.lock.acquire(blocking=False):
                continue
            try:
                if t.engine.release_factors():
                    t.factor_evictions += 1
            finally:
                t.lock.release()

    def warm_tenants(self) -> tuple[str, ...]:
        return tuple(t.name for t in self._snapshot()
                     if t.engine.cached_factor_count
                     or t.engine.backend.spectral_ready)

    # -- background flusher ---------------------------------------------------

    def flush_stale(self) -> int:
        """One flusher sweep: flush every tenant whose oldest queued delta
        outlived its policy's ``max_staleness_s``. Returns #deltas folded.
        The background thread calls it on a timer; tests call it directly."""
        folded = 0
        for t in self._snapshot():
            if not t.lock.acquire(blocking=False):
                continue   # a producer/reader holds it; their ops tick the clock
            try:
                age = t.engine.oldest_pending_age_s
                if (t.engine.pending_deltas
                        and age >= t.engine.coalesce.max_staleness_s):
                    # Counted before the flush, so a monitor that observes
                    # pending == 0 also observes the flush that caused it.
                    t.max_flush_age_s = max(t.max_flush_age_s, age)
                    t.background_flushes += 1
                    folded += t.engine.flush()
            finally:
                t.lock.release()
        return folded

    def _derive_interval(self) -> float:
        finite = [t.engine.coalesce.max_staleness_s for t in self._snapshot()
                  if t.engine.coalesce.max_staleness_s != float("inf")]
        if not finite:
            return 0.05
        return min(max(min(finite) / 4.0, 0.005), 0.25)

    def start_flusher(self, interval_s: float | None = None) -> threading.Thread:
        """Start the staleness-enforcing daemon (idempotent while running).

        ``interval_s`` defaults to a quarter of the tightest finite
        ``max_staleness_s`` across tenants, clamped to [5 ms, 250 ms].
        """
        if self._flusher is not None and self._flusher.is_alive():
            return self._flusher
        interval = self._derive_interval() if interval_s is None else interval_s
        self._stop = threading.Event()
        stop = self._stop

        def loop():
            while not stop.wait(interval):
                self.flush_stale()

        self._flusher = threading.Thread(
            target=loop, name=f"EnginePool-flusher-{id(self):x}", daemon=True)
        self._flusher.start()
        return self._flusher

    @property
    def flusher_alive(self) -> bool:
        return self._flusher is not None and self._flusher.is_alive()

    def stop_flusher(self, timeout: float = 5.0) -> None:
        """Stop and join the flusher thread; a no-op when none runs."""
        flusher = self._flusher
        if flusher is None:
            return
        self._stop.set()
        if flusher is threading.current_thread():  # pragma: no cover
            self._flusher = None
            return
        flusher.join(timeout=timeout)
        if flusher.is_alive():   # pragma: no cover - join timed out
            raise RuntimeError("EnginePool flusher failed to stop")
        self._flusher = None

    def close(self) -> None:
        """Shut the pool down: stop the flusher, commit a final snapshot
        (journaled pools) and close the journal. Idempotent and safe from
        ``__exit__``, ``__del__`` and signal handlers in any combination:
        every call stops a (re)started flusher, and the durable
        finalization runs exactly once."""
        self.stop_flusher()
        if self._store is None:
            return
        with self._close_lock:
            if self._closed:
                return
            self._closed = True
        try:
            self.snapshot()    # the final durable cut: a restart replays 0
        finally:
            if self._journal is not None:
                self._journal.close()

    def __enter__(self) -> "EnginePool":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def __del__(self) -> None:   # pragma: no cover - interpreter teardown
        try:
            self.close()
        except Exception:
            pass

    # -- observability --------------------------------------------------------

    def ledger(self) -> dict:
        """Pool-level ``fed.comm`` rollup: admission uploads (measured where
        payloads were given), streamed §VI-C bytes, and — for tenants fed
        through ``admit_frame`` — the encoded byte lengths of the wire
        frames that moved (upload direction) and of the replies (download),
        per tenant, per tenant kind (dense / sketched / rff), per tier and in
        total, with the reference's keys."""
        from repro_torch.fed import comm as fed_comm

        snapshot = self._snapshot()
        out = fed_comm.aggregate_records(
            {t.name: t.comm for t in snapshot if t.comm is not None},
            kinds={t.name: t.kind for t in snapshot})
        streamed = wire_up = wire_down = relay_frames = wire_frames = 0
        by_kind = out["by_kind"]
        for t in snapshot:
            entry = out["per_tenant"].setdefault(t.name, {})
            entry["kind"] = t.kind
            entry["streamed_bytes"] = t.streamed_floats * fed_comm.FLOAT_BYTES
            streamed += entry["streamed_bytes"]
            if t.wire_frames:
                entry["wire_frames"] = t.wire_frames
                entry["wire_upload_bytes"] = t.wire_upload_bytes
                entry["wire_download_bytes"] = t.wire_download_bytes
                if t.relay_frames:
                    entry["relay_frames"] = t.relay_frames
            wire_frames += t.wire_frames
            relay_frames += t.relay_frames
            wire_up += t.wire_upload_bytes
            wire_down += t.wire_download_bytes
            # Tenants admitted over the wire carry no CommRecord, so the
            # kind split folds their measured bytes in here.
            k = by_kind.setdefault(t.kind, {"tenants": 0,
                                            "upload_download_bytes": 0,
                                            "analytic_bytes": 0})
            if t.comm is None:
                k["tenants"] += 1
            k["streamed_bytes"] = (k.get("streamed_bytes", 0)
                                   + entry["streamed_bytes"])
            k["wire_upload_bytes"] = (k.get("wire_upload_bytes", 0)
                                      + t.wire_upload_bytes)
            k["wire_download_bytes"] = (k.get("wire_download_bytes", 0)
                                        + t.wire_download_bytes)
            k["upload_bytes"] = (k["upload_download_bytes"]
                                 + k["streamed_bytes"]
                                 + k["wire_upload_bytes"])
        out["streamed_bytes"] = streamed
        out["wire_upload_bytes"] = wire_up
        out["wire_download_bytes"] = wire_down
        out["total_bytes"] = (out["upload_download_bytes"] + streamed
                              + wire_up + wire_down)
        # Upload-frame ingress split by origin tier: frames forwarded by a
        # relay (wire.is_relay_client ids) vs direct client uploads.
        out["tier"] = self.tier
        out["by_tier"] = {"relay_frames": relay_frames,
                          "client_frames": wire_frames - relay_frames}
        return out

    def summary(self) -> dict:
        snapshot = self._snapshot()
        placements: dict[str, int] = {}
        for t in snapshot:
            placements[t.backend_name] = placements.get(t.backend_name, 0) + 1
        return {
            "tenants": len(snapshot),
            "placements": placements,
            "meshes_built": self.meshes_built,
            "flusher_alive": self.flusher_alive,
            "background_flushes": sum(t.background_flushes for t in snapshot),
            "max_flush_age_s": max(
                (t.max_flush_age_s for t in snapshot), default=0.0),
            "factor_evictions": sum(t.factor_evictions for t in snapshot),
            "psd_repairs": sum(t.psd_repairs for t in snapshot),
            "batched_sweeps": self.batched_sweeps,
            "batched_solves": self.batched_solves,
            "admission_rejections": self.admission_rejections,
            "resident_stat_bytes": self.resident_stat_bytes(),
            "warm_tenants": len(self.warm_tenants()),
            "journaled": self.journaled,
            "snapshots_taken": self.snapshots_taken,
            "replayed_frames": self.replayed_frames,
            "restored_tenants": self.restored_tenants,
            "duplicates": sum(t.duplicates for t in snapshot),
            "per_tenant": {t.name: t.summary() for t in snapshot},
        }
