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
  * **Placement** — every tenant is dense. ``"auto"`` asks
    ``server.select`` (the port has no default crossover table, so it
    resolves dense); a sharded placement raises until the sharded backend
    is ported (ROADMAP queue 1, item 15).
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
  * **Ledger** — ``ledger()`` rolls per-tenant ``fed.comm`` records and
    streamed §VI-C bytes into one account, per tenant kind.

Every tenant of a pool lives on the pool's one device (``device=``, the
card unless the caller asks for the CPU). The wire (``admit_frame``),
durability (``journal_dir``, ``snapshot``) and the Remark-4 PSD guard are
not ported yet and raise ``NotImplementedError`` naming their ROADMAP
item; their counters in ``ledger()`` and ``summary()`` stay at 0 / False.

Thread-safety contract: the pool's wrappers are safe for concurrent use.
``get()`` hands back the raw engine for single-threaded convenience.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from typing import Any, Callable, Hashable, Mapping, Sequence

import torch

from repro_torch.core.features import FeatureMap
from repro_torch.core.sufficient_stats import SuffStats
from repro_torch.server.backends import solve_snapshot
from repro_torch.server.batch import solve_stacked
from repro_torch.server.engine import CoalescerPolicy, FusionEngine
from repro_torch.server.select import SHARDED_NOT_YET, prefer_sharded

PLACEMENTS = ("dense", "sharded", "auto")

_WIRE = ("is not ported yet: the wire codec and transport wait for ROADMAP "
         "queue 1, item 9")
_DURABLE = ("is not ported yet: the journal and snapshots wait for ROADMAP "
            "queue 1, item 12 (durability)")
_PRIVACY = ("is not ported yet: psd_repair waits for ROADMAP queue 1, "
            "item 14 (privacy)")


class AdmissionError(ValueError):
    """A tenant or client was refused for capacity, not correctness.

    A ``ValueError``, as in the reference, whose wire path answers any
    ``ValueError`` with a typed refusal.
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
    feature_map: FeatureMap | None = None  # §IV-F map identity (sketch / rff)
    background_flushes: int = 0    # flushes driven by the pool's thread
    max_flush_age_s: float = 0.0   # oldest delta age ever seen at a drain
    factor_evictions: int = 0      # LRU evictions of this tenant's factors

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
        """The reference's keys; the wire, relay and guard counters are 0."""
        with self.lock:
            return {
                "placement": self.placement,
                "backend": self.backend_name,
                "kind": self.kind,
                "streamed_floats": self.streamed_floats,
                "wire_frames": 0,
                "relay_frames": 0,
                "wire_upload_bytes": 0,
                "wire_download_bytes": 0,
                "duplicates": 0,
                "background_flushes": self.background_flushes,
                "max_flush_age_s": self.max_flush_age_s,
                "factor_evictions": self.factor_evictions,
                "psd_repairs": 0,
                "engine": self.engine.summary(),
            }


def _same_device(a: torch.device, b: torch.device) -> bool:
    """Equal devices, where an index left unset matches any index."""
    return a.type == b.type and (a.index is None or b.index is None
                                 or a.index == b.index)


class EnginePool:
    """Named multi-tenant registry of :class:`FusionEngine` servers."""

    def __init__(self, *, mesh=None, threshold: float | None = None,
                 table=None, max_warm: int | None = None,
                 max_tenants: int | None = None,
                 stat_budget_bytes: int | None = None,
                 max_clients_per_tenant: int | None = None,
                 default_coalesce: CoalescerPolicy | None = None,
                 journal_dir: str | None = None,
                 tier: str = "root", device="cuda"):
        """Args:
          mesh: a mesh for sharded tenants; raises (item 15).
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
          journal_dir: crash-safe state; raises (item 12).
          tier: accounting label ("root" / "relay"), reported by ``ledger``.
          device: where every tenant's state lives.
        """
        if mesh is not None:
            raise NotImplementedError(f"EnginePool(mesh=...) {SHARDED_NOT_YET}")
        if journal_dir is not None:
            raise NotImplementedError(f"EnginePool(journal_dir=...) {_DURABLE}")
        self._tenants: dict[str, Tenant] = {}
        self._reg_lock = threading.RLock()
        self._threshold = threshold
        self._table = table
        self.max_warm = max_warm
        self.max_tenants = max_tenants
        self.stat_budget_bytes = stat_budget_bytes
        self.max_clients_per_tenant = max_clients_per_tenant
        self.tier = tier
        self.device = torch.device(device)
        self._default_coalesce = default_coalesce
        self.batched_sweeps = 0     # cross-tenant stacked solve sweeps run
        self.batched_solves = 0     # individual solves served by those sweeps
        self.admission_rejections = 0
        self._flusher: threading.Thread | None = None
        self._stop = threading.Event()

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
                      psd_guard: bool = False) -> FusionEngine:
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
        """
        if placement not in PLACEMENTS:
            raise ValueError(f"placement must be one of {PLACEMENTS}, "
                             f"got {placement!r}")
        if psd_guard:
            raise NotImplementedError(f"create_tenant(psd_guard=True) {_PRIVACY}")
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

        eff_dtype = dtype if dtype is not None or first is None \
            else first.gram.dtype
        self._check_admission(name, dim, eff_dtype)
        self._place(dim, placement)
        kwargs: dict = {"coalesce": coalesce if coalesce is not None
                        else self._default_coalesce}
        if max_update_rank is not None:
            kwargs["max_update_rank"] = max_update_rank
        if dtype is not None:
            kwargs["dtype"] = dtype
        if unpacked is not None:
            engine = FusionEngine.from_clients(unpacked, **kwargs)
        elif stats is not None:
            engine = FusionEngine.from_stats(stats, **kwargs)
        else:
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
            itemsize = torch.finfo(dtype if dtype is not None
                                   else torch.float32).bits // 8
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

    def _place(self, dim: int, placement: str) -> None:
        """Resolve a placement request; only dense is ported."""
        if placement == "auto" and not prefer_sharded(
                dim, threshold=self._threshold, table=self._table):
            return
        if placement != "dense":
            raise NotImplementedError(
                f"placing d={dim} sharded (placement={placement!r}) "
                f"{SHARDED_NOT_YET}")

    def _admission_record(self, engine: FusionEngine, dim: int, *, payloads):
        from repro_torch.fed import comm as fed_comm

        if payloads is not None:
            return fed_comm.measured_one_shot(payloads, download_floats=dim)
        return fed_comm.one_shot_comm(dim, max(len(engine.client_ids), 1))

    # -- not ported yet ------------------------------------------------------

    def admit_frame(self, name: str, frame, **kwargs):
        """Feed one decoded wire frame into a tenant (item 9)."""
        raise NotImplementedError(f"admit_frame {_WIRE}")

    def record_wire_reply(self, name: str, nbytes: int) -> None:
        """Account a reply frame's encoded bytes (item 9)."""
        raise NotImplementedError(f"record_wire_reply {_WIRE}")

    def snapshot(self) -> int | None:
        """Commit a durable snapshot (item 12)."""
        raise NotImplementedError(f"snapshot {_DURABLE}")

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
                drains: bool = True, floats: int = 0, warms: bool = False,
                quota_client: Hashable | None = None) -> Any:
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
        """Shut the pool down: stop the flusher. Idempotent."""
        self.stop_flusher()

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
        """Pool-level ``fed.comm`` rollup — admission uploads (measured
        where payloads were given) and streamed §VI-C bytes — per tenant,
        per tenant kind (dense / sketched / rff) and in total, with the
        reference's keys; the wire and relay counters are 0."""
        from repro_torch.fed import comm as fed_comm

        snapshot = self._snapshot()
        out = fed_comm.aggregate_records(
            {t.name: t.comm for t in snapshot if t.comm is not None},
            kinds={t.name: t.kind for t in snapshot})
        streamed = 0
        by_kind = out["by_kind"]
        for t in snapshot:
            entry = out["per_tenant"].setdefault(t.name, {})
            entry["kind"] = t.kind
            entry["streamed_bytes"] = t.streamed_floats * fed_comm.FLOAT_BYTES
            streamed += entry["streamed_bytes"]
            k = by_kind.setdefault(t.kind, {"tenants": 0,
                                            "upload_download_bytes": 0,
                                            "analytic_bytes": 0})
            if t.comm is None:
                k["tenants"] += 1
            k["streamed_bytes"] = (k.get("streamed_bytes", 0)
                                   + entry["streamed_bytes"])
            k["wire_upload_bytes"] = 0
            k["wire_download_bytes"] = 0
            k["upload_bytes"] = k["upload_download_bytes"] + k["streamed_bytes"]
        out["streamed_bytes"] = streamed
        out["wire_upload_bytes"] = 0
        out["wire_download_bytes"] = 0
        out["total_bytes"] = out["upload_download_bytes"] + streamed
        out["tier"] = self.tier
        out["by_tier"] = {"relay_frames": 0, "client_frames": 0}
        return out

    def summary(self) -> dict:
        snapshot = self._snapshot()
        placements: dict[str, int] = {}
        for t in snapshot:
            placements[t.backend_name] = placements.get(t.backend_name, 0) + 1
        return {
            "tenants": len(snapshot),
            "placements": placements,
            "meshes_built": 0,
            "flusher_alive": self.flusher_alive,
            "background_flushes": sum(t.background_flushes for t in snapshot),
            "max_flush_age_s": max(
                (t.max_flush_age_s for t in snapshot), default=0.0),
            "factor_evictions": sum(t.factor_evictions for t in snapshot),
            "psd_repairs": 0,
            "batched_sweeps": self.batched_sweeps,
            "batched_solves": self.batched_solves,
            "admission_rejections": self.admission_rejections,
            "resident_stat_bytes": self.resident_stat_bytes(),
            "warm_tenants": len(self.warm_tenants()),
            "journaled": False,
            "snapshots_taken": 0,
            "replayed_frames": 0,
            "restored_tenants": 0,
            "duplicates": 0,
            "per_tenant": {t.name: t.summary() for t in snapshot},
        }
