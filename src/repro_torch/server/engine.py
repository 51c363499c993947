"""FusionEngine — the stateful one-shot fusion server (policy layer).

One object owns the fused :class:`SuffStats`, retains per-client
contributions, and exposes every server-side capability of the paper as a
method:

==================  =======================================================
method              paper surface
==================  =======================================================
``ingest``          Phase 2 aggregation (Thm 1) / streaming updates (§VI-C)
``ingest_rows``     §VI-C with row-level deltas (incremental factor update)
``ingest_async``    queued §VI-C deltas, coalesced into one rank-r mutation
``flush``           apply the async queue as ONE fused delta (Thm 1 batching)
``ingest_distributed``  Phases 1+2 on a mesh: shard-local stats, one reduction
``drop/restore``    client dropout and rejoin (Thm 8) — exact on the subset
``solve``           Phase 3 ridge solve (Thm 3), factor cached per sigma
``solve_batch``     one batched multi-sigma solve (batched Phase 3)
``loco_weights``    all K leave-one-client-out models, all sigmas (Prop 5)
``loco_cv``         Prop 5 sigma selection as ONE vectorized solve
``predict``         serving hot path: x -> x @ w_sigma off the cached factor
``inference``       stderr / CI / PI off the cached factor (server.inference)
==================  =======================================================

The engine is backend-agnostic: the linear algebra on the fused ``(G, h)``
is delegated to a :class:`~repro_torch.server.backends.LinalgBackend`
(dense single-device by default; ``server.distributed.ShardedBackend``
keeps ``G`` block-sharded over a mesh). What stays here is policy: the
per-client
ledger, the async ingest coalescer (:class:`CoalescerPolicy`), per-sigma
factor caching with staleness-bounded incremental updates, and the
chol-vs-spectral ``solve_batch`` choice. ``core.fusion`` holds the
pure-function references the engine is tested against.
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import Any, Callable, Hashable, Mapping, Sequence

import torch

from repro_torch.core.fusion import cholesky_or_nan
from repro_torch.core.sufficient_stats import SuffStats, compute_stats, fuse_stats
from repro_torch.server.backends import DenseBackend, LinalgBackend
from repro_torch.server.cholesky import psd_update_vectors


@dataclasses.dataclass
class _CachedFactor:
    factor: Any       # backend-opaque factor of G + sigma I
    stale_rank: int   # update vectors absorbed since the last full factorization


@dataclasses.dataclass(frozen=True)
class CoalescerPolicy:
    """When the async ingest queue folds itself into the factors.

    A flush applies the whole queue as ONE fused delta. Auto-flush triggers
    when the queued update rank reaches ``max_rank`` (keep it <= the
    engine's ``max_update_rank`` so a flush stays incremental) or when the
    oldest queued delta is older than ``max_staleness_s``, checked on every
    queue/read operation.
    """

    max_rank: int = 64
    max_staleness_s: float = math.inf


@dataclasses.dataclass
class _PendingDelta:
    stats: SuffStats
    client_id: Hashable | None
    update_vectors: torch.Tensor | None
    rank_bound: int           # conservative rank if vectors are unknown
    queued_at: float


def _loco_solve(G, h, Gk, hk, sigmas):
    """w_{-k}(sigma) for every client k and sigma: (K, S, d)."""
    Gm = G[None] - Gk                      # (K, d, d)
    hm = h[None] - hk                      # (K, d)
    eye = torch.eye(G.shape[0], dtype=G.dtype, device=G.device)
    Ls = cholesky_or_nan(Gm[:, None] + sigmas[None, :, None, None] * eye)
    return torch.cholesky_solve(hm[:, None, :, None].expand(
        -1, sigmas.shape[0], -1, -1), Ls).squeeze(-1)


def _nbytes(t) -> int:
    """Bytes of a tensor, or of a backend's opaque factor (its ``nbytes``)."""
    if isinstance(t, torch.Tensor):
        return t.numel() * t.element_size()
    return int(t.nbytes)


class FusionEngine:
    """Stateful fusion server over one model's sufficient statistics."""

    def __init__(self, dim: int, *, dtype=None,
                 backend: LinalgBackend | None = None,
                 max_update_rank: int | None = None, rank_tol: float = 1e-7,
                 coalesce: CoalescerPolicy | None = None, device="cuda"):
        if isinstance(backend, str):
            raise ValueError(f"backend={backend!r}: pass a backend instance "
                             "(from_clients resolves backend='auto')")
        if backend is None:
            backend = DenseBackend(dim, dtype=dtype if dtype is not None
                                   else torch.float32, device=device)
        elif dtype is not None and dtype != backend.dtype:
            raise ValueError(f"requested dtype {dtype} != backend "
                             f"dtype {backend.dtype}")
        self.backend: LinalgBackend = backend
        if self.backend.dim != dim:
            raise ValueError(
                f"backend dim {self.backend.dim} != engine dim {dim}")
        self._clients: dict[Hashable, SuffStats] = {}
        # dropped id -> (stats, update vectors computed at drop time, reused
        # verbatim on restore so drop->restore round-trips the factors)
        self._dropped: dict[Hashable, tuple[SuffStats, torch.Tensor | None]] = {}
        self._factors: dict[float, _CachedFactor] = {}
        self.max_update_rank = (max(1, dim // 4) if max_update_rank is None
                                else max_update_rank)
        self.rank_tol = rank_tol
        self.dtype = self.backend.dtype
        self.coalesce = (CoalescerPolicy(max_rank=self.max_update_rank)
                         if coalesce is None else coalesce)
        self._pending: list[_PendingDelta] = []
        self.stats_version = 0
        self.cold_factorizations = 0
        self.incremental_updates = 0
        self.flushes = 0
        self.coalesced_deltas = 0
        #: flushes by the rank of the delta they applied (the blocked P/K2
        #: update from rank 8, the eager rank-1 scan below it)
        self.flush_ranks: dict[int, int] = {}

    # -- construction -------------------------------------------------------

    @classmethod
    def from_clients(cls, stats: Mapping[Hashable, SuffStats] | Sequence[SuffStats],
                     **kwargs) -> "FusionEngine":
        """Engine over per-client stats; retains each for drop/restore/LOCO.

        ``backend="auto"`` (with optional ``mesh=`` and ``threshold=``)
        picks dense or sharded through :func:`server.select.auto_backend`.
        """
        items = list(stats.items() if isinstance(stats, Mapping)
                     else enumerate(stats))
        if not items:
            raise ValueError("need at least one client's statistics")
        first = items[0][1]
        kwargs.setdefault("dtype", first.gram.dtype)
        kwargs.setdefault("device", first.gram.device)
        if kwargs.get("backend") == "auto":
            from repro_torch.server.select import auto_backend

            kwargs["backend"] = auto_backend(
                first.dim, kwargs.pop("mesh", None),
                threshold=kwargs.pop("threshold", None),
                dtype=kwargs["dtype"], device=kwargs["device"])
        backend = kwargs.get("backend")
        if backend is not None and int(backend.count) != 0:
            raise ValueError(
                "backend already holds fused statistics "
                f"(count={int(backend.count)}); build the engine with "
                "from_stats, or pass a fresh backend")
        eng = cls(first.dim, **kwargs)
        for cid, s in items:
            eng.ingest(s, client_id=cid)
        return eng

    @classmethod
    def from_stats(cls, stats: SuffStats, **kwargs) -> "FusionEngine":
        """Engine over pre-fused statistics (no per-client retention)."""
        kwargs.setdefault("dtype", stats.gram.dtype)
        kwargs.setdefault("device", stats.gram.device)
        eng = cls(stats.dim, **kwargs)
        eng.backend.set_stats(stats)
        eng.stats_version += 1
        return eng

    # -- inspection ---------------------------------------------------------

    @property
    def stats(self) -> SuffStats:
        self.flush()
        return self.backend.stats()

    @property
    def dim(self) -> int:
        return self.backend.dim

    @property
    def client_ids(self) -> tuple[Hashable, ...]:
        return tuple(self._clients)

    @property
    def dropped_ids(self) -> tuple[Hashable, ...]:
        return tuple(self._dropped)

    @property
    def count(self) -> int:
        """Effective sample size currently fused (Thm 8 reporting)."""
        self.flush()
        return int(self.backend.count)

    def summary(self) -> dict:
        return {
            "dim": self.dim,
            "backend": self.backend.name,
            "clients": len(self._clients),
            "dropped": len(self._dropped),
            "rows": int(self.backend.count),
            "cached_sigmas": sorted(self._factors),
            "spectral_cached": self.backend.spectral_ready,
            "stats_version": self.stats_version,
            "cold_factorizations": self.cold_factorizations,
            "incremental_updates": self.incremental_updates,
            "flushes": self.flushes,
            "coalesced_deltas": self.coalesced_deltas,
            "pending_deltas": self.pending_deltas,
        }

    # -- mutation (Thm 1 / Thm 8 / §VI-C) -----------------------------------

    def ingest(self, stats: SuffStats, client_id: Hashable | None = None, *,
               update_vectors: torch.Tensor | None = None) -> None:
        """Fold a statistics delta into the server state (Thm 1 additivity).

        ``client_id`` retains the contribution for ``drop``/``restore`` and
        LOCO; repeated ingests under one id accumulate. ``update_vectors``
        (r, d) with ``U^T U = stats.gram`` let cached factors be up-dated
        incrementally; without them the PSD square root is derived (or, for
        a clearly high-rank delta, the cache is invalidated).
        """
        if stats.dim != self.dim:
            raise ValueError(f"stats dim {stats.dim} != engine dim {self.dim}")
        self.flush()
        self.backend.fuse(stats, 1.0)
        if client_id is not None:
            prev = self._clients.get(client_id)
            self._clients[client_id] = stats if prev is None else prev + stats
        self._touch_factors(stats, update_vectors, sign=1.0)

    def ingest_rows(self, A: torch.Tensor, b: torch.Tensor,
                    client_id: Hashable | None = None) -> SuffStats:
        """§VI-C streaming: fold raw rows in; the rows ARE the update vectors."""
        s = compute_stats(A, b)
        self.ingest(s, client_id=client_id, update_vectors=A.to(self.dtype))
        return s

    # -- async ingest (coalescing queue) -------------------------------------

    @property
    def pending_deltas(self) -> int:
        return len(self._pending)

    @property
    def oldest_pending_age_s(self) -> float:
        """Age of the oldest queued delta (0 when the queue is empty)."""
        if not self._pending:
            return 0.0
        return time.monotonic() - self._pending[0].queued_at

    @property
    def pending_rank(self) -> int:
        """Conservative update rank the queue would apply when flushed."""
        return sum(p.rank_bound for p in self._pending)

    def ingest_async(self, stats: SuffStats,
                     client_id: Hashable | None = None, *,
                     update_vectors: torch.Tensor | None = None) -> None:
        """Queue a statistics delta; visible only after the next flush."""
        if stats.dim != self.dim:
            raise ValueError(f"stats dim {stats.dim} != engine dim {self.dim}")
        bound = (int(update_vectors.shape[0]) if update_vectors is not None
                 else min(int(stats.count), self.dim))
        self._pending.append(_PendingDelta(stats, client_id, update_vectors,
                                           bound, time.monotonic()))
        self._autoflush()

    def ingest_rows_async(self, A: torch.Tensor, b: torch.Tensor,
                          client_id: Hashable | None = None) -> SuffStats:
        """§VI-C streaming through the coalescer: queue rows, flush later."""
        s = compute_stats(A, b)
        self.ingest_async(s, client_id=client_id,
                          update_vectors=A.to(self.dtype))
        return s

    def flush(self) -> int:
        """Apply the whole queue as one fused delta; returns #deltas folded."""
        if not self._pending:
            return 0
        pending, self._pending = self._pending, []
        combined = fuse_stats([p.stats for p in pending])
        vectors = None
        if all(p.update_vectors is not None for p in pending):
            vectors = torch.cat([p.update_vectors for p in pending])
        self.backend.fuse(combined, 1.0)
        for p in pending:
            if p.client_id is not None:
                prev = self._clients.get(p.client_id)
                self._clients[p.client_id] = (p.stats if prev is None
                                              else prev + p.stats)
        self._touch_factors(combined, vectors, sign=1.0)
        self.flushes += 1
        self.coalesced_deltas += len(pending)
        rank = (int(vectors.shape[0]) if vectors is not None
                else sum(p.rank_bound for p in pending))
        self.flush_ranks[rank] = self.flush_ranks.get(rank, 0) + 1
        return len(pending)

    def _autoflush(self) -> None:
        if not self._pending:
            return
        over_rank = self.pending_rank >= self.coalesce.max_rank
        stale = (time.monotonic() - self._pending[0].queued_at
                 >= self.coalesce.max_staleness_s)
        if over_rank or stale:
            self.flush()

    def ingest_distributed(self, A: torch.Tensor, b: torch.Tensor,
                           **kwargs) -> None:
        """Phases 1+2 on a mesh: each row shard's statistics are reduced
        straight into the backend's (sharded) state.

        Needs a backend with ``fuse_distributed`` (``ShardedBackend``);
        ``participation`` and ``noise_fn`` pass through. Mesh shards are not
        ledger clients: dropout on this path is the participation mask
        (Thm 8), not ``drop``/``restore``.
        """
        self.flush()
        fuse = getattr(self.backend, "fuse_distributed", None)
        if fuse is None:
            raise ValueError(
                f"backend {self.backend.name!r} has no on-mesh fusion path")
        fuse(A, b, **kwargs)
        # an unknown-rank delta folded behind the engine's back: drop caches
        self._factors.clear()
        self.stats_version += 1

    def drop(self, client_id: Hashable) -> None:
        """Thm 8: remove a client; state becomes exact on the remaining subset."""
        self.flush()
        s = self._clients.pop(client_id)  # KeyError for unknown/already-dropped
        vectors = self._touch_factors(s, None, sign=-1.0)
        self.backend.fuse(s, -1.0)
        self._dropped[client_id] = (s, vectors)

    def restore(self, client_id: Hashable) -> None:
        """Thm 8 rejoin: add a dropped client back, exactly."""
        self.flush()
        s, vectors = self._dropped.pop(client_id)
        self.backend.fuse(s, 1.0)
        prev = self._clients.get(client_id)
        self._clients[client_id] = s if prev is None else prev + s
        self._touch_factors(s, vectors, sign=1.0)

    def export_ledger(self) -> tuple[dict[Hashable, SuffStats],
                                     dict[Hashable, SuffStats]]:
        """Snapshot of the retained ledger: ``(clients, dropped)`` stats."""
        self.flush()
        return (dict(self._clients),
                {cid: s for cid, (s, _) in self._dropped.items()})

    def import_ledger(self, clients: Mapping[Hashable, SuffStats],
                      dropped: Mapping[Hashable, SuffStats]) -> None:
        """Install a retained ledger beside already-restored fused stats.

        Only valid on an engine whose ledger is still empty — anything else
        would double-count contributions.
        """
        if self._clients or self._dropped or self._pending:
            raise ValueError("import_ledger requires an empty ledger "
                             f"({len(self._clients)} clients, "
                             f"{len(self._dropped)} dropped, "
                             f"{len(self._pending)} pending)")
        for cid, s in list(clients.items()) + list(dropped.items()):
            if s.dim != self.dim:
                raise ValueError(f"client {cid!r} stats dim {s.dim} != "
                                 f"engine dim {self.dim}")
        self._clients = dict(clients)
        self._dropped = {cid: (s, None) for cid, s in dropped.items()}

    def apply(self, fn: Callable[[SuffStats], SuffStats]) -> None:
        """Post-process fused stats (e.g. a PSD repair); drops caches."""
        self.flush()
        self.backend.set_stats(fn(self.backend.stats()))
        self._factors.clear()
        self.stats_version += 1

    def _touch_factors(self, delta: SuffStats, update_vectors, sign: float):
        """Up/down-date every cached factor by a PSD delta, or evict it."""
        self.stats_version += 1
        if not self._factors:
            return update_vectors
        if not self.backend.supports_update:
            self._factors.clear()
            return update_vectors
        if update_vectors is None:
            # rank(G_k) <= min(rows, d); skip the eigh when it cannot pay off.
            bound = min(int(delta.count), self.dim)
            if bound <= self.max_update_rank:
                update_vectors = psd_update_vectors(delta.gram,
                                                    tol=self.rank_tol)
        rank = None if update_vectors is None else int(update_vectors.shape[0])
        fresh: dict[float, _CachedFactor] = {}
        for sigma, f in self._factors.items():
            if rank is not None and f.stale_rank + rank <= self.max_update_rank:
                updated = self.backend.update(f.factor, update_vectors, sign)
                if updated is not None:
                    fresh[sigma] = _CachedFactor(updated, f.stale_rank + rank)
                    self.incremental_updates += 1
            # else: evict; next solve at this sigma refactorizes from scratch.
        self._factors = fresh
        return update_vectors

    def release_factors(self) -> int:
        """Drop every cached factor (and the backend's spectral cache)."""
        n = len(self._factors) + (1 if self.backend.spectral_ready else 0)
        self._factors.clear()
        release = getattr(self.backend, "release", None)
        if release is not None:
            release()
        return n

    @property
    def cached_factor_count(self) -> int:
        return len(self._factors)

    @property
    def retained_clients(self) -> int:
        return len(self._clients) + len(self._dropped)

    @property
    def resident_bytes(self) -> int:
        """Bytes this tenant pins: fused stats, ledger, factor cache."""
        n = int(getattr(self.backend, "state_bytes", 0))
        for s in self._clients.values():
            n += _nbytes(s.gram) + _nbytes(s.moment)
        for s, vectors in self._dropped.values():
            n += _nbytes(s.gram) + _nbytes(s.moment)
            if vectors is not None:
                n += _nbytes(vectors)
        for f in self._factors.values():
            n += _nbytes(f.factor)
        return n

    # -- solving (Thm 3 / Prop 5) -------------------------------------------

    def factor(self, sigma: float):
        """Cached (or freshly computed) factor of G + sigma I."""
        self.flush()
        key = float(sigma)
        f = self._factors.get(key)
        if f is None:
            f = _CachedFactor(self.backend.factor(key), 0)
            self._factors[key] = f
            self.cold_factorizations += 1
        return f.factor

    def solve(self, sigma: float) -> torch.Tensor:
        """Phase 3 (Thm 3): w = (G + sigma I)^{-1} h off the cached factor."""
        return self.backend.solve(self.factor(sigma), float(sigma))

    def solve_batch(self, sigmas: Sequence[float], *,
                    method: str = "auto") -> torch.Tensor:
        """All sigmas in one batched solve; returns (S, d) weights.

        ``"chol"``: one batched Cholesky sweep that also warms the per-sigma
        factor cache. ``"spectral"``: one eigendecomposition of G, cached
        until the stats change, after which any grid costs only matmuls.
        ``"auto"`` picks spectral when its eigh is cached or the grid has
        >= 16 sigmas.
        """
        self.flush()
        keys = [float(s) for s in sigmas]
        if method == "auto":
            method = ("spectral" if self.backend.spectral_ready
                      or len(keys) >= 16 else "chol")
        if method == "spectral":
            was_ready = self.backend.spectral_ready
            ws = self.backend.spectral(keys)
            if ws is not None:
                if not was_ready:
                    self.cold_factorizations += 1
                return ws
            method = "chol"
        if method != "chol":
            raise ValueError(f"unknown method {method!r}")
        factors, ws = self.backend.solve_batch(keys)
        if factors is not None:
            for k, fac in zip(keys, factors):
                self._factors[k] = _CachedFactor(fac, 0)
        return ws

    def loco_weights(self, sigmas: Sequence[float]
                     ) -> tuple[list[Hashable], torch.Tensor]:
        """Prop 5 server step for ALL (k, sigma): one call, (K, S, d)."""
        self.flush()
        if not self._clients:
            raise ValueError("no retained per-client statistics")
        ids = list(self._clients)
        fused = self.backend.stats()
        Gk = torch.stack([self._clients[i].gram for i in ids])
        hk = torch.stack([self._clients[i].moment for i in ids])
        W = _loco_solve(fused.gram, fused.moment, Gk, hk,
                        torch.tensor([float(s) for s in sigmas],
                                     dtype=fused.gram.dtype,
                                     device=fused.gram.device))
        return ids, W

    def loco_cv(self, client_data: Mapping[Hashable, tuple[torch.Tensor, torch.Tensor]]
                | Sequence[tuple[torch.Tensor, torch.Tensor]],
                sigmas: Sequence[float]):
        """Prop 5 end-to-end: vectorized solves + per-client loss evaluation.

        Returns ``(best_sigma, losses)`` like ``core.fusion.loco_cv``.
        """
        if not isinstance(client_data, Mapping):
            client_data = dict(enumerate(client_data))
        ids, W = self.loco_weights(sigmas)          # (K, S, d)
        losses = torch.zeros((len(sigmas),), dtype=self.dtype,
                             device=W.device)
        for k, cid in enumerate(ids):
            A_k, b_k = client_data[cid]
            resid = A_k @ W[k].T - b_k[:, None]     # (n_k, S)
            losses = losses + torch.mean(resid ** 2, dim=0)
        best = int(torch.argmin(losses))
        return sigmas[best], losses

    # -- serving ------------------------------------------------------------

    def predict(self, A: torch.Tensor, sigma: float) -> torch.Tensor:
        """Hot path: ridge predictions for query rows at one sigma."""
        return A @ self.solve(sigma)

    def inference(self, sigma: float, *, level: float = 0.95,
                  queries: torch.Tensor | None = None) -> dict | None:
        """Standard errors / intervals for the solve at ``sigma``, off the
        same cached factor ``solve`` uses (no new factorization). None when
        the fused statistics carry no second moment, the backend exposes no
        dense operands, or the residual degrees of freedom are <= 0."""
        from repro_torch.server.inference import inference_report

        self.flush()
        s = self.backend.stats()
        if s.yty is None:
            return None
        factor = self.factor(sigma)
        ops = self.backend.solve_operands(factor, float(sigma))
        if ops is None:
            return None
        L = ops[0]
        w = self.backend.solve(factor, float(sigma))
        return inference_report(L, s, w, sigma, level=level, queries=queries)

    def predict_batch(self, A: torch.Tensor, sigmas: Sequence[float]
                      ) -> torch.Tensor:
        """(S, n) predictions — n query rows against S regularizations."""
        return self.solve_batch(sigmas) @ A.T
