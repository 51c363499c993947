"""Pluggable linear-algebra backends for the fusion server.

``FusionEngine`` (server.engine) is the *policy* layer — client ledger,
staleness-bounded factor reuse, sigma cache, LOCO — and delegates every
representation-dependent operation on the fused ``(G, h)`` to a
``LinalgBackend``. This slice of the port has the dense single-device
backend; the sharded one waits for the distributed slice.

Protocol: ``fuse`` (fold a stats delta into the backend-held state),
``factor``/``solve``/``solve_batch`` (Phase 3), ``update`` (incremental
factor maintenance under PSD deltas; ``None`` declines and the engine
evicts), ``spectral`` (the Corollary-1 eigh serving path), and
``solve_operands`` (the ``(L, G, h, sigma)`` operands :func:`solve_snapshot`
solves).

Float32 solves off a factor are refined once in mixed precision
(:func:`_factor_solve`), a deviation from the reference, which solves once:
a float32 factor solve alone is off by up to kappa * 2^-24 of |w|, which
reaches the port's 1e-4 checks for an RFF tenant at kappa ~ 2e4.

Cholesky, triangular / Cholesky solves and ``eigh`` stay with
``torch.linalg`` (cuSOLVER on the card), as the reference left them to XLA.
"""
from __future__ import annotations

from typing import Any, Protocol, Sequence, runtime_checkable

import torch

from repro_torch.core.fusion import cholesky_or_nan
from repro_torch.core.sufficient_stats import SuffStats, zeros_like_stats
from repro_torch.kernels.ops import pow2_bucket
from repro_torch.server.cholesky import chol_update, chol_update_blocked


@runtime_checkable
class LinalgBackend(Protocol):
    """What the engine needs from a linear-algebra backend."""

    name: str
    supports_update: bool

    @property
    def dim(self) -> int: ...

    @property
    def dtype(self) -> Any: ...

    @property
    def count(self) -> torch.Tensor: ...

    @property
    def spectral_ready(self) -> bool: ...

    def fuse(self, delta: SuffStats, sign: float = 1.0) -> None: ...

    def stats(self) -> SuffStats: ...

    def set_stats(self, stats: SuffStats) -> None: ...

    def factor(self, sigma: float) -> Any: ...

    def solve(self, factor: Any, sigma: float) -> torch.Tensor: ...

    def solve_batch(self, sigmas: Sequence[float]
                    ) -> tuple[list[Any] | None, torch.Tensor]: ...

    def update(self, factor: Any, update_vectors: torch.Tensor,
               sign: float) -> Any | None: ...

    def spectral(self, sigmas: Sequence[float]) -> torch.Tensor | None: ...

    def solve_operands(self, factor: Any, sigma: float) -> tuple | None: ...


# -- dense algebra (shared with server.inference's cold reference) ----------

def _cold_factor(G: torch.Tensor, sigma: float) -> torch.Tensor:
    eye = torch.eye(G.shape[0], dtype=G.dtype, device=G.device)
    return cholesky_or_nan(G + sigma * eye)


def _factor_solve(L: torch.Tensor, G: torch.Tensor, h: torch.Tensor,
                  sigma: float) -> torch.Tensor:
    """(G + sigma I)^{-1} h off L, a Cholesky factor of G + sigma I (cold or
    updated).

    A float32 factor is refined once: w0 from L, then w0 plus the L-solve of
    the residual h - (G + sigma I) w0 taken in float64. That takes the error
    from ~kappa 2^-24 to ~(kappa 2^-24)^2 of |w| (kappa 2^-24 < 1), and
    absorbs what factor updates have drifted from G. Float64 solves once.
    """
    w = torch.cholesky_solve(h.unsqueeze(-1), L).squeeze(-1)
    if L.dtype == torch.float64:
        return w
    w64 = w.double()
    r = h.double() - torch.mv(G.double(), w64) - sigma * w64
    return w + torch.cholesky_solve(r.to(L.dtype).unsqueeze(-1), L).squeeze(-1)


def solve_snapshot(L: torch.Tensor, G: torch.Tensor, h: torch.Tensor,
                   sigma: float) -> torch.Tensor:
    """Solve off snapshotted ``(L, G, h, sigma)`` operands — outside any
    tenant lock.

    The same function ``DenseBackend.solve`` runs, so a solve over operands
    snapshotted at some state is bit-identical to the engine's solve at that
    state. The engine never writes a factor or a statistic in place (updates
    return new tensors), so the snapshot is a reference, not a copy.
    """
    return _factor_solve(L, G, h, sigma)


def _multi_sigma_factor_solve(G, h, sigmas: Sequence[float]):
    """Batched Phase 3: one batched Cholesky over the stacked shifted Grams,
    then one Cholesky solve per sigma."""
    eye = torch.eye(G.shape[0], dtype=G.dtype, device=G.device)
    shifts = torch.tensor(list(sigmas), dtype=G.dtype, device=G.device)
    Ls = cholesky_or_nan(G[None] + shifts[:, None, None] * eye[None])
    ws = torch.stack([_factor_solve(L, G, h, s) for L, s in zip(Ls, sigmas)])
    return Ls, ws


def _spectral_solve(lam, Q, h, sigmas):
    """w(sigma) for all sigmas from G's eigendecomposition (Corollary 1):
    G + sigma I shares G's eigenbasis, so each sigma costs O(d^2)."""
    qh = Q.T @ h
    return (qh[None] / (lam[None] + sigmas[:, None])) @ Q.T


class DenseBackend:
    """Single-device dense backend.

    The factor object is the lower-triangular Cholesky factor itself; PSD
    low-rank deltas are absorbed into cached factors by the blocked rank-r
    up/downdate (kernels P and K2 on the card), or the scalar LINPACK
    recurrence below ``blocked_update_min_rank``.
    """

    name = "dense"
    supports_update = True

    #: below this rank the scan-of-rank-1 reference wins (panel-transform
    #: overhead is O(bw^2 r) regardless of how small r is); above it the
    #: blocked path turns the O(r d^2) into trailing GEMMs.
    blocked_update_min_rank = 8

    def __init__(self, dim: int, *, dtype=torch.float32,
                 update_block_size: int = 32, device="cuda"):
        self._stats = zeros_like_stats(dim, dtype, device=device)
        self._eigh: tuple[torch.Tensor, torch.Tensor] | None = None
        self.update_block_size = update_block_size

    @property
    def dim(self) -> int:
        return self._stats.dim

    @property
    def dtype(self) -> torch.dtype:
        return self._stats.gram.dtype

    @property
    def device(self) -> torch.device:
        return self._stats.gram.device

    @property
    def count(self) -> torch.Tensor:
        return self._stats.count

    @property
    def spectral_ready(self) -> bool:
        return self._eigh is not None

    def fuse(self, delta: SuffStats, sign: float = 1.0) -> None:
        self._stats = (self._stats + delta) if sign > 0 else (self._stats - delta)
        self._eigh = None

    def stats(self) -> SuffStats:
        return self._stats

    def set_stats(self, stats: SuffStats) -> None:
        if stats.dim != self.dim:
            raise ValueError(f"stats dim {stats.dim} != backend dim {self.dim}")
        self._stats = stats
        self._eigh = None

    def release(self) -> None:
        """Drop derived caches (the spectral eigh); (G, h) stay intact."""
        self._eigh = None

    def factor(self, sigma: float) -> torch.Tensor:
        return _cold_factor(self._stats.gram, sigma)

    def solve(self, factor: torch.Tensor, sigma: float) -> torch.Tensor:
        return _factor_solve(factor, self._stats.gram, self._stats.moment, sigma)

    def solve_batch(self, sigmas: Sequence[float]
                    ) -> tuple[list[torch.Tensor], torch.Tensor]:
        Ls, ws = _multi_sigma_factor_solve(self._stats.gram, self._stats.moment,
                                           sigmas)
        return list(Ls), ws

    def update(self, factor: torch.Tensor, update_vectors: torch.Tensor,
               sign: float) -> torch.Tensor:
        r = update_vectors.shape[0]
        if r >= self.blocked_update_min_rank:
            # Rank-bucket to the next power of two, as the reference does;
            # zero rows are exact identities in the up/downdate recurrence.
            bucket = pow2_bucket(r)
            if bucket != r:
                update_vectors = torch.nn.functional.pad(
                    update_vectors, (0, 0, 0, bucket - r))
            return chol_update_blocked(
                factor, update_vectors, sign=sign,
                block_size=min(self.update_block_size, self.dim))
        return chol_update(factor, update_vectors, sign=sign)

    def spectral(self, sigmas: Sequence[float]) -> torch.Tensor:
        if self._eigh is None:
            self._eigh = torch.linalg.eigh(self._stats.gram)
        lam, Q = self._eigh
        return _spectral_solve(
            lam, Q, self._stats.moment,
            torch.tensor(list(sigmas), dtype=self.dtype, device=self.device))

    def solve_operands(self, factor: torch.Tensor, sigma: float
                       ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, float]:
        """The (L, G, h, sigma) operands :func:`solve_snapshot` solves."""
        return factor, self._stats.gram, self._stats.moment, sigma

    @property
    def state_bytes(self) -> int:
        """Resident bytes of the fused statistics (plus the spectral cache)."""
        tensors = [self._stats.gram, self._stats.moment]
        if self._eigh is not None:
            tensors += list(self._eigh)
        return sum(t.numel() * t.element_size() for t in tensors)
