"""One-Shot sigma-Fusion: server-side solve and its satellite guarantees.

Paper Algorithm 1 Phase 3 plus:
  * Theorem 3 / Corollary 1 — SPD solve via Cholesky, condition-number util
  * Theorem 8 — dropout fusion (exact solution on the participating subset)
  * Proposition 5 — federated leave-one-client-out cross-validation for sigma

These are the pure-function REFERENCE implementations: every call factors
from scratch and LOCO is the paper's sequential K * |Sigma| recipe. The
production path (cached / incrementally updated factors, batched sweeps,
one-pass LOCO) is ``repro_torch.server.FusionEngine``.
"""
from __future__ import annotations

from typing import Sequence

import torch

from repro_torch.core.sufficient_stats import SuffStats, fuse_stats


def cholesky_or_nan(M: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky factor of M (batched too), all NaN where M is not
    positive definite.

    The reference's Cholesky returns NaNs for such a matrix instead of
    raising, so its solves return NaN weights: that is how Remark 4's
    failure mode (DP noise making G~ + sigma I indefinite) shows there, and
    here. A positive definite M keeps ``torch.linalg.cholesky``'s bits.
    """
    L, info = torch.linalg.cholesky_ex(M)
    return L.masked_fill_((info != 0)[..., None, None], float("nan"))


def solve_ridge(stats: SuffStats, sigma) -> torch.Tensor:
    """Phase 3: w = (G + sigma I)^{-1} h via Cholesky (Thm 3: SPD for sigma>0)."""
    G = stats.gram
    reg = G + sigma * torch.eye(stats.dim, dtype=G.dtype, device=G.device)
    L = cholesky_or_nan(reg)
    return torch.cholesky_solve(stats.moment.unsqueeze(-1), L).squeeze(-1)


def one_shot_fusion(client_stats: Sequence[SuffStats], sigma) -> torch.Tensor:
    """Algorithm 1 end-to-end given already-received client statistics."""
    return solve_ridge(fuse_stats(client_stats), sigma)


def dropout_fusion(client_stats: Sequence[SuffStats],
                   participating: Sequence[bool], sigma) -> torch.Tensor:
    """Theorem 8: fuse only participating clients (exact on their union)."""
    kept = [s for s, p in zip(client_stats, participating, strict=True) if p]
    if not kept:
        raise ValueError("no participating clients")
    return one_shot_fusion(kept, sigma)


def condition_number(stats: SuffStats, sigma) -> torch.Tensor:
    """Corollary 1: kappa(G + sigma I) = (lmax + sigma) / (lmin + sigma)."""
    evals = torch.linalg.eigvalsh(stats.gram)
    return (evals[-1] + sigma) / (evals[0] + sigma)


def coverage(stats: SuffStats) -> torch.Tensor:
    """Definition 2: alpha-coverage level = lambda_min(G)."""
    return torch.linalg.eigvalsh(stats.gram)[0]


def loco_cv(client_stats: Sequence[SuffStats],
            client_data: Sequence[tuple[torch.Tensor, torch.Tensor]],
            sigmas: Sequence[float]):
    """Proposition 5: federated leave-one-client-out CV for sigma.

    Returns ``(best_sigma, losses)`` with losses of shape (|Sigma|,), the sum
    over clients of each held-out client's validation MSE.
    """
    total = fuse_stats(client_stats)
    losses = []
    for sigma in sigmas:
        loss_sum = 0.0
        for k, s_k in enumerate(client_stats):
            minus_k = SuffStats(total.gram - s_k.gram,
                                total.moment - s_k.moment,
                                total.count - s_k.count)
            w = solve_ridge(minus_k, sigma)
            A_k, b_k = client_data[k]
            loss_sum = loss_sum + torch.mean((A_k @ w - b_k) ** 2)
        losses.append(loss_sum)
    losses = torch.stack(losses)
    best = int(torch.argmin(losses))
    return sigmas[best], losses


def mse(A: torch.Tensor, b: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return torch.mean((A @ w - b) ** 2)
