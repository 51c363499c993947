"""Distributed sigma-equilibrium view of ridge regression (paper §III, §I-A.1).

The paper formulates federated ridge as a *distributed equilibrium problem*:
w* is the unique point where the aggregated stationarity residual vanishes,

    r_sigma(w) = (G + sigma I) w - h = sum_k [ G_k w - h_k ] + sigma w = 0.

This module makes that formulation operational:

  * ``equilibrium_residual``   — the certificate. ||r|| == 0 identifies the
                                 equilibrium; tests use it to verify Thm 2
                                 without comparing against a second solver.
  * ``residual_bound``         — converts a residual norm into a solution-error
                                 bound via ||w - w*|| <= ||r|| / (lmin(G)+sigma)
                                 (spectral lower bounds on the aggregated Gram).
  * ``solve_cg``               — matrix-free conjugate-gradient solve of the
                                 equilibrium (paper §VI-A: O(d^2) per iteration
                                 alternative to the O(d^3) Cholesky for large d).

Everything runs on the statistics' device. ``solve_cg`` keeps the
reference's loop and stop rule; its loop condition is read on the host once
per iteration.
"""
from __future__ import annotations

import torch

from repro_torch.core.sufficient_stats import SuffStats


def equilibrium_residual(stats: SuffStats, sigma, w: torch.Tensor) -> torch.Tensor:
    """r_sigma(w) = (G + sigma I) w - h; zero iff w is the global optimum."""
    return stats.gram @ w + sigma * w - stats.moment


def residual_bound(stats: SuffStats, sigma, w: torch.Tensor) -> torch.Tensor:
    """Non-asymptotic error bound ||w - w*||_2 <= ||r(w)|| / (lmin(G)+sigma).

    Follows from (G+sigma I)(w - w*) = r(w) and lmin(G+sigma I) >= sigma > 0;
    under alpha-coverage (Def 2) the denominator improves to alpha + sigma.
    """
    lmin = torch.linalg.eigvalsh(stats.gram)[0]
    return torch.linalg.vector_norm(equilibrium_residual(stats, sigma, w)) \
        / (lmin + sigma)


def solve_cg(stats: SuffStats, sigma, *, iters: int = 100,
             tol: float = 1e-10) -> torch.Tensor:
    """Conjugate gradients on (G + sigma I) w = h (SPD by Thm 3).

    Runs while ``it < iters and rs > tol**2``, with ``rs`` the squared
    residual norm and ``tol**2`` in the statistics' dtype, from G-vector
    products only.
    """
    G, h = stats.gram, stats.moment
    tol2 = torch.tensor(tol ** 2, dtype=h.dtype, device=h.device)

    def matvec(v):
        return G @ v + sigma * v

    w = torch.zeros_like(h)
    r = h - matvec(w)
    p = r
    rs = torch.dot(r, r)
    it = 0
    while it < iters and bool(rs > tol2):
        Ap = matvec(p)
        alpha = rs / torch.dot(p, Ap)
        w = w + alpha * p
        r = r - alpha * Ap
        rs_new = torch.dot(r, r)
        p = r + (rs_new / rs) * p
        rs = rs_new
        it += 1
    return w
