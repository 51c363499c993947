"""Federated inference from one-shot second moments.

The sufficient statistics (G = AᵀA, h = Aᵀb, n) extend with one scalar —
yty = Σ bᵢ² — to a complete statistic for classical ridge inference:

    RSS = ||b - A w||² = yty - 2 hᵀw + wᵀ G w,
    dof = tr(G M) = d - σ tr(M),  M = (G + σI)⁻¹,
    σ̂² = RSS / (n - dof),  Cov(ŵ) = σ̂² · M G M.

Everything is computed off the engine's CACHED Cholesky factor L of
(G + σI): M = L⁻ᵀL⁻¹ from one triangular solve against the identity, no new
factorization. ``reference_inference`` factors cold and solves through the
SAME functions the dense backend runs (``backends._cold_factor`` /
``backends._factor_solve``) and then this module's functions, so
engine-served intervals are bit-identical to the cold closed form on the
same fused statistics.

Statistics without a second moment (``yty=None``) serve point weights only:
the inference fields are None.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.sufficient_stats import SuffStats


def _inference_kernel(L, G, h, w, yty, n, sigma):
    """All inference scalars/arrays off the cached factor."""
    d = G.shape[0]
    eye = torch.eye(d, dtype=G.dtype, device=G.device)
    Linv = torch.linalg.solve_triangular(L, eye, upper=False)
    M = Linv.T @ Linv
    dof = d - sigma * torch.trace(M)
    rss = yty - 2.0 * (h @ w) + w @ (G @ w)
    denom = n - dof
    sigma2 = rss / denom
    cov = sigma2 * (M @ (G @ M))
    stderr = torch.sqrt(torch.clamp(torch.diagonal(cov), min=0.0))
    return rss, dof, denom, sigma2, cov, stderr


def _pi_kernel(X, w, cov, sigma2):
    """Prediction mean and std at query rows X: Var = σ̂² + xᵀ Cov(ŵ) x."""
    mean = X @ w
    var = sigma2 + torch.einsum("ni,ni->n", X @ cov, X)
    return mean, torch.sqrt(torch.clamp(var, min=0.0))


def z_value(level: float) -> float:
    """Two-sided normal critical value for a ``level`` interval.

    Evaluated in float32, the precision the reference computes it in.
    """
    if not 0.0 < level < 1.0:
        raise ValueError(f"level must be in (0, 1), got {level}")
    p = torch.tensor((1.0 + level) / 2.0, dtype=torch.float32)
    return float(torch.special.ndtri(p))


def _numpy(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def inference_report(L: torch.Tensor, stats: SuffStats, w: torch.Tensor,
                     sigma: float, *, level: float = 0.95,
                     queries: torch.Tensor | None = None) -> dict | None:
    """Standard errors and intervals for ŵ, off an existing factor.

    Args:
      L: lower Cholesky factor of (G + sigma I); never refactorized here.
      stats: the fused statistics; ``yty=None`` returns None.
      w: the served solution M h.
      sigma: the ridge shift L was factored at.
      level: two-sided coverage of the confidence/prediction intervals.
      queries: optional (q, d) rows in solve-space coordinates.

    Returns None when inference is undefined: missing moments, or
    non-positive residual degrees of freedom n - dof.
    """
    if stats.yty is None:
        return None
    z = z_value(level)
    G = stats.gram
    n = stats.count.to(G.dtype)
    rss, dof, denom, sigma2, cov, stderr = _inference_kernel(
        L, G, stats.moment, w, stats.yty.to(G.dtype), n,
        torch.tensor(sigma, dtype=G.dtype, device=G.device))
    if not float(denom) > 0.0:
        return None
    ci = torch.stack([w - z * stderr, w + z * stderr], dim=1)
    report = {
        "level": float(level),
        "n": int(stats.count),
        "dof": float(dof),
        "rss": float(rss),
        "sigma2": float(sigma2),
        "stderr": _numpy(stderr),
        "ci": _numpy(ci),
        "pi": None,
    }
    if queries is not None:
        X = torch.atleast_2d(torch.as_tensor(queries, dtype=G.dtype,
                                             device=G.device))
        if X.shape[-1] != G.shape[0]:
            raise ValueError(f"queries have {X.shape[-1]} features, "
                             f"solve space is {G.shape[0]}-dimensional")
        mean, std = _pi_kernel(X, w, cov, sigma2)
        report["pi"] = _numpy(torch.stack([mean - z * std, mean + z * std],
                                          dim=1))
        report["pi_mean"] = _numpy(mean)
    return report


def reference_inference(stats: SuffStats, sigma: float, *,
                        level: float = 0.95,
                        queries: torch.Tensor | None = None
                        ) -> tuple[torch.Tensor, dict | None]:
    """Cold centralized closed-form reference: (ŵ, report).

    Factors from scratch and solves through the same functions the dense
    engine path runs, then the same inference functions — so an engine that
    fused the same statistics serves bit-identical weights, standard errors
    and intervals.
    """
    from repro_torch.server import backends

    L = backends._cold_factor(stats.gram, sigma)
    w = backends._factor_solve(L, stats.gram, stats.moment, float(sigma))
    return w, inference_report(L, stats, w, sigma, level=level,
                               queries=queries)
