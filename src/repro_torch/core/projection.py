"""Random-projection protocol for high-dimensional features (paper §IV-F).

For d > ~1000 the d^2 Gram upload dominates; a shared Gaussian sketch
R in R^{d x m}, R_ij ~ N(0, 1/m), lets each client transmit the m x m
statistics of A_k R instead (Prop 2: JL distance preservation with
m = O(eps^-2 log n); Prop 3: ||w~ - w|| <= O(sqrt(d/m)) ||w||).

The server solves in sketch space, getting v in R^m; predictions use x^T R v,
i.e. the effective weight vector is w~ = R v in the original space — that is
what Prop 3's error bound is measured against.

R is drawn on the host by ``core.threefry`` from the same key as the JAX
package's ``jax.random.normal``, so one seed names one sketch in both.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import threefry
from repro_torch.core.sufficient_stats import SuffStats, compute_stats


def make_projection(key, d: int, m: int, dtype=torch.float32, *,
                    device="cuda") -> torch.Tensor:
    """Shared sketch matrix R (broadcast once; seed sharing costs O(1)).

    ``key`` is a uint32 pair (``threefry.key(seed)``, or a JAX key as
    numpy). R is drawn in float32, as the reference draws it, then cast to
    ``dtype``.
    """
    if not 0 < m <= d:
        raise ValueError(f"need 0 < m <= d, got {m=}, {d=}")
    R = threefry.normal(key, (d, m)) / np.sqrt(np.float32(m))
    return torch.from_numpy(R).to(device=device, dtype=dtype)


def _promoted(X: torch.Tensor, M: torch.Tensor):
    dt = torch.promote_types(X.dtype, M.dtype)
    return X.to(dt), M.to(dt)


def project_data(A: torch.Tensor, R: torch.Tensor) -> torch.Tensor:
    """Client-side feature sketch A~ = A R  (n_k x m)."""
    A, R = _promoted(A, R)
    return A @ R


def projected_stats(A: torch.Tensor, b: torch.Tensor, R: torch.Tensor
                    ) -> SuffStats:
    """Phase 1 in sketch space: G~_k = (A R)^T (A R), h~_k = (A R)^T b."""
    T = project_data(A, R)
    return compute_stats(T, b.to(T.dtype))


def lift(v: torch.Tensor, R: torch.Tensor) -> torch.Tensor:
    """Map the sketch-space solution back: w~ = R v (for x^T R v predictions)."""
    R, v = _promoted(R, v)
    return R @ v


def upload_floats(d: int, m: int | None = None) -> int:
    """Per-client upload size in floats (Thm 4 / Prop 2 accounting).

    Full protocol: d(d+1)/2 (symmetric Gram) + d. Sketched: m(m+1)/2 + m.
    """
    k = d if m is None else m
    return k * (k + 1) // 2 + k


def error_bound(d: int, m: int, w_norm: float, c: float = 1.0) -> float:
    """Prop 3's bound shape: c * sqrt(d/m) * ||w|| (constant not specified by
    the paper; benchmarks fit/validate the sqrt(d/m) *trend*)."""
    return c * (d / m) ** 0.5 * w_norm
