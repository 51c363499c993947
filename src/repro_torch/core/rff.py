"""Random Fourier features — the paper's §IV-F kernel-extension path [10].

phi(x) = sqrt(2/D) cos(W x + c),  W_ij ~ N(0, 1/ell^2), c ~ U[0, 2pi)
approximates the RBF kernel k(x,y) = exp(-||x-y||^2 / (2 ell^2)). One-shot
fusion then runs verbatim on phi(A): communication O(D^2) where D is the
feature count — nonlinear decision functions from pure linear algebra.
This is the random-feature sibling of ``projection.py``'s Gaussian sketch:
both instantiate §IV-F's m << d upload reduction, and the Prop-2/Prop-3
accounting there (``upload_floats``, ``error_bound``) prices this path's
D(D+1)/2 + D wire cost identically with m = D.

(W, c) are drawn on the host by ``core.threefry`` from the same key as the
JAX package's ``jax.random`` draws, bitwise.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from repro_torch.core import threefry
from repro_torch.core.sufficient_stats import SuffStats, compute_stats


@dataclasses.dataclass(frozen=True)
class RFFMap:
    """A shared random-feature map (broadcast by seed, like the JL sketch)."""

    W: torch.Tensor      # (d, D)
    c: torch.Tensor      # (D,)

    @property
    def num_features(self) -> int:
        return self.W.shape[1]

    def __call__(self, X: torch.Tensor) -> torch.Tensor:
        dt = torch.promote_types(X.dtype, self.W.dtype)
        Z = X.to(dt) @ self.W.to(dt) + self.c.to(dt)
        return math.sqrt(2.0 / self.num_features) * torch.cos(Z)


def make_rff(key, d: int, num_features: int, lengthscale: float = 1.0,
             dtype=torch.float32, *, device="cuda") -> RFFMap:
    """Draw (W, c) from ``key`` (a uint32 pair) as the reference does.

    Drawn in float32, then cast to ``dtype``.
    """
    kw, kc = threefry.split(key)
    W = threefry.normal(kw, (d, num_features)) / np.float32(lengthscale)
    c = threefry.uniform(kc, (num_features,), 0.0, 2.0 * math.pi)
    return RFFMap(W=torch.from_numpy(W).to(device=device, dtype=dtype),
                  c=torch.from_numpy(c).to(device=device, dtype=dtype))


def rff_stats(A: torch.Tensor, b: torch.Tensor, feat: RFFMap) -> SuffStats:
    """Client Phase 1 on random features: G_k = phi(A_k)^T phi(A_k), etc."""
    T = feat(A)
    return compute_stats(T, b.to(T.dtype))


def kernel_gram_exact(X: torch.Tensor, Y: torch.Tensor,
                      lengthscale: float = 1.0) -> torch.Tensor:
    """Exact RBF kernel matrix (test oracle for the RFF approximation)."""
    sq = ((X ** 2).sum(1)[:, None] + (Y ** 2).sum(1)[None, :]
          - 2.0 * X @ Y.T)
    return torch.exp(-sq / (2.0 * lengthscale ** 2))
