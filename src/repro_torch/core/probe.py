"""One-shot federated linear probing of backbone features.

This is where the paper's technique meets the model zoo: the nonlinear
backbone f_theta is frozen; the readout head IS a ridge regression on
features Phi = f_theta(x) in R^{d_feat}, so Theorems 1/2/5/8 apply verbatim
to the head. One aggregation of (d_feat^2 + d_feat) floats replaces
iterative head training. Multi-target heads (e.g. num_classes regression
targets) are supported by stacking moment vectors.

This is the single-device half of the reference's module: the Gram of the
features is a float32 ``torch.matmul`` (TF32 off, ``repro_torch``'s
default), as the reference's einsum is, and the head is solved by Cholesky.
The mesh half (``mesh=``) waits for ROADMAP queue 1, item 15.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from repro_torch.core.fusion import cholesky_or_nan
from repro_torch.core.sufficient_stats import SuffStats

_MESH = ("is not ported yet: the mesh half of the probe waits for ROADMAP "
         "queue 1, item 15")


@dataclasses.dataclass(frozen=True)
class ProbeResult:
    weights: torch.Tensor       # (d_feat,) or (d_feat, n_targets)
    stats: SuffStats            # fused feature statistics (reusable for LOCO-CV)
    sigma: float


def _feature_stats(feats: torch.Tensor, targets: torch.Tensor) -> SuffStats:
    """Stats on features; targets may be (n,) or (n, t) (stacked moments).

    Products accumulate in float32: the features are widened first (a
    product of two bf16 values is exact in float32).
    """
    F = feats.to(torch.float32)
    gram = F.T @ F
    moment = F.T @ targets.to(torch.float32)
    return SuffStats(gram, moment,
                     torch.tensor(feats.shape[0], dtype=torch.int32,
                                  device=feats.device))


def solve_head(stats: SuffStats, sigma: float) -> torch.Tensor:
    """(G + sigma I)^{-1} H for single- or multi-target moments."""
    G, H = stats.gram, stats.moment
    reg = G + sigma * torch.eye(G.shape[0], dtype=G.dtype, device=G.device)
    L = cholesky_or_nan(reg)
    w = torch.cholesky_solve(H[:, None] if H.ndim == 1 else H, L)
    return w[:, 0] if H.ndim == 1 else w


def one_shot_probe(
    feature_fn: Callable[[torch.Tensor], torch.Tensor],
    inputs: torch.Tensor,
    targets: torch.Tensor,
    *,
    sigma: float = 1e-2,
    mesh=None,
    client_axes: tuple[str, ...] = ("data",),
) -> ProbeResult:
    """Fit a ridge readout head on frozen backbone features, one-shot.

    Args:
      feature_fn: frozen backbone, maps (n, ...) inputs -> (n, d_feat)
        features.
      inputs / targets: everything runs on one device (K=1 degenerate case —
        still the exact centralized solution, by Thm 2).
      mesh, client_axes: the reference's on-mesh fusion; ``mesh`` raises
        ``NotImplementedError`` until item 15.
    """
    del client_axes
    if mesh is not None:
        raise NotImplementedError(f"one_shot_probe(mesh=...) {_MESH}")
    stats = _feature_stats(feature_fn(inputs), targets)
    return ProbeResult(solve_head(stats, sigma), stats, sigma)


def probe_mse(feature_fn, inputs, targets, result: ProbeResult) -> torch.Tensor:
    pred = feature_fn(inputs).to(result.weights.dtype) @ result.weights
    return torch.mean((pred - targets) ** 2)


def head_as_params(result: ProbeResult) -> dict:
    """Package the fused head so checkpointing/serving treats it as a layer."""
    w = result.weights
    return {"kernel": w if w.ndim == 2 else w[:, None],
            "bias": torch.zeros((w.shape[1] if w.ndim == 2 else 1,),
                                dtype=w.dtype, device=w.device)}
