"""Unified §IV-F feature-map identity — the sketch / RFF tenant contract.

The paper's kernel-extension claim (§IV-F, Props 2–3) covers two feature
maps that both reduce per-client upload from O(d²) to O(m²): the Gaussian
sketch x -> R^T x (projection.py) and random Fourier features
x -> sqrt(2/D) cos(W^T x + c) (rff.py). Serving either requires every
participant to hold the SAME map, so the map needs an *identity*:
(kind, seed, m, d_orig, lengthscale) regenerates the arrays
deterministically, and :func:`feature_hash` fingerprints the actual bytes.

The arrays are drawn on the host by ``core.threefry``, which reproduces the
JAX package's ``jax.random`` draws bitwise, so a map's fingerprint equals
the reference's for the same identity, and a PROJ or RFF frame from either
package admits into the other's tenant. ``convert.feature_map_from`` can
still pin a map to given arrays (``seed_arrays``).

``FeatureMap`` is hashable/frozen. Its arrays are cached per (map, device):
drawn once on the host and moved once.
"""
from __future__ import annotations

import dataclasses
import functools
import math
import zlib

import numpy as np
import torch

from repro_torch.core import projection, rff, threefry
from repro_torch.core.sufficient_stats import SuffStats, _count
from repro_torch.kernels import ops as kernel_ops
from repro_torch.kernels.ref import accumulation_dtype

KINDS = ("sketch", "rff")


def feature_hash(*arrays) -> int:
    """CRC32 chained over each array's canonical little-endian f32 bytes."""
    h = 0
    for a in arrays:
        if isinstance(a, torch.Tensor):
            a = a.detach().cpu().numpy()
        arr = np.ascontiguousarray(np.asarray(a), dtype="<f4")
        h = zlib.crc32(arr.tobytes(), h)
    return h & 0xFFFFFFFF


@dataclasses.dataclass(frozen=True)
class FeatureMap:
    """Identity of a shared §IV-F feature map.

    kind: "sketch" (Gaussian JL projection, Props 2–3) or "rff" (random
    Fourier features approximating the RBF kernel at ``lengthscale``).
    m is the feature count — the solve-space dimension (sketch m <= d_orig;
    RFF D may exceed d_orig). seed regenerates the arrays; sharing it costs
    O(1) on the wire versus O(dm) for shipping the map itself.
    """

    kind: str
    seed: int
    d_orig: int
    m: int
    lengthscale: float = 1.0

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"kind must be one of {KINDS}, got {self.kind!r}")
        if self.kind == "sketch":
            if not 0 < self.m <= self.d_orig:
                raise ValueError(f"sketch needs 0 < m <= d_orig, got "
                                 f"m={self.m}, d_orig={self.d_orig}")
        else:
            if self.m <= 0 or self.d_orig <= 0:
                raise ValueError(f"rff needs m, d_orig > 0, got m={self.m}, "
                                 f"d_orig={self.d_orig}")
        if not (math.isfinite(self.lengthscale) and self.lengthscale > 0):
            raise ValueError(f"lengthscale must be finite and > 0, "
                             f"got {self.lengthscale}")

    # -- materialization -----------------------------------------------------

    def materialize(self, device="cuda") -> tuple[torch.Tensor, ...]:
        """The map's float32 arrays on ``device``: (R,) for sketch, (W, c)
        for rff. Cached per (map, device); the RNG runs once per map."""
        return _on_device(self, str(torch.device(device)))

    @property
    def fhash(self) -> int:
        """Fingerprint of the materialized bytes (cached with them)."""
        return _fhash(self)

    # -- the map itself ------------------------------------------------------

    def __call__(self, X: torch.Tensor) -> torch.Tensor:
        """Featurize rows: X (n, d_orig) -> (n, m)."""
        if self.kind == "sketch":
            (R,) = self.materialize(X.device)
            return projection.project_data(X, R)
        W, c = self.materialize(X.device)
        return rff.RFFMap(W=W, c=c)(X)

    def stats(self, A: torch.Tensor, b: torch.Tensor) -> SuffStats:
        """Client Phase 1 in feature space: G = T^T T, h = T^T b, T = phi(A).

        ``kernels.ops`` dispatches by device: on CUDA the featurize->Gram
        kernel runs (K3 for a sketch, which holds one 4096-row chunk of T in
        device memory at a time; K4 for RFF, whose T never reaches device
        memory); on the CPU its plain version. ``yty = sum b^2`` is
        featurization-invariant (targets are not featurized).
        """
        if A.ndim != 2 or A.shape[1] != self.d_orig:
            raise ValueError(f"A must be (n, {self.d_orig}), got {tuple(A.shape)}")
        if tuple(b.shape) != (A.shape[0],):
            raise ValueError(f"b must be ({A.shape[0]},), got {tuple(b.shape)}")
        acc = accumulation_dtype(A.dtype)
        bb = b.to(acc)
        yty = torch.dot(bb, bb)
        # the map is float32; float64 input widens it (exactly)
        arrays = [a.to(acc) if acc == torch.float64 else a
                  for a in self.materialize(A.device)]
        if self.kind == "sketch":
            G, h = kernel_ops.sketch_gram(A, b, arrays[0])
        else:
            G, h = kernel_ops.rff_gram(A, b, arrays[0], arrays[1])
        return SuffStats(gram=G, moment=h, count=_count(A.shape[0], A.device),
                         yty=yty.to(G.dtype))

    # -- serving -------------------------------------------------------------

    def lift(self, v: torch.Tensor) -> torch.Tensor:
        """Solve-space solution -> served weights.

        Sketch: w~ = R v in the original d_orig space (predictions are
        x^T R v, Prop 3 measures against this). RFF: identity — weights
        live in feature space and predictions featurize first.
        """
        if self.kind == "sketch":
            (R,) = self.materialize(v.device)
            return projection.lift(v, R)
        return v

    def predict(self, X: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        """Predictions from *served* (lifted) weights on raw rows X."""
        if self.kind == "sketch":
            return X @ w
        return self(X) @ w

    def error_bound(self, w_norm: float, c: float = 1.0) -> float | None:
        """Prop 3's c·sqrt(d/m)·||w|| shape for the sketch; None for RFF
        (its approximation error is O(1/sqrt(D)) in the *kernel*, not a
        weight-space bound of this form)."""
        if self.kind == "sketch":
            return projection.error_bound(self.d_orig, self.m, w_norm, c)
        return None

    def upload_floats(self) -> int:
        """Per-client upload in floats: m(m+1)/2 + m (§IV-F accounting)."""
        return projection.upload_floats(self.d_orig, self.m)


# Host arrays installed by ``seed_arrays`` (e.g. the reference's own bytes,
# through ``convert.feature_map_from``); they take precedence over a draw.
_SEEDED: dict[FeatureMap, tuple[torch.Tensor, ...]] = {}


@functools.lru_cache(maxsize=64)
def _drawn(fm: FeatureMap) -> tuple[torch.Tensor, ...]:
    key = threefry.key(fm.seed)
    if fm.kind == "sketch":
        return (projection.make_projection(key, fm.d_orig, fm.m, device="cpu"),)
    feat = rff.make_rff(key, fm.d_orig, fm.m, lengthscale=fm.lengthscale,
                        device="cpu")
    return (feat.W, feat.c)


def _host(fm: FeatureMap) -> tuple[torch.Tensor, ...]:
    seeded = _SEEDED.get(fm)
    return seeded if seeded is not None else _drawn(fm)


@functools.lru_cache(maxsize=64)
def _on_device(fm: FeatureMap, device: str) -> tuple[torch.Tensor, ...]:
    return tuple(a.to(device) for a in _host(fm))


@functools.lru_cache(maxsize=64)
def _fhash(fm: FeatureMap) -> int:
    return feature_hash(*_host(fm))


def seed_arrays(fm: FeatureMap, arrays) -> None:
    """Make ``fm`` materialize exactly ``arrays`` ((R,) or (W, c), float32).

    Shapes are checked against the map; cached device copies and the
    fingerprint are dropped so every later use sees these bytes.
    """
    want = ([(fm.d_orig, fm.m)] if fm.kind == "sketch"
            else [(fm.d_orig, fm.m), (fm.m,)])
    host = tuple(torch.tensor(np.asarray(a, dtype=np.float32)) for a in arrays)
    if [tuple(a.shape) for a in host] != want:
        raise ValueError(f"{fm.kind} map needs arrays of shapes {want}, got "
                         f"{[tuple(a.shape) for a in host]}")
    _SEEDED[fm] = host
    _on_device.cache_clear()
    _fhash.cache_clear()
