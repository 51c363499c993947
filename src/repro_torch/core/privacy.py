"""Differential privacy for one-shot statistic transmission (Alg 2, Thm 6/7).

The Gaussian mechanism is applied ONCE per client to (G_k, h_k) — there is no
round composition, which is the paper's core privacy claim. Sensitivities
(Definition 3) assume row clipping ||a_i||_2 <= 1 and |b_i| <= 1, under which

    Delta_G = max ||a a^T||_F = 1,    Delta_h = max ||a b||_2 = 1.

Noise scale (Alg 2 line 1):  tau = Delta * sqrt(2 ln(1.25/delta)) / eps.

Keys are raw uint32 pairs (``core.threefry.key(seed)``, or a JAX PRNG key
through ``convert.key_from``). The noise is drawn on the host with
``core.threefry``, scaled and symmetrized in float32 numpy — the bits
``jax.random`` draws for the same key — then moved to the statistics'
device and added there. Float32 statistics only: the reference draws
float64 noise only under 64-bit mode, and ``core.threefry`` has no float64
normal, so float64 statistics raise ``ValueError``.

Also provides the advanced-composition accountant used for the DP-FedAvg
comparison (Thm 7) and a PSD-repair post-processing step (beyond-paper, free
under DP post-processing) that stabilizes the inversion at small eps —
addressing the paper's own Remark 4 weakness.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch.core import threefry
from repro_torch.core.sufficient_stats import SuffStats

_SQRT2 = np.float32(math.sqrt(2.0))


def gaussian_tau(eps: float, delta: float, sensitivity: float = 1.0) -> float:
    """Gaussian-mechanism noise std for (eps, delta)-DP (Alg 2 line 1)."""
    if eps <= 0 or not (0 < delta < 1):
        raise ValueError(f"need eps>0, 0<delta<1; got {eps=}, {delta=}")
    return sensitivity * math.sqrt(2.0 * math.log(1.25 / delta)) / eps


def clip_rows(A: torch.Tensor, b: torch.Tensor, *, clip_a: float = 1.0,
              clip_b: float = 1.0) -> tuple[torch.Tensor, torch.Tensor]:
    """Enforce Definition 3's sensitivity preconditions by clipping.

    The paper's Def 3 takes clip_a = clip_b = 1 (pre-normalized data). For
    unnormalized features (row norm ~ sqrt(d)) callers pass public clip
    constants; the sensitivities become Delta_G = clip_a^2 and
    Delta_h = clip_a * clip_b (see ``sensitivities``).
    """
    norms = torch.linalg.vector_norm(A, dim=1, keepdim=True)
    A = A / torch.clamp_min(norms / clip_a, 1.0)
    b = torch.clamp(b, -clip_b, clip_b)
    return A, b


def sensitivities(clip_a: float = 1.0, clip_b: float = 1.0) -> tuple[float, float]:
    """(Delta_G, Delta_h) under row clipping — Def 3 generalized.

    Delta_G = max ||a a^T||_F = clip_a^2; Delta_h = max ||a b|| = clip_a clip_b.
    """
    return clip_a ** 2, clip_a * clip_b


def _check_float32(G: torch.Tensor, h: torch.Tensor) -> None:
    if G.dtype != torch.float32 or h.dtype != torch.float32:
        raise ValueError(
            f"DP noise needs float32 statistics, got {G.dtype} / {h.dtype}: "
            f"the port draws jax.random's float32 normals only (the reference "
            f"draws float64 noise only under jax_enable_x64)")


def _gaussian(kg, kh, d_g: tuple[int, ...], d_h: tuple[int, ...],
              tau_g: float, tau_h: float) -> tuple[np.ndarray, np.ndarray]:
    """Alg 2's noise on the host: symmetrized E for G, e for h (float32)."""
    E = threefry.normal(kg, d_g) * np.float32(tau_g)
    E = (E + E.T) / _SQRT2     # symmetrize, preserving entrywise variance
    e = threefry.normal(kh, d_h) * np.float32(tau_h)
    return E, e


def _add_noise(G: torch.Tensor, h: torch.Tensor, E: np.ndarray, e: np.ndarray
               ) -> tuple[torch.Tensor, torch.Tensor]:
    return (G + torch.from_numpy(E).to(G.device),
            h + torch.from_numpy(e).to(h.device))


def privatize_stats(
    key,
    stats: SuffStats,
    eps: float,
    delta: float,
    *,
    sensitivity_g: float = 1.0,
    sensitivity_h: float = 1.0,
) -> SuffStats:
    """Algorithm 2 lines 4-6: symmetrized Gaussian on G, Gaussian on h.

    The Gram perturbation E_k is symmetrized so G~ stays symmetric (the solve
    relies on it); symmetrization keeps the mechanism's DP level because it is
    post-processing of a Gaussian-perturbed release.
    """
    _check_float32(stats.gram, stats.moment)
    kg, kh = threefry.split(key)
    d = stats.dim
    E, e = _gaussian(kg, kh, (d, d), (d,),
                     gaussian_tau(eps, delta, sensitivity_g),
                     gaussian_tau(eps, delta, sensitivity_h))
    G, h = _add_noise(stats.gram, stats.moment, E, e)
    # yty is deliberately dropped (None): an un-noised sum of y^2 riding next
    # to privatized (G, h) would leak; inference degrades on DP tenants.
    return SuffStats(G, h, stats.count)


def make_dp_noise_fn(key, eps: float, delta: float, d: int):
    """Per-client noise hook ``noise_fn(client_idx, G, h) -> (G~, h~)``.

    Each client derives an independent key by folding in its flat client
    index, matching Alg 2's "for each client in parallel". ``d`` is kept
    for the reference's signature; the shapes come from ``G`` and ``h``.
    """
    del d
    tau = gaussian_tau(eps, delta)

    def noise_fn(client_idx, G: torch.Tensor, h: torch.Tensor):
        _check_float32(G, h)
        kg, kh = threefry.split(threefry.fold_in(key, int(client_idx)))
        E, e = _gaussian(kg, kh, tuple(G.shape), tuple(h.shape), tau, tau)
        return _add_noise(G, h, E, e)

    return noise_fn


def central_dp_stats(key, fused: SuffStats, eps: float, delta: float,
                     n_clients: int, *, sensitivity_g: float = 1.0,
                     sensitivity_h: float = 1.0) -> SuffStats:
    """Simulated secure aggregation (paper §VI-D.1): noise added once to the
    aggregated sum instead of per client, reducing total noise std by sqrt(K).

    The cryptographic secure-sum itself is out of scope; this models its
    privacy/utility effect under an honest-but-curious server.
    """
    del n_clients  # sensitivity of the sum to one row is unchanged
    return privatize_stats(key, fused, eps, delta,
                           sensitivity_g=sensitivity_g,
                           sensitivity_h=sensitivity_h)


def psd_repair(stats: SuffStats, floor: float = 0.0) -> SuffStats:
    """Beyond-paper: project the noisy Gram back to the PSD cone.

    Eigenvalue clipping is DP post-processing (free), and directly attacks the
    Remark-4 failure mode where noise makes (G~ + sigma I) near-singular or
    indefinite. ``torch.linalg.eigh`` runs on the Gram's device (cuSOLVER on
    the card).
    """
    evals, evecs = torch.linalg.eigh(stats.gram)
    evals = torch.clamp_min(evals, floor)
    G = (evecs * evals) @ evecs.T
    return SuffStats(G, stats.moment, stats.count, yty=stats.yty)


# ---------------------------------------------------------------------------
# Accounting for the iterative comparison (Theorem 7).
# ---------------------------------------------------------------------------

def advanced_composition(eps0: float, delta0: float, rounds: int) -> float:
    """Theorem 7: total eps of R rounds of (eps0, delta0)-DP under advanced
    composition:  eps_total = sqrt(2 R ln(1/delta0)) eps0 + R eps0 (e^eps0 - 1).
    """
    return math.sqrt(2.0 * rounds * math.log(1.0 / delta0)) * eps0 + \
        rounds * eps0 * (math.expm1(eps0))


def per_round_budget(eps_total: float, rounds: int) -> float:
    """The paper's Experiment-5 convention: eps0 = eps_total / sqrt(R)."""
    return eps_total / math.sqrt(rounds)
