"""Iterative baselines: FedAvg and FedProx on the ridge objective (paper §V-A1).

The paper compares against FedAvg (eta=0.01, E=5 local epochs, full
participation) and FedProx (same + proximal mu=0.01). Locally each client runs
E full-batch gradient steps on its per-sample-normalized ridge loss

    L_k(w) = (1/n_k) ||A_k w - b_k||^2 + (sigma/n) ||w||^2
    [FedProx adds  (mu/2) ||w - w_global||^2]

whose client-average matches the centralized objective (1/n)(||Aw-b||^2 +
sigma ||w||^2) when n_k are equal — so any gap to the oracle is genuine
optimization error (client drift / finite rounds), which is exactly the
phenomenon the paper's Tables II/III measure.

DP-FedAvg (Experiment 5) clips each round's client update and adds Gaussian
noise calibrated to a per-round budget eps0 = eps_total / sqrt(R) — the
paper's fair-comparison convention under advanced composition.

The clients live in one stacked (K, n_k, d) tensor on their device, and
every local epoch is two batched matrix-vector products over all K clients;
rounds and epochs are Python loops. The random schedule is the reference's
bit for bit (``core.threefry``): ``split(key(seed), R)`` round keys, each
split into ``(k_sample, k_noise)``; the client-sampling masks come from
``permutation(k_sample, K)`` and the DP noise from ``normal(k_noise, (K, d))``,
all drawn on the host before the first round and moved to the device once.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from repro_torch.core import privacy, threefry
from repro_torch.data.synthetic import FederatedDataset
from repro_torch.fed import comm
from repro_torch.fed.protocol import RunResult
from repro_torch.kernels import ops as kernel_ops


@dataclasses.dataclass(frozen=True)
class IterativeConfig:
    rounds: int = 200
    lr: float = 0.01
    local_epochs: int = 5
    sigma: float = 0.01
    prox_mu: float = 0.0          # 0 -> FedAvg; >0 -> FedProx
    sample_fraction: float = 1.0  # client sampling per round (Experiment 6)
    dp_eps: float | None = None   # total budget; per-round = eps/sqrt(R)
    dp_delta: float = 1e-5
    dp_clip: float = 1.0          # L2 clip on client model-updates
    seed: int = 0


def _stack_clients(ds: FederatedDataset) -> tuple[torch.Tensor, torch.Tensor]:
    """(K, n_k, d) and (K, n_k) stacked client data (equal n_k per §V-A)."""
    A = torch.stack([a for a, _ in ds.clients])
    b = torch.stack([b for _, b in ds.clients])
    return A, b


def _schedule(cfg: IterativeConfig, K: int, d: int, noise_tau: float
              ) -> tuple[np.ndarray, int, np.ndarray | None]:
    """Per-round sampling masks (R, K), the sampled count m, and DP noise
    (R, K, d) or None: what the reference's rounds draw from their keys."""
    keys = threefry.split(threefry.key(cfg.seed), cfg.rounds)
    masks = np.ones((cfg.rounds, K), np.float32)
    m = K
    noise = (np.empty((cfg.rounds, K, d), np.float32)
             if cfg.dp_eps is not None else None)
    for r, round_key in enumerate(keys):
        k_sample, k_noise = threefry.split(round_key)
        if cfg.sample_fraction < 1.0:
            m = max(1, int(cfg.sample_fraction * K))
            masks[r] = 0.0
            masks[r, threefry.permutation(k_sample, K)[:m]] = 1.0
        if noise is not None:
            noise[r] = threefry.normal(k_noise, (K, d)) * np.float32(noise_tau)
    return masks, m, noise


def run_iterative(ds: FederatedDataset, cfg: IterativeConfig,
                  *, track_history: bool = False) -> RunResult:
    """Run FedAvg/FedProx (optionally DP) for cfg.rounds; returns final w.

    When ``track_history`` the per-round global iterates are returned in
    extras["history"] (used by the convergence figure, paper Fig. 3).
    """
    A, b = _stack_clients(ds)                      # (K, n_k, d), (K, n_k)
    K, n_k, d = A.shape
    n = K * n_k
    lam = cfg.sigma / n                            # per-sample ridge weight

    noise_tau = 0.0
    if cfg.dp_eps is not None:
        if A.dtype != torch.float32:
            raise ValueError(
                f"DP-FedAvg needs float32 client data, got {A.dtype}: the "
                f"port draws jax.random's float32 normals only")
        eps0 = privacy.per_round_budget(cfg.dp_eps, cfg.rounds)
        noise_tau = privacy.gaussian_tau(eps0, cfg.dp_delta, cfg.dp_clip)
    masks, m, noise = _schedule(cfg, K, d, noise_tau)
    masks = torch.from_numpy(masks).to(device=A.device, dtype=A.dtype)
    if noise is not None:
        noise = torch.from_numpy(noise).to(A.device)
    At = A.transpose(1, 2)                         # (K, d, n_k), a view

    t0 = time.perf_counter()
    w = torch.zeros(d, dtype=A.dtype, device=A.device)
    history = []
    for r in range(cfg.rounds):
        w_global = w.expand(K, d)
        wk = w_global
        for _ in range(cfg.local_epochs):          # E full-batch GD epochs
            resid = torch.bmm(A, wk[:, :, None])[:, :, 0] - b
            grad = (2.0 / n_k) * torch.bmm(At, resid[:, :, None])[:, :, 0] \
                + 2.0 * lam * wk
            if cfg.prox_mu > 0.0:
                grad = grad + cfg.prox_mu * (wk - w_global)
            wk = wk - cfg.lr * grad
        updates = wk - w_global                    # transmit the update
        if noise is not None:
            norms = torch.linalg.vector_norm(updates, dim=1, keepdim=True)
            updates = updates / torch.clamp_min(norms / cfg.dp_clip, 1.0)
            updates = updates + noise[r]
        w = w + (masks[r][:, None] * updates).sum(0) / m
        if track_history:
            history.append(w)
    kernel_ops.synchronize(w)
    dt = time.perf_counter() - t0

    extras = {}
    if track_history:
        extras["history"] = torch.stack(history)
    return RunResult(
        weights=w,
        comm=comm.fedavg_comm(d, K, cfg.rounds),
        wall_time_s=dt,
        rounds=cfg.rounds,
        extras=extras,
    )


def one_gradient_step(ds: FederatedDataset, eta: float) -> torch.Tensor:
    """Proposition 4's strawman: a single aggregated gradient step from w=0.

    w1 = eta * sum_k h_k = eta * h — optimal only if the 'learning rate' were
    the matrix (G + sigma I)^{-1}, i.e. only by transmitting G anyway.
    """
    h = sum(A_k.T @ b_k for A_k, b_k in ds.clients)
    return eta * h
