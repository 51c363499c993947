"""Synthetic heterogeneous regression data — paper §V-A2.

Generation recipe (K clients, n_k samples each, d features):
  1. w* ~ N(0, I_d), normalized to unit norm.
  2. Client mean mu_k = gamma * u_k, u_k a random unit vector
     (gamma = 0 -> IID, gamma = 1 -> maximum heterogeneity).
  3. Features a_ki ~ N(mu_k, Sigma_k), Sigma_k diagonal with per-client
     scales in [0.8, 1.2].
  4. Targets b_ki = a_ki^T w* + eps, eps ~ N(0, NOISE_STD^2) with
     NOISE_STD = 0.1 (the paper's 0.0100 MSE floor).

The same distribution as the reference generator, drawn with a
``torch.Generator`` seeded from ``seed`` on the target device, so the
numbers differ from ``jax.random``'s; parity checks feed arrays made by the
reference through ``repro_torch.convert`` instead.
"""
from __future__ import annotations

import dataclasses

import torch

NOISE_STD = 0.1


@dataclasses.dataclass(frozen=True)
class FederatedDataset:
    """K clients' local data plus a held-out global test set."""

    clients: tuple[tuple[torch.Tensor, torch.Tensor], ...]  # [(A_k, b_k)] * K
    test_A: torch.Tensor
    test_b: torch.Tensor
    w_star: torch.Tensor
    gamma: float

    @property
    def num_clients(self) -> int:
        return len(self.clients)

    @property
    def dim(self) -> int:
        return self.test_A.shape[1]

    def stacked(self) -> tuple[torch.Tensor, torch.Tensor]:
        """The centralized view [A_1; ...; A_K], [b_1; ...; b_K] (eq. 7)."""
        A = torch.cat([a for a, _ in self.clients], dim=0)
        b = torch.cat([b for _, b in self.clients], dim=0)
        return A, b


def generate(seed: int = 0, *, num_clients: int = 20,
             samples_per_client: int = 500, dim: int = 100,
             gamma: float = 0.5, noise_std: float = NOISE_STD,
             test_fraction: float = 0.2, effective_rank: int | None = None,
             dtype=torch.float32, device="cuda") -> FederatedDataset:
    """Paper §V-A2 generator with its default settings.

    The test set holds ``test_fraction`` of the total samples, drawn from
    the mixture of client distributions. ``effective_rank`` r < dim embeds
    the features in an r-dimensional subspace (plus 5% isotropic residue).
    """
    g = torch.Generator(device=device).manual_seed(seed)

    def normal(*shape):
        return torch.randn(shape, generator=g, dtype=dtype, device=device)

    basis = None
    if effective_rank is not None and effective_rank < dim:
        q, _ = torch.linalg.qr(normal(dim, dim))
        basis = q[:effective_rank]                        # (r, d)

    def _embed(feats):
        if basis is None:
            return feats
        return feats[..., :basis.shape[0]] @ basis + 0.05 * feats

    w_star = normal(dim)
    w_star = w_star / torch.linalg.norm(w_star)
    u = normal(num_clients, dim)
    mus = gamma * u / torch.linalg.norm(u, dim=1, keepdim=True)    # (K, d)
    scales = 0.8 + 0.4 * torch.rand((num_clients, dim), generator=g,
                                    dtype=dtype, device=device)
    clients = []
    for k in range(num_clients):
        A_k = _embed(mus[k] + normal(samples_per_client, dim) * scales[k])
        b_k = A_k @ w_star + normal(samples_per_client) * noise_std
        clients.append((A_k, b_k))

    n_test = int(test_fraction * num_clients * samples_per_client)
    assign = torch.randint(0, num_clients, (n_test,), generator=g,
                           device=device)
    test_A = _embed(mus[assign] + normal(n_test, dim) * scales[assign])
    test_b = test_A @ w_star + normal(n_test) * noise_std
    return FederatedDataset(clients=tuple(clients), test_A=test_A,
                            test_b=test_b, w_star=w_star, gamma=gamma)


def as_sharded_rows(ds: FederatedDataset, num_shards: int
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """Re-partition the same global rows into ``num_shards`` equal clients.

    Theorem 1 makes the solution partition-invariant, so mapping K process
    clients onto a different number of mesh shards is exact: the stacked
    rows, cut to a multiple of ``num_shards``.
    """
    A, b = ds.stacked()
    n = (A.shape[0] // num_shards) * num_shards
    return A[:n], b[:n]
