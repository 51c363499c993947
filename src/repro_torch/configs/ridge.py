"""The paper's own model: federated ridge regression (§V-A defaults).

This is the configuration every benchmark table starts from; individual
tables sweep one axis (gamma, d, K, eps, m) around these defaults.
"""
import dataclasses


@dataclasses.dataclass(frozen=True)
class RidgeConfig:
    num_clients: int = 20
    samples_per_client: int = 500
    dim: int = 100
    sigma: float = 0.01
    gamma: float = 0.5
    noise_std: float = 0.1
    trials: int = 5
    # iterative baselines (paper §V-A1)
    fedavg_lr: float = 0.01
    fedavg_epochs: int = 5
    fedprox_mu: float = 0.01


CONFIG = RidgeConfig()
