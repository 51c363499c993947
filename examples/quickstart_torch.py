"""Quickstart on the PyTorch port: One-Shot sigma-Fusion (paper Algorithm 1).
The port's copy of ``examples/quickstart.py``, step for step.

Generates the paper's heterogeneous synthetic benchmark, runs the one-shot
protocol, and shows exact recovery vs the centralized oracle plus the
communication ledger vs FedAvg, then Thm-8 dropout. Phase 1
(``core.compute_stats``) runs on kernel K1 on the card (``--device``, the
card by default) and on its plain version on the CPU.

``run(ds)`` takes any ``FederatedDataset``, so the same steps run on the
reference's data (``convert.dataset_from_numpy``) or at another size.
``main`` draws the reference's settings with the port's generator, whose
numbers differ from ``jax.random``'s.

  PYTHONPATH=src python examples/quickstart_torch.py [--device cpu]
"""
import argparse
import sys

import torch

from repro_torch import core, data, fed

SIGMA = 0.01


def run(ds: data.FederatedDataset, sigma: float = SIGMA) -> dict:
    """The example's steps on ``ds``; prints the reference's lines and
    returns their numbers, the weights and the dropout mask."""
    # --- the whole protocol -----------------------------------------------------
    # Phase 1 (clients, parallel): local sufficient statistics
    client_stats = [core.compute_stats(A_k, b_k) for A_k, b_k in ds.clients]
    # Phase 2+3 (server): one aggregation, one Cholesky solve
    w_fed = core.one_shot_fusion(client_stats, sigma)
    # ----------------------------------------------------------------------------

    w_central = core.solve_ridge(core.compute_stats(*ds.stacked()), sigma)
    rel_err = float(torch.linalg.norm(w_fed - w_central) / torch.linalg.norm(w_central))
    print(f"exact recovery: ||w_fed - w_central|| / ||w_central|| = {rel_err:.2e}")

    mse_fed = float(core.mse(ds.test_A, ds.test_b, w_fed))
    mse_oracle = float(core.mse(ds.test_A, ds.test_b, w_central))
    print(f"test MSE: one-shot {mse_fed:.4f} | centralized oracle {mse_oracle:.4f}")

    fa = fed.run_iterative(ds, fed.IterativeConfig(rounds=200, sigma=sigma))
    mse_fa = float(core.mse(ds.test_A, ds.test_b, fa.weights))
    one_comm = fed.one_shot_comm(ds.dim, ds.num_clients)
    print(f"FedAvg-200:  MSE {mse_fa:.4f}, comm {fa.comm.total_mb:.2f} MiB, "
          f"{fa.rounds} rounds")
    print(f"One-Shot:    MSE {mse_fed:.4f}, comm {one_comm.total_mb:.2f} MiB, "
          f"1 round ({fa.comm.total_mb / one_comm.total_mb:.1f}x less traffic)")

    # dropout robustness (Thm 8): half the clients vanish, still exact
    alive = [k % 2 == 0 for k in range(ds.num_clients)]
    res = fed.run_one_shot(ds, sigma, participating=alive)
    mse_drop = float(core.mse(ds.test_A, ds.test_b, res.weights))
    print(f"with 50% dropout: MSE {mse_drop:.4f} "
          f"(exact optimum for the {sum(alive)} surviving clients)")
    return {"rel_err": rel_err, "mse_one_shot": mse_fed, "mse_centralized": mse_oracle,
            "mse_fedavg": mse_fa, "fedavg_mb": fa.comm.total_mb, "fedavg_rounds": fa.rounds,
            "one_shot_mb": one_comm.total_mb,
            "traffic_ratio": fa.comm.total_mb / one_comm.total_mb,
            "mse_dropout": mse_drop, "survivors": sum(alive), "alive": alive,
            "w_fed": w_fed, "w_central": w_central, "w_dropout": res.weights}


def main(argv=None) -> dict:
    """The example at the reference's settings (20 clients, 500 samples
    each, d=100, heterogeneity gamma=0.5, paper §V-A) on ``--device``."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    ds = data.generate(seed=0, num_clients=20, samples_per_client=500, dim=100,
                       gamma=0.5, device=args.device)
    return run(ds)


if __name__ == "__main__":
    main(sys.argv[1:])
