"""Private one-shot federation (paper Algorithm 2) + the paper's own fixes,
on the PyTorch port. The port's copy of ``examples/private_federation.py``,
step for step.

Sweeps the privacy budget and shows the three variants:
  * per-client Gaussian noise (Alg 2 verbatim) — no composition penalty
  * + PSD repair (beyond-paper, free post-processing)
  * simulated secure aggregation (noise once on the sum; §VI-D.1)
and the LOCO-CV sigma selection (Prop 5) on the private statistics.

The keys are the reference's: ``threefry.key(int(eps * 100))`` and its
``fold_in(key, 1)``, whose noise is ``jax.random``'s bit for bit (drawn on
the host). Phase 1 runs on kernel K1 on the card (``--device``, the card by
default). ``run(ds)`` takes any ``FederatedDataset``; ``main`` draws the
reference's settings with the port's generator.

  PYTHONPATH=src python examples/private_federation_torch.py [--device cpu]
"""
import argparse
import sys

from repro_torch import core, data, fed
from repro_torch.core import fusion, privacy, threefry
from repro_torch.core.sufficient_stats import compute_stats, fuse_stats

SIGMA, DELTA = 0.01, 1e-5
EPS_GRID = (0.5, 1.0, 2.0, 5.0, 10.0)
CV_SIGMAS = [1e-4, 1e-3, 1e-2, 1e-1, 1.0]


def run(ds: data.FederatedDataset) -> dict:
    """The example's steps on ``ds``; prints the reference's lines and
    returns their numbers. An MSE is None where the line says "failed": a
    diverged solve (NaN) or an MSE of 1e3 or more, the paper's Remark-4
    failure mode."""
    def mse(w) -> float:
        return float(core.mse(ds.test_A, ds.test_b, w))

    def finite(m: float) -> float | None:
        return m if m == m and m < 1e3 else None

    def fmt(w) -> str:
        m = finite(mse(w))
        return f"{m:8.4f}" if m is not None else "  failed"

    clean = fed.run_one_shot(ds, SIGMA)
    print(f"non-private MSE: {mse(clean.weights):.4f}")
    print(f"{'eps':>6} {'alg2':>8} {'alg2+psd':>9} {'secagg':>8}")

    clip = (1.2 * ds.dim ** 0.5, 4.0)
    sg, sh = privacy.sensitivities(*clip)
    rows = []
    for eps in EPS_GRID:
        key = threefry.key(int(eps * 100))
        alg2 = fed.run_one_shot(ds, SIGMA, dp=(eps, DELTA), dp_key=key)
        psd = fed.run_one_shot(ds, SIGMA, dp=(eps, DELTA), dp_key=key,
                               psd_repair=True)
        stats = [compute_stats(*privacy.clip_rows(A, b, clip_a=clip[0],
                                                  clip_b=clip[1]))
                 for A, b in ds.clients]
        sec = privacy.central_dp_stats(threefry.fold_in(key, 1),
                                       fuse_stats(stats), eps, DELTA, ds.num_clients,
                                       sensitivity_g=sg, sensitivity_h=sh)
        w_sec = fusion.solve_ridge(sec, SIGMA)
        print(f"{eps:6.1f} {fmt(alg2.weights)} {fmt(psd.weights):>9s} "
              f"{fmt(w_sec)}")
        rows.append({"eps": eps, "alg2": finite(mse(alg2.weights)),
                     "alg2_psd": finite(mse(psd.weights)), "secagg": finite(mse(w_sec))})

    # Theorem 7: what iterative methods would pay for the same per-round budget
    eps0 = 0.1
    eps_total = privacy.advanced_composition(eps0, DELTA, 100)
    print(f"\nThm 7: {eps0=} over 100 rounds composes to "
          f"eps_total = {eps_total:.2f} "
          f"(one-shot: a single {eps0}-budget release)")

    # Prop 5: federated sigma selection without extra rounds
    best, res = fed.run_loco_cv(ds, sigmas=CV_SIGMAS)
    overhead = ds.num_clients * len(CV_SIGMAS)
    print(f"Prop 5 LOCO-CV selected sigma={best} "
          f"(MSE {mse(res.weights):.4f}, "
          f"overhead {overhead} scalars)")
    return {"mse_non_private": mse(clean.weights), "rows": rows,
            "thm7_eps_total": eps_total, "loco_sigma": best,
            "loco_mse": mse(res.weights), "loco_overhead_scalars": overhead}


def main(argv=None) -> dict:
    """The example at the reference's settings (20 clients, 500 samples
    each, d=100, gamma=0.5) on ``--device``."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    ds = data.generate(seed=0, num_clients=20, samples_per_client=500, dim=100,
                       gamma=0.5, device=args.device)
    return run(ds)


if __name__ == "__main__":
    main(sys.argv[1:])
