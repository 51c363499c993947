"""End-to-end example on the PyTorch port: pretrain a backbone, then fit its
readout head with One-Shot federated probing (the paper's technique as a
framework feature). The port's copy of ``examples/train_probe_e2e.py``,
step for step.

1. Train a reduced-family backbone for a few hundred steps with the full
   substrate (pipeline -> AdamW train step -> checkpoints), on ``--device``
   (the card by default: attention through kernel K5).
2. Freeze it; 8 simulated clients each hold private (inputs, targets).
3. Each client computes sufficient statistics of the frozen features; ONE
   aggregation round recovers the exact centralized ridge head (Thm 2),
   held against the centralized fit of the pooled features (Phase 1 on
   kernel K1 on the card).

``launch.train.train`` has no ``chunk_size``: attention runs as one pass
(K5 on the card) and the recurrences at the port's chunk of 64, where the
reference passes ``chunk_size=32``. Checkpoints go to a temporary
directory, removed at the end.

  PYTHONPATH=src python examples/train_probe_e2e_torch.py [--steps 200] [--device cpu]
"""
import argparse
import sys
import tempfile

import numpy as np
import torch

from repro_torch import core
from repro_torch.core import probe
from repro_torch.launch.train import train
from repro_torch.models import model


def features(lm, tokens):
    """The frozen feature extractor: a forward pass (whose logits are not
    used), then the mean of the input embeddings over the sequence."""
    logits = model.forward(lm, {"tokens": tokens})
    del logits  # features = final-position hidden state via embeddings mean
    x = model._input_embeddings(lm, {"tokens": tokens})
    return x.mean(dim=1)


def main(argv=None) -> dict:
    """Run the example; returns the relative error of the one-shot head
    against the centralized one, the probe's MSE, the pooled features and
    targets and both heads."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="yi-9b")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = torch.device(args.device)

    # --- 1. pretrain -----------------------------------------------------------
    with tempfile.TemporaryDirectory(prefix="repro_torch_e2e_ckpt_") as ckpt_dir:
        res = train(args.arch, reduced=True, steps=args.steps, batch=args.batch,
                    seq=args.seq, ckpt_dir=ckpt_dir, device=device)
    lm, cfg = res["params"], res["cfg"]
    print(f"[e2e] pretrained {res['params_m']:.1f}M params: "
          f"loss {res['first_loss']:.3f} -> {res['final_loss']:.3f}")

    # --- 2. frozen feature extractor: ``features`` above ---------------------------
    # --- 3. federated probe -----------------------------------------------------
    K = 8
    rng = np.random.default_rng(0)
    w_true = torch.from_numpy(rng.standard_normal(cfg.d_model).astype(np.float32)
                              ).to(device) * 0.5
    client_stats, client_data = [], []
    for _ in range(K):
        toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (16, args.seq))
                                .astype(np.int32)).to(device)
        feats = features(lm, toks)
        y = feats @ w_true + 0.01 * torch.from_numpy(
            rng.standard_normal(16).astype(np.float32)).to(device)
        client_stats.append(probe._feature_stats(feats, y))
        client_data.append((feats, y))

    head = probe.solve_head(core.fuse_stats(client_stats), sigma=1e-3)

    # exactness check vs centralized fit on pooled features
    F = torch.cat([f for f, _ in client_data])
    Y = torch.cat([y for _, y in client_data])
    head_central = core.solve_ridge(core.compute_stats(F, Y), 1e-3)
    rel = float(torch.linalg.norm(head - head_central) / torch.linalg.norm(head_central))
    print(f"[e2e] one-shot probe head == centralized head: rel err {rel:.2e}")
    mse = float(torch.mean((F @ head - Y) ** 2))
    print(f"[e2e] probe train MSE {mse:.5f} after ONE communication round "
          f"({K} clients, {cfg.d_model}x{cfg.d_model} Gram each)")
    if not rel < 1e-3:
        raise AssertionError(f"one-shot head {rel:.2e} from the centralized one")
    return {"rel": rel, "mse": mse, "features": F, "targets": Y, "head": head,
            "head_central": head_central, "train": res}


if __name__ == "__main__":
    main(sys.argv[1:])
