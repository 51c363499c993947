"""Training entry point: data pipeline -> train loop -> checkpoints.

The counterpart of the reference's ``launch/train.py`` on one device. Any
registered architecture, full or reduced, trains on ``--device`` (the card
by default): batches from ``data.pipeline`` (bitwise the reference's),
weights drawn by ``models.model.init_params`` from a ``torch.Generator``
seeded with ``--seed`` on that device (so they differ from the reference's
``jax.random`` draws), ``make_train_step`` with every stage recomputed in
the backward, AdamW under the reference trainer's schedule (warmup
max(steps // 20, 5), cosine to ``steps``). Mamba and RWKV layers run in
chunks of 64 (``models.blocks.SEQ_CHUNK``), the chunk the reference's
trainer passes. Checkpoints are the parameters in the reference's layout
(``convert.model_tree_of``) through ``checkpoint.save_pytree``, so either
package restores them.

  PYTHONPATH=src python -m repro_torch.launch.train --arch yi-9b --reduced \
      --steps 200 --batch 8 --seq 128 [--ckpt-dir DIR] [--device cpu]
"""
from __future__ import annotations

import argparse
import json
import pathlib
import time

import numpy as np
import torch

from repro_torch import checkpoint, configs, convert
from repro_torch.data import BatchSpec, EmbeddingPipeline, TokenPipeline
from repro_torch.kernels import ops
from repro_torch.models import model as M
from repro_torch.optim import adamw


def make_pipeline(cfg, batch: int, seq: int, seed: int, *, device="cuda"):
    if cfg.input_mode == "embeddings":
        return EmbeddingPipeline(global_batch=batch, seq_len=seq, d_model=cfg.d_model,
                                 seed=seed, device=device)
    return TokenPipeline(BatchSpec(batch, seq, cfg.vocab_size), seed=seed, device=device)


def prepare_batch(cfg, raw: dict) -> dict:
    """Adapt the pipeline's output to the model's input mode: an encoder's
    unit labels and mask from ``default_rng(0)``, a VLM's patches from
    ``default_rng(1)``, drawn as the reference draws them, on the raw
    batch's device."""
    if cfg.input_mode == "tokens":
        return raw
    if cfg.input_mode == "embeddings":
        gen = np.random.default_rng(0)
        B, S, _ = raw["embeddings"].shape
        device = raw["embeddings"].device
        labels = gen.integers(0, cfg.vocab_size, (B, S)).astype("int32")
        mask = gen.random((B, S)) < 0.3
        return {"embeddings": raw["embeddings"],
                "labels": torch.from_numpy(labels).to(device),
                "mask": torch.from_numpy(mask).to(device)}
    gen = np.random.default_rng(1)
    B, S = raw["tokens"].shape
    patches = gen.standard_normal((B, cfg.num_prefix, cfg.d_model), dtype="float32")
    return {"tokens": raw["tokens"], "labels": raw["labels"],
            "patches": torch.from_numpy(patches).to(raw["tokens"].device)}


def train(arch: str, *, reduced: bool = True, steps: int = 100,
          batch: int = 8, seq: int = 128, lr: float = 3e-4,
          ckpt_dir: str | None = None, ckpt_every: int = 100,
          log_every: int = 10, seed: int = 0, device="cuda") -> dict:
    """Train ``arch`` for ``steps`` steps; the reference's result dict (the
    logged losses under ``history``) plus the model and its config."""
    cfg = configs.get_reduced(arch) if reduced else configs.get(arch)
    device = torch.device(device)
    pipe = make_pipeline(cfg, batch, seq, seed, device=device)
    opt_cfg = adamw.AdamWConfig(lr=lr, warmup_steps=max(steps // 20, 5),
                                total_steps=steps)
    model = M.init_params(cfg, generator=torch.Generator(device).manual_seed(seed),
                          device=device)
    opt_state = adamw.init(model)
    step_fn = M.make_train_step(cfg, opt_cfg)

    n_params = sum(p.numel() for p in model.parameters())
    print(f"[train] {cfg.name}: {n_params / 1e6:.1f}M params, "
          f"{steps} steps, batch {batch} x seq {seq}")

    history = []
    t0 = time.time()
    for i in range(steps):
        loss = step_fn(model, opt_state, prepare_batch(cfg, pipe.batch(i)))
        if i % log_every == 0 or i == steps - 1:
            value = float(loss)
            history.append({"step": i, "loss": value})
            print(f"[train] step {i:5d} loss {value:.4f} "
                  f"({(time.time() - t0) / (i + 1):.2f}s/step)", flush=True)
        if ckpt_dir and (i + 1) % ckpt_every == 0:
            checkpoint.save_pytree(convert.model_tree_of(model), ckpt_dir, step=i + 1)

    if ckpt_dir:
        checkpoint.save_pytree(convert.model_tree_of(model), ckpt_dir, step=steps)
    ops.synchronize(next(model.parameters()))
    result = {"arch": cfg.name, "params_m": n_params / 1e6,
              "final_loss": history[-1]["loss"],
              "first_loss": history[0]["loss"],
              "wall_s": time.time() - t0, "history": history}
    return result | {"params": model, "cfg": cfg}


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=list(configs.ARCH_IDS))
    ap.add_argument("--reduced", action="store_true", default=False)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    res = train(args.arch, reduced=args.reduced, steps=args.steps,
                batch=args.batch, seq=args.seq, lr=args.lr,
                ckpt_dir=args.ckpt_dir, device=args.device)
    res.pop("params")
    res.pop("cfg")
    if args.out:
        pathlib.Path(args.out).write_text(json.dumps(res, indent=1))
    print(f"[train] done: loss {res['first_loss']:.3f} -> "
          f"{res['final_loss']:.3f} in {res['wall_s']:.0f}s")


if __name__ == "__main__":
    main()
