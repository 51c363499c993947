"""Deterministic synthetic token / embedding pipeline for training.

The counterpart of the reference's ``data/pipeline.py``: batches are drawn
with numpy's ``default_rng`` seeded by (seed, step, shard), with the same
calls in the same order, so every batch is bitwise the reference's. Each
data shard draws only its slice of the global batch. Tensors are made on
an explicit ``device``; tokens and labels stay int32, as the reference's.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class BatchSpec:
    global_batch: int
    seq_len: int
    vocab_size: int


class TokenPipeline:
    """Step-indexed synthetic LM batches: tokens and next-token labels,
    drawn from a Zipf(1) marginal over the vocabulary."""

    def __init__(self, spec: BatchSpec, *, seed: int = 0, shard_index: int = 0,
                 num_shards: int = 1, device="cuda"):
        if spec.global_batch % num_shards:
            raise ValueError(f"{spec.global_batch=} not divisible by {num_shards=}")
        self.spec = spec
        self.seed = seed
        self.shard_index = shard_index
        self.num_shards = num_shards
        self.device = torch.device(device)
        self._local_batch = spec.global_batch // num_shards
        ranks = np.arange(1, spec.vocab_size + 1, dtype=np.float64)
        p = 1.0 / ranks
        self._probs = p / p.sum()

    def batch(self, step: int) -> dict[str, torch.Tensor]:
        rng = np.random.default_rng((self.seed, step, self.shard_index))
        toks = rng.choice(self.spec.vocab_size,
                          size=(self._local_batch, self.spec.seq_len + 1),
                          p=self._probs).astype(np.int32)
        toks = torch.from_numpy(toks).to(self.device)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    def __iter__(self) -> Iterator[dict[str, torch.Tensor]]:
        step = 0
        while True:
            yield self.batch(step)
            step += 1


class EmbeddingPipeline:
    """Precomputed frame / patch embeddings (batch, seq, d_model) and
    scalar targets, for the encoder and VLM backbones."""

    def __init__(self, *, global_batch: int, seq_len: int, d_model: int,
                 seed: int = 0, shard_index: int = 0, num_shards: int = 1,
                 device="cuda"):
        if global_batch % num_shards:
            raise ValueError("global_batch must divide num_shards")
        self.global_batch, self.seq_len, self.d_model = global_batch, seq_len, d_model
        self.seed, self.shard_index, self.num_shards = seed, shard_index, num_shards
        self.device = torch.device(device)
        self._local_batch = global_batch // num_shards

    def batch(self, step: int) -> dict[str, torch.Tensor]:
        rng = np.random.default_rng((self.seed, step, self.shard_index, 7))
        emb = rng.standard_normal((self._local_batch, self.seq_len, self.d_model),
                                  dtype=np.float32)
        tgt = rng.standard_normal((self._local_batch,), dtype=np.float32)
        return {"embeddings": torch.from_numpy(emb).to(self.device),
                "targets": torch.from_numpy(tgt).to(self.device)}
