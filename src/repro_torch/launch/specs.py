"""Shape-only inputs for every (arch x input-shape) pair: ``meta`` tensors.

The counterpart of the reference's ``launch/specs.py``, whose
``ShapeDtypeStruct``s come from ``jax.eval_shape``. Here they are tensors
on the ``meta`` device, made by the port's own constructors
(``BackboneLM(cfg, device="meta")``, ``optim.adamw.init``,
``models.model.init_decode_cache``), so they carry shapes and dtypes and
allocate nothing. Parameters, optimizer state and caches come in the
reference's tree layout (``models.model.stacked_tree``: each
stage-pattern position's leaves stacked along a leading ``num_stages``
axis), which the sharding rules' ``"stack"`` axis needs; a cache's ``pos``
is the reference's int32 scalar, where the port's own cache keeps a Python
int. Batches carry the port's dtypes, which are the reference's: int32
tokens and labels (as ``data.pipeline`` makes them), a bool mask, frame
and patch embeddings in the activation dtype (the encoder's and the VLM's
frontends are stubs in both packages).
"""
from __future__ import annotations

import torch

from repro_torch.models import layers
from repro_torch.models import model as M
from repro_torch.models.config import ArchConfig, InputShape
from repro_torch.optim import adamw


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def _stack(leaves) -> torch.Tensor:
    """The meta tensor ``torch.stack(leaves)`` would give, made directly."""
    return _meta((len(leaves), *leaves[0].shape), leaves[0].dtype)


def batch_specs(cfg: ArchConfig, shape: InputShape) -> dict:
    """The input batch of one step kind."""
    B = shape.global_batch
    act = layers.dtype_of(cfg.dtype)
    if shape.kind == "decode":
        if cfg.input_mode == "embeddings":
            raise ValueError("encoder-only arch has no decode step")
        return {"tokens": _meta((B, 1), torch.int32)}
    S = shape.seq_len
    train = shape.kind == "train"
    if cfg.input_mode == "tokens":
        batch = {"tokens": _meta((B, S), torch.int32)}
        if train:
            batch["labels"] = _meta((B, S), torch.int32)
        return batch
    if cfg.input_mode == "embeddings":
        batch = {"embeddings": _meta((B, S, cfg.d_model), act)}
        if train:
            batch["labels"] = _meta((B, S), torch.int32)
            batch["mask"] = _meta((B, S), torch.bool)
        return batch
    if cfg.input_mode == "prefix_embeddings":
        S_text = S - cfg.num_prefix           # total sequence = prefix + text
        batch = {"tokens": _meta((B, S_text), torch.int32),
                 "patches": _meta((B, cfg.num_prefix, cfg.d_model), act)}
        if train:
            batch["labels"] = _meta((B, S_text), torch.int32)
        return batch
    raise ValueError(cfg.input_mode)


def params_specs(cfg: ArchConfig) -> dict:
    """The parameters of ``BackboneLM(cfg)`` on meta, in the reference's layout."""
    model = M.BackboneLM(cfg, device="meta")
    return M.stacked_tree(cfg, dict(model.named_parameters()), _stack)


def opt_specs(cfg: ArchConfig) -> dict:
    """AdamW's state of that model on meta: master, m and v (float32) in the
    reference's layout, and the int32 step count."""
    state = adamw.init(M.BackboneLM(cfg, device="meta"))
    out = {k: M.stacked_tree(cfg, state[k], _stack) for k in ("master", "m", "v")}
    out["count"] = state["count"]
    return out


def cache_specs(cfg: ArchConfig, shape: InputShape) -> dict:
    """An empty decode cache of ``shape``'s batch and length on meta, in the
    reference's layout."""
    cache = M.init_decode_cache(cfg, shape.global_batch, shape.seq_len, device="meta")
    per_stage = len(cfg.stage_pattern)
    n_stacked = per_stage * cfg.num_stages
    stages = []
    for i in range(per_stage):
        layer_caches = cache["layers"][i:n_stacked:per_stage]
        stages.append({k: _stack([c[k] for c in layer_caches]) for k in layer_caches[0]})
    out: dict = {"stages": tuple(stages), "pos": _meta((), torch.int32)}
    if cfg.tail_pattern:
        out["tail"] = tuple(cache["layers"][n_stacked:])
    return out
