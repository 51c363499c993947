"""Grouped-query attention: full / sliding-window / bidirectional.

The counterparts of the reference's ``models/attention.py``. A full-sequence
pass (``attention_fwd``, ``prefill_cache``) goes through
``kernels.ops.swa_attention``: kernel K5 for CUDA tensors, its plain version
for CPU tensors. It computes what the reference's chunked online-softmax
``attention_fwd`` computes; the kernel reads grouped KV heads directly, so
no repeated K, V is built.

Decode keeps a cache per layer: full-attention layers the whole sequence,
SWA layers a ``window``-sized ring buffer (slot = position % window), with
keys stored already roped at absolute positions. Decode attention is plain
PyTorch (softmax over the cache), as the reference leaves it to XLA, and
writes the new key and value into the cache in place.
"""
from __future__ import annotations

import dataclasses

import torch
from torch import nn

from repro_torch.kernels import ops
from repro_torch.launch.sharding import P
from repro_torch.models import layers
from repro_torch.models.config import ArchConfig

NEG_INF = -1e30


class Attention(nn.Module):
    """wq (d, H*hd), wk, wv (d, H_kv*hd), wo (H*hd, d); biases if qkv_bias."""

    def __init__(self, cfg: ArchConfig, *, dtype, device):
        super().__init__()
        d = cfg.d_model
        self.wq = layers.weight((d, cfg.q_dim), dtype, device)
        self.wk = layers.weight((d, cfg.kv_dim), dtype, device)
        self.wv = layers.weight((d, cfg.kv_dim), dtype, device)
        self.wo = layers.weight((cfg.q_dim, d), dtype, device)
        self.bq = self.bk = self.bv = None
        # query rows a step of the plain attention and its backward (None:
        # ``kernels.ref``'s); a program that costs the step sets it per model
        self.query_block: int | None = None
        if cfg.qkv_bias:
            self.bq = layers.weight((cfg.q_dim,), dtype, device)
            self.bk = layers.weight((cfg.kv_dim,), dtype, device)
            self.bv = layers.weight((cfg.kv_dim,), dtype, device)

    def reset_parameters(self, generator: torch.Generator) -> None:
        for w in (self.wq, self.wk, self.wv, self.wo):
            layers.dense_init_(w, generator)
        for b in (self.bq, self.bk, self.bv):
            if b is not None:
                b.zero_()


def axes_attention(cfg: ArchConfig) -> dict:
    p = {"wq": P("embed", "heads"), "wk": P("embed", "kv"),
         "wv": P("embed", "kv"), "wo": P("heads", "embed")}
    if cfg.qkv_bias:
        p.update(bq=P("heads"), bk=P("kv"), bv=P("kv"))
    return p


def project_qkv(attn: Attention, x: torch.Tensor, cfg: ArchConfig,
                positions: torch.Tensor):
    """x (B, S, d) -> roped q (B, S, H, hd), roped k and v (B, S, H_kv, hd)."""
    B, S, _ = x.shape
    q, k, v = x @ attn.wq, x @ attn.wk, x @ attn.wv
    if attn.bq is not None:
        q, k, v = q + attn.bq, k + attn.bk, v + attn.bv
    q = q.reshape(B, S, cfg.num_heads, cfg.head_dim)
    k = k.reshape(B, S, cfg.num_kv_heads, cfg.head_dim)
    v = v.reshape(B, S, cfg.num_kv_heads, cfg.head_dim)
    q = layers.apply_rope(q, positions, cfg.rope_theta)
    k = layers.apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _self_attention(attn: Attention, x: torch.Tensor, cfg: ArchConfig,
                    kind: str):
    """Full-sequence attention output, and the roped k, v for a cache."""
    B, S, _ = x.shape
    positions = torch.arange(S, device=x.device).expand(B, S)
    q, k, v = project_qkv(attn, x, cfg, positions)
    out = ops.swa_attention(q, k, v,
                            window=cfg.window if kind == "swa" else None,
                            causal=kind != "full_bidir", block_q=attn.query_block)
    return out.reshape(B, S, cfg.q_dim) @ attn.wo, k, v


def attention_fwd(attn: Attention, x: torch.Tensor, cfg: ArchConfig, *,
                  kind: str) -> torch.Tensor:
    """Self-attention over a full sequence (prefill).

    kind: 'full' (causal), 'swa' (causal, windowed), 'full_bidir' (encoder).
    """
    return _self_attention(attn, x, cfg, kind)[0]


# --- KV cache ----------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class CacheSpec:
    """Shape spec for one attention layer's decode cache."""

    length: int  # seq_len for full layers, window for swa layers


def cache_length(cfg: ArchConfig, kind: str, seq_len: int) -> int:
    return min(cfg.window, seq_len) if kind == "swa" else seq_len


def init_cache(cfg: ArchConfig, kind: str, batch: int, seq_len: int, dtype,
               device) -> dict:
    L = cache_length(cfg, kind, seq_len)
    shape = (batch, L, cfg.num_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def axes_cache() -> dict:
    spec = P("batch", "seq_cache", "kv_heads", "head_dim")
    return {"k": spec, "v": spec}


def decode_slot(kind: str, pos: int, L: int) -> int:
    """The cache slot that decode position ``pos`` writes: ``pos % L`` in an
    SWA ring buffer, ``pos`` in a full layer's cache of length L, where
    ``pos >= L`` raises ValueError."""
    if kind == "swa":
        return pos % L
    if pos >= L:
        raise ValueError(f"decode position {pos} is past the full-attention "
                         f"cache length {L}; prefill with a larger max_len")
    return pos


def attention_decode(attn: Attention, x: torch.Tensor, cache: dict, pos: int,
                     cfg: ArchConfig, *, kind: str) -> tuple[torch.Tensor, dict]:
    """One decode step: x (B, 1, d) at absolute position ``pos``.

    Writes the new key and value at slot ``pos % L`` (SWA ring buffer) or
    ``pos`` (full) of ``cache`` in place, and returns (out, cache). Scores
    and the weighted sum are float32; the probabilities are rounded to the
    cache's dtype first, as in the reference.

    A full layer's cache holds positions 0 .. L - 1: ``pos >= L`` raises
    ValueError before anything is written. (The reference clamps the write
    onto the last slot and returns wrong logits.)
    """
    ck, cv = cache["k"], cache["v"]
    L = ck.shape[1]
    slot = decode_slot(kind, pos, L)
    B = x.shape[0]
    positions = torch.full((B, 1), pos, device=x.device)
    q, k, v = project_qkv(attn, x, cfg, positions)          # (B, 1, H/H_kv, hd)
    ck[:, slot] = k[:, 0].to(ck.dtype)
    cv[:, slot] = v[:, 0].to(cv.dtype)

    group = cfg.num_heads // cfg.num_kv_heads
    q_g = q.reshape(B, cfg.num_kv_heads, group, cfg.head_dim)
    s = torch.einsum("bkgd,blkd->bkgl", q_g.float(), ck.float()) \
        * cfg.head_dim ** -0.5                              # (B, H_kv, G, L)
    idx = torch.arange(L, device=x.device)
    if kind == "swa":
        # slot i holds the absolute position p with p % L == i and p <= pos;
        # valid iff it is one of the newest L positions and within the window
        abs_pos = torch.where(idx <= slot, pos - slot + idx, pos - slot - L + idx)
        valid = (abs_pos >= 0) & (abs_pos <= pos) & (pos - abs_pos < cfg.window)
    else:
        valid = idx <= pos
    s = torch.where(valid, s, NEG_INF)
    p = torch.softmax(s, dim=-1).to(cv.dtype)
    out = torch.einsum("bkgl,blkd->bkgd", p.float(), cv.float())
    out = out.reshape(B, 1, cfg.q_dim).to(x.dtype)
    return out @ attn.wo, cache


def prefill_cache(attn: Attention, x: torch.Tensor, cfg: ArchConfig, *,
                  kind: str, max_len: int | None = None
                  ) -> tuple[torch.Tensor, dict]:
    """Prefill: full-sequence attention output + the cache decode extends.

    SWA layers keep the newest ``window`` keys, at the ring-buffer slots
    (position % window) that decode reads them from.
    """
    B, S, _ = x.shape
    out, k, v = _self_attention(attn, x, cfg, kind)
    L = cache_length(cfg, kind, max_len or S)
    cache = init_cache(cfg, kind, B, max_len or S, k.dtype, x.device)
    keep = min(L, S)
    tail_pos = torch.arange(S - keep, S, device=x.device)
    slots = tail_pos % L if kind == "swa" else tail_pos
    cache["k"][:, slots] = k[:, S - keep:]
    cache["v"][:, slots] = v[:, S - keep:]
    return out, cache
