"""Shared layers: RMSNorm, RoPE, the SwiGLU / GELU MLP, embedding and LM
head, and the chunk rule of the chunked recurrences (Mamba, RWKV); each
module's logical sharding axes (``axes_*``, the reference's, over the
port's ``PartitionSpec``).

The counterparts of the reference's ``models/layers.py``. Weights keep the
reference's (in, out) orientation, so a projection is ``x @ W`` and a JAX
parameter tree carries over without a transpose (``convert.model_params_from``).
Every module allocates its parameters empty; ``reset_parameters`` draws the
reference's distributions (normal x in_dim^-0.5 for projections, normal x
0.02 for the embedding, ones for norms) from an explicit ``torch.Generator``,
which gives other numbers than ``jax.random`` from the same seed. Parameters
do not require gradients, so a served model never builds a graph; a
training step (``model.make_train_step``) turns them on for its own use.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.launch.sharding import P


def dtype_of(name: str) -> torch.dtype:
    return {"bfloat16": torch.bfloat16, "float32": torch.float32}[name]


def weight(shape, dtype, device) -> nn.Parameter:
    """An uninitialised parameter that does not require gradients."""
    return nn.Parameter(torch.empty(shape, dtype=dtype, device=device),
                        requires_grad=False)


def dense_init_(w: torch.Tensor, generator: torch.Generator) -> None:
    """In place: normal x in_dim^-0.5 for an (in, out) weight."""
    w.normal_(generator=generator).mul_(w.shape[0] ** -0.5)


def pick_chunk(seq_len: int, requested: int | None) -> int:
    """Largest divisor of seq_len that is <= the requested chunk size (the
    reference's ``layers.pick_chunk``): a ragged length snaps down to a
    divisor instead of failing."""
    if requested is None or requested >= seq_len:
        return seq_len
    c = max(1, min(requested, seq_len))
    while seq_len % c:
        c -= 1
    return c


def axes_rmsnorm() -> dict:
    return {"scale": P("embed")}


class RMSNorm(nn.Module):
    """x / rms(x) in float32, cast back, times ``scale`` in x's dtype."""

    def __init__(self, d: int, eps: float, *, dtype, device):
        super().__init__()
        self.eps = eps
        self.scale = weight((d,), dtype, device)

    def reset_parameters(self) -> None:
        self.scale.fill_(1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x32 = x.float()
        var = torch.mean(x32 * x32, dim=-1, keepdim=True)
        return (x32 * torch.rsqrt(var + self.eps)).to(x.dtype) * self.scale


def rope_frequencies(head_dim: int, theta: float, device) -> torch.Tensor:
    """theta^(-2i / head_dim) for i < head_dim / 2, in float64."""
    exponents = torch.arange(0, head_dim, 2, dtype=torch.float64,
                             device=device) / head_dim
    return 1.0 / (theta ** exponents)                      # (head_dim/2,)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float
               ) -> torch.Tensor:
    """x: (..., seq, heads, head_dim); positions: (..., seq) integers.

    The reference's split-halves layout: the first and second halves of
    head_dim are the two coordinates of each rotated pair. The angles and
    their cos/sin are taken in float64 and rounded once to float32, so the
    rotation carries no error of its own that grows with the position; the
    rotation itself is in float32, as in the reference.
    """
    freqs = rope_frequencies(x.shape[-1], theta, x.device)
    angles = positions[..., :, None].double() * freqs      # (..., seq, hd/2)
    cos = torch.cos(angles).float()[..., :, None, :]
    sin = torch.sin(angles).float()[..., :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def axes_mlp(*, gated: bool = True) -> dict:
    p = {"up": P("embed", "ff"), "down": P("ff", "embed")}
    if gated:
        p["gate"] = P("embed", "ff")
    return p


class MLP(nn.Module):
    """SwiGLU ``(silu(x @ gate) * (x @ up)) @ down``, or with ``gated=False``
    (an encoder's MLP) ``gelu(x @ up) @ down`` with the tanh approximation,
    ``jax.nn.gelu``'s default."""

    def __init__(self, d_model: int, d_ff: int, *, dtype, device, gated: bool = True):
        super().__init__()
        self.up = weight((d_model, d_ff), dtype, device)
        self.down = weight((d_ff, d_model), dtype, device)
        self.gate = weight((d_model, d_ff), dtype, device) if gated else None

    def reset_parameters(self, generator: torch.Generator) -> None:
        for w in (self.up, self.gate, self.down):
            if w is not None:
                dense_init_(w, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        up = x @ self.up
        if self.gate is None:
            return F.gelu(up, approximate="tanh") @ self.down
        return (F.silu(x @ self.gate) * up) @ self.down


def axes_embedding() -> dict:
    return {"table": P("vocab", "embed")}


def axes_lm_head() -> dict:
    return {"kernel": P("embed", "vocab")}


class Embedding(nn.Module):
    def __init__(self, vocab: int, d_model: int, *, dtype, device):
        super().__init__()
        self.table = weight((vocab, d_model), dtype, device)

    def reset_parameters(self, generator: torch.Generator) -> None:
        self.table.normal_(generator=generator).mul_(0.02)

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        return self.table[tokens.long()]


class LMHead(nn.Module):
    def __init__(self, d_model: int, vocab: int, *, dtype, device):
        super().__init__()
        self.kernel = weight((d_model, vocab), dtype, device)

    def reset_parameters(self, generator: torch.Generator) -> None:
        dense_init_(self.kernel, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return lm_logits(self, x)


def lm_logits(head: LMHead, x: torch.Tensor) -> torch.Tensor:
    """The reference's ``lm_logits(params, x)``, the head module in place of
    its parameter dict: ``x @ kernel``."""
    return x @ head.kernel


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  mask: torch.Tensor | None = None) -> torch.Tensor:
    """Token-mean CE; the log-softmax in float32 whatever the logits' dtype.
    With a ``mask`` the mean is over the positions it sets (at least one)."""
    logits = logits.float()
    # logz and the gold logit keep the class axis (size 1) until they meet,
    # so the gather's result has the logits' rank and layout: on logits
    # sharded along the classes it stays a rank-3 partial term, not a
    # dropped axis whose layout has to be found again
    logz = torch.logsumexp(logits, dim=-1, keepdim=True)
    gold = logits.gather(-1, labels.long()[..., None])
    if mask is None:
        return torch.mean(logz - gold)
    mask = mask.float()[..., None]
    return ((logz - gold) * mask).sum() / torch.clamp(mask.sum(), min=1.0)
