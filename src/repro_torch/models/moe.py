"""Mixture-of-Experts block: top-k softmax router + capacity-bounded dispatch.

The counterpart of the reference's ``models/moe.py``. Each (token, choice)
pair takes its rank within its expert from an exclusive cumulative sum over
the (T * k, E) assignment matrix, in token order with the choices of a
token in order; pairs at rank >= C are dropped (standard token dropping).
Kept pairs are written into (E, C, d) slots, the expert FFNs run as three
batched products (``torch.bmm``: cuBLAS, as the reference leaves them to
XLA), and each token adds its kept choices' outputs, weighted by their
gates, in choice order.

Routing follows the reference exactly, since it decides which pairs are
dropped: logits in the activation dtype, cast to float32, softmax; top-k
with ``jax.lax.top_k``'s tie rule (among equal probabilities the lower
expert index first, :func:`top_k`); gates renormalised by
``max(sum, 1e-9)`` and cast to the activation dtype for the combine.

The router aux loss is the standard load-balance term
  E * sum_e f_e * p_e   (f: fraction of choices routed, p: mean router prob)
over the assignments before capacity.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn
from torch.profiler import record_function

from repro_torch.launch.sharding import P
from repro_torch.models import layers
from repro_torch.models.config import ArchConfig


def axes_moe() -> dict:
    return {"router": P("embed", None), "gate": P("experts", "embed", "ff"),
            "up": P("experts", "embed", "ff"), "down": P("experts", "ff", "embed")}


class MoE(nn.Module):
    """router (d, E); gate, up (E, d, ff); down (E, ff, d) — the reference's
    parameter names, so ``convert.model_params_from`` finds them.

    ``routing`` holds what the last :func:`moe_block` call assigned: the
    router probabilities (T, E) in float32, the expert indices (T, k) and
    the kept mask (T, k), tokens in b-major order. It is the block's one
    observation point, read by the tests and by the card smoke's dropped
    shares and routing-flip check, prefill and decode alike: it holds the
    tensors the block computes anyway (no copy, no host sync) until the
    next call replaces them. The block's four ``record_function`` ranges
    are the labels of the smoke's profiler split.
    """

    def __init__(self, cfg: ArchConfig, *, dtype, device):
        super().__init__()
        d, E, ff = cfg.d_model, cfg.num_experts, cfg.d_ff
        self.router = layers.weight((d, E), dtype, device)
        self.gate = layers.weight((E, d, ff), dtype, device)
        self.up = layers.weight((E, d, ff), dtype, device)
        self.down = layers.weight((E, ff, d), dtype, device)
        self.routing: dict | None = None

    def reset_parameters(self, generator: torch.Generator) -> None:
        """The reference's distributions: normal x d^-0.5 for the router,
        gate and up, normal x ff^-0.5 for down."""
        layers.dense_init_(self.router, generator)
        for w in (self.gate, self.up, self.down):
            w.normal_(generator=generator).mul_(w.shape[1] ** -0.5)


def capacity(cfg: ArchConfig, num_tokens: int) -> int:
    """Slots per expert: capacity_factor x T x k / E, at least k."""
    c = int(cfg.capacity_factor * num_tokens * cfg.top_k / cfg.num_experts)
    return max(c, cfg.top_k)


def top_k(probs: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The k largest along the last axis, largest first, equal values in
    index order (``jax.lax.top_k``'s order; ``torch.topk`` promises none)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def route(module: MoE, xt: torch.Tensor, cfg: ArchConfig):
    """xt (T, d) -> float32 probabilities (T, E), renormalised gates (T, k)
    and expert indices (T, k)."""
    probs = torch.softmax((xt @ module.router).float(), dim=-1)
    gate_vals, expert_idx = top_k(probs, cfg.top_k)
    gate_vals = gate_vals / gate_vals.sum(-1, keepdim=True).clamp_min(1e-9)
    return probs, gate_vals, expert_idx


def moe_block(module: MoE, x: torch.Tensor, cfg: ArchConfig,
              *, return_aux: bool = False):
    """x: (B, S, d) -> (B, S, d) [, aux_loss scalar]."""
    B, S, d = x.shape
    E, k = cfg.num_experts, cfg.top_k
    T = B * S
    xt = x.reshape(T, d)
    C = capacity(cfg, T)

    with record_function("moe.route"):
        probs, gate_vals, expert_idx = route(module, xt, cfg)
        # each (token, choice) pair's rank within its expert, in pair order
        flat_e = expert_idx.reshape(T * k)
        onehot = F.one_hot(flat_e, E)
        ranks = onehot.cumsum(0) - onehot
        rank_in_e = ranks.gather(1, flat_e[:, None])[:, 0]
        keep = rank_in_e < C
    module.routing = {"probs": probs, "expert_idx": expert_idx,
                      "keep": keep.reshape(T, k)}

    with record_function("moe.dispatch"):
        # slot C is a spill row for the dropped pairs, never computed
        slot = torch.where(keep, rank_in_e, C)
        src = torch.arange(T * k, device=x.device) // k   # each pair's token
        disp = xt.new_zeros(E, C + 1, d)
        disp[flat_e, slot] = xt[src]

    with record_function("moe.experts"):           # (E, C, d) -> (E, C, d)
        h = torch.bmm(disp[:, :C], module.gate)
        u = torch.bmm(disp[:, :C], module.up)
        if torch.is_grad_enabled() and (h.requires_grad or u.requires_grad):
            act = F.silu(h) * u      # silu's backward needs h itself
        else:
            act = F.silu(h, inplace=True).mul_(u)
        del u
        out_e = torch.bmm(act, module.down)

    with record_function("moe.combine"):
        w = (gate_vals.reshape(T * k) * keep).to(xt.dtype)
        gathered = out_e[flat_e, slot.clamp(max=C - 1)] * w[:, None]
        gathered = gathered.reshape(T, k, d)
        y = xt.new_zeros(T, d)
        for j in range(k):
            y = y + gathered[:, j]
    y = y.reshape(B, S, d)

    if not return_aux:
        return y
    frac = F.one_hot(expert_idx, E).float().mean(dim=(0, 1))
    aux = E * torch.sum(frac * probs.mean(0))
    return y, aux


def moe_block_gather(module: MoE, x: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    """Dropless per-token expert gather: each token runs its top-k experts'
    weights directly. No serving path calls it; it is the reference's
    dropless counterpart of :func:`moe_block`."""
    B, S, d = x.shape
    xt = x.reshape(B * S, d)
    _, gate_vals, expert_idx = route(module, xt, cfg)
    Wg = module.gate[expert_idx]                             # (T, k, d, ff)
    Wu = module.up[expert_idx]
    Wd = module.down[expert_idx]                             # (T, k, ff, d)
    h = torch.einsum("td,tkdf->tkf", xt, Wg)
    u = torch.einsum("td,tkdf->tkf", xt, Wu)
    out = torch.einsum("tkf,tkfd->tkd", F.silu(h) * u, Wd)
    y = (out * gate_vals[..., None].to(out.dtype)).sum(1)
    return y.reshape(B, S, d).to(x.dtype)
