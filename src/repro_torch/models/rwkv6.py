"""RWKV6 "Finch": the data-dependent-decay time mix and the channel mix.

The counterpart of the reference's ``models/rwkv6.py``. Per head, with a
state S of hd x hd,

    y_t = r_t @ (S_{t-1} + diag(u) k_t^T v_t),    S_t = diag(w_t) S_{t-1} + k_t^T v_t

where the decay w_t = exp(-exp(w0 + tanh(x_t A) B)) depends on the input.
A full-sequence pass runs the reference's chunked form in float32: within a
chunk, the decay products become a masked (chunk x chunk) product through
cumulative log-decays, and a chunk hands its state on as
S' = diag(prod w) S + sum_i (prod_{j>i} w . k_i)^T v_i. Every term but the
carried S depends on its chunk alone, so the port makes them for up to
``GROUP_CHUNKS`` chunks at once, each product one batched matmul over
(chunk, batch, head), and carries S across those chunks in a Python loop
of one ``addcmul`` a chunk; the state each chunk starts from then enters
its outputs in one more batched matmul. Float32 terms exist for one group
of chunks at a time (4096 positions at chunk 64). The reference leaves the
chunk step to XLA (einsums in a ``lax.scan`` over chunks); the port leaves
it to PyTorch's kernels, inside one ``rwkv.wkv`` ``record_function``
range, the head norm included. Decode is the single-step recurrence, with
a cache of S and the two token shifts: the same bytes at any context
length.

The chunked form takes ``exp(-cumsum(log w))`` over a chunk, which
overflows float32 once the summed log-decay passes ~88: a whole long
sequence as one chunk (the reference's ``chunk_size=None``) gives NaN rows.
The port's layers run every full-sequence pass in chunks of 64
(``blocks.SEQ_CHUNK``), the chunk the reference's ``serve`` prefills with.

``w0``, ``u`` and ``ln_scale`` are float32 in every model, as in the
reference; the rest follows the model's dtype, and every cast is the
reference's.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn
from torch.profiler import record_function

from repro_torch.launch.sharding import P
from repro_torch.models import layers
from repro_torch.models.config import ArchConfig

LORA_RANK = 32
GROUP_CHUNKS = 64      # chunks whose state-free terms are made at once


def axes_rwkv() -> dict:
    return {"mix": P(None, "embed"),
            "wr": P("embed", "heads"), "wk": P("embed", "heads"),
            "wv": P("embed", "heads"), "wg": P("embed", "heads"),
            "wo": P("heads", "embed"), "w0": P("embed"),
            "wA": P("embed", None), "wB": P(None, "embed"),
            "u": P("rwkv_heads", "head_dim"), "ln_scale": P("rwkv_heads", "head_dim")}


def axes_channel_mix() -> dict:
    return {"mix": P(None, "embed"), "wk": P("embed", "ff"),
            "wv": P("ff", "embed"), "wr": P("embed", "heads")}


class RWKVTimeMix(nn.Module):
    """mix (5, d): the r, k, v, w, g token-shift coefficients; wr, wk, wv,
    wg, wo (d, d); the decay's w0 (d,) in float32 and low-rank wA (d, 32),
    wB (32, d); the bonus u and the head norm's ln_scale (H, hd) in
    float32: the reference's parameter names, so
    ``convert.model_params_from`` finds them."""

    def __init__(self, cfg: ArchConfig, *, dtype, device):
        super().__init__()
        d, H, hd = cfg.d_model, cfg.rwkv_heads, cfg.rwkv_head_dim
        self.mix = layers.weight((5, d), dtype, device)
        for name in ("wr", "wk", "wv", "wg", "wo"):
            setattr(self, name, layers.weight((d, d), dtype, device))
        self.w0 = layers.weight((d,), torch.float32, device)
        self.wA = layers.weight((d, LORA_RANK), dtype, device)
        self.wB = layers.weight((LORA_RANK, d), dtype, device)
        self.u = layers.weight((H, hd), torch.float32, device)
        self.ln_scale = layers.weight((H, hd), torch.float32, device)

    def reset_parameters(self, generator: torch.Generator) -> None:
        """The reference's distributions: mix uniform on [0, 1), the
        projections and wA normal x in_dim^-0.5, wB normal x 0.01, w0 =
        -0.5, u normal x 0.1, ln_scale ones."""
        self.mix.uniform_(generator=generator)
        for w in (self.wr, self.wk, self.wv, self.wg, self.wo, self.wA):
            layers.dense_init_(w, generator)
        self.wB.normal_(generator=generator).mul_(0.01)
        self.w0.fill_(-0.5)
        self.u.normal_(generator=generator).mul_(0.1)
        self.ln_scale.fill_(1)


class RWKVChannelMix(nn.Module):
    """mix (2, d): the k, r token-shift coefficients; wk (d, d_ff), wv
    (d_ff, d), wr (d, d)."""

    def __init__(self, cfg: ArchConfig, *, dtype, device):
        super().__init__()
        d = cfg.d_model
        self.mix = layers.weight((2, d), dtype, device)
        self.wk = layers.weight((d, cfg.d_ff), dtype, device)
        self.wv = layers.weight((cfg.d_ff, d), dtype, device)
        self.wr = layers.weight((d, d), dtype, device)

    def reset_parameters(self, generator: torch.Generator) -> None:
        self.mix.uniform_(generator=generator)
        for w in (self.wk, self.wv, self.wr):
            layers.dense_init_(w, generator)


def _token_shift(x: torch.Tensor, prev: torch.Tensor | None = None) -> torch.Tensor:
    """x_{t-1} (B, S, d), the step before the sequence ``prev`` (B, d) or
    zeros."""
    first = torch.zeros_like(x[:, :1]) if prev is None else prev[:, None]
    return torch.cat([first, x[:, :-1]], dim=1)


def _mixed(mix: torch.Tensor, x: torch.Tensor, xs: torch.Tensor):
    """x + mix[i] (xs - x) for each row of ``mix``, in x's dtype (the
    reference's form; ``torch.lerp`` rounds otherwise), in one broadcast."""
    return (x + mix[:, None, None] * (xs - x)).unbind(0)


def _projections(tm: RWKVTimeMix, x: torch.Tensor, x_prev: torch.Tensor | None):
    """r, k, v, g and the decay's low-rank term tanh(xw @ wA) @ wB, each
    (B, S, d) in x's dtype."""
    xr, xk, xv, xw, xg = _mixed(tm.mix, x, _token_shift(x, x_prev))
    return (xr @ tm.wr, xk @ tm.wk, xv @ tm.wv, F.silu(xg @ tm.wg),
            torch.tanh(xw @ tm.wA) @ tm.wB)


def _head_norm(tm: RWKVTimeMix, y: torch.Tensor, eps: float) -> torch.Tensor:
    """Per-head norm of y (..., H, hd) over hd, float32: the population
    variance, as ``jnp.var``."""
    var, mu = torch.var_mean(y, -1, keepdim=True, correction=0)
    return (y - mu) * torch.rsqrt(var + eps) * tm.ln_scale


def _chunked(t: torch.Tensor, chunk: int, H: int, hd: int) -> torch.Tensor:
    """(B, n chunk, d) in any dtype -> (n, B, H, chunk, hd) float32,
    contiguous: one cast and transpose."""
    B, P, _ = t.shape
    return t.view(B, P // chunk, chunk, H, hd).permute(1, 0, 3, 2, 4).to(
        torch.float32, memory_format=torch.contiguous_format)


def _wkv_group(S0, r, k, v, lw, u):
    """The reference's ``chunk_step`` for n chunks at once, float32, on (n,
    B, H, c, hd) inputs, from the state S0 (B, H, hd, hd) before the first:
    the outputs (n, B, H, c, hd) and the state after the last. The terms
    are the reference's and are summed in its order."""
    lw_cum = torch.cumsum(lw, dim=3)                       # inclusive
    lw_prev = lw_cum - lw                                  # exclusive
    q = r * torch.exp(lw_prev)
    k_i = k * torch.exp(-lw_cum)
    att = (q @ k_i.transpose(-1, -2)).tril(-1)             # (n, B, H, c, c), i < t
    bonus = (r * u[:, None] * k).sum(-1, keepdim=True)     # r_t . u k_t
    # each chunk's update: S' = diag(prod w) S + sum_i (prod_{j>i} w . k_i)^T v_i
    k_dec = k * torch.exp(lw_cum[..., -1:, :] - lw_cum)
    kv = k_dec.transpose(-1, -2) @ v                       # (n, B, H, hd, hd)
    decay = torch.exp(lw_cum[..., -1, :])[..., None]       # (n, B, H, hd, 1)
    # the carry: the state each chunk starts from
    if torch.is_grad_enabled() and any(t.requires_grad for t in (S0, kv, decay)):
        # out= has no gradient: the same addcmuls, out of place (serving
        # writes each state in place rather than stacking copies of them)
        carried = [S0]
        for j in range(r.shape[0] - 1):
            carried.append(torch.addcmul(kv[j], decay[j], carried[j]))
        starts = torch.stack(carried)
    else:
        starts = torch.empty_like(kv)
        starts[0] = S0
        for j in range(r.shape[0] - 1):
            torch.addcmul(kv[j], decay[j], starts[j], out=starts[j + 1])
    # cross: y_t = (r_t . prod_{j<=t-1} w_j) @ S_start
    y = q @ starts
    # intra: y_t += sum_{i<t} (r_t . prod_{i<j<t} w) . k_i  v_i
    y = y + att @ v
    # bonus diagonal: y_t += (r_t . u k_t) v_t
    y = y + bonus * v
    return y, torch.addcmul(kv[-1], decay[-1], starts[-1])


def rwkv_time_mix(tm: RWKVTimeMix, x: torch.Tensor, cfg: ArchConfig, *,
                  chunk_size: int | None = None, return_state: bool = False):
    """x (B, S, d) -> (B, S, d) [, the final state S (B, H, hd, hd)
    float32]. The chunk is ``layers.pick_chunk(S, chunk_size)``; None is
    one chunk, which overflows past ~88 of summed log-decay (the module
    docstring)."""
    B, S, d = x.shape
    H, hd = cfg.rwkv_heads, cfg.rwkv_head_dim
    chunk = layers.pick_chunk(S, chunk_size)
    r, k, v, g, lora = _projections(tm, x, None)
    w0 = tm.w0.view(H, 1, hd)
    state = x.new_zeros(B, H, hd, hd, dtype=torch.float32)
    y = torch.empty(B, S, d, dtype=x.dtype, device=x.device)
    span = GROUP_CHUNKS * chunk
    with record_function("rwkv.wkv"):
        for p0 in range(0, S, span):
            sl = slice(p0, p0 + span)
            lw = -torch.exp(w0 + _chunked(lora[:, sl], chunk, H, hd))
            y_g, state = _wkv_group(state, *(_chunked(t[:, sl], chunk, H, hd)
                                             for t in (r, k, v)), lw, tm.u)
            dst = y[:, sl].view(B, -1, chunk, H, hd).permute(1, 0, 2, 3, 4)
            dst.copy_(_head_norm(tm, y_g.transpose(-2, -3), cfg.norm_eps))
    out = (y * g) @ tm.wo
    if return_state:
        return out, state
    return out


def rwkv_channel_mix(cm: RWKVChannelMix, x: torch.Tensor,
                     x_prev: torch.Tensor | None = None) -> torch.Tensor:
    """sigmoid(xr @ wr) * (relu(xk @ wk)^2 @ wv), x (B, S, d)."""
    xk, xr = _mixed(cm.mix, x, _token_shift(x, x_prev))
    kk = torch.square(F.relu(xk @ cm.wk))
    return torch.sigmoid(xr @ cm.wr) * (kk @ cm.wv)


# --- decode ------------------------------------------------------------------

def init_rwkv_cache(cfg: ArchConfig, batch: int, dtype, device) -> dict:
    """S (B, H, hd, hd) float32; the time mix's and the channel mix's
    token shifts x_tm, x_cm (B, d) in the model dtype."""
    H, hd = cfg.rwkv_heads, cfg.rwkv_head_dim
    return {"S": torch.zeros(batch, H, hd, hd, dtype=torch.float32, device=device),
            "x_tm": torch.zeros(batch, cfg.d_model, dtype=dtype, device=device),
            "x_cm": torch.zeros(batch, cfg.d_model, dtype=dtype, device=device)}


def axes_rwkv_cache() -> dict:
    return {"S": P("batch", "rwkv_heads", "head_dim", None),
            "x_tm": P("batch", "embed"), "x_cm": P("batch", "embed")}


def rwkv_decode(tm: RWKVTimeMix, cm: RWKVChannelMix, norm1: layers.RMSNorm,
                norm2: layers.RMSNorm, x: torch.Tensor, cache: dict,
                cfg: ArchConfig) -> tuple[torch.Tensor, dict]:
    """The whole RWKV layer for one step, residuals included: x (B, 1, d)
    -> (B, 1, d) and the next cache, whose shifts are the normed inputs."""
    B = x.shape[0]
    H, hd = cfg.rwkv_heads, cfg.rwkv_head_dim
    xin = norm1(x)
    r, k, v, g, lora = _projections(tm, xin, cache["x_tm"])
    rf, kf, vf = (t[:, 0].float().view(B, H, hd) for t in (r, k, v))
    w = torch.exp(-torch.exp(tm.w0 + lora[:, 0].float())).view(B, H, hd)
    S = cache["S"]
    kv = torch.einsum("bhi,bhj->bhij", kf, vf)
    y = torch.einsum("bhi,bhij->bhj", rf, S + tm.u[None, :, :, None] * kv)
    S_new = w[..., None] * S + kv
    y = _head_norm(tm, y.reshape(B, 1, H, hd), cfg.norm_eps)
    y = y.reshape(B, 1, cfg.d_model).to(x.dtype) * g
    x = x + y @ tm.wo
    xin2 = norm2(x)
    x = x + rwkv_channel_mix(cm, xin2, cache["x_cm"])
    return x, {"S": S_new, "x_tm": xin[:, 0], "x_cm": xin2[:, 0]}
