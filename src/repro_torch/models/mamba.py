"""Mamba (S6) selective state-space layer: jamba's recurrent half.

The counterpart of the reference's ``models/mamba.py``. A full-sequence
pass runs the depthwise causal conv over the whole sequence, then the
state recurrence

    h_t = exp(dt_t * A) . h_{t-1} + dt_t * x_t . B_t,    y_t = h_t . C_t + D x_t

in ``chunk_size`` blocks: within a chunk a log-depth (Hillis-Steele) scan
on the pairs (a, b) = (exp(dt A), dt x B) under the reference's combine
(a1 a2, a2 b1 + b2); across chunks a Python loop carrying h (B, d_inner,
d_state) in float32. The float32 (B, chunk, d_inner, d_state) terms are
made one chunk at a time: at jamba's full width a whole 4096-position
sequence's would take 4.3 GB, a 64-position chunk's 67 MB. The reference
leaves the scan to XLA (``associative_scan`` in a ``lax.scan``); the port
leaves it to PyTorch's elementwise kernels, inside one ``mamba.scan``
``record_function`` range. Decode is the single-step recurrence with a
(conv window, h) cache.

``A_log`` and ``D`` are float32 in every model, as in the reference; the
rest follows the model's dtype, and every cast is the reference's.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn
from torch.profiler import record_function

from repro_torch.launch.sharding import P
from repro_torch.models import layers
from repro_torch.models.config import ArchConfig


def axes_mamba() -> dict:
    return {"in_proj": P("embed", "inner"), "conv_w": P(None, "inner"),
            "x_proj": P("inner", None), "dt_proj": P(None, "inner"),
            "dt_bias": P("inner"), "A_log": P("inner", "state"), "D": P("inner"),
            "out_proj": P("inner", "embed")}


class Mamba(nn.Module):
    """in_proj (d, 2 d_inner), conv_w (K, d_inner), x_proj (d_inner,
    dt_rank + 2 d_state), dt_proj (dt_rank, d_inner), dt_bias (d_inner,),
    A_log (d_inner, d_state) and D (d_inner,) in float32, out_proj
    (d_inner, d): the reference's parameter names, so
    ``convert.model_params_from`` finds them."""

    def __init__(self, cfg: ArchConfig, *, dtype, device):
        super().__init__()
        d, di, ds, dtr = cfg.d_model, cfg.d_inner, cfg.mamba_d_state, cfg.dt_rank
        self.in_proj = layers.weight((d, 2 * di), dtype, device)
        self.conv_w = layers.weight((cfg.mamba_conv, di), dtype, device)
        self.x_proj = layers.weight((di, dtr + 2 * ds), dtype, device)
        self.dt_proj = layers.weight((dtr, di), dtype, device)
        self.dt_bias = layers.weight((di,), dtype, device)
        self.A_log = layers.weight((di, ds), torch.float32, device)
        self.D = layers.weight((di,), torch.float32, device)
        self.out_proj = layers.weight((di, d), dtype, device)

    def reset_parameters(self, generator: torch.Generator) -> None:
        """The reference's distributions: normal x in_dim^-0.5 for the
        projections, normal x 0.2 for the conv, zero dt bias, the S4D-real
        A_log = log(1..d_state) on every channel, D ones."""
        for w in (self.in_proj, self.x_proj, self.dt_proj, self.out_proj):
            layers.dense_init_(w, generator)
        self.conv_w.normal_(generator=generator).mul_(0.2)
        self.dt_bias.zero_()
        ds = self.A_log.shape[1]
        self.A_log.copy_(torch.log(torch.arange(1, ds + 1, dtype=torch.float32)))
        self.D.fill_(1)


def _causal_conv(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv by shifted adds, x (B, S, di), w (K, di): the
    reference's sum, term by term in its order and x's dtype (tap K-1 on
    the current position first)."""
    K, S = w.shape[0], x.shape[1]
    out = x * w[K - 1]
    for j in range(1, min(K, S)):
        out[:, j:] += x[:, :S - j] * w[K - 1 - j]
    return out


def _ssm_inputs(layer: Mamba, x_conv: torch.Tensor, cfg: ArchConfig):
    """(dt float32 (B, S, di), dt x float32 (B, S, di), B float32 (B, S, ds),
    C float32 (B, S, ds)): the discretisation's per-position terms. The
    softplus runs in the model dtype and is cast to float32 after, as in
    the reference."""
    dtr, ds = cfg.dt_rank, cfg.mamba_d_state
    proj = x_conv @ layer.x_proj
    dt_low, Bm, Cm = proj.split([dtr, ds, ds], dim=-1)
    dt = F.softplus(dt_low @ layer.dt_proj + layer.dt_bias).float()
    return dt, dt * x_conv.float(), Bm.float(), Cm.float()


def _scan(a: torch.Tensor, b: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Inclusive scan of (a, b) along dim 1 under (a1, b1) o (a2, b2) =
    (a1 a2, a2 b1 + b2), in ceil(log2 L) Hillis-Steele steps."""
    recording = torch.is_grad_enabled() and (a.requires_grad or b.requires_grad)
    s = 1
    while s < a.shape[1]:
        # out= has no gradient, so a recorded step makes the same products
        # out of place; serving writes them in place, since the
        # concatenation copies every element again (the scan ~2x slower on
        # an H100, PERF.md §6)
        if recording:
            a, b = (torch.cat([a[:, :s], a[:, :-s] * a[:, s:]], dim=1),
                    torch.cat([b[:, :s], torch.addcmul(b[:, s:], a[:, s:], b[:, :-s])],
                              dim=1))
        else:
            na, nb = torch.empty_like(a), torch.empty_like(b)
            na[:, :s], nb[:, :s] = a[:, :s], b[:, :s]
            torch.mul(a[:, :-s], a[:, s:], out=na[:, s:])
            torch.addcmul(b[:, s:], a[:, s:], b[:, :-s], out=nb[:, s:])
            a, b = na, nb
        s *= 2
    return a, b


def _selective_scan(layer: Mamba, dt, dtx, Bm, Cm, chunk: int):
    """y (B, S, di) float32 without the D skip, and the final h."""
    Bsz, S, di = dt.shape
    A = -torch.exp(layer.A_log)                             # (di, ds)
    h = dt.new_zeros(Bsz, di, A.shape[1])
    ys = []
    with record_function("mamba.scan"):
        for c0 in range(0, S, chunk):
            sl = slice(c0, c0 + chunk)
            dA = torch.exp(dt[:, sl, :, None] * A)           # (B, chunk, di, ds)
            dBx = dtx[:, sl, :, None] * Bm[:, sl, None, :]
            a_cum, b_cum = _scan(dA, dBx)
            hs = torch.addcmul(b_cum, a_cum, h[:, None])
            ys.append(torch.einsum("bcds,bcs->bcd", hs, Cm[:, sl]))
            h = hs[:, -1]
    return torch.cat(ys, dim=1), h


def mamba_fwd(layer: Mamba, x: torch.Tensor, cfg: ArchConfig, *,
              chunk_size: int | None = None, return_cache: bool = False):
    """x (B, S, d) -> (B, S, d) [, the decode cache {"conv": the last K - 1
    conv inputs in x's dtype, "h": the final state in float32}]. The chunk
    is ``layers.pick_chunk(S, chunk_size)``."""
    B, S, _ = x.shape
    chunk = layers.pick_chunk(S, chunk_size)
    x_in, z = (x @ layer.in_proj).chunk(2, dim=-1)
    x_conv = F.silu(_causal_conv(x_in, layer.conv_w))
    dt, dtx, Bm, Cm = _ssm_inputs(layer, x_conv, cfg)
    y, h_final = _selective_scan(layer, dt, dtx, Bm, Cm, chunk)
    y = y + layer.D * x_conv.float()
    out = (y.to(x.dtype) * F.silu(z)) @ layer.out_proj
    if return_cache:
        K = cfg.mamba_conv
        # the reference's slice: shorter than K - 1 when S < K - 1
        return out, {"conv": x_in[:, S - (K - 1):].contiguous(), "h": h_final}
    return out


# --- decode ------------------------------------------------------------------

def init_mamba_cache(cfg: ArchConfig, batch: int, dtype, device) -> dict:
    return {"conv": torch.zeros(batch, cfg.mamba_conv - 1, cfg.d_inner,
                                dtype=dtype, device=device),
            "h": torch.zeros(batch, cfg.d_inner, cfg.mamba_d_state,
                             dtype=torch.float32, device=device)}


def axes_mamba_cache() -> dict:
    return {"conv": P("batch", None, "inner"), "h": P("batch", "inner", "state")}


def check_cache(cache: dict, cfg: ArchConfig) -> None:
    """Raise ValueError unless the conv window holds K - 1 positions. A
    prefill of fewer than K - 1 tokens leaves a shorter one (the
    reference's slice), with which the reference's decode fails in its
    einsum."""
    have, K = cache["conv"].shape[1], cfg.mamba_conv
    if have != K - 1:
        raise ValueError(f"the Mamba conv cache holds {have} positions, decode needs "
                         f"{K - 1}: a prefill shorter than mamba_conv - 1 = {K - 1} "
                         f"tokens cannot be decoded from")


def mamba_decode(layer: Mamba, x: torch.Tensor, cache: dict, cfg: ArchConfig
                 ) -> tuple[torch.Tensor, dict]:
    """One step: x (B, 1, d) -> (B, 1, d) and the next cache. The conv is
    the window's dot with the taps, products exact and summed in float32,
    rounded once to x's dtype (a dot, as the reference's einsum)."""
    check_cache(cache, cfg)
    x_in, z = (x @ layer.in_proj).chunk(2, dim=-1)          # (B, 1, di)
    window = torch.cat([cache["conv"], x_in], dim=1)        # (B, K, di)
    x_c = (window.float() * layer.conv_w.float()).sum(1).to(x.dtype)
    x_conv = F.silu(x_c)[:, None]
    dt, dtx, Bm, Cm = _ssm_inputs(layer, x_conv, cfg)       # (B, 1, ...)
    A = -torch.exp(layer.A_log)
    dA = torch.exp(dt[:, 0, :, None] * A)
    h = dA * cache["h"] + dtx[:, 0, :, None] * Bm[:, 0, None, :]
    y = torch.einsum("bds,bs->bd", h, Cm[:, 0])[:, None]
    y = y + layer.D * x_conv.float()
    out = (y.to(x.dtype) * F.silu(z)) @ layer.out_proj
    return out, {"conv": window[:, 1:], "h": h}
