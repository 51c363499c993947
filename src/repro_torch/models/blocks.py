"""Per-layer blocks: a pre-norm mixer (attention or Mamba) + a pre-norm MLP
or MoE, with residuals; or an RWKV6 layer, which owns its channel mix.

The counterparts of the reference's ``models/blocks.py`` for the mixer
kinds ``full``/``swa``/``full_bidir`` (attention) and ``mamba`` (the S6
layer of ``models/mamba.py``) with a ``dense`` or ``moe`` MLP, and ``rwkv``
(``models/rwkv6.py``: norm1 -> time mix -> residual, norm2 -> channel mix
-> residual, no MLP or MoE, whatever the spec's ``mlp``). The dense
MLP is SwiGLU, or ungated GELU in an encoder-only model (hubert), as the
reference's is. An MoE layer runs the capacity-bounded ``moe.moe_block`` in
prefill and in decode (at T = B), as the reference's does. A Mamba or RWKV
layer's full-sequence pass runs in chunks of ``SEQ_CHUNK`` positions, the
chunk the reference's ``serve`` prefills with (the reference's forward
defaults to one chunk, which overflows RWKV's log-decay past ~88: see
``models/rwkv6.py``); the decode cache is the recurrent state: the (conv
window, h) pair of a Mamba layer, (S, x_tm, x_cm) of an RWKV layer.
``full_bidir`` layers have no cache: prefill and decode raise, as the
reference's do. Where the reference stacks stages along a leading axis and
scans over it, the port keeps a list of per-stage module lists and loops
in Python; the sharding axes (``axes_stacked_stages``) keep the
reference's stacked layout, a leading ``"stack"`` axis on every leaf.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.launch.sharding import P, map_specs
from repro_torch.models import attention, layers, mamba, moe, rwkv6
from repro_torch.models.config import ArchConfig, LayerSpec

ATTN_KINDS = ("full", "swa", "full_bidir")
CACHED_ATTN = ("full", "swa")
MIXER_KINDS = ATTN_KINDS + ("mamba", "rwkv")
SEQ_CHUNK = 64          # the reference serve's prefill chunk (launch/serve.py)


def _check_spec(cfg: ArchConfig, spec: LayerSpec) -> None:
    if spec.attn not in MIXER_KINDS or spec.mlp not in ("dense", "moe"):
        raise NotImplementedError(
            f"layer {spec} of {cfg.name} has no port; the port has mixer kinds "
            f"{MIXER_KINDS} with a dense MLP or an MoE")


def axes_layer(cfg: ArchConfig, spec: LayerSpec) -> dict:
    """The logical axes of one layer's parameters, by the reference's keys."""
    a: dict = {"norm1": layers.axes_rmsnorm(), "norm2": layers.axes_rmsnorm()}
    if spec.attn in ATTN_KINDS:
        a["attn"] = attention.axes_attention(cfg)
    elif spec.attn == "mamba":
        a["mamba"] = mamba.axes_mamba()
    elif spec.attn == "rwkv":
        a["rwkv_tm"] = rwkv6.axes_rwkv()
        a["rwkv_cm"] = rwkv6.axes_channel_mix()
        return a
    if spec.mlp == "dense":
        a["mlp"] = layers.axes_mlp(gated=not cfg.encoder_only)
    elif spec.mlp == "moe":
        a["moe"] = moe.axes_moe()
    return a


def axes_layer_cache(spec: LayerSpec) -> dict:
    if spec.attn in CACHED_ATTN:
        return attention.axes_cache()
    if spec.attn == "mamba":
        return mamba.axes_mamba_cache()
    if spec.attn == "rwkv":
        return rwkv6.axes_rwkv_cache()
    raise ValueError(spec.attn)


def stacked(axes):
    """``axes`` with a leading ``"stack"`` axis on every spec: the layout of
    the reference's stages, stacked along a leading ``num_stages`` axis."""
    return map_specs(lambda spec: P("stack", *spec), axes)


def axes_stacked_stages(cfg: ArchConfig) -> tuple:
    return tuple(stacked(axes_layer(cfg, s)) for s in cfg.stage_pattern)


class Layer(nn.Module):
    """norm1 -> attention (``attn``) or Mamba (``mamba``) -> residual,
    norm2 -> MLP (``mlp``) or MoE (``moe``) -> residual; or norm1 -> RWKV
    time mix (``rwkv_tm``) -> residual, norm2 -> its channel mix
    (``rwkv_cm``) -> residual."""

    def __init__(self, cfg: ArchConfig, spec: LayerSpec, *, dtype, device):
        super().__init__()
        _check_spec(cfg, spec)
        self.spec = spec
        self.norm1 = layers.RMSNorm(cfg.d_model, cfg.norm_eps, dtype=dtype, device=device)
        self.norm2 = layers.RMSNorm(cfg.d_model, cfg.norm_eps, dtype=dtype, device=device)
        if spec.attn == "rwkv":
            self.rwkv_tm = rwkv6.RWKVTimeMix(cfg, dtype=dtype, device=device)
            self.rwkv_cm = rwkv6.RWKVChannelMix(cfg, dtype=dtype, device=device)
            return
        if spec.attn == "mamba":
            self.mamba = mamba.Mamba(cfg, dtype=dtype, device=device)
        else:
            self.attn = attention.Attention(cfg, dtype=dtype, device=device)
        if spec.mlp == "moe":
            self.moe = moe.MoE(cfg, dtype=dtype, device=device)
        else:
            self.mlp = layers.MLP(cfg.d_model, cfg.d_ff, dtype=dtype, device=device,
                                  gated=not cfg.encoder_only)

    def reset_parameters(self, generator: torch.Generator) -> None:
        self.norm1.reset_parameters()
        self.norm2.reset_parameters()
        if self.spec.attn == "rwkv":
            self.rwkv_tm.reset_parameters(generator)
            self.rwkv_cm.reset_parameters(generator)
            return
        (self.mamba if self.spec.attn == "mamba" else self.attn).reset_parameters(generator)
        (self.moe if self.spec.mlp == "moe" else self.mlp).reset_parameters(generator)

    def feed_forward(self, x: torch.Tensor, cfg: ArchConfig,
                     collect_aux: list | None = None) -> torch.Tensor:
        """norm2 -> MLP or MoE, without the residual; an MoE appends its
        load-balance aux loss to ``collect_aux`` when one is given."""
        if self.spec.mlp == "moe":
            if collect_aux is None:
                return moe.moe_block(self.moe, self.norm2(x), cfg)
            y, aux = moe.moe_block(self.moe, self.norm2(x), cfg, return_aux=True)
            collect_aux.append(aux)
            return y
        return self.mlp(self.norm2(x))


def apply_layer(layer: Layer, x: torch.Tensor, cfg: ArchConfig, *,
                collect_aux: list | None = None) -> torch.Tensor:
    """One layer's full-sequence pass; an MoE layer appends its aux loss to
    ``collect_aux`` when one is given (the reference's ``apply_layer``)."""
    if layer.spec.attn == "rwkv":
        x = x + rwkv6.rwkv_time_mix(layer.rwkv_tm, layer.norm1(x), cfg,
                                    chunk_size=SEQ_CHUNK)
        return x + rwkv6.rwkv_channel_mix(layer.rwkv_cm, layer.norm2(x))
    if layer.spec.attn == "mamba":
        x = x + mamba.mamba_fwd(layer.mamba, layer.norm1(x), cfg, chunk_size=SEQ_CHUNK)
    else:
        x = x + attention.attention_fwd(layer.attn, layer.norm1(x), cfg,
                                        kind=layer.spec.attn)
    return x + layer.feed_forward(x, cfg, collect_aux)


def init_layer_cache(cfg: ArchConfig, spec: LayerSpec, batch: int,
                     seq_len: int, dtype, device) -> dict:
    if spec.attn in CACHED_ATTN:
        return attention.init_cache(cfg, spec.attn, batch, seq_len, dtype, device)
    if spec.attn == "mamba":
        return mamba.init_mamba_cache(cfg, batch, dtype, device)
    if spec.attn == "rwkv":
        return rwkv6.init_rwkv_cache(cfg, batch, dtype, device)
    raise ValueError(f"no decode cache for attn kind {spec.attn!r}")


def decode_layer(layer: Layer, x: torch.Tensor, cache: dict, pos: int,
                 cfg: ArchConfig) -> tuple[torch.Tensor, dict]:
    kind = layer.spec.attn
    if kind == "rwkv":
        return rwkv6.rwkv_decode(layer.rwkv_tm, layer.rwkv_cm, layer.norm1,
                                 layer.norm2, x, cache, cfg)
    if kind == "mamba":
        h, cache = mamba.mamba_decode(layer.mamba, layer.norm1(x), cache, cfg)
    elif kind in CACHED_ATTN:
        h, cache = attention.attention_decode(layer.attn, layer.norm1(x), cache,
                                              pos, cfg, kind=kind)
    else:
        raise ValueError(f"decode unsupported for attn kind {kind!r}")
    x = x + h
    return x + layer.feed_forward(x, cfg), cache


def prefill_layer(layer: Layer, x: torch.Tensor, cfg: ArchConfig, *,
                  max_len: int | None = None) -> tuple[torch.Tensor, dict]:
    """Full-sequence forward that also emits the decode cache for this layer."""
    kind = layer.spec.attn
    if kind == "rwkv":
        xin = layer.norm1(x)
        h, S = rwkv6.rwkv_time_mix(layer.rwkv_tm, xin, cfg, chunk_size=SEQ_CHUNK,
                                   return_state=True)
        x = x + h
        xin2 = layer.norm2(x)
        x = x + rwkv6.rwkv_channel_mix(layer.rwkv_cm, xin2)
        # copies: a view of the last position would hold the whole input
        return x, {"S": S, "x_tm": xin[:, -1].clone(), "x_cm": xin2[:, -1].clone()}
    if kind == "mamba":
        h, cache = mamba.mamba_fwd(layer.mamba, layer.norm1(x), cfg,
                                   chunk_size=SEQ_CHUNK, return_cache=True)
    elif kind in CACHED_ATTN:
        h, cache = attention.prefill_cache(layer.attn, layer.norm1(x), cfg,
                                           kind=kind, max_len=max_len)
    else:
        raise ValueError(f"prefill unsupported for attn kind {kind!r}")
    x = x + h
    return x + layer.feed_forward(x, cfg), cache
