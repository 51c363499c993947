"""Model zoo of the port: the attention families, MoE and the hybrid
Mamba + attention stack.

config    — ``ArchConfig``/``LayerSpec`` (own copy of the reference's)
layers    — RMSNorm, RoPE, gated MLP, embedding, LM head
attention — projections, full-sequence attention on K5, decode cache
mamba     — the S6 selective-scan layer (chunked scan, recurrent decode)
moe       — top-k routing with capacity, dispatch, expert products
blocks    — one pre-norm layer: prefill, decode, plain forward
model     — ``BackboneLM``, ``init_params``, ``forward``, ``prefill_step``,
            ``decode_step``, ``init_decode_cache``
"""
from repro_torch.models.config import ArchConfig, LayerSpec
from repro_torch.models import model

__all__ = ["ArchConfig", "LayerSpec", "model"]
