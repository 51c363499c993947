"""pixtral-12b [vlm]: 40L decoder, d_model 5120, 32H (GQA kv=8), d_ff 14336,
vocab 131072 — pixtral-ViT + mistral-nemo decoder. [hf:mistralai/Pixtral-12B-2409]

The same two configurations as the reference's ``configs/pixtral_12b.py``.
Backbone only: the vision encoder and projector are a stub, so a prefill
takes ``num_prefix`` precomputed patch embeddings (B, 256, d_model) before
the text tokens; decode steps consume tokens.
"""
from repro_torch.models.config import ArchConfig, LayerSpec

_L = LayerSpec(attn="full", mlp="dense")

CONFIG = ArchConfig(
    name="pixtral-12b",
    family="vlm",
    d_model=5120,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=131072,
    stage_pattern=(_L,),
    num_stages=40,
    input_mode="prefix_embeddings",
    num_prefix=256,
    rope_theta=1_000_000.0,
    source="hf:mistralai/Pixtral-12B-2409",
)

REDUCED = ArchConfig(
    name="pixtral-reduced",
    family="vlm",
    d_model=256,
    num_heads=4,
    num_kv_heads=2,
    head_dim=64,
    d_ff=512,
    vocab_size=512,
    stage_pattern=(_L,),
    num_stages=2,
    input_mode="prefix_embeddings",
    num_prefix=8,
    dtype="float32",
    source="reduced variant for CPU smoke tests",
)
