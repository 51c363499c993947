"""jamba-1.5-large-398b [hybrid]: 72L, d_model 8192, 64H (GQA kv=8),
d_ff 24576, vocab 65536, MoE 16 experts top-2 — Mamba+attention 1:7
interleave, MoE every other layer. [arXiv:2403.19887]

Stage = one Jamba block of 8 layers: attention at offset 4, Mamba elsewhere;
MoE MLP on odd offsets (period 2, offset 1). 72 = 9 stages x 8.
long_500k eligible: Mamba state is O(1) in sequence; the 9 attention layers
decode against the full cache at O(S)/token.

The same two configurations as the reference's ``configs/jamba_15_large.py``.
"""
from repro_torch.models.config import ArchConfig, LayerSpec

_MD = LayerSpec(attn="mamba", mlp="dense")
_MM = LayerSpec(attn="mamba", mlp="moe")
_AD = LayerSpec(attn="full", mlp="dense")

CONFIG = ArchConfig(
    name="jamba-1.5-large-398b",
    family="hybrid",
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    d_ff=24576,
    vocab_size=65536,
    stage_pattern=(_MD, _MM, _MD, _MM, _AD, _MM, _MD, _MM),
    num_stages=9,
    num_experts=16,
    top_k=2,
    mamba_d_state=16,
    mamba_expand=2,
    mamba_conv=4,
    sub_quadratic=True,
    source="arXiv:2403.19887",
)

REDUCED = ArchConfig(
    name="jamba-reduced",
    family="hybrid",
    d_model=256,
    num_heads=4,
    num_kv_heads=2,
    head_dim=64,
    d_ff=256,
    vocab_size=512,
    stage_pattern=(_MM, _AD),
    num_stages=1,
    num_experts=4,
    top_k=2,
    capacity_factor=8.0,  # dropless at smoke-test sizes
    mamba_d_state=8,
    sub_quadratic=True,
    dtype="float32",
    source="reduced variant for CPU smoke tests",
)
