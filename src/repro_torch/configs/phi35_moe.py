"""phi3.5-moe-42b-a6.6b [moe]: 32L, d_model 4096, 32H (GQA kv=8), d_ff 6400,
vocab 32064, MoE 16 experts top-2. [hf:microsoft/Phi-3.5-MoE-instruct]

The same two configurations as the reference's ``configs/phi35_moe.py``.
"""
from repro_torch.models.config import ArchConfig, LayerSpec

_L = LayerSpec(attn="full", mlp="moe")

CONFIG = ArchConfig(
    name="phi3.5-moe-42b-a6.6b",
    family="moe",
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=6400,
    vocab_size=32064,
    stage_pattern=(_L,),
    num_stages=32,
    num_experts=16,
    top_k=2,
    source="hf:microsoft/Phi-3.5-MoE-instruct",
)

REDUCED = ArchConfig(
    name="phi3.5-moe-reduced",
    family="moe",
    d_model=256,
    num_heads=4,
    num_kv_heads=2,
    head_dim=64,
    d_ff=256,
    vocab_size=512,
    stage_pattern=(_L,),
    num_stages=2,
    num_experts=4,
    top_k=2,
    capacity_factor=8.0,  # dropless at smoke-test sizes
    dtype="float32",
    source="reduced variant for CPU smoke tests",
)
