"""mixtral-8x22b [moe]: 56L, d_model 6144, 48H (GQA kv=8), d_ff 16384,
vocab 32768, MoE 8 experts top-2, sliding-window attention. [arXiv:2401.04088]

long_500k eligible via the 4096-token sliding window on every layer.

The same two configurations as the reference's ``configs/mixtral_8x22b.py``.
"""
from repro_torch.models.config import ArchConfig, LayerSpec

_L = LayerSpec(attn="swa", mlp="moe")

CONFIG = ArchConfig(
    name="mixtral-8x22b",
    family="moe",
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    head_dim=128,
    d_ff=16384,
    vocab_size=32768,
    stage_pattern=(_L,),
    num_stages=56,
    num_experts=8,
    top_k=2,
    window=4096,
    sub_quadratic=True,
    source="arXiv:2401.04088",
)

REDUCED = ArchConfig(
    name="mixtral-reduced",
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
    window=32,
    sub_quadratic=True,
    dtype="float32",
    source="reduced variant for CPU smoke tests",
)
