"""rwkv6-1.6b [ssm]: 24L, d_model 2048 (attention-free), d_ff 7168,
vocab 65536 — Finch, data-dependent decay. [arXiv:2404.05892]

Attention-free linear recurrence (per-head hd x hd state) => O(1) decode
state; long_500k eligible. head_dim 64 -> 32 RWKV heads.

The same two configurations as the reference's ``configs/rwkv6_16b.py``.
"""
from repro_torch.models.config import ArchConfig, LayerSpec

_L = LayerSpec(attn="rwkv", mlp="dense")

CONFIG = ArchConfig(
    name="rwkv6-1.6b",
    family="ssm",
    d_model=2048,
    num_heads=32,
    num_kv_heads=32,
    head_dim=64,
    d_ff=7168,
    vocab_size=65536,
    stage_pattern=(_L,),
    num_stages=24,
    rwkv_head_dim=64,
    sub_quadratic=True,
    source="arXiv:2404.05892",
)

REDUCED = ArchConfig(
    name="rwkv6-reduced",
    family="ssm",
    d_model=256,
    num_heads=4,
    num_kv_heads=4,
    head_dim=64,
    d_ff=512,
    vocab_size=512,
    stage_pattern=(_L,),
    num_stages=2,
    rwkv_head_dim=64,
    sub_quadratic=True,
    dtype="float32",
    source="reduced variant for CPU smoke tests",
)
