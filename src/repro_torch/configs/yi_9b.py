"""yi-9b [dense]: 48L, d_model 4096, 32H (GQA kv=4), d_ff 11008,
vocab 64000 — llama-architecture GQA. [arXiv:2403.04652]

The same two configurations as the reference's ``configs/yi_9b.py``.
"""
from repro_torch.models.config import ArchConfig, LayerSpec

_L = LayerSpec(attn="full", mlp="dense")

CONFIG = ArchConfig(
    name="yi-9b",
    family="dense",
    d_model=4096,
    num_heads=32,
    num_kv_heads=4,
    head_dim=128,
    d_ff=11008,
    vocab_size=64000,
    stage_pattern=(_L,),
    num_stages=48,
    source="arXiv:2403.04652",
)

REDUCED = ArchConfig(
    name="yi-9b-reduced",
    family="dense",
    d_model=256,
    num_heads=4,
    num_kv_heads=1,
    head_dim=64,
    d_ff=512,
    vocab_size=512,
    stage_pattern=(_L,),
    num_stages=2,
    dtype="float32",
    source="reduced variant for CPU smoke tests",
)
