"""qwen2-72b [dense]: 80L, d_model 8192, 64H (GQA kv=8), d_ff 29568,
vocab 152064 — GQA with QKV bias. [arXiv:2407.10671]

The same two configurations as the reference's ``configs/qwen2_72b.py``.
"""
from repro_torch.models.config import ArchConfig, LayerSpec

_L = LayerSpec(attn="full", mlp="dense")

CONFIG = ArchConfig(
    name="qwen2-72b",
    family="dense",
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    d_ff=29568,
    vocab_size=152064,
    stage_pattern=(_L,),
    num_stages=80,
    qkv_bias=True,
    rope_theta=1_000_000.0,
    source="arXiv:2407.10671",
)

REDUCED = ArchConfig(
    name="qwen2-72b-reduced",
    family="dense",
    d_model=256,
    num_heads=4,
    num_kv_heads=2,
    head_dim=64,
    d_ff=512,
    vocab_size=512,
    stage_pattern=(_L,),
    num_stages=2,
    qkv_bias=True,
    dtype="float32",
    source="reduced variant for CPU smoke tests",
)
