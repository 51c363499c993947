"""minitron-8b [dense]: 32L, d_model 4096, 32H (GQA kv=8), d_ff 16384,
vocab 256000 — width-pruned nemotron-4. [arXiv:2407.14679]

The same two configurations as the reference's ``configs/minitron_8b.py``.
"""
from repro_torch.models.config import ArchConfig, LayerSpec

_L = LayerSpec(attn="full", mlp="dense")

CONFIG = ArchConfig(
    name="minitron-8b",
    family="dense",
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=16384,
    vocab_size=256000,
    stage_pattern=(_L,),
    num_stages=32,
    source="arXiv:2407.14679",
)

REDUCED = ArchConfig(
    name="minitron-reduced",
    family="dense",
    d_model=256,
    num_heads=4,
    num_kv_heads=2,
    head_dim=64,
    d_ff=512,
    vocab_size=512,
    stage_pattern=(_L,),
    num_stages=2,
    dtype="float32",
    source="reduced variant for CPU smoke tests",
)
