"""gemma3-27b [dense]: 62L, d_model 5376, 32H (GQA kv=16), d_ff 21504,
vocab 262144 — 5:1 local:global interleave, 128k context.
[hf:google/gemma-3-1b-pt (family card; 27B scaling per tech report)]

Local layers are 1024-token sliding-window attention; every 6th layer is
global full attention. 62 = 10 stages x (5 swa + 1 full) + 2 swa tail.
The same two configurations as the reference's ``configs/gemma3_27b.py``.
"""
from repro_torch.models.config import ArchConfig, LayerSpec

_SWA = LayerSpec(attn="swa", mlp="dense")
_FULL = LayerSpec(attn="full", mlp="dense")

CONFIG = ArchConfig(
    name="gemma3-27b",
    family="dense",
    d_model=5376,
    num_heads=32,
    num_kv_heads=16,
    head_dim=128,
    d_ff=21504,
    vocab_size=262144,
    stage_pattern=(_SWA, _SWA, _SWA, _SWA, _SWA, _FULL),
    num_stages=10,
    tail_pattern=(_SWA, _SWA),
    window=1024,
    rope_theta=1_000_000.0,
    sub_quadratic=True,
    source="hf:google/gemma-3-1b-pt",
)

REDUCED = ArchConfig(
    name="gemma3-27b-reduced",
    family="dense",
    d_model=256,
    num_heads=4,
    num_kv_heads=2,
    head_dim=64,
    d_ff=512,
    vocab_size=512,
    stage_pattern=(_SWA, _FULL),
    num_stages=1,
    window=32,
    sub_quadratic=True,
    dtype="float32",
    source="reduced variant for CPU smoke tests",
)
