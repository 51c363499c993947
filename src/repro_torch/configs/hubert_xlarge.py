"""hubert-xlarge [audio]: 48L encoder-only, d_model 1280, 16H (kv=16 — MHA),
d_ff 5120, vocab 504 (cluster units). [arXiv:2106.07447]

The same two configurations as the reference's ``configs/hubert_xlarge.py``.
Backbone only: the convolutional feature extractor is a stub, so the model
takes precomputed frame embeddings (B, S, d_model) and returns unit logits
(``models.model.encode_step``). Its attention is bidirectional
(``full_bidir``, non-causal) at head_dim 80, its MLP ungated GELU, and it
has no decode step.
"""
from repro_torch.models.config import ArchConfig, LayerSpec

_L = LayerSpec(attn="full_bidir", mlp="dense")

CONFIG = ArchConfig(
    name="hubert-xlarge",
    family="audio",
    d_model=1280,
    num_heads=16,
    num_kv_heads=16,
    head_dim=80,
    d_ff=5120,
    vocab_size=504,
    stage_pattern=(_L,),
    num_stages=48,
    causal=False,
    encoder_only=True,
    input_mode="embeddings",
    source="arXiv:2106.07447",
)

REDUCED = ArchConfig(
    name="hubert-reduced",
    family="audio",
    d_model=256,
    num_heads=4,
    num_kv_heads=4,
    head_dim=64,
    d_ff=512,
    vocab_size=64,
    stage_pattern=(_L,),
    num_stages=2,
    causal=False,
    encoder_only=True,
    input_mode="embeddings",
    dtype="float32",
    source="reduced variant for CPU smoke tests",
)
