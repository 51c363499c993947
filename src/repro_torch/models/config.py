"""Architecture configuration for the backbone families (a copy of the
reference's ``models/config.py``, field for field).

One ``ArchConfig`` describes any of the reference's architectures (dense
GQA, MoE, hybrid Mamba+attention, RWKV6, audio encoder, VLM decoder). Layers
are organised as ``num_stages`` repetitions of a fixed ``stage_pattern``
(plus a ``tail_pattern`` remainder). The port builds and runs every
layer kind a config uses (``full``/``swa``/``full_bidir``/``mamba`` with a
``dense`` or ``moe`` MLP, in all three input modes, and ``rwkv``), and
the analytic ``param_count`` covers every family. It counts what
``init_params`` builds: an encoder's ungated MLP (2 d d_ff) and an
``embeddings``-mode model's ``mask_embed`` (d, no token embedding), where
the reference's count takes every dense MLP as gated and every model as
embedding tokens (hubert-xlarge: 315,216,640 high).
"""
from __future__ import annotations

import dataclasses
from typing import Literal

AttnKind = Literal["full", "swa", "full_bidir", "mamba", "rwkv", "none"]
MlpKind = Literal["dense", "moe"]


@dataclasses.dataclass(frozen=True)
class LayerSpec:
    """One layer slot inside a stage pattern."""

    attn: AttnKind = "full"
    mlp: MlpKind = "dense"


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: Literal["dense", "moe", "hybrid", "ssm", "audio", "vlm"]
    d_model: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int
    stage_pattern: tuple[LayerSpec, ...]
    num_stages: int
    tail_pattern: tuple[LayerSpec, ...] = ()
    # attention
    qkv_bias: bool = False
    window: int = 4096                  # sliding-window size for 'swa' layers
    rope_theta: float = 10_000.0
    causal: bool = True                 # False for encoder-only (hubert)
    # MoE
    num_experts: int = 0
    top_k: int = 2
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01
    # Mamba (S6)
    mamba_d_state: int = 16
    mamba_expand: int = 2
    mamba_conv: int = 4
    mamba_dt_rank: int = 0              # 0 -> ceil(d_model/16)
    # RWKV6
    rwkv_head_dim: int = 64
    # modality frontend stub
    input_mode: Literal["tokens", "embeddings", "prefix_embeddings"] = "tokens"
    num_prefix: int = 0                 # VLM patch-prefix length
    # serving
    encoder_only: bool = False
    sub_quadratic: bool = False         # eligible for long_500k decode
    # numerics
    dtype: str = "bfloat16"             # activation/param compute dtype
    norm_eps: float = 1e-6
    # reference
    source: str = ""

    @property
    def num_layers(self) -> int:
        return self.num_stages * len(self.stage_pattern) + len(self.tail_pattern)

    @property
    def d_inner(self) -> int:
        return self.mamba_expand * self.d_model

    @property
    def dt_rank(self) -> int:
        return self.mamba_dt_rank or -(-self.d_model // 16)

    @property
    def rwkv_heads(self) -> int:
        return self.d_model // self.rwkv_head_dim

    @property
    def q_dim(self) -> int:
        return self.num_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.num_kv_heads * self.head_dim

    def param_count(self) -> int:
        """Analytic parameter count."""
        return _param_count(self)

    def active_param_count(self) -> int:
        """Active params per token: MoE layers count top_k experts only."""
        return _param_count(self, active_only=True)

    def validate(self) -> None:
        if not (self.d_model > 0 and self.num_stages > 0):
            raise ValueError(f"{self.name}: d_model and num_stages must be > 0")
        if any(l.mlp == "moe" for l in self.stage_pattern + self.tail_pattern) \
                and not self.num_experts >= self.top_k > 0:
            raise ValueError(f"{self.name}: MoE needs num_experts >= top_k > 0")
        if self.encoder_only and self.causal:
            raise ValueError(f"{self.name}: an encoder-only model is not causal")


def _layer_params(cfg: ArchConfig, spec: LayerSpec, active_only: bool) -> int:
    p = 0
    d = cfg.d_model
    if spec.attn in ("full", "swa", "full_bidir"):
        p += d * (cfg.q_dim + 2 * cfg.kv_dim) + cfg.q_dim * d
        if cfg.qkv_bias:
            p += cfg.q_dim + 2 * cfg.kv_dim
        p += d  # attn norm
    elif spec.attn == "mamba":
        di, ds, dtr = cfg.d_inner, cfg.mamba_d_state, cfg.dt_rank
        p += d * 2 * di                 # in_proj (x and gate)
        p += cfg.mamba_conv * di        # depthwise conv
        p += di * (dtr + 2 * ds)        # x -> (dt, B, C)
        p += dtr * di + di              # dt_proj
        p += di * ds + di               # A_log, D
        p += di * d                     # out_proj
        p += d
    elif spec.attn == "rwkv":
        H, hd = cfg.rwkv_heads, cfg.rwkv_head_dim
        p += 5 * d * d                  # r,k,v,g,o projections (time-mix)
        p += 2 * 32 * d + d             # low-rank data-dependent decay (w0,A,B)
        p += 2 * H * hd                 # per-head bonus u + groupnorm scale
        p += 5 * d                      # token-shift mixing coefficients
        p += d                          # norm2 (channel-mix norm)
        p += 2 * d * cfg.d_ff + d * d + 2 * d  # channel mix (wk, wv, wr, mix)
        p += d                          # norm1
        return p
    if spec.mlp == "dense":
        # SwiGLU (gate, up, down), or an encoder's ungated GELU (up, down); + norm
        p += (2 if cfg.encoder_only else 3) * d * cfg.d_ff + d
    elif spec.mlp == "moe":
        e = cfg.top_k if active_only else cfg.num_experts
        p += e * 3 * d * cfg.d_ff + d * cfg.num_experts + d  # experts + router
    return p


def _param_count(cfg: ArchConfig, active_only: bool = False) -> int:
    per_stage = sum(_layer_params(cfg, s, active_only) for s in cfg.stage_pattern)
    tail = sum(_layer_params(cfg, s, active_only) for s in cfg.tail_pattern)
    # token embedding, or an embeddings-mode model's mask_embed alone
    emb = cfg.d_model if cfg.input_mode == "embeddings" else cfg.vocab_size * cfg.d_model
    head = cfg.d_model * cfg.vocab_size
    final_norm = cfg.d_model
    return per_stage * cfg.num_stages + tail + emb + head + final_norm


# ---------------------------------------------------------------------------
# Input shapes (assigned) and their step kinds.
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: Literal["train", "prefill", "decode"]


INPUT_SHAPES: dict[str, InputShape] = {
    "train_4k": InputShape("train_4k", 4_096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32_768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524_288, 1, "decode"),
}


def shape_applicable(cfg: ArchConfig, shape: InputShape) -> tuple[bool, str]:
    """(runs?, reason-if-skipped) — the DESIGN.md §5 skip matrix."""
    if shape.kind == "decode" and cfg.encoder_only:
        return False, "encoder-only architecture has no decode step"
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        return False, "pure full-attention decoder; long_500k needs sub-quadratic attention"
    return True, ""
