"""BackboneLM: top-level model assembly and the serving step functions.

The counterparts of the reference's ``models/model.py`` for its three
input modes:

  tokens            — decoder LMs: ``batch["tokens"]`` (B, S);
  embeddings        — the audio encoder (hubert): precomputed frame
                      embeddings ``batch["embeddings"]`` (B, S, d), frames
                      where the optional boolean ``batch["mask"]`` (B, S) is
                      set replaced by the learned ``mask_embed``;
  prefix_embeddings — the VLM (pixtral): ``batch["patches"]`` (B, P, d)
                      before the embedded ``batch["tokens"]``.

its logical sharding axes (the reference's layout, stages stacked under a
leading ``"stack"`` axis):

  param_axes / cache_axes — the trees of the reference's ``param_axes`` /
                     ``cache_axes``; ``param_axes_by_name`` the spec of each
                     of ``BackboneLM.named_parameters()`` (no ``"stack"``);

and its serving and training steps:

  init_params      — a ``BackboneLM`` with the reference's initial
                     distributions, drawn from a ``torch.Generator``;
  forward          — full-sequence logits (and the MoE aux loss), each
                     stage recomputed in the backward under ``remat``;
  loss_fn          — next-token CE, hubert's masked-unit CE or a VLM's CE
                     past its prefix, plus the weighted MoE aux loss;
  make_train_step  — gradients (accumulated over microbatches), then
                     AdamW with float32 master weights (``optim.adamw``);
  prefill_step     — full-sequence forward returning last-position logits
                     and the decode cache (a VLM's prefix included);
  decode_step      — one token against the cache (full layers: the whole
                     sequence; SWA layers: a ring buffer); tokens only;
  encode_step      — an encoder's full-sequence logits (no cache, no decode).

The module carries its config, so the functions take the model where the
reference takes ``(params, cfg)``. Layers are attention or Mamba
(``models/mamba.py``) with a dense MLP (SwiGLU; ungated GELU in an encoder)
or an MoE (``models/moe.py``, capacity-bounded in prefill and decode
alike), or RWKV6 (``models/rwkv6.py``, time mix and channel mix). Every
attention layer's full-sequence pass runs kernel K5 on CUDA tensors,
causal or not; a Mamba or RWKV layer's runs PyTorch's kernels. The cache
is a dict ``{"layers": [one cache per layer, in execution order], "pos":
int}``: an attention layer's is its keys and values, a Mamba or RWKV
layer's a recurrent state (the conv window and h; S and the two token
shifts). ``decode_step`` updates it in place and returns it.

Parameters do not require gradients: serving builds no graph. A training
step turns them on for its own use and off again; K5 stays the attention's
forward there, and its backward is ``kernels.ref.swa_attention_bwd``
(``kernels.ops.swa_attention``).
"""
from __future__ import annotations

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.launch.sharding import P
from repro_torch.models import attention, blocks, layers, mamba
from repro_torch.models.config import ArchConfig
from repro_torch.optim import adamw


class BackboneLM(nn.Module):
    """Input embeddings -> ``num_stages`` x ``stage_pattern`` ->
    ``tail_pattern`` -> final RMSNorm -> LM head. Parameters are allocated, not initialised:
    :func:`init_params` draws them, ``convert.model_params_from`` copies
    them from a reference parameter tree."""

    def __init__(self, cfg: ArchConfig, *, device="cuda"):
        super().__init__()
        self.cfg = cfg
        dt = layers.dtype_of(cfg.dtype)
        if cfg.input_mode == "embeddings":
            self.mask_embed = layers.weight((cfg.d_model,), dt, device)
        else:
            self.embed = layers.Embedding(cfg.vocab_size, cfg.d_model, dtype=dt,
                                          device=device)
        self.stages = nn.ModuleList(
            nn.ModuleList(blocks.Layer(cfg, spec, dtype=dt, device=device)
                          for spec in cfg.stage_pattern)
            for _ in range(cfg.num_stages))
        self.tail = nn.ModuleList(blocks.Layer(cfg, spec, dtype=dt, device=device)
                                  for spec in cfg.tail_pattern)
        self.final_norm = layers.RMSNorm(cfg.d_model, cfg.norm_eps, dtype=dt, device=device)
        self.head = layers.LMHead(cfg.d_model, cfg.vocab_size, dtype=dt, device=device)

    def all_layers(self) -> list[blocks.Layer]:
        """Every layer in execution order: the stages, then the tail."""
        return [layer for stage in self.stages for layer in stage] + list(self.tail)


def param_axes(cfg: ArchConfig) -> dict:
    """The logical axes of the reference's parameter tree for ``cfg``."""
    a: dict = {"stages": blocks.axes_stacked_stages(cfg),
               "final_norm": layers.axes_rmsnorm(), "head": layers.axes_lm_head()}
    if cfg.tail_pattern:
        a["tail"] = tuple(blocks.axes_layer(cfg, s) for s in cfg.tail_pattern)
    if cfg.input_mode in ("tokens", "prefix_embeddings"):
        a["embed"] = layers.axes_embedding()
    if cfg.input_mode == "embeddings":
        a["mask_embed"] = P("embed")
    return a


def param_axes_by_name(cfg: ArchConfig) -> dict[str, P]:
    """The spec of each of ``BackboneLM(cfg).named_parameters()``, by name:
    a stage's parameter its position's spec without ``"stack"``."""
    out: dict[str, P] = {}

    def put(prefix: str, node) -> None:
        if isinstance(node, P):
            out[prefix] = node
        else:
            for key, child in node.items():
                put(f"{prefix}.{key}", child)

    if cfg.input_mode == "embeddings":
        out["mask_embed"] = P("embed")
    else:
        put("embed", layers.axes_embedding())
    for s in range(cfg.num_stages):
        for i, spec in enumerate(cfg.stage_pattern):
            put(f"stages.{s}.{i}", blocks.axes_layer(cfg, spec))
    for i, spec in enumerate(cfg.tail_pattern):
        put(f"tail.{i}", blocks.axes_layer(cfg, spec))
    put("final_norm", layers.axes_rmsnorm())
    put("head", layers.axes_lm_head())
    return out


def cache_axes(cfg: ArchConfig) -> dict:
    """The logical axes of the reference's decode cache for ``cfg``: its
    stages stacked, ``pos`` a replicated scalar."""
    a: dict = {"stages": tuple(blocks.stacked(blocks.axes_layer_cache(s))
                               for s in cfg.stage_pattern), "pos": P()}
    if cfg.tail_pattern:
        a["tail"] = tuple(blocks.axes_layer_cache(s) for s in cfg.tail_pattern)
    return a


def stacked_tree(cfg: ArchConfig, named: dict, stack) -> dict:
    """The reference's nested parameter layout of ``named`` (any values
    keyed by ``BackboneLM(cfg)``'s parameter names, in its order):
    ``"stages"`` a tuple with one dict per stage-pattern position whose
    leaves are ``stack`` of that leaf's per-stage values (a leading
    ``num_stages`` axis), ``"tail"`` a tuple of per-layer dicts, the rest
    by name."""
    tree: dict = {}
    stacks = [{} for _ in cfg.stage_pattern]   # position -> key path -> [per stage]
    tail = [{} for _ in cfg.tail_pattern]

    def put(node: dict, keys, leaf) -> None:
        for key in keys[:-1]:
            node = node.setdefault(key, {})
        node[keys[-1]] = leaf

    for name, value in named.items():
        parts = name.split(".")
        if parts[0] == "stages":
            stacks[int(parts[2])].setdefault(tuple(parts[3:]), []).append(value)
        elif parts[0] == "tail":
            put(tail[int(parts[1])], parts[2:], value)
        else:
            put(tree, parts, value)
    stages = []
    for per_path in stacks:
        node: dict = {}
        for keys, values in per_path.items():
            put(node, keys, stack(values))
        stages.append(node)
    tree["stages"] = tuple(stages)
    if cfg.tail_pattern:
        tree["tail"] = tuple(tail)
    return tree


def init_params(cfg: ArchConfig, *, generator: torch.Generator,
                device="cuda") -> BackboneLM:
    """A model with the reference's initial distributions, drawn on
    ``device`` from ``generator`` (which must live on that device)."""
    model = BackboneLM(cfg, device=device)
    for layer in model.all_layers():
        layer.reset_parameters(generator)
    if cfg.input_mode == "embeddings":
        model.mask_embed.normal_(generator=generator).mul_(0.02)
    else:
        model.embed.reset_parameters(generator)
    model.final_norm.reset_parameters()
    model.head.reset_parameters(generator)
    return model


def _input_embeddings(model: BackboneLM, batch: dict) -> torch.Tensor:
    """The (B, S, d) input of the first layer, in the model's dtype, for
    the config's input mode (the module docstring's batch keys)."""
    cfg = model.cfg
    if cfg.input_mode == "tokens":
        return model.embed(batch["tokens"])
    dt = layers.dtype_of(cfg.dtype)
    if cfg.input_mode == "embeddings":
        x = batch["embeddings"].to(dt)
        if "mask" in batch:
            x = torch.where(batch["mask"][..., None], model.mask_embed, x)
        return x
    if cfg.input_mode == "prefix_embeddings":
        return torch.cat([batch["patches"].to(dt), model.embed(batch["tokens"])], dim=1)
    raise ValueError(cfg.input_mode)


def _stage_body(stage: nn.ModuleList, x: torch.Tensor, cfg: ArchConfig,
                with_aux: bool):
    """One stage's layers -> (x, the stage's summed aux loss in float32, or
    None without ``with_aux``)."""
    aux = [] if with_aux else None
    for layer in stage:
        x = blocks.apply_layer(layer, x, cfg, collect_aux=aux)
    if not with_aux:
        return x, None
    return x, sum(aux) if aux else x.new_zeros((), dtype=torch.float32)


def forward(model: BackboneLM, batch: dict, *, remat: bool = False,
            with_aux: bool = False):
    """Full-sequence logits (B, S, vocab); S counts a VLM's prefix. With
    ``with_aux``, (logits, the MoE layers' summed aux loss in float32).
    ``remat`` recomputes each stage in the backward instead of keeping its
    activations (``torch.utils.checkpoint``, as the reference's
    ``jax.checkpoint`` of its stage body), so each attention layer runs its
    forward twice a training step."""
    cfg = model.cfg
    x = _input_embeddings(model, batch)
    stage_aux = []
    for stage in model.stages:
        if remat:
            x, aux = checkpoint(_stage_body, stage, x, cfg, with_aux, use_reentrant=False)
        else:
            x, aux = _stage_body(stage, x, cfg, with_aux)
        stage_aux.append(aux)
    tail_aux = [] if with_aux else None
    for layer in model.tail:
        x = blocks.apply_layer(layer, x, cfg, collect_aux=tail_aux)
    logits = model.head(model.final_norm(x))
    if not with_aux:
        return logits
    aux_total = torch.stack(stage_aux).sum() if stage_aux \
        else x.new_zeros((), dtype=torch.float32)
    for aux in tail_aux:
        aux_total = aux_total + aux
    return logits, aux_total


def loss_fn(model: BackboneLM, batch: dict, *, remat: bool = True) -> torch.Tensor:
    """The training loss (float32 scalar) plus ``router_aux_weight`` times
    the MoE aux loss: next-token CE on ``batch["labels"]``; for an encoder
    (``embeddings``) the CE at the frames ``batch["mask"]`` sets, averaged
    over them; for a VLM the CE of the text positions after its prefix."""
    cfg = model.cfg
    logits, aux = forward(model, batch, remat=remat, with_aux=True)
    if cfg.input_mode == "embeddings":
        loss = layers.cross_entropy(logits, batch["labels"], batch["mask"])
    elif cfg.input_mode == "prefix_embeddings":
        loss = layers.cross_entropy(logits[:, cfg.num_prefix:], batch["labels"])
    else:
        loss = layers.cross_entropy(logits, batch["labels"])
    return loss + cfg.router_aux_weight * aux


def make_train_step(cfg: ArchConfig, opt_cfg: adamw.AdamWConfig, *,
                    remat: bool = True, microbatches: int = 1):
    """``train_step(model, opt_state, batch) -> loss`` (a float32 scalar on
    the model's device, not synchronised).

    The step turns ``requires_grad`` on for the model's parameters, takes
    the gradients of :func:`loss_fn` and turns it off again, so a served
    model never builds a graph. With ``microbatches`` > 1 the batch splits
    along its leading axis and the gradients accumulate in the parameters'
    dtype (``.grad``), as the reference's scan adds them; then they are
    scaled by 1 / microbatches in that dtype and the loss is the mean.
    AdamW (``optim.adamw.apply``) then updates the state and the
    parameters in place.
    """
    if microbatches < 1:
        raise ValueError(f"microbatches must be >= 1, got {microbatches}")

    def train_step(model: BackboneLM, opt_state: dict, batch: dict) -> torch.Tensor:
        named = list(model.named_parameters())
        for _, p in named:
            p.grad = None
            p.requires_grad_(True)
        try:
            if microbatches == 1:
                loss = loss_fn(model, batch, remat=remat)
                loss.backward()
                loss = loss.detach()
            else:
                split = {k: t.reshape(microbatches, t.shape[0] // microbatches,
                                      *t.shape[1:]) for k, t in batch.items()}
                loss = torch.zeros((), dtype=torch.float32, device=named[0][1].device)
                for i in range(microbatches):
                    loss_i = loss_fn(model, {k: t[i] for k, t in split.items()},
                                     remat=remat)
                    loss_i.backward()
                    loss = loss + loss_i.detach()
                inv = 1.0 / microbatches
                loss = loss * inv
                for _, p in named:
                    if p.grad is not None:
                        p.grad.mul_(inv)
        finally:
            for _, p in named:
                p.requires_grad_(False)
        # a parameter the loss does not reach (a mask_embed without a mask)
        # has no .grad; its gradient is zero, as JAX's is
        grads = {n: torch.zeros_like(p) if p.grad is None else p.grad for n, p in named}
        for _, p in named:
            p.grad = None
        adamw.apply(model, grads, opt_state, opt_cfg)
        return loss

    return train_step


def init_decode_cache(cfg: ArchConfig, batch: int, seq_len: int, *,
                      device="cuda") -> dict:
    """An empty cache for ``seq_len`` positions, at position 0."""
    dt = layers.dtype_of(cfg.dtype)
    specs = list(cfg.stage_pattern) * cfg.num_stages + list(cfg.tail_pattern)
    return {"layers": [blocks.init_layer_cache(cfg, s, batch, seq_len, dt, device)
                       for s in specs], "pos": 0}


def prefill_step(model: BackboneLM, batch: dict, *,
                 max_len: int | None = None) -> tuple[torch.Tensor, dict]:
    """Full-sequence prefill -> (last-position logits (B, 1, vocab), cache
    for ``max_len`` positions, default the input's length: a VLM's prefix
    and its tokens, which is also the cache's ``pos``)."""
    x = _input_embeddings(model, batch)
    caches = []
    for layer in model.all_layers():
        x, c = blocks.prefill_layer(layer, x, model.cfg, max_len=max_len)
        caches.append(c)
    logits = model.head(model.final_norm(x[:, -1:]))
    return logits, {"layers": caches, "pos": x.shape[1]}


def decode_step(model: BackboneLM, cache: dict, batch: dict
                ) -> tuple[torch.Tensor, dict]:
    """One-token serve step. batch = {"tokens": (B, 1)}; returns logits
    (B, 1, vocab) and the cache, updated in place and advanced by one.
    A position past a full layer's cache, or a Mamba layer's conv window
    short of K - 1 positions (a prefill shorter than that), raises
    ValueError before any layer's cache is written; an RWKV layer's state
    has no bound."""
    pos = cache["pos"]
    for layer, c in zip(model.all_layers(), cache["layers"]):
        if layer.spec.attn == "mamba":
            mamba.check_cache(c, model.cfg)
        elif layer.spec.attn != "rwkv":       # an RWKV state has no length
            attention.decode_slot(layer.spec.attn, pos, c["k"].shape[1])
    x = model.embed(batch["tokens"])
    for i, layer in enumerate(model.all_layers()):
        x, cache["layers"][i] = blocks.decode_layer(layer, x, cache["layers"][i],
                                                    pos, model.cfg)
    cache["pos"] = pos + 1
    return model.head(model.final_norm(x)), cache


def encode_step(model: BackboneLM, batch: dict) -> torch.Tensor:
    """An encoder-only model's (hubert's) full-sequence unit logits (B, S,
    vocab): ``forward`` on ``{"embeddings", "mask"?}``."""
    return forward(model, batch)
