"""AdamW with float32 master weights (mixed-precision training).

The counterpart of the reference's ``optim/adamw.py``. The model's
parameters live in its compute dtype (bf16 at full size); the optimizer
keeps a float32 master copy and float32 first and second moments, each a
dict keyed by the model's parameter names (``named_parameters``), plus the
step ``count`` (an int32 scalar on the parameters' device). ``apply``
consumes the gradients, updates master, m and v in place and copies the
master into the module's parameters (a cast to bf16 rounds to nearest
even, as ``astype`` does).

The arithmetic is the reference's, term by term and in its order, with its
float32 scalars: ``lr``, ``c1 = 1 - b1^count`` and ``c2`` are float32
tensors, ``m = b1 m + (1 - b1) g``, ``v = b2 v + ((1 - b2) g) g``, and
``p - lr (step + wd p)`` with weight decay on every parameter, norms
included. Tensors are updated one at a time, so the temporaries hold one
parameter's worth of float32, inside one ``adamw.apply``
``record_function`` range (the card smoke's step split reads it).
"""
from __future__ import annotations

import dataclasses
import math

import torch
from torch import nn
from torch.profiler import record_function


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1


def schedule(cfg: AdamWConfig, step) -> torch.Tensor:
    """Linear warmup then cosine decay to min_lr_ratio * lr, in float32.
    ``step`` is an integer or an integer tensor; the result lives on its
    device."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = step / max(cfg.warmup_steps, 1)
    prog = (step - cfg.warmup_steps) / max(cfg.total_steps - cfg.warmup_steps, 1)
    prog = torch.clamp(prog, 0.0, 1.0)
    cos = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * 0.5 * (1 + torch.cos(math.pi * prog))
    return cfg.lr * torch.where(step < cfg.warmup_steps, warm, cos)


def init(model: nn.Module) -> dict:
    """Master copies (float32) and zero moments of every parameter."""
    named = list(model.named_parameters())
    device = named[0][1].device
    with torch.no_grad():
        return {"master": {n: p.detach().to(torch.float32, copy=True) for n, p in named},
                "m": {n: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                      for n, p in named},
                "v": {n: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                      for n, p in named},
                "count": torch.zeros((), dtype=torch.int32, device=device)}


@torch.no_grad()
def apply(model: nn.Module, grads: dict[str, torch.Tensor], state: dict,
          cfg: AdamWConfig) -> dict:
    """One AdamW step on ``grads`` (by parameter name, in the parameters'
    dtype): master, m, v and count are updated in place, the master is
    copied into the module's parameters, and the state is returned."""
    with record_function("adamw.apply"):
        count = state["count"] + 1
        lr = schedule(cfg, count)
        b1, b2 = cfg.beta1, cfg.beta2
        c1 = 1.0 - b1 ** count.to(torch.float32)
        c2 = 1.0 - b2 ** count.to(torch.float32)
        for name, p in model.named_parameters():
            g = grads[name].to(torch.float32)
            m, v, master = state["m"][name], state["v"][name], state["master"][name]
            m.copy_(b1 * m + (1 - b1) * g)
            v.copy_(b2 * v + (1 - b2) * g * g)
            del g
            step = (m / c1) / (torch.sqrt(v / c2) + cfg.eps)
            master.copy_(master - lr * (step + cfg.weight_decay * master))
            del step
            p.copy_(master)
        state["count"] = count
    return state
