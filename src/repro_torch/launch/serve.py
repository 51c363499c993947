"""Batched model serving: prefill a batch of prompts, then decode new tokens.

The counterpart of the reference's ``launch/serve.py --mode model``. Every
attention layer's prefill runs kernel K5 on the card; decode is plain
PyTorch against the KV cache. Run as

    PYTHONPATH=src python -m repro_torch.launch.serve --mode model \\
        --arch gemma3-27b [--no-reduced] [--device cpu]

``--mode model`` is the only mode until the fusion server and the wire
(ROADMAP items 10 and 13) are ported.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch import configs
from repro_torch.kernels import ops
from repro_torch.models import model as model_lib


def _next_token(logits: torch.Tensor, greedy: bool,
                generator: torch.Generator | None) -> torch.Tensor:
    if greedy:
        return torch.argmax(logits, dim=-1)
    probs = torch.softmax(logits.float(), dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0]


def generate(model: model_lib.BackboneLM, prompts: torch.Tensor,
             gen_tokens: int, *, greedy: bool = True,
             generator: torch.Generator | None = None
             ) -> tuple[torch.Tensor, dict]:
    """Prefill ``prompts`` (B, S), then decode until ``gen_tokens`` tokens
    per row exist (the first comes from the prefill's logits).

    Returns the tokens (B, gen_tokens) and the seconds of the prefill and
    of the decode loop, each ending in a device synchronisation. Sampling
    (``greedy=False``) draws from ``generator``, on the logits' device.
    """
    B, S = prompts.shape
    t0 = time.perf_counter()
    logits, cache = model_lib.prefill_step(model, {"tokens": prompts},
                                           max_len=S + gen_tokens)
    tok = _next_token(logits[:, -1], greedy, generator)
    ops.synchronize(prompts)
    t_prefill = time.perf_counter() - t0
    generated = [tok]
    t0 = time.perf_counter()
    for _ in range(gen_tokens - 1):
        logits, cache = model_lib.decode_step(model, cache, {"tokens": tok[:, None]})
        tok = _next_token(logits[:, 0], greedy, generator)
        generated.append(tok)
    ops.synchronize(prompts)
    return torch.stack(generated, dim=1), {"prefill_s": t_prefill,
                                           "decode_s": time.perf_counter() - t0}


def serve(arch: str, *, reduced: bool = True, batch: int = 4,
          prompt_len: int = 32, gen_tokens: int = 32, seed: int = 0,
          greedy: bool = True, device="cuda") -> dict:
    """Initialise ``arch`` from ``seed``, serve ``batch`` random prompts.

    The prompts are the reference's (``np.random.default_rng(seed)``), bit
    for bit; the weights are drawn from a ``torch.Generator`` and differ.
    """
    cfg = configs.get_reduced(arch) if reduced else configs.get(arch)
    if cfg.encoder_only:
        raise ValueError("encoder-only architecture has no decode step")
    device = torch.device(device)
    model = model_lib.init_params(
        cfg, generator=torch.Generator(device).manual_seed(seed), device=device)
    rng = np.random.default_rng(seed)
    prompts = torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (batch, prompt_len)).astype(np.int32)).to(device)
    sampler = None if greedy else torch.Generator(device).manual_seed(seed + 1)
    tokens, times = generate(model, prompts, gen_tokens, greedy=greedy,
                             generator=sampler)
    return {
        "arch": cfg.name,
        "prefill_s": times["prefill_s"],
        "decode_s": times["decode_s"],
        "decode_tok_per_s": batch * (gen_tokens - 1) / max(times["decode_s"], 1e-9),
        "generated": tokens.cpu().numpy(),
    }


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--mode", choices=["model"], default="model")
    ap.add_argument("--arch", choices=list(configs.ARCH_IDS), required=True)
    ap.add_argument("--reduced", action=argparse.BooleanOptionalAction,
                    default=True, help="the reduced same-family config "
                    "(default) or, with --no-reduced, the full one")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen-tokens", type=int, default=32)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    res = serve(args.arch, reduced=args.reduced, batch=args.batch,
                prompt_len=args.prompt_len, gen_tokens=args.gen_tokens,
                device=args.device)
    print(f"[serve] {res['arch']}: prefill {res['prefill_s']:.2f}s, "
          f"decode {res['decode_tok_per_s']:.1f} tok/s "
          f"(batch {args.batch})")
    print(f"[serve] sample continuation: {res['generated'][0][:16].tolist()}")


if __name__ == "__main__":
    main()
