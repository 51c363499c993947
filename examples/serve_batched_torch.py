"""Serve a small model with batched requests (prefill + decode loop), on the
PyTorch port. The port's copy of ``examples/serve_batched.py``.

Runs ``launch.serve.serve`` on a reduced config: the same prefill and
decode steps that serve the full-width models, here at test widths,
including a sliding-window arch whose cache is a ring buffer. On the card
(``--device``, the default) every attention layer's prefill runs kernel K5;
decode attends in plain PyTorch. The prompts are the reference's
(``np.random.default_rng(0)``); the weights come from a ``torch.Generator``
and differ, so the ids do too.

  PYTHONPATH=src python examples/serve_batched_torch.py [--arch mixtral-8x22b] [--device cpu]
"""
import argparse
import sys

from repro_torch.launch.serve import serve


def main(argv=None) -> dict:
    """Serve; prints the reference's lines and returns ``serve``'s result."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="mixtral-8x22b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=48)
    ap.add_argument("--gen-tokens", type=int, default=24)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    res = serve(args.arch, reduced=True, batch=args.batch,
                prompt_len=args.prompt_len, gen_tokens=args.gen_tokens,
                device=args.device)
    print(f"[serve_batched] {res['arch']}")
    print(f"  prefill ({args.batch} x {args.prompt_len} tokens): "
          f"{res['prefill_s']:.2f}s")
    print(f"  decode throughput: {res['decode_tok_per_s']:.1f} tok/s "
          f"across the batch")
    for i, row in enumerate(res["generated"][:2]):
        print(f"  request {i} continuation ids: {row[:12].tolist()}")
    return res


if __name__ == "__main__":
    main(sys.argv[1:])
