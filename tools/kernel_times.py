#!/usr/bin/env python3
"""Time the port's Gram kernels (K1, K3, K4) on one card at the paths' shapes.

    python3 tools/kernel_times.py [--src DIR] [--tag NAME]

``--src`` names the ``src`` directory whose ``repro_torch`` is imported
(default: this checkout's), so that two checkouts can be compared on one
card: run the script once per checkout, in turns (A, B, B, A), in one
session on the machine. Each case is the median CUDA-event time of 10 calls
after one warm-up call (the kernels are built on the first call), through
the kernel wrappers of ``repro_torch.kernels.gram``:

- K1 ``gram_moment_cuda`` at one client's Phase 1 (n 16384, d 4096) and at
  one streamed row (n 1, d 4096 and 1024; median of 100 calls), float32;
- K3 ``sketch_gram_cuda`` at n 16384, d 4096, m 1024, float32;
- K4 ``rff_gram_cuda`` at n 16384, d 128, D 4096, float32.

Prints one JSON line: the tag, the card's name and power limit, and the
milliseconds of each case. Exits non-zero without a CUDA card.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def cuda_ms(fn, reps: int = 10) -> float:
    """Median CUDA-event time of one call, after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--src", default=os.path.join(ROOT, "src"))
    ap.add_argument("--tag", default="")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("kernel_times: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.abspath(args.src))
    from repro_torch.kernels import gram as K

    g = torch.Generator(device="cuda").manual_seed(0)

    def randn(*shape):
        return torch.randn(shape, generator=g, device="cuda")

    ms = {}
    A, b = randn(16384, 4096), randn(16384)
    ms["k1_16384x4096"] = cuda_ms(lambda: K.gram_moment_cuda(A, b))
    for d in (4096, 1024):          # one streamed row: ~0.1 ms, so 100 calls
        A1, b1 = randn(1, d), randn(1)
        ms[f"k1_1x{d}"] = cuda_ms(lambda: K.gram_moment_cuda(A1, b1), reps=100)
    R = randn(4096, 1024) / 32.0
    ms["k3_16384x4096_m1024"] = cuda_ms(lambda: K.sketch_gram_cuda(A, b, R))
    del A, R
    X, W = randn(16384, 128), randn(128, 4096) / 128 ** 0.5
    c = 2 * np.pi * torch.rand(4096, generator=g, device="cuda")
    ms["k4_16384x128_D4096"] = cuda_ms(lambda: K.rff_gram_cuda(X, b, W, c))
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(json.dumps({"tag": args.tag, "src": args.src, "card": card, "ms": ms}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
