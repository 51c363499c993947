#!/usr/bin/env python3
"""Time the port's kernels on one card at the paths' shapes.

    python3 tools/kernel_times.py [--src DIR] [--tag NAME] [--only write|gram]

``--src`` names the ``src`` directory whose ``repro_torch`` is imported
(default: this checkout's), so that two checkouts can be compared on one
card: run the script once per checkout, in turns (A, B, B, A), in one
call on the machine. Each wrapper case is the median CUDA-event time of
10 calls after one warm-up call (the kernels are built on the first call),
through the kernel wrappers of ``repro_torch.kernels.gram``:

- K1 ``gram_moment_cuda`` at one client's Phase 1 (n 16384, d 4096) and at
  one streamed row (n 1, d 4096 and 1024; median of 100 calls), float32;
- K3 ``sketch_gram_cuda`` at n 16384, d 4096, m 1024, float32;
- K4 ``rff_gram_cuda`` at n 16384, d 128, D 4096, float32;
- the write path (``--only write`` runs just these), float32: P at bw 32
  against r 64 and r 1024 update rows, K2's panel entry at the first
  trailing panel of a rank-64 update (m 4064, n = k = 96), each with its
  wrapper time, its device time (CUDA events around back-to-back launches
  of the bare kernel on preallocated buffers, over their count: 200, or 20
  for P at r 1024) and P its split by phase (``clock64`` stamps of CTA 0),
  K2 beside ``torch.addmm`` on the same operands; and one whole rank-64
  update of a d 4096 factor through ``chol_update_blocked`` (event and
  host time). The bare launches are ``chip_smoke.py``'s.

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
sys.path.insert(0, ROOT)
from chip_smoke import burst_ms, cuda_ms, k2_bare, p_bare  # noqa: E402


def panel_inputs(bw: int, r: int, g):
    M = torch.randn(16 * bw, bw, generator=g, device="cuda")
    L11 = torch.linalg.cholesky(M.T @ M + 0.01 * torch.eye(bw, device="cuda"))
    return L11.contiguous(), torch.randn(r, bw, generator=g, device="cuda")


def update_times(g) -> dict:
    """One rank-64 update of a d 4096 float32 factor through
    ``chol_update_blocked`` (128 panels, the copies of L and U included):
    the CUDA-event median of 10, and the host clock over 10 in a row."""
    import time

    from repro_torch.server import cholesky
    d, r = 4096, 64
    M = torch.randn(2 * d, d, generator=g, device="cuda") / (2 * d) ** 0.5
    L = torch.linalg.cholesky(M.T @ M + 0.1 * torch.eye(d, device="cuda")).contiguous()
    U = 0.1 * torch.randn(r, d, generator=g, device="cuda")
    del M
    out = {"event_ms": cuda_ms(lambda: cholesky.chol_update_blocked(L, U))}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(10):
        cholesky.chol_update_blocked(L, U)
    torch.cuda.synchronize()
    out["host_ms"] = (time.perf_counter() - t0) * 100
    return out


def write_path(K, g) -> dict:
    """P in place on a factor's diagonal panel and K2's panel entry, as
    ``chol_update_blocked`` launches them on the card."""
    out = {}
    bw, d = 32, 4096
    for r, reps in ((64, 200), (1024, 20)):
        L11, X1 = panel_inputs(bw, r, g)
        device_ms, phases = p_bare(K, L11, X1, reps)
        out[f"p_bw32_r{r}"] = {
            "wrapper_ms": cuda_ms(lambda: K.panel_transform_cuda(L11, X1)),
            "device_ms": device_ms, "phases": phases}
    r = 64
    n, m = bw + r, d - bw
    L = torch.randn(d, d, generator=g, device="cuda")
    X = torch.randn(r, d, generator=g, device="cuda")
    T = torch.linalg.qr(torch.randn(n, n, generator=g, device="cuda"))[0].contiguous()
    Z = torch.cat([L[bw:, :bw], X[:, bw:].T], dim=1)
    C, O = torch.zeros_like(Z), torch.empty_like(Z)
    out["k2_m4064_n96"] = {
        "wrapper_ms": cuda_ms(lambda: K.panel_gemm_cuda(L, X, 0, bw, T)),
        "device_ms": burst_ms(k2_bare(K, L, X, T), 200),
        "addmm_ms": cuda_ms(lambda: torch.addmm(C, Z, T)),
        "addmm_burst_ms": burst_ms(lambda: torch.addmm(C, Z, T, out=O), 200)}
    out["update_d4096_r64"] = update_times(g)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--src", default=os.path.join(ROOT, "src"))
    ap.add_argument("--tag", default="")
    ap.add_argument("--only", choices=("write", "gram"), default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("kernel_times: no CUDA device", file=sys.stderr)
        return 1
    src = os.path.abspath(args.src)
    sys.path.insert(0, src)
    from repro_torch.kernels import gram as K

    g = torch.Generator(device="cuda").manual_seed(0)

    def randn(*shape):
        return torch.randn(shape, generator=g, device="cuda")

    ms = {}
    if args.only != "write":
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
        del X, W
    if args.only != "gram":
        ms["write_path"] = write_path(K, g)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(json.dumps({"tag": args.tag, "src": src, "card": card, "ms": ms}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
