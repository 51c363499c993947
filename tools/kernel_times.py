#!/usr/bin/env python3
"""Time the port's kernels on one card at the paths' shapes.

    python3 tools/kernel_times.py [--src DIR] [--tag NAME] [--only write|gram|sharded|swa]

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
- the sharded backend (``--only sharded`` runs just these), float32: K2's
  general entry ``gemm_nt_cuda`` at the block Cholesky's four tile shapes
  (the SYRK 1024 x 2048 x 256, the TRSM 3840 x 256 x 256, the trailing
  update 1024 x 320 x 320, the tile composition 320 x 96 x 96; alpha -1),
  by wrapper and device time (200 bare launches into a preallocated
  output), beside ``torch.addmm`` by wrapper and device time (``out=``);
  then on a (4, 2) mesh of 8 shards of the card at d 4096 (bs 256), one
  cold ``ShardedBackend`` factor and one rank-64 factor update (event and
  host time).
- K5 at hubert-xlarge's encode (``--only swa`` runs just these): B 4,
  S 1500, H 16 over 16, non-causal, no window, at head_dim 64, 80 and 128,
  in bf16 and float32: each case's time, its rate (4 hd operations a kept
  pair) and the SHA-256 of its output on inputs drawn from seed 0, so that
  two checkouts' bits can be compared; a checkout whose K5 refuses a
  head_dim reports the error instead.

Prints one JSON line: the tag, the card's name and power limit, and the
milliseconds of each case. Exits non-zero without a CUDA card.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
from chip_smoke import (bare_entry, burst_ms, cuda_ms, k2_bare,  # noqa: E402
                        k2_general_bare, p_bare)


def panel_inputs(bw: int, r: int, g):
    M = torch.randn(16 * bw, bw, generator=g, device="cuda")
    L11 = torch.linalg.cholesky(M.T @ M + 0.01 * torch.eye(bw, device="cuda"))
    return L11.contiguous(), torch.randn(r, bw, generator=g, device="cuda")


def host_ms(fn, reps: int = 10) -> float:
    """Host clock over ``reps`` calls in a row after one warm-up call,
    synchronised, per call."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / reps


def update_times(g) -> dict:
    """One rank-64 update of a d 4096 float32 factor through
    ``chol_update_blocked`` (128 panels, the copies of L and U included):
    the CUDA-event median of 10, and the host clock over 10 in a row."""
    from repro_torch.server import cholesky
    d, r = 4096, 64
    M = torch.randn(2 * d, d, generator=g, device="cuda") / (2 * d) ** 0.5
    L = torch.linalg.cholesky(M.T @ M + 0.1 * torch.eye(d, device="cuda")).contiguous()
    U = 0.1 * torch.randn(r, d, generator=g, device="cuda")
    del M
    return {"event_ms": cuda_ms(lambda: cholesky.chol_update_blocked(L, U)),
            "host_ms": host_ms(lambda: cholesky.chol_update_blocked(L, U))}


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


def k2_general(K, C, A, B, alpha: float):
    """``chip_smoke.k2_general_bare``; a checkout from before the tile
    argument (no ``gemm_tile``) launches without it."""
    if hasattr(K, "gemm_tile"):
        return k2_general_bare(K, C, A, B, alpha)
    (m, n), k = C.shape, A.shape[1]
    O = torch.empty_like(C)
    call = bare_entry(K, "gemm_nt")
    args = (C.data_ptr(), A.data_ptr(), B.data_ptr(), O.data_ptr(), m, n, k, alpha,
            K._FLOAT_DTYPES[C.dtype])
    return lambda: call(*args)


def sharded(K, g) -> dict:
    """K2 at the sharded block Cholesky's tile shapes against addmm, then a
    cold factor and a rank-64 update of a d 4096 ShardedBackend on a (4, 2)
    mesh of the card."""
    from repro_torch.core import SuffStats
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.server import ShardedBackend
    from repro_torch.server.distributed import SUB_PANEL

    d, r, sigma = 4096, 64, 0.01
    mesh = mesh_lib.make_device_mesh(8, device="cuda")
    be = ShardedBackend(d, mesh)
    bs, rl, cl = be.block_size, be._rl, be._cl
    shapes = {"syrk": (rl, cl, bs), "trsm": (d - bs, bs, bs),
              "update": (rl, bs + r, bs + r), "compose": (bs + r, SUB_PANEL + r, SUB_PANEL + r)}
    out = {}
    for tag, (m, n, k) in shapes.items():
        C = torch.randn(m, n, generator=g, device="cuda")
        A = torch.randn(m, k, generator=g, device="cuda")
        B = torch.randn(n, k, generator=g, device="cuda")
        O = torch.empty_like(C)
        out[f"k2_{tag}"] = {
            "shape": [m, n, k],
            "tile": K.gemm_tile(m, n, C.dtype) if hasattr(K, "gemm_tile") else 64,
            "wrapper_ms": cuda_ms(lambda: K.gemm_nt_cuda(C, A, B, alpha=-1.0)),
            "device_ms": burst_ms(k2_general(K, C, A, B, -1.0), 200),
            "addmm_ms": cuda_ms(lambda: torch.addmm(C, A, B.T, alpha=-1.0)),
            "addmm_device_ms": burst_ms(
                lambda: torch.addmm(C, A, B.T, alpha=-1.0, out=O), 200)}
    M = torch.randn(2 * d, d, generator=g, device="cuda") / (2 * d) ** 0.5
    be.set_stats(SuffStats(M.T @ M, torch.randn(d, generator=g, device="cuda"),
                           torch.tensor(2 * d, device="cuda")))
    del M
    launches0 = K.gemm_nt_cuda.launches
    factor = be.factor(sigma)
    torch.cuda.synchronize()
    out["factor_k2_launches"] = K.gemm_nt_cuda.launches - launches0
    out["factor_d4096"] = {"event_ms": cuda_ms(lambda: be.factor(sigma)),
                           "host_ms": host_ms(lambda: be.factor(sigma))}
    U = 0.1 * torch.randn(r, d, generator=g, device="cuda")
    out["update_d4096_r64"] = {"event_ms": cuda_ms(lambda: be.update(factor, U, 1.0)),
                               "host_ms": host_ms(lambda: be.update(factor, U, 1.0))}
    return out


def swa_head_dims(K) -> dict:
    """K5 at hubert's encode shape across head_dims and dtypes."""
    import hashlib

    B, S, H = 4, 1500, 16
    out = {}
    for dtype in (torch.bfloat16, torch.float32):
        for hd in (64, 80, 128):
            g = torch.Generator(device="cuda").manual_seed(0)
            q, k, v = (torch.randn(B, S, H, hd, generator=g, device="cuda").to(dtype)
                       for _ in range(3))
            tag = f"{str(dtype).split('.')[1]}_hd{hd}"
            try:
                o = K.swa_flash_cuda(q, k, v, window=None, causal=False)
            except ValueError as err:
                out[tag] = {"refused": str(err)}
                continue
            ms = cuda_ms(lambda: K.swa_flash_cuda(q, k, v, window=None, causal=False))
            out[tag] = {"ms": ms, "tflops": 4 * hd * S * S * B * H / ms / 1e9,
                        "sha256": hashlib.sha256(o.cpu().view(torch.uint8).numpy()
                                                 .tobytes()).hexdigest()}
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--src", default=os.path.join(ROOT, "src"))
    ap.add_argument("--tag", default="")
    ap.add_argument("--only", choices=("write", "gram", "sharded", "swa"), default=None)
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
    if args.only in (None, "gram"):
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
    if args.only in (None, "write"):
        ms["write_path"] = write_path(K, g)
    if args.only in (None, "sharded"):
        ms["sharded"] = sharded(K, g)
    if args.only in (None, "swa"):
        ms["swa_hubert"] = swa_head_dims(K)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(json.dumps({"tag": args.tag, "src": src, "card": card, "ms": ms}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
