#!/usr/bin/env python3
"""On-card smoke test of the PyTorch / CUDA port (``src/repro_torch``).

Run from the root of a checkout on a machine with one NVIDIA card:

    python3 chip_smoke.py

It builds the port's CUDA kernels from ``src/repro_torch/csrc`` (nvcc,
sm_90a), holds each against its plain PyTorch version on the card, then
drives the port's main path through its public entry points at d = 4096,
K = 8 clients of 16384 rows each, float32, and checks the results against
float64 references. It prints one JSON line per phase, then the kernel
table, the card's name and power limit, and as the last line
``{"ok": true, "device": {...}}``. Any failure raises and exits non-zero;
so does a machine without a CUDA card, and a directory without the port.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))

# Main-path size: the top of the repo's own d-grids (Table VII uses d = 1000,
# the mutation benchmark d = 1024), a dense tenant one card holds easily.
DIM, CLIENTS, ROWS = 4096, 8, 16384
SIGMA = 0.01
SIGMAS = (0.01, 0.1, 1.0, 10.0)
STREAM_ROWS, COALESCE_RANK = 256, 64
PANEL = 32                          # DenseBackend.update_block_size
REPS = 10

# Published peaks, NVIDIA data sheets: memory bytes/s and FP32 operations/s
# outside the tensor cores (the kernels run float32 on the CUDA cores).
CARD_PEAKS = {
    "H100 PCIe": (2.0e12, 51e12),
    "H100 NVL": (3.9e12, 60e12),
    "H100": (3.35e12, 67e12),     # SXM5 (HBM3)
}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def card_peaks(name: str):
    for key, rates in CARD_PEAKS.items():
        if key in name:
            return rates
    raise RuntimeError(f"no published peaks for card {name!r}")


def cuda_ms(fn, reps: int = REPS) -> float:
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


def rel_err(x: torch.Tensor, ref: torch.Tensor) -> float:
    """max |x - ref| / max |ref|, in float64."""
    x, ref = x.double(), ref.double()
    return float((x - ref).abs().max() / ref.abs().max().clamp_min(1e-300))


def bound(ops: float, nbytes: float, peaks):
    """Least time (ms) for the work, and whether operations or bytes set it."""
    bw, fp32 = peaks
    t_ops = ops / fp32
    t_bytes = nbytes / bw
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes
                                       else "bytes")


def smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


# -- phase 1: device and build -----------------------------------------------

def device_phase() -> dict:
    from repro_torch.kernels import _build

    t0 = time.perf_counter()
    build_s = _build.build_all()
    regs = {name: [ln.split("ptxas info    : ")[-1] for ln in log.splitlines()
                   if "registers" in ln]
            for name, log in _build.build_logs().items()}
    return {"phase": "device", "nvidia_smi": smi(),
            "torch": torch.__version__, "cuda": torch.version.cuda,
            "build_s": build_s, "ptxas": regs,
            "seconds": time.perf_counter() - t0}


# -- phase 2: each kernel against its plain version ---------------------------

def kernel_phase(peaks) -> tuple[dict, dict]:
    from repro_torch.kernels import gram as K
    from repro_torch.kernels import ref
    from repro_torch.server.cholesky import panel_transform_ref

    t0 = time.perf_counter()
    g = torch.Generator(device="cuda").manual_seed(1)

    def randn(*shape, dtype=torch.float32):
        return torch.randn(shape, generator=g, device="cuda", dtype=dtype)

    rows = {}
    detail = {}

    # K1 at one client's Phase-1 shape. Tolerance: both sides sum n float32
    # products in different orders; 1e-4 of max|G| covers that at n = 16384.
    n, d = ROWS, DIM
    A, b = randn(n, d), randn(n)
    G, h = K.gram_moment_cuda(A, b)
    G2, h2 = K.gram_moment_cuda(A, b)
    torch.cuda.synchronize()
    check(torch.equal(G, G2) and torch.equal(h, h2),
          "K1 is not bitwise deterministic across two runs")
    check(torch.equal(G, G.T), "K1 G is not exactly symmetric")
    Gr, hr = ref.gram_moment_ref(A, b)
    k1 = {"G_rel": rel_err(G, Gr), "h_rel": rel_err(h, hr),
          "max_abs_err": float(max((G - Gr).abs().max(), (h - hr).abs().max())),
          "bitwise_repeat": True}
    Ab, bb = A.bfloat16(), b.bfloat16()
    Gb, hb = K.gram_moment_cuda(Ab, bb)
    Gbr, hbr = ref.gram_moment_ref(Ab, bb)
    k1["bf16_G_rel"], k1["bf16_h_rel"] = rel_err(Gb, Gbr), rel_err(hb, hbr)
    As, bs = randn(500, 100), randn(500)           # paper size, ragged tiles
    Gs, hs = K.gram_moment_cuda(As, bs)
    Gsr, hsr = ref.gram_moment_ref(As, bs)
    k1["ragged_G_rel"], k1["ragged_h_rel"] = rel_err(Gs, Gsr), rel_err(hs, hsr)
    A1, b1 = randn(1, d), randn(1)                  # one streamed row
    G1, h1 = K.gram_moment_cuda(A1, b1)
    G1r, h1r = ref.gram_moment_ref(A1, b1)
    k1["row_G_rel"] = rel_err(G1, G1r)
    Ad, bd = randn(2048, 300, dtype=torch.float64), randn(2048, dtype=torch.float64)
    Gd, hd = K.gram_moment_cuda(Ad, bd)
    Gdr, hdr = ref.gram_moment_ref(Ad, bd)
    k1["f64_G_rel"], k1["f64_h_rel"] = rel_err(Gd, Gdr), rel_err(hd, hdr)
    for key in ("G_rel", "h_rel", "bf16_G_rel", "bf16_h_rel", "ragged_G_rel",
                "ragged_h_rel", "row_G_rel"):
        check(k1[key] <= 1e-4, f"K1 {key} = {k1[key]} > 1e-4")
    check(k1["f64_G_rel"] <= 1e-12 and k1["f64_h_rel"] <= 1e-12,
          f"K1 float64 error {k1['f64_G_rel']}, {k1['f64_h_rel']} > 1e-12")
    ms = cuda_ms(lambda: K.gram_moment_cuda(A, b))
    plain_ms = cuda_ms(lambda: ref.gram_moment_ref(A, b))
    lib_ms = cuda_ms(lambda: A.T @ A)
    bms, by = bound(n * d * (d + 1) + 2 * n * d, 4 * (n * d + n + d * d + d),
                    peaks)
    rows["gram_moment"] = dict(
        name="gram_moment", route="cuda",
        source="src/repro_torch/csrc/gram_moment.cu",
        replaces="src/repro/kernels/gram.py:272", max_abs_err=k1["max_abs_err"],
        ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=by, library_ms=lib_ms)
    detail["gram_moment"] = {**k1, "shape": [n, d], "tolerance": "rel 1e-4 (f32, bf16), 1e-12 (f64)"}
    del A, b, G, G2, Gr, Ab, Gb, Gbr

    # K2 at the first panel's trailing-GEMM shape of a rank-64 update.
    m, nn, k = DIM - PANEL, PANEL + COALESCE_RANK, PANEL + COALESCE_RANK
    C, Am, Bm = torch.zeros(m, nn, device="cuda"), randn(m, k), randn(nn, k)
    O = K.gemm_nt_cuda(C, Am, Bm, alpha=1.0)
    Or = ref.gemm_nt_ref(C, Am, Bm, alpha=1.0)
    k2 = {"rel": rel_err(O, Or), "max_abs_err": float((O - Or).abs().max())}
    C2, A2, B2 = randn(100, 37), randn(100, 13), randn(37, 13)
    k2["ragged_rel"] = rel_err(K.gemm_nt_cuda(C2, A2, B2, alpha=-1.0),
                               ref.gemm_nt_ref(C2, A2, B2, alpha=-1.0))
    Cd, Ad2, Bd2 = (x.double() for x in (C, Am, Bm))
    k2["f64_rel"] = rel_err(K.gemm_nt_cuda(Cd, Ad2, Bd2, alpha=1.0),
                            ref.gemm_nt_ref(Cd, Ad2, Bd2, alpha=1.0))
    # k = 96 float32 products per entry, summed in two orders.
    check(k2["rel"] <= 1e-5 and k2["ragged_rel"] <= 1e-5,
          f"K2 error {k2['rel']}, {k2['ragged_rel']} > 1e-5")
    check(k2["f64_rel"] <= 1e-13, f"K2 float64 error {k2['f64_rel']} > 1e-13")
    ms = cuda_ms(lambda: K.gemm_nt_cuda(C, Am, Bm, alpha=1.0))
    plain_ms = cuda_ms(lambda: ref.gemm_nt_ref(C, Am, Bm, alpha=1.0))
    lib_ms = cuda_ms(lambda: torch.addmm(C, Am, Bm.T, alpha=1.0))
    bms, by = bound(2 * m * nn * k + 2 * m * nn,
                    4 * (2 * m * nn + m * k + nn * k), peaks)
    rows["gemm_nt"] = dict(
        name="gemm_nt", route="cuda", source="src/repro_torch/csrc/gemm_nt.cu",
        replaces="src/repro/kernels/gram.py:86", max_abs_err=k2["max_abs_err"],
        ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=by, library_ms=lib_ms)
    detail["gemm_nt"] = {**k2, "shape": [m, nn, k], "tolerance": "rel 1e-5 (f32), 1e-13 (f64)"}

    # P at the main path's panel: bw = 32 against r = 64 update rows, on a
    # diagonal panel of a real Gram's factor.
    bw, r = PANEL, COALESCE_RANK
    M = randn(ROWS, bw)
    # torch.linalg.cholesky returns column-major strides; the kernel takes
    # row-major (chol_update_blocked copies each panel the same way).
    L11 = torch.linalg.cholesky(
        M.T @ M + SIGMA * torch.eye(bw, device="cuda")).contiguous()
    X1 = randn(r, bw)
    k3 = {}
    for sign in (1.0, -1.0):
        # the downdate removes rows that the update just added: stays PD
        base = L11 if sign > 0 else K.panel_transform_cuda(L11, X1)[0]
        Lk, Tk = K.panel_transform_cuda(base, X1, sign=sign)
        Lp, Tp = panel_transform_ref(base, X1, sign=sign)
        key = "up" if sign > 0 else "down"
        k3[f"{key}_L_rel"], k3[f"{key}_T_rel"] = rel_err(Lk, Lp), rel_err(Tk, Tp)
        k3[f"{key}_max_abs_err"] = float(max((Lk - Lp).abs().max(),
                                             (Tk - Tp).abs().max()))
    Ld, Td = K.panel_transform_cuda(L11.double(), X1.double())
    Lpd, Tpd = panel_transform_ref(L11.double(), X1.double())
    k3["f64_rel"] = max(rel_err(Ld, Lpd), rel_err(Td, Tpd))
    # Same elementary operations; only fused multiply-adds round differently,
    # and the r * bw = 2048-step chain carries that.
    for key in ("up_L_rel", "up_T_rel", "down_L_rel", "down_T_rel"):
        check(k3[key] <= 1e-4, f"P {key} = {k3[key]} > 1e-4")
    check(k3["f64_rel"] <= 1e-12, f"P float64 error {k3['f64_rel']} > 1e-12")
    ms = cuda_ms(lambda: K.panel_transform_cuda(L11, X1))
    plain_ms = cuda_ms(lambda: panel_transform_ref(L11, X1))
    rotations = bw * (bw - 1) // 2 * r + bw * r + (bw + r) * bw * r
    bms, by = bound(6 * rotations, 4 * (2 * bw * bw + r * bw + (bw + r) ** 2),
                    peaks)
    rows["panel_transform"] = dict(
        name="panel_transform", route="cuda",
        source="src/repro_torch/csrc/panel_transform.cu",
        replaces="src/repro/server/cholesky.py:83",
        max_abs_err=max(k3["up_max_abs_err"], k3["down_max_abs_err"]),
        ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=by, library_ms=None)
    detail["panel_transform"] = {**k3, "shape": [bw, r], "tolerance": "rel 1e-4 (f32), 1e-12 (f64)"}
    return ({"phase": "kernels", "detail": detail,
             "seconds": time.perf_counter() - t0}, rows)


# -- phase 3: the main path through the public entry points -------------------

def main_path_phase() -> dict:
    from repro_torch import data, fed
    from repro_torch.core import compute_stats, dropout_fusion
    from repro_torch.kernels import gram as K
    from repro_torch.server import (CoalescerPolicy, FusionEngine,
                                    reference_inference)

    def f64_solve(stats, sigma):
        G = stats.gram.double()
        eye = torch.eye(G.shape[0], dtype=torch.float64, device=G.device)
        return torch.linalg.solve(G + sigma * eye, stats.moment.double())

    def sync():
        torch.cuda.synchronize()

    steps = {}
    t_all = time.perf_counter()
    ds = data.synthetic.generate(0, num_clients=CLIENTS,
                                 samples_per_client=ROWS, dim=DIM)
    sync()
    steps["generate_s"] = time.perf_counter() - t_all
    K.reset_launch_counts()

    # 1. one-shot protocol vs centralized and a float64 solve of the same
    #    fused statistics. Tolerance 1e-4 relative: float32 statistics and a
    #    float32 Cholesky of a well-conditioned Gram (kappa = O(10)).
    t0 = time.perf_counter()
    res = fed.run_one_shot(ds, SIGMA)
    cen = fed.run_centralized(ds, SIGMA)
    sync()
    steps["one_shot_s"] = time.perf_counter() - t0
    fused = res.extras["fused_stats"]
    w64 = f64_solve(fused, SIGMA)
    errs = {"one_shot_vs_f64": rel_err(res.weights, w64),
            "one_shot_vs_centralized": rel_err(res.weights, cen.weights),
            "test_mse": float(torch.mean((ds.test_A @ res.weights - ds.test_b) ** 2))}
    check(errs["one_shot_vs_f64"] <= 1e-4 and
          errs["one_shot_vs_centralized"] <= 1e-4, f"one-shot weights {errs}")
    check(int(fused.count) == CLIENTS * ROWS, "fused count")
    upload = res.comm.upload_wire_bytes_per_client

    # 2. engine from the clients; batched sweep warms the factor cache; then
    #    64 prediction queries of 8 rows off the cached factors.
    t0 = time.perf_counter()
    stats = [compute_stats(A, b) for A, b in ds.clients]
    eng = FusionEngine.from_clients(
        stats, coalesce=CoalescerPolicy(max_rank=COALESCE_RANK))
    ws = eng.solve_batch(SIGMAS, method="chol")
    preds = [eng.predict(ds.test_A[8 * i:8 * i + 8], SIGMAS[i % 4])
             for i in range(64)]
    sync()
    steps["engine_solve_predict_s"] = time.perf_counter() - t0
    for s, w in zip(SIGMAS, ws):
        errs[f"sweep_{s}_vs_f64"] = rel_err(w, f64_solve(eng.stats, s))
        check(errs[f"sweep_{s}_vs_f64"] <= 1e-4, f"sweep at {s}: {errs}")
    pred_ref = ds.test_A[:512].double() @ ws.double().T
    errs["predict_rel"] = max(rel_err(p, pred_ref[8 * i:8 * i + 8, i % 4])
                              for i, p in enumerate(preds))
    check(errs["predict_rel"] <= 1e-5, f"predictions {errs['predict_rel']}")

    # 3. 256 streamed single rows through the coalescer, then flush: the
    #    cached factors are updated (kernels P and K2), never refactored.
    cold0 = eng.cold_factorizations
    rows_A, rows_b = ds.test_A[:STREAM_ROWS + 1], ds.test_b[:STREAM_ROWS + 1]
    t0 = time.perf_counter()
    for i in range(STREAM_ROWS):
        eng.ingest_rows_async(rows_A[i:i + 1], rows_b[i:i + 1], client_id=7)
    eng.flush()
    sync()
    steps["stream_rows_s"] = time.perf_counter() - t0
    check(eng.incremental_updates > 0, "no incremental factor update")
    check(eng.cold_factorizations == cold0, "streaming refactorized")
    for s in SIGMAS:
        errs[f"stream_{s}_vs_f64"] = rel_err(eng.solve(s), f64_solve(eng.stats, s))
        check(errs[f"stream_{s}_vs_f64"] <= 1e-4, f"streamed at {s}: {errs}")
    check(eng.cold_factorizations == cold0, "solve after streaming refactorized")

    # 4. one synchronous rank-1 ingest: the eager scan-of-rank-1 update of
    #    every cached factor (below the blocked path's rank 8).
    t0 = time.perf_counter()
    eng.ingest_rows(rows_A[STREAM_ROWS:], rows_b[STREAM_ROWS:], client_id=7)
    sync()
    steps["rank1_ingest_rows_s"] = time.perf_counter() - t0
    errs["rank1_vs_f64"] = rel_err(eng.solve(SIGMA), f64_solve(eng.stats, SIGMA))
    check(errs["rank1_vs_f64"] <= 1e-4, f"rank-1 update: {errs}")

    # 5. Thm 8: drop client 0, check against dropout_fusion, restore.
    t0 = time.perf_counter()
    pre = eng.solve(SIGMA)
    eng.drop(0)
    w_drop = eng.solve(SIGMA)
    clients, dropped = eng.export_ledger()
    ordered = [dropped[0]] + [clients[k] for k in range(1, CLIENTS)]
    w_ref = dropout_fusion(ordered, [False] + [True] * (CLIENTS - 1), SIGMA)
    eng.restore(0)
    w_back = eng.solve(SIGMA)
    sync()
    steps["drop_restore_s"] = time.perf_counter() - t0
    errs["drop_vs_dropout_fusion"] = rel_err(w_drop, w_ref)
    errs["restore_vs_pre_drop"] = rel_err(w_back, pre)
    check(errs["drop_vs_dropout_fusion"] <= 1e-4 and
          errs["restore_vs_pre_drop"] <= 1e-4, f"drop/restore: {errs}")

    # 6. served inference == cold closed-form reference, bitwise.
    t0 = time.perf_counter()
    rep = eng.inference(SIGMA, queries=ds.test_A[:8])
    w_cold, rep_ref = reference_inference(eng.stats, SIGMA,
                                          queries=ds.test_A[:8])
    sync()
    steps["inference_s"] = time.perf_counter() - t0
    check(torch.equal(eng.solve(SIGMA), w_cold), "served w != cold reference")
    for key in ("n", "dof", "rss", "sigma2"):
        check(rep[key] == rep_ref[key], f"inference {key} differs")
    for key in ("stderr", "ci", "pi", "pi_mean"):
        check(np.array_equal(rep[key], rep_ref[key]), f"inference {key} differs")
    check(all(np.isfinite(rep[k]).all() for k in ("stderr", "ci", "pi")),
          "inference not finite")

    launches = K.launch_counts()
    for name, count in launches.items():
        check(count > 0, f"kernel {name} was not launched on the main path")
    return {"phase": "main_path", "dim": DIM, "clients": CLIENTS,
            "rows_per_client": ROWS, "dtype": "float32", "errors": errs,
            "steps_s": steps, "launches": launches,
            "upload_wire_bytes_per_client": upload,
            "engine": eng.summary(),
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 2**30,
            "seconds": time.perf_counter() - t_all}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import repro_torch  # noqa: F401  (fails outside a checkout of the repo)

    torch.cuda.set_device(0)
    name = torch.cuda.get_device_name(0)
    peaks = card_peaks(name)
    emit(device_phase())
    kernels_line, rows = kernel_phase(peaks)
    emit(kernels_line)
    path = main_path_phase()
    emit(path)
    for kname, row in rows.items():
        row["launches"] = path["launches"][kname]
    order = ("name", "route", "source", "replaces", "launches", "max_abs_err",
             "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    emit({"kernels": [{k: row[k] for k in order} for row in rows.values()]})
    print(smi(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
