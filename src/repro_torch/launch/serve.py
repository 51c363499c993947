"""Serving loops.

Modes:
  * ``model``  — prefill a batch of prompts (a VLM's after its random
    patch prefix), then decode new tokens (the reference's
    ``launch/serve.py --mode model``). Every attention layer's prefill runs
    kernel K5 on the card; decode is plain PyTorch against the KV cache,
    or a Mamba or RWKV layer's recurrent state (rwkv6-1.6b has no
    attention layer, so no K5). An
    encoder-only arch (hubert-xlarge) raises, as the reference's does: it
    has no decode step, and its ``models.model.encode_step`` no CLI.
  * ``fusion`` — ridge serving on one ``server.EnginePool``, in process
    (the reference's ``serve_fusion``): every tenant is an independent
    fusion problem admitted from Thm-4 packed payloads (K1, or K3 / K4 for
    §IV-F sketched / rff tenants); ``--sharded-tenants N`` pins the first N
    to the pool's one shared mesh (8 shards over every visible card for
    ``--device cuda``, on the one device for ``cuda:0`` or ``cpu``) and
    ``--auto-tenants M`` lets the next M follow ``server.select`` (dense:
    the port has no crossover table); queries run off cached factors against a
    naive cold solve per query, and ``--stream-deltas`` queues row deltas
    with no reads while the pool's background flusher drains them (P and
    K2 on every flush of rank 8 and up). Every tenant's served weights are
    checked against a float64 ``core.fusion`` solve over its own rows.
  * ``fusion --listen PORT`` — the same pool behind the wire (the
    reference's ``serve_wire``): a ``fed.transport.FrameServer`` accepts
    client processes (``launch/client.py``) speaking ``fed.wire`` — STATS,
    PROJ, RFF and DELTA uploads, CONTROL drop / restore, SOLVE queries —
    and the final report carries the ledger of the encoded frame lengths
    and every tenant's weights. ``--journal-dir`` makes the server
    crash-safe: every admitted frame is journaled before it fuses, and a
    restart on the same directory restores the state bitwise with no
    client re-uploading; SIGTERM commits a final snapshot before exit.
    ``--chaos-*`` puts a seeded fault-injecting proxy in front.
  * ``relay --upstream HOST:PORT`` — the same server as the middle tier of
    an aggregation tree (the reference's relay mode, ``server.relay``): it
    admits its clients as above into a ``tier="relay"`` pool and a
    ``RelayForwarder`` ships one fused delta frame per tenant upstream —
    every ``--forward-every`` admitted frames, at ``--forward-staleness``,
    and always at exit or SIGTERM — with its forward state durable under
    ``--relay-state-dir`` (default ``<journal-dir>/relay_state``).

Run as

    PYTHONPATH=src python -m repro_torch.launch.serve --mode model \\
        --arch gemma3-27b [--no-reduced] [--device cpu]
    PYTHONPATH=src python -m repro_torch.launch.serve --mode fusion \\
        [--dim 128 --tenants 8 --stream-deltas 64] \\
        [--sharded-tenants 2 --auto-tenants 2] [--device cpu]
    PYTHONPATH=src python -m repro_torch.launch.serve --mode fusion \\
        --listen 0 --expect-uploads 3 [--journal-dir DIR] [--device cpu]
    PYTHONPATH=src python -m repro_torch.launch.serve --mode relay \\
        --upstream 127.0.0.1:PORT --journal-dir DIR --relay-id r0 \\
        [--listen 0] [--device cpu]

``--compilation-cache`` is not defined: it names a JAX compilation cache.
Before its report, a
``--listen`` process prints ``[serve_wire] launches {json}``, its launches
of each CUDA kernel.
"""
from __future__ import annotations

import argparse
import json
import threading
import time
from typing import Sequence

import numpy as np
import torch

from repro_torch import configs
from repro_torch.core.features import FeatureMap
from repro_torch.core.sufficient_stats import SuffStats, compute_stats, fuse_stats
from repro_torch.kernels import ops
from repro_torch.models import model as model_lib


def _next_token(logits: torch.Tensor, greedy: bool,
                generator: torch.Generator | None) -> torch.Tensor:
    if greedy:
        return torch.argmax(logits, dim=-1)
    probs = torch.softmax(logits.float(), dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0]


def generate(model: model_lib.BackboneLM, prompts: torch.Tensor,
             gen_tokens: int, *, patches: torch.Tensor | None = None,
             greedy: bool = True, generator: torch.Generator | None = None
             ) -> tuple[torch.Tensor, dict]:
    """Prefill ``prompts`` (B, S), after a VLM's ``patches`` (B, P, d) when
    given, then decode until ``gen_tokens`` tokens per row exist (the first
    comes from the prefill's logits).

    Returns the tokens (B, gen_tokens) and the seconds of the prefill and
    of the decode loop, each ending in a device synchronisation. Sampling
    (``greedy=False``) draws from ``generator``, on the logits' device.
    """
    B, S = prompts.shape
    batch = {"tokens": prompts}
    if patches is not None:
        batch["patches"] = patches
        S += patches.shape[1]
    t0 = time.perf_counter()
    logits, cache = model_lib.prefill_step(model, batch, max_len=S + gen_tokens)
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
    """Initialise ``arch`` from ``seed``, serve ``batch`` random prompts
    (after ``num_prefix`` random patch embeddings for a VLM).

    The prompts and patches are the reference's
    (``np.random.default_rng(seed)``), bit for bit; the weights are drawn
    from a ``torch.Generator`` and differ. An encoder-only model raises
    ``ValueError``: it has no decode step.
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
    patches = None
    if cfg.input_mode == "prefix_embeddings":
        patches = torch.from_numpy(rng.standard_normal(
            (batch, cfg.num_prefix, cfg.d_model), dtype=np.float32)).to(device)
    sampler = None if greedy else torch.Generator(device).manual_seed(seed + 1)
    tokens, times = generate(model, prompts, gen_tokens, patches=patches,
                             greedy=greedy, generator=sampler)
    return {
        "arch": cfg.name,
        "prefill_s": times["prefill_s"],
        "decode_s": times["decode_s"],
        "decode_tok_per_s": batch * (gen_tokens - 1) / max(times["decode_s"], 1e-9),
        "generated": tokens.cpu().numpy(),
    }


def _f64_stats(rows: Sequence[tuple[torch.Tensor, torch.Tensor]],
               fm: FeatureMap | None, chunk: int = 16384) -> SuffStats:
    """Float64 statistics of a tenant's rows, featurized (in float32, as its
    clients do) through its map when it has one; taken in row chunks."""
    A = torch.cat([a for a, _ in rows])
    b = torch.cat([y for _, y in rows])
    parts = []
    for i in range(0, A.shape[0], chunk):
        Ai = A[i:i + chunk] if fm is None else fm(A[i:i + chunk])
        parts.append(compute_stats(Ai.double(), b[i:i + chunk].double()))
    return fuse_stats(parts)


def serve_fusion(*, num_clients: int = 4, samples_per_client: int = 128,
                 dim: int = 128, tenants: int = 8, sigmas_per_tenant: int = 4,
                 queries: int = 256, query_rows: int = 8,
                 sharded_tenants: int = 0, auto_tenants: int = 0, mesh=None,
                 threshold: float | None = None,
                 sketched_tenants: int = 0, rff_tenants: int = 0,
                 feature_dim: int = 16, lengthscale: float = 1.0,
                 stream_deltas: int = 0, coalesce_rank: int = 32,
                 flush_staleness_s: float = 0.05, max_warm: int | None = None,
                 seed: int = 0, device="cuda") -> dict:
    """Serve many independent tenants' ridge queries off ONE EnginePool.

    Each tenant is its own fusion problem: its own synthetic clients
    (``data.synthetic.generate`` from ``seed + 7919 t`` on ``device``),
    uploaded as Thm-4 :class:`fed.PackedStats` payloads (the ledger records
    their measured bytes), its own sigma grid, and its own placement: the
    first ``sharded_tenants`` pinned to the pool's shared mesh (``mesh``,
    or one the pool builds over ``device``: every visible card for
    ``"cuda"``), the next ``auto_tenants`` placed
    by ``server.select`` (``threshold``: dense at +inf, the port's default
    without a table), the rest dense. The last ``rff_tenants`` and
    the ``sketched_tenants`` before them are §IV-F feature tenants: their
    uploads are m-space statistics from ``FeatureMap.stats`` (K3 / K4 on
    the card), and their queries and deltas are featurized before they
    reach the pool. A query is (tenant, sigma, X) -> X @ w_sigma: one
    ``solve_batch`` per tenant warms its factors, then every query runs off
    them; the naive baseline cold-factorizes per query.

    Every tenant's served weights are checked against ``core.fusion`` over
    exactly its own rows, featurized for a feature tenant and taken in
    float64 (the reference's cold solve runs in float32):
    ``exact_max_abs_err`` is max |w - w_ref| over tenants, and
    ``exact_max_rel_err`` (the port's addition) is max |w - w_ref| /
    max |w_ref|.

    With ``stream_deltas > 0`` the loop then queues that many single-row
    deltas round-robin across tenants through ``ingest_rows_async`` and
    makes NO reads: the pool's background flusher (started for the
    duration, ``max_staleness_s = flush_staleness_s``) is the only
    staleness clock, beside the coalescer's own flush at
    ``coalesce_rank``. It waits for the queues to drain, records the
    flusher's flushes, the worst delta age, the rank of every flush
    (``flush_ranks``, rank -> flushes: from rank 8 the blocked update, below
    it the eager rank-1 scan) and checks every tenant again.
    """
    from repro_torch.core import fusion
    from repro_torch.data import synthetic
    from repro_torch.fed.protocol import PackedStats
    from repro_torch.server import CoalescerPolicy, EnginePool

    device = torch.device(device)
    sharded_tenants = min(sharded_tenants, tenants)
    auto_tenants = min(auto_tenants, tenants - sharded_tenants)
    rff_tenants = min(rff_tenants, tenants)
    sketched_tenants = min(sketched_tenants, tenants - rff_tenants)
    policy = CoalescerPolicy(max_rank=coalesce_rank,
                             max_staleness_s=flush_staleness_s)
    pool = EnginePool(mesh=mesh, threshold=threshold, max_warm=max_warm,
                      default_coalesce=policy, device=device)

    tenant_rows: dict[str, list[tuple[torch.Tensor, torch.Tensor]]] = {}
    feature_maps: dict[str, FeatureMap] = {}
    for t in range(tenants):
        name = f"tenant{t}"
        ds_t = synthetic.generate(seed + 7919 * t, num_clients=num_clients,
                                  samples_per_client=samples_per_client,
                                  dim=dim, device=device)
        fm = None
        if t >= tenants - rff_tenants:
            fm = FeatureMap("rff", seed=seed + t, d_orig=dim, m=feature_dim,
                            lengthscale=lengthscale)
        elif t >= tenants - rff_tenants - sketched_tenants:
            fm = FeatureMap("sketch", seed=seed + t, d_orig=dim,
                            m=min(feature_dim, dim))
        if fm is None:
            payloads = {k: PackedStats.pack(compute_stats(A_k, b_k))
                        for k, (A_k, b_k) in enumerate(ds_t.clients)}
            placement = ("sharded" if t < sharded_tenants
                         else "auto" if t < sharded_tenants + auto_tenants
                         else "dense")
        else:
            # feature tenants stay dense: their solve is too small to shard
            payloads = {k: PackedStats.pack(fm.stats(A_k, b_k))
                        for k, (A_k, b_k) in enumerate(ds_t.clients)}
            placement = "dense"
            feature_maps[name] = fm
        pool.create_tenant(name, payloads=payloads, placement=placement,
                           features=fm)
        tenant_rows[name] = list(ds_t.clients)

    # Tenant t's grid: sigmas_per_tenant points on a per-tenant log range.
    rng = np.random.default_rng(seed)
    grids = {f"tenant{t}": sorted(10.0 ** rng.uniform(-3, 1, sigmas_per_tenant))
             for t in range(tenants)}
    stream = []
    for _ in range(queries):
        name = f"tenant{int(rng.integers(tenants))}"
        sigma = grids[name][int(rng.integers(sigmas_per_tenant))]
        X = torch.as_tensor(rng.standard_normal((query_rows, dim)),
                            dtype=torch.float32, device=device)
        if name in feature_maps:
            # featurized once, up front: naive and pooled time the same work
            X = feature_maps[name](X)
        stream.append((name, sigma, X))

    def max_err() -> tuple[float, float]:
        worst_abs = worst_rel = 0.0
        for name, grid in grids.items():
            w = pool.solve(name, grid[0]).double()
            ref = fusion.solve_ridge(
                _f64_stats(tenant_rows[name], feature_maps.get(name)), grid[0])
            err = float((w - ref).abs().max())
            worst_abs = max(worst_abs, err)
            worst_rel = max(worst_rel, err / max(float(ref.abs().max()), 1e-300))
        return worst_abs, worst_rel

    # Naive: cold factorization per query, per tenant.
    fused = {name: pool.stats(name) for name in pool.tenant_names}
    ops.synchronize(stream[0][2])
    t0 = time.perf_counter()
    for name, sigma, X in stream:
        X @ fusion.solve_ridge(fused[name], sigma)
    ops.synchronize(stream[0][2])
    t_naive = time.perf_counter() - t0

    # Pooled: one warm sweep per tenant, then queries off cached factors.
    t0 = time.perf_counter()
    for name, grid in grids.items():
        pool.solve_batch(name, grid, method="chol")
    for name, sigma, X in stream:
        pool.predict(name, X, sigma)
    ops.synchronize(stream[0][2])
    t_pool = time.perf_counter() - t0

    exact_abs, exact_rel = max_err()

    # §IV-F metadata per feature tenant: the Prop-3 bound and upload floats.
    feature_reports = {
        name: {k: v for k, v in
               pool.solve_report(name, grids[name][0]).items()
               if k != "weights"}
        for name in feature_maps}

    streaming = None
    if stream_deltas:
        names = list(pool.tenant_names)
        deltas = [
            (names[i % len(names)],
             torch.as_tensor(rng.standard_normal((1, dim)), dtype=torch.float32,
                             device=device),
             torch.as_tensor(rng.standard_normal((1,)), dtype=torch.float32,
                             device=device))
            for i in range(stream_deltas)]
        engines = [pool.get(n) for n in names]
        m0 = sum(e.incremental_updates + e.cold_factorizations for e in engines)
        ranks0 = [dict(e.flush_ranks) for e in engines]
        pool.start_flusher()
        try:
            t0 = time.perf_counter()
            for name, dA, db in deltas:
                # a feature tenant's queue lives in m-space: featurize first
                dA_in = (feature_maps[name](dA) if name in feature_maps
                         else dA)
                pool.ingest_rows_async(name, dA_in, db)
                tenant_rows[name].append((dA, db))
            # NO reads from here on: only the background flusher drains.
            deadline = time.monotonic() + max(10.0, 100 * flush_staleness_s)
            while pool.pending_deltas and time.monotonic() < deadline:
                time.sleep(flush_staleness_s / 5)
            ops.synchronize(deltas[0][1])
            t_stream = time.perf_counter() - t0
            pending_after = pool.pending_deltas
        finally:
            pool.stop_flusher()
        summary = pool.summary()
        mutations = sum(e.incremental_updates + e.cold_factorizations
                        for e in engines) - m0
        flush_ranks: dict[int, int] = {}
        for e, before in zip(engines, ranks0):
            for r, n in e.flush_ranks.items():
                if n - before.get(r, 0):
                    flush_ranks[r] = flush_ranks.get(r, 0) + n - before.get(r, 0)
        stream_abs, stream_rel = max_err()
        streaming = {
            "deltas": stream_deltas,
            "coalesce_rank": coalesce_rank,
            "flush_staleness_s": flush_staleness_s,
            "pending_after": pending_after,
            "background_flushes": summary["background_flushes"],
            "max_flush_age_s": summary["max_flush_age_s"],
            "mutations_per_delta": mutations / stream_deltas,
            "flush_ranks": dict(sorted(flush_ranks.items())),
            "stream_s": t_stream,
            "exact_max_abs_err": stream_abs,
            "exact_max_rel_err": stream_rel,
        }
    pool.close()

    return {
        "tenants": tenants,
        "placements": pool.summary()["placements"],
        "sharded_tenants": sharded_tenants,
        "auto_tenants": auto_tenants,
        "sketched_tenants": sketched_tenants,
        "rff_tenants": rff_tenants,
        "feature_reports": feature_reports,
        "queries": queries,
        "distinct_sigmas": len({sigma for _, sigma, _ in stream}),
        "naive_qps": queries / t_naive,
        "pool_qps": queries / t_pool,
        "speedup": t_naive / t_pool,
        "exact_max_abs_err": exact_abs,
        "exact_max_rel_err": exact_rel,
        "streaming": streaming,
        "ledger": pool.ledger(),
        "pool": pool.summary(),
    }


def _print_fusion(res: dict) -> None:
    print(f"[serve_fusion] {res['queries']} queries, {res['tenants']} "
          f"tenants on one pool, placements {res['placements']} "
          f"({res['sharded_tenants']} pinned sharded, "
          f"{res['auto_tenants']} auto), "
          f"{res['distinct_sigmas']} distinct sigmas")
    print(f"[serve_fusion] naive {res['naive_qps']:.0f} qps -> pooled "
          f"{res['pool_qps']:.0f} qps ({res['speedup']:.1f}x)")
    print(f"[serve_fusion] exact: max|dw|={res['exact_max_abs_err']:.2e} "
          f"(relative {res['exact_max_rel_err']:.2e}) vs float64 per-tenant "
          f"references")
    for name, rep in res["feature_reports"].items():
        bound = rep.get("error_bound")
        print(f"[serve_fusion] {name}: kind={rep['kind']} "
              f"solve_dim={rep['solve_dim']} "
              f"upload_floats={rep['upload_floats']}"
              + (f" prop3_bound={bound:.3f}" if bound is not None else ""))
    if res["streaming"] is not None:
        s = res["streaming"]
        print(f"[serve_fusion] streaming {s['deltas']} deltas, no reads: "
              f"{s['background_flushes']} background flushes, "
              f"{s['pending_after']} left pending, worst delta age "
              f"{s['max_flush_age_s']:.3f}s "
              f"(budget {s['flush_staleness_s']:.3f}s), "
              f"{s['mutations_per_delta']:.2f} mutations/delta, "
              f"flush ranks {s['flush_ranks']}, "
              f"max|dw|={s['exact_max_abs_err']:.2e}")
    led = res["ledger"]
    print(f"[serve_fusion] ledger: {led['upload_download_bytes']} upload "
          f"bytes + {led['streamed_bytes']} streamed + "
          f"{led['cross_shard_bytes']} cross-shard over "
          f"{led['tenants']} tenants")
    if len(led.get("by_kind", {})) > 1:
        split = ", ".join(
            f"{kind}: {v['upload_bytes']}B/{v['tenants']} tenants"
            for kind, v in sorted(led["by_kind"].items()))
        print(f"[serve_fusion] upload bytes by kind: {split}")
    print(f"[serve_fusion] pool: meshes_built="
          f"{res['pool']['meshes_built']} "
          f"warm_tenants={res['pool']['warm_tenants']} "
          f"factor_evictions={res['pool']['factor_evictions']}")


def serve_wire(*, port: int = 0, expect_uploads: int = 0,
               timeout_s: float = 30.0, sigma: float = 0.1,
               inference: bool = False, ci_level: float = 0.95,
               placement: str = "dense", coalesce_rank: int = 32,
               flush_staleness_s: float = 0.05,
               max_warm: int | None = None,
               solve_window_s: float | None = None,
               journal_dir: str | None = None,
               snapshot_every: int | None = None,
               journal_fsync: bool = True,
               chaos=None, chaos_seed: int = 0,
               upstream: str | None = None, relay_id: str = "relay0",
               forward_every: int | None = 32,
               forward_staleness_s: float | None = None,
               forward_interval_s: float = 0.25,
               relay_state_dir: str | None = None,
               max_chunk_payload: int | None = None,
               device="cuda") -> dict:
    """Run the federation server: an ``EnginePool`` on ``device`` behind a
    ``fed.transport.FrameServer`` speaking the ``fed.wire`` protocol.

    Tenants are created lazily, with ``placement`` (a sharded one on the
    pool's shared mesh), by the first upload frame that names them (the
    HELLO's tenant binding); clients negotiate their wire dtype
    per session, in the order the pool's float32 container prefers. The
    loop exits once ``expect_uploads`` upload frames were admitted AND every
    connection has closed (so a SOLVE after the last upload still gets its
    WEIGHTS frame), at ``timeout_s``, or on SIGTERM.
    The report carries the pool ledger of the encoded frame lengths and a
    final solve per tenant at ``sigma``.

    ``solve_window_s`` puts a ``server.batch.SolveBatcher`` window on the
    SOLVE path. ``journal_dir`` makes the pool crash-safe (``EnginePool``):
    every admitted frame is journaled before it fuses, the pool snapshots
    every ``snapshot_every`` appends, a restart on the same directory
    restores the state bitwise with no client re-uploading, and SIGTERM
    leads to a final snapshot before exit (so a clean shutdown replays
    nothing). ``chaos`` (a ``fed.chaos.ChaosConfig``) puts a seeded
    fault-injecting TCP proxy in front of the server; clients connect to the
    printed proxy port.

    ``upstream="HOST:PORT"`` runs this server as a RELAY (``server.relay``):
    the pool is built with ``tier="relay"`` and a ``RelayForwarder`` ships
    ONE fused delta frame per tenant upstream — every ``forward_every``
    admitted frames, at ``forward_staleness_s`` (the poller looks every
    ``forward_interval_s``), and always at exit, SIGTERM included — stamped
    with ``relay_id`` so that upstream dedup makes a re-forward after a
    lost ACK idempotent, and streamed in chunks of ``max_chunk_payload``
    payload bytes when set. Forward state persists under
    ``relay_state_dir`` (default ``<journal_dir>/relay_state``), so a
    restarted relay re-sends its pending frame before it listens; the
    report carries the forwarder's ``relay`` summary.

    The "listening", "recovered" and "re-sent" lines and the final
    ``[serve_wire] report {json}`` line are flushed at once: a parent
    process reads them from a pipe. Before the report, a ``[serve_wire]
    launches {json}`` line gives this process's launches of each CUDA
    kernel (none on the CPU); the report keeps the reference's keys.
    """
    import os
    import signal

    from repro_torch.fed import transport
    from repro_torch.kernels import gram
    from repro_torch.server import CoalescerPolicy, EnginePool

    policy = CoalescerPolicy(max_rank=coalesce_rank,
                             max_staleness_s=flush_staleness_s)
    pool = EnginePool(max_warm=max_warm, default_coalesce=policy,
                      journal_dir=journal_dir, snapshot_every=snapshot_every,
                      journal_fsync=journal_fsync,
                      tier="relay" if upstream is not None else "root",
                      device=device)
    if pool.replayed_frames or pool.restored_tenants:
        print(f"[serve_wire] recovered {pool.restored_tenants} tenants from "
              f"snapshot + {pool.replayed_frames} replayed journal frames",
              flush=True)
    forwarder = None
    if upstream is not None:
        from repro_torch.server.relay import ForwardPolicy, RelayForwarder

        host, _, up_port = upstream.rpartition(":")
        state = relay_state_dir or (os.path.join(journal_dir, "relay_state")
                                    if journal_dir else None)
        if state is None:
            pool.close()
            raise ValueError("relay mode needs relay_state_dir (or a "
                             "journal_dir to put it under)")
        forwarder = RelayForwarder(
            pool, lambda: transport.TCPChannel(host, int(up_port)),
            relay_id=relay_id, state_dir=state,
            policy=ForwardPolicy(max_frames=forward_every,
                                 max_staleness_s=forward_staleness_s),
            max_chunk_payload=max_chunk_payload)
        resumed = forwarder.resume()
        if resumed:
            print(f"[serve_wire] relay {relay_id}: re-sent {resumed} pending "
                  f"forward frame(s) from a previous incarnation", flush=True)
    term = threading.Event()
    installed = False
    try:
        # SIGTERM only sets a flag; the final snapshot runs on the main
        # thread in pool.close() (the context manager's exit), which is
        # idempotent and safe against the flusher.
        signal.signal(signal.SIGTERM, lambda signum, frame: term.set())
        installed = True
    except ValueError:        # not the main thread (an in-process caller)
        pass
    proxy = None
    try:
        with pool, transport.FrameServer(pool, port=port, placement=placement,
                                         solve_window_s=solve_window_s) as srv:
            if chaos is not None:
                from repro_torch.fed.chaos import ChaosProxy, ChaosSchedule

                proxy = ChaosProxy(srv.host, srv.port,
                                   ChaosSchedule(chaos, chaos_seed)).start()
                print(f"[serve_wire] chaos proxy on "
                      f"{proxy.host}:{proxy.port} (seed={chaos_seed})",
                      flush=True)
            print(f"[serve_wire] listening on {srv.host}:{srv.port}",
                  flush=True)
            if forwarder is not None:
                forwarder.start(forward_interval_s)
            deadline = time.monotonic() + timeout_s
            while time.monotonic() < deadline and not term.is_set():
                if (expect_uploads
                        and srv.dispatcher.uploads_admitted >= expect_uploads
                        and srv.active_connections == 0):
                    break
                time.sleep(0.02)
            relay_summary = None
            if forwarder is not None:
                # The shutdown contract, SIGTERM included: whatever the
                # forwarding policy left unshipped goes upstream now, so
                # the root holds this relay's whole fusion before exit.
                forwarder.stop()
                forwarder.forward_all()
                relay_summary = forwarder.summary()
                forwarder.close(forward=False)
            solves = {}
            tenant_reports = {}
            for name in pool.tenant_names:
                # solve_report rides solve_lifted, which is what SOLVE frames
                # serve: the report's weights and the clients' downloads
                # cannot diverge
                rep = pool.solve_report(name, sigma, level=ci_level)
                w = rep.pop("weights")
                solves[name] = w.cpu().numpy().astype(np.float64).tolist()
                for key in ("stderr", "ci", "pi"):
                    if rep.get(key) is not None:
                        rep[key] = np.asarray(rep[key], np.float64).tolist()
                tenant_reports[name] = rep
            ledger = pool.ledger()
            report = {
                "port": srv.port,
                "proxy_port": proxy.port if proxy is not None else None,
                "sigterm": term.is_set(),
                "transport": srv.dispatcher.summary(),
                "connections_total": srv.connections_total,
                "tenants": list(pool.tenant_names),
                "sigma": sigma,
                "weights": solves,
                "tenant_reports": tenant_reports,
                "ledger": ledger,
                "pool": pool.summary(),
            }
            if relay_summary is not None:
                report["relay"] = relay_summary
            if proxy is not None:
                report["chaos"] = proxy.schedule.summary()
    finally:
        if forwarder is not None:
            forwarder.close(forward=False)   # idempotent; the error path
        if proxy is not None:
            proxy.stop()
        if installed:
            signal.signal(signal.SIGTERM, signal.SIG_DFL)
    tr = report["transport"]
    print(f"[serve_wire] {tr['frames_handled']} frames "
          f"({tr['uploads_admitted']} uploads admitted, "
          f"{tr['frames_rejected']} rejected) over "
          f"{report['connections_total']} connections")
    print(f"[serve_wire] ledger: {ledger['wire_upload_bytes']} upload bytes "
          f"+ {ledger['wire_download_bytes']} download bytes on the wire "
          f"across {len(report['tenants'])} tenants")
    if report.get("relay") is not None:
        rs = report["relay"]
        print(f"[serve_wire] relay {rs['relay_id']}: {rs['forwards']} "
              f"upstream frames ({rs['forwarded_bytes']} bytes), "
              f"{rs['duplicate_acks']} duplicate acks, "
              f"{rs['resumed_pending']} resumed pending")
    for name, w in solves.items():
        print(f"[serve_wire] tenant {name}: |w({sigma})| = "
              f"{float(np.linalg.norm(w)):.6f}")
    if inference:
        for name, rep in report["tenant_reports"].items():
            inf = rep.get("inference")
            if inf is None:
                print(f"[serve_wire] tenant {name}: inference unavailable "
                      f"(moments-less uploads — point weights only)")
            else:
                print(f"[serve_wire] tenant {name}: n={inf['n']} "
                      f"dof={inf['dof']:.2f} sigma2={inf['sigma2']:.6g} "
                      f"max stderr={max(rep['stderr']):.6g} "
                      f"({int(round(inf['level'] * 100))}% CI served)")
    print(f"[serve_wire] launches {json.dumps(gram.launch_counts())}")
    print(f"[serve_wire] report {json.dumps(report)}", flush=True)
    return report


def make_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--mode", choices=["model", "fusion", "relay"],
                    default="model")
    ap.add_argument("--arch", choices=list(configs.ARCH_IDS))
    ap.add_argument("--reduced", action=argparse.BooleanOptionalAction,
                    default=True, help="the reduced same-family config "
                    "(default) or, with --no-reduced, the full one")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen-tokens", type=int, default=32)
    ap.add_argument("--dim", type=int, default=128)
    ap.add_argument("--tenants", type=int, default=8)
    ap.add_argument("--clients", type=int, default=4,
                    help="clients per tenant (each tenant is its own "
                         "fusion problem)")
    ap.add_argument("--samples", type=int, default=128,
                    help="samples per client per tenant")
    ap.add_argument("--queries", type=int, default=256)
    ap.add_argument("--sharded-tenants", type=int, default=2,
                    help="pin the first N tenants to the pool's shared mesh "
                         "(8 shards over every visible card for --device "
                         "cuda, on the one device for cuda:0 or cpu)")
    ap.add_argument("--auto-tenants", type=int, default=2,
                    help="place the next M tenants by server/select.py "
                         "(dense: no crossover table)")
    ap.add_argument("--sketched-tenants", type=int, default=0,
                    help="make the N tenants before the rff ones §IV-F "
                         "sketched: m-space uploads (K3), m-space solves, "
                         "the Prop-3 bound in the report")
    ap.add_argument("--rff-tenants", type=int, default=0,
                    help="make the last M tenants random-Fourier-feature "
                         "tenants (D-space uploads on K4 and solves; D may "
                         "exceed --dim)")
    ap.add_argument("--feature-dim", type=int, default=16, metavar="M",
                    help="feature count of sketched / rff tenants (sketch m "
                         "is clamped to --dim)")
    ap.add_argument("--lengthscale", type=float, default=1.0,
                    help="RBF lengthscale of --rff-tenants")
    ap.add_argument("--stream-deltas", type=int, default=0,
                    help="queue N single-row deltas through the coalescers "
                         "with NO reads; the pool's background flusher is "
                         "the only staleness clock")
    ap.add_argument("--coalesce-rank", type=int, default=32,
                    help="coalescer flush threshold (update rank per flush)")
    ap.add_argument("--flush-staleness", type=float, default=0.05,
                    help="per-tenant max_staleness_s the background "
                         "flusher enforces")
    ap.add_argument("--max-warm", type=int, default=None,
                    help="LRU bound on tenants with resident factor caches")
    ap.add_argument("--listen", type=int, default=None, metavar="PORT",
                    help="serve the fed.wire protocol over TCP instead of "
                         "the in-process loop (0 = ephemeral port, printed)")
    ap.add_argument("--expect-uploads", type=int, default=0,
                    help="with --listen: exit once this many upload frames "
                         "were admitted and all connections closed")
    ap.add_argument("--serve-timeout", type=float, default=30.0,
                    help="with --listen: hard deadline in seconds")
    ap.add_argument("--sigma", type=float, default=0.1,
                    help="with --listen: sigma of the final per-tenant "
                         "report solve")
    ap.add_argument("--inference", action="store_true",
                    help="with --listen: print each tenant's federated "
                         "inference summary (noise estimate, dof, stderr); "
                         "tenants whose uploads carried no MOMENTS section "
                         "report 'unavailable'")
    ap.add_argument("--ci-level", type=float, default=0.95,
                    help="two-sided coverage of the served confidence and "
                         "prediction intervals")
    ap.add_argument("--solve-window", type=float, default=None,
                    metavar="SECONDS",
                    help="with --listen: micro-batching window on the SOLVE "
                         "path (concurrent queries within it share one "
                         "stacked sweep; a lone request never waits)")
    ap.add_argument("--journal-dir", type=str, default=None, metavar="DIR",
                    help="with --listen: write-ahead journal and snapshot "
                         "directory; every admitted frame is journaled "
                         "before it fuses, and a restart on the same DIR "
                         "restores the state bitwise with zero re-uploads")
    ap.add_argument("--snapshot-every", type=int, default=None, metavar="N",
                    help="with --journal-dir: snapshot and compact after "
                         "every N journaled frames (default: at shutdown)")
    ap.add_argument("--no-journal-fsync", action="store_true",
                    help="skip the fsync of each journal append (faster; the "
                         "crash window widens to the OS's writeback)")
    for fault in ("drop", "corrupt", "kill", "duplicate", "reorder",
                  "delay", "drop-reply"):
        ap.add_argument(f"--chaos-{fault}", type=float, default=0.0,
                        metavar="RATE",
                        help=f"with --listen: per-frame {fault} probability "
                             f"injected by the chaos proxy")
    ap.add_argument("--chaos-rate", type=float, default=0.0, metavar="RATE",
                    help="with --listen: set EVERY chaos fault to RATE")
    ap.add_argument("--chaos-delay-s", type=float, default=0.005,
                    help="injected latency per delay fault")
    ap.add_argument("--chaos-seed", type=int, default=0,
                    help="seed of the chaos proxy's fault schedule")
    ap.add_argument("--upstream", type=str, default=None, metavar="HOST:PORT",
                    help="with --mode relay: the parent aggregator to "
                         "forward fused per-tenant delta frames to")
    ap.add_argument("--relay-id", type=str, default="relay0",
                    help="stable relay identity stamped into forwarded "
                         "frames (the upstream dedup key; unique per relay)")
    ap.add_argument("--forward-every", type=int, default=32, metavar="N",
                    help="forward a tenant after N admitted upload frames")
    ap.add_argument("--forward-staleness", type=float, default=None,
                    metavar="SECONDS",
                    help="also forward once the oldest unforwarded "
                         "admission is this old")
    ap.add_argument("--forward-interval", type=float, default=0.25,
                    metavar="SECONDS",
                    help="relay poller period (how often the forwarding "
                         "policy is evaluated)")
    ap.add_argument("--relay-state-dir", type=str, default=None, metavar="DIR",
                    help="durable forward-state directory (default: "
                         "<journal-dir>/relay_state)")
    ap.add_argument("--max-chunk-payload", type=int, default=None,
                    metavar="BYTES",
                    help="stream forwarded frames larger than BYTES of "
                         "payload as continuation chunks")
    ap.add_argument("--device", default="cuda")
    return ap


def _chaos_config(args):
    """The chaos proxy's config from the ``--chaos-*`` flags, or None."""
    from repro_torch.fed.chaos import ChaosConfig

    if args.chaos_rate > 0:
        return ChaosConfig.uniform(args.chaos_rate, delay_s=args.chaos_delay_s)
    rates = {f: getattr(args, f"chaos_{f}")
             for f in ("drop", "corrupt", "kill", "duplicate", "reorder",
                       "delay", "drop_reply")}
    if any(r > 0 for r in rates.values()):
        return ChaosConfig(**rates, delay_s=args.chaos_delay_s)
    return None


def main(argv=None) -> None:
    ap = make_parser()
    args = ap.parse_args(argv)
    if args.mode == "relay" and args.upstream is None:
        ap.error("--mode relay requires --upstream HOST:PORT")
    if args.mode == "relay" or (args.mode == "fusion"
                                and args.listen is not None):
        # a relay listens even without --listen (an ephemeral port)
        serve_wire(port=args.listen or 0, expect_uploads=args.expect_uploads,
                   timeout_s=args.serve_timeout, sigma=args.sigma,
                   inference=args.inference, ci_level=args.ci_level,
                   coalesce_rank=args.coalesce_rank,
                   flush_staleness_s=args.flush_staleness,
                   max_warm=args.max_warm, solve_window_s=args.solve_window,
                   journal_dir=args.journal_dir,
                   snapshot_every=args.snapshot_every,
                   journal_fsync=not args.no_journal_fsync,
                   chaos=_chaos_config(args), chaos_seed=args.chaos_seed,
                   upstream=args.upstream if args.mode == "relay" else None,
                   relay_id=args.relay_id,
                   forward_every=args.forward_every,
                   forward_staleness_s=args.forward_staleness,
                   forward_interval_s=args.forward_interval,
                   relay_state_dir=args.relay_state_dir,
                   max_chunk_payload=args.max_chunk_payload,
                   device=args.device)
        return
    if args.mode == "fusion":
        _print_fusion(serve_fusion(
            dim=args.dim, tenants=args.tenants, num_clients=args.clients,
            samples_per_client=args.samples, queries=args.queries,
            sharded_tenants=args.sharded_tenants,
            auto_tenants=args.auto_tenants,
            sketched_tenants=args.sketched_tenants,
            rff_tenants=args.rff_tenants, feature_dim=args.feature_dim,
            lengthscale=args.lengthscale, stream_deltas=args.stream_deltas,
            coalesce_rank=args.coalesce_rank,
            flush_staleness_s=args.flush_staleness, max_warm=args.max_warm,
            device=args.device))
        return
    if args.arch is None:
        ap.error("--arch is required for --mode model")
    res = serve(args.arch, reduced=args.reduced, batch=args.batch,
                prompt_len=args.prompt_len, gen_tokens=args.gen_tokens,
                device=args.device)
    print(f"[serve] {res['arch']}: prefill {res['prefill_s']:.2f}s, "
          f"decode {res['decode_tok_per_s']:.1f} tok/s "
          f"(batch {args.batch})")
    print(f"[serve] sample continuation: {res['generated'][0][:16].tolist()}")


if __name__ == "__main__":
    main()
