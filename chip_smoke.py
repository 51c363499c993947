#!/usr/bin/env python3
"""On-card smoke test of the PyTorch / CUDA port (``src/repro_torch``).

Run from the root of a checkout on a machine with one NVIDIA card:

    python3 chip_smoke.py

It builds the port's CUDA kernels from ``src/repro_torch/csrc`` (nvcc,
sm_90a), holds each against its plain PyTorch version on the card, then
drives its paths through the port's public entry points, each with the
kernels' launch counts set to 0 just before it and read just after:

- the dense main path at d = 4096, K = 8 clients of 16384 rows each,
  float32 (one-shot, engine, streamed rows, drop/restore, inference); the
  streamed rows' factor updates must launch P on every panel and K2 on
  every panel but the last, and a profiled rank-64 update must run them
  as P, K2 pairs with no other kernel between;
- Algorithm 2 and the paper's baselines on the same data
  (``private_federation``): DP one-shot with the PSD repair on 4 of the 8
  clients, each client's upload equal to its K1 statistics plus its
  threefry noise bitwise and the fused noise against a float64 rebuild, the
  repair equal to ``psd_repair`` of the unrepaired fused Gram, the pool's
  Remark-4 guard firing on those uploads and not on clean ones; CG on the
  8 clients' fused statistics against float64 with its residual bound;
  FedAvg and FedProx over the 8 clients; the paper's own configuration
  (``configs.RIDGE``) through one-shot, the baselines, DP one-shot with and
  without the repair and DP-FedAvg;
- the §IV-F feature tenants at full width: a Gaussian sketch of the same
  data to m = 1024 and random Fourier features (D = 4096) of d = 128 data,
  each through Phase 1 on kernels K3 / K4, the packed upload, the engine in
  the m-dimensional solve space, streamed featurized rows and inference;
  plus ``run_one_shot_projected``;
- the serving pool (``server.pool.EnginePool``) at the same width: first
  ``launch.serve.serve_fusion`` with 6 tenants of 8 x 16384 rows (4 dense,
  one sketched and one rff of feature dim 1024), 256 queries against a cold
  solve per query and 256 streamed rows drained by the background flusher,
  each tenant held to a float64 solve of its rows; then a pool of the main
  path's 8 clients (4 dense tenants of 5 clients, the feature phase's
  sketch and rff tenants) whose ``solve_many`` lanes and ``SolveBatcher``
  answers (8 threads) must equal the lone solves bitwise, with LRU eviction
  at ``max_warm=2``, the flusher draining a producer thread's rows, and the
  stacked sweep timed against lone solves and one batched
  ``torch.cholesky_solve``;
- federated uploads over TCP (``fed.wire``, ``fed.transport``,
  ``fed.chaos``) into a pool on the card at the same width: the main path's
  8 clients' STATS frames through a ``FrameServer`` on 127.0.0.1 (one
  negotiated to bf16, one with moments, one in 4 MiB chunks), fused bitwise
  as in-process admission fuses them; 256 single-row DELTA frames and a
  CONTROL drop and restore (P and K2); the feature tenants' 8 PROJ (K3) and
  8 RFF (K4) frames; the same uploads through a ``ChaosProxy`` at rate 0.1,
  fused to a clean pool's bits; 64 SolveFrame round trips without and with
  the ``SolveBatcher`` window;
- the server and its clients as processes on the card, at the same width:
  ``python -m repro_torch.launch.serve --listen --journal-dir`` and 9
  ``python -m repro_torch.launch.client`` processes (8 at once, one of them
  bf16 on a tenant of its own, one with moments, one in 4 MiB chunks; then
  a delta-row client that solves), held to a float64 solve of the clients'
  rows; then a journaled server SIGKILLed with half a frame in flight and
  restarted on its journal, whose weights must equal bitwise those of an
  in-process pool that admitted the same frames and never crashed, with no
  upload admitted after the restart; and a SIGTERMed server whose journal
  replays no frame;
- the relay tier as processes on the card, at the same width: a root
  ``launch.serve --listen`` and two ``launch.serve --mode relay`` processes
  (r0, r1; forwards in 4 MiB chunks), 4 dense ``launch.client`` processes
  on each relay and 2 RFF ones (d 128, D 4096) on r0, all at once; r1 is
  SIGKILLed before any forward and restarts on its journal, which it
  replays and forwards with no client connection; r0 is SIGTERMed (its
  exit forwards epoch 0), restarts, takes a SOLVE and a DELTA client whose
  first 256-row frames update the cached factor (P and K2), and is
  SIGTERMed again (epoch 1, a delta). Every forwarded frame must equal the
  frame rebuilt from the relay's journal byte for byte, the root's weights
  those of an in-process pool that admits the rebuilt frames in the root's
  order bitwise, and a float64 solve of all clients' rows within 1e-4; the
  root's ledger counts relay frames only, their bytes the relays'; one
  forward's steps (the copy to the host, the delta, the encoding, the
  state commit, the upload) are timed in process on r0's restored state;
- the sharded backend (``server.distributed.ShardedBackend``) on a (4, 2)
  mesh of 8 shards all on the card, at the main path's data: block size
  256, so 16 block columns of 1024 x 2048 blocks; ``run_one_shot(mesh=)``
  against the dense weights and float64; an engine of the 8 clients (the
  4-sigma ``solve_batch``, each factor 56 SYRK and 15 TRSM launches of K2;
  256 streamed rows at rank 64 and a 64-row client ingested, dropped and
  restored, all through the tiles' factor update, P and K2, with no
  refactorization); a CG solve; ``ingest_distributed`` of all rows with a
  mesh client masked (4 K1); ``serve_fusion`` with 2 sharded and 2 auto
  tenants on one mesh; ``distributed_stats`` with the DP noise hook at d
  1024, each mesh client's statistics its K1 statistics plus its noise
  bits; K2 at the four sharded tile shapes (SYRK, TRSM, trailing update,
  the tile's composition) against ``addmm``, by wrapper and device time,
  and the tile's composed P against the plain loop (``sharded_serving``);
- gemma3-27b serving at full width (d_model 5376, 32 heads over 16 KV heads,
  d_ff 21504, vocab 262144, bf16), depth cut to 2 stages + the 2-layer SWA
  tail (14 layers: 12 sliding-window, 2 full), random weights from a seed:
  a batch of 4 prompts of 4096 tokens prefilled (every attention layer on
  kernel K5), then 32 greedy tokens decoded; then a one-shot linear probe
  of that model's frozen per-token features (4 clients of 2 x 1024 tokens,
  K5 in every layer), the fused head within 1e-3 of a float64 centralized
  solve, then again on a (4, 2) mesh of the card, 2 prompts a mesh client;
- the attention-only model zoo at full width, one model on the card at a
  time after gemma3's is freed, random bf16 weights from a seed, each
  config of the registry with only its depth cut: mixtral-8x22b (4 of 56
  layers; 8 experts top-2, window 4096) on 2 prompts of 8192 tokens, 32
  tokens, served twice with bitwise equal tokens, each layer's dropped
  share at capacity 1.25 and a profiler split of one prefill (K5, the
  expert ``bmm``s, routing, dispatch and combine, the rest);
  phi3.5-moe-42b-a6.6b (4 of 32; 16 experts), qwen2-72b (8 of 80),
  yi-9b (all 48) and minitron-8b (all 32) on one prompt of 4096 tokens,
  and pixtral-12b (all 40) on 256 random patch embeddings before 3840
  tokens, 8 tokens; each with its parameter count, K5 once a layer per
  prefill and never in decode, and decode consistency (the MoE configs at
  the dropless capacity E / k, again in float32 if a bf16 routing tie
  flips the last token's experts); jamba-1.5-large's first 5 of 72 layers
  (Mamba and MoE, then its attention layer) on one prompt of 4096 tokens;
  rwkv6-1.6b whole (all 24 layers, attention-free: no K5) on 4 prompts of
  4096 tokens, 32 tokens, with a profiler split of one prefill (the WKV's
  device ms and launches a layer), then served once more on one prompt of
  32768 tokens, 8 tokens, its decode state the same bytes a layer at 4096
  and at 32768 positions; then hubert-xlarge (all 48 layers,
  encoder-only, head_dim 80, non-causal) on 4 clips of 1500 random frame
  embeddings: one ``encode_step`` with K5 once a layer and nothing else,
  bitwise repeated, against a float32 copy of the model, and a changed
  last frame moving frame 0's logits. K5 is also held to its plain version
  at every prefill shape of the zoo: mixtral's (B 2, S 8192, H 48 over 8,
  window 4096), qwen2's (B 1, S 4096, H 64 over 8, causal), phi3.5-moe's,
  minitron's and pixtral's (H 32 over 8), yi's (H 32 over 4) and hubert's
  (B 4, S 1500, H 16 over 16, hd 80, non-causal; also in float32), and
  the train phase's (B 2, S 4096, H 32 over 4); the zoo and train phases
  fail on a shape that is not among them;
- training (``train``), after the zoo: the attention's gradient (K5's
  forward, the port's backward ``ref.swa_attention_bwd``) against
  autograd through K5's plain version at yi's training shape, gemma's
  windowed one and hubert's, in float32 (checked) and bf16 (reported);
  then yi-9b at full width cut to 8 of 48 layers (bf16, 1.91 G params,
  float32 master weights and moments) trained for 8 steps of
  ``make_train_step`` with every stage recomputed, on 2 x 4096 tokens of
  the port's pipeline: losses finite and falling, K5 twice a layer a step
  and no other kernel, step time, tokens/s, the forward + backward and
  AdamW split by CUDA events, peak memory over the dry-run's bytes of the
  step's arguments, mfu, and one profiled step's idle share and shares of
  the attention backward, AdamW and K5; then ``python -m
  repro_torch.launch.train`` on the reduced config as a process, whose
  loss must fall;
- the dry-run (``dryrun``), after training: ``python -m repro_torch.launch.dryrun
  --all --card --memory-only`` as a process over every (config x input
  shape) on the one-card mesh, 33 OK and the reference's 7 skips, yi-9b's
  train_4k in cost mode and ``python -m repro_torch.launch.roofline``'s
  table; the dry-run's parameter bytes of every model built above at full
  width (gemma3-27b's cut, the zoo's, yi-9b's training cut, and for
  training AdamW's state and the arguments) equal to the byte to what the
  phases measured; the roofline of the train phase's step beside its
  measured time; then the probe example (``examples/train_probe_e2e_torch.py``)
  at its defaults in process: its one-shot head within 1e-3 of the
  centralized one, K1 once and K5 twice a layer a step and once a layer a
  client, K1 and K5 then held to their plain versions at its shapes;
- the examples (``examples``), last, in process: ``examples/quickstart_torch.py``
  at its defaults (20 clients x 500 rows, d 100) and its steps at the main
  path's width (d 4096, 8 x 16384 rows), one-shot within 1e-4 of
  centralized and the Thm-8 dropout run of a float64 solve of the
  survivors' rows; ``examples/private_federation_torch.py`` at its
  defaults, its failed cells and MSEs those of the same example on a CPU
  copy of the data; ``examples/serve_batched_torch.py`` at its defaults
  (reduced mixtral), K5 then held to its plain version at that prefill's
  shape; K1 and K5 launched as often as the examples' code implies; and
  ``launch.mesh.psum_scatter`` on a mesh of ``cuda:0`` and ``cpu``, each
  slice on its shard's device.

Results are checked against float64 references, and the model against the
plain attention inside it (decode) and K5's plain version. It prints one JSON line
per phase, then the kernel table, the card's name and power limit, and as
the last line ``{"ok": true, "device": {...}}``. Any failure raises and
exits non-zero; so does a machine without a CUDA card, and a directory
without the port.
"""
from __future__ import annotations

import dataclasses
import gc
import json
import math
import os
import signal
import socket
import subprocess
import sys
import threading
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
# §IV-F feature tenants: a sketch of the dense data to m = 1024, and RFF on
# d = 128 data at D = 4096 with the unit-variance lengthscale sqrt(d).
SKETCH_M = 1024
RFF_DIM, RFF_M = 128, 4096
FEATURE_SEED = 11
FEATURE_STREAM_ROWS = 64

# The serving pool. (a) serve_fusion: 6 tenants of the main path's size (4
# dense, then 1 sketched and 1 rff of feature dim 1024, lengthscale sqrt(d)),
# 4 sigmas each, 256 queries of 8 rows, 256 streamed single rows at
# coalesce rank 32 with a 2 s staleness bound (the coalescer's rank, not the
# timer, drives the flushes). (b) a pool of the main path's 8 clients: 4
# dense tenants of 5 clients each, the feature phase's sketch and rff
# tenants; a SolveBatcher burst; LRU eviction; the background flusher.
POOL_TENANTS, POOL_FEATURE_DIM = 6, 1024
POOL_QUERIES, POOL_STREAM, POOL_COALESCE, POOL_STALENESS = 256, 256, 32, 2.0
POOL_SUBSETS = ((0, 1, 2, 3, 4), (1, 3, 5, 6, 7), (0, 2, 4, 6, 7), (3, 4, 5, 6, 7))
BATCHER_THREADS, BATCHER_REQUESTS, BATCHER_WINDOW = 8, 16, 0.002
FLUSH_ROWS, FLUSH_CHUNK, FLUSH_RANK, FLUSH_STALENESS = 256, 16, 64, 0.05
STACKED_T = (4, 16)

# The wire: the main path's 8 clients upload STATS frames over TCP to a
# FrameServer on 127.0.0.1 (client 6 negotiated to bf16, client 3 with
# moments, client 7 in 4 MiB chunks), 256 single-row DELTA frames, one
# CONTROL drop and restore, the feature tenants' PROJ and RFF frames, the
# same uploads through a ChaosProxy at rate 0.1, and 64 SolveFrame round
# trips from 8 connections without and with the SolveBatcher window.
WIRE_BF16_CLIENT, WIRE_MOMENTS_CLIENT, WIRE_CHUNK_CLIENT = 6, 3, 7
WIRE_CHUNK, WIRE_STREAM = 4 << 20, 256
WIRE_CHAOS_RATE, WIRE_CHAOS_SEED = 0.1, 7
WIRE_SOLVES, WIRE_SOLVE_THREADS = 64, 8

# The server as a process: `python -m repro_torch.launch.serve --listen
# --journal-dir` and `python -m repro_torch.launch.client` processes on the
# card. 9 clients of the shared dataset (seed PROC_SEED): 8 at once on
# tenant "ridge" (client 3 with moments, client 5 in 4 MiB chunks) and
# client 6 bf16 on its own tenant "lowp", then client 8 streams its rows as
# 4 DELTA frames and solves. Then a server is SIGKILLed with half a frame in
# flight and restarted on its journal, and another one is SIGTERMed.
PROC_CLIENTS, PROC_SEED = 9, 0
PROC_MOMENTS_CLIENT, PROC_CHUNK_CLIENT, PROC_BF16_CLIENT = 3, 5, 6
PROC_DELTA_BATCHES, PROC_CHUNK = 4, 4 << 20
PROC_TIMEOUT = 300                  # every subprocess wait, seconds

# The relay tier: a root `serve --mode fusion` and two `serve --mode relay`
# processes (r0, r1; forwards in 4 MiB chunks, no forward by the poller's
# size trigger) on the card. 4 dense clients on each relay (tenant "ridge",
# the process phase's dataset), 2 RFF clients on r0 (tenant "rff", the
# feature phase's d 128, D 4096), then a DELTA client on r0 in 256-row
# frames into a factor the phase has cached (P and K2), forwarded as r0's
# second epoch. r1 is SIGKILLed before any forward and restarted on its
# journal; r0 is SIGTERMed after its first wave, restarted, and SIGTERMed
# again; the root is SIGTERMed last.
RELAY_DENSE, RELAY_RFF = 4, 2
RELAY_DELTA_BATCHES, RELAY_CHUNK = 64, 4 << 20
RELAY_FORWARD_EVERY = 1 << 20       # the phase causes every forward
RELAY_SERVE_TIMEOUT = 900           # a server that the phase ends by signal

# gemma3-27b serving: the registry's config with 2 stages instead of 10
# (14 layers instead of 62; 17.2 GB of bf16 weights), batch 4 x 4096-token
# prompts (4x the 1024-token window), 32 greedy tokens.
MODEL_ARCH, MODEL_STAGES = "gemma3-27b", 2
MODEL_BATCH, MODEL_PROMPT, MODEL_GEN = 4, 4096, 32
MODEL_SEED = 0

# The model zoo (the zoo_serving phase), after the gemma3 model is freed:
# each config from the registry cut in depth only to its first layers
# (``depth_cut``), random bf16 weights from ZOO_SEED. Per arch: layers on
# the card, prompts, prompt length (text tokens; pixtral's 256 patches come
# before them), generated tokens. Mixtral's prompts are twice its
# 4096-token window, so it masks. jamba's first 5 of 72 layers (Mamba +
# dense, Mamba + MoE, twice, then attention + dense; 48.09 GB) are the
# shortest prefix that reaches its attention layer. rwkv6-1.6b is whole (24
# layers, 3.16 GB) at gemma3's serve shape.
ZOO_RUNS = (("mixtral-8x22b", 4, 2, 8192, 32),
            ("phi3.5-moe-42b-a6.6b", 4, 1, 4096, 8),
            ("qwen2-72b", 8, 1, 4096, 8),
            ("yi-9b", 48, 1, 4096, 8),
            ("minitron-8b", 32, 1, 4096, 8),
            ("pixtral-12b", 40, 1, 3840, 8),
            ("jamba-1.5-large-398b", 5, 1, 4096, 8),
            ("rwkv6-1.6b", 24, 4, 4096, 32))
# The attention-free config whole once more at one prompt of the
# prefill_32k input shape's length (a multiple of its chunk of 64), 8
# tokens: its decode state is the same bytes a layer as at 4096.
LONG_ARCH, LONG_BATCH, LONG_GEN = "rwkv6-1.6b", 1, 8
# The encoder (hubert-xlarge, whole): clips, frames (30 s at HuBERT's 50 Hz
# frame rate, arXiv:2106.07447).
ENCODE_ARCH, ENCODE_BATCH, ENCODE_FRAMES = "hubert-xlarge", 4, 1500
ZOO_SEED = 0
# K5 at every zoo shape that zoo_serving's prefills and encode give it, in
# the kernel phase: B, S, H, H_kv, hd, window, causal. phi3.5-moe,
# minitron and pixtral (256 patches + 3840 tokens) share one; jamba's
# attention layer is qwen2's.
SWA_ZOO_SHAPES = {"mixtral": (2, 8192, 48, 8, 128, 4096, True),
                  "qwen2": (1, 4096, 64, 8, 128, None, True),
                  "phi35_minitron": (1, 4096, 32, 8, 128, None, True),
                  "yi": (1, 4096, 32, 4, 128, None, True),
                  "hubert": (4, 1500, 16, 16, 80, None, False),
                  # the train phase's forward (B 2 x S 4096, yi's heads)
                  "yi_train": (2, 4096, 32, 4, 128, None, True)}

# Training (the train phase), after the zoo: yi-9b at full width cut in
# depth to its first 8 of 48 layers (1,908,477,952 parameters; bf16
# weights and grads, float32 master, m and v: 30.5 GB), B 2 x S 4096 tokens
# from the port's TokenPipeline (seed 0), 8 steps of make_train_step with
# every stage recomputed in the backward (K5 twice a layer a step), AdamW
# under the schedule of the reference's launch/train.py (warmup
# max(steps // 20, 5)) at a peak learning rate of its 3e-4 scaled by
# 256 / d_model (the
# reduced configs' width, where 3e-4 trains): Adam's first steps move a
# d-wide product by ~lr * d, and at d 4096 the unscaled 3e-4 took the loss
# from 11.66 up to 13.60 in 8 steps on an H100 (PERF.md §6), as wider
# models spike under the reference's own train loop: at d 2048 in float32
# and at this width in bf16 (one layer) both packages rise step for step
# (tests/test_torch_train_wide.py). The
# attention's gradient (K5 forward, ``ref.swa_attention_bwd`` backward) is
# held to autograd through K5's plain version at yi's training shape and
# at two of the kernel phase's (gemma's windowed one, hubert's non-causal
# hd 80 one): float32 within TRAIN_GRAD_TOL relative Frobenius. Then the
# train CLI as a process on the reduced config: its loss must fall.
TRAIN_ARCH, TRAIN_LAYERS, TRAIN_BATCH, TRAIN_SEQ = "yi-9b", 8, 2, 4096
TRAIN_STEPS, TRAIN_SEED, TRAIN_GRAD_TOL = 8, 0, 1e-5
TRAIN_LR_REDUCED = 3e-4               # launch/train.py's default, at d_model 256
TRAIN_CLI = ("--arch", "yi-9b", "--reduced", "--steps", "20", "--batch", "8",
             "--seq", "128")

# The dry-run (the dryrun phase), after training: ``launch.dryrun --all
# --card --memory-only`` over the whole (config x input shape) matrix on the
# one-card mesh (33 combinations and the reference's 7 skips), then the cost
# mode of DRYRUN_COSTED (the matrix's cost sweep takes many minutes of host
# time on meta: jamba's train_4k alone ~3 min), then ``launch.roofline``
# over the records, under build/ (removed after). Then the probe example
# (examples/train_probe_e2e_torch.py) in process at its defaults: reduced
# yi-9b (2 layers, float32) trained for EXAMPLE_STEPS steps, then
# EXAMPLE_CLIENTS clients' features; K5 twice a layer a step (remat) and
# once a layer a client, K1 once (the centralized head).
DRYRUN_COSTED = (("yi-9b", "train_4k"),)
EXAMPLE_STEPS, EXAMPLE_CLIENTS, EXAMPLE_ROWS = 200, 8, 16
# The examples (the examples phase), last: quickstart, private_federation
# and serve_batched in process at their defaults (the reference's 20
# clients x 500 rows, d 100; reduced mixtral at batch 4, prompt 48, 24
# tokens), then quickstart's steps at the main path's width (DIM, CLIENTS,
# ROWS). private_federation is not run at d 4096: each DP client's host
# draw of d x d noise takes 10-15 s there and the example makes 41 a budget
# for 5 budgets; the private_federation phase covers Algorithm 2 at d 4096.
EXAMPLES_CLIENTS, EXAMPLES_ROWS, EXAMPLES_DIM = 20, 500, 100

# Algorithm 2 and the paper's baselines (the private_federation phase), on
# the main path's data: DP one-shot (eps 1, delta 1e-5, key 7) on 4 of its
# 8 clients (each client's d x d noise is drawn on the host, ~8 s at d
# 4096), the pool's Remark-4 guard, CG with 100 iterations, FedAvg and
# FedProx (mu 0.01) for 200 rounds of 5 epochs at lr 0.01; then the paper's
# own configuration (configs.RIDGE) with DP at eps 1, 5, 10; then a one-shot
# probe of the served gemma3-27b: 4 clients of 2 prompts x 1024 tokens,
# per-token final-norm features, targets with 1 and 4 columns, sigma set
# so that the float64 kappa(G + sigma I) is 1e3.
PRIV_DP_CLIENTS, PRIV_EPS, PRIV_DELTA, PRIV_KEY = 4, 1.0, 1e-5, 7
PRIV_CG_ITERS = 100
PRIV_ROUNDS, PRIV_EPOCHS, PRIV_LR, PRIV_MU = 200, 5, 0.01, 0.01
PRIV_EPS_GRID, PRIV_RIDGE_SEED = (1.0, 5.0, 10.0), 0
PROBE_CLIENTS, PROBE_PROMPTS, PROBE_LEN, PROBE_TARGETS = 4, 2, 1024, 4
PROBE_SEED, PROBE_KAPPA = 1, 1e3

# The sharded backend (the sharded_serving phase), on the main path's data:
# a (4, 2) mesh of 8 shards, all on cuda:0 (block size 256 at d 4096, 16
# block columns, blocks of 1024 x 2048). run_one_shot on the mesh; an engine
# of the 8 clients on a ShardedBackend (the 4-sigma solve_batch, 256
# streamed rows at coalescer rank 64, a 64-row client ingested, dropped and
# restored, all through the factor update: P and K2 on the tiles); a CG
# solve; ingest_distributed of all rows with mesh client 1 masked out;
# serve_fusion with 2 sharded and 2 auto tenants (threshold d, so the auto
# ones place sharded) of 4 clients x 4096 rows; distributed_stats with the
# DP noise hook at d 1024 (8192 rows a mesh client); K2 at the four
# sharded tile shapes against addmm, and the tile's composed P against the
# plain loop. Sharded solves are unrefined, as the reference's; besides the
# solves, every factor the phase leaves cached (cold, streamed, after the
# drop and after the restore) is held itself: ||tril(L) tril(L)^T - (G +
# sigma I)||_F / ||G + sigma I||_F <= SHARD_FACTOR_TOL, in float64.
SHARD_DEVICES, SHARD_RANK, SHARD_SMALL_ROWS = 8, 64, 64
SHARD_FACTOR_TOL = 1e-5
SHARD_SERVE_TENANTS, SHARD_SERVE_CLIENTS, SHARD_SERVE_ROWS = 4, 4, 4096
SHARD_SERVE_QUERIES, SHARD_SERVE_STREAM = 64, 64
SHARD_DP_DIM, SHARD_DP_ROWS = 1024, 8192

# K1's, K3's, K4's and K5's times on their earlier CUDA-core routines,
# quoted from PERF.md §6 (NVIDIA H100 80GB HBM3, 700.00 W). They are not
# measured by this script: its output keeps them apart, under
# "quoted_not_measured", beside the speed-up of this run's time over them.
EARLIER_MS = {"gram_moment": 13.210, "sketch_gram": 61.828, "rff_gram": 46.670,
              "swa_flash": {"swa": 7.880, "full": 17.252}}
EARLIER_FROM = "PERF.md §6, CUDA-core routines, NVIDIA H100 80GB HBM3, 700.00 W"


def quoted_earlier(earlier_ms: float, ms: float) -> dict:
    """An earlier design's time, quoted and labelled, and this run's speed-up."""
    return {"quoted_not_measured": {"earlier_ms": earlier_ms, "from": EARLIER_FROM},
            "speedup_vs_quoted": earlier_ms / ms}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


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


def burst_ms(launch, count: int) -> float:
    """CUDA-event time of ``count`` back-to-back calls of ``launch``, over
    ``count``: a kernel's device time once launches outpace it."""
    launch()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(count):
        launch()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / count


def bare_entry(K, name: str):
    """The ctypes entry of kernel ``name`` on the current stream, called
    without the wrapper's checks and allocations."""
    _, fn = K._fn(name)
    stream = torch.cuda.current_stream().cuda_stream

    def call(*args):
        rc = fn(*args, stream)
        if rc != 0:
            raise RuntimeError(f"{name} launch failed ({rc})")
    return call


def p_bare(K, L11: torch.Tensor, X1: torch.Tensor, reps: int):
    """P's device time (a burst of ``reps`` bare launches in place on a copy
    of L11) and its split by phase (clock64 stamps of CTA 0 in one more
    launch): staging L11, the wavefront of 2 bw + r - 1 steps, the stores;
    each as cycles and as its share of that launch's event time."""
    bw, r = X1.shape[1], X1.shape[0]
    w = bw + r
    T = torch.empty(w, w, dtype=L11.dtype, device=L11.device)
    arrivals = torch.zeros(1, dtype=torch.int32, device=L11.device)
    stamps = torch.zeros(4, dtype=torch.int64, device=L11.device)
    work = L11.clone()
    call = bare_entry(K, "panel_transform")
    args = [work.data_ptr(), bw, X1.data_ptr(), bw, T.data_ptr(),
            arrivals.data_ptr(), None, bw, r, 1.0, K._FLOAT_DTYPES[L11.dtype]]
    device_ms = burst_ms(lambda: call(*args), reps)
    args[6] = stamps.data_ptr()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    call(*args)
    end.record()
    end.synchronize()
    names = ("stage", "wavefront", "store")
    cyc = np.diff(stamps.cpu().numpy())
    launch_ms = start.elapsed_time(end)
    total = max(int(cyc.sum()), 1)
    phases = {"cycles": dict(zip(names, map(int, cyc))),
              "ms": {n: launch_ms * int(c) / total for n, c in zip(names, cyc)},
              "cycles_per_step": int(cyc[1]) / (2 * bw + r - 1)}
    return device_ms, phases


def k2_bare(K, L: torch.Tensor, X: torch.Tensor, T: torch.Tensor, c0: int = 0):
    """One bare in-place launch of K2's panel entry on the panel at c0 of
    width 32 (T: (32 + r, 32 + r)), as ``chol_update_blocked`` makes it."""
    d, r, bw = L.shape[0], X.shape[0], PANEL
    c1, es = c0 + bw, L.element_size()
    call = bare_entry(K, "gemm_nt_panel")
    args = (L.data_ptr() + (c1 * d + c0) * es, d, X.data_ptr() + c1 * es, d,
            T.data_ptr(), None, d - c1, bw, bw + r, K._FLOAT_DTYPES[L.dtype])
    return lambda: call(*args)


def k2_general_bare(K, C: torch.Tensor, A: torch.Tensor, B: torch.Tensor,
                    alpha: float):
    """One bare launch of K2's general entry, O = C + alpha A B^T into a
    preallocated O, at the tile edge the wrapper would pick."""
    (m, n), k = C.shape, A.shape[1]
    O = torch.empty_like(C)
    call = bare_entry(K, "gemm_nt")
    args = (C.data_ptr(), A.data_ptr(), B.data_ptr(), O.data_ptr(), m, n, k, alpha,
            K._FLOAT_DTYPES[C.dtype], K.gemm_tile(m, n, C.dtype))
    return lambda: call(*args)


def p_work(bw: int, r: int) -> tuple[float, float]:
    """P's operations (6 a rotation) and bytes (L11 read and written, X1
    and T) on a bw-wide panel against r update rows, float32."""
    rotations = bw * (bw - 1) // 2 * r + bw * r + (bw + r) * bw * r
    return 6.0 * rotations, 4.0 * (2 * bw * bw + r * bw + (bw + r) ** 2)


def tile_transform_bound(bs: int, r: int, sub: int, peaks) -> tuple[float, str]:
    """The least time of ``composed_panel_transform`` on a bs-wide tile: the
    sum of its launches' bounds, since each waits for the last. Per
    sub-panel, P at FP32; K2's panel entry on the tile's rows below it at
    FP32 (its CUDA-core route); from the second on, the composing K2 (bs +
    r, sub + r, sub + r) at 3xTF32. ``by``: what sets most of the sum."""
    w = sub + r
    parts = []
    for c0 in range(0, bs, sub):
        parts.append(bound(*p_work(sub, r), peaks))
        below = bs - c0 - sub
        if below > 0:
            parts.append(bound(2.0 * below * w * w, 4.0 * (2 * below * w + w * w), peaks))
        if c0 > 0:
            parts.append(bound(2.0 * (bs + r) * w * w,
                               4.0 * (2 * (bs + r) * w + (bs + r) * w + w * w),
                               peaks, rate="3xtf32"))
    by = {b: sum(ms for ms, x in parts if x == b) for b in ("operations", "bytes")}
    return sum(ms for ms, _ in parts), max(by, key=by.get)


def rel_err(x: torch.Tensor, ref: torch.Tensor) -> float:
    """max |x - ref| / max |ref|, in float64."""
    x, ref = x.double(), ref.double()
    return float((x - ref).abs().max() / ref.abs().max().clamp_min(1e-300))


def bf16_ulps(o: torch.Tensor, p: torch.Tensor, floor: float = 1e-4) -> float:
    """Worst |o - p| / (2^-7 |p| + floor), element by element.

    K5 and its plain version both sum in float32 and round once to bf16, so
    an element may differ by one bf16 ulp of the plain value (at most
    2^-7 |p|) and by float32 noise (the floor). A value <= 1 passes; a mask
    off by one key moves some element of a 67M-element output by far more.
    """
    o, p = o.float(), p.float()
    return float(((o - p).abs() / (p.abs() * 2.0 ** -7 + floor)).max())


def bound(ops: float, nbytes: float, peaks, rate: str = "fp32"):
    """Least time (ms) for the work at the FP32, bf16 or 3xTF32 (a third of
    the TF32 peak) operation rate, and whether operations or bytes set it."""
    bw, fp32, bf16, tf32 = peaks
    t_ops = ops / {"fp32": fp32, "bf16": bf16, "3xtf32": tf32 / 3}[rate]
    t_bytes = nbytes / bw
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes
                                       else "bytes")


def smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


# -- phase 1: device and build -----------------------------------------------

def tensor_core_ops(lib: str) -> dict:
    """The tensor-core instructions (SASS ``HMMA``) that ``cuobjdump`` finds
    in a built library, by variant, or why there is no count."""
    tool = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    if not os.path.isfile(tool):
        return {"cuobjdump": "not found"}
    sass = subprocess.run([tool, "-sass", lib], capture_output=True, text=True).stdout
    ops = {}
    for ln in sass.splitlines():
        if "HMMA" in ln:
            op = next(w for w in ln.split() if w.startswith("HMMA"))
            ops[op] = ops.get(op, 0) + 1
    return ops


def ptxas_report(log: str) -> list[str]:
    """'kernel: N registers, M bytes spill stores' for each kernel in nvcc's
    ``-Xptxas -v`` report, names demangled by ``c++filt`` where it exists."""
    rows, name, spill = [], None, ""
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            name = ln.split("'")[1]
        elif "spill stores" in ln:
            spill = ln.split(",")[1].strip()
        elif "Used" in ln and "registers" in ln and name:
            rows.append([name, ln.split("Used ")[1].split(",")[0], spill])
            name = None
    try:
        names = subprocess.run(["c++filt"], input="\n".join(r[0] for r in rows),
                               capture_output=True, text=True, check=True).stdout.split("\n")
    except (OSError, subprocess.CalledProcessError):
        names = [r[0] for r in rows]
    return [f"{n.replace('(anonymous namespace)::', '').split('(')[0]}: {regs}, {spill}"
            for n, (_, regs, spill) in zip(names, rows)]


def device_phase() -> dict:
    from repro_torch.kernels import _build

    t0 = time.perf_counter()
    build_s = _build.build_all()
    regs = {name: ptxas_report(log) for name, log in _build.build_logs().items()}
    hmma = {name: tensor_core_ops(str(_build._build_dir() / f"lib{name}.so"))
            for name in ("swa_flash", "feature_gram", "gram_moment", "gemm_nt")}
    if "cuobjdump" not in hmma["gemm_nt"]:
        check(hmma["gemm_nt"].get("HMMA.1688.F32.TF32", 0) > 0,
              f"float32 gemm_nt is not on the tensor cores: {hmma['gemm_nt']}")
    return {"phase": "device", "nvidia_smi": smi(),
            "torch": torch.__version__, "cuda": torch.version.cuda,
            "build_s": build_s, "ptxas": regs, "sass_hmma": hmma,
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
    G64, h64 = ref.gram_moment_ref(A.double(), b.double())
    k1["G_fro_f64"], k1["h_fro_f64"] = fro_rel(G, G64), fro_rel(h, h64)
    check(k1["G_fro_f64"] <= 1e-4 and k1["h_fro_f64"] <= 1e-4, f"K1 vs float64: {k1}")
    del G64, h64
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
    # float32 K1 runs 3xTF32 on the tensor cores: its bound is at that rate;
    # the FP32 one stays in the detail
    ops, nbytes = n * d * (d + 1) + 2 * n * d, 4 * (n * d + n + d * d + d)
    bms, by = bound(ops, nbytes, peaks, rate="3xtf32")
    k1.update(tile=K.gram_tile(n, d, A.dtype), ms=ms, library_ms=lib_ms,
              tflops=ops / ms / 1e9, bound_ms_3xtf32=bms,
              bound_ms_fp32=bound(ops, nbytes, peaks)[0],
              # one streamed row as the streaming steps launch it (the
              # CUDA-core kernel for one row), then each route's launch alone,
              # in turns, 100 calls each
              row_ms=cuda_ms(lambda: K.gram_moment_cuda(A1, b1)),
              row_route_ms=row_routes(A1, b1),
              **quoted_earlier(EARLIER_MS["gram_moment"], ms))
    rows["gram_moment"] = dict(
        name="gram_moment", route="cuda",
        source="src/repro_torch/csrc/gram_moment.cu",
        replaces="src/repro/kernels/gram.py:272", max_abs_err=k1["max_abs_err"],
        ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=by, library_ms=lib_ms)
    detail["gram_moment"] = {**k1, "shape": [n, d], "tolerance": "rel 1e-4 (f32, bf16), 1e-12 (f64); float64: 1e-4 Frobenius"}
    del A, b, G, G2, Gr, Ab, Gb, Gbr, A1, b1

    # K2 as the main path launches it: the panel entry on the first trailing
    # panel of a rank-64 update, [L21 | X2^T] @ T in place (m 4064, n = k =
    # 96); then the reference's contract C + alpha A B^T on dense operands.
    m, nn, k = DIM - PANEL, PANEL + COALESCE_RANK, PANEL + COALESCE_RANK
    k2 = {}
    Lf, Xf = randn(DIM, DIM), randn(COALESCE_RANK, DIM)
    Tq = torch.linalg.qr(randn(nn, nn))[0].contiguous()      # a panel T is orthogonal
    for dt in (torch.float32, torch.float64):
        Lk, Xk = Lf.to(dt), Xf.to(dt)
        Lp, Xp = Lk.clone(), Xk.clone()
        K.panel_gemm_cuda(Lk, Xk, 0, PANEL, Tq.to(dt))
        ref.panel_gemm_ref(Lp, Xp, 0, PANEL, Tq.to(dt))
        got = torch.cat([Lk[PANEL:, :PANEL], Xk[:, PANEL:].T], dim=1)
        want = torch.cat([Lp[PANEL:, :PANEL], Xp[:, PANEL:].T], dim=1)
        key = "panel_rel" if dt == torch.float32 else "panel_f64_rel"
        k2[key] = rel_err(got, want)
        check(torch.equal(Lk[:PANEL], Lp[:PANEL]) and torch.equal(Lk[:, PANEL:], Lp[:, PANEL:])
              and torch.equal(Xk[:, :PANEL], Xp[:, :PANEL]),
              "K2's panel entry wrote outside [L21 | X2^T]")
        if dt == torch.float32:
            k2["max_abs_err"] = float((got - want).abs().max())
    # the out-of-place route: a rank-1024 update's panel (n 1056), and a
    # ragged strip (m 100 = 3 x 32 + 4)
    rw = 1024
    Lo, Xo, To = randn(DIM, DIM), randn(rw, DIM), torch.linalg.qr(randn(PANEL + rw, PANEL + rw))[0]
    Lop, Xop = Lo.clone(), Xo.clone()
    K.panel_gemm_cuda(Lo, Xo, 0, PANEL, To.contiguous())
    ref.panel_gemm_ref(Lop, Xop, 0, PANEL, To)
    k2["out_of_place_r1024_rel"] = max(rel_err(Lo, Lop), rel_err(Xo, Xop))
    del Lo, Xo, Lop, Xop
    Lr_, Xr_ = randn(164, 164), randn(64, 164)
    Lrp, Xrp = Lr_.clone(), Xr_.clone()
    K.panel_gemm_cuda(Lr_, Xr_, 32, 64, Tq)
    ref.panel_gemm_ref(Lrp, Xrp, 32, 64, Tq)
    k2["ragged_panel_rel"] = max(rel_err(Lr_, Lrp), rel_err(Xr_, Xrp))
    C, Am, Bm = torch.zeros(m, nn, device="cuda"), randn(m, k), randn(nn, k)
    O = K.gemm_nt_cuda(C, Am, Bm, alpha=1.0)
    Or = ref.gemm_nt_ref(C, Am, Bm, alpha=1.0)
    k2["rel"] = rel_err(O, Or)
    C2, A2, B2 = randn(100, 37), randn(100, 13), randn(37, 13)
    k2["ragged_rel"] = rel_err(K.gemm_nt_cuda(C2, A2, B2, alpha=-1.0),
                               ref.gemm_nt_ref(C2, A2, B2, alpha=-1.0))
    Cd, Ad2, Bd2 = (x.double() for x in (C, Am, Bm))
    k2["f64_rel"] = rel_err(K.gemm_nt_cuda(Cd, Ad2, Bd2, alpha=1.0),
                            ref.gemm_nt_ref(Cd, Ad2, Bd2, alpha=1.0))
    # k = 96 float32 products per entry, summed in two orders.
    for key in ("panel_rel", "out_of_place_r1024_rel", "ragged_panel_rel", "rel", "ragged_rel"):
        check(k2[key] <= 1e-5, f"K2 {key} = {k2[key]} > 1e-5")
    check(k2["f64_rel"] <= 1e-13 and k2["panel_f64_rel"] <= 1e-13,
          f"K2 float64 error {k2['f64_rel']}, {k2['panel_f64_rel']} > 1e-13")
    # timed in place, over and over: T is orthogonal, so values stay bounded
    Lp, Xp = Lf.clone(), Xf.clone()
    ms = cuda_ms(lambda: K.panel_gemm_cuda(Lf, Xf, 0, PANEL, Tq))
    plain_ms = cuda_ms(lambda: ref.panel_gemm_ref(Lp, Xp, 0, PANEL, Tq))
    Z = torch.cat([Lf[PANEL:, :PANEL], Xf[:, PANEL:].T], dim=1)
    Zo = torch.empty_like(Z)
    lib_ms = cuda_ms(lambda: torch.addmm(C, Z, Tq))
    k2.update(device_ms=burst_ms(k2_bare(K, Lf, Xf, Tq), 200),
              addmm_device_ms=burst_ms(lambda: torch.addmm(C, Z, Tq, out=Zo), 200),
              general_ms=cuda_ms(lambda: K.gemm_nt_cuda(C, Am, Bm, alpha=1.0)),
              general_device_ms=burst_ms(k2_general_bare(K, C, Am, Bm, 1.0), 200),
              general_tile=K.gemm_tile(m, nn, torch.float32),
              in_place=K.panel_in_place(nn, torch.float32))
    bms, by = bound(2 * m * nn * k, 4 * (2 * m * nn + nn * k), peaks)
    rows["gemm_nt"] = dict(
        name="gemm_nt", route="cuda", source="src/repro_torch/csrc/gemm_nt.cu",
        replaces="src/repro/kernels/gram.py:86", max_abs_err=k2["max_abs_err"],
        ms=ms, device_ms=k2["device_ms"], plain_ms=plain_ms, bound_ms=bms,
        bound_by=by, library_ms=lib_ms)
    detail["gemm_nt"] = {**k2, "shape": [m, nn, k], "tolerance": "rel 1e-5 (f32), 1e-13 (f64)"}
    del Lf, Lp, Xf, Xp, Z, Zo, C, Am, Bm

    # P at the main path's panel: bw = 32 against r = 64 update rows, on a
    # diagonal panel of a real Gram's factor; once more at r = 1024.
    bw = PANEL
    M = randn(ROWS, bw)
    # torch.linalg.cholesky returns column-major strides; the kernel takes
    # row-major (chol_update_blocked works on a row-major copy).
    L11 = torch.linalg.cholesky(
        M.T @ M + SIGMA * torch.eye(bw, device="cuda")).contiguous()
    k3 = {}
    for r in (COALESCE_RANK, 1024):
        X1 = randn(r, bw)
        tag = "" if r == COALESCE_RANK else f"r{r}_"
        for sign in (1.0, -1.0):
            # the downdate removes rows that the update just added: stays PD
            base = L11 if sign > 0 else K.panel_transform_cuda(L11, X1)[0]
            Lk, Tk = K.panel_transform_cuda(base, X1, sign=sign)
            Lp, Tp = panel_transform_ref(base, X1, sign=sign)
            key = tag + ("up" if sign > 0 else "down")
            k3[f"{key}_L_rel"], k3[f"{key}_T_rel"] = rel_err(Lk, Lp), rel_err(Tk, Tp)
            k3[f"{key}_max_abs_err"] = float(max((Lk - Lp).abs().max(),
                                                 (Tk - Tp).abs().max()))
            k3[f"{key}_bitwise_plain"] = bool(torch.equal(Lk, Lp) and torch.equal(Tk, Tp))
        if r == COALESCE_RANK:
            Ld, Td = K.panel_transform_cuda(L11.double(), X1.double())
            Lpd, Tpd = panel_transform_ref(L11.double(), X1.double())
            k3["f64_rel"] = max(rel_err(Ld, Lpd), rel_err(Td, Tpd))
            k3["f64_bitwise_plain"] = bool(torch.equal(Ld, Lpd) and torch.equal(Td, Tpd))
            ms = cuda_ms(lambda: K.panel_transform_cuda(L11, X1))
            plain_ms = cuda_ms(lambda: panel_transform_ref(L11, X1))
        k3[tag + "device_ms"], k3[tag + "phases"] = p_bare(
            K, L11, X1, 200 if r == COALESCE_RANK else 20)
        if r != COALESCE_RANK:
            k3[tag + "ms"] = cuda_ms(lambda: K.panel_transform_cuda(L11, X1))
    # Same elementary operations, each rounded once; the r * bw-step chain
    # carries any difference.
    for key in ("up_L_rel", "up_T_rel", "down_L_rel", "down_T_rel", "r1024_up_L_rel",
                "r1024_up_T_rel", "r1024_down_L_rel", "r1024_down_T_rel"):
        check(k3[key] <= 1e-4, f"P {key} = {k3[key]} > 1e-4")
    check(k3["f64_rel"] <= 1e-12, f"P float64 error {k3['f64_rel']} > 1e-12")
    bms, by = bound(*p_work(bw, COALESCE_RANK), peaks)
    rows["panel_transform"] = dict(
        name="panel_transform", route="cuda",
        source="src/repro_torch/csrc/panel_transform.cu",
        replaces="src/repro/server/cholesky.py:83",
        max_abs_err=max(k3["up_max_abs_err"], k3["down_max_abs_err"]),
        ms=ms, device_ms=k3["device_ms"], plain_ms=plain_ms, bound_ms=bms,
        bound_by=by, library_ms=None)
    detail["panel_transform"] = {**k3, "shape": [bw, COALESCE_RANK], "tolerance": "rel 1e-4 (f32), 1e-12 (f64)"}
    del M, L11, X1

    for kind in ("sketch", "rff"):
        row, det = feature_kernel_row(kind, g, peaks)
        rows[row["name"]] = row
        detail[row["name"]] = det
    row, det = swa_kernel_row(g, peaks)
    rows[row["name"]] = row
    detail[row["name"]] = det
    return ({"phase": "kernels", "detail": detail,
             "seconds": time.perf_counter() - t0}, rows)


def row_routes(A1: torch.Tensor, b1: torch.Tensor) -> dict:
    """K1's two routes on one row, launched alike (``gram._gram_moment``)
    in turns: the CUDA-core kernel (tile 0), the SYRK, the SYRK, the
    CUDA-core kernel; median ms of 100 calls each."""
    from repro_torch.kernels import gram as K

    tiles = {"cuda_core": 0, "syrk": K.syrk_tile(A1.shape[1])}
    out = {name: [] for name in tiles}
    for name in ("cuda_core", "syrk", "syrk", "cuda_core"):
        out[name].append(cuda_ms(lambda: K._gram_moment(A1, b1, tiles[name]), reps=100))
    return out


def fro_rel(x: torch.Tensor, ref: torch.Tensor) -> float:
    """||x - ref||_F / ||ref||_F, in float64."""
    x, ref = x.double(), ref.double()
    return float(torch.linalg.norm(x - ref) / torch.linalg.norm(ref).clamp_min(1e-300))


def feature_close(G, h, Gr, hr) -> bool:
    """tests/test_sketch_kernels.py's tolerance: |x - ref| <= 2e-3 |ref| +
    2e-4 max|G_ref| (float32 sums in other orders)."""
    scale = max(1.0, float(Gr.abs().max()))
    return all(bool(((x.double() - r.double()).abs()
                     <= 2e-3 * r.double().abs() + 2e-4 * scale).all())
               for x, r in ((G, Gr), (h, hr)))


def feature_kernel_row(kind: str, g, peaks) -> tuple[dict, dict]:
    """K3 (sketch) or K4 (rff) at the feature tenant's Phase-1 shape, plus
    ragged, bf16, row-mask and true-D cases, against the plain version and
    float64."""
    from repro_torch.kernels import gram as K
    from repro_torch.kernels import ref

    def inputs(n, d, m, dtype=torch.float32):
        def randn(*shape):
            return torch.randn(shape, generator=g, device="cuda")

        X, b = randn(n, d), randn(n)
        if kind == "sketch":
            M, c = randn(d, m) / m ** 0.5, None
        else:
            M = randn(d, m) / d ** 0.5
            c = 2 * np.pi * torch.rand(m, generator=g, device="cuda")
        return [t if t is None else t.to(dtype) for t in (X, b, M, c)]

    def kernel(X, b, M, c):
        return (K.sketch_gram_cuda(X, b, M) if c is None
                else K.rff_gram_cuda(X, b, M, c))

    def plain(X, b, M, c):
        return (ref.sketch_gram_ref(X, b, M) if c is None
                else ref.rff_gram_ref(X, b, M, c))

    def f64(X, b, M, c):
        return plain(*(t if t is None else t.double() for t in (X, b, M, c)))

    name = "sketch_gram" if kind == "sketch" else "rff_gram"
    # the plain and library yardsticks must run in full float32
    check(not torch.backends.cuda.matmul.allow_tf32, "TF32 is on for matmuls")
    n, d, m = (ROWS, DIM, SKETCH_M) if kind == "sketch" else (ROWS, RFF_DIM, RFF_M)
    det = {"shape": [n, d, m],
           "tolerance": "plain: 2e-3 rel + 2e-4 max|G|; float64: 1e-4 Frobenius"}
    cases = {"full": (n, d, m, torch.float32),
             "ragged": (1000, 100, 12, torch.float32),
             "bf16": (n, d, m, torch.bfloat16),
             "row_mask": (4095, d, m, torch.float32)}
    full = None
    for case, (cn, cd, cm, dtype) in cases.items():
        args = inputs(cn, cd, cm, dtype)
        G, h = kernel(*args)
        Gp, hp = plain(*args)
        G64, h64 = f64(*args)
        torch.cuda.synchronize()
        check(feature_close(G, h, Gp, hp), f"{name} {case}: kernel vs plain")
        det[f"{case}_G_fro_f64"], det[f"{case}_h_fro_f64"] = fro_rel(G, G64), fro_rel(h, h64)
        check(det[f"{case}_G_fro_f64"] <= 1e-4 and det[f"{case}_h_fro_f64"] <= 1e-4,
              f"{name} {case}: {det}")
        det[f"{case}_G_rel_plain"] = rel_err(G, Gp)
        if case == "ragged" and kind == "rff":
            # D = 12: a scale from any other D would move trace(G) by far more
            det["true_D_trace_ratio"] = float(torch.trace(G) / torch.trace(G64))
            check(abs(det["true_D_trace_ratio"] - 1) <= 1e-4, f"{name} scale: {det}")
        if case == "full":
            G2, h2 = kernel(*args)
            torch.cuda.synchronize()
            check(torch.equal(G, G2) and torch.equal(h, h2),
                  f"{name} is not bitwise deterministic across two runs")
            check(torch.equal(G, G.T), f"{name} G is not exactly symmetric")
            det["bitwise_repeat"] = True
            det["max_abs_err"] = float(max((G - Gp).abs().max(), (h - hp).abs().max()))
            full = args
        del G, h, Gp, hp, G64, h64, args
    X, b, M, c = full
    scale = (2.0 / m) ** 0.5

    def library():
        T = X @ M if c is None else scale * torch.cos(X @ M + c)
        return T.T @ T, T.T @ b

    ms = cuda_ms(lambda: kernel(X, b, M, c))
    plain_ms = cuda_ms(lambda: plain(X, b, M, c))
    lib_ms = cuda_ms(library)
    ops = 2 * n * d * m + n * m * (m + 1) + 2 * n * m
    nbytes = 4 * (n * d + n + d * m + (0 if c is None else m) + m * m + m)
    # float32 runs 3xTF32 on the tensor cores: the bound is at that rate;
    # the FP32 one stays in the detail
    bms, by = bound(ops, nbytes, peaks, rate="3xtf32")
    det.update(ms=ms, library_ms=lib_ms, tflops=ops / ms / 1e9, bound_ms_3xtf32=bms,
               bound_ms_fp32=bound(ops, nbytes, peaks)[0], syrk_tile=K.syrk_tile(m),
               # its two kernels' device time (featurize GEMM, SYRK) in one call
               profile=profile_top(lambda: kernel(X, b, M, c), top=4),
               **quoted_earlier(EARLIER_MS[name], ms))
    row = dict(name=name, route="cuda", source="src/repro_torch/csrc/feature_gram.cu",
               replaces=("src/repro/kernels/gram.py:187" if kind == "sketch"
                         else "src/repro/kernels/gram.py:225"),
               max_abs_err=det["max_abs_err"], ms=ms, plain_ms=plain_ms,
               bound_ms=bms, bound_by=by, library_ms=lib_ms)
    return row, det


def swa_pairs(S: int, window, causal: bool) -> int:
    """Kept (q, k) pairs of one (batch, head): what K5's mask keeps."""
    q = np.arange(S, dtype=np.int64)
    hi = q if causal else np.full(S, S - 1)
    lo = np.zeros(S, np.int64) if window is None else np.maximum(0, q - window + 1)
    return int((hi - lo + 1).sum())


def swa_case(g, peaks, B: int, S: int, H: int, Hkv: int, hd: int, window,
             causal: bool = True) -> dict:
    """K5 in bf16 at one shape, window and causality against its plain
    version: within one bf16 ulp, repeated bitwise; its time, the plain
    version's, SDPA's (``is_causal``, no mask when non-causal, or the band
    as a boolean mask, over repeated KV heads), the bound, and the seconds
    the case took."""
    from repro_torch.kernels import gram as K
    from repro_torch.kernels import ref

    t0 = time.perf_counter()

    q, k, v = [torch.randn(shape, generator=g, device="cuda").bfloat16()
               for shape in ((B, S, H, hd), (B, S, Hkv, hd), (B, S, Hkv, hd))]
    kg, vg = (t.repeat_interleave(H // Hkv, dim=2).transpose(1, 2) for t in (k, v))
    qt = q.transpose(1, 2)
    if window is None:
        mask = None
    else:
        rel = torch.arange(S, device="cuda")[:, None] - torch.arange(S, device="cuda")[None, :]
        mask = (rel < window) & (rel >= 0) if causal else rel < window

    def library():
        if mask is None:
            return torch.nn.functional.scaled_dot_product_attention(
                qt, kg, vg, is_causal=causal)
        return torch.nn.functional.scaled_dot_product_attention(
            qt, kg, vg, attn_mask=mask)

    o = K.swa_flash_cuda(q, k, v, window=window, causal=causal)
    o2 = K.swa_flash_cuda(q, k, v, window=window, causal=causal)
    p = ref.swa_attention_ref(q, k, v, window=window, causal=causal)
    torch.cuda.synchronize()
    err = float((o.float() - p.float()).abs().max())
    ulps = bf16_ulps(o, p)
    tag = f"B {B}, S {S}, H {H}/{Hkv}, hd {hd}, window {window}, causal {causal}"
    check(torch.equal(o, o2), f"K5 ({tag}) is not bitwise deterministic")
    check(ulps <= 1, f"K5 ({tag}): |kernel - plain| is {ulps} x (2^-7 |plain| + 1e-4)"
          f" (max abs {err})")
    lib_err = float((library().transpose(1, 2).float() - p.float()).abs().max())
    del o, o2, p
    ms = cuda_ms(lambda: K.swa_flash_cuda(q, k, v, window=window, causal=causal))
    plain_ms = cuda_ms(lambda: ref.swa_attention_ref(q, k, v, window=window, causal=causal))
    lib_ms = cuda_ms(library)
    pairs = swa_pairs(S, window, causal)
    ops = 4 * hd * pairs * B * H
    bms, by = bound(ops, 2 * (2 * B * S * H * hd + 2 * B * S * Hkv * hd), peaks,
                    rate="bf16")
    return {"shape": [B, S, H, Hkv, hd], "window": window, "causal": causal,
            "max_abs_err": err,
            "worst_bf16_ulps": ulps, "bitwise_repeat": True,
            "kept_pairs_per_head": pairs, "ms": ms, "plain_ms": plain_ms,
            "library_ms": lib_ms, "library_max_abs_err": lib_err,
            "vs_library": ms / lib_ms, "bound_ms": bms,
            "bound_by": by, "tflops": ops / ms / 1e9,
            # mma work: Q K^T, and P V twice (P_hi and P_lo)
            "mma_tflops": 1.5 * ops / ms / 1e9, "seconds": time.perf_counter() - t0}


def swa_kernel_row(g, peaks) -> tuple[dict, dict]:
    """K5 at the gemma3 path's shape (B 4, S 4096, H 32 over 16 KV heads,
    hd 128, bf16), with the SWA layers' window 1024 and the full layers'
    none, plus ragged float32 cases, then at every prefill and encode
    shape of the zoo (``SWA_ZOO_SHAPES``), each against the plain version;
    hubert's (hd 80, non-causal) also in float32."""
    from repro_torch import configs
    from repro_torch.kernels import gram as K
    from repro_torch.kernels import ref

    cfg = configs.get(MODEL_ARCH)
    B, S, H, Hkv, hd = (MODEL_BATCH, MODEL_PROMPT, cfg.num_heads,
                        cfg.num_kv_heads, cfg.head_dim)

    # bf16 output of float32 sums in two orders: within one bf16 ulp of the
    # plain value, element by element (bf16_ulps <= 1); float32 at 3e-5.
    det = {"shape": [B, S, H, Hkv, hd], "dtype": "bfloat16",
           "tolerance": "|o - p| <= 2^-7 |p| + 1e-4 (bf16), atol 3e-5 (f32)"}
    row = None
    for tag, window in (("swa", cfg.window), ("full", None)):
        case = swa_case(g, peaks, B, S, H, Hkv, hd, window)
        det[tag] = {**case, **quoted_earlier(EARLIER_MS["swa_flash"][tag], case["ms"])}
        if row is None:     # the row reports the SWA layers' case, 12 of 14 launches
            row = dict(name="swa_flash", route="cuda", source="src/repro_torch/csrc/swa_flash.cu",
                       replaces="src/repro/kernels/swa_flash.py:87",
                       **{key: case[key] for key in ("max_abs_err", "ms", "plain_ms",
                                                     "bound_ms", "bound_by", "library_ms")})
    # the same shape in float32, against plain at 3e-5
    for tag, window in (("swa", cfg.window), ("full", None)):
        qf, kf, vf = [torch.randn(shape, generator=g, device="cuda")
                      for shape in ((B, S, H, hd), (B, S, Hkv, hd), (B, S, Hkv, hd))]
        err = float((K.swa_flash_cuda(qf, kf, vf, window=window, causal=True)
                     - ref.swa_attention_ref(qf, kf, vf, window=window, causal=True)).abs().max())
        det[f"{tag}_f32_max_abs_err"] = err
        check(err <= 3e-5, f"K5 {tag} float32 at the path's shape: {err} > 3e-5")
        del qf, kf, vf
    # the ragged edge: S 1000 (not a multiple of 64), non-causal, float32
    q, k, v = [torch.randn(shape, generator=g, device="cuda")
               for shape in ((1, 1000, H, hd), (1, 1000, Hkv, hd), (1, 1000, Hkv, hd))]
    for window in (None, 48):
        err = float((K.swa_flash_cuda(q, k, v, window=window, causal=False)
                     - ref.swa_attention_ref(q, k, v, window=window, causal=False)).abs().max())
        det[f"ragged_f32_noncausal_w{window}_max_abs_err"] = err
        check(err <= 3e-5, f"K5 ragged non-causal window {window}: {err} > 3e-5")
    del q, k, v
    for name, shape in SWA_ZOO_SHAPES.items():
        det[name] = swa_case(g, peaks, *shape)
    # hubert's shape in float32 (the route a float32 copy of the encoder
    # runs), against plain at 3e-5, and its time
    B, S, H, Hkv, hd, window, causal = SWA_ZOO_SHAPES["hubert"]
    q, k, v = [torch.randn(shape, generator=g, device="cuda")
               for shape in ((B, S, H, hd), (B, S, Hkv, hd), (B, S, Hkv, hd))]
    err = float((K.swa_flash_cuda(q, k, v, window=window, causal=causal)
                 - ref.swa_attention_ref(q, k, v, window=window, causal=causal)).abs().max())
    det["hubert_f32_max_abs_err"] = err
    check(err <= 3e-5, f"K5 float32 at hubert's shape (hd 80, non-causal): {err} > 3e-5")
    det["hubert_f32_ms"] = cuda_ms(lambda: K.swa_flash_cuda(q, k, v, window=window,
                                                            causal=causal))
    del q, k, v
    torch.cuda.empty_cache()
    return row, det


# -- phase 3: the main path through the public entry points -------------------

def f64_solve(stats, sigma):
    """Float64 solve of (G + sigma I) w = h from the same statistics."""
    G = stats.gram.double()
    eye = torch.eye(G.shape[0], dtype=torch.float64, device=G.device)
    return torch.linalg.solve(G + sigma * eye, stats.moment.double())


def main_path_phase() -> tuple:
    from repro_torch import data, fed
    from repro_torch.core import compute_stats, dropout_fusion
    from repro_torch.kernels import gram as K
    from repro_torch.server import (CoalescerPolicy, FusionEngine,
                                    reference_inference)

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

    # one solve off the cached factor: the engine's (refined once with a
    # float64 residual) beside a single factor solve of the same factor
    L = eng.factor(SIGMA)
    steps["solve_ms"] = cuda_ms(lambda: eng.solve(SIGMA))
    steps["one_pass_solve_ms"] = cuda_ms(
        lambda: torch.cholesky_solve(eng.stats.moment[:, None], L))
    del L

    # 3. 256 streamed single rows through the coalescer, then flush: the
    #    cached factors are updated (kernels P and K2), never refactored.
    cold0 = eng.cold_factorizations
    rows_A, rows_b = ds.test_A[:STREAM_ROWS + 1], ds.test_b[:STREAM_ROWS + 1]
    updates0, launches0 = eng.incremental_updates, K.launch_counts()
    t0 = time.perf_counter()
    for i in range(STREAM_ROWS):
        eng.ingest_rows_async(rows_A[i:i + 1], rows_b[i:i + 1], client_id=7)
    eng.flush()
    sync()
    steps["stream_rows_s"] = time.perf_counter() - t0
    check(eng.incremental_updates > 0, "no incremental factor update")
    # once per panel: P on each of the d / 32 diagonal panels, K2 on each
    # that has trailing rows (all but the last)
    panels = -(-DIM // PANEL)
    updates = eng.incremental_updates - updates0
    stream = {k: K.launch_counts()[k] - launches0[k] for k in ("panel_transform", "gemm_nt")}
    check(stream["panel_transform"] == updates * panels
          and stream["gemm_nt"] == updates * (panels - 1),
          f"streaming: {stream} launches for {updates} updates of {panels} panels")
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
    for name in ("gram_moment", "gemm_nt", "panel_transform"):
        check(launches[name] > 0, f"kernel {name} was not launched on the main path")

    # one more rank-64 update of a cached factor, as a flush makes it, under
    # the profiler: from its first P to its last the card runs P and K2 in
    # turns, one pair a panel, and no other kernel
    L, U = eng.factor(SIGMA), rows_A[:COALESCE_RANK]
    names = kernel_sequence(lambda: eng.backend.update(L, U, 1.0))
    tags = ["P" if "panel_transform_kernel" in n else
            "K2" if "gemm_nt_panel_kernel" in n else n[:60] for n in names]
    check("P" in tags, f"no P in the profiled update: {tags[:8]}")
    first, last = tags.index("P"), len(tags) - 1 - tags[::-1].index("P")
    want = ["P", "K2"] * (panels - 1) + ["P"]
    got = tags[first:last + 1]
    bad = next((i for i, (g, w) in enumerate(zip(got, want)) if g != w),
               min(len(got), len(want)))
    check(got == want, f"the update's panels did not run as P, K2 pairs: {len(got)} "
          f"kernels for {len(want)}, first difference at {bad}: {got[max(bad - 2, 0):bad + 4]}")
    del L
    return ds, res.weights, {"phase": "main_path", "dim": DIM, "clients": CLIENTS,
            "rows_per_client": ROWS, "dtype": "float32", "errors": errs,
            "steps_s": steps, "launches": launches,
            "stream_launches": {**stream, "updates": updates, "panels": panels},
            "profiled_update": {"kernels_before_first_P": tags[:first],
                                "kernels_after_last_P": tags[last + 1:],
                                "panel_kernels": last + 1 - first},
            "upload_wire_bytes_per_client": upload,
            "engine": eng.summary(),
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 2**30,
            "seconds": time.perf_counter() - t_all}


# -- Algorithm 2 and the paper's baselines on the main path's data ------------

def dp_noise(key, d: int, tau_g: float, tau_h: float):
    """Algorithm 2 lines 4-6 for one client key, on the host: the
    symmetrized (E + E^T) / sqrt(2) of tau_g-scaled normals for G and
    tau_h-scaled normals for h, float32, from ``core.threefry``."""
    from repro_torch.core import threefry

    kg, kh = threefry.split(key)
    E = threefry.normal(kg, (d, d)) * np.float32(tau_g)
    E = (E + E.T) / np.float32(math.sqrt(2.0))
    return E, threefry.normal(kh, (d,)) * np.float32(tau_h)


def test_mse(ds, w: torch.Tensor) -> float | None:
    """Test MSE of ``w``, or None where the weights are not finite (the
    Remark-4 failure: an indefinite G~ + sigma I has no Cholesky factor)."""
    if not bool(torch.isfinite(w).all()):
        return None
    return float(torch.mean((ds.test_A @ w - ds.test_b) ** 2))


def private_federation_phase(ds, peaks) -> dict:
    from repro_torch import configs, core, data, fed
    from repro_torch.core import privacy, threefry
    from repro_torch.kernels import gram as K
    from repro_torch.server import EnginePool, FusionEngine

    def sync():
        torch.cuda.synchronize()

    def k1() -> int:
        return K.launch_counts()["gram_moment"]

    steps, errs, report = {}, {}, {}
    t_all = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    K.reset_launch_counts()

    # 1. Algorithm 2 at d 4096 on 4 of the 8 clients, the guard's repair on
    #    (run_one_shot(psd_repair=True)), then each client's upload rebuilt
    #    here: the same clipped rows through K1 plus the same threefry noise.
    ds4 = dataclasses.replace(ds, clients=ds.clients[:PRIV_DP_CLIENTS])
    dp, key = (PRIV_EPS, PRIV_DELTA), threefry.key(PRIV_KEY)
    clip = (1.2 * DIM ** 0.5, 4.0)                  # client_phase's default
    s_g, s_h = privacy.sensitivities(*clip)
    tau_g, tau_h = privacy.gaussian_tau(*dp, s_g), privacy.gaussian_tau(*dp, s_h)
    report["dp"] = {"eps": PRIV_EPS, "delta": PRIV_DELTA, "clients": PRIV_DP_CLIENTS,
                    "clip": list(clip), "tau_g": tau_g, "tau_h": tau_h}
    t0, before = time.perf_counter(), k1()
    rep = fed.run_one_shot(ds4, SIGMA, dp=dp, dp_key=key, psd_repair=True)
    sync()
    steps["run_one_shot_dp_repair_s"] = time.perf_counter() - t0
    check(k1() - before == PRIV_DP_CLIENTS, "K1 launches of run_one_shot(dp=...)")
    t0, before = time.perf_counter(), k1()
    uploads = fed.client_phase(ds4, dp=dp, dp_key=key)
    sync()
    steps["client_phase_dp_s"] = time.perf_counter() - t0
    check(k1() - before == PRIV_DP_CLIENTS, "K1 launches of client_phase(dp=...)")

    keys = threefry.split(key, PRIV_DP_CLIENTS)    # over all K of ds4
    G64 = torch.zeros((DIM, DIM), dtype=torch.float64, device="cuda")
    h64 = torch.zeros(DIM, dtype=torch.float64, device="cuda")
    steps["clip_k1_s"], steps["host_draw_s"] = [], []
    for k, (A, b) in enumerate(ds4.clients):
        t0 = time.perf_counter()
        Ac, bc = privacy.clip_rows(A, b, clip_a=clip[0], clip_b=clip[1])
        s = core.compute_stats(Ac, bc)
        sync()
        steps["clip_k1_s"].append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        E, e = dp_noise(keys[k], DIM, tau_g, tau_h)
        steps["host_draw_s"].append(time.perf_counter() - t0)
        E, e = torch.from_numpy(E).cuda(), torch.from_numpy(e).cuda()
        want = fed.PackedStats.pack(core.SuffStats(s.gram + E, s.moment + e, s.count))
        check(torch.equal(uploads[k].tri, want.tri)
              and torch.equal(uploads[k].moment, want.moment),
              f"DP client {k}'s upload is not its K1 statistics plus its noise, bitwise")
        A64 = Ac.double()
        G64 += A64.T @ A64 + E.double()
        h64 += A64.T @ bc.double() + e.double()
        del Ac, bc, A64, s, E, e, want
    raw = FusionEngine.from_clients({k: p.unpack() for k, p in uploads.items()}).stats
    errs["dp_fused_g_vs_f64_fro"] = fro_rel(raw.gram, G64)
    errs["dp_fused_h_vs_f64"] = fro_rel(raw.moment, h64)
    check(errs["dp_fused_g_vs_f64_fro"] <= 1e-5 and errs["dp_fused_h_vs_f64"] <= 1e-5,
          f"noisy fused statistics against the float64 rebuild: {errs}")
    del G64, h64

    t0 = time.perf_counter()
    lam = torch.linalg.eigvalsh(raw.gram)
    sync()
    steps["guard_eigvalsh_s"] = time.perf_counter() - t0
    report["dp_fused_eig"] = {"min": float(lam[0]), "max": float(lam[-1])}
    check(float(lam[0]) < 0, "the DP noise left the fused Gram PSD: the guard cannot fire")
    t0 = time.perf_counter()
    fixed = privacy.psd_repair(raw)
    sync()
    steps["psd_repair_s"] = time.perf_counter() - t0
    repeatable = torch.equal(fixed.gram, privacy.psd_repair(raw).gram)
    report["eigh_repeatable"] = repeatable
    G_rep = rep.extras["fused_stats"].gram
    if repeatable:
        check(torch.equal(G_rep, fixed.gram),
              "run_one_shot's repair differs from psd_repair of its fused stats")
    else:               # cuSOLVER's eigh differs run to run: hold it to 1e-6
        errs["repair_vs_psd_repair_fro"] = fro_rel(G_rep, fixed.gram)
        check(errs["repair_vs_psd_repair_fro"] <= 1e-6, f"repair: {errs}")
    lam = torch.linalg.eigvalsh(G_rep)
    report["repaired_eig"] = {"min": float(lam[0]), "max": float(lam[-1])}
    check(float(lam[0]) >= -1e-4 * float(lam[-1]), f"repaired Gram: {report}")
    # The float32 (V max(lam, 0)) V^T leaves the clipped eigenvalues at
    # +-eps32 lam_max, far beyond sigma 0.01 at lam_max ~ 7e6: G~ + 0.01 I
    # stays indefinite, so run_one_shot's weights are NaN, as the
    # reference's are. The repaired statistics solve at sigma_dp = 1e-3
    # lam_max, above d eps32 lam_max (a Cholesky's backward error).
    sigma_dp = 1e-3 * float(lam[-1])
    report["dp_weights_finite"] = {str(SIGMA): bool(torch.isfinite(rep.weights).all())}
    t0 = time.perf_counter()
    w_fixed = FusionEngine.from_stats(fixed).solve(sigma_dp)
    sync()
    steps["solve_after_repair_s"] = time.perf_counter() - t0
    w_dp = rep.extras["engine"].solve(sigma_dp)
    report["dp_weights_finite"]["sigma_dp"] = sigma_dp
    check(bool(torch.isfinite(w_dp).all()), f"DP weights not finite at sigma {sigma_dp}")
    check(torch.equal(w_fixed, w_dp) or not repeatable,
          "the repaired solve differs from run_one_shot's engine's")
    clean4 = fed.run_one_shot(ds4, SIGMA)
    report["test_mse"] = {"dp_repaired_sigma_0.01": test_mse(ds, rep.weights),
                          "dp_repaired_sigma_dp": test_mse(ds, w_dp),
                          "clean": test_mse(ds, clean4.weights)}
    del lam, fixed, w_fixed

    # 2. the pool's Remark-4 guard on the same 4 DP payloads, and on clean ones
    pool = EnginePool()
    try:
        t0 = time.perf_counter()
        pool.create_tenant("dp", payloads=uploads, placement="dense", psd_guard=True)
        sync()
        steps["pool_guarded_admission_s"] = time.perf_counter() - t0
        t = pool.tenant("dp")
        report["pool_guard"] = {"psd_repairs": t.psd_repairs,
                                "guard_min_eig": t.guard_min_eig}
        check(t.psd_repairs == 1 and t.guard_min_eig < 0, f"guard: {report['pool_guard']}")
        if repeatable:
            check(torch.equal(pool.get("dp").stats.gram, G_rep),
                  "the pool's repair differs from run_one_shot's")
            check(torch.equal(pool.solve("dp", sigma_dp), w_dp),
                  "the guarded tenant's solve differs from run_one_shot's")
        else:
            errs["pool_vs_run_fro"] = fro_rel(pool.get("dp").stats.gram, G_rep)
            check(errs["pool_vs_run_fro"] <= 1e-6, f"pool repair: {errs}")
        pool.create_tenant("clean", payloads=fed.client_phase(ds4), placement="dense",
                           psd_guard=True)
        report["pool_guard"]["clean_psd_repairs"] = pool.tenant("clean").psd_repairs
        report["pool_guard"]["clean_min_eig"] = pool.tenant("clean").guard_min_eig
        report["pool_guard"]["summary_psd_repairs"] = pool.summary()["psd_repairs"]
        check(pool.tenant("clean").psd_repairs == 0 and pool.summary()["psd_repairs"] == 1,
              f"guard: {report['pool_guard']}")
    finally:
        pool.close()
    del pool, uploads, rep, raw, G_rep, clean4, w_dp

    # 3. the equilibrium: CG on the 8 clients' clean fused statistics
    clean = fed.run_one_shot(ds, SIGMA)
    fused = clean.extras["fused_stats"]
    w64 = f64_solve(fused, SIGMA)
    w_cg = core.solve_cg(fused, SIGMA, iters=PRIV_CG_ITERS)
    errs["cg_vs_f64"] = rel_err(w_cg, w64)
    check(errs["cg_vs_f64"] <= 1e-5, f"CG: {errs}")
    steps["solve_cg_ms"] = cuda_ms(lambda: core.solve_cg(fused, SIGMA, iters=PRIV_CG_ITERS),
                                   reps=3)
    s64 = core.SuffStats(fused.gram.double(), fused.moment.double(), fused.count)
    true_err = float(torch.linalg.vector_norm(w_cg.double() - w64))
    report["cg"] = {"iters": PRIV_CG_ITERS, "true_err": true_err,
                    "residual_bound_f64": float(core.residual_bound(s64, SIGMA,
                                                                    w_cg.double())),
                    "residual_bound_f32": float(core.residual_bound(fused, SIGMA, w_cg)),
                    "residual_norm": float(torch.linalg.vector_norm(
                        core.equilibrium_residual(fused, SIGMA, w_cg)))}
    check(report["cg"]["residual_bound_f64"] >= true_err, f"CG bound: {report['cg']}")
    del s64, w64, w_cg

    # 4. FedAvg and FedProx at full width: 200 rounds of 5 epochs on the 8 clients
    cfg = fed.IterativeConfig(rounds=PRIV_ROUNDS, lr=PRIV_LR, local_epochs=PRIV_EPOCHS,
                              sigma=SIGMA)
    rows_bytes = sum(A.numel() * A.element_size() for A, _ in ds.clients)
    floor_s = 2 * rows_bytes * PRIV_ROUNDS * PRIV_EPOCHS / peaks[0]
    base = {"one_shot_test_mse": test_mse(ds, clean.weights),
            "one_shot_upload_floats": clean.comm.upload_floats_per_client,
            "crossover_rounds": fed.crossover_rounds(DIM), "bytes_floor_s": floor_s}
    for name, c in (("fedavg", cfg), ("fedprox", dataclasses.replace(cfg, prox_mu=PRIV_MU))):
        t0 = time.perf_counter()
        res = fed.run_iterative(ds, c)
        sync()
        wall = time.perf_counter() - t0
        check(bool(torch.isfinite(res.weights).all()), f"{name} weights not finite")
        base[name] = {"wall_s": wall, "loop_s": res.wall_time_s,
                      "test_mse": test_mse(ds, res.weights),
                      "upload_floats": res.comm.upload_floats_per_client}
        del res
    report["baselines_d4096"] = base
    del clean, fused

    # 5. the paper's own configuration (configs.RIDGE, §V-A): one-shot, the
    #    baselines, DP one-shot with and without the repair, DP-FedAvg
    rc = configs.RIDGE
    dsp = data.synthetic.generate(PRIV_RIDGE_SEED, num_clients=rc.num_clients,
                                  samples_per_client=rc.samples_per_client, dim=rc.dim,
                                  gamma=rc.gamma, noise_std=rc.noise_std)
    it = fed.IterativeConfig(lr=rc.fedavg_lr, local_epochs=rc.fedavg_epochs, sigma=rc.sigma)
    t0 = time.perf_counter()
    one = fed.run_one_shot(dsp, rc.sigma)
    runs = {"one_shot": one.weights,
            "centralized": fed.run_centralized(dsp, rc.sigma).weights}
    avg = fed.run_iterative(dsp, it)
    runs["fedavg"] = avg.weights
    runs["fedprox"] = fed.run_iterative(dsp, dataclasses.replace(
        it, prox_mu=rc.fedprox_mu)).weights
    for eps in PRIV_EPS_GRID:
        for repair in (False, True):
            runs[f"dp_one_shot_eps{eps:g}" + ("_repaired" if repair else "")] = \
                fed.run_one_shot(dsp, rc.sigma, dp=(eps, PRIV_DELTA), dp_key=key,
                                 psd_repair=repair).weights
        runs[f"dp_fedavg_eps{eps:g}"] = fed.run_iterative(
            dsp, dataclasses.replace(it, dp_eps=eps)).weights
    sync()
    steps["ridge_config_s"] = time.perf_counter() - t0
    mses = {name: test_mse(dsp, w) for name, w in runs.items()}
    for name, m in mses.items():
        if name.startswith("dp_one_shot"):
            # Remark 4: G~ + sigma I may be indefinite, its weights NaN
            check(m is None or m != mses["one_shot"], f"{name} equals the clean run")
            continue
        check(m is not None, f"{name}: weights not finite")
        if name.startswith("dp_"):
            check(m != mses["fedavg"], f"{name} equals the clean FedAvg")
    # tests/test_fed.py's DP check at its own size: 20 x 500 rows, d 30, eps 5
    ds30 = data.synthetic.generate(PRIV_RIDGE_SEED, num_clients=20, samples_per_client=500,
                                   dim=30, gamma=0.5)
    m_dp = test_mse(ds30, fed.run_one_shot(ds30, 0.01, dp=(5.0, PRIV_DELTA),
                                           dp_key=threefry.key(3)).weights)
    m_cl = test_mse(ds30, fed.run_one_shot(ds30, 0.01).weights)
    check(m_dp is not None and m_dp != m_cl and m_dp < 20 * m_cl + 0.1,
          f"DP one-shot at d 30: {m_dp} against clean {m_cl}")
    # tests/test_fed.py's IID check at its own size: 8 x 100 rows, d 20, 300 rounds
    iid = data.synthetic.generate(PRIV_RIDGE_SEED, num_clients=8, samples_per_client=100,
                                  dim=20, gamma=0.0)
    m_iid = test_mse(iid, fed.run_iterative(iid, fed.IterativeConfig(
        rounds=300, sigma=0.01)).weights)
    m_oracle = test_mse(iid, fed.run_centralized(iid, 0.01).weights)
    check(m_iid < 1.05 * m_oracle, f"FedAvg IID {m_iid} against oracle {m_oracle}")
    report["ridge_config"] = {
        "config": dataclasses.asdict(rc), "rounds": it.rounds, "test_mse": mses,
        "fedavg_iid_vs_oracle": m_iid / m_oracle,
        "dp_eps5_d30_vs_clean": [m_dp, m_cl],
        "upload_floats_per_client": {"one_shot": one.comm.upload_floats_per_client,
                                     "fedavg": avg.comm.upload_floats_per_client},
        "comm_ratio_fedavg_over_one_shot": avg.comm.analytic_total_bytes
        / one.comm.analytic_total_bytes,
        "paper_claim": "up to 38x less communication (abstract), not asserted"}
    del dsp, runs, iid, ds30

    # K1 once a client in every Phase 1: run_one_shot(dp), client_phase(dp),
    # the rebuild, the clean run and clean uploads of the 4 DP clients; the
    # 8 clients' clean run; the §V-A one-shot and its 6 DP runs; 2 oracles;
    # the d 30 check's DP and clean runs
    launches = K.launch_counts()
    k1_want = (5 * PRIV_DP_CLIENTS + CLIENTS
               + rc.num_clients * (1 + 2 * len(PRIV_EPS_GRID)) + 2 + 2 * 20)
    check(launches["gram_moment"] == k1_want,
          f"K1 launched {launches['gram_moment']} times on the private path, want {k1_want}")
    for name in ("gemm_nt", "panel_transform", "sketch_gram", "rff_gram", "swa_flash"):
        check(launches[name] == 0, f"kernel {name} launched on the private path")
    return {"phase": "private_federation", "part": "ridge", "dim": DIM,
            "rows_per_client": ROWS,
            "reduced": f"DP clients: {PRIV_DP_CLIENTS} of {CLIENTS} (host draw)",
            "errors": errs, "report": report, "steps_s": steps, "launches": launches,
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 2**30,
            "seconds": time.perf_counter() - t_all}


# -- phase 4: the §IV-F feature tenants through the same entry points ---------

def feature_tenant(tag: str, fm, ds, steps: dict, errs: dict, report: dict):
    """One feature tenant: K clients' Phase 1 (K3/K4) -> packed upload ->
    engine in the m-dim solve space -> solve and lift -> inference off the
    cached factor -> 4-sigma sweep and 64 predictions -> 64 streamed
    featurized rows (one rank-64 flush through P and K2). Returns the engine
    and the lifted weights at SIGMA."""
    from repro_torch import fed
    from repro_torch.server import (CoalescerPolicy, FusionEngine,
                                    reference_inference)

    def sync():
        torch.cuda.synchronize()

    t0 = time.perf_counter()
    fm.materialize(ds.test_A.device)
    sync()
    steps[f"{tag}_materialize_map_s"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    uploads = [fed.PackedStats.pack(fm.stats(A, b)) for A, b in ds.clients]
    sync()
    steps[f"{tag}_client_stats_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    eng = FusionEngine.from_clients([p.unpack() for p in uploads],
                                    coalesce=CoalescerPolicy(max_rank=COALESCE_RANK))
    v = eng.solve(SIGMA)
    w = fm.lift(v)
    sync()
    steps[f"{tag}_engine_solve_s"] = time.perf_counter() - t0

    # served inference off the cold factor at SIGMA == the cold reference
    t0 = time.perf_counter()
    q = fm(ds.test_A[:8])
    rep = eng.inference(SIGMA, queries=q)
    w_cold, rep_ref = reference_inference(eng.stats, SIGMA, queries=q)
    sync()
    steps[f"{tag}_inference_s"] = time.perf_counter() - t0
    check(torch.equal(v, w_cold), f"{tag}: served w != cold reference")
    for key in ("n", "dof", "rss", "sigma2"):
        check(rep[key] == rep_ref[key], f"{tag}: inference {key} differs")
    for key in ("stderr", "ci", "pi", "pi_mean"):
        check(np.array_equal(rep[key], rep_ref[key]), f"{tag}: inference {key} differs")
    check(all(np.isfinite(rep[k]).all() for k in ("stderr", "ci", "pi")),
          f"{tag}: inference not finite")

    t0 = time.perf_counter()
    vs = eng.solve_batch(SIGMAS, method="chol")
    preds = [fm.predict(ds.test_A[8 * i:8 * i + 8], fm.lift(vs[i % 4]))
             for i in range(64)]
    sync()
    steps[f"{tag}_sweep_predict_s"] = time.perf_counter() - t0
    check(eng.dim == fm.m and int(eng.stats.count) == CLIENTS * ROWS,
          f"{tag}: engine dim {eng.dim}, count {int(eng.stats.count)}")
    check(all(p.wire_floats == fm.upload_floats() for p in uploads),
          f"{tag}: upload floats")
    # Tolerance 1e-4 relative: float32 statistics and a float32 Cholesky.
    errs[f"{tag}_vs_f64"] = rel_err(v, f64_solve(eng.stats, SIGMA))
    for s, vv in zip(SIGMAS, vs):
        errs[f"{tag}_sweep_{s}_vs_f64"] = rel_err(vv, f64_solve(eng.stats, s))
    for key in [k for k in errs if k.startswith(tag)]:
        check(errs[key] <= 1e-4, f"{tag} solve {key}: {errs[key]}")
    arrays = [a.double() for a in fm.materialize(ds.test_A.device)]
    X = ds.test_A[:512].double()
    T = X @ arrays[0] if fm.kind == "sketch" else \
        (2.0 / fm.m) ** 0.5 * torch.cos(X @ arrays[0] + arrays[1])
    pred_ref = T @ vs.double().T
    errs[f"{tag}_predict_rel"] = max(rel_err(p, pred_ref[8 * i:8 * i + 8, i % 4])
                                     for i, p in enumerate(preds))
    check(errs[f"{tag}_predict_rel"] <= 1e-4, f"{tag} predictions: {errs}")

    # streamed featurized rows: one flush at rank 64, no refactorisation
    cold0, inc0, fl0 = eng.cold_factorizations, eng.incremental_updates, eng.flushes
    t0 = time.perf_counter()
    T_rows = fm(ds.test_A[:FEATURE_STREAM_ROWS])
    y_rows = ds.test_b[:FEATURE_STREAM_ROWS]
    for i in range(FEATURE_STREAM_ROWS):
        eng.ingest_rows_async(T_rows[i:i + 1], y_rows[i:i + 1], client_id="stream")
    eng.flush()
    sync()
    steps[f"{tag}_stream_rows_s"] = time.perf_counter() - t0
    check(eng.flushes - fl0 == 1, f"{tag}: {eng.flushes - fl0} flushes, want 1")
    check(eng.incremental_updates > inc0, f"{tag}: no incremental factor update")
    for s in SIGMAS:
        errs[f"{tag}_stream_{s}_vs_f64"] = rel_err(eng.solve(s), f64_solve(eng.stats, s))
        check(errs[f"{tag}_stream_{s}_vs_f64"] <= 1e-4, f"{tag} streamed: {errs}")
    errs[f"{tag}_refactorisations"] = eng.cold_factorizations - cold0
    check(errs[f"{tag}_refactorisations"] == 0, f"{tag}: streaming refactorized")

    # conditioning of the float32 solves checked above: kappa(G + sigma I)
    # of the fused statistic from float64 eigenvalues, and kappa * 2^-24
    t0 = time.perf_counter()
    lam = torch.linalg.eigvalsh(eng.stats.gram.double())
    sync()
    steps[f"{tag}_eigvalsh_f64_s"] = time.perf_counter() - t0
    report[f"{tag}_eig_min_max"] = [float(lam[0]), float(lam[-1])]
    for s in SIGMAS:
        kappa = float((lam[-1] + s) / (lam[0] + s))
        report[f"{tag}_kappa_{s}"] = kappa
        report[f"{tag}_kappa_u_{s}"] = kappa * 2.0 ** -24

    return eng, w


def feature_phase(ds, w_dense) -> dict:
    from repro_torch import core, data, fed
    from repro_torch.core import threefry
    from repro_torch.kernels import gram as K

    def mse(pred, y):
        return float(torch.mean((pred.double() - y.double()) ** 2))

    steps, errs, report = {}, {}, {}
    t_all = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    K.reset_launch_counts()

    # sketch tenant of the dense main path's data (d 4096 -> m 1024)
    fm = core.FeatureMap("sketch", FEATURE_SEED, DIM, SKETCH_M)
    eng, w_tilde = feature_tenant("sketch", fm, ds, steps, errs, report)
    report["sketch_prop3_gap_vs_dense"] = float(
        torch.linalg.norm(w_tilde - w_dense) / torch.linalg.norm(w_dense))
    report["sketch_prop3_bound_c1"] = fm.error_bound(float(torch.linalg.norm(w_tilde)))
    report["sketch_test_mse"] = mse(fm.predict(ds.test_A, w_tilde), ds.test_b)
    report["dense_test_mse"] = mse(ds.test_A @ w_dense, ds.test_b)
    del eng
    t0 = time.perf_counter()
    proj = fed.run_one_shot_projected(ds, SIGMA, SKETCH_M,
                                      key=threefry.key(FEATURE_SEED))
    torch.cuda.synchronize()
    steps["run_one_shot_projected_s"] = time.perf_counter() - t0
    errs["projected_vs_sketch_tenant"] = rel_err(proj.weights, w_tilde)
    check(errs["projected_vs_sketch_tenant"] <= 1e-4,
          f"run_one_shot_projected vs sketch tenant: {errs}")
    report["projected_upload_wire_bytes_per_client"] = \
        proj.comm.upload_wire_bytes_per_client
    del proj

    # RFF tenant on d = 128 data of the same distribution (D = 4096)
    t0 = time.perf_counter()
    ds_rff = data.synthetic.generate(1, num_clients=CLIENTS,
                                     samples_per_client=ROWS, dim=RFF_DIM)
    torch.cuda.synchronize()
    steps["rff_generate_s"] = time.perf_counter() - t0
    fm = core.FeatureMap("rff", FEATURE_SEED, RFF_DIM, RFF_M,
                         lengthscale=RFF_DIM ** 0.5)
    eng, w_rff = feature_tenant("rff", fm, ds_rff, steps, errs, report)
    report["rff_test_mse"] = mse(fm.predict(ds_rff.test_A, w_rff), ds_rff.test_b)
    lin = fed.run_one_shot(ds_rff, SIGMA)
    report["rff_data_linear_ridge_test_mse"] = mse(ds_rff.test_A @ lin.weights,
                                                   ds_rff.test_b)
    torch.cuda.synchronize()
    launches = K.launch_counts()
    for name in ("gram_moment", "gemm_nt", "panel_transform", "sketch_gram", "rff_gram"):
        check(launches[name] > 0, f"kernel {name} was not launched on the feature path")
    return {"phase": "feature_tenants", "sketch": [DIM, SKETCH_M],
            "rff": [RFF_DIM, RFF_M], "clients": CLIENTS, "rows_per_client": ROWS,
            "errors": errs, "report": report, "steps_s": steps,
            "launches": launches, "engine_rff": eng.summary(),
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 2**30,
            "seconds": time.perf_counter() - t_all}


# -- phase 5: the serving pool at full width through the same entry points ----

def stacked_timing(entries) -> dict:
    """One stacked sweep of T lanes (``solve_stacked``) against T lone
    solves and against one batched ``torch.cholesky_solve`` over [T, d, d]
    (alone, and refined with a float64 residual as the lanes are); whether
    the batched answers keep each lane's bits. Median CUDA-event ms."""
    from repro_torch.server import solve_snapshot, solve_stacked

    out = {}
    for T in STACKED_T:
        e = entries[:T]
        Ls = torch.stack([x[0] for x in e])
        Gs = torch.stack([x[1] for x in e]).double()
        Hs = torch.stack([x[2] for x in e])[..., None]
        sig = torch.tensor([x[3] for x in e], dtype=torch.float64, device="cuda")

        def refined():
            w = torch.cholesky_solve(Hs, Ls)
            w64 = w.double()
            r = Hs.double() - torch.bmm(Gs, w64) - sig[:, None, None] * w64
            return w + torch.cholesky_solve(r.to(Ls.dtype), Ls)

        lanes = solve_stacked(e)
        one_pass = [torch.cholesky_solve(x[2][:, None], x[0]) for x in e]
        batched, batched_refined = torch.cholesky_solve(Hs, Ls), refined()
        out[f"T{T}"] = {
            "stacked_ms": cuda_ms(lambda: solve_stacked(e)),
            "lone_ms": cuda_ms(lambda: [solve_snapshot(*x) for x in e]),
            "batched_cholesky_solve_ms": cuda_ms(lambda: torch.cholesky_solve(Hs, Ls)),
            "batched_refined_ms": cuda_ms(refined),
            "stack_ms": cuda_ms(lambda: torch.stack([x[0] for x in e])),
            "batched_lanes_bitwise_one_pass": sum(
                bool(torch.equal(b, o)) for b, o in zip(batched, one_pass)),
            "batched_refined_lanes_bitwise": sum(
                bool(torch.equal(b[:, 0], w)) for b, w in zip(batched_refined, lanes)),
            "batched_refined_max_rel_diff": max(
                rel_err(b[:, 0], w) for b, w in zip(batched_refined, lanes)),
            "lanes": T}
    return out


def pool_serving_phase(ds) -> dict:
    from repro_torch import core, data, fed
    from repro_torch.core import compute_stats
    from repro_torch.kernels import gram as K
    from repro_torch.launch.serve import serve_fusion
    from repro_torch.server import CoalescerPolicy, EnginePool, SolveBatcher

    def sync():
        torch.cuda.synchronize()

    steps, errs, report = {}, {}, {}
    t_all = time.perf_counter()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()

    # (a) serve_fusion, the pool's own entry point, at the main path's size.
    #     Its exactness check is the main path's: relative 1e-4 against a
    #     float64 solve of each tenant's rows.
    K.reset_launch_counts()
    t0 = time.perf_counter()
    res = serve_fusion(num_clients=CLIENTS, samples_per_client=ROWS, dim=DIM,
                       tenants=POOL_TENANTS, sigmas_per_tenant=len(SIGMAS),
                       queries=POOL_QUERIES, query_rows=8, sketched_tenants=1,
                       rff_tenants=1, feature_dim=POOL_FEATURE_DIM,
                       lengthscale=DIM ** 0.5, stream_deltas=POOL_STREAM,
                       coalesce_rank=POOL_COALESCE,
                       flush_staleness_s=POOL_STALENESS, device="cuda")
    sync()
    steps["serve_fusion_s"] = time.perf_counter() - t0
    launches = K.launch_counts()
    for name in ("gram_moment", "sketch_gram", "rff_gram", "panel_transform", "gemm_nt"):
        check(launches[name] > 0, f"kernel {name} was not launched by serve_fusion")
    stream = res["streaming"]
    errs["serve_fusion_rel"] = res["exact_max_rel_err"]
    errs["serve_fusion_stream_rel"] = stream["exact_max_rel_err"]
    errs["serve_fusion_abs"] = res["exact_max_abs_err"]
    errs["serve_fusion_stream_abs"] = stream["exact_max_abs_err"]
    for key in ("serve_fusion_rel", "serve_fusion_stream_rel"):
        check(errs[key] <= 1e-4, f"{key} = {errs[key]} > 1e-4")
    check(stream["pending_after"] == 0, f"{stream['pending_after']} deltas left pending")
    ranks = {int(r): n for r, n in stream["flush_ranks"].items()}
    report["serve_fusion"] = {
        "naive_qps": res["naive_qps"], "pool_qps": res["pool_qps"],
        "speedup": res["speedup"], "stream_s": stream["stream_s"],
        "background_flushes": stream["background_flushes"],
        "max_flush_age_s": stream["max_flush_age_s"],
        "mutations_per_delta": stream["mutations_per_delta"],
        "flush_ranks": ranks,
        "flushes_below_rank_8": sum(n for r, n in ranks.items() if r < 8),
        "ledger_by_kind": res["ledger"]["by_kind"],
        "ledger_total_bytes": res["ledger"]["total_bytes"],
        "placements": res["placements"],
        "feature_reports": {n: {k: v for k, v in r.items()
                                if k in ("kind", "solve_dim", "error_bound")}
                            for n, r in res["feature_reports"].items()}}
    del res
    torch.cuda.empty_cache()

    # (b) a pool of the main path's 8 clients: 4 dense tenants of 5 clients
    #     each (one admitted from packed payloads), the feature phase's rff
    #     tenant (D 4096, the dense tenants' bucket) and sketch tenant (m 1024)
    K.reset_launch_counts()
    t0 = time.perf_counter()
    stats = [compute_stats(A, b) for A, b in ds.clients]
    pool = EnginePool(default_coalesce=CoalescerPolicy(
        max_rank=FLUSH_RANK, max_staleness_s=FLUSH_STALENESS))
    dense = [f"dense{i}" for i in range(len(POOL_SUBSETS))]
    pool.create_tenant(dense[0], payloads={k: fed.PackedStats.pack(stats[k])
                                           for k in POOL_SUBSETS[0]})
    for name, subset in zip(dense[1:], POOL_SUBSETS[1:]):
        pool.create_tenant(name, clients={k: stats[k] for k in subset})
    fm_s = core.FeatureMap("sketch", FEATURE_SEED, DIM, SKETCH_M)
    pool.create_tenant("sketch", features=fm_s, payloads=[
        fed.PackedStats.pack(fm_s.stats(A, b)) for A, b in ds.clients])
    ds_rff = data.synthetic.generate(1, num_clients=CLIENTS,
                                     samples_per_client=ROWS, dim=RFF_DIM)
    fm_r = core.FeatureMap("rff", FEATURE_SEED, RFF_DIM, RFF_M,
                           lengthscale=RFF_DIM ** 0.5)
    pool.create_tenant("rff", features=fm_r, payloads=[
        fed.PackedStats.pack(fm_r.stats(A, b)) for A, b in ds_rff.clients])
    del ds_rff
    sync()
    steps["admit_6_tenants_s"] = time.perf_counter() - t0
    names = pool.tenant_names
    check(pool.tenant(dense[0]).comm.upload_wire_bytes_per_client is not None,
          "the payload tenant's ledger carries no measured bytes")

    # solve_many over 24 requests: every lane equals the lone solve, bitwise,
    # and each (d, dtype) bucket is one sweep
    reqs = [(n, s) for n in names for s in SIGMAS]
    t0 = time.perf_counter()
    lone = {r: pool.solve(*r) for r in reqs}
    sync()
    steps["lone_solves_24_s"] = time.perf_counter() - t0
    for n, s in reqs:
        errs[f"{n}_{s}_vs_f64"] = rel_err(lone[(n, s)], f64_solve(pool.stats(n), s))
        check(errs[f"{n}_{s}_vs_f64"] <= 1e-4, f"pool solve {n} at {s}: {errs}")
    sweeps0 = pool.batched_sweeps
    t0 = time.perf_counter()
    many = pool.solve_many(reqs)
    sync()
    steps["solve_many_24_s"] = time.perf_counter() - t0
    buckets = len({(pool.get(n).dim, pool.get(n).dtype) for n in names})
    check(pool.batched_sweeps - sweeps0 == buckets == 2,
          f"{pool.batched_sweeps - sweeps0} sweeps for {buckets} buckets")
    check(all(torch.equal(w, lone[r]) for r, w in zip(reqs, many)),
          "a solve_many lane differs from the lone solve")
    report["solve_many"] = {"requests": len(reqs), "sweeps": buckets,
                            "lanes_bitwise": len(reqs)}

    # a SolveBatcher burst, twice on one batcher: 8 threads x 16 requests,
    # answers to the host; the first burst's first sweep is the batcher
    # thread's first solve
    lone_host = {r: w.cpu() for r, w in lone.items()}
    lone_lat = []
    for i in range(BATCHER_THREADS * BATCHER_REQUESTS):
        r = reqs[i % len(reqs)]
        t0 = time.perf_counter()
        pool.solve(*r).cpu()
        lone_lat.append(time.perf_counter() - t0)

    def burst(batcher) -> dict:
        answers, lat, failures = [], [], []

        def ask(i):
            try:
                for j in range(BATCHER_REQUESTS):
                    r = reqs[(i * BATCHER_REQUESTS + j) % len(reqs)]
                    t0 = time.perf_counter()
                    w = batcher.solve(*r).cpu()
                    lat.append(time.perf_counter() - t0)
                    answers.append((r, w))
            except Exception as e:
                failures.append(repr(e))

        sweeps0 = batcher.sweeps
        t0 = time.perf_counter()
        threads = [threading.Thread(target=ask, args=(i,))
                   for i in range(BATCHER_THREADS)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        check(not any(t.is_alive() for t in threads), "a batcher client hung")
        seconds = time.perf_counter() - t0
        check(not failures, f"batcher requests failed: {failures[:3]}")
        check(len(answers) == BATCHER_THREADS * BATCHER_REQUESTS,
              "batcher answers missing")
        check(all(torch.equal(w, lone_host[r]) for r, w in answers),
              "a SolveBatcher answer differs from the lone solve")
        return {"seconds": seconds, "sweeps": batcher.sweeps - sweeps0,
                "p50_ms": 1e3 * float(np.percentile(lat, 50)),
                "p99_ms": 1e3 * float(np.percentile(lat, 99)),
                "max_ms": 1e3 * max(lat), "answers_bitwise": len(answers)}

    with SolveBatcher(pool, window_s=BATCHER_WINDOW, lifted=False) as batcher:
        first, second = burst(batcher), burst(batcher)
        batcher_summary = batcher.summary()
    steps["batcher_bursts_s"] = first["seconds"] + second["seconds"]
    report["solve_batcher"] = {
        **batcher_summary, "first_burst": first, "second_burst": second,
        "lone_p50_ms": 1e3 * float(np.percentile(lone_lat, 50)),
        "lone_p99_ms": 1e3 * float(np.percentile(lone_lat, 99))}

    # max_warm=2: round robin over the 4 dense tenants evicts factor caches;
    # a solve after an eviction refactors and passes the same check
    pool.max_warm = 2
    ev0 = pool.summary()["factor_evictions"]
    t0 = time.perf_counter()
    for rnd in range(2):
        for n in dense:
            errs[f"evicted_{n}_{rnd}_vs_f64"] = rel_err(
                pool.solve(n, SIGMA), f64_solve(pool.stats(n), SIGMA))
    sync()
    steps["evicting_round_robin_s"] = time.perf_counter() - t0
    evictions = pool.summary()["factor_evictions"] - ev0
    check(evictions > 0, "max_warm=2 evicted no factor cache")
    for key in [k for k in errs if k.startswith("evicted_")]:
        check(errs[key] <= 1e-4, f"solve after eviction {key}: {errs[key]}")
    report["eviction"] = {"max_warm": 2, "factor_evictions": evictions,
                          "warm_tenants": len(pool.warm_tenants())}
    pool.max_warm = None

    # the background flusher: a producer thread streams 256 rows in chunks of
    # 16 into one warm dense tenant, no reads; the flusher (staleness 0.05 s)
    # and the coalescer (rank 64) fold them in. P and K2 run on both threads,
    # so their launch counts are reported, not checked.
    name = dense[0]
    for s in SIGMAS:
        pool.solve(name, s)
    eng = pool.get(name)
    ranks0, p0 = dict(eng.flush_ranks), K.launch_counts()
    rows_A, rows_b = ds.test_A[:FLUSH_ROWS], ds.test_b[:FLUSH_ROWS]
    produced = {}

    def produce():
        for i in range(0, FLUSH_ROWS, FLUSH_CHUNK):
            pool.ingest_rows_async(name, rows_A[i:i + FLUSH_CHUNK],
                                   rows_b[i:i + FLUSH_CHUNK])
            time.sleep(FLUSH_STALENESS / 2)
        produced["at"] = time.monotonic()

    pool.start_flusher()
    try:
        producer = threading.Thread(target=produce)
        producer.start()
        producer.join(timeout=120)
        check(not producer.is_alive(), "the producer hung")
        deadline = produced["at"] + 100 * FLUSH_STALENESS
        while pool.pending_deltas and time.monotonic() < deadline:
            time.sleep(FLUSH_STALENESS / 10)
        drained = time.monotonic()
        sync()
        pending = pool.pending_deltas
    finally:
        pool.stop_flusher()
    t_rec = pool.tenant(name)
    check(pending == 0, f"{pending} deltas pending after 100 x staleness")
    check(t_rec.background_flushes > 0, "the flusher never flushed")
    errs["flushed_vs_f64"] = rel_err(pool.solve(name, SIGMA),
                                     f64_solve(pool.stats(name), SIGMA))
    check(errs["flushed_vs_f64"] <= 1e-4, f"solve after the flusher: {errs['flushed_vs_f64']}")
    p1 = K.launch_counts()
    report["flusher"] = {
        "rows": FLUSH_ROWS, "chunk": FLUSH_CHUNK, "max_rank": FLUSH_RANK,
        "max_staleness_s": FLUSH_STALENESS,
        "drain_after_last_chunk_s": drained - produced["at"],
        "background_flushes": t_rec.background_flushes,
        "max_flush_age_s": t_rec.max_flush_age_s,
        "flush_ranks": {r: n - ranks0.get(r, 0) for r, n in eng.flush_ranks.items()
                        if n - ranks0.get(r, 0)},
        "launches_threaded": {k: p1[k] - p0[k] for k in ("panel_transform", "gemm_nt",
                                                         "gram_moment")}}

    # the stacked sweep against lone solves and one batched cholesky_solve
    entries = [pool.get(n).backend.solve_operands(pool.get(n).factor(s), s)
               for n in dense for s in SIGMAS]
    report["stacked_timing"] = {"card": smi(), **stacked_timing(entries)}
    del entries
    launches_b = K.launch_counts()
    for kname in ("gram_moment", "sketch_gram", "rff_gram"):
        check(launches_b[kname] > 0, f"kernel {kname} was not launched by the pool")
    summary = pool.summary()
    ledger = pool.ledger()
    pool.close()
    del pool, stats, lone, many, lone_host
    peak = torch.cuda.max_memory_allocated() / 2**30
    torch.cuda.empty_cache()
    return {"phase": "pool_serving", "dim": DIM, "clients": CLIENTS,
            "rows_per_client": ROWS, "tenants_a": POOL_TENANTS,
            "tenants_b": list(names), "errors": errs, "report": report,
            "steps_s": steps, "launches": launches, "launches_b": launches_b,
            "pool": {k: summary[k] for k in ("tenants", "placements",
                                             "background_flushes",
                                             "factor_evictions", "batched_sweeps",
                                             "batched_solves", "resident_stat_bytes")},
            "ledger_by_kind": ledger["by_kind"],
            "peak_mem_gb": peak, "seconds": time.perf_counter() - t_all}


# -- the sharded backend on a mesh of 8 shards of one card --------------------

def sharded_update_launches(be, updates: int) -> dict:
    """P and K2 launches of ``updates`` rank-r updates of one factor of
    ``be``: per block column, ceil(bs / 32) P and, inside the tile, a K2
    panel entry and a composing K2 between them; then a trailing K2 on each
    row shard with rows at or below the panel."""
    subs = -(-be.block_size // 32)
    trailing = sum(1 for k in range(be._nb) for ri in range(be._nrows)
                   if (ri + 1) * be._rl > k * be.block_size)
    return {"panel_transform": updates * be._nb * subs,
            "gemm_nt": updates * (be._nb * 2 * (subs - 1) + trailing)}


def sharded_factor_launches(be) -> int:
    """K2 launches of one cold factor: a SYRK on every shard holding rows
    and columns at or below the panel and not wholly above the diagonal, a
    TRSM for every panel but the last."""
    syrk = sum(1 for k in range(be._nb) for ri in range(be._nrows)
               for ci in range(be._ncols)
               if (ri + 1) * be._rl > k * be.block_size
               and (ci + 1) * be._cl > k * be.block_size
               and (ri + 1) * be._rl > ci * be._cl)
    return syrk + be._nb - 1


def factor_residual(eng, sigma: float) -> float:
    """||tril(L) tril(L)^T - (G + sigma I)||_F / ||G + sigma I||_F in
    float64, for the engine's cached sharded factor at ``sigma`` and its
    live padded block Gram: the factor itself, not a solve off it."""
    L = torch.tril(eng.factor(sigma).L.full()).double()
    Gs = eng.backend.gram.full().double()
    Gs.diagonal().add_(sigma)
    return float(torch.linalg.norm(L @ L.T - Gs) / torch.linalg.norm(Gs))


def sharded_serving_phase(ds, peaks) -> dict:
    from repro_torch import core, data, fed
    from repro_torch.core import compute_stats, privacy, threefry
    from repro_torch.kernels import gram as K
    from repro_torch.kernels import ref
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch.serve import serve_fusion
    from repro_torch.server import CoalescerPolicy, FusionEngine, ShardedBackend
    from repro_torch.server.cholesky import panel_transform_ref
    from repro_torch.server.distributed import SUB_PANEL, composed_panel_transform

    def sync():
        torch.cuda.synchronize()

    steps, errs, report, factor_errs = {}, {}, {}, {}
    t_all = time.perf_counter()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    mesh = mesh_lib.make_device_mesh(SHARD_DEVICES, device="cuda")
    check(mesh.shape == {"data": 4, "model": 2}
          and mesh.distinct_devices == [torch.device("cuda", 0)], f"mesh {mesh}")
    w_dense = fed.run_one_shot(ds, SIGMA).weights      # the comparison, uncounted
    K.reset_launch_counts()

    # 1. run_one_shot on the mesh: the dense path's weights and float64.
    t0 = time.perf_counter()
    res = fed.run_one_shot(ds, SIGMA, mesh=mesh)
    sync()
    steps["run_one_shot_s"] = time.perf_counter() - t0
    eng0 = res.extras["engine"]
    check(eng0.backend.name == "sharded" and "fused_stats" not in res.extras
          and isinstance(res.comm, fed.ShardedCommRecord), "run_one_shot(mesh=)")
    errs["one_shot_vs_f64"] = rel_err(res.weights, f64_solve(eng0.stats, SIGMA))
    errs["one_shot_vs_dense"] = rel_err(res.weights, w_dense)
    report["cross_shard_bytes"] = res.comm.cross_shard_bytes
    report["layout"] = {"padded": eng0.backend.padded,
                        "block_size": eng0.backend.block_size,
                        "block": [eng0.backend._rl, eng0.backend._cl],
                        "spec": list(eng0.backend.spec)}
    del res, eng0, w_dense

    # 2. an engine of the 8 clients on a ShardedBackend: the 4-sigma sweep
    t0 = time.perf_counter()
    stats = [compute_stats(A, b) for A, b in ds.clients]
    be = ShardedBackend(DIM, mesh)
    eng = FusionEngine.from_clients(stats, backend=be,
                                    coalesce=CoalescerPolicy(max_rank=SHARD_RANK))
    k2_0 = K.launch_counts()["gemm_nt"]
    ws = eng.solve_batch(SIGMAS, method="chol")
    sync()
    steps["engine_solve_batch_s"] = time.perf_counter() - t0
    factor_k2 = K.launch_counts()["gemm_nt"] - k2_0
    check(factor_k2 == len(SIGMAS) * sharded_factor_launches(be),
          f"4 factors launched K2 {factor_k2} times, want "
          f"{len(SIGMAS) * sharded_factor_launches(be)}")
    for sg, w in zip(SIGMAS, ws):
        errs[f"sweep_{sg}_vs_f64"] = rel_err(w, f64_solve(eng.stats, sg))
        factor_errs[f"cold_{sg}"] = factor_residual(eng, sg)
    w1 = eng.solve(SIGMA)
    check(torch.equal(w1, eng.solve(SIGMA)), "a cached sharded solve differs")
    sync()
    t0 = time.perf_counter()
    eng.solve(SIGMA)
    sync()
    steps["solve_s"] = time.perf_counter() - t0

    # 3. 256 streamed rows through the coalescer (rank 64): every cached
    #    factor updated on the tiles (P, K2), never refactored
    cold0, upd0 = eng.cold_factorizations, eng.incremental_updates
    rows_A, rows_b = ds.test_A[:STREAM_ROWS], ds.test_b[:STREAM_ROWS]
    l0 = K.launch_counts()
    t0 = time.perf_counter()
    for i in range(STREAM_ROWS):
        eng.ingest_rows_async(rows_A[i:i + 1], rows_b[i:i + 1], client_id=7)
    eng.flush()
    sync()
    steps["stream_rows_s"] = time.perf_counter() - t0
    l1 = K.launch_counts()
    updates = eng.incremental_updates - upd0
    stream = {k: l1[k] - l0[k] for k in ("panel_transform", "gemm_nt", "gram_moment")}
    want = sharded_update_launches(be, updates)
    check(updates == len(SIGMAS) * STREAM_ROWS // SHARD_RANK,
          f"{updates} factor updates for {STREAM_ROWS} rows")
    check(stream["panel_transform"] == want["panel_transform"]
          and stream["gemm_nt"] == want["gemm_nt"],
          f"streaming launched {stream}, want {want}")
    check(eng.cold_factorizations == cold0, "sharded streaming refactorized")
    for sg in SIGMAS:
        errs[f"stream_{sg}_vs_f64"] = rel_err(eng.solve(sg), f64_solve(eng.stats, sg))
        factor_errs[f"stream_{sg}"] = factor_residual(eng, sg)

    # 4. a 64-row client ingested, dropped and restored: rank-64 updates
    g = torch.Generator("cuda").manual_seed(5)
    A_s = torch.randn(SHARD_SMALL_ROWS, DIM, generator=g, device="cuda")
    b_s = torch.randn(SHARD_SMALL_ROWS, generator=g, device="cuda")
    t0 = time.perf_counter()
    eng.ingest_rows(A_s, b_s, client_id="small")
    eng.drop("small")
    w_drop = eng.solve(SIGMA)
    errs["drop_vs_f64"] = rel_err(w_drop, f64_solve(eng.stats, SIGMA))
    t_res = time.perf_counter()
    factor_errs["drop"] = factor_residual(eng, SIGMA)
    t_res = time.perf_counter() - t_res
    eng.restore("small")
    w_back = eng.solve(SIGMA)
    sync()
    steps["small_client_ingest_drop_restore_s"] = time.perf_counter() - t0 - t_res
    errs["restore_vs_f64"] = rel_err(w_back, f64_solve(eng.stats, SIGMA))
    factor_errs["restore"] = factor_residual(eng, SIGMA)
    check(eng.cold_factorizations == cold0, "drop / restore refactorized")
    report["engine"] = eng.summary()
    report["update_buckets"] = {f"{r}{'+' if up else '-'}": n
                                for (r, up), n in be.update_buckets.items()}
    report["k2_copies"] = be.k2_copies

    # 5. CG on the same statistics
    fused = eng.stats
    becg = ShardedBackend(DIM, mesh, method="cg")
    ecg = FusionEngine.from_stats(fused, backend=becg)
    t0 = time.perf_counter()
    w_cg = ecg.solve(SIGMA)
    sync()
    steps["cg_solve_s"] = time.perf_counter() - t0
    errs["cg_vs_f64"] = rel_err(w_cg, f64_solve(fused, SIGMA))
    report["cg_iterations"] = becg.cg_last_iters
    del eng, ecg, becg, fused, be

    # 6. ingest_distributed of all rows, mesh client 1 (rows 32768..65535)
    #    masked out: 4 K1 launches, one reduction into the blocks
    A_all = torch.cat([A for A, _ in ds.clients])
    b_all = torch.cat([b for _, b in ds.clients])
    k1_0 = K.launch_counts()["gram_moment"]
    bed = ShardedBackend(DIM, mesh)
    ed = FusionEngine(DIM, backend=bed, device="cuda")
    t0 = time.perf_counter()
    ed.ingest_distributed(A_all, b_all, participation=[1.0, 0.0, 1.0, 1.0])
    sync()
    steps["ingest_distributed_s"] = time.perf_counter() - t0
    check(K.launch_counts()["gram_moment"] - k1_0 == 4, "ingest_distributed: 4 K1")
    per = A_all.shape[0] // 4
    check(ed.count == 3 * per, f"ingest_distributed count {ed.count}")
    kept = [s for k, s in enumerate(stats) if k // 2 != 1]
    ref_stats = core.fuse_stats(kept)
    t0 = time.perf_counter()
    w_dist = ed.solve(SIGMA)
    sync()
    steps["ingest_distributed_solve_s"] = time.perf_counter() - t0
    errs["ingest_distributed_vs_f64"] = rel_err(w_dist, f64_solve(ref_stats, SIGMA))
    errs["ingest_distributed_gram_rel"] = rel_err(bed.stats().gram, ref_stats.gram)
    del ed, bed, A_all, b_all, kept, ref_stats, stats

    # 7. serve_fusion: 2 sharded and 2 auto tenants (threshold d: sharded)
    t0 = time.perf_counter()
    srv = serve_fusion(num_clients=SHARD_SERVE_CLIENTS,
                       samples_per_client=SHARD_SERVE_ROWS, dim=DIM,
                       tenants=SHARD_SERVE_TENANTS, sharded_tenants=2,
                       auto_tenants=2, threshold=DIM,
                       sigmas_per_tenant=len(SIGMAS),
                       queries=SHARD_SERVE_QUERIES, query_rows=8,
                       stream_deltas=SHARD_SERVE_STREAM, coalesce_rank=32,
                       flush_staleness_s=0.05, seed=3, device="cuda")
    sync()
    steps["serve_fusion_s"] = time.perf_counter() - t0
    check(srv["placements"] == {"sharded": SHARD_SERVE_TENANTS},
          f"serve_fusion placements {srv['placements']}")
    check(srv["pool"]["meshes_built"] == 1, f"meshes_built {srv['pool']['meshes_built']}")
    check(srv["streaming"]["pending_after"] == 0, "serve_fusion left deltas pending")
    errs["serve_fusion_rel"] = srv["exact_max_rel_err"]
    errs["serve_fusion_stream_rel"] = srv["streaming"]["exact_max_rel_err"]
    report["serve_fusion"] = {
        "naive_qps": srv["naive_qps"], "pool_qps": srv["pool_qps"],
        "flush_ranks": {int(r): n for r, n in srv["streaming"]["flush_ranks"].items()},
        "cross_shard_bytes": srv["ledger"]["cross_shard_bytes"],
        "meshes_built": srv["pool"]["meshes_built"]}

    # 8. distributed_stats with Algorithm 2's noise hook at d 1024: each
    #    mesh client's noisy statistics = its K1 statistics + its noise bits
    dsd = data.synthetic.generate(1, num_clients=4, samples_per_client=SHARD_DP_ROWS,
                                  dim=SHARD_DP_DIM, device="cuda")
    A_dp = torch.cat([A for A, _ in dsd.clients])
    b_dp = torch.cat([b for _, b in dsd.clients])
    key = threefry.key(PRIV_KEY)
    nf = privacy.make_dp_noise_fn(key, PRIV_EPS, PRIV_DELTA, SHARD_DP_DIM)
    seen = []

    def recording(idx, G, h):
        Gt, ht = nf(idx, G, h)
        seen.append((idx, G, h, Gt, ht))
        return Gt, ht

    t0 = time.perf_counter()
    s_dp = core.distributed_stats(A_dp, b_dp, mesh, client_axes=("data",),
                                  noise_fn=recording)
    sync()
    steps["distributed_stats_dp_s"] = time.perf_counter() - t0
    check([i for i, *_ in seen] == [0, 1, 2, 3], f"noise hook indices {[i for i, *_ in seen]}")
    tau = privacy.gaussian_tau(PRIV_EPS, PRIV_DELTA)
    noise_sum = None
    for k, G, h, Gt, ht in seen:
        E, e = dp_noise(threefry.fold_in(key, k), SHARD_DP_DIM, tau, tau)
        Et, et = torch.from_numpy(E).cuda(), torch.from_numpy(e).cuda()
        check(torch.equal(Gt, G + Et) and torch.equal(ht, h + et),
              f"mesh client {k}: noisy statistics != K1 statistics + its noise")
        noise_sum = E.astype(np.float64) if noise_sum is None else noise_sum + E
    clean = core.fuse_stats([compute_stats(A, b) for A, b in dsd.clients])
    rebuilt = clean.gram.double() + torch.from_numpy(noise_sum).cuda()
    errs["dp_fused_vs_f64_rebuild"] = rel_err(s_dp.gram, rebuilt)
    check(s_dp.yty is None, "privatized statistics keep no yty")
    check(torch.equal(s_dp.gram, s_dp.gram.T), "the noisy fused Gram is not symmetric")
    report["dp"] = {"dim": SHARD_DP_DIM, "rows_per_mesh_client": SHARD_DP_ROWS,
                    "tau": tau, "count": float(s_dp.count)}
    del dsd, A_dp, b_dp, seen, clean, rebuilt, s_dp
    sync()
    launches = K.launch_counts()
    for name in ("gram_moment", "gemm_nt", "panel_transform"):
        check(launches[name] > 0, f"kernel {name} was not launched on the sharded path")
    for name, err in errs.items():
        limit = 1e-6 if name == "dp_fused_vs_f64_rebuild" else 1e-4
        check(err <= limit, f"sharded {name} = {err} > {limit}")
    # the factors the tile updates left behind, held themselves: a float32
    # factor's own backward error is O(1e-7) at d 4096
    for name, err in factor_errs.items():
        check(err <= SHARD_FACTOR_TOL,
              f"sharded factor {name}: ||LL^T - (G + sigma I)|| / ||G + sigma I|| "
              f"= {err} > {SHARD_FACTOR_TOL}")

    # 9. K2 at the four sharded tile shapes against gemm_nt_ref and addmm,
    #    by wrapper and by device time (200 bare launches into preallocated
    #    outputs); the tile's composed P against the plain loop. Not counted
    #    above.
    lay = ShardedBackend(DIM, mesh)
    bs, rl, cl = lay.block_size, lay._rl, lay._cl
    del lay
    sub = SUB_PANEL + SHARD_RANK          # a sub-panel's columns and the update's
    shapes = {"syrk": (rl, cl, bs), "trsm": (DIM - bs, bs, bs),
              "update": (rl, bs + SHARD_RANK, bs + SHARD_RANK),
              "compose": (bs + SHARD_RANK, sub, sub)}
    gk = torch.Generator("cuda").manual_seed(11)
    k2_rows = {}
    for tag, (m, n, k) in shapes.items():
        C = torch.randn(m, n, generator=gk, device="cuda")
        Am = torch.randn(m, k, generator=gk, device="cuda")
        Bm = torch.randn(n, k, generator=gk, device="cuda")
        got = K.gemm_nt_cuda(C, Am, Bm, alpha=-1.0)
        want = ref.gemm_nt_ref(C, Am, Bm, alpha=-1.0)
        err = rel_err(got, want)
        check(err <= 1e-5, f"K2 at the sharded {tag} shape: {err} > 1e-5")
        ops, nbytes = 2.0 * m * n * k, 4.0 * (2 * m * n + m * k + n * k)
        bms, by = bound(ops, nbytes, peaks, rate="3xtf32")
        Oa = torch.empty_like(C)
        tile = K.gemm_tile(m, n, torch.float32)
        k2_rows[tag] = {
            "shape": [m, n, k], "rel_err": err,
            "max_abs_err": float((got - want).abs().max()),
            "route": "3xtf32 mma.sync", "tile": tile,
            "ctas": -(-m // tile) * -(-n // tile),
            "ms": cuda_ms(lambda: K.gemm_nt_cuda(C, Am, Bm, alpha=-1.0)),
            "device_ms": burst_ms(k2_general_bare(K, C, Am, Bm, -1.0), 200),
            "plain_ms": cuda_ms(lambda: ref.gemm_nt_ref(C, Am, Bm, alpha=-1.0)),
            "library_ms": cuda_ms(lambda: torch.addmm(C, Am, Bm.T, alpha=-1.0)),
            "library_device_ms": burst_ms(
                lambda: torch.addmm(C, Am, Bm.T, alpha=-1.0, out=Oa), 200),
            "bound_ms": bms, "bound_by": by,
            "bound_ms_fp32": bound(ops, nbytes, peaks)[0]}
        del C, Am, Bm, got, want, Oa
    report["k2_sharded_shapes"] = {"card": smi(), **k2_rows}
    Wt = torch.randn(bs, 2 * bs, generator=gk, device="cuda")
    Lt = torch.linalg.cholesky(Wt @ Wt.T / bs + torch.eye(bs, device="cuda")).contiguous()
    Xt = torch.randn(SHARD_RANK, bs, generator=gk, device="cuda")
    La, Ta = composed_panel_transform(Lt, Xt, sign=1.0)
    t0 = time.perf_counter()
    Lb, Tb = panel_transform_ref(Lt, Xt, sign=1.0)
    sync()
    p_plain_s = time.perf_counter() - t0
    p_err = max(rel_err(torch.tril(La), torch.tril(Lb)), rel_err(Ta, Tb))
    check(p_err <= 1e-4, f"composed P of a {bs}-wide tile: {p_err} > 1e-4")
    t_bms, t_by = tile_transform_bound(bs, SHARD_RANK, SUB_PANEL, peaks)
    report["tile_transform"] = {
        "bs": bs, "r": SHARD_RANK, "rel_err": p_err,
        "ms": cuda_ms(lambda: composed_panel_transform(Lt, Xt, sign=1.0)),
        "plain_s": p_plain_s, "bound_ms": t_bms, "bound_by": t_by,
        "tolerance": "rel 1e-4 (f32), not bitwise"}
    del La, Ta, Lb, Tb, Lt, Xt, Wt
    peak = torch.cuda.max_memory_allocated() / 2**30
    torch.cuda.empty_cache()
    return {"phase": "sharded_serving", "dim": DIM, "mesh": mesh.shape,
            "devices": [str(d) for d in mesh.distinct_devices],
            "errors": errs, "factor_residuals": factor_errs,
            "factor_tolerance": SHARD_FACTOR_TOL,
            "report": report, "steps_s": steps,
            "launches": launches,
            "stream_launches": {**stream, "updates": updates},
            "factor_k2_launches": sharded_factor_launches(ShardedBackend(DIM, mesh)),
            "peak_mem_gb": peak, "seconds": time.perf_counter() - t_all}


# -- phase 6: federated uploads over TCP into a pool on the card --------------

def timed(fn, store: list):
    """``fn`` that appends each call's seconds (synchronised) to ``store``."""
    def call(*args, **kw):
        t0 = time.perf_counter()
        out = fn(*args, **kw)
        torch.cuda.synchronize()
        store.append(time.perf_counter() - t0)
        return out
    return call


def round_trips(host: str, port: int, tenant: str, want: dict,
                threads: int = WIRE_SOLVE_THREADS) -> dict:
    """``threads`` connections, each asking WIRE_SOLVES / threads
    SolveFrames in turn over ``SIGMAS``: latency per round trip, and every
    answer equal to ``want[sigma]`` bitwise."""
    from repro_torch.fed import transport

    lat, failures = [], []

    def ask(i):
        try:
            with transport.TCPChannel(host, port) as ch:
                c = transport.FrameClient(ch)
                c.hello(tenant)
                for j in range(WIRE_SOLVES // threads):
                    s = SIGMAS[(i + j) % len(SIGMAS)]
                    t0 = time.perf_counter()
                    w = c.solve(s)
                    lat.append(time.perf_counter() - t0)
                    if not np.array_equal(w, want[s]):
                        failures.append(f"sigma {s}: answer differs")
        except Exception as e:
            failures.append(repr(e))

    workers = [threading.Thread(target=ask, args=(i,)) for i in range(threads)]
    for t in workers:
        t.start()
    for t in workers:
        t.join(timeout=300)
    check(not any(t.is_alive() for t in workers), "a solving client hung")
    check(not failures and len(lat) == WIRE_SOLVES, f"round trips: {failures[:3]}")
    return {"requests": len(lat), "threads": threads,
            "p50_ms": 1e3 * float(np.percentile(lat, 50)),
            "p99_ms": 1e3 * float(np.percentile(lat, 99)),
            "max_ms": 1e3 * max(lat), "answers_bitwise": len(lat)}


def wire_serving_phase(ds) -> dict:
    from repro_torch import core, data
    from repro_torch.core import compute_stats
    from repro_torch.fed import PackedStats, chaos, transport, wire
    from repro_torch.kernels import gram as K
    from repro_torch.server import EnginePool

    def sync():
        torch.cuda.synchronize()

    steps, errs, report = {}, {}, {"card": smi()}
    t_all = time.perf_counter()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    K.reset_launch_counts()
    pool = EnginePool()
    admit_s: list = []
    pool.admit_frame = timed(pool.admit_frame, admit_s)
    server = transport.FrameServer(pool).start()
    frames = {"stats": 0, "delta": 0, "control": 0, "solve": 0, "proj": 0,
              "rff": 0}

    def client(tenant, offers=("f32",), chunk=None, port=None, seed=0):
        return transport.ResilientClient(
            lambda: transport.TCPChannel(server.host, port or server.port),
            tenant=tenant, offers=offers, max_chunk_payload=chunk, seed=seed)

    def served(tenant, sigma):
        with client(tenant) as c:
            frames["solve"] += 1
            return torch.from_numpy(c.solve(sigma)).cuda()

    try:
        # 1. the dense tenant: each client's Phase 1 (K1) and its STATS
        #    frame over TCP; client 6 offers only bf16, client 3 carries
        #    moments, client 7's 33.6 MB frame travels as 4 MiB chunks
        t0 = time.perf_counter()
        stats = [compute_stats(A, b) for A, b in ds.clients]
        sync()
        steps["clients_phase1_s"] = time.perf_counter() - t0
        enc, dec, up, nbytes = [], [], [], []
        for k, s in enumerate(stats):
            dtype = "bf16" if k == WIRE_BF16_CLIENT else "f32"
            t0 = time.perf_counter()
            raw = wire.encode_frame(wire.StatsFrame.from_stats(
                s, client_id=f"client{k}", moments=k == WIRE_MOMENTS_CLIENT),
                dtype=dtype)
            enc.append(time.perf_counter() - t0)
            t0 = time.perf_counter()
            wire.decode_frame(raw)
            dec.append(time.perf_counter() - t0)
            nbytes.append(len(raw))
            with client("dense", (dtype,), WIRE_CHUNK if k == WIRE_CHUNK_CLIENT
                        else None) as c:
                t0 = time.perf_counter()
                ack = c.upload_stats(s, client_id=f"client{k}",
                                     moments=k == WIRE_MOMENTS_CLIENT)
                up.append(time.perf_counter() - t0)
                check(ack.ok and not ack.duplicate and c.dtype == dtype,
                      f"client {k}: {ack}, dtype {c.dtype}")
            frames["stats"] += 1
            if k == WIRE_CHUNK_CLIENT:
                parts = [wire.chunk_parts(p)[3]
                         for p in wire.split_frame(raw, max_chunk_payload=WIRE_CHUNK)]
                check(wire.join_chunks(wire.FT_STATS, wire.DTYPE_TAGS[dtype], parts)
                      == raw, "the chunks do not reassemble to the frame's bytes")
                chunks = len(parts)
        steps["stats_uploads_s"] = float(sum(up))
        summ = server.dispatcher.summary()
        check(summ["frames_reassembled"] == 1 and summ["chunks_received"] == chunks,
              f"chunking: {summ}")
        # the chunked frame again, whole: the reassembled bytes had the same
        # dedup key, so it is a duplicate and fuses nothing
        with client("dense") as c:
            ack = c.upload_stats(stats[WIRE_CHUNK_CLIENT],
                                 client_id=f"client{WIRE_CHUNK_CLIENT}")
        check(ack.ok and ack.duplicate, f"the unchunked re-send: {ack}")
        frames["stats"] += 1
        # in-process admission of the same statistics (bf16-rounded for
        # client 6) in the same order: the fused (G, h) bitwise
        ref = EnginePool()
        ref.create_tenant("dense", dim=DIM)
        for k, s in enumerate(stats):
            p = PackedStats.pack(s)
            if k == WIRE_BF16_CLIENT:
                p = PackedStats(p.tri.to(torch.bfloat16).float(),
                                p.moment.to(torch.bfloat16).float(), p.count, p.dim)
            ref.ingest("dense", p.unpack(), client_id=f"client{k}")
        got, want = pool.stats("dense"), ref.stats("dense")
        check(torch.equal(got.gram, want.gram) and torch.equal(got.moment, want.moment),
              "wire-fused (G, h) differs from in-process admission")
        check(int(got.count) == CLIENTS * ROWS, "fused count")
        ref.close()
        del ref, got, want
        report["stats_frames"] = {
            "bytes": nbytes, "chunks": chunks, "encode_s": enc, "decode_s": dec,
            "upload_s": up, "admit_s": admit_s[:CLIENTS],
            "encode_median_s": float(np.median(enc)),
            "decode_median_s": float(np.median(dec)),
            "upload_median_s": float(np.median(up)),
            "admit_median_s": float(np.median(admit_s[:CLIENTS]))}
        del pool.admit_frame          # the timing hook syncs the card: off

        # 2. 256 single-row DELTA frames (K1 on each row), admitted as the
        #    JAX package admits them: synchronously, fused one by one; then
        #    the served solve against float64
        launches0 = K.launch_counts()
        t0 = time.perf_counter()
        with client("dense") as c:
            for i in range(WIRE_STREAM):
                check(c.stream_rows(ds.test_A[i:i + 1], ds.test_b[i:i + 1],
                                    client_id="stream").ok, "delta frame refused")
        sync()
        steps["delta_256_frames_s"] = time.perf_counter() - t0
        frames["delta"] += WIRE_STREAM
        check(K.launch_counts()["gram_moment"] - launches0["gram_moment"] == WIRE_STREAM,
              "a DELTA frame did not run K1 once")
        eng = pool.get("dense")
        errs["served_vs_f64"] = rel_err(served("dense", SIGMA),
                                        f64_solve(pool.stats("dense"), SIGMA))
        check(errs["served_vs_f64"] <= 1e-4, f"served solve: {errs}")

        # 3. CONTROL drop and restore of the streaming client: a rank-256
        #    down- and update of the cached factor, P and K2 on every panel
        updates0, launches0 = eng.incremental_updates, K.launch_counts()
        t0 = time.perf_counter()
        for op, key in (("drop", "drop_vs_f64"), ("restore", "restore_vs_f64")):
            with client("dense") as c:
                check(c.control(op, "stream").ok, f"{op} refused")
            frames["control"] += 1
            errs[key] = rel_err(served("dense", SIGMA),
                                f64_solve(pool.stats("dense"), SIGMA))
            check(errs[key] <= 1e-4, f"solve after {op}: {errs}")
        sync()
        steps["drop_solve_restore_solve_s"] = time.perf_counter() - t0
        panels = -(-DIM // PANEL)
        updates = eng.incremental_updates - updates0
        control = {k: K.launch_counts()[k] - launches0[k]
                   for k in ("panel_transform", "gemm_nt")}
        # the PSD root's numerical rank (float32 eigh noise lifts it past
        # 256) decides whether the restore still fits the factor's update
        # budget, so one or two blocked updates
        check(updates >= 1 and control["panel_transform"] == updates * panels
              and control["gemm_nt"] == updates * (panels - 1),
              f"drop/restore: {control} launches for {updates} updates")
        report["control_launches"] = {**control, "updates": updates, "panels": panels}

        # 4. the feature tenants: 8 PROJ frames (K3, m 1024 of the dense
        #    data) and 8 RFF frames (K4, D 4096 of d 128 data), each tenant
        #    held to float64
        t0 = time.perf_counter()
        fm_s = core.FeatureMap("sketch", FEATURE_SEED, DIM, SKETCH_M)
        with client("sketch") as c:
            for k, (A, b) in enumerate(ds.clients):
                ps = fm_s.stats(A, b)
                check(c.upload_projected(PackedStats.pack(ps), d_orig=DIM,
                                         seed=FEATURE_SEED, rhash=fm_s.fhash,
                                         client_id=f"client{k}",
                                         yty=float(ps.yty)).ok, "PROJ refused")
        frames["proj"] += CLIENTS
        ds_rff = data.synthetic.generate(1, num_clients=CLIENTS,
                                         samples_per_client=ROWS, dim=RFF_DIM)
        fm_r = core.FeatureMap("rff", FEATURE_SEED, RFF_DIM, RFF_M,
                               lengthscale=RFF_DIM ** 0.5)
        with client("rff") as c:
            for k, (A, b) in enumerate(ds_rff.clients):
                rs = fm_r.stats(A, b)
                check(c.upload_rff(PackedStats.pack(rs), d_orig=RFF_DIM,
                                   seed=FEATURE_SEED, fhash=fm_r.fhash,
                                   lengthscale=fm_r.lengthscale,
                                   client_id=f"client{k}").ok, "RFF refused")
        frames["rff"] += CLIENTS
        del ds_rff
        (R,) = fm_s.materialize("cuda")
        errs["sketch_vs_f64"] = rel_err(
            served("sketch", SIGMA),
            R.double() @ f64_solve(pool.stats("sketch"), SIGMA))
        errs["rff_vs_f64"] = rel_err(served("rff", SIGMA),
                                     f64_solve(pool.stats("rff"), SIGMA))
        check(errs["sketch_vs_f64"] <= 1e-4 and errs["rff_vs_f64"] <= 1e-4,
              f"feature tenants over the wire: {errs}")
        sync()
        steps["feature_tenants_s"] = time.perf_counter() - t0

        # 5. chaos: every fault at rate 0.1, seed 7, in a proxy in front of a
        #    second server; its pool's fused stats are a clean pool's bits
        t0 = time.perf_counter()
        sched = chaos.ChaosSchedule(chaos.ChaosConfig.uniform(WIRE_CHAOS_RATE),
                                    seed=WIRE_CHAOS_SEED)
        cpool, clean = EnginePool(), EnginePool()
        clean.create_tenant("chaos", dim=DIM)
        summaries = []
        with transport.FrameServer(cpool) as csrv, \
                chaos.ChaosProxy(csrv.host, csrv.port, sched) as proxy:
            for k, s in enumerate(stats):
                with client("chaos", port=proxy.port, seed=k) as c:
                    c.retries = 40
                    check(c.upload_stats(s, client_id=f"client{k}").ok,
                          f"chaos upload {k}")
                    summaries.append(c.summary())
                clean.ingest("chaos", PackedStats.pack(s).unpack(),
                             client_id=f"client{k}")
            dispatch = csrv.dispatcher.summary()
        got, want = cpool.stats("chaos"), clean.stats("chaos")
        check(torch.equal(got.gram, want.gram) and torch.equal(got.moment, want.moment),
              "fused stats under chaos differ from the clean pool's")
        check(int(got.count) == CLIENTS * ROWS
              and len(cpool.get("chaos").client_ids) == CLIENTS,
              "an upload fused twice or not at all under chaos")
        check(dispatch["internal_errors"] == 0, f"chaos server: {dispatch}")
        fired = sched.summary()
        check(sum(fired["fired"].values()) > 0, "no fault fired")
        report["chaos"] = {
            "rate": WIRE_CHAOS_RATE, "seed": WIRE_CHAOS_SEED,
            "requests": fired["requests"], "fired": fired["fired"],
            "retries": sum(x["retries"] for x in summaries),
            "reconnects": sum(x["reconnects"] for x in summaries),
            "duplicate_acks": sum(x["duplicate_acks"] for x in summaries),
            "duplicates_fused_once": cpool.tenant("chaos").duplicates,
            "frames_rejected": dispatch["frames_rejected"],
            "uploads_admitted": dispatch["uploads_admitted"]}
        cpool.close()
        clean.close()
        del cpool, clean, got, want
        sync()
        steps["chaos_s"] = time.perf_counter() - t0

        # 6. 64 SolveFrame round trips from one connection, then from 8
        #    without and with the SolveBatcher window; every answer is the
        #    pool's own bits
        want = {s: pool.solve_lifted("dense", s).cpu().numpy() for s in SIGMAS}
        report["round_trips_one_connection"] = round_trips(
            server.host, server.port, "dense", want, threads=1)
        report["round_trips"] = round_trips(server.host, server.port, "dense", want)
        with transport.FrameServer(pool, solve_window_s=BATCHER_WINDOW) as bsrv:
            report["round_trips_window"] = round_trips(bsrv.host, bsrv.port,
                                                       "dense", want)
            report["round_trips_window"]["batcher"] = \
                bsrv.dispatcher.summary()["solve_batcher"]
        frames["solve"] += 3 * WIRE_SOLVES

        summ = server.dispatcher.summary()
        check(summ["internal_errors"] == 0 and summ["connection_errors"] == 0,
              f"dispatcher: {summ}")
        launches = K.launch_counts()
        for name in ("gram_moment", "sketch_gram", "rff_gram", "panel_transform",
                     "gemm_nt"):
            check(launches[name] > 0, f"kernel {name} was not launched on the wire path")
        check(launches["sketch_gram"] == CLIENTS and launches["rff_gram"] == CLIENTS,
              f"feature kernels: {launches}")
        check(launches["gram_moment"] == CLIENTS + WIRE_STREAM, f"K1: {launches}")
        ledger = pool.ledger()
        report["ledger"] = {k: ledger[k] for k in (
            "wire_upload_bytes", "wire_download_bytes", "streamed_bytes",
            "total_bytes", "by_tier")}
        report["ledger_by_kind"] = ledger["by_kind"]
        report["frames_by_kind"] = frames
        report["dispatcher"] = summ
        report["pool"] = {k: pool.summary()[k] for k in ("tenants", "duplicates")}
    finally:
        server.stop()
        pool.close()
    # a connection thread holds its session, and so the pool, until its
    # client has hung up: wait for them before the model phase's memory
    deadline = time.monotonic() + 30
    while server.active_connections and time.monotonic() < deadline:
        time.sleep(0.01)
    check(server.active_connections == 0, "a wire connection thread outlived its client")
    del pool, server, stats, eng, R
    gc.collect()
    peak = torch.cuda.max_memory_allocated() / 2**30
    torch.cuda.empty_cache()
    return {"phase": "wire_serving", "dim": DIM, "clients": CLIENTS,
            "rows_per_client": ROWS, "errors": errs, "report": report,
            "steps_s": steps, "launches": launches, "peak_mem_gb": peak,
            "left_allocated_gb": torch.cuda.memory_allocated() / 2**30,
            "seconds": time.perf_counter() - t_all}


# -- phase 7: the server and its clients as processes on the card ------------

class Proc:
    """A child process whose stdout lines a thread collects, so that no
    wait on it can block without a bound; stderr goes to a file."""

    def __init__(self, args: list, log: str):
        env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
        self.log = log
        self._err = open(log, "w")
        self.t0 = time.perf_counter()
        self.proc = subprocess.Popen([sys.executable, "-m", *map(str, args)],
                                     stdout=subprocess.PIPE, stderr=self._err,
                                     text=True, env=env, cwd=ROOT)
        self.lines: list[str] = []
        self.stamps: list[float] = []      # perf_counter at each line's arrival
        self._seen = threading.Condition()
        self._reader = threading.Thread(target=self._read, daemon=True)
        self._reader.start()

    def _read(self):
        for line in self.proc.stdout:
            with self._seen:
                self.lines.append(line)
                self.stamps.append(time.perf_counter())
                self._seen.notify_all()
        with self._seen:
            self._seen.notify_all()

    def wait_line(self, pattern: str, timeout: float = PROC_TIMEOUT):
        """The first stdout line matching ``pattern``, and the seconds from
        the spawn to its arrival; fails at ``timeout`` or when the process
        ends."""
        import re

        deadline = time.monotonic() + timeout
        with self._seen:
            while True:
                for line, stamp in zip(self.lines, self.stamps):
                    m = re.search(pattern, line)
                    if m:
                        return m, stamp - self.t0
                left = deadline - time.monotonic()
                check(left > 0 and (self.proc.poll() is None
                                    or self._reader.is_alive()),
                      f"{pattern!r} not printed: {self.tail()}")
                self._seen.wait(min(left, 1.0))

    def finish(self, timeout: float = PROC_TIMEOUT) -> str:
        """Wait for the exit, which must be 0; the whole stdout."""
        try:
            self.proc.wait(timeout=timeout)
            self.wall = time.perf_counter() - self.t0
        finally:
            self.kill()
        self._reader.join(timeout=30)
        check(self.proc.returncode == 0,
              f"exit {self.proc.returncode}: {self.tail()}")
        return "".join(self.lines)

    def kill(self):
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait(timeout=60)
        self._err.close()

    def tail(self) -> str:
        with open(self.log) as f:
            err = f.read()[-3000:]
        return "".join(self.lines)[-2000:] + err


def serve_proc(jdir: str, log: str, *extra) -> Proc:
    return Proc(["repro_torch.launch.serve", "--mode", "fusion", "--listen", 0,
                 "--journal-dir", jdir, "--sigma", SIGMA, *extra], log)


def serve_report(server: Proc) -> dict:
    import re

    out = server.finish()
    m = re.search(r"\[serve_wire\] report (.*)", out)
    check(m is not None, f"no report line: {server.tail()}")
    return json.loads(m.group(1))


def fs_type(path: str) -> str:
    """The type and mount point of the filesystem that holds ``path``."""
    path, best, kind = os.path.realpath(path), "", "unknown"
    with open("/proc/self/mounts") as f:
        for line in f:
            mnt, typ = line.split()[1:3]
            if ((path == mnt or path.startswith(mnt.rstrip("/") + "/"))
                    and len(mnt) >= len(best)):
                best, kind = mnt, typ
    return f"{kind} on {best}"


def du(path: str) -> int:
    return sum(os.path.getsize(os.path.join(d, f))
               for d, _, files in os.walk(path) for f in files)


def send_frames(port: int, frames) -> None:
    """One connection a frame, each answered with an ACK that is ok."""
    from repro_torch.fed import transport, wire

    for tenant, dtype, raw in frames:
        with transport.TCPChannel("127.0.0.1", port, timeout_s=PROC_TIMEOUT) as ch:
            check(transport.FrameClient(ch).hello(tenant, (dtype,)) == dtype,
                  "negotiation")
            ack = wire.decode_frame(ch.request(raw))
            check(isinstance(ack, wire.AckFrame) and ack.ok, f"upload: {ack}")


def weights64(w: torch.Tensor) -> list:
    """What the report holds: the served weights as float64 numbers."""
    return w.cpu().numpy().astype(np.float64).tolist()


def process_serving_phase() -> dict:
    import shutil

    from repro_torch import data
    from repro_torch.core import compute_stats
    from repro_torch.fed import PackedStats, wire
    from repro_torch.server import EnginePool

    t_all = time.perf_counter()
    steps, errs, report = {}, {}, {"card": smi()}
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    work = os.path.join(ROOT, "build", "process_serving")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    j1, j2, j2ref, j3 = (os.path.join(work, n) for n in ("j1", "j2", "j2ref", "j3"))
    report["journal_fs"] = fs_type(work)
    procs: list[Proc] = []
    try:
        # the clients' rows, drawn here by the generator they use (the
        # card's: the CPU's would give other numbers)
        ds = data.synthetic.generate(PROC_SEED, num_clients=PROC_CLIENTS,
                                     samples_per_client=ROWS, dim=DIM)
        ridge = [k for k in range(PROC_CLIENTS) if k != PROC_BF16_CLIENT]

        # 1. federation over processes: server A, 8 clients at once, then
        #    the delta-row client that solves
        a = serve_proc(j1, os.path.join(work, "a.err"), "--snapshot-every", 4,
                       "--expect-uploads", 9, "--serve-timeout", PROC_TIMEOUT)
        procs.append(a)
        m, steps["server_cold_start_to_listening_s"] = a.wait_line(
            r"listening on 127\.0\.0\.1:(\d+)")
        port = int(m.group(1))

        def client(k, *extra):
            return Proc(["repro_torch.launch.client", "--connect",
                         f"127.0.0.1:{port}", "--seed", PROC_SEED,
                         "--num-clients", PROC_CLIENTS, "--client-index", k,
                         "--samples", ROWS, "--dim", DIM, *extra],
                        os.path.join(work, f"client{k}.err"))

        def flags(k):
            if k == PROC_BF16_CLIENT:
                return ["--tenant", "lowp", "--offer", "bf16"]
            out = ["--tenant", "ridge"]
            if k == PROC_MOMENTS_CLIENT:
                out.append("--moments")
            if k == PROC_CHUNK_CLIENT:
                out += ["--max-chunk-payload", PROC_CHUNK]
            return out

        t0 = time.perf_counter()
        wave = [client(k, *flags(k)) for k in range(PROC_CLIENTS - 1)]
        procs += wave
        reps = [json.loads(c.finish().strip().splitlines()[-1]) for c in wave]
        steps["eight_clients_at_once_s"] = time.perf_counter() - t0
        last = client(PROC_CLIENTS - 1, "--tenant", "ridge", "--delta-batches",
                      PROC_DELTA_BATCHES, "--solve", SIGMA)
        procs.append(last)
        t0 = time.perf_counter()
        reps.append(json.loads(last.finish().strip().splitlines()[-1]))
        steps["delta_client_s"] = time.perf_counter() - t0
        rep_a = serve_report(a)
        report["clients"] = [{"index": k, "wall_s": c.wall, **r["seconds"],
                              "negotiated_dtype": r["negotiated_dtype"],
                              "bytes_uploaded": r["bytes_uploaded"],
                              "k1_launches": r["launches"]["gram_moment"]}
                             for k, (r, c) in enumerate(zip(reps, wave + [last]))]
        for k, r in enumerate(reps):
            check(r["ok"] and r["negotiated_dtype"]
                  == ("bf16" if k == PROC_BF16_CLIENT else "f32"),
                  f"client {k}: {r['negotiated_dtype']}")
            check(r["launches"]["gram_moment"]
                  == (0 if k == PROC_CLIENTS - 1 else 1),
                  f"client {k} ran K1 {r['launches']['gram_moment']} times")
        check(rep_a["transport"]["uploads_admitted"]
              == PROC_CLIENTS - 1 + PROC_DELTA_BATCHES, f"A: {rep_a['transport']}")
        check(rep_a["transport"]["frames_reassembled"] == 1, "chunked client")
        check(rep_a["transport"]["internal_errors"] == 0, "A: internal errors")
        check(rep_a["ledger"]["wire_upload_bytes"]
              == sum(r["bytes_uploaded"] for r in reps), "A: ledger")
        check(reps[-1]["solve"]["weights"] == rep_a["weights"]["ridge"],
              "the delta client's weights are not the report's")
        stats64 = [compute_stats(A.double(), b.double()) for A, b in ds.clients]
        fused = stats64[ridge[0]]
        for k in ridge[1:]:
            fused = fused + stats64[k]
        w_ridge = torch.tensor(rep_a["weights"]["ridge"], device="cuda")
        errs["ridge_vs_f64"] = rel_err(w_ridge, f64_solve(fused, SIGMA))
        s6 = compute_stats(*ds.clients[PROC_BF16_CLIENT])   # K1, as client 6
        p6 = PackedStats.pack(s6)
        s6 = PackedStats(p6.tri.to(torch.bfloat16).float(),
                         p6.moment.to(torch.bfloat16).float(), p6.count,
                         p6.dim).unpack()
        errs["lowp_vs_f64_of_bf16_stats"] = rel_err(
            torch.tensor(rep_a["weights"]["lowp"], device="cuda"),
            f64_solve(s6, SIGMA))
        check(errs["ridge_vs_f64"] <= 1e-4 and errs["lowp_vs_f64_of_bf16_stats"] <= 1e-4,
              f"process federation: {errs}")
        report["server_a"] = {k: rep_a["pool"][k] for k in (
            "snapshots_taken", "journaled", "tenants")}
        report["server_a"]["transport"] = rep_a["transport"]
        report["server_a"]["wire_upload_bytes"] = rep_a["ledger"]["wire_upload_bytes"]
        del stats64, fused, w_ridge, s6, p6

        # 2. SIGKILL and restart: server B takes the 8 clients' STATS frames
        #    one at a time (encoded here from the same statistics), half of
        #    one more frame is in flight, B is killed; C restarts on B's
        #    journal. The reference: an in-process pool on the card, fed the
        #    same frames in the same order, never killed (journaled on a
        #    directory of its own, which times the journal and snapshots)
        frames = []
        for k in range(CLIENTS):
            s = compute_stats(*ds.clients[k])
            bf16 = k == PROC_BF16_CLIENT
            frames.append(("lowp" if bf16 else "ridge", "bf16" if bf16 else "f32",
                           wire.encode_frame(wire.StatsFrame.from_stats(
                               s, client_id=f"client{k}",
                               moments=k == PROC_MOMENTS_CLIENT),
                               dtype="bf16" if bf16 else "f32")))
        del ds, s
        b_srv = serve_proc(j2, os.path.join(work, "b.err"), "--snapshot-every", 3,
                           "--expect-uploads", 999, "--serve-timeout", PROC_TIMEOUT)
        procs.append(b_srv)
        m, _ = b_srv.wait_line(r"listening on 127\.0\.0\.1:(\d+)")
        port_b = int(m.group(1))
        t0 = time.perf_counter()
        send_frames(port_b, frames)
        steps["server_b_eight_stats_frames_s"] = time.perf_counter() - t0
        torn = socket.create_connection(("127.0.0.1", port_b), timeout=30)
        torn.sendall(frames[0][2][:len(frames[0][2]) // 2])
        b_srv.proc.kill()                                   # SIGKILL
        b_srv.proc.wait(timeout=60)
        torn.close()
        report["server_b_journal_bytes"] = du(j2)
        sent = sum(len(raw) for _, _, raw in frames)

        ref = EnginePool(journal_dir=j2ref, snapshot_every=3)
        admit_s, append_s, commit_s = [], [], []
        ref._journal.append = timed(ref._journal.append, append_s)
        ref._store.commit_snapshot = timed(ref._store.commit_snapshot, commit_s)
        for tenant, _, raw in frames:
            frame = wire.decode_frame(raw)
            t0 = time.perf_counter()
            check(ref.admit_frame(tenant, frame, encoded_len=len(raw),
                                  raw=raw).ok, "ref admit")
            torch.cuda.synchronize()
            admit_s.append(time.perf_counter() - t0)
        del frame
        want = {t: weights64(ref.solve_lifted(t, SIGMA)) for t in ref.tenant_names}
        report["journaled_stats_admission"] = {
            "frame_bytes": len(frames[0][2]), "admit_s": admit_s,
            "append_flush_fsync_s": append_s,
            "admit_median_s": float(np.median(admit_s)),
            "append_median_s": float(np.median(append_s)),
            "snapshot_commit_s": commit_s,
            "snapshots": ref.snapshots_taken,
            "snapshot_dir_bytes": du(os.path.join(j2ref, "snapshots"))}
        del ref._store.commit_snapshot, ref._journal.append   # the timing hooks
        ref.close()
        del ref

        c_srv = serve_proc(j2, os.path.join(work, "c.err"), "--serve-timeout", 2)
        procs.append(c_srv)
        _, to_recovered = c_srv.wait_line(r"\[serve_wire\] recovered")
        _, steps["restart_to_listening_s"] = c_srv.wait_line(r"listening on")
        rep_c = serve_report(c_srv)
        report["restart"] = {
            "recovered_line_s": to_recovered,
            "restored_tenants": rep_c["pool"]["restored_tenants"],
            "replayed_frames": rep_c["pool"]["replayed_frames"],
            "uploads_admitted": rep_c["transport"]["uploads_admitted"],
            "connections_total": rep_c["connections_total"],
            "wire_upload_bytes": rep_c["ledger"]["wire_upload_bytes"],
            "bytes_sent": sent}
        check(rep_c["transport"]["uploads_admitted"] == 0
              and rep_c["connections_total"] == 0, f"restart: {report['restart']}")
        check(rep_c["ledger"]["wire_upload_bytes"] == sent,
              f"the restarted ledger lost bytes: {report['restart']}")
        check(sorted(rep_c["weights"]) == sorted(want), "restored tenants")
        for t, w in want.items():
            check(rep_c["weights"][t] == w, f"tenant {t}: restored weights "
                  "differ from the uncrashed pool's")
        report["restart"]["weights_bitwise"] = sorted(want)

        # 3. SIGTERM: server D takes one upload; its final snapshot leaves a
        #    journal that replays nothing
        d_srv = serve_proc(j3, os.path.join(work, "d.err"), "--expect-uploads",
                           999, "--serve-timeout", PROC_TIMEOUT)
        procs.append(d_srv)
        m, _ = d_srv.wait_line(r"listening on 127\.0\.0\.1:(\d+)")
        send_frames(int(m.group(1)), frames[:1])
        d_srv.proc.send_signal(signal.SIGTERM)
        rep_d = serve_report(d_srv)
        check(rep_d["sigterm"] is True, "SIGTERM was not seen")
        pool = EnginePool(journal_dir=j3)
        report["sigterm"] = {"restored_tenants": pool.restored_tenants,
                             "replayed_frames": pool.replayed_frames}
        check(pool.restored_tenants == 1 and pool.replayed_frames == 0,
              f"after SIGTERM: {report['sigterm']}")
        pool.close()
        del pool
    finally:
        for p in procs:
            p.kill()
    gc.collect()
    peak = torch.cuda.max_memory_allocated() / 2**30
    torch.cuda.empty_cache()
    shutil.rmtree(work, ignore_errors=True)
    return {"phase": "process_serving", "dim": DIM, "clients": PROC_CLIENTS,
            "rows_per_client": ROWS, "errors": errs, "report": report,
            "steps_s": steps, "peak_mem_gb_this_process": peak,
            "seconds": time.perf_counter() - t_all}


# -- phase 8: the relay tier as processes on the card -------------------------

def relay_proc(jdir: str, log: str, relay_id: str, root_port: int, *extra) -> Proc:
    return Proc(["repro_torch.launch.serve", "--mode", "relay", "--upstream",
                 f"127.0.0.1:{root_port}", "--journal-dir", jdir, "--relay-id",
                 relay_id, "--max-chunk-payload", RELAY_CHUNK, "--forward-every",
                 RELAY_FORWARD_EVERY, "--sigma", SIGMA, *extra], log)


def proc_launches(server: Proc) -> dict:
    """The kernel launches a finished ``serve`` process printed."""
    import re

    m = re.search(r"\[serve_wire\] launches (.*)", "".join(server.lines))
    check(m is not None, f"no launches line: {server.tail()}")
    return json.loads(m.group(1))


def relay_frame(pool, tenant: str, relay_id: str, epoch: int, gram, moment,
                count: int, yty):
    """The frame a relay forwards for ``tenant`` of ``pool``, built here
    from host arrays with the wire codec (not through the forwarder)."""
    from repro_torch.core import SuffStats
    from repro_torch.fed import PackedStats, wire

    packed = PackedStats.pack(SuffStats(
        torch.from_numpy(gram), torch.from_numpy(moment), torch.tensor(count),
        None if yty is None else torch.from_numpy(np.asarray(yty))))
    cid = wire.relay_client_id(relay_id, epoch)
    fm = pool.tenant(tenant).feature_map
    if fm is None:
        return wire.encode_frame(wire.StatsFrame.from_packed(
            packed, client_id=cid, moments=yty is not None))
    return wire.encode_frame(wire.RFFFrame(
        tri=wire.host_array(packed.tri), moment=wire.host_array(packed.moment),
        count=int(packed.count), dim=int(packed.dim), d_orig=fm.d_orig,
        seed=fm.seed, fhash=fm.fhash, lengthscale=fm.lengthscale, client_id=cid,
        yty=None if yty is None else float(yty)))


def host_stats(pool, tenant: str) -> tuple:
    s = pool.stats(tenant)
    return (s.gram.cpu().numpy(), s.moment.cpu().numpy(), int(s.count),
            None if s.yty is None else s.yty.cpu().numpy())


def relay_serving_phase() -> dict:
    """Clients -> two relays -> root, all processes of the port on the card.

    The root's weights are held to float64 and, bitwise, to an in-process
    pool on the card that admits the frames rebuilt here from the relays'
    journals (restored with ``server.durability``) in the root's admission
    order (read from the root's journal): fused sums are not associative in
    float, so the reference folds as the tree did, per relay, then across.
    """
    import shutil

    from repro_torch import data
    from repro_torch.core import compute_stats
    from repro_torch.fed import transport, wire
    from repro_torch.server import EnginePool, ForwardPolicy, RelayForwarder
    from repro_torch.server.durability import scan_segment

    t_all = time.perf_counter()
    steps, errs, report = {}, {}, {"card": smi()}
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    work = os.path.join(ROOT, "build", "relay_serving")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    jroot, j0, j1 = (os.path.join(work, n) for n in ("root", "r0", "r1"))
    report["journal_fs"] = fs_type(work)
    procs: list[Proc] = []
    pools: list = []
    lengthscale = RFF_DIM ** 0.5
    listening = r"listening on 127\.0\.0\.1:(\d+)"
    try:
        # 1. the root, then both relays at once
        root = serve_proc(jroot, os.path.join(work, "root.err"), "--serve-timeout",
                          RELAY_SERVE_TIMEOUT)
        procs.append(root)
        m, steps["root_spawn_to_listening_s"] = root.wait_line(listening)
        root_port = int(m.group(1))
        relays = {r: relay_proc(j, os.path.join(work, f"{r}.err"), r, root_port,
                                "--serve-timeout", RELAY_SERVE_TIMEOUT)
                  for r, j in (("r0", j0), ("r1", j1))}
        procs += relays.values()
        ports = {}
        for r, p in relays.items():
            m, steps[f"{r}_spawn_to_listening_s"] = p.wait_line(listening)
            ports[r] = int(m.group(1))

        # 2. the clients, all at once: 4 dense on each relay, 2 RFF on r0
        def client(relay_port, log, *args):
            return Proc(["repro_torch.launch.client", "--connect",
                         f"127.0.0.1:{relay_port}", "--samples", ROWS, *args],
                        os.path.join(work, log))

        def dense(k, relay_port, *extra):
            return client(relay_port, f"dense{k}.err", "--tenant", "ridge",
                          "--seed", PROC_SEED, "--num-clients", 2 * RELAY_DENSE + 1,
                          "--client-index", k, "--dim", DIM, *extra)

        t0 = time.perf_counter()
        wave = [dense(k, ports["r0" if k < RELAY_DENSE else "r1"])
                for k in range(2 * RELAY_DENSE)]
        wave += [client(ports["r0"], f"rff{k}.err", "--tenant", "rff", "--seed", 1,
                        "--num-clients", RELAY_RFF, "--client-index", k, "--dim",
                        RFF_DIM, "--features", "rff", "--feature-dim", RFF_M,
                        "--lengthscale", repr(lengthscale), "--proj-seed",
                        FEATURE_SEED) for k in range(RELAY_RFF)]
        procs += wave
        reps = [json.loads(c.finish().strip().splitlines()[-1]) for c in wave]
        steps["ten_clients_at_once_s"] = time.perf_counter() - t0
        for k, r in enumerate(reps):
            kernel = "gram_moment" if k < 2 * RELAY_DENSE else "rff_gram"
            check(r["ok"] and r["launches"][kernel] == 1,
                  f"client {k}: {r['launches']}")

        # 3. r1 is SIGKILLed (its clients all ACKed, nothing forwarded); its
        #    journal is copied for the reference. r0 is SIGTERMed: its exit
        #    forwards epoch 0 of both tenants
        relays["r1"].proc.kill()
        relays["r1"].proc.wait(timeout=60)
        shutil.copytree(j1, j1 + "_ref")
        relays["r0"].proc.send_signal(signal.SIGTERM)
        t0 = time.perf_counter()
        rep_r0a = serve_report(relays["r0"])
        steps["r0_sigterm_to_exit_s"] = time.perf_counter() - t0
        check(rep_r0a["sigterm"] and rep_r0a["relay"]["forwards"] == 2
              and rep_r0a["ledger"]["tier"] == "relay", f"r0: {rep_r0a['relay']}")
        shutil.copytree(j0, j0 + "_epoch0")

        # 4. both relays restart on their journals at once: r1 (short
        #    timeout) forwards its replayed fusion and exits; r0 takes a
        #    SOLVE (a cached factor) and the DELTA client, then a SIGTERM
        r1b = relay_proc(j1, os.path.join(work, "r1b.err"), "r1", root_port,
                         "--serve-timeout", 2)
        r0b = relay_proc(j0, os.path.join(work, "r0b.err"), "r0", root_port,
                         "--serve-timeout", RELAY_SERVE_TIMEOUT)
        procs += [r1b, r0b]
        _, to_recovered = r1b.wait_line(r"\[serve_wire\] recovered")
        _, steps["r1_restart_to_listening_s"] = r1b.wait_line(listening)
        rep_r1b = serve_report(r1b)
        steps["r1_restart_to_exit_s"] = r1b.wall
        report["r1_restart"] = {
            "recovered_line_s": to_recovered, "serve_timeout_s": 2,
            "replayed_frames": rep_r1b["pool"]["replayed_frames"],
            "connections_total": rep_r1b["connections_total"],
            "forwards": rep_r1b["relay"]["forwards"]}
        check(rep_r1b["connections_total"] == 0
              and rep_r1b["transport"]["uploads_admitted"] == 0
              and rep_r1b["pool"]["replayed_frames"] == RELAY_DENSE
              and rep_r1b["relay"]["forwards"] == 1,
              f"r1 restart: {report['r1_restart']}")
        m, steps["r0_restart_to_listening_s"] = r0b.wait_line(listening)
        port_r0b = int(m.group(1))
        t0 = time.perf_counter()
        with transport.TCPChannel("127.0.0.1", port_r0b, timeout_s=PROC_TIMEOUT) as ch:
            c = transport.FrameClient(ch)
            c.hello("ridge")
            c.solve(SIGMA)
        steps["r0_cold_solve_round_trip_s"] = time.perf_counter() - t0
        last = dense(2 * RELAY_DENSE, port_r0b, "--delta-batches",
                     RELAY_DELTA_BATCHES, "--solve", SIGMA)
        procs.append(last)
        t0 = time.perf_counter()
        rep_delta = json.loads(last.finish().strip().splitlines()[-1])
        steps["delta_client_s"] = time.perf_counter() - t0
        r0b.proc.send_signal(signal.SIGTERM)
        rep_r0b = serve_report(r0b)
        check(rep_r0b["relay"]["forwards"] == 3 and rep_r0b["relay"]["empty_skips"] == 1
              and rep_r0b["relay"]["resumed_pending"] == 0, f"r0: {rep_r0b['relay']}")

        # 5. the root's journal: what it admitted, in its order
        segs = sorted(f for f in os.listdir(jroot) if f.startswith("wal_"))
        admitted = [rec for f in segs
                    for rec in scan_segment(os.path.join(jroot, f)).records]
        root.proc.send_signal(signal.SIGTERM)
        rep_root = serve_report(root)

        # 6. the reference: the relays' fused statistics restored from their
        #    journals on the card, the frames rebuilt from them
        def restored(jdir):
            pool = EnginePool(journal_dir=jdir)
            pools.append(pool)
            return pool

        p0a, p1, p0b = restored(j0 + "_epoch0"), restored(j1 + "_ref"), restored(j0)
        want = {}
        for tenant in ("ridge", "rff"):
            want[(tenant, wire.relay_client_id("r0", 0))] = relay_frame(
                p0a, tenant, "r0", 0, *host_stats(p0a, tenant))
        want[("ridge", wire.relay_client_id("r1", 0))] = relay_frame(
            p1, "ridge", "r1", 0, *host_stats(p1, "ridge"))
        (g0, h0, n0, y0), (g1, h1, n1, y1) = (host_stats(p0a, "ridge"),
                                              host_stats(p0b, "ridge"))
        want[("ridge", wire.relay_client_id("r0", 1))] = relay_frame(
            p0b, "ridge", "r0", 1, g1 - g0, h1 - h0, n1 - n0,
            None if y1 is None else y1 - y0)
        got = {(rec.tenant, rec.frame.client_id): rec.raw for rec in admitted}
        check(len(admitted) == len(want) and got.keys() == want.keys(),
              f"root admitted {sorted(got)}")
        for key, raw in want.items():
            check(got[key] == raw, f"forwarded frame {key} differs from the "
                  "one rebuilt from the relay's journal")
        ref = EnginePool()
        pools.append(ref)
        for rec in admitted:                     # the root's order
            raw = want[(rec.tenant, rec.frame.client_id)]
            check(ref.admit_frame(rec.tenant, wire.decode_frame(raw),
                                  encoded_len=len(raw), raw=raw).ok,
                  "reference admission")
        for tenant in ("ridge", "rff"):
            check(rep_root["weights"][tenant] == weights64(ref.solve_lifted(tenant, SIGMA)),
                  f"root {tenant}: weights differ from the tree-associated "
                  "in-process pool's")
        report["root_order"] = [rec.frame.client_id for rec in admitted]

        # 7. float64: the root's ridge against all 9 clients' rows, the DELTA
        #    client's relay solve against r0's rows, rff against its stats
        ds = data.synthetic.generate(PROC_SEED, num_clients=2 * RELAY_DENSE + 1,
                                     samples_per_client=ROWS, dim=DIM)
        stats64 = [compute_stats(A.double(), b.double()) for A, b in ds.clients]
        del ds
        r0_rows = stats64[0]
        for k in list(range(1, RELAY_DENSE)) + [2 * RELAY_DENSE]:
            r0_rows = r0_rows + stats64[k]
        everyone = r0_rows
        for k in range(RELAY_DENSE, 2 * RELAY_DENSE):
            everyone = everyone + stats64[k]
        errs["root_ridge_vs_f64"] = rel_err(
            torch.tensor(rep_root["weights"]["ridge"], device="cuda"),
            f64_solve(everyone, SIGMA))
        errs["r0_delta_client_solve_vs_f64"] = rel_err(
            torch.tensor(rep_delta["solve"]["weights"], device="cuda"),
            f64_solve(r0_rows, SIGMA))
        errs["root_rff_vs_f64"] = rel_err(
            torch.tensor(rep_root["weights"]["rff"], device="cuda"),
            f64_solve(ref.stats("rff"), SIGMA))
        del stats64, r0_rows, everyone
        check(all(e <= 1e-4 for e in errs.values()), f"relay tier: {errs}")

        # 8. the root's ledger: relay frames only, their bytes the relays'
        frames = rep_r0b["relay"]["forwards"] + rep_r1b["relay"]["forwards"]
        led = rep_root["ledger"]
        check(led["by_tier"] == {"relay_frames": frames, "client_frames": 0}
              and frames == len(admitted), f"root by_tier {led['by_tier']}")
        fwd_bytes = rep_r0b["relay"]["forwarded_bytes"] + rep_r1b["relay"]["forwarded_bytes"]
        check(fwd_bytes == sum(len(rec.raw) for rec in admitted),
              f"forwarded {fwd_bytes} bytes")
        chunk_bytes = sum(u["bytes_uploaded"] for rep in (rep_r0a, rep_r0b, rep_r1b)
                          for u in rep["relay"]["upstream"].values())
        check(led["wire_upload_bytes"] == chunk_bytes,
              f"root ledger {led['wire_upload_bytes']} != {chunk_bytes} bytes sent")
        chunked = sum(len(wire.split_frame(rec.raw, max_chunk_payload=RELAY_CHUNK)) > 1
                      for rec in admitted)
        check(rep_root["transport"]["frames_reassembled"] == chunked,
              f"root transport {rep_root['transport']}")
        report["root"] = {"by_tier": led["by_tier"],
                          "wire_upload_bytes": led["wire_upload_bytes"],
                          "forwarded_frame_bytes": fwd_bytes,
                          "transport": rep_root["transport"]}
        report["relays"] = {"r0": rep_r0b["relay"], "r1": rep_r1b["relay"]}

        # 9. launches: the clients' and the servers' own reports
        launches = {name: 0 for name in reps[0]["launches"]}
        for r in reps + [rep_delta]:
            for name, n in r["launches"].items():
                launches[name] += n
        servers = {"root": proc_launches(root), "r0": proc_launches(relays["r0"]),
                   "r0_restart": proc_launches(r0b), "r1_restart": proc_launches(r1b)}
        for counts in servers.values():
            for name, n in counts.items():
                launches[name] += n
        report["server_launches"] = servers
        check(servers["r0_restart"]["gram_moment"] == RELAY_DELTA_BATCHES,
              f"r0 K1 on DELTA frames: {servers['r0_restart']}")
        for name in ("gram_moment", "rff_gram", "panel_transform", "gemm_nt"):
            check(launches[name] > 0, f"kernel {name} was not launched on the relay path")

        # 10. one forward's steps, timed in process on r0's restored state:
        #     epoch 0 of "ridge" into a root pool behind a FrameServer, then
        #     one more STATS frame (r1's first) and epoch 1
        sink = EnginePool()
        pools.append(sink)
        relay = restored(shutil.copytree(j0 + "_epoch0", j0 + "_timing"))
        with transport.FrameServer(sink) as srv:
            fwd = RelayForwarder(relay, lambda: transport.TCPChannel(srv.host, srv.port),
                                 relay_id="timing", max_chunk_payload=RELAY_CHUNK,
                                 state_dir=os.path.join(work, "timing_state"),
                                 policy=ForwardPolicy(max_frames=None))
            t = {k: [] for k in ("d2h", "delta", "commit", "send")}
            sizes = []
            fwd._stats_arrays = timed(fwd._stats_arrays, t["d2h"])
            fwd._delta = timed(fwd._delta, t["delta"])
            save = timed(fwd._save_state, t["commit"])

            def save_and_size(st):
                save(st)
                sizes.append(os.path.getsize(fwd._state_path(st.tenant)))
            fwd._save_state = save_and_size
            fwd._send_pending = timed(fwd._send_pending, t["send"])
            forwards = []
            for epoch in range(2):
                if epoch:
                    rec = scan_segment(os.path.join(j1 + "_ref", sorted(
                        f for f in os.listdir(j1 + "_ref") if f.startswith("wal_"))[0])).records[0]
                    check(relay.admit_frame("ridge", rec.frame, encoded_len=len(rec.raw),
                                            raw=rec.raw).ok, "timing admission")
                t0 = time.perf_counter()
                check(fwd.forward_tenant("ridge"), "timing forward")
                total = time.perf_counter() - t0
                pending, final = t["commit"][-2:]
                upload = t["send"][-1] - final
                forwards.append({
                    "total_s": total, "d2h_s": t["d2h"][-1], "delta_s": t["delta"][-1],
                    "encode_s": total - t["d2h"][-1] - t["delta"][-1] - pending - t["send"][-1],
                    "commit_s": pending + final, "upload_s": upload,
                    "pending_record_bytes": sizes[-2], "state_record_bytes": sizes[-1]})
            fwd.close(forward=False)
        report["forward_steps"] = forwards
        report["forward_frame_bytes"] = len(want[("ridge", wire.relay_client_id("r0", 0))])
    finally:
        for p in procs:
            p.kill()
        for pool in pools:
            pool.close()
    del pools
    gc.collect()
    peak = torch.cuda.max_memory_allocated() / 2**30
    torch.cuda.empty_cache()
    shutil.rmtree(work, ignore_errors=True)
    return {"phase": "relay_serving", "dim": DIM, "rows_per_client": ROWS,
            "clients": {"dense": 2 * RELAY_DENSE + 1, "rff": RELAY_RFF},
            "errors": errs, "report": report, "steps_s": steps,
            "launches": launches, "peak_mem_gb_this_process": peak,
            "seconds": time.perf_counter() - t_all}


def kernel_sequence(fn) -> list[str]:
    """Names of the device kernels that ``fn`` launches, in the order the
    card ran them (``torch.profiler``'s device events).

    ``fn`` runs twice, first under a trace that is thrown away: the first
    trace of a process has dropped a quarter of a rank-64 update's 255
    launches on the H100 (PERF.md §7), later traces none."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        fn()
        torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    return [e.name for e in sorted(events, key=lambda e: e.time_range.start)]


def profile_top(fn, top: int = 8) -> dict:
    """Run ``fn`` once under ``torch.profiler``: host wall ms (ending in a
    synchronise), summed device-kernel ms, the device idle share of the wall
    time (profiler overhead included), the kernel launches and the ``top``
    kernels by device time. Only the device's own kernel events count (the
    host ops that launch them carry the same time again)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = [(e.key, e.self_device_time_total / 1e3, e.count)
            for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    device_ms = sum(ms for _, ms, _ in rows)
    rows.sort(key=lambda r: -r[1])
    return {"wall_ms": wall_ms, "device_ms": device_ms,
            "device_idle_share": 1 - device_ms / wall_ms,
            "launches": sum(n for _, _, n in rows),
            "top": [[name[:80], ms, n] for name, ms, n in rows[:top]]}


# -- phase 7: gemma3-27b serving at full width through the model entry points --

def model_serving_phase() -> tuple:
    from repro_torch import configs
    from repro_torch.kernels import gram as K
    from repro_torch.kernels import ref
    from repro_torch.models import attention, blocks
    from repro_torch.models import model as M

    cfg = dataclasses.replace(configs.get(MODEL_ARCH), num_stages=MODEL_STAGES)
    n_layers = cfg.num_layers
    specs = [s.attn for s in cfg.stage_pattern * cfg.num_stages + cfg.tail_pattern]
    errs = {}
    t_all = time.perf_counter()
    lm, inputs, steps, param_bytes = seeded_model(cfg, MODEL_SEED, MODEL_BATCH, MODEL_PROMPT)
    prompts = inputs["tokens"]

    # the main path: prefill 4 x 4096, then 31 decode steps (32 tokens),
    # twice: the same tokens, steady-state times
    tokens, launches, peak_gb, served = serve_checked(lm, inputs, MODEL_GEN, runs=2)
    steps.update(served)

    # decode consistency (tests/test_models.py's check): prefill of 4095
    # tokens + one decode step against the 4096-token prefill's last logits.
    # Decode attention is plain torch and prefill is K5, so this holds K5
    # against plain math inside the model.
    cons = decode_consistency(lm, inputs)
    check(cons["max_abs"] <= cons["tol"], f"decode consistency: {cons}")
    steps["consistency_s"] = cons["seconds"]
    errs.update(decode_vs_prefill_max_abs=cons["max_abs"],
                decode_vs_prefill_tol=cons["tol"], logit_scale=cons["logit_scale"])

    # where the time goes: one prefill, then 4 decode steps, each profiled
    profiles = {}
    cache = {}

    def prefill():
        cache["c"] = M.prefill_step(lm, {"tokens": prompts}, max_len=MODEL_PROMPT + 4)[1]

    def decode():
        tok = prompts[:, -1:]
        for _ in range(4):
            M.decode_step(lm, cache["c"], {"tokens": tok})

    profiles["prefill"] = profile_top(prefill)
    profiles["decode_4_steps"] = profile_top(decode)
    del cache

    # K5 against its plain version on the real q, k, v of the first SWA layer
    # and the first full layer (these launches are not the path's)
    t0 = time.perf_counter()
    x = lm.embed(prompts)
    positions = torch.arange(MODEL_PROMPT, device="cuda").expand(MODEL_BATCH, -1)
    seen = set()
    for layer in lm.all_layers():
        kind = layer.spec.attn
        if kind not in seen:
            seen.add(kind)
            q, k, v = attention.project_qkv(layer.attn, layer.norm1(x), cfg, positions)
            window = cfg.window if kind == "swa" else None
            o = K.swa_flash_cuda(q, k, v, window=window)
            p = ref.swa_attention_ref(q, k, v, window=window)
            errs[f"k5_{kind}_layer_max_abs_err"] = float((o.float() - p.float()).abs().max())
            errs[f"k5_{kind}_layer_worst_bf16_ulps"] = bf16_ulps(o, p)
            check(errs[f"k5_{kind}_layer_worst_bf16_ulps"] <= 1,
                  f"K5 on the first {kind} layer's inputs: {errs}")
            del q, k, v, o, p
        if seen == {"swa", "full"}:
            break
        x = blocks.apply_layer(layer, x, cfg)
    torch.cuda.synchronize()
    steps["layer_checks_s"] = time.perf_counter() - t0
    del x
    torch.cuda.empty_cache()
    return lm, {"phase": "model_serving", "arch": cfg.name,
            "reduced": f"depth: num_stages {MODEL_STAGES} of 10 ({n_layers} of 62 layers)",
            "layers": {kind: specs.count(kind) for kind in ("swa", "full")},
            "params": cfg.param_count(), "param_bytes": param_bytes,
            "weight_gb": param_bytes / 1e9,
            "batch": MODEL_BATCH, "prompt_len": MODEL_PROMPT, "gen_tokens": MODEL_GEN,
            "dtype": cfg.dtype, "steps_s": steps, "errors": errs, "launches": launches,
            "profiles": profiles,
            "sample_tokens": tokens[0, :8].tolist(),
            "peak_mem_gb": peak_gb, "seconds": time.perf_counter() - t_all}


def private_probe_phase(lm) -> dict:
    """The one-shot linear probe on frozen gemma3-27b features at full
    width: 4 clients' per-token final-norm hidden states (K5 in every
    layer), their feature statistics fused and the head solved once."""
    from repro_torch.core import fuse_stats, probe
    from repro_torch.kernels import gram as K
    from repro_torch.models import blocks

    def sync():
        torch.cuda.synchronize()

    cfg = lm.cfg
    steps, errs, report = {}, {}, {}
    t_all = time.perf_counter()

    def feature_fn(tokens):
        x = lm.embed(tokens)
        for layer in lm.all_layers():
            x = blocks.apply_layer(layer, x, cfg)
        return lm.final_norm(x).reshape(-1, cfg.d_model)

    rng = np.random.default_rng(PROBE_SEED)
    prompts = [torch.from_numpy(rng.integers(0, cfg.vocab_size, (PROBE_PROMPTS, PROBE_LEN))
                                .astype(np.int32)).cuda() for _ in range(PROBE_CLIENTS)]
    w_true = torch.from_numpy(rng.standard_normal((cfg.d_model, PROBE_TARGETS))
                              .astype(np.float32)).cuda()
    K.reset_launch_counts()
    feats, targets, stats = [], {1: [], PROBE_TARGETS: []}, {1: [], PROBE_TARGETS: []}
    steps["features_s"], steps["feature_stats_s"] = [], []
    for k, toks in enumerate(prompts):
        t0 = time.perf_counter()
        f = feature_fn(toks)
        sync()
        steps["features_s"].append(time.perf_counter() - t0)
        check(tuple(f.shape) == (PROBE_PROMPTS * PROBE_LEN, cfg.d_model)
              and bool(torch.isfinite(f).all()), f"client {k}'s features")
        noise = torch.from_numpy(rng.standard_normal((f.shape[0], PROBE_TARGETS))
                                 .astype(np.float32)).cuda()
        y = f.float() @ w_true + 0.01 * noise
        t0 = time.perf_counter()
        for t, yt in ((1, y[:, 0]), (PROBE_TARGETS, y)):
            targets[t].append(yt)
            stats[t].append(probe._feature_stats(f, yt))
        sync()
        steps["feature_stats_s"].append(time.perf_counter() - t0)
        feats.append(f)
    launches = K.launch_counts()
    n_layers = cfg.num_layers
    check(launches["swa_flash"] == PROBE_CLIENTS * n_layers,
          f"K5 launched {launches['swa_flash']} times for {PROBE_CLIENTS} clients' "
          f"features, want {PROBE_CLIENTS * n_layers}")
    for name in ("gram_moment", "gemm_nt", "panel_transform", "sketch_gram", "rff_gram"):
        check(launches[name] == 0, f"kernel {name} launched in the probe")

    # sigma from the float64 spectrum of the pooled features' Gram, so that
    # kappa(G + sigma I) = PROBE_KAPPA (1e3, within the 1e6 limit)
    t0 = time.perf_counter()
    F = torch.cat(feats).double()
    G64 = F.T @ F
    lam = torch.linalg.eigvalsh(G64)
    lmin, lmax = float(lam[0]), float(lam[-1])
    sigma = max((lmax - PROBE_KAPPA * lmin) / (PROBE_KAPPA - 1), 0.0)
    kappa = (lmax + sigma) / (lmin + sigma)
    sync()
    steps["f64_spectrum_s"] = time.perf_counter() - t0
    check(kappa <= 1e6, f"kappa {kappa} of G + sigma I")
    report.update({"sigma": sigma, "kappa": kappa, "gram_eig_min": lmin,
                   "gram_eig_max": lmax})
    eye = torch.eye(cfg.d_model, dtype=torch.float64, device="cuda")
    heads = {}
    for t in (1, PROBE_TARGETS):
        t0 = time.perf_counter()
        fused = fuse_stats(stats[t])
        w = probe.solve_head(fused, sigma)
        sync()
        steps[f"fuse_solve_t{t}_s"] = time.perf_counter() - t0
        check(int(fused.count) == PROBE_CLIENTS * PROBE_PROMPTS * PROBE_LEN, "fused count")
        Y = torch.cat(targets[t]).double()
        w64 = torch.linalg.solve(G64 + sigma * eye, F.T @ Y)
        errs[f"head_t{t}_vs_f64_central"] = float(torch.linalg.norm(w.double() - w64)
                                                 / torch.linalg.norm(w64))
        check(errs[f"head_t{t}_vs_f64_central"] <= 1e-3, f"probe head: {errs}")
        check(tuple(probe.head_as_params(probe.ProbeResult(w, fused, sigma))["kernel"]
                    .shape) == (cfg.d_model, t), "head_as_params shape")
        report[f"train_mse_t{t}"] = float(torch.mean((F.float() @ w - Y.float()) ** 2))
        heads[t] = (w, w64)
    del F, G64, eye, feats, stats

    # the mesh half: the 4 clients' prompts as one batch of rows on a (4, 2)
    # mesh of the card, split over its 4 clients (2 prompts each), the
    # features computed on each row shard, one reduction, one head
    from repro_torch.launch import mesh as mesh_lib

    mesh = mesh_lib.make_device_mesh(SHARD_DEVICES, device="cuda")
    tokens, Y = torch.cat(prompts), torch.cat(targets[PROBE_TARGETS])
    w1, w64 = heads[PROBE_TARGETS]
    K.reset_launch_counts()
    t0 = time.perf_counter()
    r_mesh = probe.one_shot_probe(feature_fn, tokens, Y, sigma=sigma, mesh=mesh)
    sync()
    steps["mesh_probe_s"] = time.perf_counter() - t0
    mesh_launches = K.launch_counts()
    check(mesh_launches["swa_flash"] == PROBE_CLIENTS * n_layers,
          f"the mesh probe launched K5 {mesh_launches['swa_flash']} times, want "
          f"{PROBE_CLIENTS * n_layers}")
    check(int(r_mesh.stats.count) == PROBE_CLIENTS * PROBE_PROMPTS * PROBE_LEN,
          "mesh probe count")
    errs["mesh_head_vs_f64_central"] = float(torch.linalg.norm(r_mesh.weights.double() - w64)
                                             / torch.linalg.norm(w64))
    errs["mesh_head_vs_one_device_head"] = float(torch.linalg.norm(r_mesh.weights - w1)
                                                 / torch.linalg.norm(w1))
    check(errs["mesh_head_vs_f64_central"] <= 1e-3, f"mesh probe head: {errs}")
    del targets, tokens, Y, heads, r_mesh
    torch.cuda.empty_cache()
    return {"phase": "private_federation", "part": "probe", "arch": cfg.name,
            "reduced": f"depth: num_stages {MODEL_STAGES} of 10 ({n_layers} of 62 layers)",
            "clients": PROBE_CLIENTS, "prompts_per_client": PROBE_PROMPTS,
            "prompt_len": PROBE_LEN, "d_feat": cfg.d_model, "dtype": cfg.dtype,
            "errors": errs, "report": report, "steps_s": steps, "launches": launches,
            "mesh_launches": mesh_launches, "seconds": time.perf_counter() - t_all}


# -- phase 10: the model zoo at full width --------------------------------------

MOE_LABELS = ("moe.route", "moe.dispatch", "moe.experts", "moe.combine")
SPLIT_LABELS = MOE_LABELS + ("mamba.scan", "rwkv.wkv")


def moe_prefill_split(fn) -> dict:
    """Run ``fn`` (one prefill) once under ``torch.profiler`` and split its
    device time: K5 (by kernel name), the four ``record_function`` ranges
    of ``models/moe.py``, the ``mamba.scan`` range of ``models/mamba.py``
    and the ``rwkv.wkv`` range of ``models/rwkv6.py`` (the chunk loop with
    its head norm; each kernel credited to the range enclosing the
    op that launched it), and the rest (projections, norms, RoPE, the
    conv, the head). ``annotation_ms`` are the ranges' own spans on the
    device, where the profiler records them; ``range_launches`` the
    kernels credited to each range."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = prof.events()

    def span(e) -> float:
        return (e.time_range.end - e.time_range.start) / 1e3

    device = [e for e in events if e.device_type == DeviceType.CUDA]
    kernels = [e for e in device if e.name not in SPLIT_LABELS]
    annotation = dict.fromkeys(SPLIT_LABELS, 0.0)
    for e in device:
        if e.name in SPLIT_LABELS:
            annotation[e.name] += span(e)
    total = sum(span(e) for e in kernels)
    k5 = sum(span(e) for e in kernels if "swa_flash" in e.name)
    parts = dict.fromkeys(SPLIT_LABELS, 0.0)
    counts = dict.fromkeys(SPLIT_LABELS, 0)
    for e in events:
        if e.device_type != DeviceType.CPU or not e.kernels:
            continue
        p = e
        while p is not None and p.name not in parts:
            p = p.cpu_parent
        if p is not None:
            mine = [kn for kn in e.kernels if "swa_flash" not in kn.name]
            parts[p.name] += sum(kn.duration for kn in mine) / 1e3
            counts[p.name] += len(mine)
    return {"wall_ms": wall_ms, "device_ms": total, "device_idle_share": 1 - total / wall_ms,
            "launches": len(kernels), "k5_ms": k5,
            "experts_bmm_ms": parts["moe.experts"], "routing_ms": parts["moe.route"],
            "dispatch_combine_ms": parts["moe.dispatch"] + parts["moe.combine"],
            "mamba_scan_ms": parts["mamba.scan"], "wkv_ms": parts["rwkv.wkv"],
            "rest_ms": total - k5 - sum(parts.values()),
            "annotation_ms": annotation, "range_launches": counts}


def seeded_model(cfg, seed: int, batch: int, prompt_len: int) -> tuple:
    """``cfg``'s model on the card with weights from ``seed``, its parameter
    count checked against the config's, and its inputs drawn from
    ``np.random.default_rng(seed)``: (batch, prompt_len) prompts, then a
    VLM's (batch, num_prefix, d_model) patches, as ``launch.serve.serve``
    (and the reference's) draws them; an encoder's (batch, prompt_len,
    d_model) float32 frames instead. Returns the model, the inputs
    (``{"tokens", "patches"?}`` or ``{"embeddings"}``), the init seconds
    and the weights' bytes (an integer: the dryrun phase holds the
    dry-run's bytes to it)."""
    from repro_torch.models import model as M

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    lm = M.init_params(cfg, generator=torch.Generator("cuda").manual_seed(seed),
                       device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in lm.parameters())
    check(n_params == cfg.param_count(),
          f"{cfg.name}: {n_params} parameters, the config counts {cfg.param_count()}")
    param_bytes = sum(p.numel() * p.element_size() for p in lm.parameters())
    rng = np.random.default_rng(seed)
    if cfg.input_mode == "embeddings":
        frames = rng.standard_normal((batch, prompt_len, cfg.d_model), dtype=np.float32)
        return lm, {"embeddings": torch.from_numpy(frames).cuda()}, \
            {"init_params_s": init_s}, param_bytes
    inputs = {"tokens": torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (batch, prompt_len)).astype(np.int32)).cuda()}
    if cfg.input_mode == "prefix_embeddings":
        inputs["patches"] = torch.from_numpy(rng.standard_normal(
            (batch, cfg.num_prefix, cfg.d_model), dtype=np.float32)).cuda()
    return lm, inputs, {"init_params_s": init_s}, param_bytes


def attention_layers(cfg) -> int:
    """The config's attention layers: K5 runs once each in a prefill or an
    encode (all layers but Mamba and RWKV ones)."""
    from repro_torch.models import blocks

    specs = cfg.stage_pattern * cfg.num_stages + cfg.tail_pattern
    return sum(s.attn in blocks.ATTN_KINDS for s in specs)


def serve_checked(lm, inputs, gen: int, runs: int) -> tuple:
    """``runs`` served runs of ``inputs`` (prompts, and a VLM's patches)
    through ``generate`` (a prefill, then ``gen - 1`` greedy decode steps):
    K5 once an attention layer in each run and no other kernel, tokens in
    range, every run's tokens bitwise the first's. Returns the first run's
    tokens, launch counts and peak GiB, and each run's times
    (``prefill_s``, ``prefill_2_s``, ...)."""
    from repro_torch.kernels import gram as K
    from repro_torch.launch.serve import generate

    cfg, n_layers = lm.cfg, attention_layers(lm.cfg)
    prompts, patches = inputs["tokens"], inputs.get("patches")
    batch = prompts.shape[0]
    steps = {}
    K.reset_launch_counts()
    tokens, times = generate(lm, prompts, gen, patches=patches)
    launches = K.launch_counts()
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    check(launches["swa_flash"] == n_layers
          and all(n == 0 for name, n in launches.items() if name != "swa_flash"),
          f"{cfg.name}: launches {launches} in one prefill + {gen - 1} decode steps, "
          f"want K5 {n_layers} times (one an attention layer, none in decode) and "
          "nothing else")
    check(tuple(tokens.shape) == (batch, gen) and int(tokens.min()) >= 0
          and int(tokens.max()) < cfg.vocab_size, f"{cfg.name}: generated tokens out of range")
    for run in range(1, runs + 1):
        if run > 1:
            before = K.launch_counts()["swa_flash"]
            again, times = generate(lm, prompts, gen, patches=patches)
            check(K.launch_counts()["swa_flash"] - before == n_layers,
                  f"{cfg.name}: K5 launches of run {run}")
            check(torch.equal(tokens, again), f"{cfg.name}: two runs generated different tokens")
        tag = "" if run == 1 else f"_{run}"
        steps[f"prefill{tag}_s"], steps[f"decode{tag}_s"] = times["prefill_s"], times["decode_s"]
        steps[f"decode{tag}_tok_per_s"] = batch * (gen - 1) / times["decode_s"]
    return tokens, launches, peak_gib, steps


def decode_consistency(lm, inputs, last: dict | None = None) -> dict:
    """A prefill of S - 1 tokens and one decode step against the S-token
    prefill's last logits (``tests/test_models.py``'s check; the caller
    holds ``max_abs`` to ``tol`` = 3e-2 x max(scale, 1), the reference's
    tolerance), a VLM's patches before the tokens in both prefills, K5
    once an attention layer in each prefill and never in decode (a Mamba
    layer hands its state and conv window over instead, an RWKV layer its
    state and token shifts). For an MoE, also the
    last token's experts in each layer by both paths, and the smallest gap
    between its k-th and (k + 1)-th router probabilities in either. The
    S-token prefill's last logits go to ``last["logits"]`` when ``last``
    is given."""
    from repro_torch.kernels import gram as K
    from repro_torch.models import model as M

    def k5() -> int:
        return K.launch_counts()["swa_flash"]

    cfg, n_layers = lm.cfg, attention_layers(lm.cfg)
    prompts = inputs["tokens"]
    B = prompts.shape[0]
    S = prompts.shape[1] + (inputs["patches"].shape[1] if "patches" in inputs else 0)
    moes = [layer.moe for layer in lm.all_layers() if layer.spec.mlp == "moe"]
    before = k5()
    t0 = time.perf_counter()
    _, cache = M.prefill_step(lm, {**inputs, "tokens": prompts[:, :-1]}, max_len=S)
    check(k5() - before == n_layers, f"{cfg.name}: K5 launches of the {S - 1}-position prefill")
    lg, _ = M.decode_step(lm, cache, {"tokens": prompts[:, -1:]})
    check(k5() - before == n_layers, f"{cfg.name}: K5 launched in a decode step")
    del cache
    decoded = [m.routing for m in moes]
    full, _ = M.prefill_step(lm, inputs)
    torch.cuda.synchronize()
    check(k5() - before == 2 * n_layers, f"{cfg.name}: K5 launches of the {S}-position prefill")
    prefilled = [m.routing for m in moes]
    lg, full = lg[:, 0].float(), full[:, -1].float()
    if last is not None:
        last["logits"] = full
    check(bool(torch.isfinite(lg).all() and torch.isfinite(full).all()),
          f"{cfg.name}: logits not finite")
    scale = float(full.abs().max())
    out = {"dtype": cfg.dtype, "max_abs": float((lg - full).abs().max()),
           "tol": 3e-2 * max(scale, 1.0), "logit_scale": scale,
           "seconds": time.perf_counter() - t0}
    if moes:
        k = cfg.top_k

        def gap(probs) -> float:
            top = torch.sort(probs, dim=-1, descending=True).values
            return float((top[:, k - 1] - top[:, k]).min())

        last = [r["probs"].view(B, S, -1)[:, -1] for r in prefilled]
        out["capacity_factor"] = cfg.capacity_factor
        out["decode_experts"] = [r["expert_idx"].tolist() for r in decoded]
        out["prefill_experts"] = [r["expert_idx"].view(B, S, k)[:, -1].tolist()
                                  for r in prefilled]
        out["experts_agree"] = out["decode_experts"] == out["prefill_experts"]
        out["min_router_gap"] = min(min(gap(r["probs"]) for r in decoded),
                                    min(gap(p) for p in last))
    return out


def depth_cut(cfg, layers: int):
    """``cfg`` at full width cut in depth to its first ``layers`` layers:
    whole stages where ``layers`` is a multiple of the stage pattern, else
    the pattern's first ``layers`` as one stage (jamba: 5 of its 8)."""
    period = len(cfg.stage_pattern)
    if layers % period == 0:
        return dataclasses.replace(cfg, num_stages=layers // period)
    check(layers < period and not cfg.tail_pattern,
          f"{cfg.name}: no depth cut to {layers} layers")
    return dataclasses.replace(cfg, stage_pattern=cfg.stage_pattern[:layers], num_stages=1)


def float32_consistency(lm, inputs, last: dict | None = None) -> dict:
    """``decode_consistency`` of what ``lm.float()`` computes, with at most
    one layer in float32 on the card: every layer's weights move to the
    host in their own dtypes, and each layer goes to the card as float32
    just before it runs (``blocks.prefill_layer`` / ``decode_layer``) and
    leaves it after; embedding, final norm and head are float32 on the card
    throughout. bf16 -> float32 is exact, so the numbers are those of the
    whole model cast at once, which one card cannot hold for jamba (96.2
    GB). The model's layers stay on the host: the caller frees it."""
    from repro_torch.models import blocks

    parked = {}
    for layer in lm.all_layers():
        for p in layer.parameters():
            parked[p] = p.data.cpu()
            p.data = parked[p]
    for name in ("embed", "mask_embed", "final_norm", "head"):
        if hasattr(lm, name):
            getattr(lm, name).float()
    gc.collect()
    torch.cuda.empty_cache()

    def one_layer_on_card(fn):
        def run(layer, *args, **kwargs):
            for p in layer.parameters():
                p.data = parked[p].cuda().float()
            try:
                return fn(layer, *args, **kwargs)
            finally:
                for p in layer.parameters():
                    p.data = parked[p]
        return run

    saved = blocks.prefill_layer, blocks.decode_layer
    blocks.prefill_layer, blocks.decode_layer = map(one_layer_on_card, saved)
    lm.cfg = dataclasses.replace(lm.cfg, dtype="float32")
    try:
        return decode_consistency(lm, inputs, last)
    finally:
        blocks.prefill_layer, blocks.decode_layer = saved


def zoo_run(arch: str, layers: int, batch: int, prompt_len: int, gen: int) -> dict:
    """One config of the zoo at full width, cut to its first ``layers``
    layers: the parameter count, a served run (prefill, then ``gen`` greedy
    tokens; a VLM's prefill puts its patches before the prompt) with K5
    once an attention layer, decode consistency, times and peak memory. An
    MoE also serves twice (bitwise equal tokens), reports each MoE layer's
    dropped share of (token, choice) pairs at its capacity factor 1.25 and
    a profiler split of one prefill (with a hybrid's Mamba scan: its
    launches and device ms a Mamba layer); so does an RWKV model, with its
    WKV's launches and device ms a layer. An MoE's decode consistency runs at
    the dropless capacity E / k, and again in float32, one layer on the
    card at a time, if a bf16 routing tie flipped an expert of the last
    token; an RWKV model's always runs again so, and the float32 run is
    the one held to the tolerance."""
    from repro_torch import configs
    from repro_torch.models import model as M
    from repro_torch.models import moe

    full_cfg = configs.get(arch)
    cfg = depth_cut(full_cfg, layers)
    n_layers = cfg.num_layers
    specs = cfg.stage_pattern * cfg.num_stages + cfg.tail_pattern
    window = cfg.window if any(s.attn == "swa" for s in specs) else None
    if attention_layers(cfg):
        check((batch, cfg.num_prefix + prompt_len, cfg.num_heads, cfg.num_kv_heads,
               cfg.head_dim, window, cfg.causal) in SWA_ZOO_SHAPES.values(),
              f"{arch}: the kernel phase does not hold K5 at this prefill's shape")
    t_all = time.perf_counter()
    lm, inputs, steps, param_bytes = seeded_model(cfg, ZOO_SEED, batch, prompt_len)
    tokens, launches, served_peak_gb, served = serve_checked(
        lm, inputs, gen, runs=2 if cfg.num_experts else 1)
    steps.update(served)
    steps["decode_ms_per_step"] = steps["decode_s"] / (gen - 1) * 1e3
    reduced = ("none: all layers, full width" if n_layers == full_cfg.num_layers
               else f"depth: {n_layers} of {full_cfg.num_layers} layers")
    out = {"arch": cfg.name, "reduced": reduced,
           "params": cfg.param_count(), "active_params": cfg.active_param_count(),
           "param_bytes": param_bytes, "weight_gb": param_bytes / 1e9, "batch": batch,
           "prefix": cfg.num_prefix,
           "prompt_len": prompt_len, "gen_tokens": gen, "window": window,
           "layers": {f"{s.attn}+{s.mlp}": specs.count(s) for s in dict.fromkeys(specs)},
           "launches": launches, "sample_tokens": tokens[0, :8].tolist()}

    rwkv_layers = sum(s.attn == "rwkv" for s in specs)
    if cfg.num_experts or rwkv_layers:
        split = moe_prefill_split(lambda: M.prefill_step(lm, inputs))
        for kind, label, key in (("mamba", "mamba.scan", "mamba_scan"),
                                 ("rwkv", "rwkv.wkv", "wkv")):
            n = sum(s.attn == kind for s in specs)
            if n:
                split[f"{key}_per_layer"] = {
                    "ms": split[f"{key}_ms"] / n,
                    "launches": split["range_launches"][label] / n}
        out["prefill_split"] = split
    if cfg.num_experts:
        T = batch * prompt_len
        out["capacity"] = {"factor": cfg.capacity_factor, "tokens": T,
                           "slots_per_expert": moe.capacity(cfg, T)}
        out["dropped_share_per_layer"] = [
            1 - float(layer.moe.routing["keep"].float().mean())
            for layer in lm.all_layers() if layer.spec.mlp == "moe"]
        lm.cfg = dataclasses.replace(cfg, capacity_factor=cfg.num_experts / cfg.top_k)
    last16, last32 = {}, {}
    cons = decode_consistency(lm, inputs, last16)
    if (cfg.num_experts and not cons["experts_agree"]) or rwkv_layers:
        # a bf16 routing tie flipped, or an RWKV stack, whose bf16 rounding
        # alone moves random-weight logits past the tolerance (the
        # reference's as much as the port's, PERF.md): the same check with
        # the model in float32, the bf16 error kept beside it
        cons["float32"] = float32_consistency(lm, inputs, last32)
        cons["bf16_vs_float32_prefill_max_abs"] = float(
            (last16["logits"] - last32["logits"]).abs().max())
        cons = {**cons, "checked": "float32"}
        final = cons["float32"]
    else:
        final = cons
    check(final["max_abs"] <= final["tol"], f"{arch}: decode consistency {cons}")
    out["consistency"] = cons
    steps["total_s"] = time.perf_counter() - t_all
    out.update(steps_s=steps, served_peak_gib=served_peak_gb,
               peak_gib=torch.cuda.max_memory_allocated() / 2**30)
    del lm, tokens, inputs
    gc.collect()
    torch.cuda.empty_cache()
    return out


def cache_bytes_per_layer(cache: dict) -> list[int]:
    """The bytes of each layer's decode cache."""
    return [sum(t.numel() * t.element_size() for t in c.values()) for c in cache["layers"]]


def long_run(arch: str, batch: int, gen: int) -> dict:
    """An attention-free config whole, served once on ``batch`` prompts of
    the prefill_32k input shape's length (``gen`` greedy tokens, no K5 and
    no other kernel), with no consistency check; then one prefill of those
    prompts and one of their first 4096 tokens, whose decode caches must
    hold the same bytes in every layer, and finite last logits."""
    from repro_torch import configs
    from repro_torch.models import model as M
    from repro_torch.models.config import INPUT_SHAPES

    cfg = configs.get(arch)
    seq = INPUT_SHAPES["prefill_32k"].seq_len
    check(attention_layers(cfg) == 0, f"{arch}: has attention layers")
    t_all = time.perf_counter()
    lm, inputs, steps, param_bytes = seeded_model(cfg, ZOO_SEED, batch, seq)
    tokens, launches, served_peak_gib, served = serve_checked(lm, inputs, gen, runs=1)
    steps.update(served)
    steps["decode_ms_per_step"] = steps["decode_s"] / (gen - 1) * 1e3
    short = 4096                      # the zoo run's prompt length
    per_layer = {}
    for n in (short, seq):
        logits, cache = M.prefill_step(lm, {"tokens": inputs["tokens"][:, :n]})
        check(bool(torch.isfinite(logits).all()), f"{arch}: logits at {n} not finite")
        per_layer[n] = cache_bytes_per_layer(cache)
        del logits, cache
    check(per_layer[short] == per_layer[seq] and len(set(per_layer[seq])) == 1,
          f"{arch}: decode cache bytes a layer {per_layer} differ between {short} "
          f"and {seq} positions")
    steps["total_s"] = time.perf_counter() - t_all
    out = {"arch": cfg.name, "reduced": "none: all layers, full width",
           "params": cfg.param_count(), "param_bytes": param_bytes,
           "weight_gb": param_bytes / 1e9, "batch": batch,
           "prompt_len": seq, "gen_tokens": gen, "launches": launches,
           "sample_tokens": tokens[0, :8].tolist(),
           "cache_bytes_per_layer": {str(n): b[0] for n, b in per_layer.items()},
           "cache_bytes": {str(n): sum(b) for n, b in per_layer.items()},
           "steps_s": steps, "served_peak_gib": served_peak_gib,
           "peak_gib": torch.cuda.max_memory_allocated() / 2**30}
    del lm, tokens, inputs
    gc.collect()
    torch.cuda.empty_cache()
    return out


def encode_run(arch: str, batch: int, frames: int) -> dict:
    """An encoder-only config whole, at full width: the parameter count,
    one ``encode_step`` of (batch, frames) seeded frame embeddings with K5
    once a layer and no other kernel, finite logits of (batch, frames,
    vocab), a second encode bitwise equal, a changed last frame moving
    frame 0's logits (the attention is bidirectional: under a causal mask
    it would not), and the bf16 logits against a float32 copy of the
    model (``lm.float()``, K5's float32 route) within 3e-2 x max(scale, 1),
    the reference's decode-consistency tolerance."""
    from repro_torch import configs
    from repro_torch.kernels import gram as K
    from repro_torch.models import model as M

    cfg = configs.get(arch)
    n_layers = cfg.num_layers
    check((batch, frames, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim, None, cfg.causal)
          in SWA_ZOO_SHAPES.values(),
          f"{arch}: the kernel phase does not hold K5 at this encode's shape")
    t_all = time.perf_counter()
    lm, inputs, steps, param_bytes = seeded_model(cfg, ZOO_SEED, batch, frames)

    def encode(batch_in, key):
        t0 = time.perf_counter()
        out = M.encode_step(lm, batch_in)
        torch.cuda.synchronize()
        steps[key] = time.perf_counter() - t0
        return out

    K.reset_launch_counts()
    logits = encode(inputs, "encode_s")
    launches = K.launch_counts()
    check(launches["swa_flash"] == n_layers
          and all(n == 0 for name, n in launches.items() if name != "swa_flash"),
          f"{cfg.name}: launches {launches} in one encode, want K5 {n_layers} times "
          "(one a layer) and nothing else")
    check(tuple(logits.shape) == (batch, frames, cfg.vocab_size)
          and bool(torch.isfinite(logits).all()),
          f"{cfg.name}: logits {tuple(logits.shape)} not finite of (B, S, vocab)")
    served_peak_gib = torch.cuda.max_memory_allocated() / 2**30
    check(torch.equal(logits, encode(inputs, "encode_2_s")),
          f"{cfg.name}: two encodes gave different logits")
    changed = inputs["embeddings"].clone()
    changed[:, -1] = torch.from_numpy(np.random.default_rng(ZOO_SEED + 1).standard_normal(
        (batch, cfg.d_model), dtype=np.float32)).cuda()
    moved = encode({"embeddings": changed}, "encode_changed_s")
    frame0_moved = float((moved[:, 0].float() - logits[:, 0].float()).abs().max())
    check(frame0_moved > 0, f"{cfg.name}: a changed last frame left frame 0's logits "
          "as they were: the attention is not bidirectional")
    del moved, changed
    # the same encode by a float32 copy of the model: K5's float32 route
    lm.float()
    lm.cfg = dataclasses.replace(cfg, dtype="float32")
    gc.collect()
    torch.cuda.empty_cache()
    ref32 = encode(inputs, "encode_f32_s")
    scale = float(ref32.abs().max())
    err = float((logits.float() - ref32).abs().max())
    tol = 3e-2 * max(scale, 1.0)
    check(err <= tol, f"{cfg.name}: bf16 logits {err} from the float32 model's, tol {tol}")
    check(K.launch_counts()["swa_flash"] == 4 * n_layers,
          f"{cfg.name}: K5 launches of four encodes")
    steps["total_s"] = time.perf_counter() - t_all
    out = {"arch": cfg.name, "reduced": "none: all layers, full width",
           "params": cfg.param_count(), "param_bytes": param_bytes,
           "weight_gb": param_bytes / 1e9, "batch": batch,
           "frames": frames, "head_dim": cfg.head_dim, "causal": cfg.causal,
           "launches": launches, "frame0_moved_max_abs": frame0_moved,
           "vs_float32": {"max_abs": err, "tol": tol, "logit_scale": scale},
           "steps_s": steps, "served_peak_gib": served_peak_gib,
           "peak_gib": torch.cuda.max_memory_allocated() / 2**30}
    del lm, logits, ref32, inputs
    gc.collect()
    torch.cuda.empty_cache()
    return out


def zoo_serving_phase() -> dict:
    """The decoder configs of the zoo (``ZOO_RUNS``), the attention-free
    one at 32768 positions (``LONG_ARCH``), then the encoder
    (``ENCODE_ARCH``), one model on the card at a time."""
    from repro_torch.kernels import gram as K

    t0 = time.perf_counter()
    runs = [zoo_run(*run) for run in ZOO_RUNS]
    runs.append(long_run(LONG_ARCH, LONG_BATCH, LONG_GEN))
    runs.append(encode_run(ENCODE_ARCH, ENCODE_BATCH, ENCODE_FRAMES))
    return {"phase": "zoo_serving", "dtype": "bfloat16",
            "consistency_note": "the MoE configs' decode consistency runs at the dropless "
                                "capacity E / k (a prefill of S - 1 and one of S drop "
                                "different pairs at 1.25); the served runs keep 1.25; "
                                "rwkv6-1.6b's is held in float32, its bf16 rounding alone "
                                "moving the logits past the tolerance (bf16 error beside)",
            "runs": runs,
            "launches": {name: sum(r["launches"][name] for r in runs)
                         for name in K.launch_counts()},
            "seconds": time.perf_counter() - t0}


# -- the train phase: yi-9b trained at full width through K5 ----------------

def attention_grad_case(g, B: int, S: int, H: int, Hkv: int, hd: int, window,
                        causal: bool) -> dict:
    """The gradient of ``ops.swa_attention`` (K5 forward, then
    ``ref.swa_attention_bwd``) against ``torch.autograd`` through K5's plain
    version on the same inputs and output gradient: the worst relative
    Frobenius error of dq, dk, dv in float32 (checked) and in bf16
    (reported), and the backward's device time in bf16."""
    from repro_torch.kernels import ops, ref

    def fro(x, y) -> float:
        x, y = x.double(), y.double()
        return float(torch.linalg.vector_norm(x - y) / torch.linalg.vector_norm(y))

    out = {"shape": [B, S, H, Hkv, hd], "window": window, "causal": causal}
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v, do = [torch.randn(shape, generator=g, device="cuda").to(dtype)
                       for shape in ((B, S, H, hd), (B, S, Hkv, hd), (B, S, Hkv, hd),
                                     (B, S, H, hd))]
        kernel = [t.clone().requires_grad_(True) for t in (q, k, v)]
        ops.swa_attention(*kernel, window=window, causal=causal).backward(do)
        plain = [t.clone().requires_grad_(True) for t in (q, k, v)]
        ref.swa_attention_ref(*plain, window=window, causal=causal).backward(do)
        err = max(fro(a.grad, b.grad) for a, b in zip(kernel, plain))
        tag = "f32" if dtype == torch.float32 else "bf16"
        out[f"{tag}_grad_rel_fro"] = err
        if dtype == torch.float32:
            check(err <= TRAIN_GRAD_TOL,
                  f"attention gradient at {out}: {err} > {TRAIN_GRAD_TOL} (float32)")
        else:
            out["bwd_ms_bf16"] = cuda_ms(lambda: ref.swa_attention_bwd(
                q, k, v, do, window=window, causal=causal), reps=3)
        del q, k, v, do, kernel, plain
        torch.cuda.empty_cache()
    return out


def train_step_split(fn) -> dict:
    """Run ``fn`` (one training step) once under ``torch.profiler``: host
    wall ms, summed device-kernel ms, the device idle share of the wall
    (profiler overhead included), the kernel launches, K5's device ms (by
    kernel name) and the device ms of the kernels launched inside the
    ``attn.bwd`` range (the attention backward, ``kernels/ops.py``) and the
    ``adamw.apply`` range (``optim/adamw.py``), each with its share of the
    kernel time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    labels = ("attn.bwd", "adamw.apply")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = prof.events()
    kernels = [e for e in events if e.device_type == DeviceType.CUDA and e.name not in labels]
    total = sum(e.time_range.end - e.time_range.start for e in kernels) / 1e3
    k5 = sum(e.time_range.end - e.time_range.start for e in kernels
             if "swa_flash" in e.name) / 1e3
    parts, counts = dict.fromkeys(labels, 0.0), dict.fromkeys(labels, 0)
    for e in events:
        if e.device_type != DeviceType.CPU or not e.kernels:
            continue
        p = e
        while p is not None and p.name not in parts:
            p = p.cpu_parent
        if p is not None:
            parts[p.name] += sum(kn.duration for kn in e.kernels) / 1e3
            counts[p.name] += len(e.kernels)
    return {"wall_ms": wall_ms, "device_ms": total, "device_idle_share": 1 - total / wall_ms,
            "launches": len(kernels), "k5_ms": k5, "k5_share": k5 / total,
            "attn_bwd_ms": parts["attn.bwd"], "attn_bwd_share": parts["attn.bwd"] / total,
            "attn_bwd_launches": counts["attn.bwd"],
            "adamw_ms": parts["adamw.apply"], "adamw_share": parts["adamw.apply"] / total,
            "adamw_launches": counts["adamw.apply"],
            "rest_ms": total - k5 - parts["attn.bwd"] - parts["adamw.apply"]}


def train_model_flops(cfg, batch: int, seq: int) -> float:
    """The model FLOPs of one training step (no recompute counted): 6 x the
    matmul parameters (every projection and the head; the embedding is a
    gather) x the tokens, plus the causal attention's 12 x hd a kept
    (query, key) pair in each head of each attention layer."""
    from repro_torch.models import blocks

    specs = cfg.stage_pattern * cfg.num_stages + cfg.tail_pattern
    per_layer = (2 * cfg.d_model * cfg.q_dim + 2 * cfg.d_model * cfg.kv_dim
                 + 3 * cfg.d_model * cfg.d_ff)
    matmul = per_layer * len(specs) + cfg.d_model * cfg.vocab_size
    attn = sum(s.attn in blocks.ATTN_KINDS for s in specs)
    pairs = swa_pairs(seq, None, True) * batch * cfg.num_heads
    return 6.0 * matmul * batch * seq + 12.0 * cfg.head_dim * pairs * attn


def train_cli() -> dict:
    """``python -m repro_torch.launch.train`` on the reduced config as a
    process on the card: its report (``--out``), its wall seconds, and the
    fall of its loss (checked)."""
    out_dir = os.path.join(ROOT, "build", "train_cli")
    os.makedirs(out_dir, exist_ok=True)
    report_path = os.path.join(out_dir, "report.json")
    t0 = time.perf_counter()
    try:
        run = subprocess.run([sys.executable, "-m", "repro_torch.launch.train", *TRAIN_CLI,
                              "--out", report_path],
                             capture_output=True, text=True, timeout=PROC_TIMEOUT, cwd=ROOT,
                             env=dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src")))
        check(run.returncode == 0, f"train CLI exited {run.returncode}: {run.stderr[-2000:]}")
        with open(report_path) as f:
            report = json.load(f)
    finally:
        import shutil
        shutil.rmtree(out_dir, ignore_errors=True)
    check(report["final_loss"] < report["first_loss"],
          f"train CLI: the loss did not fall: {report['history']}")
    return {"args": list(TRAIN_CLI), "first_loss": report["first_loss"],
            "final_loss": report["final_loss"], "params_m": report["params_m"],
            "train_wall_s": report["wall_s"], "process_s": time.perf_counter() - t0,
            "last_line": run.stdout.strip().splitlines()[-1]}


def train_phase(peaks) -> dict:
    """yi-9b (``TRAIN_LAYERS`` of 48 layers, full width, bf16) trained for
    ``TRAIN_STEPS`` steps on B ``TRAIN_BATCH`` x S ``TRAIN_SEQ`` tokens
    through ``make_train_step(remat=True)``: every loss finite and the last
    below the first, K5 launched 2 x 8 times a step and no other kernel;
    step times, tokens/s, the step's split into forward + backward and
    AdamW (CUDA events), peak memory, mfu, and one profiled step's device
    idle share and attention-backward share. Before it, the attention
    gradient at three shapes; after it, the train CLI."""
    from repro_torch import configs
    from repro_torch.data import BatchSpec, TokenPipeline
    from repro_torch.kernels import gram as K
    from repro_torch.launch import dryrun
    from repro_torch.models import model as M
    from repro_torch.models.config import InputShape
    from repro_torch.optim import adamw

    t_all = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    g = torch.Generator("cuda").manual_seed(TRAIN_SEED)
    full = configs.get(TRAIN_ARCH)
    cfg = depth_cut(full, TRAIN_LAYERS)
    check((TRAIN_BATCH, TRAIN_SEQ, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim, None,
           cfg.causal) in SWA_ZOO_SHAPES.values(),
          "train: the kernel phase does not hold K5 at the training shape")
    gemma = configs.get(MODEL_ARCH)
    grad_cases = [
        attention_grad_case(g, TRAIN_BATCH, TRAIN_SEQ, cfg.num_heads, cfg.num_kv_heads,
                            cfg.head_dim, None, True),
        attention_grad_case(g, MODEL_BATCH, MODEL_PROMPT, gemma.num_heads,
                            gemma.num_kv_heads, gemma.head_dim, gemma.window, True),
        attention_grad_case(g, *SWA_ZOO_SHAPES["hubert"])]
    grad_s = time.perf_counter() - t_all

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    lm = M.init_params(cfg, generator=torch.Generator("cuda").manual_seed(TRAIN_SEED),
                       device="cuda")
    n_params = sum(p.numel() for p in lm.parameters())
    check(n_params == cfg.param_count(),
          f"{cfg.name}: {n_params} parameters, the config counts {cfg.param_count()}")
    opt_state = adamw.init(lm)
    opt_cfg = adamw.AdamWConfig(lr=TRAIN_LR_REDUCED * 256 / cfg.d_model,
                                warmup_steps=max(TRAIN_STEPS // 20, 5),
                                total_steps=TRAIN_STEPS)
    step_fn = M.make_train_step(cfg, opt_cfg, remat=True)
    pipe = TokenPipeline(BatchSpec(TRAIN_BATCH, TRAIN_SEQ, cfg.vocab_size), seed=TRAIN_SEED,
                         device="cuda")
    batches = [pipe.batch(i) for i in range(TRAIN_STEPS)]
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    param_bytes = sum(p.numel() * p.element_size() for p in lm.parameters())
    optimizer_bytes = sum(t.numel() * t.element_size() for key in ("master", "m", "v")
                          for t in opt_state[key].values()) \
        + opt_state["count"].numel() * opt_state["count"].element_size()
    # the predicted floor of the peak: the step's arguments on one card
    # (parameters, AdamW's state, the batch), as the dry-run counts them
    floor = dryrun.memory(cfg, InputShape("train_phase", TRAIN_SEQ, TRAIN_BATCH, "train"),
                          dryrun.make_named_mesh("card"))

    # CUDA events around each step and around AdamW inside it
    marks = []
    apply = adamw.apply

    def timed_apply(*args, **kwargs):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = apply(*args, **kwargs)
        end.record()
        marks.append((start, end))
        return out

    attn = attention_layers(cfg)
    losses, step_s, fb_ms, adam_ms, k5_per_step = [], [], [], [], []
    split = None
    K.reset_launch_counts()
    adamw.apply = timed_apply
    try:
        for i, batch in enumerate(batches):
            before = K.launch_counts()["swa_flash"]
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            begin = torch.cuda.Event(enable_timing=True)
            begin.record()
            if i == TRAIN_STEPS - 1:        # the last step, profiled
                holder = {}
                split = train_step_split(lambda: holder.update(
                    loss=step_fn(lm, opt_state, batch)))
                loss = holder["loss"]
            else:
                loss = step_fn(lm, opt_state, batch)
            torch.cuda.synchronize()
            step_s.append(time.perf_counter() - t1)
            start, end = marks[-1]
            fb_ms.append(begin.elapsed_time(start))
            adam_ms.append(start.elapsed_time(end))
            losses.append(float(loss))
            k5_per_step.append(K.launch_counts()["swa_flash"] - before)
    finally:
        adamw.apply = apply
    launches = K.launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    check(all(math.isfinite(x) for x in losses), f"training losses not finite: {losses}")
    check(losses[-1] < losses[0], f"training loss did not fall: {losses}")
    check(all(n == 2 * attn for n in k5_per_step),
          f"K5 launches a step {k5_per_step}, want 2 x {attn} (remat runs each forward twice)")
    check(all(n == 0 for name, n in launches.items() if name != "swa_flash"),
          f"training launched other kernels: {launches}")
    # steady state: the steps after the first (warm-up) and before the profiled one
    steady = step_s[1:-1]
    step_med = float(np.median(steady))
    tokens = TRAIN_BATCH * TRAIN_SEQ
    flops = train_model_flops(cfg, TRAIN_BATCH, TRAIN_SEQ)
    out = {"phase": "train", "arch": cfg.name,
           "reduced": f"depth: {cfg.num_layers} of {full.num_layers} layers",
           "params": n_params, "dtype": cfg.dtype, "batch": TRAIN_BATCH, "seq": TRAIN_SEQ,
           "steps": TRAIN_STEPS, "remat": True, "adamw": dataclasses.asdict(opt_cfg),
           "attention_grad": grad_cases, "attention_grad_tol": TRAIN_GRAD_TOL,
           "losses": losses, "step_s": step_s, "step_s_median": step_med,
           "steps_per_s": 1 / step_med, "tokens_per_s": tokens / step_med,
           "fwd_bwd_ms": fb_ms, "adamw_ms": adam_ms,
           "fwd_bwd_ms_median": float(np.median(fb_ms[1:-1])),
           "adamw_ms_median": float(np.median(adam_ms[1:-1])),
           "k5_launches_per_step": k5_per_step, "launches": launches,
           "peak_gb": peak_gb, "param_bytes": param_bytes,
           "optimizer_bytes": optimizer_bytes, "optimizer_state_gb": optimizer_bytes / 1e9,
           "dryrun_arguments": floor["arguments"],
           "peak_floor_bytes": floor["argument_bytes"],
           "peak_over_floor_gb": peak_gb - floor["argument_bytes"] / 1e9,
           "model_tflop_per_step": flops / 1e12,
           "mfu": flops / step_med / peaks[2], "mfu_peak": "dense bf16, launch.mesh.CARD_PEAKS",
           "profiled_step": split, "nvidia_smi": smi(),
           "setup_s": setup_s, "attention_grad_s": grad_s}
    del lm, opt_state, batches, step_fn
    gc.collect()
    torch.cuda.empty_cache()
    out["cli"] = train_cli()
    out["seconds"] = time.perf_counter() - t_all
    return out


# -- the dryrun phase: the dry-run on the card's mesh, and the probe example --

def dryrun_phase(peaks, serving: dict, zoo: dict, train: dict) -> dict:
    """(a) the dry-run's memory sweep of the whole matrix on the one-card
    mesh as a process (33 OK, 7 SKIP), the cost mode of ``DRYRUN_COSTED``
    and the roofline's table; (b) the dry-run's parameter bytes of every
    model the script built at full width (gemma3-27b's cut, the zoo's runs,
    yi-9b's training cut), and for training AdamW's and the arguments'
    bytes, equal to the byte to what the phases measured; (c) the roofline
    of the train phase's own step (yi-9b at 8 layers, B 2 x 4096) beside its
    measured time, not a gate; (d) the probe example in process, its
    one-shot head within 1e-3 of the centralized one and its K1 and K5
    launches pinned, K1 and K5 then held to their plain versions at its
    shapes."""
    import shutil

    from repro_torch import configs
    from repro_torch.kernels import gram as K
    from repro_torch.kernels import ref
    from repro_torch.launch import dryrun, roofline
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.models.config import InputShape

    t_all = time.perf_counter()
    out_dir = os.path.join(ROOT, "build", "dryrun_torch")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    steps = {}

    def module(step: str, *args) -> str:
        """``python -m args`` as a process; its stdout; its seconds as ``step``."""
        t0 = time.perf_counter()
        run = subprocess.run([sys.executable, "-m", *args], capture_output=True, text=True,
                             timeout=PROC_TIMEOUT, cwd=ROOT, env=env)
        check(run.returncode == 0, f"{' '.join(args)} exited {run.returncode}: "
              f"{run.stdout[-1000:]} {run.stderr[-2000:]}")
        steps[step] = time.perf_counter() - t0
        return run.stdout

    # (a) the matrix in memory mode, DRYRUN_COSTED in cost mode, the roofline
    shutil.rmtree(out_dir, ignore_errors=True)
    try:
        lines = module("memory_sweep_s", "repro_torch.launch.dryrun", "--all", "--card",
                       "--memory-only", "--out", out_dir).splitlines()
        status = [line[1:5].strip() for line in lines if line.startswith("[")]
        counts = {k: status.count(k) for k in ("OK", "SKIP", "FAIL")}
        check(counts == {"OK": 33, "SKIP": 7, "FAIL": 0} and len(status) == 40,
              f"dry-run sweep: {counts}")
        for arch, shape_name in DRYRUN_COSTED:
            module(f"cost_{arch}_{shape_name}_s", "repro_torch.launch.dryrun", "--arch", arch,
                   "--shape", shape_name, "--card", "--out", out_dir)
        table = module("roofline_s", "repro_torch.launch.roofline", "--dir", out_dir)
        matrix = {}
        for name in sorted(os.listdir(out_dir)):
            if not name.endswith("_card.json"):
                continue
            with open(os.path.join(out_dir, name)) as f:
                rec = json.load(f)
            if "skipped" in rec:
                continue
            mem = rec["memory"]
            row = {"argument_bytes": mem["argument_bytes"], "arguments": mem["arguments"],
                   "output_bytes": mem["output_bytes"], "fits": mem["fits"],
                   "fit_layers": mem["fit_layers"]}
            r = roofline.analyze(rec)
            if r is not None:
                row.update(counted_tflop=r.flops / 1e12, model_tflop=r.model_flops / 1e12,
                           compute_ms=r.compute_s * 1e3, memory_ms=r.est_memory_s * 1e3,
                           dominant=r.dominant)
            matrix[f"{rec['arch']} {rec['shape']}"] = row
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)

    # (b) the dry-run's bytes against the models the phases built
    card = dryrun.make_named_mesh("card")

    def params_bytes(cfg) -> int:
        shape = InputShape("serve", cfg.num_prefix + 64, 1, "prefill")
        return dryrun.memory(cfg, shape, card)["arguments"]["params"]

    gemma = dataclasses.replace(configs.get(MODEL_ARCH), num_stages=MODEL_STAGES)
    built = [(gemma, serving["param_bytes"])]
    built += [(depth_cut(configs.get(run[0]), run[1]), r["param_bytes"])
              for run, r in zip(ZOO_RUNS, zoo["runs"])]
    built += [(configs.get(r["arch"]), r["param_bytes"]) for r in zoo["runs"][len(ZOO_RUNS):]]
    exact = []
    for cfg, measured in built:
        want = params_bytes(cfg)
        exact.append({"arch": cfg.name, "layers": cfg.num_layers, "dryrun_param_bytes": want,
                      "model_param_bytes": measured})
        check(want == measured, f"{cfg.name} at {cfg.num_layers} layers: the dry-run's "
              f"parameter bytes {want}, the model's {measured}")
    train_cfg = depth_cut(configs.get(TRAIN_ARCH), TRAIN_LAYERS)
    train_shape = InputShape("train_phase", TRAIN_SEQ, TRAIN_BATCH, "train")
    mem = dryrun.memory(train_cfg, train_shape, card)
    exact.append({"arch": train_cfg.name, "layers": train_cfg.num_layers, "train": True,
                  "dryrun_arguments": mem["arguments"],
                  "model_param_bytes": train["param_bytes"],
                  "adamw_state_bytes": train["optimizer_bytes"]})
    check(mem["arguments"]["params"] == train["param_bytes"]
          and mem["arguments"]["opt"] == train["optimizer_bytes"]
          and mem["argument_bytes"] == train["peak_floor_bytes"],
          f"training: the dry-run's arguments {mem['arguments']}, the phase's parameters "
          f"{train['param_bytes']} and AdamW state {train['optimizer_bytes']} bytes")

    # (c) the roofline of the train phase's step beside its measured time
    t0 = time.perf_counter()
    c2, c4 = (dryrun.cost(train_cfg, train_shape, card, n)["flops"]
              for n in dryrun.COST_STAGES)
    flops = roofline.at_depth(c2, c4, train_cfg.num_stages)
    est = roofline.hbm_bytes(train_cfg, train_shape, model_shards=1, data_shards=1)
    compute_s, memory_s = flops / peaks[2], est / peaks[0]
    step_roofline = {
        "arch": train_cfg.name, "layers": train_cfg.num_layers,
        "batch": TRAIN_BATCH, "seq": TRAIN_SEQ, "remat": False,
        "counted_tflop": flops / 1e12,
        "counted_tflop_at_8_stages": dryrun.count_flops(train_cfg, train_shape) / 1e12,
        "model_tflop_6nd": roofline.model_flops(train_cfg, train_shape, 1) / 1e12,
        "train_phase_model_tflop_per_step": train["model_tflop_per_step"],
        "compute_s": compute_s, "memory_s": memory_s, "est_hbm_bytes": est,
        "bound_s": max(compute_s, memory_s),
        "measured_step_s_median": train["step_s_median"],
        "measured_over_bound": train["step_s_median"] / max(compute_s, memory_s),
        "peaks": "launch.mesh.CARD_PEAKS (dense bf16, HBM)"}
    steps["step_roofline_s"] = time.perf_counter() - t0

    # (d) the probe example at its defaults, in process
    t0 = time.perf_counter()
    example = load_example("train_probe_e2e_torch.py")
    K.reset_launch_counts()
    res, printed = printed_by(example.main, ["--device", "cuda"])
    launches = K.launch_counts()
    steps["example_s"] = time.perf_counter() - t0
    attn = attention_layers(configs.get_reduced("yi-9b"))
    want = {name: 0 for name in launches}
    want.update(swa_flash=2 * attn * EXAMPLE_STEPS + attn * EXAMPLE_CLIENTS, gram_moment=1)
    check(launches == want, f"the example launched {launches}, want {want}")
    check(res["rel"] < 1e-3, f"the example's head: rel err {res['rel']}")
    F, Y = res["features"], res["targets"]
    G, h = K.gram_moment_cuda(F, Y)
    Gr, hr = ref.gram_moment_ref(F, Y)
    k1_err = max(rel_err(G, Gr), rel_err(h, hr))
    check(k1_err <= 1e-5, f"K1 at the example's features: rel err {k1_err}")
    g = torch.Generator("cuda").manual_seed(TRAIN_SEED)
    rcfg = configs.get_reduced("yi-9b")
    k5_err = {}
    for B in (8, EXAMPLE_ROWS):          # the training batch, a client's rows
        q, k, v = [torch.randn(shape, generator=g, device="cuda") for shape in (
            (B, 64, rcfg.num_heads, rcfg.head_dim),
            (B, 64, rcfg.num_kv_heads, rcfg.head_dim),
            (B, 64, rcfg.num_kv_heads, rcfg.head_dim))]
        k5_err[f"B {B}"] = float((K.swa_flash_cuda(q, k, v, window=None, causal=True)
                                  - ref.swa_attention_ref(q, k, v, window=None,
                                                          causal=True)).abs().max())
        check(k5_err[f"B {B}"] <= 3e-5, f"K5 float32 at the example's shape: {k5_err}")
    example_line = {"rel": res["rel"], "mse": res["mse"], "launches": launches,
                    "first_loss": res["train"]["first_loss"],
                    "final_loss": res["train"]["final_loss"],
                    "train_wall_s": res["train"]["wall_s"], "k1_rel_err": k1_err,
                    "k5_f32_max_abs_err": k5_err,
                    "last_lines": printed[-3:]}
    del res, F, Y, G, h, Gr, hr
    gc.collect()
    torch.cuda.empty_cache()
    return {"phase": "dryrun", "mesh": "card (1, 1)", "hbm_bytes": mesh_lib.HBM_BYTES,
            "sweep": counts, "costed": [list(c) for c in DRYRUN_COSTED],
            "matrix": matrix, "roofline_table": table.strip().splitlines(),
            "exact_bytes": exact, "step_roofline": step_roofline, "example": example_line,
            "steps_s": steps, "nvidia_smi": smi(), "seconds": time.perf_counter() - t_all}


# -- the examples: quickstart, private federation, batched serving ------------

def load_example(name: str):
    """``examples/<name>`` imported as a module (its ``main`` not run)."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(name[:-len(".py")],
                                                  os.path.join(ROOT, "examples", name))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def printed_by(fn, *args) -> tuple:
    """``fn(*args)``'s result, after the card has finished, and the lines it
    printed."""
    import contextlib
    import io

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        res = fn(*args)
    torch.cuda.synchronize()
    return res, out.getvalue().rstrip("\n").split("\n")


def launched(want: dict) -> dict:
    """This run's launches, which must be ``want``'s and none of any other
    kernel."""
    from repro_torch.kernels import gram as K

    counts = K.launch_counts()
    full = {name: want.get(name, 0) for name in counts}
    check(counts == full, f"launched {counts}, want {full}")
    return counts


def examples_phase() -> dict:
    """The port's examples in process, each through its ``main`` or ``run``
    with the kernels' launch counts set to 0 before it: (a) quickstart at
    its defaults (K1 once a client, once for the centralized rows and once a
    surviving client), then its ``run`` at the main path's full width
    (EXAMPLES_QUICK_*), one-shot against centralized at the main path's
    1e-4 and the dropout run against a float64 solve of the surviving
    clients' rows; (b) private_federation at its defaults (K1 in every
    Phase 1), then the same example's ``run`` on a CPU copy of the same data
    as the reference: the same failed cells, each finite MSE within one
    unit of its printed fourth decimal, the parity tests' tolerance; (c)
    serve_batched at its defaults (reduced mixtral, K5 once an attention
    layer in the prefill), K5 then held to its plain version at that
    prefill's shape, in float32 (the served dtype) at 3e-5 and in bf16
    within one ulp; (d) ``launch.mesh.psum_scatter`` on a two-shard mesh of
    ``cuda:0`` and ``cpu``: each slice on its shard's device, bitwise the
    sum's slice."""
    from repro_torch import configs, data
    from repro_torch.kernels import gram as K
    from repro_torch.kernels import ref
    from repro_torch.launch import mesh as mesh_lib

    t_all = time.perf_counter()
    steps, launches = {}, {}
    quick = load_example("quickstart_torch.py")
    private = load_example("private_federation_torch.py")
    serve_ex = load_example("serve_batched_torch.py")
    clients, rows, dim = EXAMPLES_CLIENTS, EXAMPLES_ROWS, EXAMPLES_DIM

    # (a) quickstart: its defaults, then the main path's width
    t0 = time.perf_counter()
    K.reset_launch_counts()
    res, lines = printed_by(quick.main, ["--device", "cuda"])
    launches["quickstart"] = launched({"gram_moment": clients + 1 + clients // 2})
    check(res["rel_err"] <= 1e-4 and len(lines) == 5, f"quickstart: {lines}")
    quick_line = {"lines": lines, "rel_err": res["rel_err"]}
    steps["quickstart_s"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    ds = data.synthetic.generate(0, num_clients=CLIENTS, samples_per_client=ROWS, dim=DIM)
    torch.cuda.synchronize()
    steps["quickstart_full_generate_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    K.reset_launch_counts()
    res, lines = printed_by(quick.run, ds)
    launches["quickstart_full"] = launched({"gram_moment": CLIENTS + 1 + CLIENTS // 2})
    steps["quickstart_full_s"] = time.perf_counter() - t0
    alive = [A for (A, _), a in zip(ds.clients, res["alive"]) if a]
    A64 = torch.cat(alive).double()
    b64 = torch.cat([b for (_, b), a in zip(ds.clients, res["alive"]) if a]).double()
    w64 = torch.linalg.solve(A64.T @ A64 + SIGMA * torch.eye(DIM, dtype=torch.float64,
                                                             device="cuda"), A64.T @ b64)
    del A64, b64, alive
    full = {"d": DIM, "clients": CLIENTS, "rows": ROWS, "lines": lines,
            "one_shot_vs_centralized": rel_err(res["w_fed"], res["w_central"]),
            "dropout_vs_f64": rel_err(res["w_dropout"], w64),
            **{k: res[k] for k in ("rel_err", "mse_one_shot", "mse_centralized",
                                   "mse_fedavg", "mse_dropout", "fedavg_mb", "one_shot_mb",
                                   "traffic_ratio", "survivors")}}
    check(full["one_shot_vs_centralized"] <= 1e-4 and full["dropout_vs_f64"] <= 1e-4,
          f"quickstart at d {DIM}: {full}")
    check(all(math.isfinite(full[k]) for k in ("mse_one_shot", "mse_centralized",
                                               "mse_fedavg", "mse_dropout")),
          f"quickstart at d {DIM}: {full}")
    del res, ds, w64
    gc.collect()
    torch.cuda.empty_cache()

    # (b) private_federation at its defaults, on the card and on a CPU copy
    t0 = time.perf_counter()
    K.reset_launch_counts()
    res, lines = printed_by(private.main, ["--device", "cuda"])
    # K1: the clean run, then each eps's Algorithm 2, its repaired run and
    # the secure aggregation's clipped rows, then LOCO-CV's statistics
    launches["private_federation"] = launched(
        {"gram_moment": clients * (2 + 3 * len(private.EPS_GRID))})
    steps["private_federation_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    ds = data.generate(seed=0, num_clients=clients, samples_per_client=rows, dim=dim,
                       gamma=0.5, device="cuda")
    ds_cpu = data.FederatedDataset(
        clients=tuple((A.cpu(), b.cpu()) for A, b in ds.clients), test_A=ds.test_A.cpu(),
        test_b=ds.test_b.cpu(), w_star=ds.w_star.cpu(), gamma=ds.gamma)
    K.reset_launch_counts()
    cpu, _ = printed_by(private.run, ds_cpu)
    launched({})                  # the CPU copy launches no kernel
    steps["private_federation_cpu_s"] = time.perf_counter() - t0

    def close(a, b) -> bool:      # one unit in the printed fourth decimal
        return (a is None) == (b is None) and (a is None or abs(a - b) <= 1e-4 * (1 + 1e-9))

    priv = {"lines": lines, "cpu_rows": cpu["rows"], "rows": res["rows"],
            "mse_non_private": [res["mse_non_private"], cpu["mse_non_private"]],
            "loco": [[res["loco_sigma"], res["loco_mse"]], [cpu["loco_sigma"], cpu["loco_mse"]]],
            "tolerance": "the same failed cells; finite MSEs within 1e-4 of the CPU run's"}
    for got, want in zip(res["rows"], cpu["rows"]):
        for key in ("alg2", "alg2_psd", "secagg"):
            check(close(got[key], want[key]),
                  f"private_federation at eps {got['eps']}, {key}: card {got[key]}, "
                  f"cpu {want[key]}")
    check(close(res["mse_non_private"], cpu["mse_non_private"])
          and close(res["loco_mse"], cpu["loco_mse"]) and res["loco_sigma"] == cpu["loco_sigma"]
          and res["thm7_eps_total"] == cpu["thm7_eps_total"], f"private_federation: {priv}")
    del res, cpu, ds, ds_cpu

    # (c) serve_batched at its defaults, then K5 at its prefill's shape
    t0 = time.perf_counter()
    cfg = configs.get_reduced("mixtral-8x22b")
    K.reset_launch_counts()
    res, lines = printed_by(serve_ex.main, ["--device", "cuda"])
    launches["serve_batched"] = launched({"swa_flash": attention_layers(cfg)})
    gen = res["generated"]
    check(gen.shape == (4, 24) and bool(((gen >= 0) & (gen < cfg.vocab_size)).all())
          and lines[0] == f"[serve_batched] {cfg.name}", f"serve_batched: {lines}")
    steps["serve_batched_s"] = time.perf_counter() - t0
    B, S, H, Hkv, hd = 4, 48, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    g = torch.Generator("cuda").manual_seed(ZOO_SEED)
    q, k, v = [torch.randn(shape, generator=g, device="cuda")
               for shape in ((B, S, H, hd), (B, S, Hkv, hd), (B, S, Hkv, hd))]
    k5_f32 = float((K.swa_flash_cuda(q, k, v, window=cfg.window, causal=True)
                    - ref.swa_attention_ref(q, k, v, window=cfg.window, causal=True))
                   .abs().max())
    check(k5_f32 <= 3e-5, f"K5 float32 at serve_batched's prefill: {k5_f32} > 3e-5")
    k5_bf16 = swa_case(g, mesh_lib.card_peaks(torch.cuda.get_device_name(0)),
                       B, S, H, Hkv, hd, cfg.window)
    serve_line = {"lines": lines, "prefill_s": res["prefill_s"],
                  "decode_tok_per_s": res["decode_tok_per_s"],
                  "k5_shape": [B, S, H, Hkv, hd], "window": cfg.window,
                  "k5_f32_max_abs_err": k5_f32, "k5_bf16": k5_bf16}

    # (d) the reduce-scatter on a mesh of two devices
    mesh = mesh_lib.Mesh([torch.device("cuda", 0), "cpu"], ("data",))
    devices = list(mesh.devices.reshape(-1))
    parts = [torch.randn((8, 6), generator=torch.Generator().manual_seed(i)).to(dev)
             for i, dev in enumerate(devices)]
    total = mesh_lib.psum(parts)
    scatter = {}
    for axis in (0, 1):
        sl = mesh_lib.psum_scatter(parts, dim=axis)
        scatter[f"dim {axis}"] = [str(x.device) for x in sl]
        check([x.device for x in sl] == devices, f"psum_scatter placed its slices on "
              f"{scatter[f'dim {axis}']}, the shards are on {devices}")
        check(all(torch.equal(x.cpu(), want.cpu())
                  for x, want in zip(sl, torch.chunk(total, 2, dim=axis))),
              "psum_scatter's slices are not the sum's")

    totals = {name: sum(run.get(name, 0) for run in launches.values())
              for name in K.launch_counts()}
    return {"phase": "examples", "quickstart": quick_line, "quickstart_full_width": full,
            "private_federation": priv, "serve_batched": serve_line,
            "psum_scatter": {"mesh": [str(d) for d in devices], "slices_on": scatter},
            "launches_by_example": launches, "launches": totals, "steps_s": steps,
            "nvidia_smi": smi(), "seconds": time.perf_counter() - t_all}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import repro_torch  # noqa: F401  (fails outside a checkout of the repo)

    from repro_torch.launch import mesh as mesh_lib

    torch.cuda.set_device(0)
    name = torch.cuda.get_device_name(0)
    # published peaks (memory bytes/s, FP32, dense bf16 and dense TF32
    # operations/s): K2 and P are bound at FP32, K5 at bf16, K1, K3 and K4
    # at a third of TF32 (their 3xTF32 routes)
    peaks = mesh_lib.card_peaks(name)
    emit(device_phase())
    kernels_line, rows = kernel_phase(peaks)
    emit(kernels_line)
    ds, w_dense, path = main_path_phase()
    emit(path)
    private = private_federation_phase(ds, peaks)
    emit(private)
    features = feature_phase(ds, w_dense)
    emit(features)
    del w_dense
    emit(pool_serving_phase(ds))
    sharded_line = sharded_serving_phase(ds, peaks)
    emit(sharded_line)
    wire_line = wire_serving_phase(ds)
    emit(wire_line)
    del ds
    emit(process_serving_phase())
    relay_line = relay_serving_phase()
    emit(relay_line)
    lm, serving = model_serving_phase()
    emit(serving)
    probe = private_probe_phase(lm)       # the probe reuses the served model
    del lm
    torch.cuda.empty_cache()
    emit(probe)
    zoo = zoo_serving_phase()
    emit(zoo)
    train = train_phase(peaks)
    emit(train)
    dry = dryrun_phase(peaks, serving, zoo, train)
    emit(dry)
    examples = examples_phase()
    emit(examples)
    for kname, row in rows.items():
        run = (features if kname in ("sketch_gram", "rff_gram")
               else serving if kname == "swa_flash" else path)
        row["launches"] = run["launches"][kname]
        row["wire_launches"] = wire_line["launches"][kname]
        row["relay_launches"] = relay_line["launches"][kname]
        row["private_launches"] = (private["launches"][kname]
                                   + probe["launches"][kname])
        row["sharded_launches"] = (sharded_line["launches"][kname]
                                   + probe["mesh_launches"][kname])
        row["zoo_launches"] = zoo["launches"][kname]
        row["train_launches"] = train["launches"][kname]
        row["example_launches"] = (dry["example"]["launches"][kname]
                                   + examples["launches"][kname])
    order = ("name", "route", "source", "replaces", "launches", "wire_launches",
             "relay_launches", "private_launches", "sharded_launches", "zoo_launches",
             "train_launches", "example_launches", "max_abs_err",
             "ms", "device_ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    emit({"kernels": [{k: row[k] for k in order if k in row} for row in rows.values()]})
    print(smi(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
