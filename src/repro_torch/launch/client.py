"""Wire-protocol client CLI: one federated participant as its own process.

The paper's client loop across a real process boundary: the client draws
the shared synthetic dataset (the seed every participant uses) on
``--device``, keeps its own ``--client-index`` shard, runs Phase 1 there
(kernel K1 on the card, or K3 / K4 for a ``--features`` upload), negotiates
a wire dtype with the server and ships the Thm-4 packed upload, the §IV-F
feature variant or §VI-C delta-row batches over TCP. It can then drive the
Thm-8 control plane (drop / rejoin) and query the fused solution.

The last line on stdout is one JSON report with the JAX package's keys
(negotiated dtype, bytes per direction, the served weights with
``--solve``) plus ``seconds``, the wall time of the draw, of Phase 1 and of
the upload, and ``launches``, this process's launches of each CUDA kernel
(none on the CPU).

Usage (a 3-client federation against ``serve --mode fusion --listen``)::

    PYTHONPATH=src python -m repro_torch.launch.client \\
        --connect 127.0.0.1:7777 --tenant ridge --seed 0 --num-clients 3 \\
        --client-index 0 --samples 128 --dim 32 --offer f64,f32 \\
        --solve 0.1 [--device cpu]

The draw is the port's ``data.synthetic.generate``, a ``torch.Generator``
on the device: its numbers are not the JAX package's, and the card's
generator gives other numbers than the CPU's.
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np


def run_client(args: argparse.Namespace) -> dict:
    import torch

    from repro_torch.core.features import FeatureMap
    from repro_torch.core.sufficient_stats import compute_stats
    from repro_torch.data import synthetic
    from repro_torch.fed import transport
    from repro_torch.fed.protocol import PackedStats
    from repro_torch.kernels import gram, ops

    # This client's shard of the shared dataset, drawn BEFORE the connection
    # opens: a first kernel build can take seconds and must not count
    # against the server's idle timeout.
    t0 = time.perf_counter()
    ds = synthetic.generate(args.seed, num_clients=args.num_clients,
                            samples_per_client=args.samples, dim=args.dim,
                            device=torch.device(args.device))
    A, b = ds.clients[args.client_index]
    del ds
    ops.synchronize(A)
    seconds = {"generate": time.perf_counter() - t0}

    host, _, port = args.connect.rpartition(":")
    offers = tuple(args.offer.split(","))
    resilient = args.retries > 0

    def connect():
        return transport.TCPChannel(host or "127.0.0.1", int(port),
                                    timeout_s=args.timeout)

    features = args.features
    if args.projected and features == "none":
        # Legacy spelling: --projected M == --features sketch --feature-dim M
        features, args.feature_dim = "sketch", args.projected
    # Phase 1, before the connection opens too
    t0 = time.perf_counter()
    fm = packed = stats = None
    if features != "none":
        fm = FeatureMap(features, seed=args.proj_seed, d_orig=args.dim,
                        m=args.feature_dim, lengthscale=args.lengthscale)
        packed = PackedStats.pack(fm.stats(A, b))
        ops.synchronize(A)
    elif not args.delta_batches:
        stats = compute_stats(A, b)
        ops.synchronize(A)
    seconds["phase1"] = time.perf_counter() - t0

    if resilient:
        # Crash- and partition-tolerant: reconnect and resume with seeded
        # exponential backoff. A blind re-send after a lost ACK is safe: the
        # server deduplicates byte-identical frames (duplicate=True).
        seed = (args.retry_seed if args.retry_seed is not None
                else 1000 + args.client_index)   # distinct jitter per client
        client = transport.ResilientClient(
            connect, tenant=args.tenant, offers=offers,
            retries=args.retries, backoff_s=args.backoff,
            jitter=args.jitter, seed=seed,
            max_chunk_payload=args.max_chunk_payload)
    else:
        client = transport.FrameClient(
            connect(), max_chunk_payload=args.max_chunk_payload)
    report: dict = {"tenant": args.tenant, "client_id": args.client_id,
                    "client_index": args.client_index}
    try:
        report["negotiated_dtype"] = (client.hello() if resilient
                                      else client.hello(args.tenant, offers))
        t0 = time.perf_counter()
        if fm is not None:
            # yty = sum b^2 is featurization-invariant (targets never pass
            # through the map), so feature tenants serve the same solve-space
            # inference as dense ones
            yty = (float(packed.yty) if args.moments and packed.yty is not None
                   else None)
            if features == "sketch":
                client.upload_projected(packed, d_orig=args.dim,
                                        seed=args.proj_seed, rhash=fm.fhash,
                                        client_id=args.client_id, yty=yty)
            else:
                client.upload_rff(packed, d_orig=args.dim,
                                  seed=args.proj_seed, fhash=fm.fhash,
                                  lengthscale=args.lengthscale,
                                  client_id=args.client_id, yty=yty)
            # the port has one Phase-1 route a device: the kernel on the
            # card, its plain version on the CPU
            report["uploaded"] = {
                "frame": "proj" if features == "sketch" else "rff",
                "m": args.feature_dim, "proj_seed": args.proj_seed,
                "fused_ingest": True, "moments": yty is not None}
        elif args.delta_batches:
            # §VI-C: the same rows as raw delta batches instead of one packed
            # statistic (Thm 1 makes the union identical); the server runs
            # Phase 1 on each
            n = A.shape[0]
            bounds = np.linspace(0, n, args.delta_batches + 1, dtype=int)
            for lo, hi in zip(bounds[:-1], bounds[1:]):
                if hi > lo:
                    client.stream_rows(A[lo:hi], b[lo:hi],
                                       client_id=args.client_id)
            report["uploaded"] = {"frame": "delta",
                                  "batches": args.delta_batches, "rows": n}
        else:
            client.upload_stats(stats, client_id=args.client_id,
                                moments=args.moments)
            report["uploaded"] = {"frame": "tri", "d": args.dim,
                                  "count": int(A.shape[0]),
                                  "moments": args.moments}
        seconds["upload"] = time.perf_counter() - t0

        if args.control:
            op, _, target = args.control.partition(":")
            client.control(op, target or args.client_id)
            report["control"] = {"op": op, "target": target or args.client_id}

        if args.solve is not None:
            w = client.solve(args.solve)
            report["solve"] = {"sigma": args.solve,
                               "weights": np.asarray(w, np.float64).tolist()}

        if resilient:
            s = client.summary()
            report.update(bytes_uploaded=s["bytes_uploaded"],
                          bytes_sent=s["bytes_sent"],
                          bytes_received=s["bytes_received"],
                          frames_sent=s["frames_sent"],
                          retries=s["retries"], reconnects=s["reconnects"],
                          duplicate_acks=s["duplicate_acks"], ok=True)
        else:
            report.update(bytes_uploaded=client.bytes_uploaded,
                          bytes_sent=client.bytes_sent,
                          bytes_received=client.bytes_received,
                          frames_sent=client.frames_sent, ok=True)
    finally:
        client.close()
    report["seconds"] = seconds
    report["launches"] = gram.launch_counts()
    return report


def make_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--connect", required=True, metavar="HOST:PORT",
                    help="wire server address (serve --mode fusion "
                         "--listen PORT)")
    ap.add_argument("--tenant", default="default",
                    help="tenant this session binds to at HELLO")
    ap.add_argument("--client-id", default=None,
                    help="client id carried in upload/control frames "
                         "(default: client<index>)")
    ap.add_argument("--offer", default="f32",
                    help="comma list of wire dtypes to offer (f32,f64,bf16); "
                         "the server's policy picks one")
    ap.add_argument("--seed", type=int, default=0,
                    help="shared dataset seed (same for every participant)")
    ap.add_argument("--num-clients", type=int, default=3)
    ap.add_argument("--client-index", type=int, default=0,
                    help="which client's shard this process owns")
    ap.add_argument("--samples", type=int, default=128)
    ap.add_argument("--dim", type=int, default=32)
    ap.add_argument("--projected", type=int, default=0, metavar="M",
                    help="upload the §IV-F m-dim sketched statistics instead "
                         "of the full Thm-4 payload (alias for --features "
                         "sketch --feature-dim M)")
    ap.add_argument("--features", choices=("none", "sketch", "rff"),
                    default="none",
                    help="§IV-F feature map: 'sketch' ships the m-dim JL "
                         "projection statistics (K3), 'rff' the D-dim "
                         "random-Fourier statistics (K4)")
    ap.add_argument("--feature-dim", type=int, default=16, metavar="M",
                    help="feature count (sketch m / rff D)")
    ap.add_argument("--lengthscale", type=float, default=1.0,
                    help="RBF lengthscale for --features rff")
    ap.add_argument("--proj-seed", type=int, default=0,
                    help="shared feature-map seed (all feature clients must "
                         "agree; the server verifies the map hash)")
    ap.add_argument("--delta-batches", type=int, default=0, metavar="N",
                    help="ship the shard as N §VI-C delta-row frames instead "
                         "of one packed statistic")
    ap.add_argument("--moments", action="store_true",
                    help="append the 8-byte MOMENTS section (yty = sum y^2) "
                         "to the upload so the server can serve federated "
                         "inference (stderr/CI/PI)")
    ap.add_argument("--control", default=None, metavar="OP[:CLIENT]",
                    help="after uploading, send a Thm-8 control frame: "
                         "'drop', 'restore', or 'drop:other_id'")
    ap.add_argument("--solve", type=float, default=None, metavar="SIGMA",
                    help="query the fused weights at SIGMA and report them")
    ap.add_argument("--timeout", type=float, default=120.0,
                    help="socket timeout awaiting each server reply")
    ap.add_argument("--retries", type=int, default=0,
                    help="max retries per operation (0 = fail fast); >0 "
                         "switches to the resilient client: reconnect, "
                         "re-HELLO, and re-send on transient failures, "
                         "relying on server-side dedup for lost ACKs")
    ap.add_argument("--backoff", type=float, default=0.05, metavar="S",
                    help="base retry backoff in seconds (doubles per "
                         "attempt, capped at 2s)")
    ap.add_argument("--jitter", type=float, default=0.5,
                    help="backoff jitter fraction in [0,1]: each delay is "
                         "scaled by 1 + jitter*U(-1,1) from --retry-seed")
    ap.add_argument("--retry-seed", type=int, default=None,
                    help="seed for the jitter schedule (default: derived "
                         "from --client-index so clients desynchronize)")
    ap.add_argument("--max-chunk-payload", type=int, default=None,
                    metavar="BYTES",
                    help="stream uploads whose payload exceeds BYTES as "
                         "continuation chunks; smaller uploads stay "
                         "byte-identical")
    ap.add_argument("--device", default="cuda",
                    help="where the draw and Phase 1 run (cuda or cpu)")
    return ap


def main(argv=None) -> None:
    args = make_parser().parse_args(argv)
    if args.client_id is None:
        args.client_id = f"client{args.client_index}"
    report = run_client(args)
    print(json.dumps(report), flush=True)


if __name__ == "__main__":
    main()
