"""Process-level federated runtime: clients, server, protocol executions.

The paper-faithful K-client simulation: every execution returns the model
and a CommRecord measured from the payloads that moved. The executions are
thin protocol adapters over ``server.FusionEngine``: they emulate the client
side (local statistics, dropout masks) and hand everything server-side —
aggregation, factorization, solving, LOCO CV — to one engine, returned in
``extras["engine"]`` so callers can keep serving from the fused state.

What travels between the two sides is :class:`PackedStats`, the Theorem-4
wire format: the d(d+1)/2 lower triangle of the client Gram
(``kernels.ops.pack_lower``) plus the d-float moment.

With ``dp=(eps, delta)`` the clients run Algorithm 2: each clips its rows,
computes its statistics (kernel K1 on the card) and adds the Gaussian
mechanism's noise once (``core.privacy``), drawn from its own key of
``split(dp_key, K)`` — the bits ``jax.random`` draws for the same key.

``run_one_shot_projected`` is the §IV-F variant: clients upload the m x m
statistics of their rows under a shared Gaussian sketch, and the engine
solves in the m-dimensional sketch space.

``run_one_shot(mesh=...)`` fuses into a ``server.ShardedBackend`` on the
mesh; ``backend="auto"`` picks dense or sharded (``server.select``).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Sequence

import torch

from repro_torch.core import privacy, projection, threefry
from repro_torch.core.sufficient_stats import SuffStats, compute_stats
from repro_torch.data.synthetic import FederatedDataset
from repro_torch.fed import comm
from repro_torch.kernels import ops as kernel_ops
from repro_torch.server import FusionEngine, LinalgBackend, ShardedBackend


@dataclasses.dataclass(frozen=True)
class PackedStats:
    """One client's upload in the Theorem-4 wire encoding.

    ``tri`` is the row-major lower triangle of the client Gram, ``moment``
    the d-float moment vector; ``count`` rides along as metadata and
    ``yty`` (sum b^2) closes the inference algebra server-side (``None``
    for a moments-less payload). ``pack``/``unpack`` are exact.
    """

    tri: torch.Tensor       # (d(d+1)/2,)
    moment: torch.Tensor    # (d,)
    count: torch.Tensor
    dim: int
    yty: torch.Tensor | None = None

    @classmethod
    def pack(cls, stats: SuffStats) -> "PackedStats":
        return cls(kernel_ops.pack_lower(stats.gram), stats.moment,
                   stats.count, stats.dim, yty=stats.yty)

    def unpack(self) -> SuffStats:
        return SuffStats(kernel_ops.unpack_lower(self.tri, self.dim),
                         self.moment, self.count,
                         yty=None if self.yty is None
                         else self.yty.to(self.tri.dtype))

    @property
    def wire_floats(self) -> int:
        """Floats on the wire for this upload (what the ledger measures)."""
        return int(self.tri.numel() + self.moment.numel())


@dataclasses.dataclass
class RunResult:
    weights: torch.Tensor
    comm: comm.CommRecord
    wall_time_s: float
    rounds: int
    extras: dict = dataclasses.field(default_factory=dict)


def client_phase(ds: FederatedDataset, *,
                 participating: Sequence[bool] | None = None,
                 dp: tuple[float, float] | None = None,
                 dp_clip: tuple[float, float] | None = None,
                 dp_key=None,
                 client_stats: Sequence[SuffStats] | None = None,
                 ) -> dict[int, PackedStats]:
    """Phase 1 on every participating client: what each one uploads.

    ``client_stats`` short-circuits the (deterministic) local computation
    with already-computed statistics — but never the DP pipeline, whose
    clipping must see the raw rows. Under ``dp`` the key is split over all
    K clients, whatever the participation.
    """
    keys = (threefry.split(dp_key, ds.num_clients)
            if dp is not None else [None] * ds.num_clients)
    if dp is not None and dp_clip is None:
        dp_clip = (1.2 * ds.dim ** 0.5, 4.0)

    uploads: dict[int, PackedStats] = {}
    for k, (A_k, b_k) in enumerate(ds.clients):
        if participating is not None and not participating[k]:
            continue
        if dp is None and client_stats is not None:
            uploads[k] = PackedStats.pack(client_stats[k])
            continue
        s_g, s_h = (1.0, 1.0)
        if dp is not None:
            A_k, b_k = privacy.clip_rows(A_k, b_k, clip_a=dp_clip[0],
                                         clip_b=dp_clip[1])
            s_g, s_h = privacy.sensitivities(*dp_clip)
        s = compute_stats(A_k, b_k)
        if dp is not None:
            s = privacy.privatize_stats(keys[k], s, *dp,
                                        sensitivity_g=s_g, sensitivity_h=s_h)
        uploads[k] = PackedStats.pack(s)
    return uploads


def run_one_shot(ds: FederatedDataset, sigma: float, *,
                 participating: Sequence[bool] | None = None,
                 dp: tuple[float, float] | None = None,
                 dp_clip: tuple[float, float] | None = None,
                 dp_key=None,
                 psd_repair: bool = False,
                 client_stats: Sequence[SuffStats] | None = None,
                 backend: LinalgBackend | None = None,
                 mesh=None) -> RunResult:
    """Algorithm 1 (or Algorithm 2 when ``dp`` is given) over process
    clients.

    Args:
      participating: Thm 8 dropout mask; dropped clients transmit nothing.
      dp: (eps, delta) for Algorithm 2 — per-client Gaussian noise, no
        composition. Rows are clipped per Definition 3 (generalized) with
        public clip constants ``dp_clip = (clip_a, clip_b)``; default
        (1.2 sqrt(d), 4) covers N(mu, I)-scale features without biasing.
      dp_key: a uint32 key pair (``core.threefry.key(seed)``, or a JAX key
        through ``convert.key_from``).
      psd_repair: beyond-paper post-processing (``privacy.psd_repair``).
      client_stats: reuse already-computed per-client statistics (ignored
        under DP).
      backend: linalg backend for the engine; defaults to dense on the
        clients' device. With a sharded backend the engine in
        ``extras["engine"]`` keeps the fused Gram block-sharded, the record
        gains the cross-shard reduction ledger, and no eager dense
        ``fused_stats`` is gathered (``extras["engine"].stats`` gives one).
        ``backend="auto"`` picks dense or sharded(``mesh``) by the threshold
        (``server.select``).
      mesh: shorthand for ``backend=ShardedBackend(ds.dim, mesh)`` (or the
        candidate mesh under ``backend="auto"``).
    """
    t0 = time.perf_counter()
    if backend == "auto":
        from repro_torch.server import auto_backend

        backend = auto_backend(ds.dim, mesh, device=ds.test_A.device)
    elif backend is None and mesh is not None:
        backend = ShardedBackend(ds.dim, mesh)
    uploads = client_phase(ds, participating=participating, dp=dp,
                           dp_clip=dp_clip, dp_key=dp_key,
                           client_stats=client_stats)
    engine = FusionEngine.from_clients(
        {k: p.unpack() for k, p in uploads.items()}, backend=backend)
    if psd_repair:
        engine.apply(privacy.psd_repair)
    w = engine.solve(sigma)
    kernel_ops.synchronize(w)
    dt = time.perf_counter() - t0
    extras = {"engine": engine, "participating_clients": len(uploads)}
    if isinstance(backend, ShardedBackend):
        # the ledger models the on-mesh reduction into the block layout;
        # gathering G onto one device is what the backend exists to avoid
        record = comm.sharded_oneshot_record(
            ds.dim, len(uploads), backend.fusion_axis_sizes)
    else:
        record = comm.measured_one_shot(list(uploads.values()),
                                        download_floats=ds.dim)
        extras["fused_stats"] = engine.stats
    return RunResult(weights=w, comm=record, wall_time_s=dt, rounds=1,
                     extras=extras)


def run_one_shot_projected(ds: FederatedDataset, sigma: float, m: int, *,
                           key) -> RunResult:
    """§IV-F random-projection protocol; returns the lifted w~ = R v.

    ``key`` is a uint32 pair (``core.threefry.key(seed)``, or a JAX PRNG key
    passed through ``np.asarray``); R is drawn from it as the reference
    draws it, on the clients' device.
    """
    t0 = time.perf_counter()
    R = projection.make_projection(key, ds.dim, m, device=ds.test_A.device)
    payloads = [PackedStats.pack(projection.projected_stats(A_k, b_k, R))
                for A_k, b_k in ds.clients]    # m(m+1)/2 + m floats each
    engine = FusionEngine.from_clients([p.unpack() for p in payloads])
    w = projection.lift(engine.solve(sigma), R)
    kernel_ops.synchronize(w)
    return RunResult(
        weights=w,
        comm=comm.measured_one_shot(payloads, download_floats=m, frame="proj"),
        wall_time_s=time.perf_counter() - t0,
        rounds=1,
        # The engine lives in projected space (dim m): solve() yields v, and
        # callers must lift with extras["projection"] to get d-dim weights.
        extras={"m": m, "engine": engine, "projection": R},
    )


def run_centralized(ds: FederatedDataset, sigma: float) -> RunResult:
    """Oracle: centralized ridge with access to all data."""
    t0 = time.perf_counter()
    A, b = ds.stacked()
    engine = FusionEngine.from_stats(compute_stats(A, b))
    w = engine.solve(sigma)
    kernel_ops.synchronize(w)
    return RunResult(
        weights=w,
        comm=comm.CommRecord(0, 0, ds.num_clients, 0),
        wall_time_s=time.perf_counter() - t0,
        rounds=0,
        extras={"engine": engine},
    )


def run_loco_cv(ds: FederatedDataset, sigmas: Sequence[float]
                ) -> tuple[float, RunResult]:
    """Prop 5 sigma selection followed by final fusion at sigma*.

    The engine solves all K * |Sigma| held-out systems in one vectorized
    pass, and the final fusion reuses the statistics the CV already received.
    """
    stats = [compute_stats(A_k, b_k) for A_k, b_k in ds.clients]
    engine = FusionEngine.from_clients(stats)
    best, losses = engine.loco_cv(list(ds.clients), sigmas)
    res = run_one_shot(ds, best, client_stats=stats)
    res.extras["cv_losses"] = losses
    res.extras["sigma_grid"] = list(sigmas)
    # Prop 5 overhead: K * |Sigma| scalars on top of the one-shot payload.
    rep = {"upload_floats_per_client":
           res.comm.upload_floats_per_client + len(sigmas)}
    if res.comm.upload_wire_bytes_per_client is not None:
        rep["upload_wire_bytes_per_client"] = (
            res.comm.upload_wire_bytes_per_client
            + len(sigmas) * comm.FLOAT_BYTES)
    res.comm = dataclasses.replace(res.comm, **rep)
    return best, res
