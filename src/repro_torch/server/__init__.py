"""Server subsystem: the production path for one-shot fusion.

``FusionEngine`` is the paper's server made stateful and servable — fused
``(G, h)`` ownership, cached and incrementally maintained factors, batched
multi-sigma solving, Thm 8 dropout, §VI-C streaming, and Prop 5 LOCO CV.
The engine is the policy layer; the linear algebra lives behind a
``LinalgBackend``: ``DenseBackend`` (one device) or ``ShardedBackend``
((G, h) block-sharded over a ``launch.mesh.Mesh``; on-mesh fusion and a
block-Cholesky / CG solve over the blocks).

``EnginePool`` serves many tenants' engines from one process: admission
quotas, per-tenant locks, a background staleness flusher, LRU eviction of
factor caches, a pool-level byte ledger, and ``solve_many``, which answers
requests across tenants in one ``solve_stacked`` sweep per (d, dtype);
``SolveBatcher`` puts a micro-batching window in front of it.
``server.durability`` (``DurableStore``, ``Journal``, ``scan_segment``)
keeps a pool's state on disk: a write-ahead journal of admitted wire frames
and snapshots. ``server.relay`` (``RelayForwarder``, ``ForwardPolicy``)
makes a journaled pool the middle tier of an aggregation tree: it forwards
one fused delta frame per tenant upstream, crash-safe. ``core.fusion``
keeps the pure-function references.
"""
from repro_torch.server.backends import DenseBackend, LinalgBackend, solve_snapshot
from repro_torch.server.batch import SolveBatcher, solve_stacked
from repro_torch.server.cholesky import (chol_rank1, chol_update,
                                         chol_update_blocked, panel_transform,
                                         psd_update_vectors)
from repro_torch.server.distributed import ShardedBackend, ShardedFactor
from repro_torch.server.engine import CoalescerPolicy, FusionEngine
from repro_torch.server.inference import inference_report, reference_inference
from repro_torch.server.pool import AdmissionError, EnginePool, Tenant
from repro_torch.server.select import auto_backend, backend_threshold, prefer_sharded
# durability and relay pull in repro_torch.fed for the wire codec, whose
# protocol module imports this package back: they come last
from repro_torch.server.durability import DurableStore, Journal, scan_segment
from repro_torch.server.relay import ForwardPolicy, RelayForwarder

__all__ = ["FusionEngine", "CoalescerPolicy", "EnginePool", "Tenant",
           "AdmissionError", "DurableStore", "Journal", "scan_segment",
           "ForwardPolicy", "RelayForwarder",
           "SolveBatcher", "solve_stacked", "solve_snapshot",
           "LinalgBackend", "DenseBackend", "ShardedBackend", "ShardedFactor",
           "chol_rank1", "chol_update",
           "chol_update_blocked", "panel_transform", "psd_update_vectors",
           "inference_report", "reference_inference", "auto_backend",
           "backend_threshold", "prefer_sharded"]
