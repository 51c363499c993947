"""Server subsystem: the production path for one-shot fusion.

``FusionEngine`` is the paper's server made stateful and servable — fused
``(G, h)`` ownership, cached and incrementally maintained factors, batched
multi-sigma solving, Thm 8 dropout, §VI-C streaming, and Prop 5 LOCO CV.
The engine is the policy layer; the linear algebra lives behind a
``LinalgBackend`` (``DenseBackend`` in this slice of the port).
``core.fusion`` keeps the pure-function references.
"""
from repro_torch.server.backends import DenseBackend, LinalgBackend, solve_snapshot
from repro_torch.server.cholesky import (chol_rank1, chol_update,
                                         chol_update_blocked, panel_transform,
                                         psd_update_vectors)
from repro_torch.server.engine import CoalescerPolicy, FusionEngine
from repro_torch.server.inference import inference_report, reference_inference

__all__ = ["FusionEngine", "CoalescerPolicy", "solve_snapshot",
           "LinalgBackend", "DenseBackend", "chol_rank1", "chol_update",
           "chol_update_blocked", "panel_transform", "psd_update_vectors",
           "inference_report", "reference_inference"]
