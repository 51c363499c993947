"""Backend selection: dense vs sharded from a measured crossover.

``backend_threshold`` resolves the dimension at or above which the sharded
backend would be preferred, ``prefer_sharded`` asks it for one dimension
(a pool's ``"auto"`` placement), and ``auto_backend`` returns a ready
backend.

Resolution order: an explicit ``threshold=``, then the ``crossover_d`` of a
dense-vs-sharded table named by ``table=``, then +inf (dense everywhere).
Unlike the reference, the port has no default table: the reference's
``experiments/repro/sharded_fusion_bench.json`` is a CPU measurement of its
JAX sharded backend, not evidence for the card, so every dimension goes
dense unless a caller pins a number.
"""
from __future__ import annotations

import json
import math
import pathlib

import torch


def backend_threshold(threshold: float | None = None,
                      table: pathlib.Path | str | None = None) -> float:
    """Dimension at/above which the sharded backend is preferred.

    Explicit ``threshold`` -> ``crossover_d`` of ``table`` -> +inf. A table
    that is missing, unreadable or reports a null crossover reads as +inf.
    """
    if threshold is not None:
        return float(threshold)
    if table is None:
        return math.inf
    try:
        crossover = json.loads(pathlib.Path(table).read_text()).get("crossover_d")
    except (OSError, ValueError):
        crossover = None
    return float(crossover) if crossover is not None else math.inf


def prefer_sharded(dim: int, *, threshold: float | None = None,
                   table: pathlib.Path | str | None = None) -> bool:
    """Would ``auto`` place this dimension on the sharded backend?"""
    return dim >= backend_threshold(threshold, table)


def auto_backend(dim: int, mesh=None, *, threshold: float | None = None,
                 table: pathlib.Path | str | None = None,
                 dtype=torch.float32, device="cuda", **sharded_kwargs):
    """Backend for ``dim``: a ``ShardedBackend`` on ``mesh`` iff a mesh is
    given AND ``dim`` clears the threshold, else a ``DenseBackend`` on
    ``device``."""
    from repro_torch.server.backends import DenseBackend
    from repro_torch.server.distributed import ShardedBackend

    if mesh is not None and prefer_sharded(dim, threshold=threshold,
                                           table=table):
        return ShardedBackend(dim, mesh, dtype=dtype, **sharded_kwargs)
    return DenseBackend(dim, dtype=dtype, device=device)
