"""Sufficient statistics for ridge regression (paper §III-D, Theorem 1).

The ridge solution w_sigma = (A^T A + sigma I)^{-1} A^T b depends on the data
only through G = A^T A (d x d) and h = A^T b (d), and both decompose
additively over any row partition of (A, b) — Theorem 1. This module
provides:

  * ``compute_stats``           — local (G_k, h_k) on one client's data
                                  (kernel K1 for CUDA tensors)
  * ``compute_stats_streaming`` — chunked pass over rows (bounded memory)
  * ``fuse_stats``              — Phase-2 server aggregation (a tree-sum)
  * ``streaming_update``        — §VI-C: fold new rows into old statistics
  * ``distributed_stats``       — Phases 1+2 on a mesh: each row shard is a
                                  client, one reduction is the round
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import torch

from repro_torch.kernels import ops as kernel_ops


@dataclasses.dataclass(frozen=True)
class SuffStats:
    """Sufficient statistics of ridge regression (Definition 1).

    Attributes:
      gram:   G = A^T A, shape (d, d), symmetric PSD.
      moment: h = A^T b, shape (d,).
      count:  number of rows n (0-d int32 tensor on the stats' device).
      yty:    residual second moment sum b_i^2 (0-d tensor), or None when
              unknown. Combining a None with anything degrades the result to
              None: point estimates are untouched, inference fields degrade.
    """

    gram: torch.Tensor
    moment: torch.Tensor
    count: torch.Tensor
    yty: torch.Tensor | None = None

    @property
    def dim(self) -> int:
        return self.gram.shape[-1]

    @staticmethod
    def _combine_yty(a, b, op):
        if a is None or b is None:
            return None
        return op(a, b)

    def __add__(self, other: "SuffStats") -> "SuffStats":
        # Theorem 1: additivity over row partitions.
        return SuffStats(
            gram=self.gram + other.gram,
            moment=self.moment + other.moment,
            count=self.count + other.count,
            yty=self._combine_yty(self.yty, other.yty, lambda a, b: a + b),
        )

    def __sub__(self, other: "SuffStats") -> "SuffStats":
        # Additivity also licenses removal (Thm 8 dropout, Prop 5 LOCO).
        return SuffStats(
            gram=self.gram - other.gram,
            moment=self.moment - other.moment,
            count=self.count - other.count,
            yty=self._combine_yty(self.yty, other.yty, lambda a, b: a - b),
        )

    def scale(self, s) -> "SuffStats":
        """Scale a client's contribution (0/1 masks give Thm 8 dropout)."""
        return SuffStats(self.gram * s, self.moment * s, self.count * s,
                         yty=None if self.yty is None else self.yty * s)

    def without_moments(self) -> "SuffStats":
        """The same statistics with the second moment dropped (yty=None)."""
        return SuffStats(self.gram, self.moment, self.count, yty=None)


def _count(n: int, device) -> torch.Tensor:
    # a fill on the device: no copy from the host, which would wait for the
    # device's queued work (and serialise the cards of a mesh)
    return torch.full((), n, dtype=torch.int32, device=device)


def zeros_like_stats(d: int, dtype=torch.float32, *,
                     device="cuda") -> SuffStats:
    return SuffStats(
        gram=torch.zeros((d, d), dtype=dtype, device=device),
        moment=torch.zeros((d,), dtype=dtype, device=device),
        count=_count(0, device),
        yty=torch.zeros((), dtype=dtype, device=device),
    )


def compute_stats(A: torch.Tensor, b: torch.Tensor) -> SuffStats:
    """Local Phase-1 computation: G_k = A_k^T A_k, h_k = A_k^T b_k.

    (G, h) come from ``kernels.ops.gram_moment``: kernel K1 for CUDA
    tensors, its plain version for CPU tensors. Accumulation is float32 for
    bf16/f16 inputs, else the input dtype.

    Args:
      A: (n_k, d) feature matrix of one client.
      b: (n_k,) target vector.
    """
    if A.ndim != 2:
        raise ValueError(f"A must be (n, d), got {tuple(A.shape)}")
    if tuple(b.shape) != (A.shape[0],):
        raise ValueError(f"b must be ({A.shape[0]},), got {tuple(b.shape)}")
    gram, moment = kernel_ops.gram_moment(A, b)
    acc = torch.float32 if b.dtype in (torch.bfloat16, torch.float16) \
        else b.dtype
    bb = b.to(acc)
    yty = torch.dot(bb, bb).to(gram.dtype)
    return SuffStats(gram=gram, moment=moment,
                     count=_count(A.shape[0], A.device), yty=yty)


def _promote_f32(dtype: torch.dtype) -> torch.dtype:
    return torch.promote_types(dtype, torch.float32)


def compute_stats_streaming(A: torch.Tensor, b: torch.Tensor, *,
                            chunk: int = 1024) -> SuffStats:
    """Streaming Phase-1 over row chunks (bounded working set).

    Mirrors a memory-constrained edge client: G accumulates in a d x d
    buffer while rows stream through one (chunk, d) window at a time. Only
    the ragged tail chunk is zero-padded — zero rows contribute zero to G,
    h and yty, so padding is exact.
    """
    n, d = A.shape
    out = zeros_like_stats(d, _promote_f32(A.dtype), device=A.device)
    n_main = (n // chunk) * chunk
    for i in range(0, n_main, chunk):
        out = out + compute_stats(A[i:i + chunk], b[i:i + chunk])
    if n_main < n:
        tail = n - n_main
        a_t = torch.nn.functional.pad(A[n_main:], (0, 0, 0, chunk - tail))
        b_t = torch.nn.functional.pad(b[n_main:], (0, chunk - tail))
        out = out + compute_stats(a_t, b_t)
    # chunk-sized steps over-count padded rows; fix the true count.
    return SuffStats(out.gram, out.moment, _count(n, A.device), yty=out.yty)


def fuse_stats(stats: Sequence[SuffStats], *, chunk: int = 8) -> SuffStats:
    """Phase-2 server aggregation: G = sum_k G_k, h = sum_k h_k (Thm 1).

    A chunked tree reduction: at most ``chunk`` Grams are stacked into one
    buffer and summed, and the chunk partials recurse, so peak extra memory
    is O(chunk * d^2 + K/chunk * d^2) rather than O(K * d^2).
    """
    if not stats:
        raise ValueError("need at least one client's statistics")
    if any(s.yty is None for s in stats) and \
            any(s.yty is not None for s in stats):
        stats = [s if s.yty is None else s.without_moments() for s in stats]
    if len(stats) == 1:
        return stats[0]
    if len(stats) <= chunk:
        def total(field):
            return torch.stack([getattr(s, field) for s in stats]).sum(dim=0)

        return SuffStats(
            gram=total("gram"), moment=total("moment"),
            count=total("count").to(stats[0].count.dtype),
            yty=None if stats[0].yty is None else total("yty"))
    partials = [fuse_stats(stats[i:i + chunk], chunk=chunk)
                for i in range(0, len(stats), chunk)]
    return fuse_stats(partials, chunk=chunk)


def streaming_update(old: SuffStats, delta_A: torch.Tensor,
                     delta_b: torch.Tensor) -> SuffStats:
    """§VI-C streaming extension: fold newly arrived rows into existing stats."""
    return old + compute_stats(delta_A, delta_b)


# ---------------------------------------------------------------------------
# Distributed protocol: clients = mesh shards, Phase 2 = one psum.
# ---------------------------------------------------------------------------

def _client_rows(x, k: int, n_clients: int, client_axes, dev) -> torch.Tensor:
    """Client k's rows of ``x`` on ``dev``: its block of a row-sharded
    :class:`~repro_torch.launch.sharding.ShardedTensor` (already on its
    device), or its even share of a plain tensor, copied straight there."""
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch.sharding import ShardedTensor, spec_axes

    if isinstance(x, ShardedTensor):
        if spec_axes(x.spec[0]) != tuple(client_axes) or any(x.spec[1:]):
            raise ValueError(f"rows sharded as {x.spec}, clients along "
                             f"{tuple(client_axes)}")
        return mesh_lib.send(x.blocks[(k,) + (0,) * (len(x.shape) - 1)], dev)
    rows = x.shape[0] // n_clients
    return mesh_lib.send(x[k * rows:(k + 1) * rows], dev)


def client_stats(A, b, mesh, *, client_axes: tuple[str, ...] = ("data",),
                 participation=None, noise_fn=None) -> list[SuffStats]:
    """Phase 1 on a mesh: each client's local statistics on its own device,
    in flat client order (the per-client half of :func:`distributed_stats`).

    Client k is flat (row-major) position k along ``client_axes``; its
    device is the mesh's at those coordinates (index 0 along the other
    axes). Its rows go straight there, from an even split of ``A`` / ``b``
    or from their blocks when they are row-sharded ``ShardedTensor`` blocks,
    and K1 computes its ``(G_k, h_k)`` there. ``noise_fn(k, G_k, h_k)``
    (Algorithm 2) and the weight ``participation[k]`` (Thm 8) follow; the
    count becomes the float weighted row count. Without ``participation``
    the Gram is not scaled (a weight of one keeps its bits) and no d x d
    copy is made.
    """
    from repro_torch.launch import mesh as mesh_lib

    n_clients = mesh_lib.axis_size(mesh, client_axes)
    if A.shape[0] % n_clients:
        raise ValueError(f"{A.shape[0]} rows do not split over {n_clients} "
                         f"clients along {client_axes}")
    part = (torch.ones(n_clients, dtype=torch.float32) if participation is None
            else torch.as_tensor(participation, dtype=torch.float32))
    local = []
    for k in range(n_clients):
        dev = mesh.device_at(mesh_lib.unflatten(mesh, client_axes, k))
        s = compute_stats(_client_rows(A, k, n_clients, client_axes, dev),
                          _client_rows(b, k, n_clients, client_axes, dev))
        if noise_fn is not None:
            # DP noise covers (G, h) only; an un-noised sum of y^2 riding
            # along would leak, so the privatized statistics drop it.
            g_t, h_t = noise_fn(k, s.gram, s.moment)
            s = SuffStats(g_t, h_t, s.count)
        w = torch.full((), float(part[k]), dtype=torch.float32, device=dev)
        gram = s.gram if participation is None else s.gram * w
        local.append(SuffStats(gram, s.moment * w, s.count * w,
                               yty=None if s.yty is None else s.yty * w))
    return local


def distributed_stats(A, b, mesh, *,
                      client_axes: tuple[str, ...] = ("data",),
                      participation=None, noise_fn=None) -> SuffStats:
    """One-Shot protocol Phases 1+2 on a mesh (``launch.mesh.Mesh``).

    The rows of ``A`` and ``b`` are split evenly over the shards along
    ``client_axes`` (or come row-sharded, as ``ShardedTensor`` blocks); each
    such shard plays one client: it computes its local (G_k, h_k) (kernel
    K1 on the card) on its own device (:func:`client_stats`), and the
    single reduction, added in flat client order, is the one communication
    round (d^2 + d floats, Theorem 4's upload cost). The result lies on the
    first client's device.

    Args:
      client_axes: mesh axes the rows are sharded over; client k is flat
        (row-major) position k along them.
      participation: optional (K,) 0/1 weights by client index (Thm 8
        dropout): a dropped client's statistics are zeroed before the
        reduction, and the count becomes the float weighted row count.
      noise_fn: optional ``(client_index, G, h) -> (G~, h~)`` applied before
        aggregation (Algorithm 2's per-client noise, e.g.
        ``privacy.make_dp_noise_fn``); the privatized statistics drop yty.
    """
    from repro_torch.launch import mesh as mesh_lib

    local = client_stats(A, b, mesh, client_axes=client_axes,
                         participation=participation, noise_fn=noise_fn)
    dev = local[0].gram.device
    yty = (None if any(s.yty is None for s in local)
           else mesh_lib.psum([s.yty for s in local], dev))
    return SuffStats(gram=mesh_lib.psum([s.gram for s in local], dev),
                     moment=mesh_lib.psum([s.moment for s in local], dev),
                     count=mesh_lib.psum([s.count for s in local], dev),
                     yty=yty)
