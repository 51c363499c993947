"""Incremental Cholesky machinery for the fusion server.

The server's regularized Gram ``G + sigma I`` changes only by PSD low-rank
deltas: streaming rows arrive (§VI-C, rank = #rows), a client drops out or
rejoins (Thm 8, rank = rank(G_k)). A cached factor L with L L^T = G + sigma I
is maintained by rank-r up/downdates at O(r d^2) instead of an O(d^3/3)
refactorization.

Two implementations of the same algebra:

  * ``chol_rank1`` / ``chol_update`` — the classic LINPACK recurrence, one
    rank-1 sweep per update vector: d sequential column steps per vector,
    run eagerly (a dozen small launches per step on the card). The pinned
    numerical reference, and the engine's path below rank 8.
  * ``chol_update_blocked`` — the production mutation path. L is processed
    in (bw x bw) diagonal panels; ``panel_transform`` runs the scalar
    recurrence of one panel against all r update vectors at once and
    returns the (bw+r) x (bw+r) right-transformation T, and the trailing
    rows absorb the whole panel in one product ``[L21 | X2^T] @ T``. On CUDA
    tensors each panel is two launches on the update's own copies of L and
    X, kernel P then kernel K2's panel entry, both in place
    (``kernels.gram.blocked_update_cuda``); on CPU tensors the plain loop
    below (``panel_transform_ref``, then ``kernels.ref.panel_gemm_ref``).

Both perform identical elementary operations, so the blocked path is the
reference up to float associativity in the GEMM.

Unlike JAX arrays, tensors are mutable: every function here returns a new
factor and leaves its inputs untouched, so an ``(L, h)`` snapshot held by a
caller is never written through.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import gram as gram_kernel
from repro_torch.kernels import ops as kernel_ops
from repro_torch.kernels import ref


def chol_rank1(L: torch.Tensor, x: torch.Tensor, *,
               sign: float = 1.0) -> torch.Tensor:
    """Factor of ``L L^T + sign * x x^T`` from the lower factor L. O(d^2).

    ``sign=+1`` is an update, ``sign=-1`` a downdate (valid while the result
    stays positive definite, which the sigma I floor guarantees here).
    """
    L = L.clone()
    x = x.to(L.dtype).clone()
    tiny = torch.finfo(L.dtype).tiny
    for k in range(L.shape[0]):
        Lkk = L[k, k]
        xk = x[k]
        r = torch.sqrt(torch.clamp(Lkk * Lkk + sign * xk * xk, min=tiny))
        c = r / Lkk
        s = xk / Lkk
        new_col = (L[k + 1:, k] + sign * s * x[k + 1:]) / c
        x[k + 1:] = c * x[k + 1:] - s * new_col
        L[k + 1:, k] = new_col
        L[k, k] = r
    return L


def chol_update(L: torch.Tensor, U: torch.Tensor, *,
                sign: float = 1.0) -> torch.Tensor:
    """Factor of ``L L^T + sign * U^T U`` for U of shape (r, d). O(r d^2)."""
    for u in U:
        L = chol_rank1(L, u, sign=sign)
    return L


def panel_transform_ref(L11: torch.Tensor, X1: torch.Tensor, *,
                        sign: float = 1.0
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of kernel P: the reference's nested scalar loop."""
    bw = L11.shape[0]
    r = X1.shape[0]
    s = sign
    L11 = L11.clone()
    X1 = X1.clone()
    T = torch.eye(bw + r, dtype=L11.dtype, device=L11.device)
    tiny = torch.finfo(L11.dtype).tiny
    for k in range(bw):
        for j in range(r):
            Lkk = L11[k, k]
            xk = X1[j, k]
            rho = torch.sqrt(torch.clamp(Lkk * Lkk + s * xk * xk, min=tiny))
            c = rho / Lkk
            st = xk / Lkk
            col = L11[k + 1:, k].clone()
            xrow = X1[j, k + 1:]
            L11[k + 1:, k] = (col + s * st * xrow) / c
            L11[k, k] = rho
            X1[j, k + 1:] = (-st * col + xrow) / c
            tk = T[:, k].clone()
            tj = T[:, bw + j].clone()
            T[:, k] = (tk + s * st * tj) / c
            T[:, bw + j] = (-st * tk + tj) / c
    return L11, T


def panel_transform(L11: torch.Tensor, X1: torch.Tensor, *,
                    sign: float = 1.0) -> tuple[torch.Tensor, torch.Tensor]:
    """Factor one diagonal panel against all r update vectors at once.

    Args:
      L11: (bw, bw) lower-triangular diagonal panel of L.
      X1:  (r, bw) the panel's column slice of the update vectors.
      sign: +1 update / -1 downdate.

    Returns ``(L11', T)``: the updated panel factor and the accumulated
    (bw+r, bw+r) right-transformation with ``[L21 | X2^T] @ T =
    [L21' | X2'^T]`` for every trailing row. Kernel P for CUDA tensors, the
    plain loop for CPU tensors.
    """
    if kernel_ops.on_card(L11.device, "panel_transform"):
        return gram_kernel.panel_transform_cuda(
            L11.contiguous(), X1.contiguous(), sign=sign)
    return panel_transform_ref(L11, X1, sign=sign)


def chol_update_blocked(L: torch.Tensor, U: torch.Tensor, *,
                        sign: float = 1.0,
                        block_size: int = 32) -> torch.Tensor:
    """Blocked factor of ``L L^T + sign * U^T U`` for U of shape (r, d).

    The trailing-panel product carries the O(r d^2) bulk (kernel K2 on
    CUDA). ``chol_update`` is the pinned scan-of-rank-1 reference. L and U
    are copied once into row-major working tensors, which the panels update
    in place.
    """
    d = L.shape[0]
    if U.shape[0] == 0:
        return L
    L = L.clone(memory_format=torch.contiguous_format)
    X = U.to(L.dtype).clone(memory_format=torch.contiguous_format)
    if kernel_ops.on_card(L.device, "chol_update_blocked"):
        gram_kernel.blocked_update_cuda(L, X, sign=sign, block_size=block_size)
        return L
    for c0 in range(0, d, block_size):
        c1 = min(c0 + block_size, d)
        L11, T = panel_transform_ref(L[c0:c1, c0:c1], X[:, c0:c1], sign=sign)
        L[c0:c1, c0:c1] = L11
        if c1 < d:
            ref.panel_gemm_ref(L, X, c0, c1, T)
    return L


def psd_update_vectors(G: torch.Tensor, *, tol: float = 1e-7) -> torch.Tensor:
    """Rows U (r, d) with ``U^T U ~= G`` for PSD G, r = numerical rank.

    One eigendecomposition turns an arbitrary PSD delta (e.g. a departing
    client's Gram) into explicit update vectors. The rank is decided on the
    host, with the reference's cutoff ``tol * max(lambda_max, 1)``.
    """
    evals, evecs = torch.linalg.eigh(G)
    host = evals.cpu()
    cutoff = tol * max(float(host[-1]), 1.0)
    r = int((host > cutoff).sum())
    if r == 0:
        return torch.zeros((0, G.shape[0]), dtype=G.dtype, device=G.device)
    vecs = evecs[:, -r:]
    vals = torch.clamp(evals[-r:], min=0.0)
    return (vecs * torch.sqrt(vals)).T
