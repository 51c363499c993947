"""Plain PyTorch versions of the hand-written kernels.

Each function computes what its CUDA kernel computes, on any device. The
CPU path of the port runs these; on the card they are the oracle the kernels
are held against and nothing on the CUDA main path calls them. The plain
``panel_transform`` loop lives beside its dispatcher in
``server/cholesky.py``, as in the JAX package.
"""
from __future__ import annotations

import math

import torch


def accumulation_dtype(dtype: torch.dtype) -> torch.dtype:
    """float32 for half-width inputs, else the input dtype (f32 / f64)."""
    return torch.float32 if dtype in (torch.bfloat16, torch.float16) else dtype


def gram_moment_ref(A: torch.Tensor, b: torch.Tensor
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """G = A^T A, h = A^T b, accumulated in :func:`accumulation_dtype`."""
    acc = accumulation_dtype(A.dtype)
    Aa = A.to(acc)
    return Aa.T @ Aa, Aa.T @ b.to(acc)


def sketch_gram_ref(A: torch.Tensor, b: torch.Tensor, R: torch.Tensor
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """Unfused §IV-F sketch: materialise T = A R, then (T^T T, T^T b).

    T is computed in :func:`accumulation_dtype` of A from the (possibly
    bf16-quantised) inputs; this is the device-memory round trip of T that
    kernel K3 avoids.
    """
    acc = accumulation_dtype(A.dtype)
    T = A.to(acc) @ R.to(acc)
    return gram_moment_ref(T, b.to(acc))


def rff_gram_ref(X: torch.Tensor, b: torch.Tensor, W: torch.Tensor,
                 c: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Unfused random Fourier features: T = sqrt(2/D) cos(X W + c), then Gram."""
    acc = accumulation_dtype(X.dtype)
    D = W.shape[1]
    T = math.sqrt(2.0 / D) * torch.cos(X.to(acc) @ W.to(acc) + c.to(acc))
    return gram_moment_ref(T, b.to(acc))


def gemm_nt_ref(C: torch.Tensor, A: torch.Tensor, B: torch.Tensor, *,
                alpha: float = -1.0) -> torch.Tensor:
    """C + alpha * A @ B^T (C: (m, n), A: (m, k), B: (n, k))."""
    return C + alpha * (A @ B.T)
