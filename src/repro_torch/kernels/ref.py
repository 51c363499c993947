"""Plain PyTorch versions of the hand-written kernels.

Each function computes what its CUDA kernel computes, on any device. The
CPU path of the port runs these; on the card they are the oracle the kernels
are held against and nothing on the CUDA main path calls them. The plain
``panel_transform`` loop lives beside its dispatcher in
``server/cholesky.py``, as in the JAX package.
"""
from __future__ import annotations

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


def gemm_nt_ref(C: torch.Tensor, A: torch.Tensor, B: torch.Tensor, *,
                alpha: float = -1.0) -> torch.Tensor:
    """C + alpha * A @ B^T (C: (m, n), A: (m, k), B: (n, k))."""
    return C + alpha * (A @ B.T)
