"""Public kernel entry points: dispatch by device, plus the Theorem-4 codec.

``gram_moment``, ``gemm_nt``, ``sketch_gram``, ``rff_gram`` and
``swa_attention`` run the hand-written CUDA kernel for CUDA tensors and the
plain PyTorch version (``kernels.ref``) for CPU tensors; any other device
raises, but ``meta``, whose tensors carry shapes and no data: it takes the
plain version, which there computes nothing (the dry-run's shape-only
programs, ``launch/dryrun.py``). There is no switch between the two: the
tensor's device decides, and a failing kernel raises rather than falling
back. ``swa_attention`` also carries a gradient where autograd records
(its backward is ``ref.swa_attention_bwd``).

``synchronize`` is the one device fence the host-timed loops use.

``pack_lower``/``unpack_lower`` (the Theorem-4 triangular wire codec for
client Gram uploads) are a static-index gather/scatter, not kernels.
"""
from __future__ import annotations

import math

import torch
from torch.profiler import record_function

from repro_torch.kernels import gram as gram_kernel
from repro_torch.kernels import ref


def pow2_bucket(n: int, *, floor: int = 1) -> int:
    """Smallest power of two >= max(n, floor).

    The blocked factor update pads its rank to this bucket with zero rows
    (exact identities of the recurrence), as the reference does.
    """
    return max(floor, 1 << (max(int(n), 1) - 1).bit_length())


def on_card(device: torch.device, name: str) -> bool:
    """True for CUDA (kernel), False for CPU (plain version) and for meta
    (the plain version on shapes alone); else raise.

    The port's one device rule: every dispatcher asks it, none looks at the
    device itself."""
    if device.type == "cuda":
        return True
    if device.type in ("cpu", "meta"):
        return False
    raise ValueError(f"{name}: no kernel or plain path for device {device}")


def gram_moment(A: torch.Tensor, b: torch.Tensor
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """Fused (G, h) = (A^T A, A^T b): kernel K1 on CUDA, plain on CPU.

    Accumulates in float32 for bf16/f16 input, else in the input dtype.
    """
    if on_card(A.device, "gram_moment"):
        return gram_kernel.gram_moment_cuda(A, b)
    return ref.gram_moment_ref(A, b)


def sketch_gram(A: torch.Tensor, b: torch.Tensor, R: torch.Tensor
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """Fused §IV-F sketch ingest ((AR)^T AR, (AR)^T b): K3 on CUDA, plain on CPU.

    No padding: the kernel masks ragged n, d and m itself.
    """
    if on_card(A.device, "sketch_gram"):
        return gram_kernel.sketch_gram_cuda(A, b, R)
    return ref.sketch_gram_ref(A, b, R)


def rff_gram(X: torch.Tensor, b: torch.Tensor, W: torch.Tensor,
             c: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Fused RFF ingest, T = sqrt(2/D) cos(XW + c) and (T^T T, T^T b):
    K4 on CUDA, plain on CPU. The scale uses D = W.shape[1]."""
    if on_card(X.device, "rff_gram"):
        return gram_kernel.rff_gram_cuda(X, b, W, c)
    return ref.rff_gram_ref(X, b, W, c)


class _SWAAttention(torch.autograd.Function):
    """:func:`swa_attention` with a gradient: the forward is K5 on CUDA
    tensors (the plain version on CPU ones), the backward
    ``ref.swa_attention_bwd`` on both, inside an ``attn.bwd``
    ``record_function`` range. The reference has no kernel here: its
    attention is XLA's, and JAX differentiates it; the backward is the
    port's own form of that autodiff work, not a plain version standing in
    for a kernel. Only q, k and v are saved; the scores are recomputed."""

    @staticmethod
    def forward(ctx, q, k, v, window, causal, block_q):
        ctx.save_for_backward(q, k, v)
        ctx.window, ctx.causal, ctx.block_q = window, causal, block_q
        return _swa_forward(q, k, v, window, causal, block_q)

    @staticmethod
    def backward(ctx, do):
        q, k, v = ctx.saved_tensors
        with record_function("attn.bwd"):
            dq, dk, dv = ref.swa_attention_bwd(q, k, v, do, window=ctx.window,
                                               causal=ctx.causal, block_q=ctx.block_q)
        return dq, dk, dv, None, None, None


def _swa_forward(q, k, v, window, causal, block_q):
    if on_card(q.device, "swa_attention"):
        return gram_kernel.swa_flash_cuda(q, k, v, window=window, causal=causal)
    return ref.swa_attention_ref(q, k, v, window=window, causal=causal, block_q=block_q)


def swa_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  window: int | None, causal: bool = True,
                  block_q: int | None = None) -> torch.Tensor:
    """Sliding-window (or full, ``window=None``) attention over a sequence:
    K5 on CUDA, plain on CPU.

    q: (B, S, H, hd); k, v: (B, S, H_kv, hd) with H % H_kv == 0, query head
    h reading KV head h // (H / H_kv). No padding: the kernel masks a ragged
    S itself, so a non-causal ragged S is exact too. The call carries a
    gradient (:class:`_SWAAttention`) where autograd records (grad mode on
    and an input that requires grad); otherwise the output has no
    ``grad_fn`` and nothing saved outlives the call. ``block_q`` is the
    query rows a step of the plain version and of the backward
    (``ref.SWA_BLOCK_Q`` when None); K5 tiles by itself.
    """
    if window is not None and window < 1:
        raise ValueError(f"swa_attention: window must be None or >= 1, got {window}")
    return _SWAAttention.apply(q, k, v, window, causal, block_q or ref.SWA_BLOCK_Q)


def synchronize(t: torch.Tensor) -> None:
    """Wait until the work queued on ``t``'s device is done, so that a host
    clock times it (CPU work is already done when it returns)."""
    if on_card(t.device, "synchronize"):
        torch.cuda.synchronize(t.device)


def gemm_nt(C: torch.Tensor, A: torch.Tensor, B: torch.Tensor, *,
            alpha: float = -1.0) -> torch.Tensor:
    """C + alpha * A @ B^T: kernel K2 on CUDA, plain on CPU."""
    if on_card(C.device, "gemm_nt"):
        return gram_kernel.gemm_nt_cuda(C, A, B, alpha=alpha)
    return ref.gemm_nt_ref(C, A, B, alpha=alpha)


_TRIL_IDX: dict[tuple[int, torch.device], torch.Tensor] = {}


def _tril(d: int, device: torch.device) -> torch.Tensor:
    """Static (2, d(d+1)/2) row-major lower-triangle indices (cached)."""
    key = (d, torch.device(device))
    idx = _TRIL_IDX.get(key)
    if idx is None:
        idx = torch.tril_indices(d, d, device=device)
        _TRIL_IDX[key] = idx
    return idx


def tri_len(d: int) -> int:
    """Packed lower-triangle length for dimension d: d(d+1)/2 (Thm 4)."""
    return d * (d + 1) // 2


def tri_dim(length: int) -> int:
    """Inverse of :func:`tri_len`; ValueError if no d satisfies d(d+1)/2 = L."""
    d = (math.isqrt(8 * length + 1) - 1) // 2
    if tri_len(d) != length:
        raise ValueError(f"{length} is not a triangular length d(d+1)/2")
    return d


def pack_lower(G: torch.Tensor) -> torch.Tensor:
    """(..., d, d) symmetric -> (..., d(d+1)/2) row-major lower triangle."""
    i, j = _tril(G.shape[-1], G.device)
    return G[..., i, j]


def unpack_lower(tri: torch.Tensor, d: int) -> torch.Tensor:
    """(..., d(d+1)/2) packed lower triangle -> full symmetric (..., d, d).

    Exact roundtrip with :func:`pack_lower` for symmetric input: scatter the
    triangle, then add the mirrored strict lower part (zeros elsewhere), as
    the reference codec does.
    """
    if tri.shape[-1] != tri_len(d):
        raise ValueError(f"packed length {tri.shape[-1]} != d(d+1)/2 "
                         f"for d={d}")
    i, j = _tril(d, tri.device)
    low = torch.zeros((*tri.shape[:-1], d, d), dtype=tri.dtype,
                      device=tri.device)
    low[..., i, j] = tri
    return low + torch.tril(low, -1).transpose(-1, -2)
