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
    bf16-quantised) inputs and held whole in memory; kernel K3 holds one
    4096-row chunk of it at a time.
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


def panel_gemm_ref(L: torch.Tensor, X: torch.Tensor, c0: int, c1: int,
                   T: torch.Tensor) -> None:
    """Plain version of K2's panel entry: Z = [L[c1:, c0:c1] | X[:, c1:]^T]
    becomes Z @ T in place, computed as the reference calls K2,
    ``gemm_nt(0, Z, T^T, alpha=1)``."""
    bw = c1 - c0
    Z = torch.cat([L[c1:, c0:c1], X[:, c1:].T], dim=1)
    Zn = gemm_nt_ref(torch.zeros_like(Z), Z, T.T.contiguous(), alpha=1.0)
    L[c1:, c0:c1] = Zn[:, :bw]
    X[:, c1:] = Zn[:, bw:].T


SWA_BLOCK_Q = 256     # query rows per step: a (B, H, 256, S) float32 score block


def _block_probs(qb: torch.Tensor, kb: torch.Tensor, q0: int, k0: int,
                 window: int | None, causal: bool, scale: float) -> torch.Tensor:
    """The masked softmax of one query block qb (B, Hkv, G, bq, hd) over
    the keys kb (B, Hkv, nk, hd) at positions q0.. and k0..: float32
    (B, Hkv, G, bq, nk), dropped pairs scoring -1e30 before the softmax."""
    s = torch.einsum("bkgqd,bksd->bkgqs", qb, kb) * scale
    rel = (torch.arange(q0, q0 + qb.shape[3], device=qb.device)[:, None]
           - torch.arange(k0, k0 + kb.shape[2], device=qb.device)[None, :])
    ok = torch.ones_like(rel, dtype=torch.bool)
    if causal:
        ok &= rel >= 0
    if window is not None:
        ok &= rel < window
    s = torch.where(ok, s, -1e30)
    p = torch.exp(s - s.amax(-1, keepdim=True))
    return p / p.sum(-1, keepdim=True)


def swa_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      window: int | None, causal: bool = True,
                      block_q: int = SWA_BLOCK_Q) -> torch.Tensor:
    """Masked-softmax attention in float32: the plain version of K5.

    q: (B, S, H, hd); k, v: (B, S, H_kv, hd), query head h reading KV head
    h // (H / H_kv). A pair (q, k) is kept iff q - k >= 0 (causal) and
    q - k < window (when set); dropped pairs score -1e30, as in the
    reference. Queries go ``block_q`` at a time, so no (B, H, S, S) score
    tensor is built unless ``block_q >= S``. Returns (B, S, H, hd) in q's
    dtype.
    """
    B, S, H, hd = q.shape
    Hkv = k.shape[2]
    scale = hd ** -0.5
    qg = q.float().view(B, S, Hkv, H // Hkv, hd).permute(0, 2, 3, 1, 4)
    kf = k.float().permute(0, 2, 1, 3)                      # (B, Hkv, S, hd)
    vf = v.float().permute(0, 2, 1, 3)
    out = torch.empty_like(qg)                               # (B, Hkv, G, S, hd)
    for q0 in range(0, S, block_q):
        q1 = min(q0 + block_q, S)
        # every block reads all S keys (the backward reads only those kept)
        p = _block_probs(qg[:, :, :, q0:q1], kf, q0, 0, window, causal, scale)
        out[:, :, :, q0:q1] = torch.einsum("bkgqs,bksd->bkgqd", p, vf)
    return out.permute(0, 3, 1, 2, 4).reshape(B, S, H, hd).to(q.dtype)


def swa_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      do: torch.Tensor, *, window: int | None,
                      causal: bool = True, block_q: int = SWA_BLOCK_Q
                      ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) of :func:`swa_attention_ref`'s attention for the output
    gradient ``do`` (B, S, H, hd), in float32 inside and returned in the
    inputs' dtypes.

    The scores are recomputed ``block_q`` queries at a time, each block reading
    only the keys its mask can keep: [max(0, q0 - window + 1), q1) when
    causal, up to S when not. Per block, with P the masked softmax,
    dV += P^T dO, dP = dO V^T, dS = P . (dP - rowsum(dP . P)), dQ = dS K
    scale and dK += dS^T Q scale; a KV head's dK and dV sum over its
    group of query heads. The forward is K5 on the card; this backward is
    the port's own form of the autodiff the reference leaves to XLA, and
    runs on both devices.
    """
    B, S, H, hd = q.shape
    Hkv = k.shape[2]
    scale = hd ** -0.5
    qg = q.float().reshape(B, S, Hkv, H // Hkv, hd).permute(0, 2, 3, 1, 4)
    dog = do.float().reshape(B, S, Hkv, H // Hkv, hd).permute(0, 2, 3, 1, 4)
    kf = k.float().permute(0, 2, 1, 3)                      # (B, Hkv, S, hd)
    vf = v.float().permute(0, 2, 1, 3)
    dq = torch.empty_like(qg)                                # (B, Hkv, G, S, hd)
    dk = torch.zeros_like(kf)
    dv = torch.zeros_like(vf)
    for q0 in range(0, S, block_q):
        q1 = min(q0 + block_q, S)
        k0 = 0 if window is None else max(0, q0 - window + 1)
        k1 = q1 if causal else S
        qb, dob = qg[:, :, :, q0:q1], dog[:, :, :, q0:q1]
        kb, vb = kf[:, :, k0:k1], vf[:, :, k0:k1]
        p = _block_probs(qb, kb, q0, k0, window, causal, scale)
        dv[:, :, k0:k1] += torch.einsum("bkgqs,bkgqd->bksd", p, dob)
        dp = torch.einsum("bkgqd,bksd->bkgqs", dob, vb)
        ds = p * (dp - (dp * p).sum(-1, keepdim=True))
        del p, dp
        dq[:, :, :, q0:q1] = torch.einsum("bkgqs,bksd->bkgqd", ds, kb) * scale
        dk[:, :, k0:k1] += torch.einsum("bkgqs,bkgqd->bksd", ds, qb) * scale
        del ds
    return (dq.permute(0, 3, 1, 2, 4).reshape(B, S, H, hd).to(q.dtype),
            dk.permute(0, 2, 1, 3).to(k.dtype).contiguous(),
            dv.permute(0, 2, 1, 3).to(v.dtype).contiguous())
