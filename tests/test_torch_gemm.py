"""A numpy model of K2's float32 general entry (``gemm_nt`` in
``csrc/gemm_nt.cu``, ``gemm_nt_tc_kernel``) and its tile rule
(``kernels/gram.py::gemm_tile``), against the reference's ``gemm_nt`` (JAX,
its Pallas kernel in interpret mode on the CPU) and the plain version.

The kernel runs only on the card (``tests/test_torch_cuda.py``,
``chip_smoke.py``). Here its arithmetic is modelled: one CTA per square
output tile at the edge the rule picks, operand rows past m and n and
columns past k loaded as zeros, k walked in 32-deep tiles, each tile summed
from zero as small*big + big*small + big*big of the TF32 splits (exact
products, rounded once to float32) and added to the float32 running sum,
then O = C + alpha * acc as one fused multiply-add. ``_product`` and
``_tf32`` are K3's model of the same 3xTF32 step (``test_torch_features``).
"""
import numpy as np
import pytest
import torch

from repro.kernels import ops as jax_ops
from repro_torch.kernels import gram, ops, ref
from test_torch_features import _product, _tf32

BK = 32                          # csrc/gemm_nt.cu TcGemm::BK
TILES = (128, 64)                # TcShape edges, widest first
SMS = 132                        # an H100 SXM's SMs (gram._FEATURE_SMS)
TOL = 1e-5                       # rel of max |ref|, as chip_smoke.py holds K2


def _cdiv(a, b):
    return -(-a // b)


def _tile_rule(m, n):
    """A copy of ``gemm_tile`` for float32: the edge whose busiest SM
    computes the least output, ceil(CTAs / 132) x edge^2, the wider on a
    tie."""
    def busiest(t):
        return _cdiv(_cdiv(m, t) * _cdiv(n, t), SMS) * t * t
    return min(TILES, key=busiest)


def _k2_model(C, A, B, alpha, tile):
    """O = C + alpha A B^T as ``gemm_nt_tc_kernel`` computes it at edge
    ``tile``. Unwritten elements stay NaN, so a CTA grid that misses one
    shows."""
    m, n = C.shape
    k = A.shape[1]
    kp = _cdiv(k, BK) * BK
    O = np.full((m, n), np.nan, np.float32)
    for i0 in range(0, _cdiv(m, tile) * tile, tile):
        for j0 in range(0, _cdiv(n, tile) * tile, tile):
            a = np.zeros((tile, kp), np.float32)        # loads past m, k: zeros
            b = np.zeros((tile, kp), np.float32)
            rows, cols = min(tile, m - i0), min(tile, n - j0)
            a[:rows, :k] = A[i0:i0 + rows]
            b[:cols, :k] = B[j0:j0 + cols]
            acc = (_product(a, b.T, "3xtf32", BK) if kp
                   else np.zeros((tile, tile), np.float32))
            # fmaf(alpha, acc, C): exact in float64 for alpha = +-1, one rounding
            o = (np.float64(alpha) * acc[:rows, :cols]
                 + C[i0:i0 + rows, j0:j0 + cols]).astype(np.float32)
            O[i0:i0 + rows, j0:j0 + cols] = o
    return O


def _inputs(m, n, k, c_zero, seed):
    rng = np.random.default_rng(seed)
    C = (np.zeros((m, n)) if c_zero else rng.standard_normal((m, n))).astype(np.float32)
    A = rng.standard_normal((m, k)).astype(np.float32)
    B = rng.standard_normal((n, k)).astype(np.float32)
    return C, A, B


def _close(x, want):
    return np.abs(x.astype(np.float64) - want).max() <= TOL * np.abs(want).max()


# The sharded backend's four sites (SYRK 1024 x 2048 x 256, TRSM 3840 x 256
# x 256, trailing update 1024 x 320 x 320, composition 320 x 96 x 96) and
# the dense path's (4064, 96, 96), scaled down by 8; each once as scaled and
# once ragged (m, n, k off the tile and k % 4 != 0); and the card test's
# (100, 37, 13).
SHAPES = [(128, 256, 32), (131, 250, 37), (480, 32, 32), (477, 33, 30),
          (128, 40, 40), (129, 41, 43), (40, 12, 12), (41, 13, 13),
          (508, 12, 12), (100, 37, 13)]


class TestModel:
    @pytest.mark.parametrize("m,n,k", SHAPES)
    @pytest.mark.parametrize("alpha", [-1.0, 1.0])
    def test_model_matches_reference_and_plain(self, m, n, k, alpha):
        """The model at the edge the rule picks, with C zero (the TRSM, the
        update, the composition) and C a Gram block (the SYRK), within 1e-5
        of max |ref| of the reference's Pallas ``gemm_nt`` and of the plain
        version, and within 1e-6 of float64."""
        for c_zero in (True, False):
            C, A, B = _inputs(m, n, k, c_zero, seed=m * n + k)
            got = _k2_model(C, A, B, alpha, _tile_rule(m, n))
            assert not np.isnan(got).any()
            want64 = C.astype(np.float64) + alpha * (A.astype(np.float64) @ B.T)
            jax_out = np.asarray(jax_ops.gemm_nt(C, A, B, alpha=alpha))
            plain = ref.gemm_nt_ref(*map(torch.from_numpy, (C, A, B)), alpha=alpha).numpy()
            assert _close(got, jax_out.astype(np.float64))
            assert _close(got, plain.astype(np.float64))
            assert np.abs(got - want64).max() <= 1e-6 * np.abs(want64).max()

    @pytest.mark.parametrize("m,n,k", [(64, 64, 256), (128, 96, 320), (96, 96, 96)])
    def test_three_passes_hold_float32_at_k2_depths(self, m, n, k):
        """At K2's real depths (96-320, 3-10 k-tiles) the 3xTF32 sum stays
        within 1e-6 of float64, one TF32 pass (big*big alone) does not hold
        the 1e-5 check, and float32 FMA is no closer than 3xTF32 by more
        than a few ulps."""
        C, A, B = _inputs(m, n, k, False, seed=k)
        want64 = C.astype(np.float64) - A.astype(np.float64) @ B.T
        scale = np.abs(want64).max()
        got = _k2_model(C, A, B, -1.0, _tile_rule(m, n))
        assert np.abs(got - want64).max() <= 1e-6 * scale
        one = C - (_tf32(A).astype(np.float64) @ _tf32(B).T)
        assert np.abs(one - want64).max() > TOL * scale
        f32 = (C - A @ B.T).astype(np.float32)
        assert np.abs(got - want64).max() <= 4 * max(np.abs(f32 - want64).max(),
                                                     np.finfo(np.float32).eps * scale)

    @pytest.mark.parametrize("m,n,k", [(131, 250, 37), (41, 13, 13), (100, 37, 0)])
    def test_model_at_either_edge(self, m, n, k):
        """Both edges cover every output element once and agree within the
        check (the kernel's bits do not depend on the edge; that is a card
        test); k = 0 gives C."""
        C, A, B = _inputs(m, n, k, False, seed=7)
        o64, o128 = (_k2_model(C, A, B, 1.0, t) for t in (64, 128))
        assert not np.isnan(o64).any() and not np.isnan(o128).any()
        want = C.astype(np.float64) + A.astype(np.float64) @ B.T
        assert _close(o64, want) and _close(o128, want)
        if k == 0:
            assert np.array_equal(o64, C) and np.array_equal(o128, C)


class TestTileRule:
    # (m, n) -> (edge, CTAs, waves on 132 SMs)
    @pytest.mark.parametrize("m,n,tile,ctas,waves", [
        (1024, 2048, 128, 128, 1),      # the SYRK: 512 CTAs of 64 tie, 4 waves
        (3840, 256, 64, 240, 2),        # the TRSM at its first panel
        (256, 256, 64, 16, 1),          # the TRSM at its last
        (1024, 320, 64, 80, 1),         # the trailing update
        (320, 96, 64, 10, 1),           # the tile's composition
        (4064, 96, 64, 128, 1),         # the dense path's panel product
        (100, 37, 64, 2, 1),
        (4096, 4096, 128, 1024, 8),     # tie again: the wider edge
        (1024, 1024, 64, 256, 2),
        (1, 1, 64, 1, 1)])
    def test_rule_at_the_paths_shapes(self, m, n, tile, ctas, waves):
        assert gram.gemm_tile(m, n, torch.float32) == _tile_rule(m, n) == tile
        assert _cdiv(m, tile) * _cdiv(n, tile) == ctas
        assert _cdiv(ctas, SMS) == waves

    def test_rule_everywhere(self):
        """``gemm_tile`` and the copy agree on a grid of shapes, and
        the edge picked never leaves the busiest SM more output than the
        other edge would."""
        for m in range(1, 5000, 97):
            for n in (1, 13, 96, 256, 320, 2048, 4096):
                t = gram.gemm_tile(m, n, torch.float32)
                assert t == _tile_rule(m, n)
                busy = {e: _cdiv(_cdiv(m, e) * _cdiv(n, e), SMS) * e * e for e in TILES}
                assert busy[t] == min(busy.values())

    def test_float64_takes_the_cuda_core_loop(self):
        assert gram.gemm_tile(1024, 2048, torch.float64) == 0
        assert gram.gemm_tile(3, 5, torch.float64) == 0


class TestDispatch:
    def test_cpu_tensors_take_the_plain_version(self):
        """On the CPU the dispatcher gives the plain version's bits, and the
        kernel's wrapper refuses CPU tensors."""
        C, A, B = map(torch.from_numpy, _inputs(65, 33, 13, False, seed=3))
        assert torch.equal(ops.gemm_nt(C, A, B, alpha=-1.0),
                           ref.gemm_nt_ref(C, A, B, alpha=-1.0))
        with pytest.raises(ValueError, match="CUDA"):
            gram.gemm_nt_cuda(C, A, B, alpha=-1.0)
