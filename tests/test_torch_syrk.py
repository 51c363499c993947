"""Numpy models of the tensor-core SYRK's schedules (``csrc/tc_syrk.cuh``):
float32 / bfloat16 / float16 K1 (T = A read in place) and the chunk route
of K4 (T = sqrt(2/D) cos(XW + c) through a 4096-row workspace), against the
plain versions.

The kernels run only on the card (``tests/test_torch_cuda.py``,
``chip_smoke.py``). Here their schedules are modelled: one "CTA" per upper
tile (I, J) of G at the tile edge the wrapper picks (``gram.syrk_tile``),
rows walked in the kernel's k-tiles (32 rows at the 128-wide tile, 16-row
slices dealt to 4 groups at the 32-wide tile), loads past the row and
column limits as zeros, diagonal tiles writing r <= c and every tile its
mirror, h in FMA chains from the diagonal tiles, K4's chunks added in
order with the cosine epilogue, the zeroed padding columns and rows of the
workspace that no chunk wrote left as NaN (a read of them would show). In
float64 a model is the schedule alone and must equal the plain version; in
float32 it adds the 3xTF32 arithmetic of K3's model (``_product``).
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import gram, ref
from test_torch_features import _product, _tf32

# csrc/tc_syrk.cuh SyrkShape: tile edge -> (groups, rows per group per k-tile)
SYRK_SHAPES = {32: (4, 16), 128: (1, 32)}
FEATURIZE_DEPTH = 32                      # csrc/feature_gram.cu kFeatBK


def _syrk_model(T, b, m, tile, arith, col_lim, G=None, h=None):
    """G (+)= T^T T and h (+)= T^T b over the rows of T as ``syrk_kernel``
    schedules them (G, h None: the first call writes, else it adds)."""
    groups, gk = SYRK_SHAPES[tile]
    dt = np.float64 if arith == "f64" else np.float32
    rows = T.shape[0]
    tiles = -(-m // tile)
    Tp = np.zeros((rows, tiles * tile), dt)       # loads past col_lim: zeros
    Tp[:, :col_lim] = T[:, :col_lim]
    bt = b.astype(dt)
    first = G is None
    if first:
        G, h = np.full((m, m), np.nan, dt), np.full(m, np.nan, dt)
    for ti in range(tiles):
        for tj in range(ti, tiles):
            I, J = ti * tile + np.arange(tile), tj * tile + np.arange(tile)
            acc = _product(Tp[:, I].T, Tp[:, J], arith, gk, groups).astype(dt)
            rr, cc = np.meshgrid(I, J, indexing="ij")
            keep = (rr < m) & (cc < m) & ((ti < tj) | (rr <= cc))
            val = (acc[keep] + (0 if first else G[rr[keep], cc[keep]])).astype(dt)
            G[rr[keep], cc[keep]] = val
            G[cc[keep], rr[keep]] = val
            if ti == tj:
                hacc = np.zeros((groups, tile), dt)
                for r in range(rows):          # one FMA chain per group and column
                    q = r // gk % groups
                    hacc[q] = (hacc[q].astype(np.float64)
                               + Tp[r, I].astype(np.float64) * bt[r]).astype(dt)
                hsum = hacc[0]
                for q in range(1, groups):
                    hsum = (hsum + hacc[q]).astype(dt)
                ok = I < m
                h[I[ok]] = (hsum[ok] + (0 if first else h[I[ok]])).astype(dt)
    return G, h


def _k1_model(A, b, tile, arith="f64"):
    """K1 on the SYRK: T = A in place (col_lim = d), one call."""
    d = A.shape[1]
    return _syrk_model(A, b, d, tile, arith, col_lim=d)


def _k4_chunk_model(X, b, W, c, tile, arith="f64", chunk_rows=None):
    """K4's chunk route: per chunk, in order, the featurize GEMM (32-deep
    k-tiles) with the epilogue sqrt(2/D) cos(P + c) into a workspace whose
    rows are padded to ldT with zeros, then the SYRK over the chunk's rows
    (col_lim = ldT), the first chunk writing and later ones adding."""
    n, _ = X.shape
    m = W.shape[1]
    chunks, rows_per = gram.sketch_chunks(n)
    if chunk_rows is not None:
        chunks, rows_per = max(1, -(-n // chunk_rows)), chunk_rows
    assert chunks * rows_per >= n and (n == 0 or (chunks - 1) * rows_per < n)
    dt = np.float64 if arith == "f64" else np.float32
    ldT = -(-m // 4) * 4
    scale = dt(np.sqrt(2.0 / m))
    work = np.full((max(1, min(n, rows_per)), ldT), np.nan, dt)   # torch.empty
    G = h = None
    for ch in range(chunks):
        r0 = ch * rows_per
        rows = max(0, min(rows_per, n - r0))
        P = _product(X[r0:r0 + rows], W, arith, FEATURIZE_DEPTH).astype(dt)
        work[:rows, :m] = (scale * np.cos(P + c.astype(dt))).astype(dt)
        work[:rows, m:] = 0                    # padding columns written as zeros
        G, h = _syrk_model(work[:rows], b[r0:r0 + rows], m, tile, arith, ldT, G, h)
    return G, h


def _rel_fro(x, ref64):
    return np.linalg.norm(x - ref64) / max(np.linalg.norm(ref64), 1e-30)


class TestSyrkSchedules:
    @pytest.mark.parametrize("n,d,tile", [
        (0, 5, 32), (0, 7, 128), (1, 3, 128), (1, 40, 32), (31, 129, 128),
        (300, 130, 32), (300, 257, 128), (517, 100, 32), (4097, 33, 128),
        (4100, 70, 32)])
    def test_k1_model_matches_plain_and_float64(self, n, d, tile):
        """Ragged d (not a multiple of 4 or of the tile), d below one tile,
        n = 0 and 1, and a row count that is not a multiple of the k-tile:
        the schedule in float64 equals the plain version and is exactly
        symmetric; in 3xTF32 float32 it stays within 1e-5 (Frobenius) of
        float64."""
        rng = np.random.default_rng(n + d + tile)
        A = rng.standard_normal((n, d)).astype(np.float32)
        b = rng.standard_normal(n).astype(np.float32)
        G64, h64 = ref.gram_moment_ref(*(torch.from_numpy(a).double() for a in (A, b)))
        G, h = _k1_model(A.astype(np.float64), b.astype(np.float64), tile)
        np.testing.assert_allclose(G, G64.numpy(), rtol=1e-10, atol=1e-10)
        np.testing.assert_allclose(h, h64.numpy(), rtol=1e-10, atol=1e-10)
        assert np.array_equal(G, G.T)
        G32, h32 = _k1_model(A, b, tile, arith="3xtf32")
        assert G32.dtype == h32.dtype == np.float32 and np.array_equal(G32, G32.T)
        assert _rel_fro(G32, G64.numpy()) <= 1e-5
        assert _rel_fro(h32, h64.numpy()) <= 1e-5

    @pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
    def test_k1_half_inputs_are_exact_in_tf32(self, dtype):
        """bf16 and f16 values are converted on load and are exact in TF32,
        so their small parts are zero and one product is the whole 3xTF32
        product: the model in float32 matches float64 of the same values."""
        rng = np.random.default_rng(7)
        A = torch.from_numpy(rng.standard_normal((200, 48))).to(dtype).float().numpy()
        b = torch.from_numpy(rng.standard_normal(200)).to(dtype).float().numpy()
        assert np.array_equal(_tf32(A), A) and np.array_equal(_tf32(b), b)
        G32, h32 = _k1_model(A, b, 32, arith="3xtf32")
        G64, h64 = ref.gram_moment_ref(torch.from_numpy(A).double(),
                                       torch.from_numpy(b).double())
        assert _rel_fro(G32, G64.numpy()) <= 1e-6 and _rel_fro(h32, h64.numpy()) <= 1e-6

    @pytest.mark.parametrize("n,d,D,tile,chunk_rows", [
        (300, 7, 130, 32, 64), (129, 16, 99, 128, 64), (500, 9, 65, 128, 100),
        (0, 5, 6, 32, None), (1, 3, 1, 32, None), (1, 4, 6, 128, None),
        (4100, 8, 70, 32, None), (4095, 4, 257, 128, None), (200, 12, 258, 32, 50)])
    def test_k4_chunk_model_matches_plain_and_float64(self, n, d, D, tile, chunk_rows):
        """D not a multiple of 4 or of 128, a ragged last chunk (4 rows at the
        real 4096), one and many chunks, n = 0 and 1: in float64 the chunk
        route equals the plain version; in 3xTF32 float32 it is within 1e-5
        of float64. Workspace rows past a chunk stay NaN, so a SYRK that
        read them, or cos(0 + c) rows that were not masked, would show."""
        rng = np.random.default_rng(n + d + D)
        X = rng.standard_normal((n, d)).astype(np.float32)
        b = rng.standard_normal(n).astype(np.float32)
        W = (rng.standard_normal((d, D)) / np.sqrt(d)).astype(np.float32)
        c = rng.uniform(0, 2 * np.pi, D).astype(np.float32)
        G64, h64 = ref.rff_gram_ref(*(torch.from_numpy(a).double() for a in (X, b, W, c)))
        G, h = _k4_chunk_model(*(a.astype(np.float64) for a in (X, b, W, c)), tile,
                               chunk_rows=chunk_rows)
        np.testing.assert_allclose(G, G64.numpy(), rtol=1e-10, atol=1e-10)
        np.testing.assert_allclose(h, h64.numpy(), rtol=1e-10, atol=1e-10)
        assert np.array_equal(G, G.T)
        G32, h32 = _k4_chunk_model(X, b, W, c, tile, arith="3xtf32", chunk_rows=chunk_rows)
        assert G32.dtype == np.float32 and np.array_equal(G32, G32.T)
        assert _rel_fro(G32, G64.numpy()) <= 1e-5
        assert _rel_fro(h32, h64.numpy()) <= 1e-5

    def test_k4_unmasked_rows_would_show(self):
        """Why the masks matter: a chunk whose rows past n were featurized
        from zero-filled X (cos(0 + c) != 0) adds cos(c)^T cos(c) per row."""
        rng = np.random.default_rng(3)
        n, d, D = 61, 5, 24
        X, b = rng.standard_normal((n, d)), rng.standard_normal(n)
        W, c = rng.standard_normal((d, D)), rng.uniform(0, 2 * np.pi, D)
        Xpad, bpad = np.vstack([X, np.zeros((3, d))]), np.r_[b, np.zeros(3)]
        G, _ = _k4_chunk_model(Xpad, bpad, W, c, 32, chunk_rows=64)
        G64, _ = ref.rff_gram_ref(*(torch.from_numpy(a) for a in (X, b, W, c)))
        assert np.abs(G - G64.numpy()).max() > 0.1

    @pytest.mark.parametrize("m,tile", [
        (1, 32), (100, 32), (1024, 32), (2048, 32), (2560, 128), (3072, 128),
        (4096, 128), (5000, 128), (8192, 128)])
    def test_tile_rule(self, m, tile):
        """128-wide where the upper triangle of 128-tiles keeps its waves of
        132 SMs at least 3/4 busy (m 4096: 528 CTAs, 4 whole waves), else
        32-wide (K3 at m 1024: 36 wide CTAs, so 528 narrow ones)."""
        assert gram.syrk_tile(m) == tile
        t = -(-m // 128)
        ctas = t * (t + 1) // 2
        if tile == 128:
            assert ctas >= 0.75 * -(-ctas // 132) * 132

    @pytest.mark.parametrize("n,d,dtype,route", [
        (16384, 4096, torch.float32, 128), (4, 4096, torch.bfloat16, 128),
        (500, 100, torch.float16, 32), (16384, 1024, torch.float32, 32),
        (16384, 4096, torch.float64, 0), (2048, 300, torch.float64, 0),
        (1, 4096, torch.float32, 0), (1, 1024, torch.float16, 0), (2, 1024, torch.float32, 32),
        (0, 64, torch.float32, 0)])
    def test_k1_route(self, n, d, dtype, route):
        """float64 K1 and a single row keep the CUDA-core kernel (route 0);
        the others take the SYRK at the tile edge of the rule."""
        assert gram.gram_tile(n, d, dtype) == route
