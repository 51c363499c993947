"""Port parity for the §IV-F feature tenants: K3/K4's plain versions, the
feature-map identity, the projected protocol and a feature tenant served
from the fusion engine.

The same numpy inputs go through the JAX reference (its Pallas kernels in
interpret mode, as tests/test_sketch_kernels.py runs them) and through the
port's CPU path. Feature-map arrays are carried over from the reference
with ``convert.feature_map_from``, so both sides featurize with the same
bytes. Numpy models of the CUDA kernels' schedules are held against the
plain version: K4's and float64 K3's tile routine (tile ownership, row
splits, masks, split reduction) and float32 K3's chunk route (the chunk
walk, the featurize product once per row, upper-tile ownership with
mirrored writes, chunk-order sums, and its 3xTF32 arithmetic); the kernels
themselves run on the card (``tests/test_torch_cuda.py``,
``chip_smoke.py``).
"""
import dataclasses

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro import core as jcore
from repro import fed as jfed
from repro.data import synthetic as jsyn
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch import core as tcore
from repro_torch import fed as tfed
from repro_torch.convert import (dataset_from_numpy, feature_map_from, key_from,
                                 tensor_from_numpy)
from repro_torch.core import features as tfeatures
from repro_torch.core import threefry
from repro_torch.kernels import gram, ops, ref
from repro_torch.server import CoalescerPolicy, FusionEngine, reference_inference

SKETCH_GRID = [(256, 128, 128), (512, 256, 16), (1000, 100, 12), (64, 16, 8),
               (128, 384, 48)]
RFF_GRID = [(256, 128, 128), (512, 64, 256), (1000, 100, 12), (64, 16, 8),
            (96, 48, 160)]
DTYPES = {"float32": (np.float32, jnp.float32),
          "bfloat16": (ml_dtypes.bfloat16, jnp.bfloat16)}


def _assert_close(G, h, Gr, hr):
    """tests/test_sketch_kernels.py's tolerance: f32 reduction order."""
    G, h, Gr, hr = (np.asarray(x, np.float64) for x in (G, h, Gr, hr))
    scale = max(1.0, float(np.abs(Gr).max()))
    np.testing.assert_allclose(G, Gr, rtol=2e-3, atol=2e-4 * scale)
    np.testing.assert_allclose(h, hr, rtol=2e-3, atol=2e-4 * scale)


def _np(t):
    return t.detach().cpu().double().numpy()


def _sketch_inputs(n, d, m, dtype, seed):
    rng = np.random.default_rng(seed)
    npd, _ = DTYPES[dtype]
    A = rng.standard_normal((n, d)).astype(np.float32).astype(npd)
    b = rng.standard_normal(n).astype(np.float32).astype(npd)
    R = (rng.standard_normal((d, m)) / np.sqrt(m)).astype(np.float32).astype(npd)
    return A, b, R


def _rff_inputs(n, d, D, dtype, seed):
    rng = np.random.default_rng(seed)
    npd, _ = DTYPES[dtype]
    X = rng.standard_normal((n, d)).astype(np.float32).astype(npd)
    b = rng.standard_normal(n).astype(np.float32).astype(npd)
    W = rng.standard_normal((d, D)).astype(np.float32).astype(npd)
    c = rng.uniform(0.0, 2 * np.pi, D).astype(np.float32).astype(npd)
    return X, b, W, c


def _t(*arrays):
    return [tensor_from_numpy(a, device="cpu") for a in arrays]


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


class TestPlainKernels:
    @pytest.mark.parametrize("n,d,m", SKETCH_GRID)
    @pytest.mark.parametrize("dtype", list(DTYPES))
    def test_sketch_gram_vs_jax(self, n, d, m, dtype):
        arrs = _sketch_inputs(n, d, m, dtype, seed=n + d + m)
        G, h = ops.sketch_gram(*_t(*arrs))
        assert G.shape == (m, m) and h.shape == (m,)
        assert G.dtype == h.dtype == torch.float32
        _assert_close(G, h, *jops.sketch_gram(*_j(*arrs)))
        _assert_close(G, h, *jref.sketch_gram_ref(*_j(*arrs)))

    @pytest.mark.parametrize("n,d,D", RFF_GRID)
    @pytest.mark.parametrize("dtype", list(DTYPES))
    def test_rff_gram_vs_jax(self, n, d, D, dtype):
        arrs = _rff_inputs(n, d, D, dtype, seed=n + d + D)
        G, h = ops.rff_gram(*_t(*arrs))
        assert G.shape == (D, D) and h.shape == (D,)
        assert G.dtype == h.dtype == torch.float32
        _assert_close(G, h, *jops.rff_gram(*_j(*arrs)))
        _assert_close(G, h, *jref.rff_gram_ref(*_j(*arrs)))

    def test_rff_row_mask_poison(self):
        """n one short of the reference's block: a padded row would add
        cos(c)^T cos(c), O(D), so agreement shows both sides mask it."""
        X, b, W, c = _rff_inputs(31, 32, 32, "float32", seed=19)
        G, _ = ops.rff_gram(*_t(X, b, W, c))
        Gj, _ = jops.rff_gram(*_j(X, b, W, c), block_d=32, block_n=32)
        assert float(np.abs(_np(G) - np.asarray(Gj)).max()) < 1e-3

    def test_rff_scale_uses_true_feature_count(self):
        """D = 12: the reference pads to 128 lanes and scales by sqrt(2/12)."""
        X, b, W, c = _rff_inputs(64, 32, 12, "float32", seed=23)
        G, _ = ops.rff_gram(*_t(X, b, W, c))
        Gj, _ = jops.rff_gram(*_j(X, b, W, c))
        ratio = float(np.trace(_np(G)) / np.trace(np.asarray(Gj)))
        assert abs(ratio - 1.0) < 1e-3, ratio

    @pytest.mark.parametrize("fn", ["sketch", "rff"])
    def test_float64_stays_float64(self, fn):
        rng = np.random.default_rng(3)
        X = torch.from_numpy(rng.standard_normal((40, 9)))
        b = torch.from_numpy(rng.standard_normal(40))
        M = torch.from_numpy(rng.standard_normal((9, 5)))
        if fn == "sketch":
            G, h = ops.sketch_gram(X, b, M)
            T = X @ M
        else:
            c = torch.from_numpy(rng.uniform(0, 6, 5))
            G, h = ops.rff_gram(X, b, M, c)
            T = np.sqrt(2 / 5) * torch.cos(X @ M + c)
        assert G.dtype == h.dtype == torch.float64
        torch.testing.assert_close(G, T.T @ T, rtol=1e-12, atol=1e-12)
        torch.testing.assert_close(h, T.T @ b, rtol=1e-12, atol=1e-12)

    def test_cuda_wrappers_refuse_cpu_tensors(self):
        X, b, W, c = _t(*_rff_inputs(8, 4, 3, "float32", seed=0))
        with pytest.raises(ValueError, match="CUDA"):
            gram.sketch_gram_cuda(X, b, W)
        with pytest.raises(ValueError, match="CUDA"):
            gram.rff_gram_cuda(X, b, W, c)
        assert gram.launch_counts()["sketch_gram"] == 0
        assert gram.launch_counts()["rff_gram"] == 0

    def test_unknown_device_raises(self):
        """A device other than CUDA, CPU and meta raises; a meta tensor
        takes the plain version, which there computes shapes alone."""
        G, h = ops.sketch_gram(torch.zeros(4, 3, device="meta"),
                               torch.zeros(4, device="meta"),
                               torch.zeros(3, 2, device="meta"))
        assert (G.device.type, G.shape, h.shape) == ("meta", (2, 2), (2,))
        elsewhere = type("Elsewhere", (), {"device": torch.device("xpu")})()
        with pytest.raises(ValueError, match="device"):
            ops.sketch_gram(elsewhere, elsewhere, elsewhere)


def _kernel_model(X, b, M, c, dtype=torch.float32):
    """numpy model of csrc/feature_gram.cu's schedule, in float64.

    Row splits from ``gram.feature_splits``; one "CTA" per (upper tile,
    split) builds T for its chunk rows and its I and J columns with the
    kernel's masks, accumulates G_IJ over the chunk rows in order, writes the
    tile and its mirror into the split's slab; h from the diagonal tiles;
    slabs added in split order.
    """
    n, d = X.shape
    m = M.shape[1]
    BT = 64 if dtype == torch.float64 else 128
    rows_chunk = gram._FEATURE_ROWS
    splits, rps = gram.feature_splits(n, m, dtype)
    assert splits * rps >= n and (splits - 1) * rps < max(n, 1)
    tiles = -(-m // BT)
    slabs = np.full((splits, m, m), np.nan)
    hslab = np.full((splits, m), np.nan)
    for blk in range(tiles * (tiles + 1) // 2):
        t, ti = blk, 0
        while t >= tiles - ti:
            t -= tiles - ti
            ti += 1
        tj = ti + t
        cols = np.r_[ti * BT + np.arange(BT), tj * BT + np.arange(BT)]
        ok_col = cols < m
        Mc = np.where(ok_col, M[:, np.minimum(cols, m - 1)], 0.0)
        for s in range(splits):
            row_end = min(n, (s + 1) * rps)
            acc = np.zeros((BT, BT))
            hacc = np.zeros(BT)
            for r0 in range(s * rps, row_end, rows_chunk):
                rows = r0 + np.arange(rows_chunk)
                ok_row = rows < row_end
                Xc = np.where(ok_row[:, None], X[np.minimum(rows, n - 1)], 0.0)
                T = Xc @ Mc
                if c is not None:
                    cc = np.where(ok_col, c[np.minimum(cols, m - 1)], 0.0)
                    T = np.where(ok_row[:, None] & ok_col[None, :],
                                 np.sqrt(2.0 / m) * np.cos(T + cc), 0.0)
                acc += T[:, :BT].T @ T[:, BT:]
                if ti == tj:
                    hacc += T[:, :BT].T @ np.where(ok_row, b[np.minimum(rows, n - 1)], 0.0)
            r_idx, c_idx = ti * BT + np.arange(BT), tj * BT + np.arange(BT)
            rr, cc_ = np.meshgrid(r_idx, c_idx, indexing="ij")
            keep = (rr < m) & (cc_ < m)
            slabs[s, rr[keep], cc_[keep]] = acc[keep]
            slabs[s, cc_[keep], rr[keep]] = acc[keep]
            if ti == tj:
                hk = r_idx < m
                hslab[s, r_idx[hk]] = hacc[hk]
    assert not np.isnan(slabs).any() and not np.isnan(hslab).any()
    return slabs.sum(0), hslab.sum(0)


def _tf32(x) -> np.ndarray:
    """float32 -> TF32 (10 mantissa bits), nearest with ties away from zero,
    as ``cvt.rna.tf32.f32``; returned as float32."""
    u = np.asarray(x, np.float32).view(np.uint32)
    return ((u + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def _product(X, Y, arith, depth=32, groups=1):
    """X (M, K) @ Y (K, N) as K3's chunk route sums it: in float64
    (``arith="f64"``, the schedule alone) or as its 3xTF32 mma
    (``"3xtf32"``): the k-range in ``depth``-deep tiles, dealt in turn to
    ``groups`` groups of warps; each tile summed from zero as
    small*big + big*small + big*big of the TF32 splits (exact products),
    rounded to float32 and added to its group's float32 running sum; the
    groups' sums added in group order."""
    if arith == "f64":
        return X @ Y
    acc = np.zeros((groups, X.shape[0], Y.shape[1]), np.float32)
    for i, k0 in enumerate(range(0, X.shape[1], depth)):
        x, y = X[:, k0:k0 + depth].astype(np.float32), Y[k0:k0 + depth].astype(np.float32)
        xb, yb = _tf32(x), _tf32(y)
        xs, ys = _tf32(x - xb), _tf32(y - yb)
        part = (xs.astype(np.float64) @ yb + xb.astype(np.float64) @ ys
                + xb.astype(np.float64) @ yb)
        acc[i % groups] = (acc[i % groups] + part.astype(np.float32)).astype(np.float32)
    out = acc[0]
    for q in range(1, groups):
        out = (out + acc[q]).astype(np.float32)
    return out


SYRK_TILE, SYRK_GROUPS, SYRK_DEPTH = 32, 4, 16   # csrc/tc_syrk.cuh: SyrkShape<32> GROUPS, GK


def _sketch_chunk_model(A, b, R, chunk_rows=None, arith="f64"):
    """numpy model of float32 K3's chunk route (csrc/feature_gram.cu).

    Chunks from ``gram.sketch_chunks`` (or ``chunk_rows``); per chunk, in
    order: T_c = A_c R once per row (32-deep k-tiles), into a workspace
    whose rows are padded to a multiple of 4 with zeros; then one "CTA" per
    upper 32 x 32 tile of G adds T_c[:, I]^T T_c[:, J] (16-row slices dealt
    to 4 groups, summed in group order) to what the earlier chunks wrote,
    writing r <= c on diagonal tiles and every mirror; diagonal tiles also
    add T_c[:, I]^T b_c (per group, float32 FMAs in row order under
    ``"3xtf32"``).
    """
    n, d = A.shape
    m = R.shape[1]
    chunks, rows_per = gram.sketch_chunks(n)
    if chunk_rows is not None:
        chunks, rows_per = max(1, -(-n // chunk_rows)), chunk_rows
    assert chunks * rows_per >= n and (n == 0 or (chunks - 1) * rows_per < n)
    dt = np.float64 if arith == "f64" else np.float32
    ldT, BT = -(-m // 4) * 4, SYRK_TILE
    tiles = -(-m // BT)
    G, h = np.full((m, m), np.nan, dt), np.full(m, np.nan, dt)
    for ch in range(chunks):
        r0 = ch * rows_per
        rows = max(0, min(rows_per, n - r0))
        T = np.zeros((rows, tiles * BT), dt)        # columns >= ldT: zero-filled loads
        T[:, :m] = _product(A[r0:r0 + rows], R, arith)
        assert not T[:, m:ldT].any()
        bc = b[r0:r0 + rows].astype(dt)
        for ti in range(tiles):
            for tj in range(ti, tiles):
                I, J = ti * BT + np.arange(BT), tj * BT + np.arange(BT)
                acc = _product(T[:, I].T, T[:, J], arith, SYRK_DEPTH, SYRK_GROUPS)
                rr, cc = np.meshgrid(I, J, indexing="ij")
                keep = (rr < m) & (cc < m) & ((ti < tj) | (rr <= cc))
                val = acc[keep] + (G[rr[keep], cc[keep]] if ch else 0)
                G[rr[keep], cc[keep]] = val
                G[cc[keep], rr[keep]] = val
                if ti == tj:
                    hacc = np.zeros((SYRK_GROUPS, BT), dt)
                    for r in range(rows):              # one FMA chain per group and column
                        q = r // SYRK_DEPTH % SYRK_GROUPS
                        hacc[q] = (hacc[q] + T[r, I] * bc[r]).astype(dt)
                    hsum = hacc[0]
                    for q in range(1, SYRK_GROUPS):
                        hsum = (hsum + hacc[q]).astype(dt)
                    ok = I < m
                    h[I[ok]] = hsum[ok] + (h[I[ok]] if ch else 0)
    assert not np.isnan(G).any() and not np.isnan(h).any()
    return G, h


class TestKernelScheduleModel:
    """The CUDA kernels' tiling, splits and masks compute the plain function."""

    @pytest.mark.parametrize("n,d,m,kind", [
        (1000, 100, 12, "sketch"), (300, 20, 200, "sketch"), (0, 5, 3, "sketch"),
        (2500, 7, 130, "sketch"), (31, 32, 32, "rff"), (700, 16, 257, "rff"),
        (1, 3, 1, "rff")])
    def test_model_matches_plain(self, n, d, m, kind):
        """float32 K3 takes the chunk route; float64 K4 the tile routine
        (float32 K4 takes the chunk route, tests/test_torch_syrk.py)."""
        rng = np.random.default_rng(n + d + m)
        X, b = rng.standard_normal((n, d)), rng.standard_normal(n)
        M = rng.standard_normal((d, m))
        c = rng.uniform(0, 2 * np.pi, m) if kind == "rff" else None
        G, h = (_kernel_model(X, b, M, c, torch.float64) if kind == "rff"
                else _sketch_chunk_model(X, b, M))
        if kind == "rff":
            Gr, hr = ref.rff_gram_ref(*(torch.from_numpy(a) for a in (X, b, M, c)))
        else:
            Gr, hr = ref.sketch_gram_ref(*(torch.from_numpy(a) for a in (X, b, M)))
        np.testing.assert_allclose(G, Gr.numpy(), rtol=1e-10, atol=1e-10)
        np.testing.assert_allclose(h, hr.numpy(), rtol=1e-10, atol=1e-10)
        assert np.array_equal(G, G.T)

    @pytest.mark.parametrize("n,m,dtype,splits", [
        (16384, 1024, torch.float32, 11), (16384, 4096, torch.float32, 1),
        (1000, 12, torch.float32, 4), (0, 5, torch.float32, 1),
        (2048, 300, torch.float64, 8)])
    def test_split_choice(self, n, m, dtype, splits):
        s, rows = gram.feature_splits(n, m, dtype)
        assert s == splits and s * rows >= n and rows % gram._FEATURE_ROWS == 0

    @pytest.mark.parametrize("n,d,m,chunk_rows", [
        (300, 20, 200, 64), (129, 7, 130, 32), (64, 16, 64, 64), (500, 9, 65, 100),
        (0, 5, 3, None), (1, 3, 1, None), (4100, 8, 70, None), (4096, 6, 12, None)])
    def test_sketch_chunk_model_matches_plain_and_float64(self, n, d, m, chunk_rows):
        """K3's chunk route: n not a multiple of the chunk (a chunk of 4 rows
        at the real 4096), m not a multiple of the 64-wide tile, one and
        many chunks, m below one tile. The schedule in float64 equals the
        plain version; the 3xTF32 arithmetic in float32 stays at float32
        accuracy (float32 sums of up to 4096 terms with cancellation: 1e-5),
        far inside chip_smoke.py's 1e-4 Frobenius and the plain-version
        tolerance."""
        rng = np.random.default_rng(n + d + m)
        A = rng.standard_normal((n, d)).astype(np.float32)
        b = rng.standard_normal(n).astype(np.float32)
        R = (rng.standard_normal((d, m)) / np.sqrt(m)).astype(np.float32)
        G64, h64 = ref.sketch_gram_ref(*(torch.from_numpy(a).double() for a in (A, b, R)))
        G, h = _sketch_chunk_model(A.astype(np.float64), b.astype(np.float64),
                                   R.astype(np.float64), chunk_rows)
        np.testing.assert_allclose(G, G64.numpy(), rtol=1e-10, atol=1e-10)
        np.testing.assert_allclose(h, h64.numpy(), rtol=1e-10, atol=1e-10)
        assert np.array_equal(G, G.T)
        G32, h32 = _sketch_chunk_model(A, b, R, chunk_rows, arith="3xtf32")
        assert G32.dtype == np.float32 and np.array_equal(G32, G32.T)
        Gp, hp = ref.sketch_gram_ref(*_t(A, b, R))
        _assert_close(G32, h32, Gp, hp)
        for x, x64 in ((G32, G64.numpy()), (h32, h64.numpy())):
            assert np.linalg.norm(x - x64) <= 1e-5 * max(np.linalg.norm(x64), 1e-30)

    def test_one_tf32_pass_is_not_enough(self):
        """Why three products: one TF32 pass (big*big alone) keeps ~3 digits,
        too few for the 1e-4 Frobenius check against float64."""
        rng = np.random.default_rng(0)
        A = rng.standard_normal((256, 64)).astype(np.float32)
        R = (rng.standard_normal((64, 32)) / np.sqrt(32)).astype(np.float32)
        T64 = A.astype(np.float64) @ R
        one = _tf32(A).astype(np.float64) @ _tf32(R)
        three = _product(A, R, "3xtf32")
        assert np.linalg.norm(one - T64) > 1e-4 * np.linalg.norm(T64)
        assert np.linalg.norm(three - T64) < 1e-6 * np.linalg.norm(T64)

    @pytest.mark.parametrize("n,chunks", [(0, 1), (1, 1), (4096, 1), (4097, 2),
                                          (16384, 4), (16385, 5)])
    def test_sketch_chunks(self, n, chunks):
        c, rows = gram.sketch_chunks(n)
        assert (c, rows) == (chunks, 4096)
        assert c * rows >= n and (n == 0 or (c - 1) * rows < n)


def _jax_map(kind, seed, d, m, ls=1.0):
    return jcore.FeatureMap(kind, seed, d, m, ls)


def _port_map(fj):
    arrays = [np.asarray(a) for a in fj.materialize()]
    return feature_map_from(fj, arrays, device="cpu")


MAPS = [("sketch", 3, 40, 12, 1.0), ("sketch", 0, 16, 16, 1.0),
        ("rff", 5, 6, 48, 1.5), ("rff", 1, 24, 10, 24 ** 0.5)]


class TestFeatureMap:
    @pytest.mark.parametrize("arrays", [
        [np.arange(12, dtype=np.float32).reshape(3, 4)],
        [np.linspace(-1, 1, 7), np.float32([3.5, -0.0, 1e-30])],
        [np.zeros(0, np.float32)]])
    def test_feature_hash_bitwise(self, arrays):
        assert tcore.feature_hash(*arrays) == jcore.feature_hash(*arrays)
        assert tcore.feature_hash(*(torch.from_numpy(np.asarray(a)) for a in arrays)) \
            == jcore.feature_hash(*arrays)

    @pytest.mark.parametrize("spec", MAPS)
    def test_fhash_of_carried_arrays_equals_reference(self, spec):
        fj = _jax_map(*spec)
        ft = _port_map(fj)
        assert ft.fhash == fj.fhash
        assert tcore.feature_hash(*ft.materialize("cpu")) == fj.fhash

    @pytest.mark.parametrize("args", [
        ("pca", 0, 8, 4, 1.0), ("sketch", 0, 8, 9, 1.0), ("sketch", 0, 8, 0, 1.0),
        ("rff", 0, 0, 4, 1.0), ("rff", 0, 8, -1, 1.0), ("rff", 0, 8, 4, 0.0),
        ("sketch", 0, 8, 4, float("nan")), ("rff", 0, 8, 4, float("inf"))])
    def test_validation_errors_match(self, args):
        with pytest.raises(ValueError) as ej:
            jcore.FeatureMap(*args)
        with pytest.raises(ValueError) as et:
            tcore.FeatureMap(*args)
        assert str(et.value) == str(ej.value)

    def test_identity_is_hashable_and_frozen(self):
        a, b = tcore.FeatureMap("rff", 1, 4, 8), tcore.FeatureMap("rff", 1, 4, 8)
        assert a == b and hash(a) == hash(b)
        with pytest.raises(dataclasses.FrozenInstanceError):
            a.m = 3

    @pytest.mark.parametrize("spec", MAPS)
    def test_own_draw_close_to_reference(self, spec):
        """Without carried arrays the port draws its own: c bitwise, R and W
        within the threefry tolerance (see tests/test_torch_threefry.py)."""
        fj = _jax_map(*spec)
        ft = tcore.FeatureMap(*spec)
        for a, b in zip(ft.materialize("cpu"), fj.materialize()):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=2e-6, atol=1e-6)
        if spec[0] == "rff":
            assert np.array_equal(ft.materialize("cpu")[1].numpy(),
                                  np.asarray(fj.materialize()[1]))

    def test_seeded_arrays_win_and_shapes_are_checked(self):
        ft = tcore.FeatureMap("sketch", 99, 6, 2)
        R = np.ones((6, 2), np.float32)
        tfeatures.seed_arrays(ft, [R])
        assert np.array_equal(ft.materialize("cpu")[0].numpy(), R)
        with pytest.raises(ValueError, match="shapes"):
            tfeatures.seed_arrays(ft, [np.ones((2, 6), np.float32)])

    @pytest.mark.parametrize("spec", MAPS)
    def test_stats_lift_predict_vs_reference(self, spec):
        fj = _jax_map(*spec)
        ft = _port_map(fj)
        rng = np.random.default_rng(spec[1])
        n = 90
        A = rng.standard_normal((n, fj.d_orig)).astype(np.float32)
        b = rng.standard_normal(n).astype(np.float32)
        sj = fj.stats(jnp.asarray(A), jnp.asarray(b))
        st = ft.stats(torch.from_numpy(A), torch.from_numpy(b))
        _assert_close(st.gram, st.moment, sj.gram, sj.moment)
        assert int(st.count) == int(sj.count) == n
        np.testing.assert_allclose(float(st.yty), float(sj.yty), rtol=1e-6)
        # featurize
        np.testing.assert_allclose(_np(ft(torch.from_numpy(A))),
                                   np.asarray(fj(jnp.asarray(A))),
                                   rtol=1e-5, atol=1e-5)
        # lift and predict
        v = rng.standard_normal(fj.m).astype(np.float32)
        wt, wj = ft.lift(torch.from_numpy(v)), fj.lift(jnp.asarray(v))
        np.testing.assert_allclose(_np(wt), np.asarray(wj), rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(_np(ft.predict(torch.from_numpy(A), wt)),
                                   np.asarray(fj.predict(jnp.asarray(A), wj)),
                                   rtol=1e-4, atol=1e-4)
        assert ft.error_bound(2.5) == fj.error_bound(2.5)
        assert ft.error_bound(1.0, c=0.3) == fj.error_bound(1.0, c=0.3)
        assert ft.upload_floats() == fj.upload_floats()

    @pytest.mark.parametrize("spec", MAPS[:1] + MAPS[2:3])
    def test_two_pass_stats_and_fused_route_vs_reference(self, spec):
        """The port's two-pass ``projected_stats`` / ``rff_stats`` against the
        reference's, and ``FeatureMap.stats`` against the reference's fused
        route (``use_pallas=True``, Pallas in interpret mode)."""
        fj = _jax_map(*spec)
        ft = _port_map(fj)
        rng = np.random.default_rng(0)
        A = rng.standard_normal((50, ft.d_orig)).astype(np.float32)
        b = rng.standard_normal(50).astype(np.float32)
        At, bt = torch.from_numpy(A), torch.from_numpy(b)
        arrays_t = ft.materialize("cpu")
        arrays_j = fj.materialize()
        if ft.kind == "sketch":
            st = tcore.projected_stats(At, bt, *arrays_t)
            sj = jcore.projected_stats(jnp.asarray(A), jnp.asarray(b), *arrays_j)
        else:
            st = tcore.rff_stats(At, bt, tcore.RFFMap(*arrays_t))
            sj = jcore.rff_stats(jnp.asarray(A), jnp.asarray(b),
                                 jcore.RFFMap(*arrays_j))
        _assert_close(st.gram, st.moment, sj.gram, sj.moment)
        assert int(st.count) == int(sj.count) == 50
        s = ft.stats(At, bt)
        sf = fj.stats(jnp.asarray(A), jnp.asarray(b), use_pallas=True)
        _assert_close(s.gram, s.moment, sf.gram, sf.moment)
        np.testing.assert_allclose(float(s.yty), float(sf.yty), rtol=1e-6)

    def test_stats_shape_checks(self):
        ft = tcore.FeatureMap("sketch", 0, 8, 4)
        with pytest.raises(ValueError, match="A must be"):
            ft.stats(torch.zeros(3, 7), torch.zeros(3))
        with pytest.raises(ValueError, match="b must be"):
            ft.stats(torch.zeros(3, 8), torch.zeros(4))

    @pytest.mark.parametrize("ls", [1.0, 2.5])
    def test_kernel_gram_exact_vs_reference(self, ls):
        rng = np.random.default_rng(5)
        X = rng.standard_normal((7, 3)).astype(np.float32)
        Y = rng.standard_normal((5, 3)).astype(np.float32)
        Kt = tcore.kernel_gram_exact(torch.from_numpy(X), torch.from_numpy(Y), ls)
        np.testing.assert_allclose(Kt.numpy(), np.asarray(
            jcore.kernel_gram_exact(jnp.asarray(X), jnp.asarray(Y), ls)),
            rtol=1e-5, atol=1e-6)

    def test_key_from(self):
        k = jax.random.PRNGKey(42)
        np.testing.assert_array_equal(key_from(k), threefry.key(42))
        with pytest.raises(TypeError):
            key_from(np.zeros(3, np.uint32))


def _datasets(num_clients=4, n=60, d=32, seed=0):
    dj = jsyn.generate(jax.random.PRNGKey(seed), num_clients=num_clients,
                       samples_per_client=n, dim=d)
    dt = dataset_from_numpy([(np.asarray(A), np.asarray(b)) for A, b in dj.clients],
                            dj.test_A, dj.test_b, dj.w_star, dj.gamma, device="cpu")
    return dj, dt


class TestProjectedProtocol:
    @pytest.mark.parametrize("m,sigma,seed", [(8, 0.1, 0), (16, 0.01, 3), (32, 1.0, 7)])
    def test_matches_jax(self, m, sigma, seed):
        dj, dt = _datasets()
        kj = jax.random.PRNGKey(seed)
        rj = jfed.run_one_shot_projected(dj, sigma, m, key=kj)
        rt = tfed.run_one_shot_projected(dt, sigma, m, key=np.asarray(kj))
        wj, wt = np.asarray(rj.weights), _np(rt.weights)
        assert wt.shape == wj.shape == (dj.dim,)
        assert np.linalg.norm(wt - wj) / np.linalg.norm(wj) <= 1e-4
        assert dataclasses.asdict(rt.comm) == dataclasses.asdict(rj.comm)
        assert rt.rounds == rj.rounds == 1
        assert rt.extras["m"] == m and rt.extras["engine"].dim == m
        np.testing.assert_allclose(rt.extras["projection"].numpy(),
                                   np.asarray(rj.extras["projection"]),
                                   rtol=2e-6, atol=1e-6)

    def test_equals_sketch_tenant(self):
        """run_one_shot_projected and a FeatureMap('sketch') tenant with the
        same seed fuse the same statistics (same R, same rows)."""
        _, dt = _datasets()
        rt = tfed.run_one_shot_projected(dt, 0.1, 8, key=threefry.key(5))
        fm = tcore.FeatureMap("sketch", 5, dt.dim, 8)
        eng = FusionEngine.from_clients([fm.stats(A, b) for A, b in dt.clients],
                                        device="cpu")
        torch.testing.assert_close(fm.lift(eng.solve(0.1)), rt.weights,
                                   rtol=1e-5, atol=1e-6)


class TestFeatureTenant:
    """A feature tenant served from the engine: streamed featurized rows
    through the coalescer, and inference off the cached factor."""

    @pytest.mark.parametrize("spec", [("sketch", 2, 24, 10, 1.0),
                                      ("rff", 4, 6, 40, 2.0)])
    def test_streamed_rows_match_cold_f64_solve(self, spec):
        ft = tcore.FeatureMap(*spec)
        rng = np.random.default_rng(1)
        w = rng.standard_normal(ft.d_orig)
        clients = []
        for _ in range(3):
            A = rng.standard_normal((50, ft.d_orig)).astype(np.float32)
            clients.append((torch.from_numpy(A),
                            torch.from_numpy((A @ w).astype(np.float32))))
        rows = torch.from_numpy(rng.standard_normal((16, ft.d_orig)).astype(np.float32))
        rows_b = rows.double() @ torch.from_numpy(w)
        sigmas = [0.01, 0.1, 1.0]
        eng = FusionEngine.from_clients([ft.stats(A, b) for A, b in clients],
                                        coalesce=CoalescerPolicy(max_rank=16),
                                        max_update_rank=64, device="cpu")
        eng.solve_batch(sigmas)
        cold0 = eng.cold_factorizations
        T = ft(rows)
        for i in range(16):
            eng.ingest_rows_async(T[i:i + 1], rows_b[i:i + 1].float(), client_id=9)
        assert eng.flushes == 1 and eng.incremental_updates > 0
        # cold float64 solve from every raw row, featurized in float64
        arrays = [a.double() for a in ft.materialize("cpu")]
        A_all = torch.cat([A for A, _ in clients] + [rows]).double()
        b_all = torch.cat([b for _, b in clients] + [rows_b.float()]).double()
        T_all = (A_all @ arrays[0] if ft.kind == "sketch"
                 else tcore.RFFMap(*arrays)(A_all))
        for s in sigmas:
            w64 = torch.linalg.solve(T_all.T @ T_all + s * torch.eye(ft.m,
                                     dtype=torch.float64), T_all.T @ b_all)
            wt = eng.solve(s)
            assert float(torch.linalg.norm(wt.double() - w64)
                         / torch.linalg.norm(w64)) <= 1e-4
        assert eng.cold_factorizations == cold0

    @pytest.mark.parametrize("kind", ["sketch", "rff"])
    def test_inference_bitwise_equals_reference(self, kind):
        ft = tcore.FeatureMap(kind, 8, 12, 6 if kind == "sketch" else 20)
        rng = np.random.default_rng(2)
        A = torch.from_numpy(rng.standard_normal((200, 12)).astype(np.float32))
        b = torch.from_numpy(rng.standard_normal(200).astype(np.float32))
        eng = FusionEngine.from_clients([ft.stats(A[:100], b[:100]),
                                         ft.stats(A[100:], b[100:])], device="cpu")
        q = ft(A[:5])
        rep = eng.inference(0.1, queries=q)
        w_cold, rep_ref = reference_inference(eng.stats, 0.1, queries=q)
        assert torch.equal(eng.solve(0.1), w_cold)
        for key in ("n", "dof", "rss", "sigma2"):
            assert rep[key] == rep_ref[key]
        for key in ("stderr", "ci", "pi", "pi_mean"):
            assert np.array_equal(rep[key], rep_ref[key])

    def test_bf16_client_stats_vs_reference(self):
        """bf16 rows with the float32 map: both sides quantise the rows
        only, then featurize and accumulate in float32."""
        fj = _jax_map("sketch", 6, 32, 8)
        ft = _port_map(fj)
        rng = np.random.default_rng(4)
        A = rng.standard_normal((120, 32)).astype(np.float32).astype(ml_dtypes.bfloat16)
        b = rng.standard_normal(120).astype(np.float32).astype(ml_dtypes.bfloat16)
        sj = fj.stats(jnp.asarray(A), jnp.asarray(b))
        st = ft.stats(*_t(A, b))
        assert st.gram.dtype == torch.float32
        _assert_close(st.gram, st.moment, sj.gram, sj.moment)
