"""The port's CUDA kernels and its main path on the card, at test sizes.

Marked ``cuda``: each test asks the ``card`` fixture, which skips when there
is no CUDA device (decided at run time, never at import). On a machine with
a card, run them with

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Each kernel is held against its plain PyTorch version on the same CUDA
tensors, and the CUDA path of the port against its own CPU path.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import core, server
from repro_torch.fed import PackedStats
from repro_torch.kernels import gram, ops, ref
from repro_torch.server import cholesky

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the kernels run only on the card")
    return torch.device("cuda")


def _randn(shape, dtype=torch.float32, seed=0):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(shape, generator=g, dtype=torch.float64).to(dtype)


def _rel(x, y):
    x, y = x.double().cpu(), y.double().cpu()
    return float((x - y).abs().max() / y.abs().max())


@pytest.mark.parametrize("n,d,dtype", [(1, 40, torch.float32), (300, 129, torch.float32),
                                       (1000, 256, torch.bfloat16),
                                       (77, 65, torch.float16), (200, 70, torch.float64)])
def test_gram_moment_matches_plain(card, n, d, dtype):
    A, b = _randn((n, d), dtype).to(card), _randn((n,), dtype, seed=1).to(card)
    before = gram.gram_moment_cuda.launches
    G, h = gram.gram_moment_cuda(A, b)
    G2, h2 = gram.gram_moment_cuda(A, b)
    Gr, hr = ref.gram_moment_ref(A, b)
    torch.cuda.synchronize()
    assert gram.gram_moment_cuda.launches == before + 2
    assert torch.equal(G, G2) and torch.equal(h, h2) and torch.equal(G, G.T)
    tol = 1e-12 if dtype == torch.float64 else 1e-5
    assert _rel(G, Gr) <= tol and _rel(h, hr) <= tol


@pytest.mark.parametrize("n", [1, 31, 4097])
@pytest.mark.parametrize("d", [100, 130, 2601])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
def test_gram_moment_syrk_matches_plain(card, n, d, dtype):
    """K1 on the tensor-core SYRK (n 31, 4097) and, for a streamed row (n
    1), the CUDA-core kernel: d ragged against the tile (100), rows not
    16-byte aligned (130, 2601: the 4-byte copies), the 128-wide tile
    (2601) and the 32-wide one; held at the same 1e-5 as above."""
    assert gram.gram_tile(n, d, dtype) == (0 if n == 1 else 128 if d == 2601 else 32)
    A, b = _randn((n, d), dtype, seed=n).to(card), _randn((n,), dtype, seed=d).to(card)
    G, h = gram.gram_moment_cuda(A, b)
    G2, h2 = gram.gram_moment_cuda(A, b)
    Gr, hr = ref.gram_moment_ref(A, b)
    torch.cuda.synchronize()
    assert G.dtype == h.dtype == torch.float32
    assert torch.equal(G, G2) and torch.equal(h, h2) and torch.equal(G, G.T)
    assert _rel(G, Gr) <= 1e-5 and _rel(h, hr) <= 1e-5


@pytest.mark.parametrize("n,d", [(0, 40), (300, 129), (4097, 260)])
@pytest.mark.parametrize("tile", [0, 32, 128])
def test_gram_moment_every_route(card, n, d, tile):
    """The CUDA-core kernel and both SYRK widths at shapes where the rule
    would pick another route, and n = 0 (G and h zeros)."""
    A, b = _randn((n, d), seed=1).to(card), _randn((n,), seed=2).to(card)
    G, h = gram._gram_moment(A, b, tile)
    Gr, hr = ref.gram_moment_ref(A, b)
    torch.cuda.synchronize()
    assert torch.equal(G, G.T)
    if n == 0:
        assert not G.any() and not h.any()
    else:
        assert _rel(G, Gr) <= 1e-5 and _rel(h, hr) <= 1e-5


def test_gram_moment_unaligned_input(card):
    """Rows that start 4 bytes into their buffer take the 4-byte copies and
    give the bits of the same rows at an aligned address."""
    A, b = _randn((4097, 4096)).to(card), _randn((4097,), seed=1).to(card)
    buf = torch.empty(A.numel() + 1, device=card)
    buf[1:] = A.reshape(-1)
    Au = buf[1:].view(A.shape)
    assert Au.data_ptr() % 16 == 4
    G, h = gram.gram_moment_cuda(A, b)
    Gu, hu = gram.gram_moment_cuda(Au, b)
    assert torch.equal(G, Gu) and torch.equal(h, hu)


@pytest.mark.parametrize("m,n,k,dtype", [(100, 37, 13, torch.float32),
                                         (4064, 96, 96, torch.float32),
                                         (1024, 2048, 256, torch.float32),
                                         (3840, 256, 256, torch.float32),
                                         (1024, 320, 320, torch.float32),
                                         (320, 96, 96, torch.float32),
                                         (65, 64, 1, torch.float64)])
def test_gemm_nt_matches_plain(card, m, n, k, dtype):
    """Float32 on the tensor cores at the dense panel's shape and the
    sharded block Cholesky's four (SYRK, TRSM, trailing update, the tile's
    composition), float64 on the CUDA cores."""
    C, A, B = (_randn(s, dtype, seed=i).to(card)
               for i, s in enumerate(((m, n), (m, k), (n, k))))
    out = gram.gemm_nt_cuda(C, A, B, alpha=-0.5)
    tol = 1e-13 if dtype == torch.float64 else 1e-5
    assert _rel(out, ref.gemm_nt_ref(C, A, B, alpha=-0.5)) <= tol


def _gemm_operands(card, m, n, k, seed=0):
    return tuple(_randn(s, seed=seed + i).to(card)
                 for i, s in enumerate(((m, n), (m, k), (n, k))))


def test_gemm_nt_repeats_bitwise(card):
    """Two launches at the SYRK's shape give the same bits (no split over k,
    no atomics), and each counts once."""
    C, A, B = _gemm_operands(card, 1024, 2048, 256)
    before = gram.gemm_nt_cuda.launches
    O1 = gram.gemm_nt_cuda(C, A, B, alpha=-1.0)
    O2 = gram.gemm_nt_cuda(C, A, B, alpha=-1.0)
    torch.cuda.synchronize()
    assert gram.gemm_nt_cuda.launches == before + 2
    assert torch.equal(O1, O2)
    assert _rel(O1, ref.gemm_nt_ref(C, A, B, alpha=-1.0)) <= 1e-5


@pytest.mark.parametrize("m,n,k", [(1024, 320, 320), (100, 37, 13), (320, 96, 96)])
def test_gemm_nt_either_tile_edge_same_bits(card, m, n, k):
    """Both float32 tile edges give the same bits: each element is one
    thread's sum over the same k-tiles in the same order."""
    C, A, B = _gemm_operands(card, m, n, k, seed=3)
    O64 = gram._gemm_nt(C, A, B, 1.0, 64, card)
    O128 = gram._gemm_nt(C, A, B, 1.0, 128, card)
    assert torch.equal(O64, O128)
    assert _rel(O64, ref.gemm_nt_ref(C, A, B, alpha=1.0)) <= 1e-5


@pytest.mark.parametrize("m,n,k", [(300, 36, 13), (3840, 256, 256)])
def test_gemm_nt_unaligned_rows(card, m, n, k):
    """Operands 4 bytes off 16-byte alignment take the 4-byte copies and the
    scalar epilogue: within 1e-5 of plain, and at k % 4 == 0 the bits of the
    same operands at aligned addresses."""
    C, A, B = _gemm_operands(card, m, n, k, seed=5)

    def shifted(t):
        buf = torch.empty(t.numel() + 1, device=card)
        buf[1:] = t.reshape(-1)
        return buf[1:].view(t.shape)
    Cu, Au, Bu = map(shifted, (C, A, B))
    assert all(t.data_ptr() % 16 == 4 for t in (Cu, Au, Bu))
    O = gram.gemm_nt_cuda(Cu, Au, Bu, alpha=-1.0)
    assert _rel(O, ref.gemm_nt_ref(C, A, B, alpha=-1.0)) <= 1e-5
    if k % 4 == 0:
        assert torch.equal(O, gram.gemm_nt_cuda(C, A, B, alpha=-1.0))


def test_gemm_nt_float32_on_the_tensor_cores(card):
    """The built library holds the TF32 tensor-core instruction that
    ``mma.sync.m16n8k8`` compiles to."""
    import os
    import subprocess

    from repro_torch.kernels import _build
    _build.build_all()
    tool = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    if not os.path.isfile(tool):
        pytest.skip(f"no cuobjdump at {tool}")
    sass = subprocess.run([tool, "-sass", str(_build._build_dir() / "libgemm_nt.so")],
                          capture_output=True, text=True, check=True).stdout
    assert "HMMA.1688.F32.TF32" in sass


def test_gemm_nt_refuses_a_bad_route(card):
    """Float32 takes tile edges 64 and 128 only, float64 only the CUDA-core
    loop (0)."""
    C, A, B = _gemm_operands(card, 65, 64, 8)
    for tile in (0, 32, 96):
        with pytest.raises(RuntimeError, match="bad argument"):
            gram._gemm_nt(C, A, B, 1.0, tile, card)
    with pytest.raises(RuntimeError, match="bad argument"):
        gram._gemm_nt(C.double(), A.double(), B.double(), 1.0, 64, card)


@pytest.mark.parametrize("bw,r", [(1, 1), (7, 3), (32, 64), (32, 300), (5, 200),
                                  (32, 1024)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_panel_transform_matches_plain(card, bw, r, dtype):
    M = _randn((4 * bw, bw), torch.float64)
    L11 = torch.linalg.cholesky(M.T @ M + 0.1 * torch.eye(bw, dtype=torch.float64))
    L11 = L11.to(dtype).to(card).contiguous()
    X1 = (0.5 * _randn((r, bw), dtype, seed=2)).to(card)
    Lk, Tk = gram.panel_transform_cuda(L11, X1)
    Lp, Tp = cholesky.panel_transform_ref(L11, X1)
    tol = 1e-12 if dtype == torch.float64 else 1e-4
    assert _rel(Lk, Lp) <= tol and _rel(Tk, Tp) <= tol


def _factor(d, dtype, seed=0):
    M = _randn((2 * d, d), torch.float64, seed=seed)
    return torch.linalg.cholesky(M.T @ M / d + 0.1 * torch.eye(d, dtype=torch.float64)).to(dtype)


@pytest.mark.parametrize("d,c0,bw,r", [(100, 32, 32, 64), (100, 96, 4, 8),
                                       (300, 0, 32, 200), (70, 64, 6, 200)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("sign", [1.0, -1.0])
def test_panel_transform_in_place(card, d, c0, bw, r, sign, dtype):
    """P on a panel inside a factor, as the blocked update launches it: the
    panel's lower triangle becomes the plain L11', nothing else of L or X
    changes, T is the plain T, and the arrival count is back at 0."""
    c1 = c0 + bw
    L = _factor(d, dtype).contiguous().to(card)
    X = (0.3 * _randn((r, d), dtype, seed=3)).to(card)
    if sign < 0:    # downdate what an update added: stays positive definite
        L[c0:c1, c0:c1] = cholesky.panel_transform_ref(L[c0:c1, c0:c1], X[:, c0:c1])[0]
    L0, X0 = L.clone(), X.clone()
    Lp, Tp = cholesky.panel_transform_ref(L[c0:c1, c0:c1], X[:, c0:c1], sign=sign)
    panels = gram._Panels(L, X, bw, sign)
    panels.transform(c0, c1)
    T = panels.T[:(bw + r) ** 2].view(bw + r, bw + r)
    torch.cuda.synchronize()
    tol = 1e-12 if dtype == torch.float64 else 1e-4
    assert _rel(torch.tril(L[c0:c1, c0:c1]), torch.tril(Lp)) <= tol
    assert _rel(T, Tp) <= tol
    keep = torch.ones(d, d, dtype=torch.bool, device=card)
    keep[c0:c1, c0:c1] = ~torch.ones(bw, bw, dtype=torch.bool, device=card).tril()
    assert torch.equal(L[keep], L0[keep]) and torch.equal(X, X0)
    assert int(panels.arrivals.item()) == 0


@pytest.mark.parametrize("d,c0,r,dtype", [(4096, 0, 64, torch.float32),
                                          (4096, 0, 64, torch.float64),
                                          (300, 32, 128, torch.float32),
                                          (300, 32, 128, torch.float64),
                                          (164, 32, 64, torch.float32),
                                          (2000, 0, 1024, torch.float32),
                                          (90, 32, 8, torch.float64)])
def test_panel_gemm_matches_plain(card, d, c0, r, dtype):
    """K2's panel entry, in place (n = 32 + r up to the cap) and out of
    place (above it: float64 at r 128, r 1024), ragged strips (m = 100),
    against ``ref.panel_gemm_ref``; every other element stays."""
    c1 = c0 + 32
    L = _randn((d, d), dtype, seed=1).to(card)
    X = _randn((r, d), dtype, seed=2).to(card)
    T = torch.linalg.qr(_randn((32 + r, 32 + r), torch.float64, seed=3))[0]
    T = T.to(dtype).contiguous().to(card)
    Lp, Xp = L.clone(), X.clone()
    before = gram.gemm_nt_cuda.launches
    gram.panel_gemm_cuda(L, X, c0, c1, T)
    ref.panel_gemm_ref(Lp, Xp, c0, c1, T)
    torch.cuda.synchronize()
    assert gram.gemm_nt_cuda.launches == before + 1
    assert gram.panel_in_place(32 + r, dtype) == (32 + r <= (160 if dtype == torch.float32 else 96))
    tol = 1e-13 if dtype == torch.float64 else 1e-5
    assert _rel(L[c1:, c0:c1], Lp[c1:, c0:c1]) <= tol and _rel(X[:, c1:], Xp[:, c1:]) <= tol
    assert torch.equal(L[:c1], Lp[:c1]) and torch.equal(L[:, :c0], Lp[:, :c0])
    assert torch.equal(L[:, c1:], Lp[:, c1:]) and torch.equal(X[:, :c1], Xp[:, :c1])


@pytest.mark.parametrize("dtype,widest", [(torch.float32, 160), (torch.float64, 96)])
def test_panel_in_place_width(card, dtype, widest):
    """The library's in-place rule: every width up to the cap, none above."""
    assert [n for n in range(1, 400) if gram.panel_in_place(n, dtype)] == \
        list(range(1, widest + 1))


@pytest.mark.parametrize("d,r", [(100, 8), (517, 64), (100, 256)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("sign", [1.0, -1.0])
def test_blocked_update_matches_cpu_path(card, d, r, sign, dtype):
    """``chol_update_blocked`` on the card (P then K2 a panel, in place, or
    out of place at r 256; ragged last panels at d 100 and 517) against its
    CPU path, from a column-major factor as ``torch.linalg.cholesky``
    returns it."""
    L = _factor(d, dtype)
    U = 0.3 * _randn((r, d), dtype, seed=4)
    if sign < 0:
        L = cholesky.chol_update_blocked(L, U)
    want = cholesky.chol_update_blocked(L, U, sign=sign)
    Lc = L.to(card).T.contiguous().T
    assert not Lc.is_contiguous()
    got = cholesky.chol_update_blocked(Lc, U.to(card), sign=sign)
    tol = 1e-10 if dtype == torch.float64 else 2e-4
    assert _rel(got, want) <= tol


def test_blocked_update_two_launches_a_panel(card):
    """A rank-64 update at d 4100 (129 panels, the last 4 wide): P on every
    panel, K2 on every panel but the last, and under the profiler nothing
    else runs from the first P to the last."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    d, r = 4100, 64
    L = _factor(d, torch.float32).to(card)
    U = (0.3 * _randn((r, d), seed=5)).to(card)
    cholesky.chol_update_blocked(L, U)          # builds and loads the kernels
    torch.cuda.synchronize()
    gram.reset_launch_counts()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        cholesky.chol_update_blocked(L, U)
        torch.cuda.synchronize()
    panels = -(-d // 32)
    counts = gram.launch_counts()
    assert counts["panel_transform"] == panels and counts["gemm_nt"] == panels - 1
    events = sorted((e for e in prof.events() if e.device_type == DeviceType.CUDA),
                    key=lambda e: e.time_range.start)
    tags = ["P" if "panel_transform_kernel" in e.name else
            "K2" if "gemm_nt_panel_kernel" in e.name else e.name for e in events]
    first, last = tags.index("P"), len(tags) - 1 - tags[::-1].index("P")
    assert tags[first:last + 1] == ["P", "K2"] * (panels - 1) + ["P"]
    assert len(tags) - (last + 1 - first) <= 3      # the copies of L and U, the count's zero


def test_wrappers_reject_bad_arguments(card):
    A = torch.zeros(4, 3, device=card)
    with pytest.raises(TypeError):
        gram.gram_moment_cuda(A.int(), torch.zeros(4, device=card).int())
    with pytest.raises(ValueError):
        gram.gram_moment_cuda(A.T, torch.zeros(3, device=card))
    with pytest.raises(ValueError):
        gram.panel_transform_cuda(torch.eye(33, device=card), torch.zeros(2, 33, device=card))


def test_engine_on_card_matches_cpu_path(card):
    rng = np.random.default_rng(0)
    data = [(rng.standard_normal((200, 48)).astype(np.float32),
             rng.standard_normal(200).astype(np.float32)) for _ in range(3)]
    rows = rng.standard_normal((20, 48)).astype(np.float32)
    engines = {}
    for dev in ("cpu", card):
        stats = [core.compute_stats(torch.from_numpy(A).to(dev), torch.from_numpy(b).to(dev))
                 for A, b in data]
        eng = server.FusionEngine.from_clients(
            stats, max_update_rank=64, coalesce=server.CoalescerPolicy(max_rank=16))
        eng.solve(0.1)
        for i in range(len(rows)):
            r = torch.from_numpy(rows[i:i + 1]).to(dev)
            eng.ingest_rows_async(r, r.sum(1), client_id=1)
        eng.flush()
        eng.drop(0)
        engines[str(dev)] = eng
    gpu, cpu = engines[str(card)], engines["cpu"]
    assert gpu.incremental_updates == cpu.incremental_updates > 0
    assert _rel(gpu.solve(0.1), cpu.solve(0.1)) <= 1e-4
    assert gpu.inference(0.1) is not None


def _feature_inputs(n, d, m, dtype, map_dtype, seed, rff):
    X = _randn((n, d), dtype, seed).to("cuda")
    b = _randn((n,), dtype, seed + 1).to("cuda")
    M = (_randn((d, m), torch.float64, seed + 2) / (1.0 if rff else m ** 0.5)
         ).to(map_dtype).to("cuda")
    c = (torch.rand(m, generator=torch.Generator().manual_seed(seed + 3),
                    dtype=torch.float64) * 2 * np.pi).to(map_dtype).to("cuda")
    return X, b, M, c


def _feature_close(G, h, Gr, hr):
    """tests/test_sketch_kernels.py's tolerance (f32 reduction order)."""
    scale = max(1.0, float(Gr.abs().max()))
    torch.testing.assert_close(G, Gr, rtol=2e-3, atol=2e-4 * scale)
    torch.testing.assert_close(h, hr, rtol=2e-3, atol=2e-4 * scale)


@pytest.mark.parametrize("kind", ["sketch", "rff"])
@pytest.mark.parametrize("n,d,m,dtype,map_dtype", [
    (1000, 100, 12, torch.float32, torch.float32),     # ragged n, d, m; split rows
    (31, 32, 32, torch.float32, torch.float32),        # one short of a chunk
    (1, 7, 5, torch.float32, torch.float32),
    (0, 7, 5, torch.float32, torch.float32),
    (3000, 64, 300, torch.float32, torch.float32),     # several tiles and splits
    (700, 48, 160, torch.bfloat16, torch.bfloat16),
    (700, 48, 160, torch.bfloat16, torch.float32),
    (513, 40, 70, torch.float64, torch.float64),
    (4500, 37, 130, torch.float32, torch.float32),     # K3: 4-byte copies, 2 chunks
    (5000, 64, 1000, torch.float32, torch.float32),    # K3: partial chunk, m 1000
    (4100, 32, 1024, torch.float32, torch.float32),    # K3: a chunk of 4 rows
    (4097, 40, 1024, torch.bfloat16, torch.float32),   # K3: bf16 rows, f32 map
    (4500, 24, 1000, torch.bfloat16, torch.bfloat16)])
def test_feature_gram_matches_plain(card, kind, n, d, m, dtype, map_dtype):
    X, b, M, c = _feature_inputs(n, d, m, dtype, map_dtype, n + d + m, kind == "rff")
    if kind == "sketch":
        run = lambda: gram.sketch_gram_cuda(X, b, M)                  # noqa: E731
        Gr, hr = ref.sketch_gram_ref(X, b, M)
        wrapper = gram.sketch_gram_cuda
    else:
        run = lambda: gram.rff_gram_cuda(X, b, M, c)                  # noqa: E731
        Gr, hr = ref.rff_gram_ref(X, b, M, c)
        wrapper = gram.rff_gram_cuda
    before = wrapper.launches
    G, h = run()
    G2, h2 = run()
    torch.cuda.synchronize()
    assert wrapper.launches == before + 2
    assert G.dtype == h.dtype == ref.accumulation_dtype(dtype)
    assert torch.equal(G, G2) and torch.equal(h, h2) and torch.equal(G, G.T)
    if dtype == torch.float64:
        torch.testing.assert_close(G, Gr, rtol=1e-11, atol=1e-11)
        torch.testing.assert_close(h, hr, rtol=1e-11, atol=1e-11)
    else:
        _feature_close(G, h, Gr, hr)


@pytest.mark.parametrize("D", [96, 4096])
@pytest.mark.parametrize("dtype,map_dtype", [(torch.float32, torch.float32),
                                             (torch.bfloat16, torch.bfloat16),
                                             (torch.bfloat16, torch.float32)])
def test_rff_gram_chunk_route_matches_plain(card, D, dtype, map_dtype):
    """K4 on the chunk route at n 4095 (one partial chunk), d 128, at D 96
    (32-wide SYRK tiles) and the path's D 4096 (128-wide), with float32 and
    bfloat16 rows."""
    X, b, W, c = _feature_inputs(4095, 128, D, dtype, map_dtype, D, True)
    W = W / 128 ** 0.5
    G, h = gram.rff_gram_cuda(X, b, W, c)
    G2, h2 = gram.rff_gram_cuda(X, b, W, c)
    Gr, hr = ref.rff_gram_ref(X, b, W, c)
    torch.cuda.synchronize()
    assert torch.equal(G, G2) and torch.equal(h, h2) and torch.equal(G, G.T)
    _feature_close(G, h, Gr, hr)


@pytest.mark.parametrize("n,D", [(1, 5), (4097, 130), (300, 257)])
@pytest.mark.parametrize("tile", [32, 128])
@pytest.mark.parametrize("kind", ["sketch", "rff"])
def test_chunk_route_both_tile_widths(card, n, D, tile, kind):
    """The chunk route's SYRK at both widths, whatever the rule picks."""
    X, b, M, c = _feature_inputs(n, 24, D, torch.float32, torch.float32, n + D, kind == "rff")
    if kind == "sketch":
        G, h = gram._feature_gram("sketch_gram", X, b, M, None, tile)
        Gr, hr = ref.sketch_gram_ref(X, b, M)
    else:
        G, h = gram._feature_gram("rff_gram", X, b, M, c, tile)
        Gr, hr = ref.rff_gram_ref(X, b, M, c)
    torch.cuda.synchronize()
    assert torch.equal(G, G.T)
    _feature_close(G, h, Gr, hr)


def test_sketch_gram_unaligned_input(card):
    """A row block that starts 4 bytes into its buffer takes K3's 4-byte
    copies and gives the bits of the same rows at an aligned address."""
    X, b, M, _ = _feature_inputs(4200, 16, 96, torch.float32, torch.float32, 5, False)
    buf = torch.empty(X.numel() + 1, device=card)
    buf[1:] = X.reshape(-1)
    Xu = buf[1:].view(X.shape)
    assert Xu.data_ptr() % 16 == 4
    G, h = gram.sketch_gram_cuda(X, b, M)
    Gu, hu = gram.sketch_gram_cuda(Xu, b, M)
    assert torch.equal(G, Gu) and torch.equal(h, hu)


def test_feature_gram_rejects_bad_arguments(card):
    X, b, M, c = _feature_inputs(8, 4, 3, torch.float32, torch.float32, 0, True)
    with pytest.raises(TypeError):
        gram.sketch_gram_cuda(X, b, M.double())
    with pytest.raises(TypeError):
        gram.rff_gram_cuda(X.half(), b.half(), M.half(), c.half())
    with pytest.raises(ValueError):
        gram.sketch_gram_cuda(X, b, M[:3])
    with pytest.raises(ValueError):
        gram.rff_gram_cuda(X, b, M, c[:2])
    with pytest.raises(ValueError):
        gram.sketch_gram_cuda(X.T, b[:4], M)


@pytest.mark.parametrize("kind,m", [("sketch", 16), ("rff", 96)])
def test_feature_tenant_on_card_matches_cpu_path(card, kind, m):
    fm = core.FeatureMap(kind, 4, 40, m, 6.0)
    rng = np.random.default_rng(1)
    data = [(rng.standard_normal((300, 40)).astype(np.float32),
             rng.standard_normal(300).astype(np.float32)) for _ in range(3)]
    w = {}
    for dev in ("cpu", card):
        before = gram.launch_counts()
        stats = [fm.stats(torch.from_numpy(A).to(dev), torch.from_numpy(b).to(dev))
                 for A, b in data]
        after = gram.launch_counts()
        name = "sketch_gram" if kind == "sketch" else "rff_gram"
        assert after[name] - before[name] == (3 if dev == card else 0)
        eng = server.FusionEngine.from_clients(stats)
        w[str(dev)] = fm.lift(eng.solve(0.1))
    assert _rel(w[str(card)], w["cpu"]) <= 1e-4


def _swa_inputs(B, S, H, Hkv, hd, dtype, seed=0):
    return [_randn(shape, dtype, seed + i).to("cuda")
            for i, shape in enumerate(((B, S, H, hd), (B, S, Hkv, hd), (B, S, Hkv, hd)))]


@pytest.mark.parametrize("hd", [64, 128, 80])
@pytest.mark.parametrize("S", [1, 64, 65, 200, 1000, 4096])
@pytest.mark.parametrize("window", [None, 48, 1024])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("group", [1, 2, 4])
def test_swa_flash_matches_plain(card, hd, S, window, causal, dtype, group):
    """K5 against its plain version: float32 sums in other orders, so
    float32 within 3e-5 and bf16 within one bf16 ulp of the plain value,
    element by element (|o - p| <= 2^-7 |p| + 1e-4)."""
    q, k, v = _swa_inputs(2, S, 4, 4 // group, hd, dtype, seed=S + hd)
    before = gram.swa_flash_cuda.launches
    o = gram.swa_flash_cuda(q, k, v, window=window, causal=causal)
    o2 = gram.swa_flash_cuda(q, k, v, window=window, causal=causal)
    p = ref.swa_attention_ref(q, k, v, window=window, causal=causal)
    torch.cuda.synchronize()
    assert gram.swa_flash_cuda.launches == before + 2
    assert o.dtype == dtype and o.shape == q.shape and torch.equal(o, o2)
    diff = (o.float() - p.float()).abs()
    if dtype == torch.float32:
        assert float(diff.max()) <= 3e-5
    else:
        assert bool((diff <= p.float().abs() * 2.0 ** -7 + 1e-4).all())


@pytest.mark.parametrize("H,Hkv", [(48, 8), (64, 8), (32, 8), (32, 4)])
@pytest.mark.parametrize("window", [4096, None])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_swa_flash_zoo_heads_and_window(card, H, Hkv, window, dtype):
    """K5 at the zoo's heads, hd 128: mixtral's 48 and qwen2's 64 query
    heads over 8 KV heads (GQA 6 and 8), phi3.5-moe's and minitron's 32
    over 8 and yi's 32 over 4 (GQA 4 and 8), with mixtral's window 4096 at
    S 4200: the window masks the first 104 queries' oldest keys, and S is
    not a multiple of 64. Held to the plain version as
    ``test_swa_flash_matches_plain``."""
    q, k, v = _swa_inputs(1, 4200, H, Hkv, 128, dtype, seed=H)
    o = gram.swa_flash_cuda(q, k, v, window=window)
    o2 = gram.swa_flash_cuda(q, k, v, window=window)
    p = ref.swa_attention_ref(q, k, v, window=window)
    torch.cuda.synchronize()
    assert torch.equal(o, o2)
    diff = (o.float() - p.float()).abs()
    if dtype == torch.float32:
        assert float(diff.max()) <= 3e-5
    else:
        assert bool((diff <= p.float().abs() * 2.0 ** -7 + 1e-4).all())
    if window is not None:        # the window changes the result
        full = ref.swa_attention_ref(q, k, v, window=None)
        assert not torch.equal(p, full)


@pytest.mark.parametrize("S", [1500, 1000, 65])
@pytest.mark.parametrize("window", [None, 48])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_swa_flash_hubert_heads(card, S, window, causal, dtype):
    """K5 at hubert-xlarge's heads: hd 80, 16 query heads over 16 KV heads
    (MHA), B 4, over ragged S (1500 is 30 s of frames at 50 Hz), held to
    the plain version as ``test_swa_flash_matches_plain``; non-causal
    without a window is hubert's own case."""
    q, k, v = _swa_inputs(4, S, 16, 16, 80, dtype, seed=S)
    o = gram.swa_flash_cuda(q, k, v, window=window, causal=causal)
    o2 = gram.swa_flash_cuda(q, k, v, window=window, causal=causal)
    p = ref.swa_attention_ref(q, k, v, window=window, causal=causal)
    torch.cuda.synchronize()
    assert torch.equal(o, o2) and bool(torch.isfinite(o).all())
    diff = (o.float() - p.float()).abs()
    if dtype == torch.float32:
        assert float(diff.max()) <= 3e-5
    else:
        assert bool((diff <= p.float().abs() * 2.0 ** -7 + 1e-4).all())


def test_swa_attention_dispatch_by_device(card):
    q, k, v = _swa_inputs(1, 100, 2, 1, 64, torch.float32)
    before = gram.swa_flash_cuda.launches
    on_card = ops.swa_attention(q, k, v, window=32)
    assert gram.swa_flash_cuda.launches == before + 1
    on_cpu = ops.swa_attention(q.cpu(), k.cpu(), v.cpu(), window=32)
    assert gram.swa_flash_cuda.launches == before + 1     # the plain version
    assert on_cpu.device.type == "cpu"
    torch.testing.assert_close(on_card.cpu(), on_cpu, rtol=0, atol=3e-5)


def test_swa_flash_rejects_what_it_does_not_take(card):
    q, k, v = _swa_inputs(1, 64, 2, 1, 64, torch.float32)
    before = gram.swa_flash_cuda.launches
    for dtype in (torch.float16, torch.float64):
        with pytest.raises(TypeError):
            ops.swa_attention(q.to(dtype), k.to(dtype), v.to(dtype), window=None)
    with pytest.raises(TypeError):
        gram.swa_flash_cuda(q, k.bfloat16(), v, window=None)
    with pytest.raises(ValueError):       # head_dim 96
        gram.swa_flash_cuda(*_swa_inputs(1, 64, 2, 1, 96, torch.float32), window=None)
    with pytest.raises(ValueError):       # 3 query heads over 2 KV heads
        gram.swa_flash_cuda(*_swa_inputs(1, 64, 3, 2, 64, torch.float32), window=None)
    with pytest.raises(ValueError):
        gram.swa_flash_cuda(q.transpose(1, 2), k, v, window=None)
    with pytest.raises(ValueError):
        gram.swa_flash_cuda(q, k, v, window=0)
    assert gram.swa_flash_cuda.launches == before


def test_reduced_gemma_on_card_matches_cpu_path(card):
    from repro_torch import configs
    from repro_torch.launch.serve import generate
    from repro_torch.models import model

    cfg = configs.get_reduced("gemma3-27b")
    cpu = model.init_params(cfg, generator=torch.Generator().manual_seed(0), device="cpu")
    gpu = model.init_params(cfg, generator=torch.Generator().manual_seed(0), device="cpu").to(card)
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 96)).astype(np.int32))
    before = gram.swa_flash_cuda.launches
    lg, cache = model.prefill_step(gpu, {"tokens": toks.to(card)}, max_len=104)
    assert gram.swa_flash_cuda.launches == before + cfg.num_layers
    lc, cache_c = model.prefill_step(cpu, {"tokens": toks}, max_len=104)
    scale = max(float(lc.abs().max()), 1.0)
    torch.testing.assert_close(lg.cpu(), lc, rtol=0, atol=1e-4 * scale)
    for tg, tc in zip(cache["layers"], cache_c["layers"]):
        torch.testing.assert_close(tg["k"].cpu(), tc["k"], rtol=0, atol=1e-4 * scale)
    tok = toks[:, -1:]
    for _ in range(8):          # past the reduced window of 32 in the ring buffer
        lg, cache = model.decode_step(gpu, cache, {"tokens": tok.to(card)})
        lc, cache_c = model.decode_step(cpu, cache_c, {"tokens": tok})
        torch.testing.assert_close(lg.cpu(), lc, rtol=0, atol=1e-4 * scale)
        tok = torch.argmax(lc[:, 0], dim=-1)[:, None].int()
    assert gram.swa_flash_cuda.launches == before + cfg.num_layers
    tg, _ = generate(gpu, toks.to(card), 6)
    tc, _ = generate(cpu, toks, 6)
    assert torch.equal(tg.cpu(), tc)


@pytest.mark.parametrize("S", [200, 1500])
def test_narrow_hubert_encode_on_card_matches_cpu_path(card, S):
    """The reduced hubert at the full config's head_dim 80, float32: one
    ``encode_step`` on the card (K5 non-causal, once a layer) against the
    CPU path (the plain version), and a masked one."""
    import dataclasses

    from repro_torch import configs
    from repro_torch.models import model

    cfg = dataclasses.replace(configs.get_reduced("hubert-xlarge"), head_dim=80)
    cpu = model.init_params(cfg, generator=torch.Generator().manual_seed(0), device="cpu")
    gpu = model.init_params(cfg, generator=torch.Generator().manual_seed(0), device="cpu").to(card)
    rng = np.random.default_rng(S)
    x = torch.from_numpy(rng.standard_normal((2, S, cfg.d_model), dtype=np.float32))
    mask = torch.from_numpy(rng.random((2, S)) < 0.3)
    for batch in ({"embeddings": x}, {"embeddings": x, "mask": mask}):
        before = gram.swa_flash_cuda.launches
        lg = model.encode_step(gpu, {key: t.to(card) for key, t in batch.items()})
        assert gram.swa_flash_cuda.launches == before + cfg.num_layers
        lc = model.encode_step(cpu, batch)
        scale = max(float(lc.abs().max()), 1.0)
        assert lg.shape == (2, S, cfg.vocab_size)
        torch.testing.assert_close(lg.cpu(), lc, rtol=0, atol=1e-4 * scale)


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-4), ("bfloat16", 3e-2)])
def test_reduced_jamba_on_card_matches_cpu_path(card, dtype, tol):
    """The reduced jamba (a Mamba + MoE layer, then attention + dense) on
    the card against the same model on the CPU: prefill logits and every
    layer's cache (Mamba conv window and state, attention k), teacher-forced
    decode logits, within ``tol`` x max(scale, 1) (bf16: the reference's
    decode-consistency tolerance, as the card smoke holds the zoo); K5 once
    a prefill and never in decode; on the card, a prefill of S - 1 and one
    decode step against the S-token forward at 3e-2."""
    from repro_torch import configs
    from repro_torch.models import model

    cfg = dataclasses.replace(configs.get_reduced("jamba-1.5-large-398b"), dtype=dtype)
    cpu = model.init_params(cfg, generator=torch.Generator().manual_seed(0), device="cpu")
    gpu = model.init_params(cfg, generator=torch.Generator().manual_seed(0), device="cpu").to(card)
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 200)).astype(np.int32))
    before = gram.swa_flash_cuda.launches
    lg, cache = model.prefill_step(gpu, {"tokens": toks[:, :192].to(card)}, max_len=200)
    assert gram.swa_flash_cuda.launches == before + 1
    lc, cache_c = model.prefill_step(cpu, {"tokens": toks[:, :192]}, max_len=200)
    scale = max(float(lc.abs().max()), 1.0)
    torch.testing.assert_close(lg.cpu().float(), lc.float(), rtol=0, atol=tol * scale)
    for tg, tc in zip(cache["layers"], cache_c["layers"]):
        for key in tc:
            ref = tc[key].float()
            torch.testing.assert_close(tg[key].cpu().float(), ref, rtol=0,
                                       atol=tol * max(float(ref.abs().max()), 1.0))
    for pos in range(192, 200):
        tok = toks[:, pos:pos + 1]
        lg, cache = model.decode_step(gpu, cache, {"tokens": tok.to(card)})
        lc, cache_c = model.decode_step(cpu, cache_c, {"tokens": tok})
        torch.testing.assert_close(lg.cpu().float(), lc.float(), rtol=0, atol=tol * scale)
    assert gram.swa_flash_cuda.launches == before + 1
    full = model.forward(gpu, {"tokens": toks.to(card)})[:, -1].float()
    _, c = model.prefill_step(gpu, {"tokens": toks[:, :-1].to(card)}, max_len=200)
    lg, _ = model.decode_step(gpu, c, {"tokens": toks[:, -1:].to(card)})
    assert float((lg[:, 0].float() - full).abs().max()) <= \
        3e-2 * max(float(full.abs().max()), 1.0)


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-4), ("bfloat16", 3e-2)])
def test_reduced_rwkv6_on_card_matches_cpu_path(card, dtype, tol):
    """The reduced rwkv6 (two RWKV layers: the chunked WKV time mix and the
    channel mix) on the card against the same model on the CPU: prefill
    logits and every layer's cache (S, x_tm, x_cm), teacher-forced decode
    logits, within ``tol`` x max(scale, 1) (bf16: the reference's
    decode-consistency tolerance); no kernel of the port launches (no
    attention layer); a prefill of S - 1 and one decode step against the
    S-token forward at 3e-2 on the card. S 200 is a ragged length: its
    chunk is 50."""
    from repro_torch import configs
    from repro_torch.models import model

    cfg = dataclasses.replace(configs.get_reduced("rwkv6-1.6b"), dtype=dtype)
    cpu = model.init_params(cfg, generator=torch.Generator().manual_seed(0), device="cpu")
    gpu = model.init_params(cfg, generator=torch.Generator().manual_seed(0), device="cpu").to(card)
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 200)).astype(np.int32))
    gram.reset_launch_counts()
    lg, cache = model.prefill_step(gpu, {"tokens": toks[:, :192].to(card)})
    lc, cache_c = model.prefill_step(cpu, {"tokens": toks[:, :192]})
    scale = max(float(lc.abs().max()), 1.0)
    torch.testing.assert_close(lg.cpu().float(), lc.float(), rtol=0, atol=tol * scale)
    for tg, tc in zip(cache["layers"], cache_c["layers"]):
        assert set(tg) == {"S", "x_tm", "x_cm"} and tg["S"].dtype == torch.float32
        for key in tc:
            ref_ = tc[key].float()
            torch.testing.assert_close(tg[key].cpu().float(), ref_, rtol=0,
                                       atol=tol * max(float(ref_.abs().max()), 1.0))
    for pos in range(192, 200):
        tok = toks[:, pos:pos + 1]
        lg, cache = model.decode_step(gpu, cache, {"tokens": tok.to(card)})
        lc, cache_c = model.decode_step(cpu, cache_c, {"tokens": tok})
        torch.testing.assert_close(lg.cpu().float(), lc.float(), rtol=0, atol=tol * scale)
    full = model.forward(gpu, {"tokens": toks.to(card)})[:, -1].float()
    _, c = model.prefill_step(gpu, {"tokens": toks[:, :-1].to(card)})
    lg, _ = model.decode_step(gpu, c, {"tokens": toks[:, -1:].to(card)})
    assert bool(torch.isfinite(full).all())
    assert float((lg[:, 0].float() - full).abs().max()) <= \
        3e-2 * max(float(full.abs().max()), 1.0)
    assert all(n == 0 for n in gram.launch_counts().values())


@pytest.mark.parametrize("arch,cf", [("phi3.5-moe-42b-a6.6b", 8.0),
                                     ("mixtral-8x22b", 8.0), ("mixtral-8x22b", 0.25)])
def test_moe_block_on_card_matches_cpu(card, arch, cf):
    """The MoE block (router, top-k, ranks, dispatch, the expert ``bmm``s,
    combine) in float32 on the card against the CPU: the same experts and
    kept pairs, outputs within 1e-5 of their largest magnitude, and the
    card's run repeated bitwise."""
    from repro_torch import configs
    from repro_torch.models import moe

    cfg = dataclasses.replace(configs.get_reduced(arch), capacity_factor=cf)
    cpu = moe.MoE(cfg, dtype=torch.float32, device="cpu")
    cpu.reset_parameters(torch.Generator().manual_seed(0))
    gpu = moe.MoE(cfg, dtype=torch.float32, device=card)
    gpu.load_state_dict(cpu.state_dict())
    x = _randn((2, 64, cfg.d_model), seed=1)
    yc, auxc = moe.moe_block(cpu, x, cfg, return_aux=True)
    yg, auxg = moe.moe_block(gpu, x.to(card), cfg, return_aux=True)
    yg2 = moe.moe_block(gpu, x.to(card), cfg)
    assert torch.equal(yg, yg2)
    for key in ("expert_idx", "keep"):
        assert torch.equal(gpu.routing[key].cpu(), cpu.routing[key])
    assert bool(cpu.routing["keep"].all()) == (cf == 8.0)
    torch.testing.assert_close(yg.cpu(), yc, rtol=0, atol=1e-5 * float(yc.abs().max()))
    assert abs(float(auxg) - float(auxc)) <= 1e-5


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_moe_top_k_ties_on_card(card, dtype):
    """The stable sort on CUDA keeps ``jax.lax.top_k``'s order: among equal
    probabilities the lower expert index first, as on the CPU."""
    from repro_torch.models import moe

    probs = torch.from_numpy(np.random.default_rng(0).integers(0, 3, (4096, 16))
                             .astype(np.float32) / 3).to(dtype)
    for k in (1, 2, 4):
        vals, idx = moe.top_k(probs.to(card), k)
        cvals, cidx = moe.top_k(probs, k)
        assert torch.equal(idx.cpu(), cidx) and torch.equal(vals.cpu(), cvals)
        # equal values come in index order
        ties = vals[:, 1:] == vals[:, :-1]
        assert bool((idx[:, 1:] > idx[:, :-1])[ties].all())


# -- the serving pool on the card (server/batch.py, server/pool.py) ------------

def _spd_lanes(d, T, dtype, seed=0):
    """T solve operands (L, G, h, sigma) on the card: one Gram, T sigmas."""
    A = _randn((d + 8, d), torch.float64, seed).to("cuda")
    G = (A.T @ A / (d + 8) + 0.5 * torch.eye(d, device="cuda", dtype=torch.float64)
         ).to(dtype)
    lanes = []
    for i in range(T):
        sigma = 0.01 * (i + 1)
        h = _randn((d,), dtype, seed + 1 + i).to("cuda")
        L = torch.linalg.cholesky(G + sigma * torch.eye(d, device="cuda", dtype=dtype))
        lanes.append((L, G, h, sigma))
    return lanes


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("T", [1, 3, 8, 16])
@pytest.mark.parametrize("d", [256, 1024, 4096])
def test_stacked_lane_equals_lone_solve(card, d, T, dtype):
    lanes = _spd_lanes(d, T, dtype)
    ws = server.solve_stacked(lanes)
    for ops, w in zip(lanes, ws):
        assert torch.equal(w, server.solve_snapshot(*ops))
    assert _rel(ws[-1], torch.linalg.solve(
        lanes[-1][1].double() + lanes[-1][3] * torch.eye(d, device=card, dtype=torch.float64),
        lanes[-1][2].double())) <= (1e-4 if dtype == torch.float32 else 1e-10)


def _card_pool(d=128, tenants=3, seed=0, **kw):
    """A pool on the card (its default device) of ``tenants`` dense tenants,
    two clients of 300 rows each."""
    rng = np.random.default_rng(seed)
    pool = server.EnginePool(**kw)
    for t in range(tenants):
        stats = [core.compute_stats(
            torch.from_numpy(rng.standard_normal((300, d)).astype(np.float32)).cuda(),
            torch.from_numpy(rng.standard_normal(300).astype(np.float32)).cuda())
            for _ in range(2)]
        pool.create_tenant(f"t{t}", clients=stats, placement="dense")
    return pool


@pytest.mark.parametrize("kind,d_orig", [("sketch", 200), ("rff", 24)])
def test_feature_tenant_rides_the_dense_bucket(card, kind, d_orig):
    m = 96
    pool = _card_pool(d=m, tenants=2)
    fm = core.FeatureMap(kind, 5, d_orig, m, 4.0)
    rng = np.random.default_rng(3)
    uploads = [PackedStats.pack(fm.stats(
        torch.from_numpy(rng.standard_normal((400, d_orig)).astype(np.float32)).to(card),
        torch.from_numpy(rng.standard_normal(400).astype(np.float32)).to(card)))
        for _ in range(3)]
    pool.create_tenant("f", payloads=uploads, features=fm)
    reqs = [(n, s) for n in ("t0", "f", "t1") for s in (0.01, 0.5)]
    lone = [pool.solve_lifted(n, s) for n, s in reqs]
    sweeps = pool.batched_sweeps
    many = pool.solve_many(reqs, lifted=True)
    assert pool.batched_sweeps == sweeps + 1
    for (n, s), a, b in zip(reqs, lone, many):
        assert torch.equal(a, b), (n, s)
    assert many[2].shape == ((d_orig,) if kind == "sketch" else (m,))


def test_solve_batcher_bitwise_under_threads(card):
    import threading

    pool = _card_pool(d=512, tenants=4)
    reqs = [(f"t{t}", s) for t in range(4) for s in (0.01, 0.1, 1.0, 10.0)]
    lone = {r: pool.solve(*r).cpu() for r in reqs}
    out, errors = {}, []
    with server.SolveBatcher(pool, window_s=0.002, lifted=False) as batcher:
        def ask(i):
            try:
                for j in range(16):
                    r = reqs[(i * 5 + j) % len(reqs)]
                    out[(i, j)] = (r, batcher.solve(*r).cpu())
            except Exception as e:    # pragma: no cover - surfaced below
                errors.append(repr(e))

        threads = [threading.Thread(target=ask, args=(i,)) for i in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
            assert not t.is_alive()
        summary = batcher.summary()
    assert not errors, errors
    assert len(out) == 128 and summary["requests"] == 128
    for r, w in out.values():
        assert torch.equal(w, lone[r]), r
    pool.close()


def _streaming_pool(staleness):
    pool = _card_pool(d=320, tenants=1, default_coalesce=server.CoalescerPolicy(
        max_rank=64, max_staleness_s=staleness))
    for s in (0.01, 1.0):
        pool.solve("t0", s)
    return pool


def test_flusher_thread_update_equals_caller_thread(card):
    """The same rank-16 flush (P, then K2's panel entry, a panel) run by the
    pool's flusher thread and by the caller leaves the same factor bits."""
    import time

    rows = _randn((16, 320), seed=7).to(card), _randn((16,), seed=8).to(card)
    caller, flusher = _streaming_pool(float("inf")), _streaming_pool(0.02)
    caller.ingest_rows_async("t0", *rows)
    caller.flush("t0")
    before = gram.launch_counts()
    flusher.start_flusher()
    try:
        flusher.ingest_rows_async("t0", *rows)
        deadline = time.monotonic() + 10
        while flusher.pending_deltas and time.monotonic() < deadline:
            time.sleep(0.005)
    finally:
        flusher.close()
    torch.cuda.synchronize()
    assert flusher.pending_deltas == 0
    assert flusher.tenant("t0").background_flushes == 1
    after = gram.launch_counts()
    assert after["panel_transform"] > before["panel_transform"]
    assert after["gemm_nt"] > before["gemm_nt"]
    for s in (0.01, 1.0):
        a = caller.get("t0")._factors[s].factor
        b = flusher.get("t0")._factors[s].factor
        assert torch.equal(a, b)
        assert torch.equal(caller.solve("t0", s), flusher.solve("t0", s))
    assert caller.get("t0").incremental_updates == flusher.get("t0").incremental_updates == 2


def test_snapshot_survives_a_flush_on_card(card):
    pool = _streaming_pool(float("inf"))
    eng = pool.get("t0")
    factor = eng.factor(0.01)
    ops = eng.backend.solve_operands(factor, 0.01)
    copies = [o.clone() for o in ops[:3]]
    w0 = server.solve_snapshot(*ops)
    pool.ingest_rows_async("t0", _randn((16, 320), seed=9).to(card),
                           _randn((16,), seed=10).to(card))
    pool.flush("t0")
    assert eng.flush_ranks == {16: 1}
    assert not torch.equal(eng.factor(0.01), factor)
    assert all(torch.equal(o, c) for o, c in zip(ops, copies))
    assert torch.equal(server.solve_snapshot(*ops), w0)


# -- the wire (fed.wire, fed.transport, fed.chaos) into a pool on the card ----

def _wire_stats(d, seed, device):
    rng = np.random.default_rng(seed)
    A = torch.from_numpy(rng.standard_normal((200, d)).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal(200).astype(np.float32))
    return core.compute_stats(A.to(device), b.to(device))


def _rounded(stats, offer):
    if offer != "bf16":
        return stats
    p = PackedStats.pack(stats)
    return PackedStats(p.tri.to(torch.bfloat16).float(),
                       p.moment.to(torch.bfloat16).float(), p.count,
                       p.dim).unpack()


@pytest.mark.parametrize("d", [64, 300])
@pytest.mark.parametrize("offer", ["f32", "bf16"])
@pytest.mark.parametrize("chunk", [None, 4096])
def test_wire_stats_over_tcp_fuse_to_in_process_bits(card, d, offer, chunk):
    """STATS frames (K1 on the client) over sockets into a pool on the card
    fuse to the bits of in-process admission of the same statistics in the
    same order, with and without chunking; the served solve is that pool's."""
    from repro_torch.fed import transport

    stats = [_wire_stats(d, i, card) for i in range(4)]
    with server.EnginePool() as pool, transport.FrameServer(pool) as srv:
        client = transport.ResilientClient(
            lambda: transport.TCPChannel(srv.host, srv.port), tenant="t",
            offers=(offer,), max_chunk_payload=chunk)
        for i, s in enumerate(stats):
            assert client.upload_stats(s, client_id=f"c{i}", moments=i == 1).ok
        w = client.solve(0.01)
        client.close()
        assert srv.dispatcher.summary()["internal_errors"] == 0
        with server.EnginePool() as ref:
            ref.create_tenant("t", dim=d)
            for i, s in enumerate(stats):
                ref.ingest("t", _rounded(s, offer), client_id=f"c{i}")
            for a, b in ((pool.stats("t").gram, ref.stats("t").gram),
                         (pool.stats("t").moment, ref.stats("t").moment)):
                assert a.is_cuda and torch.equal(a, b)
            assert np.array_equal(w, ref.solve_lifted("t", 0.01).cpu().numpy())


def test_wire_rows_and_control_on_card_match_cpu_path(card):
    """STATS, single-row DELTA frames (K1 each; a rank-1 update of the
    cached factor) and a CONTROL drop / restore (a blocked rank-160 down-
    and update: P and K2) on the card match the same frames on the CPU:
    integer rows keep the statistics bitwise, solves within 1e-5."""
    from repro_torch.fed import transport, wire

    rng = np.random.default_rng(4)
    d = 160
    frames = [wire.encode_frame(wire.StatsFrame.from_stats(
        _wire_stats(d, 10 + i, "cpu"), client_id=f"c{i}")) for i in range(3)]
    for k in range(16):
        A = rng.integers(-3, 4, (1, d)).astype(np.float32)
        b = rng.integers(-3, 4, 1).astype(np.float32)
        frames.append(wire.encode_frame(wire.DeltaRowsFrame(A=A, b=b,
                                                            client_id="s")))
    frames += [wire.encode_frame(wire.ControlFrame("drop", "c1")),
               wire.encode_frame(wire.ControlFrame("restore", "c1"))]
    pools = {dev: server.EnginePool(device=dev) for dev in ("cuda", "cpu")}
    for dev, pool in pools.items():
        session = transport.WireDispatcher(pool).session()
        session.handle(wire.encode_frame(wire.Hello("t")))
        pool.create_tenant("t", dim=d, max_update_rank=2 * d)
        for raw in frames[:3]:
            assert wire.decode_frame(session.handle(raw)).ok
        pool.solve("t", 0.01)
        if dev == "cuda":
            before = gram.launch_counts()
        for raw in frames[3:]:
            assert wire.decode_frame(session.handle(raw)).ok
        if dev == "cuda":
            torch.cuda.synchronize()
            after = gram.launch_counts()
    assert after["gram_moment"] == before["gram_moment"] + 16
    assert after["panel_transform"] > before["panel_transform"]
    assert after["gemm_nt"] > before["gemm_nt"]
    gpu, cpu = pools["cuda"], pools["cpu"]
    assert torch.equal(gpu.stats("t").gram.cpu(), cpu.stats("t").gram)
    assert gpu.get("t").incremental_updates == cpu.get("t").incremental_updates
    assert _rel(gpu.solve("t", 0.01), cpu.solve("t", 0.01)) <= 1e-5
    assert gpu.ledger() == cpu.ledger()
    for p in pools.values():
        p.close()


@pytest.mark.parametrize("kind", ["sketch", "rff"])
def test_wire_feature_frames_on_card(card, kind):
    """PROJ / RFF frames (K3 / K4 on the client) admit into a pool on the
    card under the map's hash and serve the in-process feature tenant's
    weights."""
    from repro_torch.fed import transport

    d_orig, m, seed = (300, 64, 3) if kind == "sketch" else (24, 128, 4)
    fm = core.FeatureMap(kind, seed, d_orig, m, 2.0 if kind == "rff" else 1.0)
    rng = np.random.default_rng(5)
    packed = [PackedStats.pack(fm.stats(
        torch.from_numpy(rng.standard_normal((500, d_orig)).astype(np.float32)).to(card),
        torch.from_numpy(rng.standard_normal(500).astype(np.float32)).to(card)))
        for _ in range(3)]
    with server.EnginePool() as pool:
        c = transport.FrameClient(transport.LoopbackChannel(
            transport.WireDispatcher(pool)))
        c.hello("f")
        for i, p in enumerate(packed):
            if kind == "sketch":
                c.upload_projected(p, d_orig=d_orig, seed=seed, rhash=fm.fhash,
                                   client_id=f"p{i}")
            else:
                c.upload_rff(p, d_orig=d_orig, seed=seed, fhash=fm.fhash,
                             lengthscale=2.0, client_id=f"p{i}")
        w = c.solve(0.1)
        with server.EnginePool() as ref:
            ref.create_tenant("f", payloads=packed, features=fm)
            assert torch.equal(pool.stats("f").gram, ref.stats("f").gram)
            assert np.array_equal(w, ref.solve_lifted("f", 0.1).cpu().numpy())


def test_wire_chaos_proxy_fuses_each_upload_once_on_card(card):
    """Every fault at 10% between resilient clients and a server whose pool
    is on the card: the fused statistics are the bits of a clean pool."""
    from repro_torch.fed import chaos, transport

    stats = [_wire_stats(96, 20 + i, card) for i in range(6)]
    sched = chaos.ChaosSchedule(chaos.ChaosConfig.uniform(0.1, delay_s=0.001),
                                seed=7)
    with server.EnginePool() as pool, transport.FrameServer(pool) as srv, \
            chaos.ChaosProxy(srv.host, srv.port, sched, timeout_s=10.0) as px:
        for i, s in enumerate(stats):
            client = transport.ResilientClient(
                lambda: transport.TCPChannel(px.host, px.port, timeout_s=10.0),
                tenant="t", retries=80, backoff_s=0.001, seed=i)
            assert client.upload_stats(s, client_id=f"c{i}").ok
            client.close()
        with server.EnginePool() as clean:
            clean.create_tenant("t", dim=96)
            for i, s in enumerate(stats):
                clean.ingest("t", s, client_id=f"c{i}")
            assert torch.equal(pool.stats("t").gram, clean.stats("t").gram)
            assert torch.equal(pool.stats("t").moment, clean.stats("t").moment)
        assert pool.get("t").count == 6 * 200
        assert sched.requests > 6


# -- durability (server.durability) and processes on the card -----------------

@pytest.mark.parametrize("snapshot_every", [None, 2])
def test_journaled_pool_on_card_restores_bitwise(card, tmp_path, snapshot_every):
    """A journaled pool on the card, crashed (its journal closed, no final
    snapshot) after STATS and DELTA frames (K1) and a drop / restore (P and
    K2), restarts on the card into a pool whose solve equals the
    uncrashed pool's bitwise; a clean close then replays nothing."""
    from repro_torch.fed import wire

    d = 160
    rng = np.random.default_rng(6)
    frames = [wire.encode_frame(wire.StatsFrame.from_stats(
        _wire_stats(d, 30 + i, "cpu"), client_id=f"c{i}")) for i in range(3)]
    for _ in range(6):
        A = rng.integers(-3, 4, (2, d)).astype(np.float32)
        b = rng.integers(-3, 4, 2).astype(np.float32)
        frames.append(wire.encode_frame(wire.DeltaRowsFrame(A=A, b=b,
                                                            client_id="s")))
    frames += [wire.encode_frame(wire.ControlFrame("drop", "c1")),
               wire.encode_frame(wire.ControlFrame("restore", "c1"))]

    def feed(pool):
        for raw in frames:
            assert pool.admit_frame("t", wire.decode_frame(raw),
                                    encoded_len=len(raw), raw=raw).ok

    ref = server.EnginePool()
    feed(ref)
    p1 = server.EnginePool(journal_dir=tmp_path, snapshot_every=snapshot_every)
    feed(p1)
    p1._journal.close()
    p1._closed = True
    before = gram.launch_counts()
    p2 = server.EnginePool(journal_dir=tmp_path)
    torch.cuda.synchronize()
    replayed = gram.launch_counts()["gram_moment"] - before["gram_moment"]
    assert p2.stats("t").gram.is_cuda
    n = p2.replayed_frames
    assert n == len(frames) % (snapshot_every or len(frames) + 1)
    assert replayed == sum(raw[5] == wire.FT_DELTA for raw in frames[len(frames) - n:])
    assert torch.equal(p2.stats("t").gram, ref.stats("t").gram)
    assert torch.equal(p2.solve("t", 0.01), ref.solve("t", 0.01))
    p2.close()
    p3 = server.EnginePool(journal_dir=tmp_path)
    assert p3.replayed_frames == 0 and p3.restored_tenants == 1
    assert torch.equal(p3.solve("t", 0.01), ref.solve("t", 0.01))
    p3.close()
    ref.close()


def test_client_process_on_card_uploads_to_server_on_card(card, tmp_path):
    """``python -m repro_torch.launch.serve --listen`` and
    ``python -m repro_torch.launch.client``, both on the card: the report's
    weights are the ones the client received, and a float64 solve of the
    clients' rows (drawn here by the same generator on the card) agrees."""
    import json
    import os
    import pathlib
    import re
    import subprocess
    import sys

    from repro_torch.core import fusion
    from repro_torch.data import synthetic

    repo = pathlib.Path(__file__).resolve().parents[1]
    env = dict(os.environ, PYTHONPATH=str(repo / "src"))
    srv = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.serve", "--mode", "fusion",
         "--listen", "0", "--expect-uploads", "2", "--serve-timeout", "240",
         "--sigma", "0.01", "--journal-dir", str(tmp_path)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
    try:
        port = None
        for _ in range(20):
            m = re.search(r"listening on 127\.0\.0\.1:(\d+)",
                          srv.stdout.readline())
            if m:
                port = int(m.group(1))
                break
        assert port is not None
        reps = []
        for k, extra in ((0, ["--moments"]), (1, ["--solve", "0.01"])):
            cl = subprocess.run(
                [sys.executable, "-m", "repro_torch.launch.client",
                 "--connect", f"127.0.0.1:{port}", "--tenant", "t",
                 "--num-clients", "2", "--client-index", str(k),
                 "--samples", "4096", "--dim", "256", *extra],
                capture_output=True, text=True, env=env, timeout=240)
            assert cl.returncode == 0, cl.stderr
            reps.append(json.loads(cl.stdout.strip().splitlines()[-1]))
        out, err = srv.communicate(timeout=240)
    finally:
        if srv.poll() is None:
            srv.kill()
            srv.communicate(timeout=30)
    assert srv.returncode == 0, err
    report = json.loads(re.search(r"\[serve_wire\] report (.*)", out).group(1))
    assert report["ledger"]["wire_upload_bytes"] == sum(
        r["bytes_uploaded"] for r in reps)
    assert reps[1]["solve"]["weights"] == report["weights"]["t"]
    ds = synthetic.generate(0, num_clients=2, samples_per_client=4096, dim=256)
    stats = [core.compute_stats(A.double().cpu(), b.double().cpu())
             for A, b in ds.clients]
    ref = fusion.solve_ridge(stats[0] + stats[1], 0.01)
    assert _rel(torch.tensor(report["weights"]["t"]), ref) <= 1e-4


# -- the relay tier (server.relay) on the card ----------------------------------

@pytest.mark.parametrize("feature", [None, "rff"])
def test_two_tier_forward_on_card_is_the_relays_fused_stats(card, tmp_path,
                                                           feature):
    """A journaled relay pool on the card (STATS frames, then DELTA rows
    through K1; an rff tenant's RFF frames) forwards into a root pool on
    the card: one forward leaves the root's fused (G, h) bitwise the
    relay's, and with small-integer rows a second epoch telescopes to the
    relay's again, bitwise. The forward's ``now`` is a host copy."""
    from repro_torch.fed import transport, wire
    from repro_torch.server.relay import ForwardPolicy, RelayForwarder

    d = 96
    rng = np.random.default_rng(7)
    fm = (None if feature is None
          else core.FeatureMap("rff", seed=5, d_orig=d, m=128, lengthscale=9.0))

    def rows(n):
        return (torch.from_numpy(rng.integers(-3, 4, (n, d)).astype(np.float32)),
                torch.from_numpy(rng.integers(-3, 4, n).astype(np.float32)))

    def frame(k):
        A, b = rows(64)
        if fm is None:
            return wire.StatsFrame.from_stats(core.compute_stats(A.to(card), b.to(card)),
                                              client_id=f"c{k}", moments=True)
        p = PackedStats.pack(fm.stats(A.to(card), b.to(card)))
        return wire.RFFFrame(tri=wire.host_array(p.tri), moment=wire.host_array(p.moment),
                             count=int(p.count), dim=int(p.dim), d_orig=d, seed=fm.seed,
                             fhash=fm.fhash, lengthscale=fm.lengthscale, client_id=f"c{k}")

    def send(disp, frames):
        for f in frames:
            raw = wire.encode_frame(f)
            c = transport.FrameClient(transport.LoopbackChannel(disp))
            c.hello("t")
            assert c.upload_raw(raw).ok

    root = server.EnginePool()
    relay = server.EnginePool(journal_dir=tmp_path, tier="relay")
    rdisp = transport.WireDispatcher(relay)
    fwd = RelayForwarder(relay, lambda: transport.LoopbackChannel(
        transport.WireDispatcher(root)), relay_id="r0",
        state_dir=tmp_path / "relay_state", policy=ForwardPolicy(max_frames=None))
    send(rdisp, [frame(k) for k in range(3)])
    assert fwd.forward_all() == 1
    for field in ("gram", "moment"):
        assert torch.equal(getattr(root.stats("t"), field),
                           getattr(relay.stats("t"), field))
        host = fwd._state("t").last[field]
        assert isinstance(host, np.ndarray)
        assert host.tobytes() == getattr(relay.stats("t"), field).cpu().numpy().tobytes()
    assert root.stats("t").gram.is_cuda
    if fm is None:
        A, b = rows(40)
        send(rdisp, [wire.DeltaRowsFrame(A=A.numpy(), b=b.numpy(), client_id="s")])
    else:
        send(rdisp, [frame(9)])
    assert fwd.forward_all() == 1
    assert torch.equal(root.stats("t").gram, relay.stats("t").gram)
    assert torch.equal(root.stats("t").moment, relay.stats("t").moment)
    assert root.ledger()["by_tier"] == {"relay_frames": 2, "client_frames": 0}
    fwd.close(forward=False)
    relay.close()
    root.close()


def _dp_dataset(card, d=48, K=4, n=200):
    from repro_torch import data

    ds = data.synthetic.generate(5, num_clients=K, samples_per_client=n, dim=d,
                                 device="cpu")
    on = dataclasses.replace(ds, clients=tuple((A.to(card), b.to(card))
                                               for A, b in ds.clients),
                             test_A=ds.test_A.to(card), test_b=ds.test_b.to(card),
                             w_star=ds.w_star.to(card))
    return ds, on


@pytest.mark.parametrize("eps", [0.05, 5.0])
def test_dp_run_one_shot_on_card_matches_cpu_path(card, eps):
    """Algorithm 2 on the card: K1 on the clipped rows plus the host-drawn
    noise, fused as on the CPU (K1's tolerance); the repair is psd_repair
    of the unrepaired run's fused Gram, bitwise on the card."""
    from repro_torch import fed
    from repro_torch.core import privacy, threefry

    cpu_ds, ds = _dp_dataset(card)
    before = gram.gram_moment_cuda.launches
    raw = fed.run_one_shot(ds, 0.01, dp=(eps, 1e-5), dp_key=threefry.key(7))
    assert gram.gram_moment_cuda.launches == before + 4
    rep = fed.run_one_shot(ds, 0.01, dp=(eps, 1e-5), dp_key=threefry.key(7),
                           psd_repair=True)
    cpu = fed.run_one_shot(cpu_ds, 0.01, dp=(eps, 1e-5), dp_key=threefry.key(7))
    G, Gc = raw.extras["fused_stats"].gram, cpu.extras["fused_stats"].gram
    assert G.is_cuda and _rel(G, Gc) <= 1e-5
    assert _rel(raw.extras["fused_stats"].moment, cpu.extras["fused_stats"].moment) <= 1e-5
    assert torch.equal(rep.extras["fused_stats"].gram, privacy.psd_repair(
        raw.extras["fused_stats"]).gram)
    assert torch.isfinite(rep.weights).all()
    lam = torch.linalg.eigvalsh(rep.extras["fused_stats"].gram.double())
    assert float(lam[0]) >= -1e-4 * float(lam[-1])


def test_psd_guard_on_card_matches_run_one_shot(card):
    """The pool's Remark-4 guard on the card fires once and leaves the
    fused stats of ``run_one_shot(psd_repair=True)``, bitwise."""
    from repro_torch import fed
    from repro_torch.core import threefry

    _, ds = _dp_dataset(card)
    key = threefry.key(7)
    rep = fed.run_one_shot(ds, 0.01, dp=(0.05, 1e-5), dp_key=key, psd_repair=True)
    uploads = fed.client_phase(ds, dp=(0.05, 1e-5), dp_key=key)
    pool = server.EnginePool()
    pool.create_tenant("dp", payloads=uploads, placement="dense", psd_guard=True)
    clean = server.EnginePool()
    clean.create_tenant("clean", payloads=fed.client_phase(ds), placement="dense",
                        psd_guard=True)
    t = pool.tenant("dp")
    assert t.psd_repairs == 1 and t.guard_min_eig < 0
    assert clean.tenant("clean").psd_repairs == 0
    assert pool.summary()["psd_repairs"] == 1
    assert torch.equal(pool.get("dp").stats.gram, rep.extras["fused_stats"].gram)
    assert torch.equal(pool.solve("dp", 0.01), rep.weights)


@pytest.mark.parametrize("iters", [5, 100])
def test_solve_cg_on_card_matches_cpu_path(card, iters):
    A, b = _randn((600, 96)), _randn((600,), seed=1)
    s = core.compute_stats(A, b)
    sc = core.SuffStats(s.gram.to(card), s.moment.to(card), s.count.to(card))
    w = core.solve_cg(sc, 0.5, iters=iters)
    assert w.is_cuda
    assert _rel(w, core.solve_cg(s, 0.5, iters=iters)) <= 1e-5


@pytest.mark.parametrize("kw", [{}, {"prox_mu": 0.01}, {"sample_fraction": 0.5},
                                {"dp_eps": 5.0}])
def test_run_iterative_on_card_matches_cpu_path(card, kw):
    from repro_torch import fed

    cpu_ds, ds = _dp_dataset(card, d=32, K=6, n=100)
    cfg = fed.IterativeConfig(rounds=30, **kw)
    res = fed.run_iterative(ds, cfg, track_history=True)
    ref = fed.run_iterative(cpu_ds, cfg, track_history=True)
    assert res.weights.is_cuda and res.extras["history"].shape == (30, 32)
    assert _rel(res.weights, ref.weights) <= 1e-4
    assert _rel(res.extras["history"], ref.extras["history"]) <= 1e-4


@pytest.mark.parametrize("targets", [(), (3,)])
def test_one_shot_probe_on_card_matches_cpu_path(card, targets):
    X, Y = _randn((300, 64)), _randn((300, *targets), seed=2)
    res = core.one_shot_probe(torch.tanh, X.to(card), Y.to(card), sigma=0.1)
    ref = core.one_shot_probe(torch.tanh, X, Y, sigma=0.1)
    assert res.weights.is_cuda and res.weights.shape == ref.weights.shape
    assert _rel(res.weights, ref.weights) <= 1e-5


# -- the sharded backend on a (4, 2) mesh of the card ---------------------------

def _card_mesh(card, n=8):
    from repro_torch.launch import mesh as mesh_lib

    return mesh_lib.make_device_mesh(n, device=card)


@pytest.mark.parametrize("d,bs", [(100, None), (300, 32), (256, 64)])
def test_sharded_engine_on_card_matches_cpu_path(card, d, bs):
    """Factor, solve, a rank-r update, drop and restore on the card's mesh
    (K2 at the SYRK / TRSM / trailing sites, P on the tiles) against the
    same calls on a CPU mesh and against float64."""
    from repro_torch.launch import mesh as mesh_lib

    A, b = _randn((4 * d + 48, d)), _randn((4 * d + 48,), seed=1)
    # one large client and three of 16 rows (a drop is a rank-16 downdate)
    cuts = [0, 4 * d, 4 * d + 16, 4 * d + 32, 4 * d + 48]
    stats = {k: core.compute_stats(A[cuts[k]:cuts[k + 1]], b[cuts[k]:cuts[k + 1]])
             for k in range(4)}
    out = {}
    for dev, mesh in (("cpu", mesh_lib.make_cpu_mesh(8)), ("card", _card_mesh(card))):
        on = {k: core.SuffStats(s.gram.to(mesh.distinct_devices[0]),
                                s.moment.to(mesh.distinct_devices[0]),
                                s.count.to(mesh.distinct_devices[0]))
              for k, s in stats.items()}
        eng = server.FusionEngine.from_clients(
            on, backend=server.ShardedBackend(d, mesh, block_size=bs),
            max_update_rank=d)
        gram.reset_launch_counts()
        w0 = eng.solve(0.1)
        k2_factor = gram.launch_counts()["gemm_nt"]
        rows = _randn((24, d), seed=3).to(mesh.distinct_devices[0])
        eng.ingest_rows(rows, rows[:, 0].clone())
        w1 = eng.solve(0.1)
        eng.drop(2)
        w2 = eng.solve(0.1)
        launches = gram.launch_counts()
        # the factor the updates left behind, held itself
        L = torch.tril(eng.factor(0.1).L.full()).double()
        Gs = eng.backend.gram.full().double()
        Gs.diagonal().add_(0.1)
        assert float(torch.linalg.norm(L @ L.T - Gs) / torch.linalg.norm(Gs)) <= 1e-5
        out[dev] = (w0, w1, w2, eng.stats, k2_factor, launches,
                    eng.cold_factorizations)
    for i in range(3):
        assert _rel(out["card"][i], out["cpu"][i]) <= 1e-4
    G, h = out["card"][3].gram.double(), out["card"][3].moment.double()
    w64 = torch.linalg.solve(G + 0.1 * torch.eye(d, dtype=G.dtype, device=G.device), h)
    assert _rel(out["card"][2], w64) <= 1e-5
    assert out["card"][4] > 0 and out["cpu"][4] == 0
    assert out["card"][5]["panel_transform"] > 0
    assert out["card"][6] == out["cpu"][6] == 1      # no refactorization


@pytest.mark.parametrize("bs,r", [(64, 1), (128, 16), (256, 64), (256, 200)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_composed_panel_transform_on_card(card, bs, r, dtype):
    from repro_torch.server.distributed import composed_panel_transform

    W = _randn((bs, 2 * bs), dtype=torch.float64)
    L = torch.linalg.cholesky(W @ W.T / bs + torch.eye(bs, dtype=torch.float64))
    L, X = L.to(dtype).to(card).contiguous(), _randn((r, bs), dtype, seed=4).to(card)
    gram.reset_launch_counts()
    La, Ta = composed_panel_transform(L, X, sign=1.0)
    c = gram.launch_counts()
    assert c["panel_transform"] == bs // 32 and c["gemm_nt"] == 2 * (bs // 32 - 1)
    Lb, Tb = cholesky.panel_transform_ref(L.cpu(), X.cpu(), sign=1.0)
    tol = 1e-4 if dtype == torch.float32 else 1e-10
    assert _rel(torch.tril(La), torch.tril(Lb)) <= tol
    assert _rel(Ta, Tb) <= tol


def test_fuse_distributed_and_probe_on_card_mesh(card):
    from repro_torch.core import probe

    mesh = _card_mesh(card)
    A, b = _randn((512, 48)), _randn((512,), seed=1)
    be = server.ShardedBackend(48, mesh)
    eng = server.FusionEngine(48, backend=be, device=card)
    gram.reset_launch_counts()
    eng.ingest_distributed(A.to(card), b.to(card), participation=[1, 0, 1, 1])
    assert gram.launch_counts()["gram_moment"] == 4
    keep = torch.cat([torch.arange(0, 128), torch.arange(256, 512)])
    ref = core.compute_stats(A[keep], b[keep])
    assert eng.count == 384
    assert _rel(be.stats().gram, ref.gram) <= 1e-5
    s = core.distributed_stats(A.to(card), b.to(card), mesh)
    assert s.gram.is_cuda and _rel(s.gram, core.compute_stats(A, b).gram) <= 1e-5
    W = _randn((48, 16), seed=5)
    r = probe.one_shot_probe(lambda x: torch.tanh(x @ W.to(x.device)), A.to(card),
                             b.to(card), sigma=0.1, mesh=mesh)
    r0 = probe.one_shot_probe(lambda x: torch.tanh(x @ W), A, b, sigma=0.1)
    assert r.weights.is_cuda and _rel(r.weights, r0.weights) <= 1e-4


def test_sharded_pool_on_card_restores_bitwise(card, tmp_path):
    """A sharded tenant on the pool's card mesh, journaled: the restored
    pool's solves equal the never-crashed pool's, bitwise."""
    from repro_torch.fed import wire

    pool = server.EnginePool(device=card, journal_dir=str(tmp_path))
    raws = []
    for k in range(3):
        A, b = _randn((64, 40), seed=10 + k), _randn((64,), seed=20 + k)
        frame = wire.StatsFrame.from_stats(core.compute_stats(A, b), client_id=f"c{k}")
        raws.append(wire.encode_frame(frame, dtype="f32"))
    for raw in raws:
        assert pool.admit_frame("s", wire.decode_frame(raw), encoded_len=len(raw),
                                placement="sharded", raw=raw).ok
    w = pool.solve("s", 0.1)
    assert pool.tenant("s").backend_name == "sharded" and pool.meshes_built == 1
    assert pool.get("s").backend.mesh.distinct_devices == [torch.device("cuda", 0)]
    pool.close()
    back = server.EnginePool(device=card, journal_dir=str(tmp_path))
    assert back.tenant("s").backend_name == "sharded"
    assert torch.equal(back.solve("s", 0.1), w)
    back.close()


# --- training (K5's forward with the port's backward) --------------------------

@pytest.mark.parametrize("S,H,Hkv,hd,window,causal", [
    (300, 4, 1, 128, None, True), (520, 4, 2, 64, 100, True), (257, 2, 2, 80, None, False)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_swa_attention_grad_on_card(card, S, H, Hkv, hd, window, causal, dtype):
    """dq, dk, dv of ``ops.swa_attention`` (K5 forward, then
    ``ref.swa_attention_bwd``) against autograd through the plain forward on
    the same card tensors: float32 within 1e-5, bf16 within 1e-2 of each
    gradient's largest magnitude; K5 launched once."""
    q, k, v, do = (_randn(shape, dtype, seed=i).to(card) for i, shape in enumerate(
        ((2, S, H, hd), (2, S, Hkv, hd), (2, S, Hkv, hd), (2, S, H, hd))))
    kernel = [t.clone().requires_grad_(True) for t in (q, k, v)]
    before = gram.swa_flash_cuda.launches
    ops.swa_attention(*kernel, window=window, causal=causal).backward(do)
    assert gram.swa_flash_cuda.launches == before + 1
    plain = [t.clone().requires_grad_(True) for t in (q, k, v)]
    ref.swa_attention_ref(*plain, window=window, causal=causal).backward(do)
    tol = 1e-5 if dtype == torch.float32 else 1e-2
    for a, b in zip(kernel, plain):
        assert a.grad.dtype == dtype
        assert _rel(a.grad, b.grad) <= tol


def _yi_pair(card, dtype="float32"):
    from repro_torch import configs
    from repro_torch.models import model

    cfg = dataclasses.replace(configs.get_reduced("yi-9b"), dtype=dtype)
    cpu = model.init_params(cfg, generator=torch.Generator().manual_seed(0), device="cpu")
    gpu = model.init_params(cfg, generator=torch.Generator().manual_seed(0),
                            device="cpu").to(card)
    return cfg, cpu, gpu


def test_reduced_yi_loss_and_grads_on_card_match_cpu_path(card):
    from repro_torch.launch import train
    from repro_torch.models import model

    cfg, cpu, gpu = _yi_pair(card)
    batch = train.make_pipeline(cfg, 2, 128, 0, device="cpu").batch(0)
    out = {}
    before = gram.swa_flash_cuda.launches
    for name, lm, b in (("cpu", cpu, batch),
                        ("gpu", gpu, {k: t.to(card) for k, t in batch.items()})):
        for p in lm.parameters():
            p.requires_grad_(True)
        loss = model.loss_fn(lm, b, remat=True)
        loss.backward()
        out[name] = (float(loss), {n: p.grad.cpu() for n, p in lm.named_parameters()})
    # remat: each attention layer's forward runs twice on the card
    assert gram.swa_flash_cuda.launches == before + 2 * cfg.num_layers
    assert abs(out["gpu"][0] - out["cpu"][0]) <= 1e-4
    for n, g in out["cpu"][1].items():
        assert _rel(out["gpu"][1][n], g) <= 1e-4, n


@pytest.mark.parametrize("remat,per_layer", [(True, 2), (False, 1)])
def test_train_step_k5_launches_on_card(card, remat, per_layer):
    from repro_torch.launch import train
    from repro_torch.models import model
    from repro_torch.optim import adamw

    cfg, _, gpu = _yi_pair(card, "bfloat16")
    state = adamw.init(gpu)
    step = model.make_train_step(cfg, adamw.AdamWConfig(warmup_steps=1), remat=remat)
    pipe = train.make_pipeline(cfg, 2, 128, 0, device=card)
    gram.reset_launch_counts()
    losses = [float(step(gpu, state, pipe.batch(i))) for i in range(3)]
    counts = gram.launch_counts()
    assert counts["swa_flash"] == 3 * per_layer * cfg.num_layers
    assert all(n == 0 for k, n in counts.items() if k != "swa_flash")
    assert all(np.isfinite(losses))
    assert not any(p.requires_grad or p.grad is not None for p in gpu.parameters())


def test_adamw_step_on_card_matches_cpu_path(card):
    """One AdamW step from the same bf16 weights on the same gradients, on
    the card and on the CPU: master, m and v within 1e-6 of each tensor's
    largest magnitude, the bf16 parameters within one bf16 ulp."""
    from repro_torch.optim import adamw

    _, cpu, gpu = _yi_pair(card, "bfloat16")
    cfg = adamw.AdamWConfig(warmup_steps=3, total_steps=20)
    sc, sg = adamw.init(cpu), adamw.init(gpu)
    grads = {n: _randn(p.shape, seed=i).mul(1e-2).bfloat16()
             for i, (n, p) in enumerate(cpu.named_parameters())}
    for _ in range(2):
        adamw.apply(cpu, grads, sc, cfg)
        adamw.apply(gpu, {n: g.to(card) for n, g in grads.items()}, sg, cfg)
    assert int(sg["count"]) == int(sc["count"]) == 2
    for key in ("master", "m", "v"):
        for n, t in sc[key].items():
            assert _rel(sg[key][n], t) <= 1e-6, (key, n)
    for (n, pg), pc in zip(gpu.named_parameters(), cpu.parameters()):
        diff = (pg.cpu().float() - pc.float()).abs()
        assert bool((diff <= 2.0 ** -7 * pc.float().abs()).all()), n


def test_psum_scatter_places_each_slice_on_its_shard(card):
    """A two-shard mesh with one shard on the card and one on the host: the
    reduce-scatter leaves slice i of the sum on shard i's device, bitwise
    the sum's slice, as the reference's tiled ``psum_scatter`` leaves it on
    shard i."""
    from repro_torch.launch import mesh as mesh_lib

    m = mesh_lib.Mesh([card, "cpu"], ("data",))
    devices = list(m.devices.reshape(-1))
    parts = [_randn((8, 6), seed=i).to(dev) for i, dev in enumerate(devices)]
    total = mesh_lib.psum(parts)
    assert total.device == devices[0]
    for dim in (0, 1):
        sl = mesh_lib.psum_scatter(parts, dim=dim)
        assert [s.device for s in sl] == devices
        for s, want in zip(sl, torch.chunk(total, 2, dim=dim)):
            assert torch.equal(s.cpu(), want.cpu())
