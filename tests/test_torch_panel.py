"""The write path's two kernels, P and K2's panel entry, as numpy models of
their CUDA schedules, and the blocked update's CPU path.

- ``p_model`` runs ``csrc/panel_transform.cu`` step by step: every CTA of
  the grid, each role's warps as arrays over (CTA, warp, lane) — the
  diagonal warp, the off-diagonal warps with two rows each, the T warps —
  the lane-to-lane ``__shfl_up_sync`` of x and of T's column bw + j, the
  (c, st) ring of 64 slots per column and the diagonal's two-slot mailbox,
  each slot tagged (a reader must find the step it needs, and no slot may
  be read and written in one step), X1's rows staged 16 steps ahead in a
  64-row ring, T rows q = bw + j0 started at j0 and rows q < bw at column
  q (the skipped steps meet exact zeros), the scalar wavefront
  repeated in every CTA, T's rows split over the CTAs, and L11' written by
  the CTA that arrived last. numpy rounds every operation once, as the kernel's ``__f*_rn``
  intrinsics do, so the model must give ``panel_transform_ref``'s bits (its
  square root is the plain version's own, see ``_sqrt``).
- ``k2_model`` runs ``csrc/gemm_nt.cu``'s panel entry: 32-row strips read
  through L's and X's strides, each strip's reads and writes the same
  elements and no two strips sharing one, and above ``k2_in_place`` (the
  library's ``gemm_nt_panel_in_place``, modelled) the out-of-place tile route into a workspace, copied back. It must equal
  ``ref.panel_gemm_ref`` (the reference's ``gemm_nt(0, Z, T^T)``) and leave
  every other element of L and X as it was.
- The CPU ``chol_update_blocked`` keeps the bits of the loop it had before
  P and K2 worked in place, and still matches JAX's.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.server import cholesky as jchol
from repro_torch.kernels import ref
from repro_torch.server import cholesky as tchol

WARPS, RING = 32, 64
DTYPES = {torch.float32: np.float32, torch.float64: np.float64}


def _panel(bw, r, dtype, seed=0):
    rng = np.random.default_rng([bw, r, seed])
    M = rng.standard_normal((4 * bw, bw))
    L11 = np.linalg.cholesky(M.T @ M + 0.1 * np.eye(bw)).astype(dtype)
    X1 = (0.5 * rng.standard_normal((r, bw))).astype(dtype)
    return L11, X1


def _shfl_up(v):
    """``__shfl_up_sync(kAll, v, 1)``: lane k gets lane k - 1's value,
    lane 0 its own."""
    out = v.copy()
    out[..., 1:] = v[..., :-1]
    return out


def _sqrt(a):
    """The plain version's square root. torch's CPU sqrt is not correctly
    rounded (it differs from numpy's in the last bit near a rounding
    midpoint, in float32 and float64); the kernel's ``__fsqrt_rn`` is, as is
    the card's plain version's, so the model takes the oracle's here."""
    return torch.sqrt(torch.from_numpy(np.ascontiguousarray(a))).numpy()


def _rotate(a, x, c, st, s):
    """(a, x) -> ((a + s st x) / c, (-st a + x) / c), one rounding each."""
    return (a + (s * st) * x) / c, ((-st) * a + x) / c


ROW_WARPS = 16
X_RING, X_AHEAD, X_WAIT = 64, 16, 8


def _lanes():
    """(row, k) of every lane of the off-diagonal warps 1..16: warp p holds
    row p in lanes [0, p) and row 32 - p in lanes [p, 32); warp 16 only
    row 16 (row -1: no element)."""
    p = np.arange(1, ROW_WARPS + 1)[:, None]
    lane = np.arange(WARPS)[None, :]
    row = np.where(lane < p, p, np.where(p < ROW_WARPS, WARPS - p, -1))
    return row, np.where(lane < p, lane, lane - p)


def p_model(L, ldl, X, ldx, bw, r, sign, *, twarps=8, seed=0):
    """Kernel P on flat row-major buffers: L11 at L[0], X1 at X[0]. Writes
    L11' over L's lower triangle; returns T ((bw + r)^2, row-major).
    ``twarps`` T warps a CTA (the kernel picks 1 to 8 from the SM count).

    Arrays carry a leading CTA axis; the diagonal warp is (cta, lane), the
    off-diagonal warps (cta, warp, lane), the T warps (cta, warp, lane)."""
    dt = L.dtype.type
    s, one, zero, tiny = dt(sign), dt(1), dt(0), np.finfo(dt).tiny
    w = bw + r
    ctas = -(-w // twarps)
    C = np.arange(ctas)
    lane = np.arange(WARPS)
    Tout = np.full(w * w, np.nan, dt)               # poisoned: all must be written

    def elem(i, c):                                 # L11[i, c] where i >= 0
        return L[np.clip(i * ldl + c, 0, L.size - 1)]

    # the diagonal warp: lane i holds (i, i); the off-diagonal warps
    drow = np.broadcast_to(lane, (ctas, WARPS))
    dmine = drow < bw
    dl = np.where(dmine, elem(drow, drow), zero)
    orow, ok = _lanes()
    orow, ok = np.broadcast_to(orow, (ctas,) + orow.shape), np.broadcast_to(ok, (ctas,) + ok.shape)
    omine = (orow >= 0) & (orow < bw)
    ol = np.where(omine, elem(orow, ok), zero)
    # CTAs stage L11 and arrive in a shuffled order; the last writes L11'
    last = np.random.default_rng(seed).permutation(ctas)[-1]

    # X1 rows staged in a 64-slot ring: rows [0, 16) before the loop, row
    # t + 16 copied during step t and complete (visible) after step t + 8
    xs = np.zeros((X_RING, WARPS), dt)
    xtag = np.full(X_RING, -1)

    def stage(j):
        if 0 <= j < r:
            xs[j % X_RING, :bw] = X[j * ldx + np.arange(bw)]
            xtag[j % X_RING] = j

    for j in range(X_AHEAD):
        stage(j)
    copying = {}                                    # step it completes -> row

    def x_of(j, rows, mask):                        # X1[j, rows] from the ring
        assert (xtag[j[mask] % X_RING] == j[mask]).all(), "X1 row not staged"
        return xs[j % X_RING, np.clip(rows, 0, WARPS - 1)]

    q = C[:, None, None] * twarps + np.arange(twarps)[None, :, None]
    tw = np.broadcast_to(q < w, (ctas, twarps, 1))
    tl = (q < w) & (lane < bw)
    jstart = np.where(q > bw, q - bw, 0)
    kstart = np.where(q < bw, q, 0)
    for jj in range(0, r, WARPS):                   # the zero prefill
        pre = tw & (jj + lane < jstart)
        Tout[(q * w + bw + jj + lane)[pre]] = zero
    tk = np.where(tl & (q == lane), one, zero)

    ring = np.zeros((2, ctas, WARPS, RING), dt)     # c, st
    tag = np.full((ctas, WARPS, RING), -1)          # which j a slot holds
    box = np.zeros((ctas, WARPS, 2), dt)
    btag = np.full((ctas, WARPS, 2), -1)
    x_in = np.zeros((ctas, ROW_WARPS, WARPS), dt)
    tj_in = np.zeros((ctas, twarps, WARPS), dt)
    cc = np.broadcast_to(C[:, None, None], (ctas, ROW_WARPS, WARPS))
    ct = np.broadcast_to(C[:, None, None], (ctas, twarps, WARPS))
    cd = np.broadcast_to(C[:, None], (ctas, WARPS))
    klane = np.broadcast_to(lane, (ctas, twarps, WARPS))

    def read(cta, kk, slot, j, mask):
        assert (tag[cta[mask], kk[mask], slot[mask]] == j[mask]).all(), "ring slot stale"
        return ring[0, cta, kk, slot], ring[1, cta, kk, slot], (cta * WARPS + kk) * RING + slot

    with np.errstate(all="ignore"):
        for t in range(2 * bw + r - 1):
            # diagonal warp: (i, i, j), j = t - 2i
            # the loader issues row t + 16 into a slot whose last row (j - 64)
            # was last read at step j - 64 + bw - 1
            assert t + X_AHEAD - X_RING + bw - 1 < t, "X1 slot rewritten while read"
            copying[t + X_AHEAD - X_WAIT] = t + X_AHEAD
            j = t - 2 * drow
            act = dmine & (j >= 0) & (j < r)
            got = act & (drow > 0)
            assert (btag[cd[got], drow[got], j[got] & 1] == j[got]).all(), "mailbox stale"
            x = np.where(drow == 0, x_of(j, 0 * drow, act & (drow == 0)), box[cd, drow, j & 1])
            rho = _sqrt(np.maximum(dl * dl + (s * x) * x, tiny))
            dwrite = (cd[act], drow[act], (j & (RING - 1))[act], j[act],
                      (rho / dl)[act], (x / dl)[act])
            box_reads = ((cd * WARPS + drow) * 2 + (j & 1))[got]
            dl = np.where(act, rho, dl)

            # off-diagonal warps: (row, k, j), j = t - row - k
            j = t - orow - ok
            act = omine & (j >= 0) & (j < r)
            x = np.where(ok == 0, x_of(j, orow, act & (ok == 0)), x_in)
            slot = j & (RING - 1)
            c, st, codes = read(cc, ok, slot, j, act)
            reads = codes[act]
            ln, xn = _rotate(ol, x, c, st, s)
            ol = np.where(act, ln, ol)
            x = np.where(act, xn, x)
            hand = act & (ok == orow - 1)
            bwrite = (cc[hand], orow[hand], j[hand] & 1, j[hand], x[hand])
            x_in = _shfl_up(x)

            # T warps: row q, (k, j2), j2 = t - bw - k, from t >= bw + jstart
            on = tw & (t >= bw + jstart + kstart)
            j2 = t - bw - klane
            tj = np.where(klane == 0, np.where(q == bw + j2, one, zero), tj_in)
            act2 = tl & on & (klane >= kstart) & (j2 >= jstart) & (j2 < r)
            slot2 = j2 & (RING - 1)
            c, st, codes = read(ct, klane, slot2, j2, act2)
            reads = np.concatenate([reads, codes[act2]])
            tkn, tjn = _rotate(tk, tj, c, st, s)
            tk = np.where(act2, tkn, tk)
            tj = np.where(act2, tjn, tj)
            out = act2 & (klane == bw - 1)
            Tout[(q * w + bw + j2)[out]] = tj[out]
            tj_in = np.where(on, _shfl_up(tj), tj_in)

            # the barrier: this step's ring and mailbox writes become visible
            b_, k_, sl_, jw, cw, sw = dwrite
            assert not np.intersect1d(reads, (b_ * WARPS + k_) * RING + sl_).size, \
                "ring slot read and written in one step"
            ring[0, b_, k_, sl_], ring[1, b_, k_, sl_], tag[b_, k_, sl_] = cw, sw, jw
            b_, i_, sl_, jw, xw = bwrite
            assert not np.intersect1d(box_reads, (b_ * WARPS + i_) * 2 + sl_).size, \
                "mailbox slot read and written in one step"
            box[b_, i_, sl_], btag[b_, i_, sl_] = xw, jw
            if t in copying:                        # the loader's wait_group
                stage(copying.pop(t))
    store = tl
    Tout[(q * w + klane)[store]] = tk[store]
    for rows, ks, vals, mine in ((drow, drow, dl, dmine), (orow, ok, ol, omine)):
        sel = mine & (np.arange(ctas).reshape((-1,) + (1,) * (mine.ndim - 1)) == last)
        L[(rows * ldl + ks)[sel]] = vals[sel]
    assert not np.isnan(Tout).any(), "an element of T was never written"
    return Tout.reshape(w, w)


def test_p_lanes_cover_the_triangle_once():
    row, k = _lanes()
    cells = sorted(zip(row[row >= 0].tolist(), k[row >= 0].tolist()))
    assert cells == [(i, c) for i in range(1, WARPS) for c in range(i)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("sign", [1.0, -1.0])
@pytest.mark.parametrize("bw,r,twarps", [
    (bw, r, t) for bw in (1, 5, 32) for r in (1, 8, 64, 200)
    for t in ((1, 8) if r <= 64 else (8,))])     # one T row a CTA: up to 96 CTAs
def test_p_schedule_gives_the_plain_bits(bw, r, sign, dtype, twarps):
    L11, X1 = _panel(bw, r, DTYPES[dtype])
    if sign < 0:   # downdate what the update added: stays positive definite
        L11 = tchol.panel_transform_ref(torch.from_numpy(L11), torch.from_numpy(X1))[0].numpy()
    Lr, Tr = tchol.panel_transform_ref(torch.from_numpy(L11), torch.from_numpy(X1), sign=sign)
    # the panel inside a wider factor and wider update rows, as in place
    ld = bw + 3
    Lbuf = np.full((bw, ld), 7.0, L11.dtype)
    Lbuf[:, :bw] = np.triu(np.full((bw, bw), 7.0), 1) + np.tril(L11)
    Xbuf = np.full((r, ld), 9.0, X1.dtype)
    Xbuf[:, :bw] = X1
    Xflat = Xbuf.ravel().copy()
    Lflat = Lbuf.ravel()
    T = p_model(Lflat, ld, Xflat, ld, bw, r, sign, twarps=twarps, seed=bw + r)
    got = Lflat.reshape(bw, ld)
    assert np.array_equal(np.tril(got[:, :bw]), np.tril(Lr.numpy()))
    assert (np.triu(got[:, :bw], 1) == np.triu(np.full((bw, bw), 7.0), 1)).all()
    assert (got[:, bw:] == 7.0).all()
    assert np.array_equal(Xflat, Xbuf.ravel())
    assert np.array_equal(T, Tr.numpy())


def test_p_model_sees_a_short_ring():
    """With 32 slots a column's slot is rewritten in the step its last
    reader (a T row) reads it, at bw = 32: the model refuses that."""
    global RING
    L11, X1 = _panel(32, 40, np.float32)
    RING = 32
    try:
        with pytest.raises(AssertionError):
            p_model(L11.ravel().copy(), 32, X1.ravel().copy(), 32, 32, 40, 1.0)
    finally:
        RING = 64


STRIP, TILE = 32, 64
PANEL_SMEM = 200 * 1024                 # kPanelSmem
PANEL_GROUPS = {torch.float32: 5, torch.float64: 3}


def k2_in_place(n, dtype):
    """``panel_groups`` of ``csrc/gemm_nt.cu``: all of T (n rows of 32-column
    groups) and a strip of Z (32 rows of n + 1) in one CTA's shared memory."""
    groups = -(-n // 32)
    size = torch.finfo(dtype).bits // 8
    return (groups <= PANEL_GROUPS[dtype]
            and size * (n * 32 * groups + STRIP * (n + 1)) <= PANEL_SMEM)


def k2_model(L, X, c0, c1, T):
    """K2's panel entry on numpy arrays L (d, d), X (r, d), in place."""
    d, r = L.shape[0], X.shape[0]
    bw = c1 - c0
    n, m = bw + r, d - c1
    Lf, Xf = L.reshape(-1), X.reshape(-1)       # views: writes land in L, X

    def where(i, c):        # flat buffer and index of Z[i, c]
        return (Lf, (c1 + i) * d + c0 + c) if c < bw else (Xf, (c - bw) * d + c1 + i)

    if k2_in_place(n, torch.from_numpy(L).dtype):
        owned = set()
        for cta in range(-(-m // STRIP)):
            i0 = cta * STRIP
            rows = min(STRIP, m - i0)
            cells = [(i, c) for i in range(rows) for c in range(n)]
            at = {(id(buf), k) for buf, k in (where(i0 + i, c) for i, c in cells)}
            assert len(at) == rows * n and not at & owned, "strips overlap"
            owned |= at
            Zs = np.zeros((STRIP, n), L.dtype)
            for i, c in cells:
                buf, k = where(i0 + i, c)
                Zs[i, c] = buf[k]
            out = Zs @ T
            for i, c in cells:
                buf, k = where(i0 + i, c)
                buf[k] = out[i, c]
        assert len(owned) == m * n
        return "in place"
    O = np.zeros((m, n), L.dtype)
    for i0 in range(0, m, TILE):
        for j0 in range(0, n, TILE):
            rows, cols = range(i0, min(i0 + TILE, m)), range(j0, min(j0 + TILE, n))
            A = np.array([[where(i, kk)[0][where(i, kk)[1]] for kk in range(n)] for i in rows])
            Bt = np.array([[T[kk, j] for kk in range(n)] for j in cols])
            O[i0:i0 + len(rows), j0:j0 + len(cols)] = A @ Bt.T
    L[c1:, c0:c1] = O[:, :bw]
    X[:, c1:] = O[:, bw:].T
    return "out of place"


@pytest.mark.parametrize("d,c0,bw,r,dtype,route", [
    (100, 32, 32, 64, torch.float32, "in place"),    # the rank-64 flush's width
    (261, 0, 32, 64, torch.float64, "in place"),     # ragged last strip
    (77, 0, 32, 128, torch.float32, "in place"),     # n = 160, the float32 cap
    (77, 0, 32, 128, torch.float64, "out of place"),
    (90, 32, 26, 200, torch.float32, "out of place"),
])
def test_k2_panel_model_equals_z_times_t(d, c0, bw, r, dtype, route):
    rng = np.random.default_rng([d, r])
    np_dt = DTYPES[dtype]
    L = rng.standard_normal((d, d)).astype(np_dt)
    X = rng.standard_normal((r, d)).astype(np_dt)
    T = rng.standard_normal((bw + r, bw + r)).astype(np_dt)
    c1 = c0 + bw
    Lr, Xr = torch.from_numpy(L.copy()), torch.from_numpy(X.copy())
    ref.panel_gemm_ref(Lr, Xr, c0, c1, torch.from_numpy(T))
    before_L, before_X = L.copy(), X.copy()
    assert k2_model(L, X, c0, c1, T) == route
    tol = 1e-5 if dtype == torch.float32 else 1e-12
    np.testing.assert_allclose(L[c1:, c0:c1], Lr.numpy()[c1:, c0:c1], rtol=tol, atol=tol)
    np.testing.assert_allclose(X[:, c1:], Xr.numpy()[:, c1:], rtol=tol, atol=tol)
    keep = np.ones((d, d), bool)
    keep[c1:, c0:c1] = False
    assert np.array_equal(L[keep], before_L[keep])
    assert np.array_equal(X[:, :c1], before_X[:, :c1])


@pytest.mark.parametrize("dtype,widest", [(torch.float32, 160), (torch.float64, 96)])
def test_k2_in_place_width(dtype, widest):
    """Every power-of-two rank's width 32 + r up to the cap goes in place,
    the next one out of place; the rank-64 flush's 96 in both dtypes (the
    library's own rule is held to the same widths on the card)."""
    assert all(k2_in_place(n, dtype) for n in range(1, widest + 1))
    assert not k2_in_place(widest + 1, dtype)
    assert k2_in_place(96, dtype)


def _blocked_before(L, U, sign=1.0, block_size=32):
    """chol_update_blocked's CPU loop as it was before P and K2 worked in
    place on the card."""
    d = L.shape[0]
    L = L.clone()
    X = U.to(L.dtype).clone()
    for c0 in range(0, d, block_size):
        c1 = min(c0 + block_size, d)
        bw = c1 - c0
        L11, T = tchol.panel_transform_ref(L[c0:c1, c0:c1], X[:, c0:c1], sign=sign)
        L[c0:c1, c0:c1] = L11
        if c1 < d:
            Z = torch.cat([L[c1:, c0:c1], X[:, c1:].T], dim=1)
            Zn = ref.gemm_nt_ref(torch.zeros_like(Z), Z, T.T.contiguous(), alpha=1.0)
            L[c1:, c0:c1] = Zn[:, :bw]
            X[:, c1:] = Zn[:, bw:].T
    return L


def _factor(d, dtype, seed=0):
    rng = np.random.default_rng([d, seed])
    A = rng.standard_normal((2 * d, d))
    return np.linalg.cholesky(A.T @ A + 0.1 * np.eye(d)).astype(DTYPES[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("d,r,bs,sign", [(70, 8, 32, 1.0), (64, 16, 16, -1.0),
                                         (45, 64, 32, 1.0), (33, 9, 8, -1.0)])
def test_cpu_blocked_update_bits_unchanged(d, r, bs, sign, dtype):
    L = torch.from_numpy(_factor(d, dtype))
    U = torch.from_numpy((0.3 * np.random.default_rng([d, r]).standard_normal((r, d)))
                         .astype(DTYPES[dtype]))
    if sign < 0:
        L = tchol.chol_update_blocked(L, U, block_size=bs)
    want = _blocked_before(L, U, sign=sign, block_size=bs)
    assert torch.equal(tchol.chol_update_blocked(L, U, sign=sign, block_size=bs), want)
    # a column-major factor (as torch.linalg.cholesky gives on a card) and
    # transposed update rows give the same bits
    Lc = L.T.contiguous().T
    Ut = U.T.contiguous().T
    assert torch.equal(tchol.chol_update_blocked(Lc, Ut, sign=sign, block_size=bs), want)


@pytest.mark.parametrize("d,r,bs", [(70, 8, 32), (100, 64, 32)])
def test_cpu_blocked_update_matches_jax(d, r, bs):
    L = _factor(d, torch.float32, seed=1)
    U = (0.5 * np.random.default_rng([r, d]).standard_normal((r, d))).astype(np.float32)
    got = tchol.chol_update_blocked(torch.from_numpy(L), torch.from_numpy(U), block_size=bs)
    want = jchol.chol_update_blocked(jnp.asarray(L), jnp.asarray(U), block_size=bs,
                                     use_pallas=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4, atol=2e-4)
