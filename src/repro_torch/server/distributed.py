"""ShardedBackend — fused (G, h) kept block-sharded on a mesh, end to end.

The dense backend holds ``G`` whole on one device. This backend never
materializes the fused Gram in one piece on the solve path:

  * **storage** — ``G`` is a 2-D block-sharded :class:`ShardedTensor` whose
    layout comes from the logical-axis rules in ``launch.sharding``
    (``FUSION_RULES``: rows over the client / data axes, columns over the
    model axis): shard (i, j) holds the (rl, cl) block of its coordinates,
    on its own device. ``d`` is padded up to the block / mesh lcm; the pad
    block of ``G + sigma I`` is ``sigma I`` and the pad of ``h`` is zero, so
    padded solves are exact on the first ``d`` coordinates. ``h`` is
    replicated: one copy, on the mesh's first device, broadcast to the
    other devices where a solve needs it.
  * **fusion** — ``fuse`` adds a dense delta block by block, each block
    cut from the unpadded delta and sent to its shard (the same elementwise
    adds as the reference's). ``fuse_distributed`` runs the paper's Phases
    1+2 on mesh rows as the reference does: each row shard computes its
    local statistics on its own device (kernel K1 on the card), and one
    reduce-scatter, added in flat shard order, leaves each shard only its
    own block: no device holds the fused Gram, and a client's Gram leaves
    its device only as the blocks other devices own.
  * **solve** — a right-looking block Cholesky over the blocks. Per block
    column: the bs x bs diagonal tile is broadcast and factored on every
    device holding rows of the column at or below it
    (``core.fusion.cholesky_or_nan``), each such device solves its own row
    shards' rows below it against the tile as a GEMM with the tile's
    inverse (kernel K2, ``_trsm``), the column of L from the panel down is
    gathered onto every device holding a shard at or below the panel, and
    every shard holding rows and columns at or below the panel takes its
    trailing update ``G_ij - L_ik L_jk^T`` on its rows from the panel down
    as one local GEMM (K2: m <= rl, n = cl, k = bs). Triangular solves run block by block
    on the diagonal tile's device, with one bs-float reduction and one
    bs-float broadcast a step, unrefined as the reference's are.
  * **CG** — where padding would more than double ``d``, ``method="auto"``
    takes matrix-free Jacobi-preconditioned conjugate gradients on the
    blocks.
  * **update** — a ``block_chol`` factor absorbs a rank-r up/downdate
    without refactorizing: per block column, the bs x bs diagonal tile and
    the update vectors' bs columns give the tile's (bs + r)-square
    transform T, and each row shard applies ``[L21 | X2^T] @ T`` to its rows
    in one local GEMM (K2: m = rl, n = k = bs + r). On the card T is built
    from ceil(bs / 32) launches of kernel P on 32-wide sub-panels, K2's
    panel entry between them inside the tile, and K2 composing the
    sub-panels' transforms (:func:`composed_panel_transform`); on the CPU
    it is the plain loop over the whole tile. CG factors decline (``None``).

Work that every shard of the reference computes redundantly (the tile's
factor and inverse, the panel transform) runs once per distinct device of
the mesh. Everything else runs on the device of the block it touches, and
the loops over devices issue their work without reading a value back, so
the cards of a mesh run at once. Every copy between devices goes through
``launch.mesh``'s collectives, which count the bytes; on a mesh whose
shards share one device they copy nothing. The sums are the one-device
mesh's, in the same order, so a mesh over several cards gives its bits.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import torch
import torch.nn.functional as F

from repro_torch.core.fusion import cholesky_or_nan
from repro_torch.core.sufficient_stats import SuffStats, client_stats
from repro_torch.kernels import gram as gram_kernel
from repro_torch.kernels import ops as kernel_ops
from repro_torch.kernels import ref
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch.sharding import (FUSION_RULES, GRAM_AXES,
                                         PartitionSpec, ShardedTensor,
                                         ShardingRules, spec_axes, spec_entry)
from repro_torch.server.cholesky import panel_transform_ref

SUB_PANEL = 32          # the widest panel kernel P takes


@dataclasses.dataclass
class ShardedFactor:
    """Backend-opaque factor handle: block-sharded Cholesky factor or CG marker."""

    kind: str                          # "block_chol" | "cg"
    sigma: float
    L: ShardedTensor | None = None     # (dp, dp) block-sharded lower factor

    @property
    def nbytes(self) -> int:
        return 0 if self.L is None else self.L.nbytes


def composed_panel_transform(L11: torch.Tensor, X1: torch.Tensor, *,
                             sign: float = 1.0, sub: int = SUB_PANEL
                             ) -> tuple[torch.Tensor, torch.Tensor]:
    """``(L11', T)`` of a bs-wide diagonal tile, built from sub-panels.

    The tile is processed in ``sub``-wide panels as the blocked update
    processes a whole factor: the panel's transform T_j ((sub + r)-square),
    then ``[tile rows below | X^T] @ T_j`` inside the tile. T_j acts on the
    panel's columns and the r update columns only, so the tile's transform
    is the product of the embedded T_j, accumulated as ``T[:, idx] = T[:,
    idx] @ T_j``. On the card: kernel P and K2's panel entry in place on a
    copy of the tile (``kernels.gram._Panels``), K2 for the products; on the
    CPU the plain versions. Equal to ``panel_transform_ref`` over the whole
    tile up to rounding.
    """
    bs, r = L11.shape[0], X1.shape[0]
    n = bs + r
    L = L11.clone(memory_format=torch.contiguous_format)
    X = X1.to(L.dtype).clone(memory_format=torch.contiguous_format)
    card = kernel_ops.on_card(L.device, "composed_panel_transform")
    panels = gram_kernel._Panels(L, X, sub, sign) if card else None
    T = None
    for c0 in range(0, bs, sub):
        c1 = min(c0 + sub, bs)
        w = c1 - c0 + r
        if card:
            panels.transform(c0, c1)
            Tj = panels.T[:w * w].view(w, w)
        else:
            L[c0:c1, c0:c1], Tj = panel_transform_ref(
                L[c0:c1, c0:c1], X[:, c0:c1], sign=sign)
        idx = torch.cat([torch.arange(c0, c1, device=L.device),
                         torch.arange(bs, n, device=L.device)])
        if T is None:
            T = torch.eye(n, dtype=L.dtype, device=L.device)
            T[idx[:, None], idx] = Tj
        else:
            cols = T[:, idx]
            T[:, idx] = kernel_ops.gemm_nt(torch.zeros_like(cols), cols,
                                           Tj.T.contiguous(), alpha=1.0)
        if c1 < bs:
            if card:
                panels.gemm(c0, c1)
            else:
                ref.panel_gemm_ref(L, X, c0, c1, Tj)
    return L, T


def tile_transform(L11: torch.Tensor, X1: torch.Tensor, *, sign: float
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """The diagonal tile's ``(L11', T)``: sub-panels of kernel P composed by
    K2 on the card, the plain loop over the whole tile on the CPU (the
    reference's ``panel_transform`` of the tile)."""
    if kernel_ops.on_card(L11.device, "tile_transform"):
        return composed_panel_transform(L11, X1, sign=sign)
    return panel_transform_ref(L11, X1, sign=sign)


class ShardedBackend:
    """Mesh-sharded linalg backend for :class:`~repro_torch.server.FusionEngine`."""

    name = "sharded"
    supports_update = True

    def __init__(self, dim: int, mesh, *, dtype=torch.float32,
                 block_size: int | None = None, method: str = "auto",
                 rules: ShardingRules = FUSION_RULES,
                 cg_iters: int | None = None, cg_tol: float = 1e-6):
        if method not in ("auto", "block_chol", "cg"):
            raise ValueError(f"unknown method {method!r}")
        self.mesh = mesh
        self.method = method
        self._dim = dim
        self._dtype = dtype
        self.cg_tol = cg_tol

        # The block layout from the logical-axis rules, resolved against a
        # shape every mesh axis product divides (as the reference does).
        m_all = mesh.size
        spec = rules.resolve(GRAM_AXES, (m_all, m_all), mesh)
        self._row_axes = spec_axes(spec[0] if len(spec) > 0 else None)
        self._col_axes = spec_axes(spec[1] if len(spec) > 1 else None)
        self._nrows = mesh_lib.axis_size(mesh, self._row_axes)
        self._ncols = mesh_lib.axis_size(mesh, self._col_axes)
        self.spec = PartitionSpec(spec_entry(self._row_axes),
                                  spec_entry(self._col_axes))

        if block_size is None:
            # the reference's rule: at most 16 block columns, bs >= 8
            block_size = 8
            while dim / block_size > 16:
                block_size *= 2
        self.block_size = block_size
        unit = block_size * math.lcm(self._nrows, self._ncols)
        self.padded = -(-dim // unit) * unit
        self._nb = self.padded // block_size
        self._rl = self.padded // self._nrows   # local rows per shard
        self._cl = self.padded // self._ncols   # local cols per shard

        self._dev = {
            (ri, ci): mesh.device_at({
                **mesh_lib.unflatten(mesh, self._row_axes, ri),
                **mesh_lib.unflatten(mesh, self._col_axes, ci)})
            for ri in range(self._nrows) for ci in range(self._ncols)}
        self.device = self._dev[(0, 0)]
        self._G = ShardedTensor(mesh, self.spec, (self.padded, self.padded), {
            key: torch.zeros((self._rl, self._cl), dtype=dtype, device=dev)
            for key, dev in self._dev.items()})
        self._h = torch.zeros((self.padded,), dtype=dtype, device=self.device)
        self._count = torch.zeros((), dtype=torch.int32, device=self.device)
        self._diag = None          # cached diag(G) for the CG preconditioner
        self.cg_iters = (cg_iters if cg_iters is not None
                         else min(4 * self.padded, 2000))
        #: (rank bucket, update?) -> updates run at that bucket
        self.update_buckets: dict[tuple[int, bool], int] = {}
        #: copies made only to hand K2 contiguous operands (the tile's
        #: transposed T, a column-major tile inverse)
        self.k2_copies = 0

    # -- protocol surface ----------------------------------------------------

    @property
    def dim(self) -> int:
        return self._dim

    @property
    def dtype(self) -> torch.dtype:
        return self._dtype

    @property
    def count(self) -> torch.Tensor:
        return self._count

    @property
    def spectral_ready(self) -> bool:
        return False

    @property
    def gram(self) -> ShardedTensor:
        """The live block-sharded (padded) Gram."""
        return self._G

    @property
    def fusion_axis_sizes(self) -> dict[str, int]:
        """Mesh axes (and sizes) the fusion reduction crosses — the row /
        client axes only (``fed.comm.sharded_oneshot_record``)."""
        return {str(a): int(self.mesh.shape[a]) for a in self._row_axes}

    def _pad_vec(self, h: torch.Tensor) -> torch.Tensor:
        return F.pad(h.to(self._dtype), (0, self.padded - self._dim))

    def _block(self, G: torch.Tensor, ri: int, ci: int) -> torch.Tensor:
        """Block (ri, ci) of ``G`` zero-padded to (dp, dp), cut from the
        unpadded ``G`` (a view where the block lies inside it)."""
        rl, cl = self._rl, self._cl
        blk = G[ri * rl:(ri + 1) * rl, ci * cl:(ci + 1) * cl].to(self._dtype)
        if blk.shape == (rl, cl):
            return blk
        return F.pad(blk, (0, cl - blk.shape[1], 0, rl - blk.shape[0]))

    def _columns(self, G: torch.Tensor, ci: int) -> torch.Tensor:
        """Column block ci of ``G`` zero-padded to (dp, dp): (dp, cl)."""
        d, cl = self._dim, self._cl
        col = G[:, ci * cl:(ci + 1) * cl].to(self._dtype)
        if col.shape == (self.padded, cl):
            return col
        return F.pad(col, (0, cl - col.shape[1], 0, self.padded - d))

    def fuse(self, delta: SuffStats, sign: float = 1.0) -> None:
        if delta.dim != self._dim:
            raise ValueError(f"stats dim {delta.dim} != backend dim {self._dim}")
        s = 1.0 if sign > 0 else -1.0
        dg = delta.gram
        self._G = ShardedTensor(self.mesh, self.spec, self._G.shape, {
            (ri, ci): blk + s * mesh_lib.send(self._block(dg, ri, ci), blk.device)
            for (ri, ci), blk in self._G.blocks.items()})
        self._h = self._h + s * self._pad_vec(delta.moment).to(self.device)
        dc = torch.as_tensor(delta.count).to(self.device, torch.int32)
        self._count = self._count + (dc if sign > 0 else -dc)
        self._diag = None

    def stats(self) -> SuffStats:
        """Dense (gathered) view — interop only, never the solve path."""
        d = self._dim
        return SuffStats(self._G.full(self.device)[:d, :d].contiguous(),
                         self._h[:d].clone(), self._count)

    def set_stats(self, stats: SuffStats) -> None:
        if stats.dim != self._dim:
            raise ValueError(f"stats dim {stats.dim} != backend dim {self._dim}")
        self._G = ShardedTensor(self.mesh, self.spec, self._G.shape, {
            key: mesh_lib.send(self._block(stats.gram, *key), dev, copy=True)
            for key, dev in self._dev.items()})
        self._h = self._pad_vec(stats.moment).to(self.device)
        self._count = torch.as_tensor(stats.count).to(self.device, torch.int32)
        self._diag = None

    def release(self) -> None:
        """Drop derived caches (the CG diag preconditioner); (G, h) stay."""
        self._diag = None

    def update(self, factor: ShardedFactor, update_vectors: torch.Tensor,
               sign: float) -> ShardedFactor | None:
        """Blocked rank-r up/downdate of a block-sharded factor, on the blocks.

        Returns a new :class:`ShardedFactor` whose L absorbed ``sign * U^T
        U``; ``None`` for CG factors (the engine evicts them).
        """
        r = int(update_vectors.shape[0])
        if factor.kind != "block_chol":
            return None
        if r == 0:
            return factor
        # Rank-bucket to the next power of two, as the reference does (its
        # compiled programs per rank); zero rows are exact identities.
        bucket = kernel_ops.pow2_bucket(r)
        key = (bucket, sign > 0)
        self.update_buckets[key] = self.update_buckets.get(key, 0) + 1
        U = F.pad(update_vectors.to(self.device, self._dtype),
                  (0, self.padded - self._dim, 0, bucket - r))
        return ShardedFactor("block_chol", factor.sigma,
                             self._update(factor.L, U, 1.0 if sign > 0 else -1.0))

    def spectral(self, sigmas):
        return None   # no sharded eigh: the engine takes the Cholesky sweep

    # -- on-mesh fusion (Phases 1+2, reduce-scattered into the block layout) --

    def fuse_distributed(self, A, b, *, participation=None,
                         noise_fn=None) -> None:
        """Fold mesh rows in: shard-local statistics, one reduce-scatter.

        Each row (client) shard computes its local ``(G_k, h_k)`` on its own
        device (``core.client_stats``: kernel K1 on the card), applies
        ``noise_fn(k, G_k, h_k)`` (Algorithm 2) and the Thm-8 weight
        ``participation[k]``, and :meth:`fuse_local` reduce-scatters them
        into the blocks. ``A`` and ``b`` are plain tensors (split evenly)
        or row-sharded ``ShardedTensor`` blocks.
        """
        if A.shape[-1] != self._dim:
            raise ValueError(f"A has dim {A.shape[-1]}, backend {self._dim}")
        self.fuse_local(client_stats(A, b, self.mesh, client_axes=self._row_axes,
                                     participation=participation,
                                     noise_fn=noise_fn))

    def fuse_local(self, local: Sequence[SuffStats]) -> None:
        """Phase 2 of the row shards' statistics (one a row shard, in flat
        order, each on its own device): as the reference's ``psum_scatter``
        over the row axes, block (ri, ci) of the padded sum is added in flat
        shard order on block (ri, ci)'s device from block (ri, ci) of each
        ``G_k``, so no device holds the fused Gram and a ``G_k`` leaves its
        device only as the blocks other devices own. ``h`` and the count are
        reduced onto the mesh's first device; the count, a weighted row
        count, is rounded."""
        if len(local) != self._nrows:
            raise ValueError(f"{len(local)} row shards' statistics, mesh has "
                             f"{self._nrows}")
        blocks = dict(self._G.blocks)
        for ci in range(self._ncols):
            cols = [self._columns(s.gram, ci) for s in local]
            devices = [self._dev[(ri, ci)] for ri in range(self._nrows)]
            for ri, blk in enumerate(mesh_lib.psum_scatter(cols, devices=devices)):
                blocks[(ri, ci)] = blocks[(ri, ci)] + blk
        self._G = ShardedTensor(self.mesh, self.spec, self._G.shape, blocks)
        dh = mesh_lib.psum([self._pad_vec(s.moment) for s in local], self.device)
        dc = mesh_lib.psum([s.count.to(torch.float32) for s in local], self.device)
        self._h = self._h + dh
        self._count = self._count + torch.round(dc).to(torch.int32)
        self._diag = None

    # -- factorization + solves ----------------------------------------------

    def _resolve_method(self) -> str:
        if self.method != "auto":
            return self.method
        # padding past 2x: the tiling fits d badly, take matrix-free CG
        return "cg" if self.padded >= 2 * self._dim else "block_chol"

    def factor(self, sigma: float) -> ShardedFactor:
        if not sigma > 0:
            raise ValueError("sharded solves require sigma > 0 "
                             "(the pad block of G + sigma I is sigma I)")
        if self._resolve_method() == "cg":
            return ShardedFactor("cg", float(sigma))
        return ShardedFactor("block_chol", float(sigma), self._chol(float(sigma)))

    def solve(self, factor: ShardedFactor, sigma: float | None = None
              ) -> torch.Tensor:
        if factor.kind == "cg":
            return self._cg_solve(factor.sigma)
        return self._tri_solve(factor.L, self._h)[:self._dim]

    def solve_batch(self, sigmas: Sequence[float]
                    ) -> tuple[list[ShardedFactor], torch.Tensor]:
        factors = [self.factor(s) for s in sigmas]
        ws = torch.stack([self.solve(f) for f in factors])
        return factors, ws

    def solve_operands(self, factor: ShardedFactor, sigma: float) -> None:
        """Decline the snapshot path: a sharded solve runs over the blocks,
        so the pool solves sharded tenants under their lock and keeps them
        out of cross-tenant stacks."""
        return None

    @property
    def state_bytes(self) -> int:
        """Resident bytes of the fused (padded, block-sharded) statistics."""
        return self._G.nbytes + self._h.numel() * self._h.element_size()

    # -- the blocks ---------------------------------------------------------------

    def _strip_parts(self, blocks, k: int) -> list[torch.Tensor]:
        """Each row shard's rows of block column k (views, row order)."""
        c0 = k * self.block_size
        qk, lc0 = divmod(c0, self._cl)
        return [blocks[(ri, qk)][:, lc0:lc0 + self.block_size]
                for ri in range(self._nrows)]

    def _trsm(self, Linv: torch.Tensor, below: torch.Tensor) -> torch.Tensor:
        """Panel solve X @ Lkk^T = below as a GEMM against the tile's
        inverse (K2 on the card)."""
        return kernel_ops.gemm_nt(torch.zeros_like(below), below, Linv, alpha=1.0)

    def _tile_inverse(self, Lkk: torch.Tensor) -> torch.Tensor:
        """Lkk^{-1}, contiguous for K2; Lkk's diagonal is >= sqrt(sigma), so
        the small triangular inverse is well conditioned."""
        eye = torch.eye(Lkk.shape[0], dtype=Lkk.dtype, device=Lkk.device)
        Linv = torch.linalg.solve_triangular(Lkk, eye, upper=False)
        if not Linv.is_contiguous():
            Linv = Linv.contiguous()
            self.k2_copies += 1
        return Linv

    def _chol(self, sigma: float) -> ShardedTensor:
        """Right-looking block Cholesky of G + sigma I over the blocks."""
        bs, rl, cl = self.block_size, self._rl, self._cl
        Gl = {}
        for (ri, ci), blk in self._G.blocks.items():
            g = blk.clone()
            g.diagonal(ri * rl - ci * cl).add_(sigma)   # the global diagonal
            Gl[(ri, ci)] = g
        Ll = {key: torch.zeros_like(g) for key, g in Gl.items()}

        for k in range(self._nb):
            c0 = k * bs
            qk, lc0 = divmod(c0, cl)
            pk, lr0 = divmod(c0, rl)
            parts = self._strip_parts(Gl, k)
            # rl is a multiple of bs: the tile lies in row shard pk, and the
            # shards after it lie wholly below the tile
            rows = range(pk, self._nrows)
            owners = list(dict.fromkeys(self._dev[(ri, qk)] for ri in rows))
            # the tile, factored (and inverted) once on each device holding
            # rows of the panel's column at or below it; each of those
            # devices solves its own rows below the tile in one TRSM
            tile = parts[pk][lr0:lr0 + bs]
            pieces = {}
            for dev, t in zip(owners, mesh_lib.broadcast(tile, owners)):
                mine = [ri for ri in rows if self._dev[(ri, qk)] == dev]
                Lkk = cholesky_or_nan(t.contiguous())
                below = {ri: parts[ri][max(c0 + bs - ri * rl, 0):] for ri in mine}
                below = {ri: p for ri, p in below.items() if len(p)}
                if below:
                    solved = self._trsm(self._tile_inverse(Lkk), torch.cat(list(below.values())))
                    below = dict(zip(below, solved.split([len(p) for p in below.values()])))
                for ri in mine:
                    pieces[ri] = torch.cat(([Lkk] if ri == pk else [])
                                           + ([below[ri]] if ri in below else []))
            # the column of L from row c0 down, gathered onto each device
            # holding a shard at or below the panel
            users = list(dict.fromkeys(self._dev[(ri, ci)] for ri in rows
                                       for ci in range(self._ncols)))
            Lcs = dict(zip(users, mesh_lib.all_gather([pieces[ri] for ri in rows],
                                                      devices=users)))
            for ri in rows:
                a = max(ri * rl, c0) - ri * rl          # the shard's first row at or below c0
                for ci in range(self._ncols):
                    g = Gl[(ri, ci)]
                    Lc = Lcs[g.device]
                    mine = Lc[ri * rl + a - c0:(ri + 1) * rl - c0]
                    if ci == qk:
                        Ll[(ri, ci)][a:, lc0:lc0 + bs] = mine
                    # a shard whose columns all lie above the panel takes an
                    # exactly-zero update, and one wholly above the diagonal
                    # is never read again
                    if (ci + 1) * cl <= c0 or (ri + 1) * rl <= ci * cl:
                        continue
                    lc = Lc[max(ci * cl - c0, 0):(ci + 1) * cl - c0]
                    if ci * cl < c0:                    # L's rows above c0 are zero
                        lc = F.pad(lc, (0, 0, c0 - ci * cl, 0))
                    out = kernel_ops.gemm_nt(g[a:], mine, lc, alpha=-1.0)
                    if a:
                        g[a:] = out
                    else:
                        Gl[(ri, ci)] = out
        return ShardedTensor(self.mesh, self.spec, self._G.shape, Ll)

    def _update(self, L: ShardedTensor, X: torch.Tensor, sign: float
                ) -> ShardedTensor:
        """Blocked rank-r up/downdate of L by X (r, dp), over the blocks.

        Row shard ri keeps its rows of the update vectors, (rl, r), on the
        device of the block it updates; only the tile and the tile's rows of
        X are broadcast, to build the tile's transform on every device."""
        bs, rl, cl = self.block_size, self._rl, self._cl
        devices = self.mesh.distinct_devices
        Ll = {key: blk.clone() for key, blk in L.blocks.items()}
        xs = [X[:, ri * rl:(ri + 1) * rl].T for ri in range(self._nrows)]
        for k in range(self._nb):
            c0 = k * bs
            qk, lc0 = divmod(c0, cl)
            pk, lr0 = divmod(c0, rl)
            strips = self._strip_parts(Ll, k)
            xs[pk] = mesh_lib.send(xs[pk], Ll[(pk, qk)].device)
            tile = strips[pk][lr0:lr0 + bs]
            X1 = xs[pk][lr0:lr0 + bs].T                             # (r, bs)
            transforms = {}
            for dev, t, x1 in zip(devices, mesh_lib.broadcast(tile, devices),
                                  mesh_lib.broadcast(X1, devices)):
                self.k2_copies += 1          # T transposed for K2's B operand
                Lkk_new, T = tile_transform(t, x1, sign=sign)
                transforms[dev] = (Lkk_new, T.T.contiguous())
            for ri in range(self._nrows):
                if (ri + 1) * rl <= c0:
                    continue                 # rows above the panel: X unchanged
                blk = Ll[(ri, qk)]
                Lkk_new, TT = transforms[blk.device]
                strip = strips[ri]
                Xloc = mesh_lib.send(xs[ri], blk.device)               # (rl, r)
                Z = torch.cat([strip, Xloc], dim=1)                    # (rl, bs + r)
                Zn = kernel_ops.gemm_nt(torch.zeros_like(Z), Z, TT, alpha=1.0)
                g = torch.arange(ri * rl, (ri + 1) * rl, device=blk.device)
                below = (g >= c0 + bs)[:, None]
                new_strip = torch.where(below, Zn[:, :bs], strip)
                if ri == pk:
                    new_strip[lr0:lr0 + bs] = Lkk_new
                blk[:, lc0:lc0 + bs] = new_strip
                xs[ri] = torch.where(below, Zn[:, bs:], Xloc)
        return ShardedTensor(self.mesh, self.spec, L.shape, Ll)

    def _diag_tile(self, L: ShardedTensor, k: int) -> torch.Tensor:
        """The k-th bs x bs diagonal tile of L, a view on its shard's device."""
        bs, rl, cl = self.block_size, self._rl, self._cl
        c0 = k * bs
        pk, qk = c0 // rl, c0 // cl
        return L.blocks[(pk, qk)][c0 - pk * rl:c0 - pk * rl + bs,
                                  c0 - qk * cl:c0 - qk * cl + bs]

    def _tri_solve(self, L: ShardedTensor, h: torch.Tensor) -> torch.Tensor:
        """w = (L L^T)^{-1} h by block forward / back substitution. Step k
        runs on the diagonal tile's device: one local (bs, cl) matvec a
        shard, one bs-float reduction onto that device, and the solved
        bs floats broadcast into every device's copy of the iterate."""
        bs, rl, cl = self.block_size, self._rl, self._cl
        devices = self.mesh.distinct_devices
        hs = dict(zip(devices, mesh_lib.broadcast(h, devices)))
        # Forward: L y = h. Entries of y past block k are still zero, so the
        # row block's matvec sums exactly the factored columns.
        ys = {dev: torch.zeros_like(hs[dev]) for dev in devices}
        for k in range(self._nb):
            c0 = k * bs
            pk, lr0 = divmod(c0, rl)
            tile = self._diag_tile(L, k)
            parts = [L.blocks[(pk, ci)][lr0:lr0 + bs]
                     @ ys[L.blocks[(pk, ci)].device][ci * cl:(ci + 1) * cl]
                     for ci in range(self._ncols)]
            s = mesh_lib.psum(parts, tile.device)
            yk = torch.linalg.solve_triangular(
                tile, (hs[tile.device][c0:c0 + bs] - s)[:, None], upper=False)[:, 0]
            for dev, v in zip(devices, mesh_lib.broadcast(yk, devices)):
                ys[dev][c0:c0 + bs] = v
        # Backward: L^T w = y over block rows in reverse.
        xs = {dev: torch.zeros_like(hs[dev]) for dev in devices}
        for k in reversed(range(self._nb)):
            c0 = k * bs
            qk, lc0 = divmod(c0, cl)
            tile = self._diag_tile(L, k)
            parts = [L.blocks[(ri, qk)][:, lc0:lc0 + bs].T
                     @ xs[L.blocks[(ri, qk)].device][ri * rl:(ri + 1) * rl]
                     for ri in range(self._nrows)]
            s = mesh_lib.psum(parts, tile.device)
            xk = torch.linalg.solve_triangular(
                tile.T, (ys[tile.device][c0:c0 + bs] - s)[:, None], upper=True)[:, 0]
            for dev, v in zip(devices, mesh_lib.broadcast(xk, devices)):
                xs[dev][c0:c0 + bs] = v
        return xs[self.device]

    def _matvec(self, x: torch.Tensor) -> torch.Tensor:
        """G @ x over the blocks: x broadcast, per shard a local matvec,
        summed over the column shards on the row's device, gathered over
        the row shards."""
        rl, cl = self._rl, self._cl
        devices = self.mesh.distinct_devices
        xd = dict(zip(devices, mesh_lib.broadcast(x, devices)))
        rows = []
        for ri in range(self._nrows):
            parts = []
            for ci in range(self._ncols):
                blk = self._G.blocks[(ri, ci)]
                parts.append(blk @ xd[blk.device][ci * cl:(ci + 1) * cl])
            rows.append(mesh_lib.psum(parts, self._dev[(ri, 0)]))
        return mesh_lib.all_gather(rows, self.device)

    # -- CG fallback -----------------------------------------------------------

    def _gram_diag(self) -> torch.Tensor:
        if self._diag is None:
            rl, cl = self._rl, self._cl
            d = torch.zeros((self.padded,), dtype=self._dtype, device=self.device)
            for (ri, ci), blk in self._G.blocks.items():
                lo, hi = max(ri * rl, ci * cl), min((ri + 1) * rl, (ci + 1) * cl)
                if lo < hi:
                    d[lo:hi] = mesh_lib.send(torch.diagonal(
                        blk[lo - ri * rl:hi - ri * rl, lo - ci * cl:hi - ci * cl]
                    ), self.device)
            self._diag = d
        return self._diag

    def _cg_solve(self, sigma: float) -> torch.Tensor:
        """Jacobi-preconditioned CG on (G + sigma I) w = h, G kept in blocks."""
        h = self._h
        M = self._gram_diag() + sigma

        def mv(x):
            return self._matvec(x) + sigma * x

        tiny = torch.finfo(h.dtype).tiny
        thresh = float(self.cg_tol ** 2 * torch.dot(h, h)) + tiny
        w = torch.zeros_like(h)
        r = h - mv(w)
        z = r / M
        p = z
        rz = torch.dot(r, z)
        it = 0
        while it < self.cg_iters and float(torch.dot(r, r)) > thresh:
            Ap = mv(p)
            alpha = rz / torch.dot(p, Ap)
            w = w + alpha * p
            r = r - alpha * Ap
            z = r / M
            rz_new = torch.dot(r, z)
            p = z + (rz_new / rz) * p
            rz = rz_new
            it += 1
        self.cg_last_iters = it
        return w[:self._dim]
