"""ctypes wrappers of the hand-written CUDA kernels (``csrc/*.cu``).

Each wrapper takes CUDA tensors only: it checks device, dtype, shape and
contiguity and raises on anything its kernel does not take, allocates the
outputs (and scratch) with ``torch.empty`` on the inputs' device, launches
on that device's current stream, with that device current, without
synchronising, and raises if the launch returned a CUDA error. Each keeps a plain integer ``launches`` count, raised
by one where it launches its kernel and nowhere else.

  K1 ``gram_moment_cuda``     — (A^T A, A^T b); replaces ``gram_moment_pallas``
  K2 ``gemm_nt_cuda``         — C + alpha A B^T; replaces ``gemm_nt_pallas``
                                (float32 on the tensor cores, :func:`gemm_tile`)
     ``panel_gemm_cuda``      — its panel entry: [L21 | X2^T] @ T in place
  P  ``panel_transform_cuda`` — one panel of the blocked Cholesky update
     ``blocked_update_cuda``  — every panel of one update, P then K2 in place
  K3 ``sketch_gram_cuda``     — ((AR)^T AR, (AR)^T b); replaces ``sketch_gram_pallas``
  K4 ``rff_gram_cuda``        — the same on sqrt(2/D) cos(XW + c); replaces
                                ``rff_gram_pallas``
  K5 ``swa_flash_cuda``       — sliding-window flash attention (prefill);
                                replaces ``swa_flash_pallas``

K1 in float32, bfloat16 and float16, and K3 and K4 with float32 or
bfloat16 input, run on one tensor-core SYRK (``csrc/tc_syrk.cuh``) whose
tile edge :func:`syrk_tile` picks from the Gram's size; float64 K1 runs
its CUDA-core kernel. K3 and K4 share one source,
``csrc/feature_gram.cu``: float64 on its tile routine, float32 and
bfloat16 input on its chunk route. The libraries are compiled on the
first call (``kernels._build``).
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import _build

_VP, _INT, _DBL, _FLT = ctypes.c_void_p, ctypes.c_int, ctypes.c_double, ctypes.c_float
_INT32_MAX = 2**31 - 1

_GRAM_DTYPES = {torch.float32: 0, torch.float64: 1, torch.bfloat16: 2,
                torch.float16: 3}
_FLOAT_DTYPES = {torch.float32: 0, torch.float64: 1}

_SIGNATURES = {
    "gram_moment": [_VP, _VP, _VP, _VP, _INT, _INT, _INT, _INT, _VP],
    "gemm_nt": [_VP, _VP, _VP, _VP, _INT, _INT, _INT, _DBL, _INT, _INT, _VP],
    "gemm_nt_panel": [_VP, _INT, _VP, _INT, _VP, _VP, _INT, _INT, _INT, _INT, _VP],
    "panel_transform": [_VP, _INT, _VP, _INT, _VP, _VP, _VP, _INT, _INT, _DBL,
                        _INT, _VP],
    "sketch_gram": [_VP] * 6 + [_INT] * 7 + [_VP],
    "rff_gram": [_VP] * 7 + [_INT] * 5 + [_DBL, _INT, _INT, _VP],
    "swa_flash": [_VP] * 4 + [_INT] * 7 + [_FLT, _INT, _VP],
}
_SOURCE = {"sketch_gram": "feature_gram", "rff_gram": "feature_gram",
           "gemm_nt_panel": "gemm_nt"}
# A second entry of a kernel raises that kernel's launch count.
_COUNTED_AS = {"gemm_nt_panel": "gemm_nt"}

# (input dtype, map dtype) -> code of csrc/feature_gram.cu
_FEATURE_DTYPES = {(torch.float32, torch.float32): 0,
                   (torch.float64, torch.float64): 1,
                   (torch.bfloat16, torch.bfloat16): 2,
                   (torch.bfloat16, torch.float32): 3}
_FEATURE_ROWS = 64        # rows of T per chunk (kRows in feature_gram.cu)
_FEATURE_SMS = 132        # SMs of an H100 SXM; one tile-routine CTA fits per SM
_FEATURE_MAX_SPLITS = 16
_SKETCH_CHUNK_ROWS = 4096  # rows of the chunk route's T workspace (K3, K4)
_SYRK_WIDE = 128           # the SYRK's tile edges (csrc/tc_syrk.cuh)
_SYRK_NARROW = 32
_SYRK_MIN_FILL = 0.75      # least share of the wide tiles' waves kept busy
_GEMM_TILES = (128, 64)    # K2's float32 output tile edges (csrc/gemm_nt.cu), widest first


def syrk_tile(m: int) -> int:
    """Edge of the tensor-core SYRK's G tiles for an m x m Gram (K1, and the
    chunk route of K3 and K4).

    A 128-wide tile CTA fills an SM, so the upper triangle of 128-tiles runs
    in waves of ``_FEATURE_SMS``. Where those waves are at least 3/4 busy
    (m 4096: 528 CTAs, 4 whole waves) the wide tile is taken; else the
    32-wide tile, whose many small CTAs fill the card (m 1024: 528 CTAs
    where 128-tiles give 36). Depends only on m, so the bits of G do not
    depend on the card.
    """
    tiles = -(-m // _SYRK_WIDE)
    ctas = tiles * (tiles + 1) // 2
    waves = -(-ctas // _FEATURE_SMS)
    return _SYRK_WIDE if ctas >= _SYRK_MIN_FILL * waves * _FEATURE_SMS else _SYRK_NARROW


def gemm_tile(m: int, n: int, dtype: torch.dtype) -> int:
    """K2's route for an (m, n) output of ``gemm_nt``: 0 for the CUDA-core
    tile loop (float64), else the edge of the float32 tensor-core route's
    square output tiles, 128 or 64.

    A CTA's time grows with its tile's area, and the CTAs of a launch run
    on ``_FEATURE_SMS`` SMs, so the busiest SM computes ceil(CTAs / 132)
    tiles' worth: waves x area. The edge with the least of that wins, the
    wider on a tie (each operand row is then read by fewer CTAs). At the
    sharded backend's shapes: the SYRK (1024, 2048) runs 128 CTAs of 128
    (512 of 64 tie); the TRSM (3840, 256) 240 of 64, the trailing update
    (1024, 320) 80 of 64, the composition (320, 96) 10 of 64. Depends only
    on the shape and dtype; the bits do not depend on the edge.
    """
    if dtype == torch.float64:
        return 0

    def busiest(t: int) -> int:
        ctas = -(-m // t) * -(-n // t)
        return -(-ctas // _FEATURE_SMS) * t * t
    return min(_GEMM_TILES, key=busiest)


_GRAM_SYRK_MIN_ROWS = 2    # fewer rows: K1 keeps its CUDA-core kernel


def gram_tile(n: int, d: int, dtype: torch.dtype) -> int:
    """K1's route for (n, d) input of ``dtype``: 0 for the CUDA-core kernel,
    else the SYRK's tile edge :func:`syrk_tile` (d).

    Float64 always takes the CUDA-core kernel, and so does a single
    streamed row (n = 1): there both routes mostly write G, and the SYRK
    measured 2-3% slower (PERF.md §6). Depends only on the shape and dtype.
    """
    if dtype == torch.float64 or n < _GRAM_SYRK_MIN_ROWS:
        return 0
    return syrk_tile(d)


def _fn(name: str):
    lib = _build.load(_SOURCE.get(name, name))
    fn = getattr(lib, name)
    if fn.argtypes is None:
        fn.argtypes = _SIGNATURES[name]
        fn.restype = _INT
        lib.kernel_error_string.argtypes = [_INT]
        lib.kernel_error_string.restype = ctypes.c_char_p
    return lib, fn


# Kernels that address their operands with 64-bit offsets: their extents
# (n, d) are ints, their element counts need not be (K1 on 32768 x 65536).
_INT64_ADDRESSED = {"gram_moment"}


def _check(name: str, tensors: dict[str, torch.Tensor], dtypes) -> torch.device:
    """Common argument checks; returns the one CUDA device of all tensors."""
    devices = {t.device for t in tensors.values()}
    if len(devices) != 1:
        raise ValueError(f"{name}: tensors on several devices {sorted(map(str, devices))}")
    (device,) = devices
    if device.type != "cuda":
        raise ValueError(f"{name} is the CUDA kernel and takes CUDA tensors, got "
                         f"{device}; the plain version serves CPU tensors")
    for arg, t in tensors.items():
        if t.dtype not in dtypes:
            raise TypeError(f"{name}: {arg} has dtype {t.dtype}, kernel takes "
                            f"{sorted(map(str, dtypes))}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {arg} must be contiguous")
        if (max(t.shape, default=1) > _INT32_MAX if name in _INT64_ADDRESSED
                else t.numel() > _INT32_MAX):
            raise ValueError(f"{name}: {arg} has {t.numel()} elements, more "
                             "than the kernel's int32 extents allow")
    return device


def _launch(name: str, device: torch.device, *args) -> None:
    lib, fn = _fn(name)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = fn(*args, stream)
    _raise_on(name, lib, rc)


def _raise_on(name: str, lib: ctypes.CDLL, rc: int) -> None:
    if rc != 0:
        what = ("bad argument" if rc < 0
                else lib.kernel_error_string(rc).decode())
        raise RuntimeError(f"{name} kernel launch failed: {what} (code {rc})")


def gram_moment_cuda(A: torch.Tensor, b: torch.Tensor
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """K1: (G, h) = (A^T A, A^T b) in one pass over A, deterministic.

    A: (n, d), b: (n,), both f32 / f64 / bf16 / f16 of one dtype. G (d, d)
    and h (d,) are float64 for float64 input, float32 otherwise. Float32,
    bfloat16 and float16 run the 3xTF32 tensor-core SYRK on A in place,
    float64 and a single row the CUDA-core kernel (:func:`gram_tile`).
    """
    device = _check("gram_moment", {"A": A, "b": b}, _GRAM_DTYPES)
    if A.ndim != 2 or b.shape != (A.shape[0],):
        raise ValueError(f"gram_moment: A must be (n, d) and b (n,), got "
                         f"{tuple(A.shape)} and {tuple(b.shape)}")
    if A.dtype != b.dtype:
        raise TypeError(f"gram_moment: A is {A.dtype} but b is {b.dtype}")
    G, h = _gram_moment(A, b, gram_tile(*A.shape, A.dtype))
    gram_moment_cuda.launches += A.shape[1] > 0      # d = 0 launches nothing
    return G, h


def _gram_moment(A: torch.Tensor, b: torch.Tensor, tile: int
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """K1's launch with its route given (``tile``: see :func:`gram_tile`);
    the wrapper's arguments already checked."""
    n, d = A.shape
    acc = torch.float64 if A.dtype == torch.float64 else torch.float32
    G = torch.empty((d, d), dtype=acc, device=A.device)
    h = torch.empty((d,), dtype=acc, device=A.device)
    if d > 0:
        _launch("gram_moment", A.device, A.data_ptr(), b.data_ptr(), G.data_ptr(),
                h.data_ptr(), n, d, _GRAM_DTYPES[A.dtype], tile)
    return G, h


def gemm_nt_cuda(C: torch.Tensor, A: torch.Tensor, B: torch.Tensor, *,
                 alpha: float = -1.0) -> torch.Tensor:
    """K2: C + alpha * A @ B^T. C: (m, n), A: (m, k), B: (n, k); f32 or f64.

    Float32 runs the 3xTF32 tensor-core tile GEMM at the tile edge
    :func:`gemm_tile` picks, float64 the CUDA-core tile loop. Bitwise
    deterministic."""
    device = _check("gemm_nt", {"C": C, "A": A, "B": B}, _FLOAT_DTYPES)
    if not (C.ndim == A.ndim == B.ndim == 2) or A.shape[0] != C.shape[0] \
            or B.shape[0] != C.shape[1] or A.shape[1] != B.shape[1]:
        raise ValueError(f"gemm_nt: need C (m, n), A (m, k), B (n, k), got "
                         f"{tuple(C.shape)}, {tuple(A.shape)}, {tuple(B.shape)}")
    if not C.dtype == A.dtype == B.dtype:
        raise TypeError(f"gemm_nt: mixed dtypes {C.dtype}, {A.dtype}, {B.dtype}")
    out = _gemm_nt(C, A, B, alpha, gemm_tile(*C.shape, C.dtype), device)
    gemm_nt_cuda.launches += out.numel() > 0      # m = 0 or n = 0 launches nothing
    return out


def _gemm_nt(C: torch.Tensor, A: torch.Tensor, B: torch.Tensor, alpha: float,
             tile: int, device: torch.device) -> torch.Tensor:
    """K2's launch with its route given (``tile``: see :func:`gemm_tile`);
    the wrapper's arguments already checked."""
    m, n = C.shape
    out = torch.empty_like(C)
    if m > 0 and n > 0:
        _launch("gemm_nt", device, C.data_ptr(), A.data_ptr(), B.data_ptr(),
                out.data_ptr(), m, n, A.shape[1], float(alpha),
                _FLOAT_DTYPES[C.dtype], tile)
    return out


def panel_transform_cuda(L11: torch.Tensor, X1: torch.Tensor, *,
                         sign: float = 1.0) -> tuple[torch.Tensor, torch.Tensor]:
    """P: ``(L11', T)`` of one diagonal panel against all r update vectors.

    L11: (bw, bw) lower-triangular with 1 <= bw <= 32, X1: (r, bw) with
    r >= 1; f32 or f64. T is (bw + r, bw + r). The kernel works in place;
    here on a copy of L11, whose upper triangle it leaves as it was.
    """
    device = _check("panel_transform", {"L11": L11, "X1": X1}, _FLOAT_DTYPES)
    bw = L11.shape[0] if L11.ndim == 2 else -1
    if L11.shape != (bw, bw) or not 1 <= bw <= 32 or X1.ndim != 2 \
            or X1.shape[1] != bw or X1.shape[0] < 1:
        raise ValueError(f"panel_transform: need L11 (bw, bw) with bw <= 32 and "
                         f"X1 (r >= 1, bw), got {tuple(L11.shape)}, "
                         f"{tuple(X1.shape)}")
    if L11.dtype != X1.dtype:
        raise TypeError(f"panel_transform: L11 is {L11.dtype}, X1 is {X1.dtype}")
    panels = _Panels(L11.clone(), X1, bw, sign)
    panels.transform(0, bw)
    w = bw + X1.shape[0]
    return panels.L, panels.T.view(w, w)


def panel_in_place(n: int, dtype: torch.dtype) -> bool:
    """Whether K2's panel entry takes an n-wide panel product (n = bw + r)
    in place: all of T and a 32-row strip of Z in one CTA's shared memory
    (float32 up to n = 160, float64 up to n = 96). Wider products go out of
    place into a workspace and are copied back. The rule is the library's
    (``gemm_nt_panel_in_place`` in ``csrc/gemm_nt.cu``), so this loads it."""
    fn = _build.load("gemm_nt").gemm_nt_panel_in_place
    fn.argtypes, fn.restype = [_INT, _INT], _INT
    return bool(fn(n, _FLOAT_DTYPES[dtype]))


def _panel_gemm(entry, L: torch.Tensor, X: torch.Tensor, c0: int, c1: int,
                T: torch.Tensor, O: torch.Tensor | None, stream: int) -> None:
    """One launch of K2's panel entry (``entry``: its library and function)
    on the trailing rows c1: of the panel L[:, c0:c1]: Z @ T back over Z in
    place, or with a workspace O (at least d - c1 rows of bw + r) out of
    place and copied back. Arguments already checked."""
    lib, fn = entry
    d, s = L.shape[0], L.element_size()
    bw = c1 - c0
    m, n = d - c1, bw + X.shape[0]
    with torch.cuda.device(L.device):
        rc = fn(L.data_ptr() + (c1 * d + c0) * s, d, X.data_ptr() + c1 * s, d,
                T.data_ptr(), None if O is None else O.data_ptr(), m, bw, n,
                _FLOAT_DTYPES[L.dtype], stream)
    _raise_on("gemm_nt_panel", lib, rc)
    gemm_nt_cuda.launches += 1          # K2's count, from either entry
    if O is not None:
        L[c1:, c0:c1].copy_(O[:m, :bw])
        X[:, c1:].copy_(O[:m, bw:].T)


class _Panels:
    """P and K2 over one factor L (d, d) and its update vectors X (r, d),
    both row-major and updated in place.

    Checks the operands and allocates the workspaces (T, P's arrival count,
    and the out-of-place product when the panels are too wide to take in
    place) once, and takes the library entries and the stream once, so that
    each panel is two bare launches: :meth:`transform` (P) writes L11' into
    L and T into its workspace, :meth:`gemm` (K2) writes [L21 | X2^T] @ T
    back over L21 and X2.
    """

    def __init__(self, L: torch.Tensor, X: torch.Tensor, block_size: int,
                 sign: float):
        device = _check("chol_update_blocked", {"L": L, "X": X}, _FLOAT_DTYPES)
        d = L.shape[0] if L.ndim == 2 else -1
        if L.shape != (d, d) or X.ndim != 2 or X.shape[1] != d or X.shape[0] < 1:
            raise ValueError(f"panels: need L (d, d) and X (r >= 1, d), got "
                             f"{tuple(L.shape)}, {tuple(X.shape)}")
        if not 1 <= block_size <= 32:
            raise ValueError(f"panels: block size {block_size} not in 1..32")
        if L.dtype != X.dtype:
            raise TypeError(f"panels: L is {L.dtype}, X is {X.dtype}")
        self.L, self.X, self.d, self.r = L, X, d, X.shape[0]
        self.sign, self.code = float(sign), _FLOAT_DTYPES[L.dtype]
        w = min(block_size, d) + self.r
        self.T = torch.empty(w * w, dtype=L.dtype, device=device)
        self.arrivals = torch.zeros(1, dtype=torch.int32, device=device)
        self.O = (None if panel_in_place(w, L.dtype) else
                  torch.empty((max(d - block_size, 0), w), dtype=L.dtype, device=device))
        self.p_lib, self.p = _fn("panel_transform")
        self.k2 = _fn("gemm_nt_panel")
        with torch.cuda.device(device):
            self.stream = torch.cuda.current_stream(device).cuda_stream

    def transform(self, c0: int, c1: int) -> None:
        """P on the panel L[c0:c1, c0:c1]: L11' in place, T (bw + r square)
        at the head of its workspace."""
        bw, d, s = c1 - c0, self.d, self.L.element_size()
        with torch.cuda.device(self.L.device):
            rc = self.p(self.L.data_ptr() + (c0 * d + c0) * s, d,
                        self.X.data_ptr() + c0 * s, d, self.T.data_ptr(),
                        self.arrivals.data_ptr(), None, bw, self.r, self.sign,
                        self.code, self.stream)
        _raise_on("panel_transform", self.p_lib, rc)
        panel_transform_cuda.launches += 1

    def gemm(self, c0: int, c1: int) -> None:
        """K2 on the trailing rows c1: of the panel: Z @ T back over Z."""
        _panel_gemm(self.k2, self.L, self.X, c0, c1, self.T, self.O, self.stream)


def blocked_update_cuda(L: torch.Tensor, X: torch.Tensor, *, sign: float,
                        block_size: int) -> None:
    """Every diagonal panel of the blocked rank-r up/downdate of L (d, d)
    by X (r, d), in place on both: P then K2 a panel, two launches and no
    allocation (plus K2's copy back above :func:`panel_in_place`)."""
    d = L.shape[0]
    panels = _Panels(L, X, block_size, sign)
    for c0 in range(0, d, block_size):
        c1 = min(c0 + block_size, d)
        panels.transform(c0, c1)
        if c1 < d:
            panels.gemm(c0, c1)


def panel_gemm_cuda(L: torch.Tensor, X: torch.Tensor, c0: int, c1: int,
                    T: torch.Tensor) -> None:
    """K2's panel entry alone: Z = [L[c1:, c0:c1] | X[:, c1:]^T] becomes
    Z @ T in place. L (d, d), X (r, d), T (c1 - c0 + r, c1 - c0 + r); all
    row-major of one dtype (f32 or f64). Out of place through a workspace
    above :func:`panel_in_place`."""
    device = _check("gemm_nt_panel", {"L": L, "X": X, "T": T}, _FLOAT_DTYPES)
    d = L.shape[0] if L.ndim == 2 else -1
    bw, r = c1 - c0, X.shape[0] if X.ndim == 2 else -1
    if (L.shape != (d, d) or X.ndim != 2 or X.shape[1] != d or r < 1
            or T.shape != (bw + r, bw + r) or not 0 <= c0 < c1 < d):
        raise ValueError(f"gemm_nt_panel: need L (d, d), X (r >= 1, d), "
                         f"0 <= c0 < c1 < d and T (c1 - c0 + r square), got L "
                         f"{tuple(L.shape)}, X {tuple(X.shape)}, c0 {c0}, c1 "
                         f"{c1}, T {tuple(T.shape)}")
    if not L.dtype == X.dtype == T.dtype:
        raise TypeError(f"gemm_nt_panel: mixed dtypes {L.dtype}, {X.dtype}, {T.dtype}")
    n = bw + r
    O = (None if panel_in_place(n, L.dtype) else
         torch.empty((d - c1, n), dtype=L.dtype, device=device))
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
    _panel_gemm(_fn("gemm_nt_panel"), L, X, c0, c1, T, O, stream)


def feature_splits(n: int, m: int, dtype: torch.dtype) -> tuple[int, int]:
    """(splits, rows per split) of the tile routine's row split for n rows,
    m features (float64 K3 and K4 run it; the float32 figures describe
    the routine at 128-wide tiles).

    A tile-routine CTA fills an SM (``__launch_bounds__(256, 1)``), so the CTAs of
    one launch run in waves of ``_FEATURE_SMS``. The split count minimises
    waves times rows per split, the time of the slowest SM, and takes the
    fewest splits on a tie; each split keeps at least 4 chunks of rows. It
    depends only on the shapes and dtype, so the bits of G do not depend on
    the card.
    """
    def cdiv(a: int, b: int) -> int:
        return -(-a // b)

    tiles = cdiv(m, 64 if dtype == torch.float64 else 128)
    ctas = tiles * (tiles + 1) // 2
    chunks = max(1, cdiv(n, _FEATURE_ROWS))
    best = None
    for want in range(1, min(_FEATURE_MAX_SPLITS, max(1, chunks // 4)) + 1):
        rows = cdiv(chunks, want) * _FEATURE_ROWS
        splits = max(1, cdiv(n, rows))
        cost = cdiv(ctas * splits, _FEATURE_SMS) * rows
        if best is None or cost < best[0]:
            best = (cost, splits, rows)
    return best[1], best[2]


def sketch_chunks(n: int) -> tuple[int, int]:
    """(chunks, rows per chunk) of the chunk route (K3, K4) for n rows.

    Float32 and bfloat16-input K3 and K4 walk their rows in chunks of a fixed
    ``_SKETCH_CHUNK_ROWS``: T of one chunk goes through a workspace of that
    many rows, whatever n is, and the chunks' Gram contributions are added
    in chunk order. Depends only on n, so the bits of G do not depend on the
    card. n = 0 is one empty chunk (G and h are zeros).
    """
    return max(1, -(-n // _SKETCH_CHUNK_ROWS)), _SKETCH_CHUNK_ROWS


def _feature_gram(name: str, X: torch.Tensor, b: torch.Tensor,
                  M: torch.Tensor, c: torch.Tensor | None, tile: int | None = None
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Checks, outputs and launch shared by K3 (c None) and K4; ``tile``
    (the chunk route's SYRK tile edge) defaults to :func:`syrk_tile` (m)."""
    tensors = {"A" if c is None else "X": X, "b": b,
               "R" if c is None else "W": M}
    if c is not None:
        tensors["c"] = c
    device = _check(name, tensors, _GRAM_DTYPES)
    if X.ndim != 2 or b.shape != (X.shape[0],) or M.ndim != 2 \
            or M.shape[0] != X.shape[1] or X.shape[1] < 1 or M.shape[1] < 1 \
            or (c is not None and c.shape != (M.shape[1],)):
        raise ValueError(
            f"{name}: need X (n, d >= 1), b (n,), map (d, m >= 1)"
            f"{'' if c is None else ', c (m,)'}; got {tuple(X.shape)}, "
            f"{tuple(b.shape)}, {tuple(M.shape)}"
            f"{'' if c is None else ', ' + str(tuple(c.shape))}")
    code = _FEATURE_DTYPES.get((X.dtype, M.dtype))
    if code is None or b.dtype != X.dtype or (c is not None and c.dtype != M.dtype):
        raise TypeError(
            f"{name}: got input {X.dtype}, b {b.dtype}, map {M.dtype}"
            f"{'' if c is None else f', c {c.dtype}'}; the kernel takes b in "
            "the input's dtype, c in the map's, and (input, map) one of "
            f"{[(str(a), str(r)) for a, r in _FEATURE_DTYPES]}")
    n, d = X.shape
    m = M.shape[1]
    acc = torch.float64 if X.dtype == torch.float64 else torch.float32
    G = torch.empty((m, m), dtype=acc, device=device)
    h = torch.empty((m,), dtype=acc, device=device)
    if acc == torch.float32:
        # the chunk route: the workspace holds one chunk of T, each row padded
        # to a multiple of 4 floats
        splits, rows = sketch_chunks(n)
        work = torch.empty(max(1, min(n, rows)) * (-(-m // 4) * 4),
                           dtype=acc, device=device)
    else:
        splits, rows = feature_splits(n, m, X.dtype)
        work = (torch.empty(splits * (m * m + m), dtype=acc, device=device)
                if splits > 1 else None)
    wptr = None if work is None else work.data_ptr()
    tile = syrk_tile(m) if tile is None else tile
    if c is None:
        _launch(name, device, X.data_ptr(), b.data_ptr(), M.data_ptr(),
                G.data_ptr(), h.data_ptr(), wptr, n, d, m, splits, rows, tile, code)
    else:
        _launch(name, device, X.data_ptr(), b.data_ptr(), M.data_ptr(),
                c.data_ptr(), G.data_ptr(), h.data_ptr(), wptr, n, d, m,
                splits, rows, math.sqrt(2.0 / m), tile, code)
    return G, h


def sketch_gram_cuda(A: torch.Tensor, b: torch.Tensor, R: torch.Tensor
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """K3: (G, h) = ((AR)^T AR, (AR)^T b).

    A: (n, d), b: (n,) of one dtype, R: (d, m); float32 with a float32 R,
    bfloat16 with a bfloat16 or float32 R, or float64 throughout. G (m, m)
    and h (m,) are float64 for float64 input, float32 otherwise.
    Float32 and bfloat16 input compute T = AR once per row, 4096 rows at a
    time through a workspace of one chunk (:func:`sketch_chunks`), and fold
    each chunk into G with the SYRK (:func:`syrk_tile`), at float32 accuracy
    on the tensor cores; float64 keeps T in shared memory and rebuilds it
    per G tile. Bitwise deterministic.
    """
    G, h = _feature_gram("sketch_gram", A, b, R, None)
    sketch_gram_cuda.launches += 1
    return G, h


def rff_gram_cuda(X: torch.Tensor, b: torch.Tensor, W: torch.Tensor,
                  c: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """K4: T = sqrt(2/D) cos(XW + c), (G, h) = (T^T T, T^T b).

    X: (n, d), b: (n,), W: (d, D), c: (D,); dtypes as for K3, with c in W's
    dtype. The scale uses D = W.shape[1]. Float32 and bfloat16 input take
    K3's chunk route, the cosine as the featurize GEMM's epilogue (T of one
    4096-row chunk at a time in device memory); float64 never writes T.
    """
    G, h = _feature_gram("rff_gram", X, b, W, c)
    rff_gram_cuda.launches += 1
    return G, h


_SWA_DTYPES = {torch.float32: 0, torch.bfloat16: 2}
_SWA_HEAD_DIMS = (64, 80, 128)


def swa_flash_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                   window: int | None, causal: bool = True) -> torch.Tensor:
    """K5: softmax(q k^T hd^-0.5 + mask) v, the window and causal mask of
    ``swa_flash_pallas``, KV blocks outside the mask skipped.

    q: (B, S, H, hd); k, v: (B, S, H_kv, hd) with H % H_kv == 0 (query head
    h reads KV head h // (H / H_kv)); one dtype, float32 or bfloat16; hd 64,
    80 or 128; contiguous. ``window`` None or >= 1. Returns (B, S, H, hd) in
    q's dtype. Ragged S is masked in the kernel. Bitwise deterministic.
    """
    device = _check("swa_flash", {"q": q, "k": k, "v": v}, _SWA_DTYPES)
    if q.ndim != 4 or k.ndim != 4 or k.shape != v.shape \
            or k.shape[:2] != q.shape[:2] or k.shape[3] != q.shape[3] \
            or k.shape[2] < 1 or q.shape[2] % k.shape[2] \
            or q.shape[3] not in _SWA_HEAD_DIMS:
        raise ValueError(f"swa_flash: need q (B, S, H, hd) and k, v (B, S, H_kv, hd) "
                         f"with H % H_kv == 0 and hd in {_SWA_HEAD_DIMS}, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    if not q.dtype == k.dtype == v.dtype:
        raise TypeError(f"swa_flash: mixed dtypes {q.dtype}, {k.dtype}, {v.dtype}")
    if window is not None and window < 1:
        raise ValueError(f"swa_flash: window must be None or >= 1, got {window}")
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("swa_flash: q, k, v must be 16-byte aligned")
    B, S, H, hd = q.shape
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    # a window of S or more masks nothing that causality does not
    w = -1 if window is None or window >= S else int(window)
    _launch("swa_flash", device, q.data_ptr(), k.data_ptr(), v.data_ptr(),
            out.data_ptr(), B, S, H, k.shape[2], hd, w, int(bool(causal)),
            hd ** -0.5, _SWA_DTYPES[q.dtype])
    swa_flash_cuda.launches += 1
    return out


gram_moment_cuda.launches = 0
gemm_nt_cuda.launches = 0
panel_transform_cuda.launches = 0
sketch_gram_cuda.launches = 0
rff_gram_cuda.launches = 0
swa_flash_cuda.launches = 0

KERNELS = {"gram_moment": gram_moment_cuda, "gemm_nt": gemm_nt_cuda,
           "panel_transform": panel_transform_cuda,
           "sketch_gram": sketch_gram_cuda, "rff_gram": rff_gram_cuda,
           "swa_flash": swa_flash_cuda}


def launch_counts() -> dict[str, int]:
    """Launches of each kernel since the last :func:`reset_launch_counts`."""
    return {name: fn.launches for name, fn in KERNELS.items()}


def reset_launch_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0
