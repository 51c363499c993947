// K2: O = C + alpha * A @ B^T, and the panel product of the blocked
// Cholesky update in place.
//
// Replaces the TPU kernel `gemm_nt_pallas` (src/repro/kernels/gram.py, body
// `_gemm_nt_kernel`). The reference calls it the inner tile of the sharded
// block Cholesky (server/distributed.py: the SYRK G_ij -= L_ik L_jk^T, the
// TRSM as a GEMM against the inverted diagonal tile, the tile update's
// [L_strip | X^T] @ T and the composition of the tile's transforms), and
// the trailing product of every blocked rank-r factor up/downdate
// (server/cholesky.py, `chol_update_blocked`): Z @ T with Z = [L21 | X2^T]
// of shape (d - c1, bw + r) and T the (bw + r, bw + r) panel
// transformation, called as gemm_nt(0, Z, T^T, alpha=1) once per diagonal
// panel. Two entries:
//
//   `gemm_nt`        the reference's contract on dense row-major operands.
//                    Float32 runs on the tensor cores (below); float64 on
//                    the CUDA-core tile loop: one CTA per 64 x 64 output
//                    tile, 256 threads as a 16 x 16 grid each holding a
//                    4 x 4 block of accumulators, k staged 16 deep through
//                    shared memory.
//   `gemm_nt_panel`  the panel product with no C and no copies: Z is read
//                    where it lies, L21 = L[c1:, c0:c1] at its leading
//                    dimension and X2^T from the rows of X = X[:, c1:], and
//                    the result goes back over the same elements.
//
// Float32 `gemm_nt` (`gemm_nt_tc_kernel`). At the sharded backend's shapes
// on an H100 (d 4096 on a (4, 2) mesh, bs 256, r 64; m, n, k): the SYRK
// 1024, 2048, 256 is 1.07 GFLOP, bound by operations (6.5 us at 3xTF32's
// 495/3 TFLOP/s, 16 us at FP32's 67); the TRSM 3840, 256, 256 moves 12.1 MB
// (3.6 us, bytes); the trailing update 1024, 320, 320 4.3 MB (1.3 us,
// bytes); the tile composition 320, 96, 96 is a few microseconds of launch.
// k is only 96-256, so a tile's latency, not the card's rate, is what a
// launch pays. The design:
//   * 3xTF32 on mma.sync.m16n8k8 (`mma_ktile` of tc_syrk.cuh, B read as
//     its (n, k) rows): small*big + big*small + big*big of the TF32 splits,
//     each 32-deep k-tile summed from zero in the tensor cores and added to
//     the running sum by a round-to-nearest FADD, so the tensor cores'
//     round-toward-zero stays off the long sum; float32 accuracy at a third
//     of the TF32 rate, 2.5x the FP32 ceiling.
//   * Operand tiles through tc_syrk.cuh's three-stage cp.async ring: 16-byte
//     copies where A and B are 16-byte aligned and k % 4 == 0, else 4-byte
//     copies; rows >= m or n and columns >= k load as zeros. Rows padded to
//     36 floats, so each fragment load hits 32 distinct banks.
//   * Square output tiles of edge 128 (8 warps of 64 x 32, one CTA an SM)
//     or 64 (4 warps of 32 x 32, four CTAs an SM), the edge chosen by the
//     caller from the shape alone (`kernels/gram.py::gemm_tile`): the least
//     waves x tile area on 132 SMs, so the SYRK runs 128 CTAs of 128 and
//     the TRSM (240), trailing update (80) and composition (10) of 64.
//   * Epilogue O = C + alpha * acc: the accumulators staged through the
//     ring's shared memory, then C read and O written as 16-byte vectors
//     along rows where C and O are aligned and n % 4 == 0.
//   * Every output element is one thread's sum over k in a fixed order, no
//     split over k and no atomics: the same inputs give the same bits on
//     every run, and at either tile edge.
// Float64 `gemm_nt`, the in-place panel entry and its out-of-place route
// for wide panels (`PanelZT` through `launch_tiles`, A read transposed out
// of X) keep the CUDA-core loops, bit for bit.
//
// What bounds the panel product on an H100: at bw = 32, r = 64 (m <= 4064,
// n = k = 96) a launch moves ~3.2 MB and does 75 MFLOP, ~1 us of either,
// so its time is the launch and the latency of one load-compute-store pass.
// Design (in place): one CTA owns a strip of 32 trailing rows across all n
// columns. It stages its strip of Z and all of T in shared memory with
// cp.async, computes the 32 x n strip with plain FP32 (or FP64) fused
// multiply-adds on the CUDA cores (warp w: rows w + 8p; lane: columns
// lane + 32q), stages the result over its Z strip, and stores it back with
// the load's coalesced mapping. No other CTA reads or writes those rows, so
// the in-place write cannot race. That takes T and the strip in shared
// memory, (n * 32 NQ + 32 (n + 1)) elements for n <= 32 NQ: up to n = 160 in
// float32 (r <= 128) and n = 96 in float64 (r <= 64). Wider panels (the rare
// large-rank updates, where the product dominates) run out of place: the
// CUDA-core tile loop reads Z and T through the same strides into a
// workspace O (m, n), which the caller copies back.

#include <cuda_runtime.h>
#include <stdint.h>

#include "tc_syrk.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 64;
constexpr int kBK = 16;
constexpr int kStrip = 32;              // rows of Z per CTA of the panel entry
constexpr int kStripRows = kStrip / 8;  // of them, per warp
constexpr int kPanelSmem = 200 * 1024;  // its shared memory cap (bytes)

__device__ __forceinline__ float fma_t(float a, float b, float c) { return fmaf(a, b, c); }
__device__ __forceinline__ double fma_t(double a, double b, double c) { return fma(a, b, c); }

// The reference's operands: A (m, k), B (n, k), C and O (m, n), row-major.
template <typename T>
struct DenseNT {
  const T* C;
  const T* A;
  const T* B;
  T* O;
  int n, k;
  T alpha;
  __device__ T a(int i, int kk) const { return A[static_cast<int64_t>(i) * k + kk]; }
  __device__ T b(int j, int kk) const { return B[static_cast<int64_t>(j) * k + kk]; }
  __device__ void store(int i, int j, T acc) const {
    const int64_t at = static_cast<int64_t>(i) * n + j;
    O[at] = C[at] + alpha * acc;
  }
};

// The panel's operands: A = Z = [L21 | X2^T], B = T^T, O a workspace.
template <typename T>
struct PanelZT {
  const T* L;   // L[c1, c0], leading dimension ldl
  const T* X;   // X[0, c1], leading dimension ldx
  const T* Tm;  // T (n, n)
  T* O;         // (m, n)
  int ldl, ldx, bw, n;
  __device__ T a(int i, int kk) const {
    return kk < bw ? L[static_cast<int64_t>(i) * ldl + kk]
                   : X[static_cast<int64_t>(kk - bw) * ldx + i];
  }
  __device__ T b(int j, int kk) const { return Tm[static_cast<int64_t>(kk) * n + j]; }
  __device__ void store(int i, int j, T acc) const { O[static_cast<int64_t>(i) * n + j] = acc; }
};

template <typename T, typename Ops>
__global__ void __launch_bounds__(kThreads)
gemm_nt_kernel(Ops ops, int m, int n, int k) {
  // +1 column of padding: the loads below write consecutive kk from
  // consecutive threads, which would otherwise hit one bank.
  __shared__ T As[kBK][kTile + 1];
  __shared__ T Bs[kBK][kTile + 1];
  const int i0 = blockIdx.y * kTile;
  const int j0 = blockIdx.x * kTile;
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;

  T acc[4][4];
#pragma unroll
  for (int p = 0; p < 4; ++p)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[p][q] = T(0);

  for (int k0 = 0; k0 < k; k0 += kBK) {
    for (int e = tid; e < kBK * kTile; e += kThreads) {
      const int r = e / kBK;
      const int kk = e % kBK;
      const bool kin = k0 + kk < k;
      As[kk][r] = (kin && i0 + r < m) ? ops.a(i0 + r, k0 + kk) : T(0);
      Bs[kk][r] = (kin && j0 + r < n) ? ops.b(j0 + r, k0 + kk) : T(0);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      T a[4], bb[4];
#pragma unroll
      for (int p = 0; p < 4; ++p) {
        a[p] = As[kk][ty + 16 * p];
        bb[p] = Bs[kk][tx + 16 * p];
      }
#pragma unroll
      for (int p = 0; p < 4; ++p)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[p][q] = fma_t(a[p], bb[q], acc[p][q]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int p = 0; p < 4; ++p) {
    const int r = i0 + ty + 16 * p;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int c = j0 + tx + 16 * q;
      if (r < m && c < n) ops.store(r, c, acc[p][q]);
    }
  }
}

template <typename T, typename Ops>
int launch_tiles(const Ops& ops, int m, int n, int k, cudaStream_t stream) {
  const dim3 grid((n + kTile - 1) / kTile, (m + kTile - 1) / kTile);
  gemm_nt_kernel<T, Ops><<<grid, kThreads, 0, stream>>>(ops, m, n, k);
  return static_cast<int>(cudaGetLastError());
}

// The float32 route's CTA for an output tile edge TILE: WM x WN warps.
template <int TILE> struct TcShape;
template <> struct TcShape<64> { static constexpr int WM = 2, WN = 2, kMinBlocks = 4; };
template <> struct TcShape<128> { static constexpr int WM = 2, WN = 4, kMinBlocks = 1; };

template <int TILE>
struct TcGemm : TcShape<TILE> {
  using S = TcShape<TILE>;
  static constexpr int kThreads = 32 * S::WM * S::WN;
  static constexpr int BK = 32;                     // k per ring stage
  static constexpr int LD = BK + 4;                 // fragments on distinct banks
  static constexpr int MT = TILE / S::WM / 16, NT = TILE / S::WN / 8;
  static constexpr int kStage = 2 * TILE * LD;      // the A tile, then the B tile
  static constexpr int kOutLD = TILE + 8;           // staged output: float2 stores conflict-free
  static constexpr int kSmem = kStages * kStage * static_cast<int>(sizeof(float));
  static_assert(TILE * kOutLD <= kStages * kStage, "the output tile does not fit the ring");
};

// O = C + alpha * A B^T for the TILE x TILE output tile (blockIdx.y,
// blockIdx.x); kVec: 16-byte operand copies; vec_out: C and O 16-byte
// aligned and n % 4 == 0.
template <int TILE, bool kVec>
__global__ void __launch_bounds__(TcGemm<TILE>::kThreads, TcGemm<TILE>::kMinBlocks)
gemm_nt_tc_kernel(const float* __restrict__ C, const float* __restrict__ A,
                  const float* __restrict__ B, float* __restrict__ O, int m, int n,
                  int k, float alpha, int vec_out) {
  using P = TcGemm<TILE>;
  constexpr int MT = P::MT, NT = P::NT, BK = P::BK, LD = P::LD, TH = P::kThreads;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* smem = reinterpret_cast<float*>(smem_raw);
  const int i0 = blockIdx.y * TILE, j0 = blockIdx.x * TILE;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int wm0 = (warp / P::WN) * (TILE / P::WM), wn0 = (warp % P::WN) * (TILE / P::WN);

  float acc[MT][NT][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;

  pipeline(
      (k + BK - 1) / BK,
      [&](int kt, int stage) {
        float* As = smem + stage * P::kStage;
        const int k0 = kt * BK;
        load_tile<TILE, BK, TH, kVec>(As, LD, A, k, i0, k0, m, k, tid);
        load_tile<TILE, BK, TH, kVec>(As + TILE * LD, LD, B, k, j0, k0, n, k, tid);
      },
      [&](int stage) {
        const float* As = smem + stage * P::kStage;
        mma_ktile<MT, NT, false, BK, true>(acc, As, LD, As + TILE * LD, LD, wm0, wn0, lane);
      });

  // The ring is free once every warp has left its last k-tile: stage the
  // accumulators there as the output tile, row-major.
  cp_async_wait<0>();
  __syncthreads();
  float* Os = smem;
  const int g = lane / 4, t = lane % 4;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = wm0 + mt * 16 + g + 8 * h, c = wn0 + nt * 8 + 2 * t;
        *reinterpret_cast<float2*>(Os + r * P::kOutLD + c) =
            make_float2(acc[mt][nt][2 * h], acc[mt][nt][2 * h + 1]);
      }
  __syncthreads();

  // Consecutive threads on consecutive 4-column groups of a row.
  constexpr int kQ = TILE / 4;
  for (int e = tid; e < TILE * kQ; e += TH) {
    const int r = e / kQ, c = (e % kQ) * 4;
    const int gi = i0 + r, gj = j0 + c;
    if (gi >= m || gj >= n) continue;
    const float4 a = *reinterpret_cast<const float4*>(Os + r * P::kOutLD + c);
    const int64_t at = static_cast<int64_t>(gi) * n + gj;
    if (vec_out) {                 // n % 4 == 0: all four columns are in range
      const float4 cv = *reinterpret_cast<const float4*>(C + at);
      *reinterpret_cast<float4*>(O + at) =
          make_float4(fmaf(alpha, a.x, cv.x), fmaf(alpha, a.y, cv.y),
                      fmaf(alpha, a.z, cv.z), fmaf(alpha, a.w, cv.w));
    } else {
      const float v[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
      for (int q = 0; q < 4; ++q)
        if (gj + q < n) O[at + q] = fmaf(alpha, v[q], C[at + q]);
    }
  }
}

template <int TILE>
int launch_tc(const float* C, const float* A, const float* B, float* O, int m, int n,
              int k, float alpha, cudaStream_t stream) {
  using P = TcGemm<TILE>;
  const auto addr = [](const void* p) { return reinterpret_cast<uintptr_t>(p); };
  const bool vec = (addr(A) | addr(B)) % 16 == 0 && k % 4 == 0;
  const int vec_out = (addr(C) | addr(O)) % 16 == 0 && n % 4 == 0;
  auto run = [&](auto kernel) {
    // per kernel and device: set on the current device at every launch
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, P::kSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
    const dim3 grid((n + TILE - 1) / TILE, (m + TILE - 1) / TILE);
    kernel<<<grid, P::kThreads, P::kSmem, stream>>>(C, A, B, O, m, n, k, alpha, vec_out);
    return static_cast<int>(cudaGetLastError());
  };
  return vec ? run(gemm_nt_tc_kernel<TILE, true>) : run(gemm_nt_tc_kernel<TILE, false>);
}

__device__ __forceinline__ void cp_async(void* smem, const void* gmem, float) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::
                   "r"(static_cast<unsigned>(__cvta_generic_to_shared(smem))), "l"(gmem));
}
__device__ __forceinline__ void cp_async(void* smem, const void* gmem, double) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::
                   "r"(static_cast<unsigned>(__cvta_generic_to_shared(smem))), "l"(gmem));
}

// Shared memory of the in-place panel entry at width n (NQ column groups).
template <typename T>
__host__ __device__ constexpr int panel_smem(int n, int nq) {
  return static_cast<int>(sizeof(T)) * (n * 32 * nq + kStrip * (n + 1));
}

// One element of the strip: Z[i0 + i, c] lies in L (c < bw) or in X.
template <typename T>
__device__ __forceinline__ T* strip_at(T* L, int ldl, T* X, int ldx, int bw,
                                       int row, int c) {
  return c < bw ? L + static_cast<int64_t>(row) * ldl + c
                : X + static_cast<int64_t>(c - bw) * ldx + row;
}

template <typename T, int NQ>
__global__ void __launch_bounds__(kThreads)
gemm_nt_panel_kernel(T* __restrict__ L, int ldl, T* __restrict__ X, int ldx,
                     const T* __restrict__ Tm, int m, int bw, int n) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int kPitchT = 32 * NQ;
  T* const Ts = reinterpret_cast<T*>(smem_raw);   // [n][kPitchT]
  T* const Zs = Ts + n * kPitchT;                 // [kStrip][n + 1]
  const int pz = n + 1;
  const int i0 = blockIdx.x * kStrip;
  const int rows = min(kStrip, m - i0);
  const int tid = threadIdx.x;
  const int r = n - bw;

  for (int e = tid; e < n * kPitchT; e += kThreads) {
    const int kk = e / kPitchT, c = e % kPitchT;
    if (c < n) cp_async(Ts + e, Tm + static_cast<int64_t>(kk) * n + c, T(0));
    else Ts[e] = T(0);
  }
  // L21 rows: consecutive threads on consecutive columns; X2^T: on
  // consecutive rows of the strip, which are consecutive in X's rows.
  for (int e = tid; e < kStrip * bw; e += kThreads) {
    const int i = e / bw, c = e % bw;
    if (i < rows) cp_async(Zs + i * pz + c, strip_at(L, ldl, X, ldx, bw, i0 + i, c), T(0));
    else Zs[i * pz + c] = T(0);
  }
  for (int e = tid; e < kStrip * r; e += kThreads) {
    const int i = e % kStrip, c = bw + e / kStrip;
    if (i < rows) cp_async(Zs + i * pz + c, strip_at(L, ldl, X, ldx, bw, i0 + i, c), T(0));
    else Zs[i * pz + c] = T(0);
  }
  asm volatile("cp.async.wait_all;\n" ::);
  __syncthreads();

  const int warp = tid >> 5, lane = tid & 31;
  T acc[kStripRows][NQ];
#pragma unroll
  for (int p = 0; p < kStripRows; ++p)
#pragma unroll
    for (int q = 0; q < NQ; ++q) acc[p][q] = T(0);
  for (int kk = 0; kk < n; ++kk) {
    T a[kStripRows], b[NQ];
#pragma unroll
    for (int p = 0; p < kStripRows; ++p) a[p] = Zs[(warp + 8 * p) * pz + kk];
#pragma unroll
    for (int q = 0; q < NQ; ++q) b[q] = Ts[kk * kPitchT + lane + 32 * q];
#pragma unroll
    for (int p = 0; p < kStripRows; ++p)
#pragma unroll
      for (int q = 0; q < NQ; ++q) acc[p][q] = fma_t(a[p], b[q], acc[p][q]);
  }
  __syncthreads();
#pragma unroll
  for (int p = 0; p < kStripRows; ++p)
#pragma unroll
    for (int q = 0; q < NQ; ++q)
      if (lane + 32 * q < n) Zs[(warp + 8 * p) * pz + lane + 32 * q] = acc[p][q];
  __syncthreads();

  for (int e = tid; e < rows * bw; e += kThreads) {
    const int i = e / bw, c = e % bw;
    *strip_at(L, ldl, X, ldx, bw, i0 + i, c) = Zs[i * pz + c];
  }
  for (int e = tid; e < kStrip * r; e += kThreads) {
    const int i = e % kStrip, c = bw + e / kStrip;
    if (i < rows) *strip_at(L, ldl, X, ldx, bw, i0 + i, c) = Zs[i * pz + c];
  }
}

template <typename T, int NQ>
int launch_panel(void* L, int ldl, void* X, int ldx, const void* Tm, int m,
                 int bw, int n, cudaStream_t stream) {
  // per kernel and device: set on the current device at every launch
  const cudaError_t err = cudaFuncSetAttribute(
      gemm_nt_panel_kernel<T, NQ>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      panel_smem<T>(32 * NQ, NQ));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int ctas = (m + kStrip - 1) / kStrip;
  gemm_nt_panel_kernel<T, NQ><<<ctas, kThreads, panel_smem<T>(n, NQ), stream>>>(
      static_cast<T*>(L), ldl, static_cast<T*>(X), ldx,
      static_cast<const T*>(Tm), m, bw, n);
  return static_cast<int>(cudaGetLastError());
}

// The least number of 32-column groups that covers n, or 0 if the in-place
// entry's shared memory cannot hold width n.
template <typename T>
int panel_groups(int n) {
  const int nq = (n + 31) / 32;
  const int most = sizeof(T) == 4 ? 5 : 3;
  return nq <= most && panel_smem<T>(n, nq) <= kPanelSmem ? nq : 0;
}

template <typename T>
int panel(void* L, int ldl, void* X, int ldx, const void* Tm, void* O, int m,
          int bw, int n, cudaStream_t s) {
  if (O != nullptr) {
    const PanelZT<T> ops{static_cast<const T*>(L), static_cast<const T*>(X),
                         static_cast<const T*>(Tm), static_cast<T*>(O),
                         ldl, ldx, bw, n};
    return launch_tiles<T>(ops, m, n, n, s);
  }
  switch (panel_groups<T>(n)) {
    case 1: return launch_panel<T, 1>(L, ldl, X, ldx, Tm, m, bw, n, s);
    case 2: return launch_panel<T, 2>(L, ldl, X, ldx, Tm, m, bw, n, s);
    case 3: return launch_panel<T, 3>(L, ldl, X, ldx, Tm, m, bw, n, s);
    case 4: return launch_panel<T, 4>(L, ldl, X, ldx, Tm, m, bw, n, s);
    case 5: return launch_panel<T, 5>(L, ldl, X, ldx, Tm, m, bw, n, s);
    default: return -1;
  }
}

}  // namespace

// C, O: (m, n); A: (m, k); B: (n, k); all row-major, one dtype: 0 float32
// (on the tensor cores at output tile edge `tile`, 64 or 128), 1 float64
// (on the CUDA cores, `tile` 0). Returns the cudaError_t of the launch (0 on
// success), -1 for a bad argument.
extern "C" int gemm_nt(const void* C, const void* A, const void* B, void* O,
                       int m, int n, int k, double alpha, int dtype, int tile,
                       void* stream) {
  if (m <= 0 || n <= 0 || k < 0) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: {
      if ((tile != 64 && tile != 128) || m > 65535 * tile) return -1;
      const auto c = static_cast<const float*>(C), a = static_cast<const float*>(A),
                 b = static_cast<const float*>(B);
      const auto o = static_cast<float*>(O);
      const auto al = static_cast<float>(alpha);
      return tile == 64 ? launch_tc<64>(c, a, b, o, m, n, k, al, s)
                        : launch_tc<128>(c, a, b, o, m, n, k, al, s);
    }
    case 1: {
      if (tile != 0 || m > 65535 * kTile) return -1;
      const DenseNT<double> ops{static_cast<const double*>(C), static_cast<const double*>(A),
                                static_cast<const double*>(B), static_cast<double*>(O),
                                n, k, alpha};
      return launch_tiles<double>(ops, m, n, k, s);
    }
    default: return -1;
  }
}

// Z @ T for one panel: Z[i] = [L[c1 + i, c0:c1] | X[:, c1 + i]] for the
// m trailing rows. L: L[c1, c0] (leading dimension ldl), X: X[0, c1]
// (n - bw rows, leading dimension ldx), Tm: (n, n) row-major. With O null
// the product goes back over Z in place (for n where
// `gemm_nt_panel_in_place` holds); else into O (m, n) row-major and Z is
// only read. One dtype: 0 float32,
// 1 float64. Returns the cudaError_t of the launch (0 on success), -1 for a
// bad argument.
extern "C" int gemm_nt_panel(void* L, int ldl, void* X, int ldx,
                             const void* Tm, void* O, int m, int bw, int n,
                             int dtype, void* stream) {
  if (m <= 0 || bw < 1 || n <= bw || ldl < bw || ldx < m || m > 65535 * kTile)
    return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return panel<float>(L, ldl, X, ldx, Tm, O, m, bw, n, s);
    case 1: return panel<double>(L, ldl, X, ldx, Tm, O, m, bw, n, s);
    default: return -1;
  }
}

// 1 if the panel entry takes an n-wide product in place (O null) for
// dtype 0 float32 / 1 float64, else 0.
extern "C" int gemm_nt_panel_in_place(int n, int dtype) {
  if (n < 1) return 0;
  switch (dtype) {
    case 0: return panel_groups<float>(n) > 0;
    case 1: return panel_groups<double>(n) > 0;
    default: return 0;
  }
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
