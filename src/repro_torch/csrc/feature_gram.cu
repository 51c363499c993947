// K3 and K4: featurize -> Gram for the §IV-F feature tenants.
//
//   K3 sketch_gram: T = A R,                    G = T^T T, h = T^T b
//   K4 rff_gram:    T = sqrt(2/D) cos(X W + c), G = T^T T, h = T^T b
//
// Replace the TPU kernels `sketch_gram_pallas` and `rff_gram_pallas`
// (src/repro/kernels/gram.py, bodies `_sketch_gram_kernel` and
// `_rff_gram_kernel`): a client's Phase 1 in the m-dimensional feature space.
//
// What bounds them on an H100: operations. At the main path's shapes the
// essential work (2ndm for the featurize product, n m (m + 1) for the upper
// triangle of G, 2nm for h) is 155 GFLOP for K3 (n 16384, d 4096, m 1024)
// and 292 GFLOP for K4 (d 128, D 4096), against 0.27 GB and 0.07 GB of
// input: 2.3 / 4.4 ms at the 67 TFLOP/s FP32 (non-tensor) peak. Float32
// input is never rounded to TF32 or bf16 alone.
//
// Two routes.
//
// Float32 and bfloat16 input (`launch_chunks`): T is computed once per row,
// through a bounded workspace, on the tensor cores.
//   * The rows are walked in chunks of a fixed, shape-only size (the
//     wrapper's 4096 rows; the workspace does not grow with n). For each
//     chunk, in order:
//     (a) `featurize_kernel` writes T_c = A_c R (K3) or sqrt(2/D) cos(X_c W
//         + c) (K4, the cosine as the GEMM's epilogue): 128 x 128 CTA tiles,
//         8 warps of 64 x 32, the d-reduction in 32-deep tiles in order;
//     (b) `syrk_kernel` (tc_syrk.cuh) adds T_c^T T_c to G and T_c^T b_c to
//         h, one CTA per upper G tile, the tile edge (32 or 128) chosen by
//         the wrapper from m alone. Chunks are added in order.
//     K3 at m 1024 (16 MB of T a chunk, in L2) takes 32-wide tiles: 528
//     CTAs, where 128-wide ones would be 36. K4 at D 4096 takes 128-wide
//     ones: 528 CTAs. Its T chunk is 64 MB, beyond L2: T costs 2 n D 4 B of
//     traffic (0.5 GB, ~0.15 ms at 3.35 TB/s) and G's read-back 4 chunks x
//     2 D^2 4 B (1 GB, ~0.3 ms), small beside ~5 ms of mma; the tile
//     routine instead rebuilt T 2 D / 128 times over.
//   * Products are 3xTF32 on `mma.sync.m16n8k8`: each float32 operand x is
//     split into big = tf32(x) and small = tf32(x - big), and
//     small*big + big*small + big*big goes into float32 accumulators, which
//     keeps about float32 accuracy (the dropped small*small term is 2^-22
//     relative) at an effective 495 / 3 = 165 TFLOP/s peak. The tensor
//     cores round their float32 sums toward zero, a bias that grows with
//     the length of the sum (~2^-24 x terms): each k-tile's sum starts from
//     zero and is added to the running sum by a round-to-nearest FADD, so
//     no biased sum is longer than 12 mma.
//   * Operand tiles go through a three-stage shared-memory ring with
//     `cp.async` (16-byte copies when rows are 16-byte aligned, else 4-byte;
//     bfloat16 operands are converted to float32 on a synchronous load).
//     Rows of 36, 40 and 136 floats keep the fragment loads off bank
//     conflicts. Ragged n, d and m are masked (zero-filled), not padded.
//   * K4's masks (cos(0 + c) != 0, so zero-filled loads mask nothing after
//     the cosine): the featurize kernel never writes T rows past the chunk,
//     which the SYRK loads as zeros, and writes the padding columns m <= c <
//     ldT as zeros. The scale is sqrt(2/D) with the true D, the cosine the
//     accurate cosf (no --use_fast_math): |x w + c| reaches tens of radians.
//   * What holds it back: one 8-warp CTA per SM (240 registers), the
//     mma.sync throughput with 3 mma per product and the TF32 splits' ALU
//     work; no `wgmma` or TMA yet.

// Float64 K3 and K4 (`launch`): one tile routine on the CUDA cores.
//   * One CTA owns an upper 64 x 64 tile (I, J) of G (I <= J) and one split
//     of the rows. It walks its rows in a fixed order, 64 at a time. For
//     each chunk it builds T[chunk, I] and T[chunk, J] in shared memory (a
//     64 x 128 product over d, in fixed order over d, from A and the I and J
//     columns of R), applies the epilogue, and accumulates G_IJ += T_I^T T_J
//     in registers. Diagonal CTAs also accumulate h. The tile is written with
//     its mirror, so G is exactly symmetric. T never leaves shared memory.
//   * Each CTA recomputes the featurize product for its own columns, so the
//     featurize work is done about 2 (m / 64) times over instead of once.
//   * Rows are split over blockIdx.y only when there are few G tiles: each
//     split writes a partial G and h to a workspace, and a second kernel adds
//     the splits in split order. The split count depends only on (n, m).
//   * K4 masks rows past the end of its split to zero after the cosine and
//     scales by sqrt(2/D) with the true D.
//
// Both routes: fixed orders and no atomics, so the same input gives the same
// bits on every run, whatever the card.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "tc_syrk.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 64;   // rows of T built per chunk
constexpr int kDK = 16;     // columns of A per featurize step
constexpr int kPad = 4;     // keeps the transposed A tile off one bank

template <typename Acc> struct Tile;
template <> struct Tile<double> { static constexpr int TM = 4; };

__device__ __forceinline__ double cvt(double x, double) { return x; }
__device__ __forceinline__ double fma_acc(double a, double b, double c) { return fma(a, b, c); }
__device__ __forceinline__ double cos_acc(double x) { return cos(x); }

template <typename Acc>
constexpr size_t smem_bytes() {
  constexpr int TW = 32 * Tile<Acc>::TM;  // 2 * BT
  return sizeof(Acc) * (static_cast<size_t>(kRows) * TW + kDK * (kRows + kPad) +
                        kDK * TW + kRows);
}

// kRFF selects the epilogue; c and scale are read only when it is set.
template <typename InA, typename InR, typename Acc, bool kRFF>
__global__ void __launch_bounds__(kThreads, 1)
feature_gram_kernel(const InA* __restrict__ A, const InA* __restrict__ b,
                    const InR* __restrict__ R, const InR* __restrict__ c,
                    Acc* __restrict__ G, Acc* __restrict__ h, int n, int d,
                    int m, int tiles, int rows_per_split, Acc scale) {
  constexpr int TM = Tile<Acc>::TM;
  constexpr int BT = 16 * TM;     // edge of a G tile
  constexpr int TW = 2 * BT;      // T columns per chunk: I, then J
  constexpr int FR = kRows / 8;   // featurize rows per thread
  constexpr int FC = TW / 32;     // featurize columns per thread
  constexpr int AS = kRows + kPad;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Acc* Ts = reinterpret_cast<Acc*>(smem_raw);  // [kRows][TW]
  Acc* As = Ts + kRows * TW;                   // [kDK][AS], A transposed
  Acc* Rs = As + kDK * AS;                     // [kDK][TW]
  Acc* bs = Rs + kDK * TW;                     // [kRows]

  // blockIdx.x enumerates the upper triangle of the tile grid row by row.
  int t = blockIdx.x;
  int ti = 0;
  while (t >= tiles - ti) {
    t -= tiles - ti;
    ++ti;
  }
  const int tj = ti + t;
  const bool diag = ti == tj;
  const int i0 = ti * BT;
  const int j0 = tj * BT;
  const int split = blockIdx.y;
  const int row_begin = split * rows_per_split;
  const int row_end = min(n, row_begin + rows_per_split);
  const int tid = threadIdx.x;
  const int gx = tid % 16;  // Gram phase: 16 x 16 threads, TM x TM each
  const int gy = tid / 16;
  const int fx = tid % 32;  // featurize phase: 8 row groups x 32 lanes
  const int fy = tid / 32;

  Acc acc[TM][TM];
#pragma unroll
  for (int p = 0; p < TM; ++p)
#pragma unroll
    for (int q = 0; q < TM; ++q) acc[p][q] = Acc(0);
  Acc hacc = Acc(0);

  for (int r0 = row_begin; r0 < row_end; r0 += kRows) {
    // -- featurize: T[r0 + fy*FR + p][fx + 32q] = sum_k A[row][k] R[k][col]
    Acc tacc[FR][FC];
#pragma unroll
    for (int p = 0; p < FR; ++p)
#pragma unroll
      for (int q = 0; q < FC; ++q) tacc[p][q] = Acc(0);
    for (int k0 = 0; k0 < d; k0 += kDK) {
      for (int e = tid; e < kRows * kDK; e += kThreads) {
        const int r = e / kDK;
        const int kk = e % kDK;
        const int row = r0 + r;
        const int col = k0 + kk;
        As[kk * AS + r] = (row < row_end && col < d)
                              ? cvt(A[static_cast<int64_t>(row) * d + col], Acc(0))
                              : Acc(0);
      }
      for (int e = tid; e < kDK * TW; e += kThreads) {
        const int kk = e / TW;
        const int cc = e % TW;
        const int k = k0 + kk;
        const int col = cc < BT ? i0 + cc : j0 + cc - BT;
        Rs[kk * TW + cc] = (k < d && col < m)
                               ? cvt(R[static_cast<int64_t>(k) * m + col], Acc(0))
                               : Acc(0);
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < kDK; ++kk) {
        Acc a[FR], r[FC];
#pragma unroll
        for (int p = 0; p < FR; ++p) a[p] = As[kk * AS + fy * FR + p];
#pragma unroll
        for (int q = 0; q < FC; ++q) r[q] = Rs[kk * TW + fx + 32 * q];
#pragma unroll
        for (int p = 0; p < FR; ++p)
#pragma unroll
          for (int q = 0; q < FC; ++q) tacc[p][q] = fma_acc(a[p], r[q], tacc[p][q]);
      }
      __syncthreads();
    }
    // -- epilogue into shared memory
#pragma unroll
    for (int p = 0; p < FR; ++p) {
      const int rr = fy * FR + p;
#pragma unroll
      for (int q = 0; q < FC; ++q) {
        const int cc = fx + 32 * q;
        Acc v = tacc[p][q];
        if constexpr (kRFF) {
          const int col = cc < BT ? i0 + cc : j0 + cc - BT;
          v = (r0 + rr < row_end && col < m)
                  ? scale * cos_acc(v + cvt(c[col], Acc(0)))
                  : Acc(0);
        }
        Ts[rr * TW + cc] = v;
      }
    }
    if (diag && tid < kRows)
      bs[tid] = (r0 + tid < row_end) ? cvt(b[r0 + tid], Acc(0)) : Acc(0);
    __syncthreads();
    // -- Gram: G_IJ += T_I^T T_J over the chunk's rows, in row order. Rows
    //    past the end of the split are zero in T.
#pragma unroll 4
    for (int k = 0; k < kRows; ++k) {
      Acc a[TM], bb[TM];
#pragma unroll
      for (int p = 0; p < TM; ++p) {
        a[p] = Ts[k * TW + gy + 16 * p];
        bb[p] = Ts[k * TW + BT + gx + 16 * p];
      }
#pragma unroll
      for (int p = 0; p < TM; ++p)
#pragma unroll
        for (int q = 0; q < TM; ++q) acc[p][q] = fma_acc(a[p], bb[q], acc[p][q]);
    }
    if (diag && tid < BT) {
      for (int k = 0; k < kRows; ++k) hacc = fma_acc(Ts[k * TW + tid], bs[k], hacc);
    }
    __syncthreads();
  }

  Acc* Gs = G + static_cast<int64_t>(split) * m * m;
#pragma unroll
  for (int p = 0; p < TM; ++p) {
    const int r = i0 + gy + 16 * p;
#pragma unroll
    for (int q = 0; q < TM; ++q) {
      const int cidx = j0 + gx + 16 * q;
      if (r < m && cidx < m) {
        Gs[static_cast<int64_t>(r) * m + cidx] = acc[p][q];
        if (!diag) Gs[static_cast<int64_t>(cidx) * m + r] = acc[p][q];
      }
    }
  }
  if (diag && tid < BT && i0 + tid < m) h[static_cast<int64_t>(split) * m + i0 + tid] = hacc;
}

// out[i] = sum over splits, in split order, of part[s][i], for the m*m
// entries of G followed by the m entries of h.
template <typename Acc>
__global__ void reduce_splits_kernel(const Acc* __restrict__ Gp,
                                     const Acc* __restrict__ hp,
                                     Acc* __restrict__ G, Acc* __restrict__ h,
                                     int m, int splits) {
  const int64_t mm = static_cast<int64_t>(m) * m;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
       i < mm + m; i += stride) {
    const bool is_g = i < mm;
    const Acc* src = is_g ? Gp + i : hp + (i - mm);
    const int64_t step = is_g ? mm : m;
    Acc s = src[0];
    for (int sp = 1; sp < splits; ++sp) s += src[sp * step];
    if (is_g) G[i] = s;
    else h[i - mm] = s;
  }
}

template <typename InA, typename InR, typename Acc, bool kRFF>
int launch(const void* A, const void* b, const void* R, const void* c, void* G,
           void* h, void* work, int n, int d, int m, int splits,
           int rows_per_split, double scale, cudaStream_t stream) {
  constexpr int BT = 16 * Tile<Acc>::TM;
  constexpr size_t smem = smem_bytes<Acc>();
  const int tiles = (m + BT - 1) / BT;
  if (splits < 1 || splits > 65535 || rows_per_split < 1 ||
      static_cast<int64_t>(splits) * rows_per_split < n)
    return -1;
  if (splits > 1 && work == nullptr) return -1;
  auto kernel = feature_gram_kernel<InA, InR, Acc, kRFF>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  Acc* Gout = static_cast<Acc*>(splits > 1 ? work : G);
  Acc* hout = splits > 1 ? Gout + static_cast<int64_t>(splits) * m * m
                         : static_cast<Acc*>(h);
  const dim3 grid(tiles * (tiles + 1) / 2, splits);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const InA*>(A), static_cast<const InA*>(b),
      static_cast<const InR*>(R), static_cast<const InR*>(c), Gout, hout, n, d,
      m, tiles, rows_per_split, static_cast<Acc>(scale));
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return static_cast<int>(err);
  const int64_t want = (static_cast<int64_t>(m) * m + m + 255) / 256;
  const int blocks = static_cast<int>(want < 4096 ? want : 4096);
  reduce_splits_kernel<Acc><<<blocks, 256, 0, stream>>>(
      Gout, hout, static_cast<Acc*>(G), static_cast<Acc*>(h), m, splits);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// The chunk route (K3 and K4, float32 and bfloat16 input): T once per chunk
// of rows, then the tensor-core SYRK of tc_syrk.cuh.

// (a) T[r, c] for r < rows, c < ldT: the product P = sum_k A[r, k] R[k, c],
// or for K4 (kRFF) scale * cos(P + c[col]), with zeros for m <= c < ldT
// either way (cos(0 + c) != 0, so K4 writes them explicitly). Rows >= rows
// are never written. 128 x 128 tiles over (c, r), 32 deep; 8 warps as 2 x 4
// of 64 x 32.
constexpr int kFeatThreads = 256;
constexpr int kFeatBM = 128, kFeatBN = 128, kFeatBK = 32;
constexpr int kFeatLdA = kFeatBK + 4;   // A fragments on distinct banks
constexpr int kFeatLdB = kFeatBN + 8;   // B fragments on distinct banks
constexpr int kFeatStage = kFeatBM * kFeatLdA + kFeatBK * kFeatLdB;

template <typename TA, typename TR, bool kVec, bool kRFF>
__global__ void __launch_bounds__(kFeatThreads, 1)
featurize_kernel(const TA* __restrict__ A, const TR* __restrict__ R,
                 const TR* __restrict__ cvec, float scale, float* __restrict__ T,
                 int rows, int d, int m, int ldT) {
  constexpr int MT = 4, NT = 4;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* smem = reinterpret_cast<float*>(smem_raw);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int col0 = blockIdx.x * kFeatBN;
  const int row0 = blockIdx.y * kFeatBM;
  const int wm0 = (warp / 4) * 64, wn0 = (warp % 4) * 32;

  float acc[MT][NT][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;

  pipeline(
      (d + kFeatBK - 1) / kFeatBK,
      [&](int kt, int stage) {
        float* As = smem + stage * kFeatStage;
        const int k0 = kt * kFeatBK;
        load_tile<kFeatBM, kFeatBK, kFeatThreads, kVec>(As, kFeatLdA, A, d, row0, k0, rows, d,
                                                        tid);
        load_tile<kFeatBK, kFeatBN, kFeatThreads, kVec>(As + kFeatBM * kFeatLdA, kFeatLdB, R,
                                                        m, k0, col0, d, m, tid);
      },
      [&](int stage) {
        const float* As = smem + stage * kFeatStage;
        mma_ktile<MT, NT, false, kFeatBK>(acc, As, kFeatLdA, As + kFeatBM * kFeatLdA, kFeatLdB,
                                          wm0, wn0, lane);
      });

  const int g = lane / 4, t = lane % 4;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int c = col0 + wn0 + nt * 8 + 2 * t;
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int r = row0 + wm0 + mt * 16 + g + 8 * hh;
        if (r < rows && c < ldT) {
          float v0 = acc[mt][nt][2 * hh], v1 = acc[mt][nt][2 * hh + 1];
          if constexpr (kRFF) {
            v0 = c < m ? scale * cosf(v0 + to_f32(cvec[c])) : 0.f;
            v1 = c + 1 < m ? scale * cosf(v1 + to_f32(cvec[c + 1])) : 0.f;
          }
          *reinterpret_cast<float2*>(T + static_cast<int64_t>(r) * ldT + c) =
              make_float2(v0, v1);
        }
      }
    }
}

// For each chunk of chunk_rows rows, in order: (a) T_c into the workspace,
// (b) G (+)= T_c^T T_c and h (+)= T_c^T b_c by the SYRK with BT-wide tiles
// (the first chunk writes, later ones add). T's rows are padded to ldT, a
// multiple of 4 floats, with zeros.
template <typename TA, typename TR, bool kRFF>
int launch_chunks(const void* A, const void* b, const void* R, const void* cvec, void* G,
                  void* h, void* work, int n, int d, int m, int chunks, int chunk_rows,
                  double scale, int bt, cudaStream_t stream) {
  if (chunks < 1 || chunk_rows < 1 || static_cast<int64_t>(chunks) * chunk_rows < n ||
      (n > 0 && static_cast<int64_t>(chunks - 1) * chunk_rows >= n) || work == nullptr ||
      (bt != 32 && bt != 128))
    return -1;
  const int ldT = (m + 3) / 4 * 4;
  const bool vec = d % 4 == 0 && m % 4 == 0 && reinterpret_cast<uintptr_t>(A) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(R) % 16 == 0;
  auto featurize = vec ? featurize_kernel<TA, TR, true, kRFF>
                       : featurize_kernel<TA, TR, false, kRFF>;
  constexpr int kFeatSmem = kStages * kFeatStage * static_cast<int>(sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(
      featurize, cudaFuncAttributeMaxDynamicSharedMemorySize, kFeatSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const TA* Ab = static_cast<const TA*>(A);
  const TA* bb = static_cast<const TA*>(b);
  float* Tw = static_cast<float*>(work);
  for (int c = 0; c < chunks; ++c) {
    const int r0 = c * chunk_rows;
    const int rows = n - r0 < chunk_rows ? n - r0 : chunk_rows;
    if (rows > 0) {
      const dim3 grid((m + kFeatBN - 1) / kFeatBN, (rows + kFeatBM - 1) / kFeatBM);
      featurize<<<grid, kFeatThreads, kFeatSmem, stream>>>(
          Ab + static_cast<int64_t>(r0) * d, static_cast<const TR*>(R),
          static_cast<const TR*>(cvec), static_cast<float>(scale), Tw, rows, d, m, ldT);
      err = cudaGetLastError();
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    const int rc = launch_syrk<float, TA, true>(bt, Tw, ldT, ldT, bb + r0, static_cast<float*>(G),
                                                static_cast<float*>(h), rows > 0 ? rows : 0, m,
                                                c > 0, stream);
    if (rc != 0) return rc;
  }
  return 0;
}

}  // namespace

// dtype: 0 A, b, R float32; 1 all float64; 2 all bfloat16; 3 A, b bfloat16
// with R float32. G (m, m) and h (m,) are float64 for float64 input, float32
// otherwise. rows_per_split * splits must cover n. For dtype 1 (the tile
// routine) work holds splits * (m * m + m) accumulators when splits > 1 (may
// be null otherwise), and tile is not read. For dtypes 0, 2, 3 (the chunk
// route) splits is the number of row chunks, rows_per_split the rows of a
// chunk (the last chunk holds at least one row), work holds min(n,
// rows_per_split) rows of (m + 3) / 4 * 4 float32 (the chunk of T) and must
// not be null, and tile (32 or 128) is the edge of the SYRK's G tiles.
// Returns the cudaError_t of the launches (0 on success), -1 for a bad argument.
extern "C" int sketch_gram(const void* A, const void* b, const void* R, void* G,
                           void* h, void* work, int n, int d, int m, int splits,
                           int rows_per_split, int tile, int dtype, void* stream) {
  if (n < 0 || d <= 0 || m <= 0) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return launch_chunks<float, float, false>(A, b, R, nullptr, G, h, work, n, d, m,
                                                      splits, rows_per_split, 0.0, tile, s);
    case 1: return launch<double, double, double, false>(A, b, R, nullptr, G, h, work, n, d, m,
                                                 splits, rows_per_split, 0.0, s);
    case 2: return launch_chunks<__nv_bfloat16, __nv_bfloat16, false>(
        A, b, R, nullptr, G, h, work, n, d, m, splits, rows_per_split, 0.0, tile, s);
    case 3: return launch_chunks<__nv_bfloat16, float, false>(
        A, b, R, nullptr, G, h, work, n, d, m, splits, rows_per_split, 0.0, tile, s);
    default: return -1;
  }
}

// As sketch_gram with W (d, D) for R and c (D,) of W's dtype; scale is
// sqrt(2 / D) for the true feature count D.
extern "C" int rff_gram(const void* X, const void* b, const void* W, const void* c,
                        void* G, void* h, void* work, int n, int d, int m,
                        int splits, int rows_per_split, double scale, int tile, int dtype,
                        void* stream) {
  if (n < 0 || d <= 0 || m <= 0) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return launch_chunks<float, float, true>(X, b, W, c, G, h, work, n, d, m, splits,
                                                     rows_per_split, scale, tile, s);
    case 1: return launch<double, double, double, true>(X, b, W, c, G, h, work, n, d, m, splits,
                                                rows_per_split, scale, s);
    case 2: return launch_chunks<__nv_bfloat16, __nv_bfloat16, true>(
        X, b, W, c, G, h, work, n, d, m, splits, rows_per_split, scale, tile, s);
    case 3: return launch_chunks<__nv_bfloat16, float, true>(
        X, b, W, c, G, h, work, n, d, m, splits, rows_per_split, scale, tile, s);
    default: return -1;
  }
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
