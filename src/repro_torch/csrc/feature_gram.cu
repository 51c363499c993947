// K3 and K4: fused featurize -> Gram for the §IV-F feature tenants.
//
//   K3 sketch_gram: T = A R,                    G = T^T T, h = T^T b
//   K4 rff_gram:    T = sqrt(2/D) cos(X W + c), G = T^T T, h = T^T b
//
// Replace the TPU kernels `sketch_gram_pallas` and `rff_gram_pallas`
// (src/repro/kernels/gram.py, bodies `_sketch_gram_kernel` and
// `_rff_gram_kernel`): a client's Phase 1 in the m-dimensional feature space.
// As there, the (n, m) feature block T never goes to device memory: it is
// built in shared memory one chunk of rows at a time and folded into G.
//
// What bounds them on an H100: operations. At the main path's shapes the
// essential work (2ndm for the featurize product, n m (m + 1) for the upper
// triangle of G, 2nm for h) is 155 GFLOP for K3 (n 16384, d 4096, m 1024)
// and 292 GFLOP for K4 (d 128, D 4096), against 0.27 GB and 0.07 GB of
// input. They run on the CUDA cores in full precision (no TF32, no bf16
// rounding of float32 inputs), so the bound is the FP32 (non-tensor) peak.
//
// Design, one tile routine with two epilogues:
//   * One CTA owns an upper tile (I, J) of G (I <= J, BT x BT, BT = 128 for
//     float32 accumulation, 64 for float64) and one split of the rows. It
//     walks its rows in a fixed order, 64 at a time. For each chunk it builds
//     T[chunk, I] and T[chunk, J] in shared memory (a 64 x 2BT product over
//     d, in fixed order over d, from A and the I and J columns of R), applies
//     the epilogue, and accumulates G_IJ += T_I^T T_J in registers. Diagonal
//     CTAs also accumulate h. The tile is written with its mirror, so G is
//     exactly symmetric.
//   * Each CTA recomputes the featurize product for its own columns, so the
//     featurize work is done about 2 (m / BT) times over instead of once.
//     That is the price of owning G tiles without atomics; the bound counts
//     only the essential work, so it shows as a gap there.
//   * Rows are split over blockIdx.y only when there are few G tiles
//     (K3 at m 1024 has 36): each split writes a partial G and h to a
//     workspace, and a second kernel adds the splits in split order. The
//     split count depends only on (n, m), so the same input gives the same
//     bits on every run: no atomics anywhere.
//   * Ragged n, d and m are masked in the kernel: no padding. K4 masks rows
//     past the end of its split to zero after the cosine, because
//     cos(0 + c) != 0, and scales by sqrt(2/D) with the true D. It uses the
//     accurate cosf (no --use_fast_math): |x w + c| reaches tens of radians.
//   * Inputs are converted to the accumulation type on load: float32 and
//     bfloat16 accumulate in float32, float64 in float64.
// Simple and correct first: no tensor cores, TMA or double buffering yet.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 64;   // rows of T built per chunk
constexpr int kDK = 16;     // columns of A per featurize step
constexpr int kPad = 4;     // keeps the transposed A tile off one bank

template <typename Acc> struct Tile;
template <> struct Tile<float> { static constexpr int TM = 8; };
template <> struct Tile<double> { static constexpr int TM = 4; };

__device__ __forceinline__ float cvt(float x, float) { return x; }
__device__ __forceinline__ double cvt(double x, double) { return x; }
__device__ __forceinline__ float cvt(__nv_bfloat16 x, float) { return __bfloat162float(x); }

__device__ __forceinline__ float fma_acc(float a, float b, float c) { return fmaf(a, b, c); }
__device__ __forceinline__ double fma_acc(double a, double b, double c) { return fma(a, b, c); }

__device__ __forceinline__ float cos_acc(float x) { return cosf(x); }
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

template <bool kRFF>
int dispatch(const void* A, const void* b, const void* R, const void* c, void* G,
             void* h, void* work, int n, int d, int m, int splits,
             int rows_per_split, double scale, int dtype, void* stream) {
  if (n < 0 || d <= 0 || m <= 0) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return launch<float, float, float, kRFF>(A, b, R, c, G, h, work, n, d, m, splits, rows_per_split, scale, s);
    case 1: return launch<double, double, double, kRFF>(A, b, R, c, G, h, work, n, d, m, splits, rows_per_split, scale, s);
    case 2: return launch<__nv_bfloat16, __nv_bfloat16, float, kRFF>(A, b, R, c, G, h, work, n, d, m, splits, rows_per_split, scale, s);
    case 3: return launch<__nv_bfloat16, float, float, kRFF>(A, b, R, c, G, h, work, n, d, m, splits, rows_per_split, scale, s);
    default: return -1;
  }
}

}  // namespace

// dtype: 0 A, b, R float32; 1 all float64; 2 all bfloat16; 3 A, b bfloat16
// with R float32. G (m, m) and h (m,) are float64 for float64 input, float32
// otherwise. work holds splits * (m * m + m) accumulators when splits > 1
// (may be null otherwise); rows_per_split * splits must cover n.
// Returns the cudaError_t of the launches (0 on success), -1 for a bad argument.
extern "C" int sketch_gram(const void* A, const void* b, const void* R, void* G,
                           void* h, void* work, int n, int d, int m, int splits,
                           int rows_per_split, int dtype, void* stream) {
  return dispatch<false>(A, b, R, nullptr, G, h, work, n, d, m, splits,
                         rows_per_split, 0.0, dtype, stream);
}

// As sketch_gram with W (d, D) for R and c (D,) of W's dtype; scale is
// sqrt(2 / D) for the true feature count D.
extern "C" int rff_gram(const void* X, const void* b, const void* W, const void* c,
                        void* G, void* h, void* work, int n, int d, int m,
                        int splits, int rows_per_split, double scale, int dtype,
                        void* stream) {
  return dispatch<true>(X, b, W, c, G, h, work, n, d, m, splits, rows_per_split,
                        scale, dtype, stream);
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
