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
// K3 in float32 and with bfloat16 input (`launch_sketch`): T = A R is
// computed once per row, through a bounded workspace, on the tensor cores.
//   * The rows are walked in chunks of a fixed, shape-only size (the
//     wrapper's 4096 rows: T's chunk is 16 MB at m 1024, held in the 50 MB
//     L2; the workspace does not grow with n). For each chunk, in order:
//     (a) `sketch_featurize_kernel` writes T_c = A_c R: 128 x 128 CTA tiles,
//         8 warps of 64 x 32, the d-reduction in 32-deep tiles in order;
//     (b) `sketch_syrk_kernel`, one CTA per upper 32 x 32 tile (I, J) of G
//         (528 at m 1024, four to an SM), adds T_c[:, I]^T T_c[:, J] to the
//         tile (G of the earlier chunks read back) and writes it with its
//         mirror; diagonal CTAs also add T_c[:, I]^T b_c in float32 FMAs.
//         Four one-warp groups take the 16-row slices of each 64-row tile
//         in turn and add their sums in group order. (Larger tiles leave
//         136 CTAs for 132 SMs: two waves.) Chunks are added in order.
//     T through the workspace costs ~2 n m 4 B of traffic (128 MB at the
//     path's shape, 0.04 ms at 3.35 TB/s), mostly L2 hits: cheap next to
//     the 9x featurize recompute that a tile-owning CTA would pay.
//   * Products are 3xTF32 on `mma.sync.m16n8k8`: each float32 operand x is
//     split into big = tf32(x) and small = tf32(x - big), and
//     small*big + big*small + big*big goes into float32 accumulators, which
//     keeps about float32 accuracy (the dropped small*small term is 2^-22
//     relative) at an effective 495 / 3 = 165 TFLOP/s peak. The tensor
//     cores round their float32 sums toward zero, a bias that grows with
//     the length of the sum (~2^-24 x terms): each k-tile's sum starts from
//     zero and is added to the running sum by a round-to-nearest FADD, so
//     no biased sum is longer than 12 mma (6 in the SYRK).
//   * Operand tiles go through a three-stage shared-memory ring with
//     `cp.async` (16-byte copies when rows are 16-byte aligned, else 4-byte;
//     bfloat16 operands are converted to float32 on a synchronous load).
//     Rows of 36, 40 and 136 floats keep the fragment loads off bank
//     conflicts. Ragged n, d and m are masked (zero-filled), not padded.
//   * Diagonal G tiles write only r <= c and its mirror: the tensor core may
//     sum T_r . T_c and T_c . T_r in other orders, so G is exactly symmetric
//     only because each pair is computed once.
//   * What holds it back: one 8-warp featurize CTA per SM (240 registers),
//     the mma.sync throughput with 3 mma per product and the TF32 splits'
//     ALU work; no `wgmma` or TMA yet.

// K4 and K3 in float64 (`launch`): one tile routine on the CUDA cores.
//   * One CTA owns an upper tile (I, J) of G (I <= J, BT x BT, BT = 128 for
//     float32 accumulation, 64 for float64) and one split of the rows. It
//     walks its rows in a fixed order, 64 at a time. For each chunk it builds
//     T[chunk, I] and T[chunk, J] in shared memory (a 64 x 2BT product over
//     d, in fixed order over d, from A and the I and J columns of R), applies
//     the epilogue, and accumulates G_IJ += T_I^T T_J in registers. Diagonal
//     CTAs also accumulate h. The tile is written with its mirror, so G is
//     exactly symmetric. T never leaves shared memory.
//   * Each CTA recomputes the featurize product for its own columns, so the
//     featurize work is done about 2 (m / BT) times over instead of once.
//     That is the price of owning G tiles without atomics; the bound counts
//     only the essential work, so it shows as a gap there.
//   * Rows are split over blockIdx.y only when there are few G tiles: each
//     split writes a partial G and h to a workspace, and a second kernel adds
//     the splits in split order. The split count depends only on (n, m).
//   * K4 masks rows past the end of its split to zero after the cosine,
//     because cos(0 + c) != 0, and scales by sqrt(2/D) with the true D. It
//     uses the accurate cosf (no --use_fast_math): |x w + c| reaches tens of
//     radians.
//   * Inputs are converted to the accumulation type on load: float32 and
//     bfloat16 accumulate in float32, float64 in float64.
//
// Both routes: fixed orders and no atomics, so the same input gives the same
// bits on every run, whatever the card.

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

// ---------------------------------------------------------------------------
// K3, float32 and bfloat16 input: T once per chunk of rows (3xTF32 mma.sync).

constexpr int kStages = 3;      // depth of the cp.async ring

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

__device__ __forceinline__ uint32_t tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// x -> (big, small): big = tf32(x), small = tf32(x - big).
__device__ __forceinline__ void split_tf32(float x, uint32_t& big, uint32_t& small) {
  big = tf32(x);
  small = tf32(x - __uint_as_float(big));
}

// d += a (16x8, row) * b (8x8, col); tf32 in, float32 accumulators.
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// A ROWS x COLS tile of a row-major matrix (row stride ld) from (row0, col0)
// into shared memory (row stride lds), as float32; elements at rows >=
// row_lim or columns >= col_lim are zeros. Float32 goes by cp.async (16-byte
// copies when kVec: col_lim, ld and the base 16-byte aligned), bfloat16 by a
// synchronous load and convert.
template <int ROWS, int COLS, int THREADS, bool kVec>
__device__ __forceinline__ void load_tile(float* dst, int lds, const float* src, int64_t ld,
                                          int row0, int col0, int row_lim, int col_lim,
                                          int tid) {
  constexpr int kW = kVec ? 4 : 1;
  constexpr int kC = COLS / kW;
  static_assert(ROWS * kC % THREADS == 0, "tile not a multiple of the CTA");
#pragma unroll
  for (int i = 0; i < ROWS * kC / THREADS; ++i) {
    const int e = tid + i * THREADS;
    const int r = e / kC, c = (e % kC) * kW;
    const bool ok = row0 + r < row_lim && col0 + c < col_lim;
    const float* p = ok ? src + (row0 + r) * ld + col0 + c : src;
    if constexpr (kVec) cp_async16(dst + r * lds + c, p, ok ? 16 : 0);
    else cp_async4(dst + r * lds + c, p, ok ? 4 : 0);
  }
}

template <int ROWS, int COLS, int THREADS, bool kVec>
__device__ __forceinline__ void load_tile(float* dst, int lds, const __nv_bfloat16* src,
                                          int64_t ld, int row0, int col0, int row_lim,
                                          int col_lim, int tid) {
  static_assert(ROWS * COLS % THREADS == 0, "tile not a multiple of the CTA");
#pragma unroll 4
  for (int i = 0; i < ROWS * COLS / THREADS; ++i) {
    const int e = tid + i * THREADS;
    const int r = e / COLS, c = e % COLS;
    const bool ok = row0 + r < row_lim && col0 + c < col_lim;
    dst[r * lds + c] = ok ? __bfloat162float(src[(row0 + r) * ld + col0 + c]) : 0.f;
  }
}

// acc += A B over one BK-deep tile, for this warp's (16 MT) x (8 NT) block
// at (wm0, wn0) of the CTA tile. A(i, k) is As[i * lda + k], or As[k * lda
// + i] when kATrans; B(k, j) is Bs[k * ldb + j]. The tile's products are
// summed from zero in the tensor cores (3 BK / 8 mma per output fragment)
// and added to acc by a round-to-nearest FADD.
template <int MT, int NT, bool kATrans, int BK>
__device__ __forceinline__ void mma_ktile(float (&acc)[MT][NT][4], const float* As, int lda,
                                          const float* Bs, int ldb, int wm0, int wn0,
                                          int lane) {
  const int g = lane / 4, t = lane % 4;
  float part[MT][NT][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) part[mt][nt][e] = 0.f;
#pragma unroll
  for (int k = 0; k < BK; k += 8) {
    uint32_t bb[NT][2], bsm[NT][2];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int j = wn0 + nt * 8 + g;
      split_tf32(Bs[(k + t) * ldb + j], bb[nt][0], bsm[nt][0]);
      split_tf32(Bs[(k + t + 4) * ldb + j], bb[nt][1], bsm[nt][1]);
    }
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      const int i = wm0 + mt * 16 + g;
      float x[4];
      if constexpr (kATrans) {
        x[0] = As[(k + t) * lda + i];
        x[1] = As[(k + t) * lda + i + 8];
        x[2] = As[(k + t + 4) * lda + i];
        x[3] = As[(k + t + 4) * lda + i + 8];
      } else {
        x[0] = As[i * lda + k + t];
        x[1] = As[(i + 8) * lda + k + t];
        x[2] = As[i * lda + k + t + 4];
        x[3] = As[(i + 8) * lda + k + t + 4];
      }
      uint32_t ab[4], asm_[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) split_tf32(x[e], ab[e], asm_[e]);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        mma_tf32(part[mt][nt], asm_, bb[nt][0], bb[nt][1]);
        mma_tf32(part[mt][nt], ab, bsm[nt][0], bsm[nt][1]);
        mma_tf32(part[mt][nt], ab, bb[nt][0], bb[nt][1]);
      }
    }
  }
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] += part[mt][nt][e];
}

// The cp.async ring: compute(stage) for each of ktiles operand tiles, with
// load(kt, stage) issuing tile kt kStages - 1 tiles ahead (one commit group
// per tile, empty past the end; synchronous stores count as done). One
// barrier per tile: the stage refilled at step kt was read at step kt - 1.
template <typename Load, typename Compute>
__device__ __forceinline__ void pipeline(int ktiles, Load load, Compute compute) {
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < ktiles) load(s, s);
    cp_async_commit();
  }
  for (int kt = 0; kt < ktiles; ++kt) {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    const int next = kt + kStages - 1;
    if (next < ktiles) load(next, next % kStages);
    cp_async_commit();
    compute(kt % kStages);
  }
}

// (a) T[r, c] = sum_k A[r, k] R[k, c] for r < rows, c < ldT (zeros for
// m <= c < ldT). 128 x 128 tiles over (c, r), 32 deep; 8 warps as 2 x 4 of
// 64 x 32.
constexpr int kFeatThreads = 256;
constexpr int kFeatBM = 128, kFeatBN = 128, kFeatBK = 32;
constexpr int kFeatLdA = kFeatBK + 4;   // A fragments on distinct banks
constexpr int kFeatLdB = kFeatBN + 8;   // B fragments on distinct banks
constexpr int kFeatStage = kFeatBM * kFeatLdA + kFeatBK * kFeatLdB;

template <typename TA, typename TR, bool kVec>
__global__ void __launch_bounds__(kFeatThreads, 1)
sketch_featurize_kernel(const TA* __restrict__ A, const TR* __restrict__ R,
                        float* __restrict__ T, int rows, int d, int m, int ldT) {
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
        if (r < rows && c < ldT)
          *reinterpret_cast<float2*>(T + static_cast<int64_t>(r) * ldT + c) =
              make_float2(acc[mt][nt][2 * hh], acc[mt][nt][2 * hh + 1]);
      }
    }
}

// (b) One upper 32 x 32 tile (I, J) of G per CTA: G_IJ (+)= T_I^T T_J over
// the chunk's rows, written with its mirror; diagonal CTAs also h_I (+)=
// T_I^T b. `accumulate` adds to what the earlier chunks wrote. There are few
// tiles and the sums are long, so four one-warp groups take the 16-row
// slices of each 64-row tile in turn, and the groups' sums are added in
// group order at the end.
constexpr int kSyrkBT = 32;                     // tile edge: 528 CTAs at m 1024
constexpr int kSyrkGroups = 4;                  // one warp each
constexpr int kSyrkThreads = 32 * kSyrkGroups;
constexpr int kSyrkGK = 16;                     // rows per group per tile
constexpr int kSyrkBK = kSyrkGroups * kSyrkGK;
constexpr int kSyrkLd = kSyrkBT + 8;            // B fragments on distinct banks
constexpr int kSyrkStage = 2 * kSyrkBK * kSyrkLd + kSyrkBK;
constexpr int kSyrkSmem = kStages * kSyrkStage * static_cast<int>(sizeof(float));

template <typename TB>
__global__ void __launch_bounds__(kSyrkThreads)
sketch_syrk_kernel(const float* __restrict__ T, const TB* __restrict__ b,
                   float* __restrict__ G, float* __restrict__ h, int rows, int m,
                   int ldT, int tiles, int accumulate) {
  constexpr int MT = kSyrkBT / 16, NT = kSyrkBT / 8;   // a warp: the whole tile
  constexpr int kRed = MT * NT * 4 * 32 + 32;          // one group's sums in shared memory
  static_assert((kSyrkGroups - 1) * kRed <= kStages * kSyrkStage, "reduction does not fit");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* smem = reinterpret_cast<float*>(smem_raw);
  int tt = blockIdx.x;
  int ti = 0;
  while (tt >= tiles - ti) {
    tt -= tiles - ti;
    ++ti;
  }
  const int tj = ti + tt;
  const bool diag = ti == tj;
  const int i0 = ti * kSyrkBT, j0 = tj * kSyrkBT;
  const int tid = threadIdx.x, lane = tid % 32;
  const int group = tid / 32;

  float acc[MT][NT][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;
  float hacc = 0.f;

  pipeline(
      (rows + kSyrkBK - 1) / kSyrkBK,
      [&](int kt, int stage) {
        float* As = smem + stage * kSyrkStage;
        float* Bs = As + kSyrkBK * kSyrkLd;
        float* bs = Bs + kSyrkBK * kSyrkLd;
        const int k0 = kt * kSyrkBK;
        load_tile<kSyrkBK, kSyrkBT, kSyrkThreads, true>(As, kSyrkLd, T, ldT, k0, i0, rows, ldT, tid);
        load_tile<kSyrkBK, kSyrkBT, kSyrkThreads, true>(Bs, kSyrkLd, T, ldT, k0, j0, rows, ldT, tid);
        if (diag && tid < kSyrkBK) bs[tid] = k0 + tid < rows ? cvt(b[k0 + tid], 0.f) : 0.f;
      },
      [&](int stage) {
        const float* As = smem + stage * kSyrkStage + group * kSyrkGK * kSyrkLd;
        const float* Bs = As + kSyrkBK * kSyrkLd;
        mma_ktile<MT, NT, true, kSyrkGK>(acc, As, kSyrkLd, Bs, kSyrkLd, 0, 0, lane);
        if (diag) {
          const float* bs = smem + stage * kSyrkStage + 2 * kSyrkBK * kSyrkLd + group * kSyrkGK;
#pragma unroll
          for (int k = 0; k < kSyrkGK; ++k) hacc = fmaf(As[k * kSyrkLd + lane], bs[k], hacc);
        }
      });

  // groups 1.. leave their sums in shared memory; group 0 adds them in order
  __syncthreads();
  if (group > 0) {
    float* red = smem + (group - 1) * kRed;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) red[((mt * NT + nt) * 4 + e) * 32 + lane] = acc[mt][nt][e];
    red[MT * NT * 4 * 32 + lane] = hacc;
  }
  __syncthreads();
  if (group > 0) return;
  for (int q = 0; q < kSyrkGroups - 1; ++q) {
    const float* red = smem + q * kRed;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mt][nt][e] += red[((mt * NT + nt) * 4 + e) * 32 + lane];
    hacc += red[MT * NT * 4 * 32 + lane];
  }

  const int g = lane / 4, t = lane % 4;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = i0 + mt * 16 + g + 8 * (e / 2);
        const int c = j0 + nt * 8 + 2 * t + (e & 1);
        if (r < m && c < m && (!diag || r <= c)) {
          const int64_t rc = static_cast<int64_t>(r) * m + c;
          const float val = accumulate ? G[rc] + acc[mt][nt][e] : acc[mt][nt][e];
          G[rc] = val;
          G[static_cast<int64_t>(c) * m + r] = val;
        }
      }
  if (diag && i0 + lane < m) h[i0 + lane] = accumulate ? h[i0 + lane] + hacc : hacc;
}

template <typename TA, typename TR>
int launch_sketch(const void* A, const void* b, const void* R, void* G, void* h, void* work,
                  int n, int d, int m, int chunks, int chunk_rows, cudaStream_t stream) {
  if (chunks < 1 || chunk_rows < 1 || static_cast<int64_t>(chunks) * chunk_rows < n ||
      (n > 0 && static_cast<int64_t>(chunks - 1) * chunk_rows >= n) || work == nullptr)
    return -1;
  const int ldT = (m + 3) / 4 * 4;
  const bool vec = d % 4 == 0 && m % 4 == 0 && reinterpret_cast<uintptr_t>(A) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(R) % 16 == 0;
  auto featurize = vec ? sketch_featurize_kernel<TA, TR, true>
                       : sketch_featurize_kernel<TA, TR, false>;
  constexpr int kFeatSmem = kStages * kFeatStage * static_cast<int>(sizeof(float));
  auto syrk = sketch_syrk_kernel<TA>;
  cudaError_t err = cudaFuncSetAttribute(
      featurize, cudaFuncAttributeMaxDynamicSharedMemorySize, kFeatSmem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(syrk, cudaFuncAttributeMaxDynamicSharedMemorySize, kSyrkSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles = (m + kSyrkBT - 1) / kSyrkBT;
  const TA* Ab = static_cast<const TA*>(A);
  const TA* bb = static_cast<const TA*>(b);
  float* Tw = static_cast<float*>(work);
  for (int c = 0; c < chunks; ++c) {
    const int r0 = c * chunk_rows;
    const int rows = n - r0 < chunk_rows ? n - r0 : chunk_rows;
    if (rows > 0) {
      const dim3 grid((m + kFeatBN - 1) / kFeatBN, (rows + kFeatBM - 1) / kFeatBM);
      featurize<<<grid, kFeatThreads, kFeatSmem, stream>>>(
          Ab + static_cast<int64_t>(r0) * d, static_cast<const TR*>(R), Tw, rows, d, m, ldT);
      err = cudaGetLastError();
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    syrk<<<tiles * (tiles + 1) / 2, kSyrkThreads, kSyrkSmem, stream>>>(
        Tw, bb + r0, static_cast<float*>(G), static_cast<float*>(h), rows > 0 ? rows : 0, m,
        ldT, tiles, c > 0);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}

}  // namespace

// dtype: 0 A, b, R float32; 1 all float64; 2 all bfloat16; 3 A, b bfloat16
// with R float32. G (m, m) and h (m,) are float64 for float64 input, float32
// otherwise. rows_per_split * splits must cover n. For dtype 1 (the tile
// routine) work holds splits * (m * m + m) accumulators when splits > 1 (may
// be null otherwise). For dtypes 0, 2, 3 (the chunk route) splits is the
// number of row chunks, rows_per_split the rows of a chunk (the last chunk
// holds at least one row), and work holds min(n, rows_per_split) rows of
// (m + 3) / 4 * 4 float32 (the chunk of T); it must not be null.
// Returns the cudaError_t of the launches (0 on success), -1 for a bad argument.
extern "C" int sketch_gram(const void* A, const void* b, const void* R, void* G,
                           void* h, void* work, int n, int d, int m, int splits,
                           int rows_per_split, int dtype, void* stream) {
  if (n < 0 || d <= 0 || m <= 0) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return launch_sketch<float, float>(A, b, R, G, h, work, n, d, m, splits, rows_per_split, s);
    case 1: return launch<double, double, double, false>(A, b, R, nullptr, G, h, work, n, d, m,
                                                          splits, rows_per_split, 0.0, s);
    case 2: return launch_sketch<__nv_bfloat16, __nv_bfloat16>(A, b, R, G, h, work, n, d, m, splits, rows_per_split, s);
    case 3: return launch_sketch<__nv_bfloat16, float>(A, b, R, G, h, work, n, d, m, splits, rows_per_split, s);
    default: return -1;
  }
}

// As sketch_gram with W (d, D) for R and c (D,) of W's dtype, on the tile
// routine for every dtype (work and splits as for dtype 1 there); scale is
// sqrt(2 / D) for the true feature count D.
extern "C" int rff_gram(const void* X, const void* b, const void* W, const void* c,
                        void* G, void* h, void* work, int n, int d, int m,
                        int splits, int rows_per_split, double scale, int dtype,
                        void* stream) {
  if (n < 0 || d <= 0 || m <= 0) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return launch<float, float, float, true>(X, b, W, c, G, h, work, n, d, m, splits, rows_per_split, scale, s);
    case 1: return launch<double, double, double, true>(X, b, W, c, G, h, work, n, d, m, splits, rows_per_split, scale, s);
    case 2: return launch<__nv_bfloat16, __nv_bfloat16, float, true>(X, b, W, c, G, h, work, n, d, m, splits, rows_per_split, scale, s);
    case 3: return launch<__nv_bfloat16, float, float, true>(X, b, W, c, G, h, work, n, d, m, splits, rows_per_split, scale, s);
    default: return -1;
  }
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
