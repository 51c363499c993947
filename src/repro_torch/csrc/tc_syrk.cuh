// The 3xTF32 tensor-core pieces shared by K1 (gram_moment.cu), the chunk
// route of K3/K4 (feature_gram.cu) and K2's float32 general entry
// (gemm_nt.cu): the cp.async ring, the TF32 split and mma.sync helpers, and
// one SYRK kernel, G (+)= T^T T and h (+)= T^T b.
//
// SYRK (`syrk_kernel`): one CTA per upper BT x BT tile (I <= J) of G.
//   * BT = 128: 8 warps as 2 x 4 blocks of 64 x 32 (the featurize GEMM's
//     layout, A read transposed), 32-row k-tiles through a three-stage
//     cp.async ring, one CTA per SM (~230 registers). At m = 4096 that is 528
//     CTAs: 4 waves of 132 SMs.
//   * BT = 32: 4 one-warp groups each hold the whole tile and take the
//     16-row slices of each 64-row tile in turn; the groups' sums are added
//     in group order at the end. Many small CTAs, for Grams whose 128-tiles
//     would leave SMs idle (K3 at m 1024: 528 CTAs instead of 36).
//   The width is the caller's choice, by shape alone (`kernels/gram.py`).
//   * Every float32 product is 3xTF32 (small*big + big*small + big*big of the
//     TF32 splits); each k-tile is summed from zero in the tensor cores and
//     added to the running sum by a round-to-nearest FADD, which keeps the
//     tensor cores' round-toward-zero bias off long sums. bfloat16 and
//     float16 operands are converted on load: they are exact in TF32, so
//     their small parts are zero.
//   * Each CTA walks the rows in a fixed order, with no split over rows and
//     no atomics: the same input gives the same bits on every run.
//   * A diagonal tile writes only r <= c and its mirror (the tensor cores may
//     sum T_r . T_c and T_c . T_r in other orders), so G is exactly
//     symmetric. Diagonal CTAs also accumulate h in float32 FMA chains in row
//     order. `accumulate` adds to what earlier calls wrote.
//   * Rows >= rows and columns >= col_lim load as zeros.

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

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

template <int ROWS, int COLS, int THREADS, bool kVec>
__device__ __forceinline__ void load_tile(float* dst, int lds, const __half* src, int64_t ld,
                                          int row0, int col0, int row_lim, int col_lim,
                                          int tid) {
  static_assert(ROWS * COLS % THREADS == 0, "tile not a multiple of the CTA");
#pragma unroll 4
  for (int i = 0; i < ROWS * COLS / THREADS; ++i) {
    const int e = tid + i * THREADS;
    const int r = e / COLS, c = e % COLS;
    const bool ok = row0 + r < row_lim && col0 + c < col_lim;
    dst[r * lds + c] = ok ? __half2float(src[(row0 + r) * ld + col0 + c]) : 0.f;
  }
}

// acc += A B over one BK-deep tile, for this warp's (16 MT) x (8 NT) block
// at (wm0, wn0) of the CTA tile. A(i, k) is As[i * lda + k], or As[k * lda
// + i] when kATrans; B(k, j) is Bs[k * ldb + j], or Bs[j * ldb + k] when
// kBRows (B held as its (n, k) rows). The tile's products are summed from
// zero in the tensor cores (3 BK / 8 mma per output fragment) and added to
// acc by a round-to-nearest FADD.
template <int MT, int NT, bool kATrans, int BK, bool kBRows = false>
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
      const float* b = kBRows ? Bs + j * ldb + k + t : Bs + (k + t) * ldb + j;
      split_tf32(b[0], bb[nt][0], bsm[nt][0]);
      split_tf32(b[kBRows ? 4 : 4 * ldb], bb[nt][1], bsm[nt][1]);
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

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }

// The SYRK's CTA shape for a tile edge BT: WM x WN warps tile it, GROUPS
// such warp sets take GK-row slices of each BK-row tile in turn.
template <int BT> struct SyrkShape;
template <> struct SyrkShape<32> { static constexpr int WM = 1, WN = 1, GROUPS = 4, GK = 16; };
template <> struct SyrkShape<128> { static constexpr int WM = 2, WN = 4, GROUPS = 1, GK = 32; };

template <int BT>
struct Syrk : SyrkShape<BT> {
  using S = SyrkShape<BT>;
  static constexpr int kGroupThreads = 32 * S::WM * S::WN;
  static constexpr int kThreads = kGroupThreads * S::GROUPS;
  static constexpr int BK = S::GROUPS * S::GK;      // rows per ring stage
  static constexpr int LD = BT + 8;                  // fragments on distinct banks
  static constexpr int MT = BT / S::WM / 16, NT = BT / S::WN / 8;
  static constexpr int kStage = 2 * BK * LD + BK;
  static constexpr int kSmem = kStages * kStage * static_cast<int>(sizeof(float));
};

// G (m x m, row-major) (+)= T[:, I]^T T[:, J] over rows 0 .. rows - 1 of T
// (row stride ldT), for the upper tile (I, J) that blockIdx.x names; h (+)=
// T[:, I]^T b on diagonal tiles. T is float32 (a workspace), bfloat16 or
// float16 (converted on load); kVec: 16-byte copies (float32 T with ldT,
// col_lim and T 16-byte aligned).
template <int BT, typename TT, typename TB, bool kVec>
__global__ void __launch_bounds__(Syrk<BT>::kThreads, 1)
syrk_kernel(const TT* __restrict__ T, int64_t ldT, int col_lim, const TB* __restrict__ b,
            float* __restrict__ G, float* __restrict__ h, int rows, int m, int tiles,
            int accumulate) {
  using P = Syrk<BT>;
  constexpr int MT = P::MT, NT = P::NT, BK = P::BK, GK = P::GK, LD = P::LD;
  constexpr int GROUPS = P::GROUPS;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* smem = reinterpret_cast<float*>(smem_raw);
  // blockIdx.x enumerates the upper triangle of the tile grid row by row.
  int tt = blockIdx.x;
  int ti = 0;
  while (tt >= tiles - ti) {
    tt -= tiles - ti;
    ++ti;
  }
  const int tj = ti + tt;
  const bool diag = ti == tj;
  const int i0 = ti * BT, j0 = tj * BT;
  const int tid = threadIdx.x, lane = tid % 32;
  const int group = tid / P::kGroupThreads;
  const int hcol = tid % P::kGroupThreads;        // h: one column per thread of a group
  const int warp = hcol / 32;
  const int wm0 = (warp / P::WN) * (BT / P::WM), wn0 = (warp % P::WN) * (BT / P::WN);

  float acc[MT][NT][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;
  float hacc = 0.f;

  pipeline(
      (rows + BK - 1) / BK,
      [&](int kt, int stage) {
        float* As = smem + stage * P::kStage;
        float* Bs = As + BK * LD;
        float* bs = Bs + BK * LD;
        const int k0 = kt * BK;
        load_tile<BK, BT, P::kThreads, kVec>(As, LD, T, ldT, k0, i0, rows, col_lim, tid);
        load_tile<BK, BT, P::kThreads, kVec>(Bs, LD, T, ldT, k0, j0, rows, col_lim, tid);
        if (diag && tid < BK) bs[tid] = k0 + tid < rows ? to_f32(b[k0 + tid]) : 0.f;
      },
      [&](int stage) {
        const float* As = smem + stage * P::kStage + group * GK * LD;
        const float* Bs = As + BK * LD;
        mma_ktile<MT, NT, true, GK>(acc, As, LD, Bs, LD, wm0, wn0, lane);
        if (diag && hcol < BT) {
          const float* bs = smem + stage * P::kStage + 2 * BK * LD + group * GK;
#pragma unroll
          for (int k = 0; k < GK; ++k) hacc = fmaf(As[k * LD + hcol], bs[k], hacc);
        }
      });

  if constexpr (GROUPS > 1) {
    // groups 1.. leave their sums in shared memory; group 0 adds them in order
    constexpr int kRed = MT * NT * 4 * 32 + 32;
    static_assert((GROUPS - 1) * kRed <= kStages * P::kStage, "reduction does not fit");
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
    for (int q = 0; q < GROUPS - 1; ++q) {
      const float* red = smem + q * kRed;
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[mt][nt][e] += red[((mt * NT + nt) * 4 + e) * 32 + lane];
      hacc += red[MT * NT * 4 * 32 + lane];
    }
  }

  const int g = lane / 4, t = lane % 4;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = i0 + wm0 + mt * 16 + g + 8 * (e / 2);
        const int c = j0 + wn0 + nt * 8 + 2 * t + (e & 1);
        if (r < m && c < m && (!diag || r <= c)) {
          const int64_t rc = static_cast<int64_t>(r) * m + c;
          const float val = accumulate ? G[rc] + acc[mt][nt][e] : acc[mt][nt][e];
          G[rc] = val;
          G[static_cast<int64_t>(c) * m + r] = val;
        }
      }
  if (diag && hcol < BT && i0 + hcol < m)
    h[i0 + hcol] = accumulate ? h[i0 + hcol] + hacc : hacc;
}

// Launches syrk_kernel<BT> over the upper tiles of an m x m G (bad BT: -1).
template <typename TT, typename TB, bool kVec>
int launch_syrk(int bt, const TT* T, int64_t ldT, int col_lim, const TB* b, float* G,
                float* h, int rows, int m, int accumulate, cudaStream_t stream) {
  auto run = [&](auto kernel, int BT, int threads, int smem) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    const int tiles = (m + BT - 1) / BT;
    kernel<<<tiles * (tiles + 1) / 2, threads, smem, stream>>>(T, ldT, col_lim, b, G, h, rows,
                                                              m, tiles, accumulate);
    return static_cast<int>(cudaGetLastError());
  };
  switch (bt) {
    case 32: return run(syrk_kernel<32, TT, TB, kVec>, 32, Syrk<32>::kThreads, Syrk<32>::kSmem);
    case 128: return run(syrk_kernel<128, TT, TB, kVec>, 128, Syrk<128>::kThreads, Syrk<128>::kSmem);
    default: return -1;
  }
}

}  // namespace
