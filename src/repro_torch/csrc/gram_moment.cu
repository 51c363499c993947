// K1: fused Gram + moment, G = A^T A and h = A^T b in one pass over A.
//
// Replaces the TPU kernel `gram_moment_pallas` (src/repro/kernels/gram.py,
// body `_gram_kernel`): the one-shot protocol's Phase 1 on every client.
//
// What bounds it on an H100: operations. For A of shape (n, d) the upper
// triangle of G needs n * d * (d + 1) / 2 multiply-adds, while A is read once
// (n * d elements) and G written once (d * d): at n = 16384, d = 4096 in
// float32 that is 2.75e11 operations against 0.3 GB, far above the card's
// balance point.
//
// Two routes, chosen by the wrapper from the shape and dtype
// (`kernels/gram.py::gram_tile`).
//   * Float32, bfloat16 and float16 from 2 rows on: the tensor-core SYRK of
//     tc_syrk.cuh
//     with T = A read in place (no workspace, one launch): one CTA per upper
//     G tile, 3xTF32 `mma.sync`, rows in a fixed order, G mirrored, h from
//     the diagonal CTAs. A ragged d, or a d or pointer that is not 16-byte
//     aligned, takes the 4-byte `cp.async` copies; bfloat16 and float16 are
//     converted to float32 on load (exact in TF32). Its bound is the same
//     work at a third of the TF32 peak, 1.67 ms at the shape above.
//   * Float64, and a single row of any dtype (a streamed row, where both
//     routes mostly write G): `gram_moment_kernel` below, on the CUDA
//     cores, converting bfloat16 / float16 to float32 on load.
//
// `gram_moment_kernel`:
//   * One CTA per upper-triangular output tile (ti <= tj) of G; the strict
//     lower triangle is written as the mirror of the same registers, so G is
//     exactly symmetric and only half the products are computed.
//   * Each CTA loops over all n rows itself, in a fixed order, with one
//     fused multiply-add chain per output element: no atomics and no split
//     over n, so the same input gives the same bits on every run. The
//     packed upload built from G is hashed for replay deduplication, so the
//     bits must not depend on scheduling.
//   * h comes from the diagonal CTAs (ti == tj), which already hold the
//     column block of A in shared memory: one extra multiply-add chain per
//     column against the matching chunk of b.
//   * 256 threads as a 16 x 16 grid, each holding a TM x TM block of
//     accumulators; rows of A stream through shared memory BK at a time.
//     Ragged n and d are masked on load and on store.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tc_syrk.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kBK = 8;

__device__ __forceinline__ float cvt_acc(float x, float) { return x; }
__device__ __forceinline__ double cvt_acc(double x, double) { return x; }
__device__ __forceinline__ float cvt_acc(__nv_bfloat16 x, float) { return __bfloat162float(x); }
__device__ __forceinline__ float cvt_acc(__half x, float) { return __half2float(x); }

__device__ __forceinline__ float fma_acc(float a, float b, float c) { return fmaf(a, b, c); }
__device__ __forceinline__ double fma_acc(double a, double b, double c) { return fma(a, b, c); }

template <typename In, typename Acc, int TM>
__global__ void __launch_bounds__(kThreads)
gram_moment_kernel(const In* __restrict__ A, const In* __restrict__ b,
                   Acc* __restrict__ G, Acc* __restrict__ h,
                   int n, int d, int tiles) {
  constexpr int BT = 16 * TM;
  __shared__ Acc As[kBK][BT];
  __shared__ Acc Bs[kBK][BT];
  __shared__ Acc bsh[kBK];

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
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;

  Acc acc[TM][TM];
#pragma unroll
  for (int m = 0; m < TM; ++m)
#pragma unroll
    for (int q = 0; q < TM; ++q) acc[m][q] = Acc(0);
  Acc hacc = Acc(0);

  for (int k0 = 0; k0 < n; k0 += kBK) {
    for (int e = tid; e < kBK * BT; e += kThreads) {
      const int kk = e / BT;
      const int c = e % BT;
      const int row = k0 + kk;
      const int64_t base = static_cast<int64_t>(row) * d;
      As[kk][c] = (row < n && i0 + c < d) ? cvt_acc(A[base + i0 + c], Acc(0)) : Acc(0);
      Bs[kk][c] = (row < n && j0 + c < d) ? cvt_acc(A[base + j0 + c], Acc(0)) : Acc(0);
    }
    if (diag && tid < kBK)
      bsh[tid] = (k0 + tid < n) ? cvt_acc(b[k0 + tid], Acc(0)) : Acc(0);
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      Acc a[TM], bb[TM];
#pragma unroll
      for (int m = 0; m < TM; ++m) {
        a[m] = As[kk][ty + 16 * m];
        bb[m] = Bs[kk][tx + 16 * m];
      }
#pragma unroll
      for (int m = 0; m < TM; ++m)
#pragma unroll
        for (int q = 0; q < TM; ++q) acc[m][q] = fma_acc(a[m], bb[q], acc[m][q]);
    }
    if (diag && tid < BT) {
#pragma unroll
      for (int kk = 0; kk < kBK; ++kk) hacc = fma_acc(As[kk][tid], bsh[kk], hacc);
    }
    __syncthreads();
  }

#pragma unroll
  for (int m = 0; m < TM; ++m) {
    const int r = i0 + ty + 16 * m;
#pragma unroll
    for (int q = 0; q < TM; ++q) {
      const int c = j0 + tx + 16 * q;
      if (r < d && c < d) {
        G[static_cast<int64_t>(r) * d + c] = acc[m][q];
        if (!diag) G[static_cast<int64_t>(c) * d + r] = acc[m][q];
      }
    }
  }
  if (diag && tid < BT && i0 + tid < d) h[i0 + tid] = hacc;
}

template <typename In, typename Acc, int TM>
int launch(const void* A, const void* b, void* G, void* h, int n, int d,
           cudaStream_t stream) {
  constexpr int BT = 16 * TM;
  const int tiles = (d + BT - 1) / BT;
  const int blocks = tiles * (tiles + 1) / 2;
  gram_moment_kernel<In, Acc, TM><<<blocks, kThreads, 0, stream>>>(
      static_cast<const In*>(A), static_cast<const In*>(b),
      static_cast<Acc*>(G), static_cast<Acc*>(h), n, d, tiles);
  return static_cast<int>(cudaGetLastError());
}

template <typename In>
int launch_tc(const void* A, const void* b, void* G, void* h, int n, int d, int tile,
              cudaStream_t stream) {
  if (tile == 0) return launch<In, float, 8>(A, b, G, h, n, d, stream);
  const In* Ap = static_cast<const In*>(A);
  const In* bp = static_cast<const In*>(b);
  float* Gp = static_cast<float*>(G);
  float* hp = static_cast<float*>(h);
  if constexpr (sizeof(In) == 4) {
    if (d % 4 == 0 && reinterpret_cast<uintptr_t>(A) % 16 == 0)
      return launch_syrk<In, In, true>(tile, Ap, d, d, bp, Gp, hp, n, d, 0, stream);
  }
  return launch_syrk<In, In, false>(tile, Ap, d, d, bp, Gp, hp, n, d, 0, stream);
}

}  // namespace

// dtype of A and b: 0 float32, 1 float64, 2 bfloat16, 3 float16.
// G (d, d) and h (d,) are float64 for float64 input, float32 otherwise.
// tile: 0 for the CUDA-core kernel, 32 or 128 for the tensor-core SYRK's
// tile edge (float32, bfloat16, float16).
// Returns the cudaError_t of the launch (0 on success), -1 for a bad argument.
extern "C" int gram_moment(const void* A, const void* b, void* G, void* h,
                           int n, int d, int dtype, int tile, void* stream) {
  if (n < 0 || d <= 0 || (dtype == 1 && tile != 0)) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return launch_tc<float>(A, b, G, h, n, d, tile, s);
    case 1: return launch<double, double, 4>(A, b, G, h, n, d, s);
    case 2: return launch_tc<__nv_bfloat16>(A, b, G, h, n, d, tile, s);
    case 3: return launch_tc<__half>(A, b, G, h, n, d, tile, s);
    default: return -1;
  }
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
