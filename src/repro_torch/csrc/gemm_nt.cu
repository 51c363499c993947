// K2: O = C + alpha * A @ B^T for one panel of the blocked Cholesky update.
//
// Replaces the TPU kernel `gemm_nt_pallas` (src/repro/kernels/gram.py, body
// `_gemm_nt_kernel`). On the port's main path it is the trailing GEMM of
// every blocked rank-r factor up/downdate (server/cholesky.py,
// `chol_update_blocked`): Z @ T with Z = [L21 | X2^T] of shape
// (d - c1, bw + r) and T the (bw + r, bw + r) panel transformation, called as
// gemm_nt(0, Z, T^T, alpha=1) once per diagonal panel.
//
// What bounds it on an H100: at the panel shapes (m <= 4064, n = k = 96 for
// bw = 32, r = 64) one launch moves about 3 MB and does 75 MFLOP, a few
// microseconds of either; a factor update makes d / bw = 128 such launches
// in sequence, so its cost is launch latency, not bytes or operations.
//
// Design: one CTA per 64 x 64 output tile, 256 threads as a 16 x 16 grid
// each holding a 4 x 4 block of accumulators, with the (small) k loop inside
// the CTA in chunks of 16 staged through shared memory. float32 and float64,
// plain fused multiply-adds on the CUDA cores (no TF32). Ragged m, n and k
// are masked, so the wrapper pads nothing.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 64;
constexpr int kBK = 16;

__device__ __forceinline__ float fma_t(float a, float b, float c) { return fmaf(a, b, c); }
__device__ __forceinline__ double fma_t(double a, double b, double c) { return fma(a, b, c); }

template <typename T>
__global__ void __launch_bounds__(kThreads)
gemm_nt_kernel(const T* __restrict__ C, const T* __restrict__ A,
               const T* __restrict__ B, T* __restrict__ O,
               int m, int n, int k, T alpha) {
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
      As[kk][r] = (kin && i0 + r < m) ? A[static_cast<int64_t>(i0 + r) * k + k0 + kk] : T(0);
      Bs[kk][r] = (kin && j0 + r < n) ? B[static_cast<int64_t>(j0 + r) * k + k0 + kk] : T(0);
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
      if (r < m && c < n) {
        const int64_t at = static_cast<int64_t>(r) * n + c;
        O[at] = C[at] + alpha * acc[p][q];
      }
    }
  }
}

template <typename T>
int launch(const void* C, const void* A, const void* B, void* O, int m, int n,
           int k, double alpha, cudaStream_t stream) {
  const dim3 grid((n + kTile - 1) / kTile, (m + kTile - 1) / kTile);
  gemm_nt_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(C), static_cast<const T*>(A),
      static_cast<const T*>(B), static_cast<T*>(O), m, n, k,
      static_cast<T>(alpha));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C, O: (m, n); A: (m, k); B: (n, k); all row-major, one dtype:
// 0 float32, 1 float64. Returns the cudaError_t of the launch (0 on
// success), -1 for a bad argument.
extern "C" int gemm_nt(const void* C, const void* A, const void* B, void* O,
                       int m, int n, int k, double alpha, int dtype,
                       void* stream) {
  if (m <= 0 || n <= 0 || k < 0 || m > 65535 * kTile) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return launch<float>(C, A, B, O, m, n, k, alpha, s);
    case 1: return launch<double>(C, A, B, O, m, n, k, alpha, s);
    default: return -1;
  }
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
