// P: one diagonal panel of the blocked rank-r Cholesky up/downdate.
//
// No TPU kernel of its own: the JAX package runs this recurrence as two
// nested `fori_loop`s that XLA compiles into one device loop
// (src/repro/server/cholesky.py, `panel_transform`). Run eagerly in PyTorch
// each of its bw * r scalar steps costs a handful of launches, so it gets a
// kernel here; its plain version stays in server/cholesky.py.
//
// Given the (bw, bw) lower-triangular panel L11 and the panel's columns X1
// (r, bw) of the update vectors, it returns L11' and the (bw + r, bw + r)
// right-transformation T with [L21 | X2^T] @ T = [L21' | X2'^T] for every
// trailing row. Step (k, j) is a 2 x 2 rotation of columns (k, bw + j) with
//   rho = sqrt(max(L11[k,k]^2 + s X1[j,k]^2, tiny)), c = rho / L11[k,k],
//   st = X1[j,k] / L11[k,k],
//   (a, x) -> ((a + s st x) / c, (-st a + x) / c).
//
// What bounds it on an H100: neither bytes nor operations, but the chain of
// dependent scalar steps (latency). At bw = 32, r = 64 it moves ~45 KB and
// does ~1.2 MFLOP, microseconds of either.
//
// Design: one CTA of 256 threads, two phases.
//   1. Scalars. Thread i of warp 0 owns row i of the panel: its row of L11
//      (at most 32 values) lives in registers, and it walks j = 0..r-1,
//      applying the rotations of columns k < i to (L11[i,k], X1[j,i]) and
//      then the diagonal step that yields (c, st) for (i, j). Row i needs
//      (c, st) of (k, j) for k < i only, so the rows run as a wavefront:
//      at time t thread i handles j = t - i, with one __syncwarp per time
//      step and the last 32 j-columns of scalars in a shared-memory ring.
//      That is r + bw - 1 steps instead of bw * r. All scalars also go to a
//      global table (2, bw, r) for phase 2.
//   2. T. Rotations on different column pairs commute, so each row of T
//      can apply the whole (k, j) sequence in j-major order on its own: one
//      thread per row, the bw columns k in registers, column bw + j in one
//      register while j advances. No synchronisation between rows.
// Every elementary operation is the one the sequential loop performs, in an
// order that respects its dependencies; only fused multiply-adds may round
// differently from the plain version.
// Deviation from the first plan (L11 and X1 in shared memory): X1 is read
// once per element straight from global memory and L11 lives in registers,
// so the shared memory needed is fixed (the 32 x 32 scalar ring) for any r.

#include <cfloat>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBw = 32;

__device__ __forceinline__ float tiny_of(float) { return FLT_MIN; }
__device__ __forceinline__ double tiny_of(double) { return DBL_MIN; }

template <typename T>
__global__ void __launch_bounds__(kThreads)
panel_transform_kernel(const T* __restrict__ L11, const T* __restrict__ X1,
                       T* __restrict__ L11o, T* __restrict__ Tout,
                       T* __restrict__ table, int bw, int r, T s) {
  __shared__ T cring[kMaxBw][kMaxBw];
  __shared__ T sring[kMaxBw][kMaxBw];
  T* const ctab = table;           // (bw, r): c of step (k, j)
  T* const stab = table + bw * r;  // (bw, r): st of step (k, j)
  const int tid = threadIdx.x;

  if (tid < kMaxBw) {
    const int i = tid;
    const bool row = i < bw;
    T l[kMaxBw];
#pragma unroll
    for (int k = 0; k < kMaxBw; ++k)
      l[k] = (row && k <= i) ? L11[i * bw + k] : T(0);
    // t = 0 is j = -i, which only row 0 handles.
    T x_next = (row && i == 0) ? X1[0] : T(0);
    for (int t = 0; t < r + bw - 1; ++t) {
      const int j = t - i;
      T x = x_next;
      const int jn = j + 1;
      x_next = (row && jn >= 0 && jn < r) ? X1[jn * bw + i] : T(0);
      if (row && j >= 0 && j < r) {
        const int slot = j & (kMaxBw - 1);
#pragma unroll
        for (int k = 0; k < kMaxBw; ++k) {
          if (k < i) {
            const T c = cring[k][slot];
            const T st = sring[k][slot];
            const T a = l[k];
            l[k] = (a + s * st * x) / c;
            x = (-st * a + x) / c;
          }
        }
        T lkk = T(0);
#pragma unroll
        for (int k = 0; k < kMaxBw; ++k)
          if (k == i) lkk = l[k];
        const T rho = sqrt(fmax(lkk * lkk + s * x * x, tiny_of(T(0))));
        const T c = rho / lkk;
        const T st = x / lkk;
        cring[i][slot] = c;
        sring[i][slot] = st;
        ctab[i * r + j] = c;
        stab[i * r + j] = st;
#pragma unroll
        for (int k = 0; k < kMaxBw; ++k)
          if (k == i) l[k] = rho;
      }
      __syncwarp();
    }
    if (row) {
#pragma unroll
      for (int k = 0; k < kMaxBw; ++k)
        if (k < bw) L11o[i * bw + k] = k <= i ? l[k] : L11[i * bw + k];
    }
  }
  __syncthreads();

  const int w = bw + r;
  for (int q = tid; q < w; q += kThreads) {
    T tk[kMaxBw];
#pragma unroll
    for (int k = 0; k < kMaxBw; ++k) tk[k] = (q == k) ? T(1) : T(0);
    T* const trow = Tout + static_cast<int64_t>(q) * w;
    for (int j = 0; j < r; ++j) {
      T tj = (q == bw + j) ? T(1) : T(0);
#pragma unroll
      for (int k = 0; k < kMaxBw; ++k) {
        if (k < bw) {
          const T c = ctab[k * r + j];
          const T st = stab[k * r + j];
          const T a = tk[k];
          tk[k] = (a + s * st * tj) / c;
          tj = (-st * a + tj) / c;
        }
      }
      trow[bw + j] = tj;
    }
#pragma unroll
    for (int k = 0; k < kMaxBw; ++k)
      if (k < bw) trow[k] = tk[k];
  }
}

template <typename T>
int launch(const void* L11, const void* X1, void* L11o, void* Tout,
           void* table, int bw, int r, double sign, cudaStream_t stream) {
  panel_transform_kernel<T><<<1, kThreads, 0, stream>>>(
      static_cast<const T*>(L11), static_cast<const T*>(X1),
      static_cast<T*>(L11o), static_cast<T*>(Tout), static_cast<T*>(table),
      bw, r, static_cast<T>(sign));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// L11 (bw, bw), X1 (r, bw) in; L11o (bw, bw), Tout (bw + r, bw + r) and the
// scratch table (2, bw, r) out; all row-major, one dtype: 0 float32,
// 1 float64. 1 <= bw <= 32, r >= 1. Returns the cudaError_t of the launch
// (0 on success), -1 for a bad argument.
extern "C" int panel_transform(const void* L11, const void* X1, void* L11o,
                               void* Tout, void* table, int bw, int r,
                               double sign, int dtype, void* stream) {
  if (bw < 1 || bw > kMaxBw || r < 1) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return launch<float>(L11, X1, L11o, Tout, table, bw, r, sign, s);
    case 1: return launch<double>(L11, X1, L11o, Tout, table, bw, r, sign, s);
    default: return -1;
  }
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
