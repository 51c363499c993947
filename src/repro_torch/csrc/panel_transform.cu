// P: one diagonal panel of the blocked rank-r Cholesky up/downdate, in place.
//
// No TPU kernel of its own: the JAX package runs this recurrence as two
// nested `fori_loop`s that XLA compiles into one device loop
// (src/repro/server/cholesky.py, `panel_transform`). Run eagerly in PyTorch
// each of its bw * r scalar steps costs a handful of launches, so it gets a
// kernel here; its plain version stays in server/cholesky.py.
//
// Given the (bw, bw) lower-triangular panel L11 and the panel's columns X1
// (r, bw) of the update vectors, it writes L11' over L11 and the
// (bw + r, bw + r) right-transformation T with [L21 | X2^T] @ T =
// [L21' | X2'^T] for every trailing row. Step (k, j) is a 2 x 2 rotation of
// columns (k, bw + j) with
//   rho = sqrt(max(L11[k,k]^2 + s X1[j,k]^2, tiny)), c = rho / L11[k,k],
//   st = X1[j,k] / L11[k,k],
//   (a, x) -> ((a + s st x) / c, (-st a + x) / c).
//
// What bounds it on an H100: neither bytes nor operations, but the chain of
// dependent scalar steps. At bw = 32, r = 64 it moves ~45 KB and does ~1.2
// MFLOP, microseconds of either; the recurrence is 2 bw + r - 1 steps
// deep, and a step takes as long as the SM needs to issue every warp's
// rotation (two IEEE divisions each) and the diagonal's square root.
//
// Design: a wavefront over (row, column, update vector), both phases in one
// step loop of 2 bw + r - 1 steps with one __syncthreads each; CTAs of 18
// to 25 warps, each warp one role, so that no warp runs two code paths a
// step. A step is bound by the instructions the SM issues for all its
// warps, so each SM gets as few as the launch allows.
//   Off-diagonal (warps 1..16). Lane pairs of rows fill a warp: warp p holds
//      row p in lanes [0, p) and row 32 - p in lanes [p, 32) (p = 16: row 16
//      in lanes [0, 16)); the lane of (row i, column k < i) keeps L11[i,k].
//      X1[j,i], rotated by columns 0..k-1, moves from lane to lane by
//      __shfl_up_sync; a row's first lane reads it from X1's rows staged in
//      shared memory, its last hands it to the diagonal warp through a
//      two-slot mailbox. Step (i, k, j) runs at time i + k + j.
//   Diagonal (warp 0). Lane i keeps L11[i,i]; at time 2i + j it turns the
//      mailbox's x into (c, st) of step (i, j) and publishes them in a
//      shared-memory ring of 64 j-slots per column.
//   T (warps 17 .. 16 + nt). Warp 17 + u of CTA b owns row q = nt b + u
//      of T, with nt = ceil((bw + r) / SMs) between 1 and 8, so that the
//      grid fills the SMs with one CTA each (`t_warps`): lane k keeps
//      T[q,k], and T[q, bw + j] moves from lane to lane. Row q's step
//      (k, j) reads (c, st)(k, j) from the same ring at time bw + k + j >
//      2k + j. Steps on exact zeros leave them so (in the plain loop too)
//      and are skipped: a row q = bw + j0 starts at j0, and a row q < bw at
//      column q.
//   Warp 17 also copies X1's row t + 16 with cp.async during step t.
//   Every CTA repeats the scalar roles (cheap) and none waits for another.
//   L11 is staged once per CTA; the CTA that counts itself last on
//   `arrivals` (all others have then read L11) writes L11' in place and
//   resets the count, so reads and writes of L never race.
// Every elementary operation is the plain loop's, rounded once each
// (__f*_rn / __d*_rn: no contraction into fused multiply-adds), in an order
// its dependencies allow.

#include <cfloat>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxBw = 32;
constexpr int kRowWarps = 16;                    // warps 1..16
constexpr int kMaxTWarps = 8;                    // warps 17..24 at most
constexpr int kMaxThreads = 32 * (1 + kRowWarps + kMaxTWarps);
constexpr int kLoaderWarp = 1 + kRowWarps;       // copies X1's rows ahead
constexpr int kRing = 64;                        // j-slots per column; > bw + 1
constexpr int kXRing = 64;                       // X1 rows staged; > kXAhead + bw - 1
constexpr int kXAhead = 16;                      // steps a row of X1 is copied ahead
constexpr int kXWait = 8;                        // copies in flight (< kXAhead)
constexpr unsigned kAll = 0xffffffffu;

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float div(float a, float b) { return __fdiv_rn(a, b); }
__device__ __forceinline__ float root(float a) { return __fsqrt_rn(fmaxf(a, FLT_MIN)); }
__device__ __forceinline__ double mul(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ double add(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ double div(double a, double b) { return __ddiv_rn(a, b); }
__device__ __forceinline__ double root(double a) { return __dsqrt_rn(fmax(a, DBL_MIN)); }

// (a, x) -> ((a + s st x) / c, (-st a + x) / c), as the plain loop rounds it.
template <typename T>
__device__ __forceinline__ void rotate(T& a, T& x, T c, T st, T s) {
  const T a0 = a;
  a = div(add(a0, mul(mul(s, st), x)), c);
  x = div(add(mul(-st, a0), x), c);
}

__device__ __forceinline__ void stamp(long long* stamps, int at) {
  if (stamps != nullptr && blockIdx.x == 0 && threadIdx.x == 0)
    stamps[at] = clock64();
}

__device__ __forceinline__ void cp_async(void* smem, const void* gmem, float) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::
                   "r"(static_cast<unsigned>(__cvta_generic_to_shared(smem))), "l"(gmem));
}
__device__ __forceinline__ void cp_async(void* smem, const void* gmem, double) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::
                   "r"(static_cast<unsigned>(__cvta_generic_to_shared(smem))), "l"(gmem));
}

template <typename T>
struct Shared {
  T lsh[kMaxBw][kMaxBw + 1];   // L11 as read
  T cring[kMaxBw][kRing];      // c and st of step (k, j) at [k][j % 64]
  T sring[kMaxBw][kRing];
  T xs[kXRing][kMaxBw];        // X1 row j at [j % 64], copied kXAhead steps ahead
  T mailbox[kMaxBw][2];        // x of (i, j) for the diagonal, at [i][j % 2]
  int last;
};

template <typename T>
__global__ void __launch_bounds__(kMaxThreads)
panel_transform_kernel(T* __restrict__ L, int ldl, const T* __restrict__ X,
                       int ldx, T* __restrict__ Tout, int* __restrict__ arrivals,
                       long long* __restrict__ stamps, int bw, int r, T s,
                       int twarps) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Shared<T>& sh = *reinterpret_cast<Shared<T>*>(smem_raw);
  stamp(stamps, 0);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int w = bw + r;

  // This lane's element of L11: (row, k), on the diagonal warp (row, row),
  // on an off-diagonal warp p (row, k < row) as laid out above.
  const int p = warp;                          // off-diagonal warp p
  const bool offdiag = warp > 0 && p <= kRowWarps;
  int row = -1, k = 0;
  if (warp == 0) {
    row = lane;
    k = lane;
  } else if (offdiag) {
    row = lane < p ? p : (p < kRowWarps ? kMaxBw - p : -1);
    k = lane < p ? lane : lane - p;
  }
  const bool mine = row >= 0 && row < bw;

  // X1's first kXAhead rows; the loader warp (the first T warp) copies row
  // t + kXAhead during step t.
  const bool loader = warp == kLoaderWarp && lane < bw;
  for (int e = threadIdx.x; e < kXAhead * bw; e += blockDim.x) {
    const int j = e / bw, c = e % bw;
    if (j < r) cp_async(&sh.xs[j][c], X + static_cast<int64_t>(j) * ldx + c, T(0));
  }
  asm volatile("cp.async.commit_group;\n" ::);
  // Stage L11 through shared memory: once a value is stored there, its load
  // from L is complete, so the arrival below orders every read before the
  // last CTA's writes.
  for (int e = threadIdx.x; e < bw * bw; e += blockDim.x) {
    const int i = e / bw, c = e % bw;
    if (c <= i) sh.lsh[i][c] = L[static_cast<int64_t>(i) * ldl + c];
  }
  asm volatile("cp.async.wait_all;\n" ::);
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    sh.last = atomicAdd(arrivals, 1) == static_cast<int>(gridDim.x) - 1;
  }
  T l = mine ? sh.lsh[row][k] : T(0);

  // T role: row q. Its steps on exact zeros are skipped: a row q = bw + j0
  // starts at j0 (its column bw + j below j0 written as zeros now), a row
  // q < bw at column q.
  const int q = blockIdx.x * twarps + warp - 1 - kRowWarps;
  const bool t_warp = warp > kRowWarps && q < w;
  const bool t_lane = t_warp && lane < bw;
  const int jstart = q > bw ? q - bw : 0;
  const int kstart = q < bw ? q : 0;
  T* const trow = Tout + static_cast<int64_t>(q) * w;
  if (t_warp)
    for (int j = lane; j < jstart; j += 32) trow[bw + j] = T(0);
  T tk = (t_lane && q == lane) ? T(1) : T(0);

  stamp(stamps, 1);
  T x_in = T(0), tj_in = T(0);
  const int steps = 2 * bw + r - 1;
  for (int t = 0; t < steps; ++t) {
    if (loader) {
      const int j = t + kXAhead;
      if (j < r)
        cp_async(&sh.xs[j & (kXRing - 1)][lane], X + static_cast<int64_t>(j) * ldx + lane, T(0));
      asm volatile("cp.async.commit_group;\n" ::);
      asm volatile("cp.async.wait_group %0;\n" :: "n"(kXWait));
    }
    if (warp == 0) {
      // diagonal (row, row, j), j = t - 2 row
      const int j = t - 2 * row;
      if (mine && j >= 0 && j < r) {
        const T x = row == 0 ? sh.xs[j & (kXRing - 1)][0] : sh.mailbox[row][j & 1];
        const T rho = root(add(mul(l, l), mul(mul(s, x), x)));
        sh.cring[row][j & (kRing - 1)] = div(rho, l);
        sh.sring[row][j & (kRing - 1)] = div(x, l);
        l = rho;
      }
    } else if (offdiag) {
      // off-diagonal (row, k, j), j = t - row - k
      T x = x_in;
      const int j = t - row - k;
      if (mine && j >= 0 && j < r) {
        const int slot = j & (kRing - 1);
        if (k == 0) x = sh.xs[j & (kXRing - 1)][row];
        rotate(l, x, sh.cring[k][slot], sh.sring[k][slot], s);
        if (k == row - 1) sh.mailbox[row][j & 1] = x;
      }
      x_in = __shfl_up_sync(kAll, x, 1);
    } else if (t_warp && t >= bw + jstart + kstart) {
      // T row q, step (lane, j2), j2 = t - bw - lane
      const int j2 = t - bw - lane;
      T tj = lane == 0 ? (q == bw + j2 ? T(1) : T(0)) : tj_in;
      if (t_lane && lane >= kstart && j2 >= jstart && j2 < r) {
        const int slot = j2 & (kRing - 1);
        rotate(tk, tj, sh.cring[lane][slot], sh.sring[lane][slot], s);
        if (lane == bw - 1) trow[bw + j2] = tj;
      }
      tj_in = __shfl_up_sync(kAll, tj, 1);
    }
    __syncthreads();
  }
  stamp(stamps, 2);

  if (t_lane) trow[lane] = tk;
  if (sh.last) {
    if (mine) L[static_cast<int64_t>(row) * ldl + k] = l;
    if (threadIdx.x == 0) *arrivals = 0;
  }
  if (stamps != nullptr) {
    __syncthreads();
    stamp(stamps, 3);
  }
}

// T warps a CTA: as few as fill the SMs with one CTA each, so that an SM
// issues for as few warps as the launch allows (each CTA repeats the 17
// scalar warps).
int t_warps(int w) {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess || sms < 1)
    sms = 132;
  const int t = (w + sms - 1) / sms;
  return t < 1 ? 1 : (t > kMaxTWarps ? kMaxTWarps : t);
}

template <typename T>
int launch(void* L, int ldl, const void* X, int ldx, void* Tout, int* arrivals,
           long long* stamps, int bw, int r, double sign, cudaStream_t stream) {
  // per kernel and device: set on the current device at every launch
  const cudaError_t err = cudaFuncSetAttribute(
      panel_transform_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(sizeof(Shared<T>)));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int twarps = t_warps(bw + r);
  const int ctas = (bw + r + twarps - 1) / twarps;
  panel_transform_kernel<T><<<ctas, 32 * (1 + kRowWarps + twarps), sizeof(Shared<T>), stream>>>(
      static_cast<T*>(L), ldl, static_cast<const T*>(X), ldx,
      static_cast<T*>(Tout), arrivals, stamps, bw, r, static_cast<T>(sign), twarps);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// L: the panel's top-left element L[c0, c0] of a row-major factor with
// leading dimension ldl; its lower triangle (bw x bw, diagonal included) is
// read and overwritten with L11', the rest is left untouched. X: X[0, c0] of
// the row-major update vectors (r rows, leading dimension ldx), read only.
// Tout: (bw + r, bw + r) row-major, written. arrivals: one int, 0 before
// the launch and 0 after it. stamps: null, or 4 int64 for CTA 0's clock64
// at the start, before the step loop, after it and at the end. One dtype:
// 0 float32, 1 float64. 1 <= bw <= 32, r >= 1. Returns the cudaError_t of
// the launch (0 on success), -1 for a bad argument.
extern "C" int panel_transform(void* L, int ldl, const void* X, int ldx,
                               void* Tout, int* arrivals, long long* stamps,
                               int bw, int r, double sign, int dtype,
                               void* stream) {
  if (bw < 1 || bw > kMaxBw || r < 1 || ldl < bw || ldx < bw) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return launch<float>(L, ldl, X, ldx, Tout, arrivals, stamps, bw, r, sign, s);
    case 1: return launch<double>(L, ldl, X, ldx, Tout, arrivals, stamps, bw, r, sign, s);
    default: return -1;
  }
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
