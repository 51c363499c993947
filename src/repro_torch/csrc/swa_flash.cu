// K5: sliding-window flash attention, the forward pass over a whole sequence
// (prefill), causal or not, with an online softmax in float32.
//
// Replaces the TPU kernel `swa_flash_pallas` (src/repro/kernels/swa_flash.py,
// body `_flash_kernel`), reached through `ops.swa_attention`. In the port
// every attention layer's full-sequence pass runs it: the `swa` layers with
// their window, the `full` layers with none.
//
// What it computes, for one (batch, head): scores q.k * hd^-0.5 in float32;
// a pair (q, k) is kept iff k < S, rel = q - k >= 0 (when causal) and
// rel < window (when a window is set); dropped pairs score -1e30, as in the
// reference; out = softmax(scores) @ v, finished as acc / max(l, 1e-30) and
// cast to q's dtype.
//
// What bounds it on an H100: operations. Each kept pair costs 4 * hd
// operations (the score and its share of P @ V), against q, k, v and out
// read or written once: at B 4, S 4096, H 32, hd 128 in bf16 that is
// 2.4e11 operations (window 1024) or 5.5e11 (causal, no window) against
// 0.40 GB. Scores and P @ V run on the CUDA cores in float32 here, so the
// FP32 rate, not the tensor cores, sets this kernel's pace.
//
// Design:
//   * One CTA per (64-row query block, head, batch); the heaviest query
//     blocks of a causal sequence are scheduled first (blockIdx.x reversed).
//     The Q tile stays in shared memory for the CTA's life.
//   * The CTA walks only the KV blocks that its mask can reach: from
//     (q0 - window + 1) / 64 (with a window) to min(q_last, S - 1) / 64
//     (when causal). For window 1024 that is 17 blocks of 64 keys whatever
//     S is: the work is linear in S, as on the TPU.
//   * K (transposed) and V tiles of 64 keys go through shared memory; 256
//     threads as 16 x 16, each owning 4 query rows x 4 keys of the score
//     tile and the same 4 rows x hd/16 columns of the output accumulator.
//     Row max and row sum are reduced across the 16 threads of a row with
//     warp shuffles; P goes through shared memory for P @ V.
//   * The ragged edge is masked, not padded: keys >= S score -1e30 and
//     rows >= S are never stored, so a non-causal ragged S is exact.
//   * Inputs are read in their (B, S, H, hd) layout through strides (no
//     transpose), with H_kv <= H key/value heads: query head h reads KV head
//     h / (H / H_kv), so grouped-query attention needs no repeated K, V.
//   * A fixed KV order, fixed shuffle trees and no atomics: the same input
//     gives the same bits on every run.
// Simple and correct first: no tensor cores, TMA or double buffering yet.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;             // query rows per CTA
constexpr int kBK = 64;             // keys per KV block
constexpr int kThreads = 256;       // 16 x 16
constexpr int kPStride = kBK + 4;   // padded row of P: no bank conflict between rows
constexpr float kNegInf = -1e30f;   // the reference's NEG_INF

// Eight consecutive elements (16-byte aligned) as float32.
__device__ __forceinline__ void load8(const float* p, float* out) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  out[0] = a.x; out[1] = a.y; out[2] = a.z; out[3] = a.w;
  out[4] = b.x; out[5] = b.y; out[6] = b.z; out[7] = b.w;
}

__device__ __forceinline__ void load8(const __nv_bfloat16* p, float* out) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void store1(float* p, float x) { *p = x; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }

__device__ __forceinline__ float row_max16(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float row_sum16(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// smem: Qt [HD][kBQ], Kt [HD][kBK], Vs [kBK][HD], Ps [kBQ][kPStride], float32.
template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
swa_flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o, int S, int H,
                 int Hkv, int window, int causal, float scale) {
  constexpr int kCols = HD / 16;    // output columns per thread
  constexpr int kChunks = HD / 8;   // 8-element chunks per row
  extern __shared__ float4 smem4[];
  float* Qt = reinterpret_cast<float*>(smem4);
  float* Kt = Qt + HD * kBQ;
  float* Vs = Kt + HD * kBK;
  float* Ps = Vs + kBK * HD;

  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (H / Hkv);
  const int tid = threadIdx.x;
  const int tx = tid % 16;          // keys tx*4.., output columns g*64 + tx*4..
  const int ty = tid / 16;          // query rows ty*4..
  const int64_t q_row = static_cast<int64_t>(H) * HD;
  const int64_t kv_row = static_cast<int64_t>(Hkv) * HD;
  const T* qb = q + static_cast<int64_t>(b) * S * q_row + static_cast<int64_t>(h) * HD;
  const T* kb = k + static_cast<int64_t>(b) * S * kv_row + static_cast<int64_t>(hk) * HD;
  const T* vb = v + static_cast<int64_t>(b) * S * kv_row + static_cast<int64_t>(hk) * HD;
  T* ob = o + static_cast<int64_t>(b) * S * q_row + static_cast<int64_t>(h) * HD;

  // Q tile, transposed; rows past S are zero and never stored.
  for (int e = tid; e < kBQ * kChunks; e += kThreads) {
    const int r = e % kBQ, c = e / kBQ;
    float x[8];
    if (q0 + r < S) {
      load8(qb + (q0 + r) * q_row + c * 8, x);
    } else {
#pragma unroll
      for (int i = 0; i < 8; ++i) x[i] = 0.f;
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) Qt[(c * 8 + i) * kBQ + r] = x[i];
  }

  float acc[4][kCols];
  float m_i[4], l_i[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m_i[i] = kNegInf;
    l_i[i] = 0.f;
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[i][c] = 0.f;
  }

  // The KV blocks this query block's mask can reach.
  const int q_last = min(q0 + kBQ - 1, S - 1);
  const int k_lo = window > 0 ? max(0, q0 - window + 1) : 0;
  const int k_hi = causal ? q_last : S - 1;

  for (int kblk = k_lo / kBK; kblk <= k_hi / kBK; ++kblk) {
    const int k0 = kblk * kBK;
    __syncthreads();                // the last block's Kt, Vs, Ps are consumed
    for (int e = tid; e < kBK * kChunks; e += kThreads) {
      const int r = e % kBK, c = e / kBK;
      float x[8];
      if (k0 + r < S) {
        load8(kb + (k0 + r) * kv_row + c * 8, x);
      } else {
#pragma unroll
        for (int i = 0; i < 8; ++i) x[i] = 0.f;
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) Kt[(c * 8 + i) * kBK + r] = x[i];
    }
    for (int e = tid; e < kBK * kChunks; e += kThreads) {
      const int r = e / kChunks, c = e % kChunks;
      float x[8];
      if (k0 + r < S) {
        load8(vb + (k0 + r) * kv_row + c * 8, x);
      } else {
#pragma unroll
        for (int i = 0; i < 8; ++i) x[i] = 0.f;
      }
      float4* dst = reinterpret_cast<float4*>(Vs + r * HD + c * 8);
      dst[0] = make_float4(x[0], x[1], x[2], x[3]);
      dst[1] = make_float4(x[4], x[5], x[6], x[7]);
    }
    __syncthreads();

    // scores of rows ty*4 + i against keys tx*4 + j
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < HD; ++d) {
      const float4 a = *reinterpret_cast<const float4*>(Qt + d * kBQ + ty * 4);
      const float4 c = *reinterpret_cast<const float4*>(Kt + d * kBK + tx * 4);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float cv[4] = {c.x, c.y, c.z, c.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(av[i], cv[j], s[i][j]);
    }

    // mask, online softmax per row, P to shared memory
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + ty * 4 + i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + tx * 4 + j;
        const int rel = qpos - kpos;
        const bool ok = kpos < S && (!causal || rel >= 0) && (window <= 0 || rel < window);
        s[i][j] = ok ? s[i][j] * scale : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m_i[i], row_max16(mx));
      const float alpha = expf(m_i[i] - m_new);
      float p[4];
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        p[j] = expf(s[i][j] - m_new);
        rs += p[j];
      }
      l_i[i] = l_i[i] * alpha + row_sum16(rs);
      m_i[i] = m_new;
#pragma unroll
      for (int c = 0; c < kCols; ++c) acc[i][c] *= alpha;
      *reinterpret_cast<float4*>(Ps + (ty * 4 + i) * kPStride + tx * 4) =
          make_float4(p[0], p[1], p[2], p[3]);
    }
    __syncthreads();

    // acc += P @ V for rows ty*4 + i, columns g*64 + tx*4 + jj
#pragma unroll 2
    for (int kk = 0; kk < kBK; kk += 4) {
      float pr[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float4 pv = *reinterpret_cast<const float4*>(Ps + (ty * 4 + i) * kPStride + kk);
        pr[i][0] = pv.x; pr[i][1] = pv.y; pr[i][2] = pv.z; pr[i][3] = pv.w;
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
#pragma unroll
        for (int g = 0; g < HD / 64; ++g) {
          const float4 vv = *reinterpret_cast<const float4*>(Vs + (kk + u) * HD + g * 64 + tx * 4);
          const float vc[4] = {vv.x, vv.y, vv.z, vv.w};
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int jj = 0; jj < 4; ++jj)
              acc[i][g * 4 + jj] = fmaf(pr[i][u], vc[jj], acc[i][g * 4 + jj]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qpos = q0 + ty * 4 + i;
    if (qpos >= S) continue;
    const float inv = 1.f / fmaxf(l_i[i], 1e-30f);
    T* orow = ob + qpos * q_row;
#pragma unroll
    for (int g = 0; g < HD / 64; ++g)
#pragma unroll
      for (int jj = 0; jj < 4; ++jj)
        store1(orow + g * 64 + tx * 4 + jj, acc[i][g * 4 + jj] * inv);
  }
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, void* o, int B, int S,
           int H, int Hkv, int window, int causal, float scale,
           cudaStream_t stream) {
  const int smem = static_cast<int>(sizeof(float)) * (2 * HD * kBQ + kBK * HD + kBQ * kPStride);
  cudaError_t err = cudaFuncSetAttribute(
      swa_flash_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((S + kBQ - 1) / kBQ, H, B);
  swa_flash_kernel<T, HD><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), S, H, Hkv, window, causal, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, o: (B, S, H, hd); k, v: (B, S, Hkv, hd); contiguous, 16-byte aligned,
// one dtype: 0 float32, 2 bfloat16. hd is 64 or 128. window <= 0 means none.
// Returns the cudaError_t of the launch (0 on success), -1 for a bad argument.
extern "C" int swa_flash(const void* q, const void* k, const void* v, void* o,
                         int B, int S, int H, int Hkv, int hd, int window,
                         int causal, float scale, int dtype, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || Hkv <= 0 || H % Hkv != 0 || B > 65535 || H > 65535)
    return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int key = dtype * 1000 + hd;
  switch (key) {
    case 64: return launch<float, 64>(q, k, v, o, B, S, H, Hkv, window, causal, scale, s);
    case 128: return launch<float, 128>(q, k, v, o, B, S, H, Hkv, window, causal, scale, s);
    case 2064: return launch<__nv_bfloat16, 64>(q, k, v, o, B, S, H, Hkv, window, causal, scale, s);
    case 2128: return launch<__nv_bfloat16, 128>(q, k, v, o, B, S, H, Hkv, window, causal, scale, s);
    default: return -1;
  }
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
