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
// 0.40 GB, 0.24 / 0.56 ms at the 989 TFLOP/s bf16 tensor-core peak.
//
// Two routines share the schedule below:
//   * bfloat16 (the serving dtype): `swa_flash_mma_kernel`, on the tensor
//     cores with `mma.sync.m16n8k16` bf16 -> float32. Four warps, each owning
//     16 of the CTA's 64 query rows. The Q tile is loaded once and kept in
//     registers as A fragments (`ldmatrix`). K and V tiles of 64 keys stream
//     through a two-stage shared-memory ring with `cp.async` (the next
//     block's copy runs under this block's math); K is read with `ldmatrix`,
//     V with `ldmatrix.trans`. Scores S = Q K^T stay in the accumulator
//     fragments; the online softmax runs there in float32 (exp2 with the
//     scale folded into log2 e), the row max and sum reduced across the 4
//     threads of a quad by a fixed xor tree. P is not rounded to bf16
//     alone: p_hi = bf16(p), p_lo = bf16(p - p_hi), and P_hi V + P_lo V go
//     into the same float32 accumulator, so P @ V keeps about float32
//     accuracy (one bf16 rounding of p would add 2^-9 relative error per
//     weight) for 1.5x the P @ V mma work: 3 mma per 2 of a bf16-only P.
//     Rows of hd + 8 elements (272 bytes at hd 128, 176 at hd 80, 144 at
//     hd 64; 68, 44, 36 words) put the 8 rows of each `ldmatrix` phase on 8
//     distinct 4-bank groups, so no bank conflict needs a swizzle. What
//     bounds it is the mma.sync instruction rate (no `wgmma`, no TMA, no
//     warp specialisation yet) and the 1.5x.
//   * float32 (a test and parity dtype): `swa_flash_f32_kernel`, every
//     score and P @ V product as an FP32 FMA on the CUDA cores; 256 threads
//     as 16 x 16, each owning 4 query rows x 4 keys of the score tile and
//     the same 4 rows x hd/16 columns of the output (tx, tx + 16, ...); P
//     through shared memory.
//
// hd is 64, 80 (hubert-xlarge) or 128; every loop over hd steps by 16.
//
// The common schedule:
//   * One CTA per (64-row query block, head, batch); the heaviest query
//     blocks of a causal sequence are scheduled first (blockIdx.x reversed).
//   * The CTA walks only the KV blocks of 64 keys that its mask can reach:
//     from (q0 - window + 1) / 64 (with a window) to min(q_last, S - 1) / 64
//     (when causal). For window 1024 that is 17 blocks whatever S is: the
//     work is linear in S, as on the TPU.
//   * The ragged edge is masked, not padded: keys >= S score -1e30 (their
//     tiles are zero-filled) and rows >= S are never stored, so a non-causal
//     ragged S is exact. The bf16 routine applies the mask only on blocks
//     that straddle an edge (keys >= S, the diagonal, the window's far
//     edge); in an interior block every pair is kept, so skipping the mask
//     there changes no bit.
//   * Inputs are read in their (B, S, H, hd) layout through strides (no
//     transpose), with H_kv <= H key/value heads: query head h reads KV head
//     h / (H / H_kv), so grouped-query attention needs no repeated K, V.
//   * A fixed KV order, fixed shuffle trees and no atomics: the same input
//     gives the same bits on every run.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;             // query rows per CTA
constexpr int kBK = 64;             // keys per KV block
constexpr float kNegInf = -1e30f;   // the reference's NEG_INF

// The KV blocks [first, last] that query block q0's mask can reach.
__device__ __forceinline__ int2 kv_blocks(int q0, int S, int window, int causal) {
  const int q_last = min(q0 + kBQ - 1, S - 1);
  const int k_lo = window > 0 ? max(0, q0 - window + 1) : 0;
  const int k_hi = causal ? q_last : S - 1;
  return make_int2(k_lo / kBK, k_hi / kBK);
}

// ---------------------------------------------------------------------------
// bfloat16: tensor cores (mma.sync m16n8k16), cp.async double buffering.

constexpr int kMmaThreads = 128;    // 4 warps x 16 query rows

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; src_bytes 0 writes zeros (rows past S).
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

// d += a (16x16, row) * b (16x8, col); bf16 in, float32 accumulators.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// (x, y) -> bf16 pair hi, and the bf16 pair lo of what hi leaves out.
__device__ __forceinline__ void split_bf16(float x, float y, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 l = __floats2bfloat162_rn(x - hf.x, y - hf.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

// One 64-row tile (rows row0.. of a (.., S, heads, HD) tensor, row stride ld
// elements) into shared memory with row stride HD + 8; rows >= S are zeros.
template <int HD>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                          int row0, int S, int64_t ld, int tid) {
  constexpr int kChunks = HD / 8;   // 16-byte chunks per row
  constexpr int kLd = HD + 8;
#pragma unroll
  for (int i = 0; i < kBQ * kChunks / kMmaThreads; ++i) {
    const int e = tid + i * kMmaThreads;
    const int r = e / kChunks, c = e % kChunks;
    const bool ok = row0 + r < S;
    cp_async16(dst + r * kLd + c * 8, src + (ok ? row0 + r : 0) * ld + c * 8, ok ? 16 : 0);
  }
}

template <int HD>
__global__ void __launch_bounds__(kMmaThreads)
swa_flash_mma_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o,
                     int S, int H, int Hkv, int window, int causal, float scale_log2) {
  constexpr int kLd = HD + 8;       // padded smem row: ldmatrix rows on distinct banks
  constexpr int kTile = kBQ * kLd;  // elements of one 64-row tile
  constexpr int kKS = HD / 16;      // k-steps of Q K^T
  constexpr int kNT = HD / 8;       // n-tiles of the output
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* Ks = Qs + kTile;           // [2][kTile]
  __nv_bfloat16* Vs = Ks + 2 * kTile;       // [2][kTile]

  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (H / Hkv);
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;     // mma fragment row group, column pair
  const int64_t q_ld = static_cast<int64_t>(H) * HD;
  const int64_t kv_ld = static_cast<int64_t>(Hkv) * HD;
  const __nv_bfloat16* qb = q + static_cast<int64_t>(b) * S * q_ld + static_cast<int64_t>(h) * HD;
  const __nv_bfloat16* kb = k + static_cast<int64_t>(b) * S * kv_ld + static_cast<int64_t>(hk) * HD;
  const __nv_bfloat16* vb = v + static_cast<int64_t>(b) * S * kv_ld + static_cast<int64_t>(hk) * HD;
  __nv_bfloat16* ob = o + static_cast<int64_t>(b) * S * q_ld + static_cast<int64_t>(h) * HD;

  const int2 blocks = kv_blocks(q0, S, window, causal);
  load_tile<HD>(Qs, qb, q0, S, q_ld, tid);
  load_tile<HD>(Ks, kb, blocks.x * kBK, S, kv_ld, tid);
  load_tile<HD>(Vs, vb, blocks.x * kBK, S, kv_ld, tid);
  cp_async_commit();

  uint32_t qf[kKS][4];              // this warp's 16 Q rows as A fragments
  float acc[kNT][4];                // rows g, g+8 x columns nt*8 + 2t, +1
  float m_i[2] = {kNegInf, kNegInf};
  float l_i[2] = {0.f, 0.f};        // this thread's share of the row sums
#pragma unroll
  for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;

  const int row_a = q0 + warp * 16 + g;     // the thread's two query rows
  const int row_b = row_a + 8;
  for (int kblk = blocks.x; kblk <= blocks.y; ++kblk) {
    const int stage = (kblk - blocks.x) & 1;
    const int k0 = kblk * kBK;
    if (kblk < blocks.y) {
      load_tile<HD>(Ks + (stage ^ 1) * kTile, kb, k0 + kBK, S, kv_ld, tid);
      load_tile<HD>(Vs + (stage ^ 1) * kTile, vb, k0 + kBK, S, kv_ld, tid);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (kblk == blocks.x) {
#pragma unroll
      for (int ks = 0; ks < kKS; ++ks)
        ldmatrix_x4(qf[ks], Qs + (warp * 16 + lane % 16) * kLd + ks * 16 + (lane / 16) * 8);
    }
    const __nv_bfloat16* Kt = Ks + stage * kTile;
    const __nv_bfloat16* Vt = Vs + stage * kTile;

    // S = Q K^T: 8 n-tiles of 8 keys
    float s[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < kKS; ++ks) {
#pragma unroll
      for (int jp = 0; jp < 4; ++jp) {
        uint32_t kf[4];
        ldmatrix_x4(kf, Kt + (jp * 16 + lane % 8 + (lane / 16) * 8) * kLd + ks * 16 +
                             ((lane / 8) % 2) * 8);
        mma_bf16(s[2 * jp], qf[ks], kf[0], kf[1]);
        mma_bf16(s[2 * jp + 1], qf[ks], kf[2], kf[3]);
      }
    }

    // scale (log2 domain); the mask only where the block straddles an edge
    const bool edge = k0 + kBK > S || (causal && k0 + kBK - 1 > q0) ||
                      (window > 0 && q0 + kBQ - 1 - k0 >= window);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[j][e] * scale_log2;
        if (edge) {
          const int qpos = e < 2 ? row_a : row_b;
          const int kpos = k0 + j * 8 + 2 * t + (e & 1);
          const int rel = qpos - kpos;
          const bool ok = kpos < S && (!causal || rel >= 0) && (window <= 0 || rel < window);
          x = ok ? x : kNegInf;
        }
        s[j][e] = x;
      }

    // online softmax on the fragments: rows g (e 0, 1) and g + 8 (e 2, 3)
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      mx[0] = fmaxf(mx[0], fmaxf(s[j][0], s[j][1]));
      mx[1] = fmaxf(mx[1], fmaxf(s[j][2], s[j][3]));
    }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m_i[r], mx[r]);
      alpha[r] = exp2f(m_i[r] - m_new);
      m_i[r] = m_new;
    }
    float rs[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] = exp2f(s[j][e] - m_i[e / 2]);
        rs[e / 2] += s[j][e];
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) l_i[r] = l_i[r] * alpha[r] + rs[r];
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt) {
      acc[nt][0] *= alpha[0];
      acc[nt][1] *= alpha[0];
      acc[nt][2] *= alpha[1];
      acc[nt][3] *= alpha[1];
    }

    // acc += P_hi V + P_lo V, 16 keys per k-step
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t ph[4], pl[4];
      split_bf16(s[2 * kk][0], s[2 * kk][1], ph[0], pl[0]);
      split_bf16(s[2 * kk][2], s[2 * kk][3], ph[1], pl[1]);
      split_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1], ph[2], pl[2]);
      split_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3], ph[3], pl[3]);
#pragma unroll
      for (int dp = 0; dp < kNT / 2; ++dp) {
        uint32_t vf[4];
        ldmatrix_x4_trans(vf, Vt + (kk * 16 + lane % 8 + ((lane / 8) % 2) * 8) * kLd +
                                  dp * 16 + (lane / 16) * 8);
        mma_bf16(acc[2 * dp], ph, vf[0], vf[1]);
        mma_bf16(acc[2 * dp], pl, vf[0], vf[1]);
        mma_bf16(acc[2 * dp + 1], ph, vf[2], vf[3]);
        mma_bf16(acc[2 * dp + 1], pl, vf[2], vf[3]);
      }
    }
    __syncthreads();                // this stage's K, V are consumed
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_i[r] += __shfl_xor_sync(0xffffffffu, l_i[r], 1);
    l_i[r] += __shfl_xor_sync(0xffffffffu, l_i[r], 2);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qpos = r == 0 ? row_a : row_b;
    if (qpos >= S) continue;
    const float inv = 1.f / fmaxf(l_i[r], 1e-30f);
    __nv_bfloat16* orow = ob + qpos * q_ld;
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt)
      *reinterpret_cast<__nv_bfloat162*>(orow + nt * 8 + 2 * t) =
          __floats2bfloat162_rn(acc[nt][2 * r] * inv, acc[nt][2 * r + 1] * inv);
  }
}

// ---------------------------------------------------------------------------
// float32: FP32 FMAs on the CUDA cores.

constexpr int kThreads = 256;       // 16 x 16
constexpr int kPStride = kBK + 4;   // padded row of P: no bank conflict between rows

// Eight consecutive floats (16-byte aligned).
__device__ __forceinline__ void load8(const float* p, float* out) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  out[0] = a.x; out[1] = a.y; out[2] = a.z; out[3] = a.w;
  out[4] = b.x; out[5] = b.y; out[6] = b.z; out[7] = b.w;
}

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

// smem: Qt [HD][kBQ], Kt [HD][kBK], Vs [kBK][HD], Ps [kBQ][kPStride].
template <int HD>
__global__ void __launch_bounds__(kThreads)
swa_flash_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ o, int S, int H,
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
  const int tx = tid % 16;          // keys tx*4.., output columns tx, tx + 16, ..
  const int ty = tid / 16;          // query rows ty*4..
  const int64_t q_row = static_cast<int64_t>(H) * HD;
  const int64_t kv_row = static_cast<int64_t>(Hkv) * HD;
  const float* qb = q + static_cast<int64_t>(b) * S * q_row + static_cast<int64_t>(h) * HD;
  const float* kb = k + static_cast<int64_t>(b) * S * kv_row + static_cast<int64_t>(hk) * HD;
  const float* vb = v + static_cast<int64_t>(b) * S * kv_row + static_cast<int64_t>(hk) * HD;
  float* ob = o + static_cast<int64_t>(b) * S * q_row + static_cast<int64_t>(h) * HD;

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

  const int2 blocks = kv_blocks(q0, S, window, causal);
  for (int kblk = blocks.x; kblk <= blocks.y; ++kblk) {
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

    // acc += P @ V for rows ty*4 + i, columns c*16 + tx (a half-warp reads
    // 16 consecutive floats of a V row: no bank conflict at any HD)
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
        for (int c = 0; c < kCols; ++c) {
          const float vv = Vs[(kk + u) * HD + c * 16 + tx];
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[i][c] = fmaf(pr[i][u], vv, acc[i][c]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qpos = q0 + ty * 4 + i;
    if (qpos >= S) continue;
    const float inv = 1.f / fmaxf(l_i[i], 1e-30f);
    float* orow = ob + qpos * q_row;
#pragma unroll
    for (int c = 0; c < kCols; ++c) orow[c * 16 + tx] = acc[i][c] * inv;
  }
}

template <int HD>
int launch_bf16(const void* q, const void* k, const void* v, void* o, int B, int S, int H,
                int Hkv, int window, int causal, float scale, cudaStream_t stream) {
  const int smem = static_cast<int>(sizeof(__nv_bfloat16)) * 5 * kBQ * (HD + 8);
  cudaError_t err = cudaFuncSetAttribute(
      swa_flash_mma_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((S + kBQ - 1) / kBQ, H, B);
  swa_flash_mma_kernel<HD><<<grid, kMmaThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), S, H, Hkv,
      window, causal, scale * 1.4426950408889634f);
  return static_cast<int>(cudaGetLastError());
}

template <int HD>
int launch_f32(const void* q, const void* k, const void* v, void* o, int B, int S, int H,
               int Hkv, int window, int causal, float scale, cudaStream_t stream) {
  const int smem = static_cast<int>(sizeof(float)) * (2 * HD * kBQ + kBK * HD + kBQ * kPStride);
  cudaError_t err = cudaFuncSetAttribute(
      swa_flash_f32_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((S + kBQ - 1) / kBQ, H, B);
  swa_flash_f32_kernel<HD><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(o), S, H, Hkv, window, causal, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, o: (B, S, H, hd); k, v: (B, S, Hkv, hd); contiguous, 16-byte aligned,
// one dtype: 0 float32, 2 bfloat16. hd is 64, 80 or 128. window <= 0 means none.
// Returns the cudaError_t of the launch (0 on success), -1 for a bad argument.
extern "C" int swa_flash(const void* q, const void* k, const void* v, void* o,
                         int B, int S, int H, int Hkv, int hd, int window,
                         int causal, float scale, int dtype, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || Hkv <= 0 || H % Hkv != 0 || B > 65535 || H > 65535)
    return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int key = dtype * 1000 + hd;
  switch (key) {
    case 64: return launch_f32<64>(q, k, v, o, B, S, H, Hkv, window, causal, scale, s);
    case 80: return launch_f32<80>(q, k, v, o, B, S, H, Hkv, window, causal, scale, s);
    case 128: return launch_f32<128>(q, k, v, o, B, S, H, Hkv, window, causal, scale, s);
    case 2064: return launch_bf16<64>(q, k, v, o, B, S, H, Hkv, window, causal, scale, s);
    case 2080: return launch_bf16<80>(q, k, v, o, B, S, H, Hkv, window, causal, scale, s);
    case 2128: return launch_bf16<128>(q, k, v, o, B, S, H, Hkv, window, causal, scale, s);
    default: return -1;
  }
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
