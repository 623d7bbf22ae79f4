// Single-tile attention backward per (batch, head), sm_90a, shared by the
// packed-layout kernel (packed_attention_bwd.cu, #2) and the head-major one
// (small_attention.cu, #4); the layouts differ only in their strides, as in
// packed_tile.cuh.  With inv = 1 / (1 - rate) and keep the Philox mask of
// tile b * H + h (philox.cuh; all ones at rate 0):
//
//     p  = softmax(scale * q k^T, masked)     dp = dO v^T
//
// and then, as the Pallas _packed_bwd_kernel (#2):
//
//     r  = rowsum(keep.p.dp)                  ds = p . (keep.dp - r)
//     dv = inv * (keep.p)^T dO
//     dk = scale * inv * ds^T q               dq = scale * inv * ds k
//
// or, with kScaleP, as _small_bwd_kernel (#4), inv inside the rounded
// operands:
//
//     pd = keep ? p.inv : 0                   dpd = keep ? dp.inv : 0
//     r  = rowsum(p.dpd)                      ds = p . (dpd - r)
//     dv = pd^T dO                            dk = scale * ds^T q
//     dq = scale * ds k
//
// Nothing is saved by the forward: p is recomputed from q and k and the
// mask regenerated from the seed.  The products take operands rounded to
// the input type (p and ds included) and sum in fp32, as the Pallas kernels
// do with preferred_element_type=float32.  Masked scores take the finite
// value -0.7 * FLT_MAX, so a row without any valid key has uniform p over
// Sk, as mha_reference has; a masked score gets no gradient (ds = 0), as in
// the vjp of mha_reference (the Pallas kernels let one through on such a
// row).
//
// Two launches, no atomics, so the result is the same on every run:
//   phase 0, one block per (32-query tile, head, batch): scores of the tile
//     against all Sk keys into shared memory, exact softmax, dp, r and ds in
//     place, then dq = ds k; writes each row's (max, sum, r) to a
//     (B, H, Sq, 3) fp32 scratch;
//   phase 1, one block per (64-key tile, head, batch): walks all query rows
//     in chunks of 32, recomputes p and dp for (chunk x tile) from the
//     scratch statistics, and keeps dk and dv of its keys in registers.
// Both score the same (row, key) pairs with the same fmaf chain over d, so
// they see bitwise the same p; no (Sq, Sk) tile ever reaches device memory.
//
// The design is the simple one that is right: the products run on CUDA
// cores out of shared memory, each thread holding a strip of 8 rows of one
// key so one shared load feeds 8 FMAs.  Tensor-core mma/wgmma tiles and TMA
// are left for later work.

#pragma once

#include <cfloat>
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "philox.cuh"

namespace m3p {
namespace tile_bwd {

constexpr int kThreads = 256;
constexpr int kQTile = 32;                         // query rows of a tile
constexpr int kKTile = 64;                         // keys of a tile
constexpr int kRowStrips = kThreads / kKTile;      // 4
constexpr int kRowsPerThread = kQTile / kRowStrips;  // 8
constexpr float kMaskValue = -0.7f * FLT_MAX;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

template <typename T>
__device__ __forceinline__ float rounded(float x) {
  return to_f(from_f<T>(x));
}

__device__ __forceinline__ float warp_max(float x) {
  for (int off = 16; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int off = 16; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

template <typename T>
struct Params {
  const T* q;
  const T* k;
  const T* v;
  const uint8_t* kv_mask;  // (B, Sk), 1 = attend, or null
  const T* dout;
  T* dq;
  T* dk;
  T* dv;
  float* stats;  // (B, H, Sq, 3): row max, row sum, r
  int b, sq, sk, h, dh;
  // strides in elements: batch (sb), head (sh), row (ss)
  long long q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss;
  long long do_sb, do_sh, do_ss, dq_sb, dq_sh, dq_ss;
  long long dk_sb, dk_sh, dk_ss, dv_sb, dv_sh, dv_ss;
  float scale;
  int causal;
  float inv;
  uint32_t threshold;
  unsigned long long seed;
};

__host__ __device__ inline int odd_pitch(int n) { return n | 1; }

// rows [row0, row0 + n) of a (S, H*Dh) slab into an fp32 (n_max, ld) array;
// missing rows are zero
template <typename T>
__device__ void load_rows(float* dst, const T* src, long long stride,
                          int row0, int n, int n_max, int dh, int ld) {
  for (int i = threadIdx.x; i < n_max * dh; i += kThreads) {
    const int r = i / dh, d = i - r * dh;
    dst[r * ld + d] = r < n ? to_f(src[(row0 + r) * stride + d]) : 0.f;
  }
}

// keep_s[r * kKTile + j] = keep(row q0 + r, key k0 + j) for the whole tile
template <bool kDropout>
__device__ void fill_keep(uint8_t* keep_s, unsigned long long seed,
                          uint32_t threshold, int tile, int q0, int k0) {
  if (!kDropout) return;
  constexpr int kGroups = kKTile / 4;
  for (int i = threadIdx.x; i < kQTile * kGroups; i += kThreads) {
    const int r = i / kGroups, g = i - r * kGroups;
    const uint4 bits = keep_bits(seed, tile, q0 + r, k0 / 4 + g);
    uint8_t* out = keep_s + r * kKTile + 4 * g;
    out[0] = bits.x >= threshold;
    out[1] = bits.y >= threshold;
    out[2] = bits.z >= threshold;
    out[3] = bits.w >= threshold;
  }
}

// acc[m] = a_s[row i0 + 4m] . b_s[key j] over d < dh, the fmaf chain of
// packed_attention.cu, for the thread's key j = tid % kKTile and strip
// i0 = tid / kKTile
__device__ __forceinline__ void strip_dots(const float* a_s, const float* b_s,
                                           int ld, int dh,
                                           float (&acc)[kRowsPerThread]) {
  const int j = threadIdx.x % kKTile, i0 = threadIdx.x / kKTile;
  const float* brow = b_s + j * ld;
#pragma unroll
  for (int m = 0; m < kRowsPerThread; ++m) acc[m] = 0.f;
  for (int d = 0; d < dh; ++d) {
    const float bv = brow[d];
#pragma unroll
    for (int m = 0; m < kRowsPerThread; ++m)
      acc[m] = fmaf(a_s[(i0 + kRowStrips * m) * ld + d], bv, acc[m]);
  }
}

__device__ __forceinline__ bool attends(const uint8_t* mb, int causal, int kj,
                                        int qi, int q_offset) {
  return (mb == nullptr || mb[kj] != 0) && !(causal && kj > qi + q_offset);
}

inline size_t dq_smem_bytes(int sk, int dh) {
  const size_t ld = static_cast<size_t>(dh) + 1;
  return sizeof(float) * (2 * kQTile * ld + kKTile * ld +
                          2 * static_cast<size_t>(kQTile) * odd_pitch(sk)) +
         kQTile * kKTile;
}

inline size_t dkdv_smem_bytes(int dh) {
  const size_t ld = static_cast<size_t>(dh) + 1;
  return sizeof(float) * (2 * kKTile * ld + 2 * kQTile * ld +
                          2 * kQTile * kKTile + 3 * kQTile) +
         kQTile * kKTile;
}

// ---------------------------------------------------------------------------
// phase 0: dq and the row statistics
// ---------------------------------------------------------------------------

template <typename T, bool kDropout, bool kScaleP, int kMaxDh>
__global__ void __launch_bounds__(kThreads)
packed_attention_bwd_dq_kernel(Params<T> p) {
  constexpr int kDims = kMaxDh / (kThreads / kQTile);  // dq columns / thread
  extern __shared__ float smem[];
  const int dh = p.dh, sq = p.sq, sk = p.sk;
  const int ld = dh + 1, ldp = odd_pitch(sk);
  float* q_s = smem;                   // (kQTile, ld)
  float* do_s = q_s + kQTile * ld;     // (kQTile, ld)
  float* kv_s = do_s + kQTile * ld;    // (kKTile, ld): K, then V, then K
  float* p_s = kv_s + kKTile * ld;     // (kQTile, ldp): s, p, then ds
  float* dp_s = p_s + kQTile * ldp;    // (kQTile, ldp): keep.dp
  uint8_t* keep_s = reinterpret_cast<uint8_t*>(dp_s + kQTile * ldp);

  const int q0 = blockIdx.x * kQTile;
  const int h = blockIdx.y, b = blockIdx.z;
  const int tile = b * gridDim.y + h;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int q_offset = sk - sq;
  const int rows = min(kQTile, sq - q0);
  const T* qb = p.q + b * p.q_sb + h * p.q_sh;
  const T* kb = p.k + b * p.k_sb + h * p.k_sh;
  const T* vb = p.v + b * p.v_sb + h * p.v_sh;
  const T* dob = p.dout + b * p.do_sb + h * p.do_sh;
  const uint8_t* mb =
      p.kv_mask == nullptr ? nullptr : p.kv_mask + static_cast<long long>(b) * sk;
  float* stats = p.stats + (static_cast<long long>(tile) * sq + q0) * 3;

  load_rows(q_s, qb, p.q_ss, q0, rows, kQTile, dh, ld);
  load_rows(do_s, dob, p.do_ss, q0, rows, kQTile, dh, ld);
  const int j = tid % kKTile, i0 = tid / kKTile;

  // scores: p_s[i][kj] = scale * q_i . k_kj, or the mask value
  for (int k0 = 0; k0 < sk; k0 += kKTile) {
    const int kn = min(kKTile, sk - k0);
    __syncthreads();
    load_rows(kv_s, kb, p.k_ss, k0, kn, kKTile, dh, ld);
    __syncthreads();
    float acc[kRowsPerThread];
    strip_dots(q_s, kv_s, ld, dh, acc);
    if (j < kn) {
#pragma unroll
      for (int m = 0; m < kRowsPerThread; ++m) {
        const int i = i0 + kRowStrips * m;
        if (i < rows)
          p_s[i * ldp + k0 + j] = attends(mb, p.causal, k0 + j, q0 + i,
                                          q_offset)
                                      ? acc[m] * p.scale
                                      : kMaskValue;
      }
    }
  }
  __syncthreads();

  // exact softmax per row (a warp per row), statistics to the scratch
  for (int i = warp; i < rows; i += kThreads / 32) {
    float* prow = p_s + i * ldp;
    float mx = -FLT_MAX;
    for (int c = lane; c < sk; c += 32) mx = fmaxf(mx, prow[c]);
    mx = warp_max(mx);
    float sum = 0.f;
    for (int c = lane; c < sk; c += 32) {
      const float e = expf(prow[c] - mx);
      prow[c] = e;
      sum += e;
    }
    sum = warp_sum(sum);
    for (int c = lane; c < sk; c += 32) prow[c] = prow[c] / sum;
    if (lane == 0) {
      stats[i * 3 + 0] = mx;
      stats[i * 3 + 1] = sum;
    }
  }

  // dp_s[i][kj] = keep ? dO_i . v_kj : 0
  for (int k0 = 0; k0 < sk; k0 += kKTile) {
    const int kn = min(kKTile, sk - k0);
    __syncthreads();
    load_rows(kv_s, vb, p.v_ss, k0, kn, kKTile, dh, ld);
    fill_keep<kDropout>(keep_s, p.seed, p.threshold, tile, q0, k0);
    __syncthreads();
    float acc[kRowsPerThread];
    strip_dots(do_s, kv_s, ld, dh, acc);
    if (j < kn) {
#pragma unroll
      for (int m = 0; m < kRowsPerThread; ++m) {
        const int i = i0 + kRowStrips * m;
        const bool keep = !kDropout || keep_s[i * kKTile + j] != 0;
        if (i < rows)
          dp_s[i * ldp + k0 + j] =
              keep ? (kScaleP ? acc[m] * p.inv : acc[m]) : 0.f;
      }
    }
  }
  __syncthreads();

  // r = rowsum(p . keep.dp); ds = p . (keep.dp - r), rounded, over p;
  // ds = 0 at a masked score
  for (int i = warp; i < rows; i += kThreads / 32) {
    float* prow = p_s + i * ldp;
    const float* dprow = dp_s + i * ldp;
    float r = 0.f;
    for (int c = lane; c < sk; c += 32) r += prow[c] * dprow[c];
    r = warp_sum(r);
    for (int c = lane; c < sk; c += 32)
      prow[c] = attends(mb, p.causal, c, q0 + i, q_offset)
                    ? rounded<T>(prow[c] * (dprow[c] - r))
                    : 0.f;
    if (lane == 0) stats[i * 3 + 2] = r;
  }

  // dq_i = scale * inv * sum_kj ds[i][kj] k_kj; thread: row tid % 32,
  // columns tid / 32 + 8 c
  const int qi_local = tid % kQTile, d0 = tid / kQTile;
  float acc[kDims];
#pragma unroll
  for (int c = 0; c < kDims; ++c) acc[c] = 0.f;
  for (int k0 = 0; k0 < sk; k0 += kKTile) {
    const int kn = min(kKTile, sk - k0);
    __syncthreads();
    load_rows(kv_s, kb, p.k_ss, k0, kn, kKTile, dh, ld);
    __syncthreads();
    const float* dsrow = p_s + qi_local * ldp + k0;
    for (int jj = 0; jj < kn; ++jj) {
      const float ds = dsrow[jj];
      const float* krow = kv_s + jj * ld;
#pragma unroll
      for (int c = 0; c < kDims; ++c) {
        const int d = d0 + (kThreads / kQTile) * c;
        if (d < dh) acc[c] = fmaf(ds, krow[d], acc[c]);
      }
    }
  }
  if (qi_local < rows) {
    T* dqb = p.dq + b * p.dq_sb + h * p.dq_sh + (q0 + qi_local) * p.dq_ss;
    const float f = kScaleP ? p.scale : p.scale * p.inv;
#pragma unroll
    for (int c = 0; c < kDims; ++c) {
      const int d = d0 + (kThreads / kQTile) * c;
      if (d < dh) dqb[d] = from_f<T>(acc[c] * f);
    }
  }
}

// ---------------------------------------------------------------------------
// phase 1: dk and dv
// ---------------------------------------------------------------------------

template <typename T, bool kDropout, bool kScaleP, int kMaxDh>
__global__ void __launch_bounds__(kThreads)
packed_attention_bwd_dkdv_kernel(Params<T> p) {
  constexpr int kDims = kMaxDh / kRowStrips;  // dk/dv columns per thread
  extern __shared__ float smem[];
  const int dh = p.dh, sq = p.sq, sk = p.sk;
  const int ld = dh + 1;
  float* k_s = smem;                     // (kKTile, ld)
  float* v_s = k_s + kKTile * ld;        // (kKTile, ld)
  float* q_s = v_s + kKTile * ld;        // (kQTile, ld)
  float* do_s = q_s + kQTile * ld;       // (kQTile, ld)
  float* pd_s = do_s + kQTile * ld;      // (kQTile, kKTile): keep.p rounded
  float* ds_s = pd_s + kQTile * kKTile;  // (kQTile, kKTile): ds rounded
  float* st_s = ds_s + kQTile * kKTile;  // (kQTile, 3)
  uint8_t* keep_s = reinterpret_cast<uint8_t*>(st_s + 3 * kQTile);

  const int k0 = blockIdx.x * kKTile;
  const int h = blockIdx.y, b = blockIdx.z;
  const int tile = b * gridDim.y + h;
  const int tid = threadIdx.x;
  const int q_offset = sk - sq;
  const int kn = min(kKTile, sk - k0);
  const T* qb = p.q + b * p.q_sb + h * p.q_sh;
  const T* dob = p.dout + b * p.do_sb + h * p.do_sh;
  const uint8_t* mb =
      p.kv_mask == nullptr ? nullptr : p.kv_mask + static_cast<long long>(b) * sk;
  const float* stats = p.stats + static_cast<long long>(tile) * sq * 3;

  load_rows(k_s, p.k + b * p.k_sb + h * p.k_sh, p.k_ss, k0, kn, kKTile, dh,
            ld);
  load_rows(v_s, p.v + b * p.v_sb + h * p.v_sh, p.v_ss, k0, kn, kKTile, dh,
            ld);
  const int j = tid % kKTile, i0 = tid / kKTile;
  const int kj = k0 + j;
  float dk_acc[kDims], dv_acc[kDims];
#pragma unroll
  for (int c = 0; c < kDims; ++c) dk_acc[c] = dv_acc[c] = 0.f;

  for (int q0 = 0; q0 < sq; q0 += kQTile) {
    const int rows = min(kQTile, sq - q0);
    __syncthreads();
    load_rows(q_s, qb, p.q_ss, q0, rows, kQTile, dh, ld);
    load_rows(do_s, dob, p.do_ss, q0, rows, kQTile, dh, ld);
    for (int i = tid; i < 3 * rows; i += kThreads)
      st_s[i] = stats[q0 * 3 + i];
    fill_keep<kDropout>(keep_s, p.seed, p.threshold, tile, q0, k0);
    __syncthreads();
    float s[kRowsPerThread], dp[kRowsPerThread];
    strip_dots(q_s, k_s, ld, dh, s);
    strip_dots(do_s, v_s, ld, dh, dp);
#pragma unroll
    for (int m = 0; m < kRowsPerThread; ++m) {
      const int i = i0 + kRowStrips * m;
      float pd = 0.f, ds = 0.f;
      if (i < rows && j < kn) {
        const bool valid = attends(mb, p.causal, kj, q0 + i, q_offset);
        const float sc = valid ? s[m] * p.scale : kMaskValue;
        const float pr = expf(sc - st_s[i * 3 + 0]) / st_s[i * 3 + 1];
        const bool keep = !kDropout || keep_s[i * kKTile + j] != 0;
        pd = keep ? (kScaleP ? pr * p.inv : pr) : 0.f;
        const float dpd = keep ? (kScaleP ? dp[m] * p.inv : dp[m]) : 0.f;
        ds = valid ? pr * (dpd - st_s[i * 3 + 2]) : 0.f;
      }
      pd_s[i * kKTile + j] = rounded<T>(pd);
      ds_s[i * kKTile + j] = rounded<T>(ds);
    }
    __syncthreads();
    for (int i = 0; i < rows; ++i) {
      const float pd = pd_s[i * kKTile + j];
      const float ds = ds_s[i * kKTile + j];
      const float* dorow = do_s + i * ld;
      const float* qrow = q_s + i * ld;
#pragma unroll
      for (int c = 0; c < kDims; ++c) {
        const int d = i0 + kRowStrips * c;
        if (d < dh) {
          dv_acc[c] = fmaf(pd, dorow[d], dv_acc[c]);
          dk_acc[c] = fmaf(ds, qrow[d], dk_acc[c]);
        }
      }
    }
  }

  if (j < kn) {
    T* dkb = p.dk + b * p.dk_sb + h * p.dk_sh + kj * p.dk_ss;
    T* dvb = p.dv + b * p.dv_sb + h * p.dv_sh + kj * p.dv_ss;
    const float fk = kScaleP ? p.scale : p.scale * p.inv;
#pragma unroll
    for (int c = 0; c < kDims; ++c) {
      const int d = i0 + kRowStrips * c;
      if (d < dh) {
        dkb[d] = from_f<T>(dk_acc[c] * fk);
        dvb[d] = from_f<T>(kScaleP ? dv_acc[c] : dv_acc[c] * p.inv);
      }
    }
  }
}

template <typename T, bool kDropout, bool kScaleP, int kMaxDh>
cudaError_t launch(int phase, const Params<T>& p, cudaStream_t stream) {
  const dim3 block(kThreads);
  if (phase == 0) {
    const size_t smem = dq_smem_bytes(p.sk, p.dh);
    auto kernel = packed_attention_bwd_dq_kernel<T, kDropout, kScaleP, kMaxDh>;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    kernel<<<dim3((p.sq + kQTile - 1) / kQTile, p.h, p.b), block, smem,
             stream>>>(p);
  } else {
    const size_t smem = dkdv_smem_bytes(p.dh);
    auto kernel =
        packed_attention_bwd_dkdv_kernel<T, kDropout, kScaleP, kMaxDh>;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    kernel<<<dim3((p.sk + kKTile - 1) / kKTile, p.h, p.b), block, smem,
             stream>>>(p);
  }
  return cudaGetLastError();
}

template <typename T, bool kScaleP>
cudaError_t launch_for(int phase, const Params<T>& p, cudaStream_t stream) {
  const bool dropout = p.threshold != 0u;
  if (p.dh <= 64)
    return dropout ? launch<T, true, kScaleP, 64>(phase, p, stream)
                   : launch<T, false, kScaleP, 64>(phase, p, stream);
  return dropout ? launch<T, true, kScaleP, 128>(phase, p, stream)
                 : launch<T, false, kScaleP, 128>(phase, p, stream);
}

template <typename T>
Params<T> make_params(const void* q, const void* k, const void* v,
                      const void* kv_mask, const void* dout, void* dq,
                      void* dk, void* dv, void* stats, int b, int sq, int sk,
                      int h, int dh, const long long (&st)[21], float scale,
                      int causal, float inv, unsigned int threshold,
                      unsigned long long seed) {
  return Params<T>{static_cast<const T*>(q), static_cast<const T*>(k),
                   static_cast<const T*>(v),
                   static_cast<const uint8_t*>(kv_mask),
                   static_cast<const T*>(dout), static_cast<T*>(dq),
                   static_cast<T*>(dk), static_cast<T*>(dv),
                   static_cast<float*>(stats), b, sq, sk, h, dh,
                   st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7],
                   st[8], st[9], st[10], st[11], st[12], st[13], st[14],
                   st[15], st[16], st[17], st[18], st[19], st[20],
                   scale, causal, inv, threshold, seed};
}

// dtype: 0 = float32, 1 = bfloat16; phase 0 = dq and the row statistics,
// 1 = dk and dv (reads the statistics; launch after phase 0 on one
// stream).  st: the batch, head and row strides of q, k, v, dO, dq, dk, dv
// in that order.  Dropout when threshold != 0.
template <bool kScaleP>
cudaError_t dispatch(int dtype, int phase, const void* q, const void* k,
                     const void* v, const void* kv_mask, const void* dout,
                     void* dq, void* dk, void* dv, void* stats, int b,
                     int sq, int sk, int h, int dh,
                     const long long (&st)[21], float scale, int causal,
                     float inv, unsigned int threshold,
                     unsigned long long seed, cudaStream_t stream) {
  if (dh > 128 || (phase != 0 && phase != 1)) return cudaErrorInvalidValue;
  if (dtype == 0)
    return launch_for<float, kScaleP>(
        phase,
        make_params<float>(q, k, v, kv_mask, dout, dq, dk, dv, stats, b, sq,
                           sk, h, dh, st, scale, causal, inv, threshold,
                           seed),
        stream);
  if (dtype == 1)
    return launch_for<__nv_bfloat16, kScaleP>(
        phase,
        make_params<__nv_bfloat16>(q, k, v, kv_mask, dout, dq, dk, dv, stats,
                                   b, sq, sk, h, dh, st, scale, causal, inv,
                                   threshold, seed),
        stream);
  return cudaErrorInvalidValue;
}

}  // namespace tile_bwd
}  // namespace m3p
