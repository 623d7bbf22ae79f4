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
// Two designs, two launches each, no atomics, so the result is the same on
// every run: phase 0 computes dq and each query row's statistics into a
// (B, H, Sq, 3) fp32 scratch, phase 1 dk and dv from them.  The C entries
// launch the design the caller names (tc_fits, and Sq, Sk <= kMaxSeq, for
// the tensor cores; ops/attention.py::_packed_design and _small_design).
// No (Sq, Sk) tile ever reaches device memory.
//
// CUDA cores (fp32, and bf16 outside the tensor-core rule): the products
// run out of fp32 shared memory, each thread holding a strip of 8 rows of
// one key so one shared load feeds 8 FMAs.
//   phase 0, one block per (32-query tile, head, batch): scores of the tile
//     against all Sk keys into shared memory, exact softmax, dp, r and ds in
//     place, then dq = ds k; the statistics are (max, sum, r);
//   phase 1, one block per (64-key tile, head, batch): walks all query rows
//     in chunks of 32, recomputes p and dp for (chunk x tile) from the
//     scratch statistics, and keeps dk and dv of its keys in registers.
//   Both score the same (row, key) pairs with the same fmaf chain over d, so
//   they see bitwise the same p.
//
// Tensor cores (bf16, Dh a multiple of 16 up to 128, 16-byte aligned rows,
// Sq, Sk <= 512; the model's paths): mma.sync m16n8k16 with fp32 sums,
// blocks of 4 warps, so that 2-3 blocks share an SM at S = 100-512 and
// hide each other's staging.  See namespace tc below.

#pragma once

#include <cfloat>
#include <cstdint>
#include <type_traits>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "flash_tile.cuh"
#include "mma.cuh"
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
  float* stats;     // (B, H, Sq, 3): row max, row sum (1 / sum on the
                    // tensor cores), r
  uint32_t* bits;   // tensor cores with dropout: (B, H, Sq, ceil(Sk / 32))
                    // keep bits, written by phase 0 for phase 1
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
  int head_base, heads_total;  // the Philox tiles' heads (philox_tile)
  // the debug instantiation only (kDump, M3P_SCORE_DUMP): (4, B, H, Sq, Sk)
  // fp32, phase 0's and phase 1's scores q.k, then their p
  float* scores;
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
    fill_keep<kDropout>(keep_s, p.seed, p.threshold,
                        philox_tile(b, h, p.head_base, p.heads_total),
                        q0, k0);
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
    fill_keep<kDropout>(keep_s, p.seed, p.threshold,
                        philox_tile(b, h, p.head_base, p.heads_total),
                        q0, k0);
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
                      void* dk, void* dv, void* stats, void* bits, int b,
                      int sq, int sk, int h, int dh,
                      const long long (&st)[21], float scale, int causal,
                      float inv, unsigned int threshold,
                      unsigned long long seed, int head_base,
                      int heads_total) {
  return Params<T>{static_cast<const T*>(q), static_cast<const T*>(k),
                   static_cast<const T*>(v),
                   static_cast<const uint8_t*>(kv_mask),
                   static_cast<const T*>(dout), static_cast<T*>(dq),
                   static_cast<T*>(dk), static_cast<T*>(dv),
                   static_cast<float*>(stats), static_cast<uint32_t*>(bits),
                   b, sq, sk, h, dh,
                   st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7],
                   st[8], st[9], st[10], st[11], st[12], st[13], st[14],
                   st[15], st[16], st[17], st[18], st[19], st[20],
                   scale, causal, inv, threshold, seed, head_base,
                   heads_total, nullptr};
}

// ---------------------------------------------------------------------------
// bf16 on the tensor cores: mma.sync m16n8k16, fp32 sums
// ---------------------------------------------------------------------------
//
// Phase 0, one block of 4 warps per (64-query tile, head, batch); warp w
// owns queries 16 w .. 16 w + 15 in the M dimension (a lane rows g and
// g + 8) and walks the keys in 64-key tiles, K and V two stages deep by
// cp.async, twice:
//   pass A: s = q k^T, dp = dO v^T; the exact row statistics over all Sk
//     keys, max m, l = sum exp(s - m) and r = rowsum(p . keep.dp), in one
//     online pass (the sums rescaled when the running max grows);
//   pass B: s and dp again, p = exp(s - m) / l, ds = p . (keep.dp - r)
//     rounded to bf16 in the C-to-A fragment repack, dq += ds k.
//   Writes (m, 1 / l, r) per row.  With dropout the block draws the keep
//   bits of its 64 rows against all Sk keys once (Philox, 8 groups a word)
//   into shared memory for both passes, and writes them to a (B, H, Sq,
//   ceil(Sk / 32)) word scratch for phase 1, which so draws none.
// Phase 1, one block of 4 warps per (64-key tile, head, batch); warp w owns
// keys 16 w .. 16 w + 15 in M and walks the queries in kQT-row tiles (64 at
// Dh 64, 32 at Dh 128 to spare registers), q, dO, their statistics and
// keep words two stages deep by cp.async: s^T = k q^T and dp^T = v dO^T,
// then pd^T and ds^T passed from C to A fragments in registers (rounded to
// bf16 where the CUDA-core design rounds them) for dv += pd^T dO and
// dk += ds^T q.  This is flash_attention_bwd.cu's phase 0 with the
// statistics of phase 0 here in place of the forward's.
// Both phases: a tile whose every (query, key) pair of a warp is in range
// and attended skips the per-element masking (a warp vote); a warp whose
// rows (keys) all lie past Sq (Sk) only helps stage the tiles.  Rows padded
// by 8 bf16 keep ldmatrix free of bank conflicts.  Dh 64 and 128 compile
// exact, other multiples of 16 take the Dh <= 128 kernels.
// Products: phase 0 does five (q k^T and dO v^T in both passes, ds k),
// phase 1 four, nine against the five of the math.  Phase 1 scores
// s^T = k q^T, the same products as phase 0's s = q k^T summed over the
// same k-steps with the operands' roles swapped, which PTX does not promise
// to round identically.  On an H100 the debug build (kDump) shows them
// equal: the two phases write bitwise the same scores and p at causal
// (63, 63) and cross (63, 100) (tests/test_torch_kernels.py).
// Shared memory at Dh 64: 59,392 bytes (phase 0), 57,856 (phase 1); at
// Dh 128: 108,544 / 108,032.  Registers (nvcc -Xptxas -v, sm_90a; without /
// with dropout; #2's and #4's instantiations within 4 of each other):
// phase 0 168 / 167 at Dh 64, 168 / 184-188 at Dh 128, 168 / 168 in the
// Dh <= 128 kernel; phase 1 198 / 180 at Dh 64, 242 / 244 at Dh 128,
// 222 / 232; no spills.  So at Dh 64 phase 0 runs three blocks (12 warps)
// an SM and phase 1 two.

namespace tc {

using bf16 = __nv_bfloat16;
using namespace m3p::mma;

constexpr int kWarps = 4;
constexpr int kThreadsTc = 32 * kWarps;
constexpr int kRows = 16 * kWarps;   // queries (phase 0) or keys (phase 1)
constexpr int kKT = 64;              // keys of a phase-0 tile
constexpr int kPad = 8;              // bf16 padding of a shared row
constexpr int kMaxSeq = 512;         // Sq, Sk the design takes
constexpr int kWords = kMaxSeq / 32;  // keep words of a phase-0 row
static_assert(kKT == flash::kTile, "whole_tile votes over flash::kTile keys");
static_assert(kRows == 2 * 32, "a phase-1 block's keys are two keep words");

// queries of a phase-1 tile: fewer at Dh 128 to spare registers
template <int kMaxDh>
constexpr int kQTileOf = kMaxDh <= 64 ? 64 : 32;

// phase 0: q and dO (kRows, ld); two stages of K and V (kKT, ld); the keep
// words (kRows, kWords)
inline size_t smem_bytes_dq(int dh) {
  return sizeof(bf16) * static_cast<size_t>(2 * kRows + 4 * kKT) *
             (dh + kPad) +
         sizeof(uint32_t) * kRows * kWords;
}

// phase 1: K and V (kRows, ld); two stages of q and dO (kQT, ld), of
// (m, 1 / l, r) (3, kQT) fp32 and of the keep words (kQT, 2)
inline size_t smem_bytes_dkdv(int dh, int qt) {
  return sizeof(bf16) * static_cast<size_t>(2 * kRows + 4 * qt) *
             (dh + kPad) +
         sizeof(float) * 6 * qt + sizeof(uint32_t) * 4 * qt;
}

template <int kR>
__device__ __forceinline__ void load_rows_async(bf16* dst, int ld,
                                                const bf16* src,
                                                long long stride, int row0,
                                                int n, int dh) {
  flash::load_tile_async<kR, kThreadsTc>(dst, ld, src, stride, row0, n, dh);
}

// dp as it enters r and ds: keep ? dp (times inv with kScaleP) : 0
template <bool kDropout, bool kScaleP>
__device__ __forceinline__ float kept_dp(const Params<bf16>& p, bool keep,
                                         float dp) {
  return !kDropout || keep ? (kScaleP ? dp * p.inv : dp) : 0.f;
}

// The keep bits of query rows q0 .. q0 + rows - 1 against every key: bit j
// of word w of row r is the keep bit of (q0 + r, 32 w + j), 0 past Sk; into
// bits_s (kRows, kWords) and the scratch
__device__ inline void fill_bits(uint32_t* bits_s, const Params<bf16>& p,
                                 int tile, int q0, int rows) {
  const int words = (p.sk + 31) / 32;
  for (int i = threadIdx.x; i < rows * words; i += kThreadsTc) {
    const int r = i / words, w = i - r * words;
    uint32_t word = 0;
    for (int grp = 0; grp < 8 && 32 * w + 4 * grp < p.sk; ++grp) {
      const uint4 x = keep_bits(
          p.seed,
          philox_tile(tile / p.h, tile % p.h, p.head_base, p.heads_total),
          q0 + r, 8 * w + grp);
      word |= (static_cast<uint32_t>(x.x >= p.threshold) |
               static_cast<uint32_t>(x.y >= p.threshold) << 1 |
               static_cast<uint32_t>(x.z >= p.threshold) << 2 |
               static_cast<uint32_t>(x.w >= p.threshold) << 3)
              << (4 * grp);
    }
    const int left = p.sk - 32 * w;
    if (left < 32) word &= (1u << left) - 1u;
    bits_s[r * kWords + w] = word;
    p.bits[(static_cast<long long>(tile) * p.sq + q0 + r) * words + w] = word;
  }
}

// The debug instantiation (kDump) writes entry (qi, kj) of what a phase
// computes to slot `which` of p.scores: 0 / 1 the unscaled score q.k of
// phase 0 / 1, 2 / 3 their p
__device__ __forceinline__ void dump(const Params<bf16>& p, int which,
                                     int tile, int qi, int kj, float x) {
  const long long n = static_cast<long long>(p.b) * p.h * p.sq * p.sk;
  p.scores[which * n + (static_cast<long long>(tile) * p.sq + qi) * p.sk +
           kj] = x;
}

template <bool kDropout, bool kScaleP, int kMaxDh, bool kExact,
          bool kDump = false>
__global__ void __launch_bounds__(kThreadsTc)
packed_attention_bwd_dq_mma_kernel(Params<bf16> p) {
  constexpr int kDSteps = kMaxDh / 16, kDTiles = kMaxDh / 8;
  constexpr int kKeyTiles = kKT / 8;
  extern __shared__ float4 smem4[];
  const int dh = kExact ? kMaxDh : p.dh, sq = p.sq, sk = p.sk;
  const int ld = dh + kPad;
  bf16* q_s = reinterpret_cast<bf16*>(smem4);
  bf16* do_s = q_s + kRows * ld;
  bf16* kv_s = do_s + kRows * ld;  // stage i: K at 2 i kKT ld, then V
  uint32_t* bits_s = reinterpret_cast<uint32_t*>(kv_s + 4 * kKT * ld);

  const int q0 = blockIdx.x * kRows;
  const int h = blockIdx.y, b = blockIdx.z;
  const int tile = b * gridDim.y + h;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int q_offset = sk - sq;
  const bf16* kb = p.k + b * p.k_sb + h * p.k_sh;
  const bf16* vb = p.v + b * p.v_sb + h * p.v_sh;
  const uint8_t* mb =
      p.kv_mask == nullptr ? nullptr : p.kv_mask + static_cast<long long>(b) * sk;
  const int rows = min(kRows, sq - q0);
  const int n_tiles = (sk + kKT - 1) / kKT;
  const bool busy = 16 * warp < rows;  // warp-uniform: a row below Sq

  load_rows_async<kRows>(q_s, ld, p.q + b * p.q_sb + h * p.q_sh, p.q_ss, q0,
                         rows, dh);
  load_rows_async<kRows>(do_s, ld, p.dout + b * p.do_sb + h * p.do_sh,
                         p.do_ss, q0, rows, dh);
  load_rows_async<kKT>(kv_s, ld, kb, p.k_ss, 0, min(kKT, sk), dh);
  load_rows_async<kKT>(kv_s + kKT * ld, ld, vb, p.v_ss, 0, min(kKT, sk), dh);
  cp_async_commit();
  if (kDropout) fill_bits(bits_s, p, tile, q0, rows);

  // the lane's rows q0 + 16 w + g + 8 half: running max, and the lane's
  // share of l and of r's numerator; after pass A, 1 / l and r
  float m[2] = {-FLT_MAX, -FLT_MAX}, l[2] = {0.f, 0.f}, r[2] = {0.f, 0.f};
  float dq_acc[kDTiles][4];
#pragma unroll
  for (int n = 0; n < kDTiles; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq_acc[n][e] = 0.f;

  for (int it = 0; it < 2 * n_tiles; ++it) {
    const bool pass_b = it >= n_tiles;
    const int k0 = (pass_b ? it - n_tiles : it) * kKT;
    const int kn = min(kKT, sk - k0);
    if (it + 1 < 2 * n_tiles) {
      bf16* next = kv_s + ((it + 1) & 1) * 2 * kKT * ld;
      const int nk0 = ((it + 1) % n_tiles) * kKT, nn = min(kKT, sk - nk0);
      load_rows_async<kKT>(next, ld, kb, p.k_ss, nk0, nn, dh);
      load_rows_async<kKT>(next + kKT * ld, ld, vb, p.v_ss, nk0, nn, dh);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const bf16* k_s = kv_s + (it & 1) * 2 * kKT * ld;
    const bf16* v_s = k_s + kKT * ld;

    if (busy) {
      if (it == n_tiles) {
        // pass A is done: the rows' 1 / l and r; (m, 1 / l, r) out
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const float lt = flash::quad_sum(l[half]);
          r[half] = flash::quad_sum(r[half]) / lt;
          l[half] = 1.f / lt;
          const int qi = q0 + 16 * warp + g + 8 * half;
          if (t == 0 && qi < sq) {
            float* st = p.stats + (static_cast<long long>(tile) * sq + qi) * 3;
            st[0] = m[half];
            st[1] = l[half];
            st[2] = r[half];
          }
        }
      }

      // s = q k^T, dp = dO v^T: query rows, keys 8 j + 2 t + e
      float s[kKeyTiles][4], dp[kKeyTiles][4];
#pragma unroll
      for (int j = 0; j < kKeyTiles; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
      for (int ds = 0; ds < kDSteps; ++ds)
        if (16 * ds < dh) {
          uint32_t qa[4], da[4];
          flash::load_a_frag(qa, q_s, ld, warp, ds, lane);
          flash::load_a_frag(da, do_s, ld, warp, ds, lane);
#pragma unroll
          for (int j = 0; j < kKeyTiles; j += 2) {
            uint32_t bb[4];
            flash::load_b_pair(bb, k_s, ld, j, ds, lane);
            mma_16816(s[j], qa, bb[0], bb[1]);
            mma_16816(s[j + 1], qa, bb[2], bb[3]);
            flash::load_b_pair(bb, v_s, ld, j, ds, lane);
            mma_16816(dp[j], da, bb[0], bb[1]);
            mma_16816(dp[j + 1], da, bb[2], bb[3]);
          }
        }

      // the keep words of the lane's rows for keys k0 .. k0 + 63
      uint32_t kw[2][2] = {{0u, 0u}, {0u, 0u}};
      if (kDropout) {
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const uint32_t* row =
              bits_s + (16 * warp + g + 8 * half) * kWords + k0 / 32;
          kw[half][0] = row[0];
          kw[half][1] = k0 + 32 < sk ? row[1] : 0u;
        }
      }
      auto keep = [&](int half, int j, int e) {
        return ((kw[half][j >> 2] >> (8 * (j & 3) + 2 * t + e)) & 1u) != 0u;
      };

      // a tile whose every key the warp's rows attend skips the masking
      // (rows past Sq feed only their own results, which are not written)
      const bool whole = flash::whole_tile(mb, p.causal, k0, kn,
                                           q0 + 16 * warp + q_offset, lane);
      if (!pass_b) {
        if constexpr (kDump) {
#pragma unroll
          for (int half = 0; half < 2; ++half)
#pragma unroll
            for (int j = 0; j < kKeyTiles; ++j)
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                const int qi = q0 + 16 * warp + g + 8 * half;
                const int c = 8 * j + 2 * t + e;
                if (qi < sq && c < kn)
                  dump(p, 0, tile, qi, k0 + c, s[j][2 * half + e]);
              }
        }
        // pass A: scores into s (-FLT_MAX past Sk, the mask value where
        // not attended), then the online statistics
        auto stats_of = [&](auto whole_tile) {
          constexpr bool kWhole = decltype(whole_tile)::value;
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int qi = q0 + 16 * warp + g + 8 * half;
            float mx = -FLT_MAX;
#pragma unroll
            for (int j = 0; j < kKeyTiles; ++j)
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                const int c = 8 * j + 2 * t + e;
                float& sc = s[j][2 * half + e];
                if (kWhole)
                  sc *= p.scale;
                else if (c >= kn)
                  sc = -FLT_MAX;
                else
                  sc = attends(mb, p.causal, k0 + c, qi, q_offset)
                           ? sc * p.scale
                           : kMaskValue;
                mx = fmaxf(mx, sc);
              }
            const float m_new = fmaxf(m[half], flash::quad_max(mx));
            const float alpha = expf(m[half] - m_new);
            float ls = 0.f, rs = 0.f;
#pragma unroll
            for (int j = 0; j < kKeyTiles; ++j)
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                const float ex = expf(s[j][2 * half + e] - m_new);
                ls += ex;
                rs += ex * kept_dp<kDropout, kScaleP>(p, keep(half, j, e),
                                                      dp[j][2 * half + e]);
              }
            l[half] = l[half] * alpha + ls;
            r[half] = r[half] * alpha + rs;
            m[half] = m_new;
          }
        };
        if (whole)
          stats_of(std::true_type());
        else
          stats_of(std::false_type());
      } else {
        // pass B: ds into s, then dq += ds k with ds rounded to bf16
        auto grads_of = [&](auto whole_tile) {
          constexpr bool kWhole = decltype(whole_tile)::value;
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int qi = q0 + 16 * warp + g + 8 * half;
#pragma unroll
            for (int j = 0; j < kKeyTiles; ++j)
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                const int c = 8 * j + 2 * t + e;
                const bool valid =
                    kWhole ||
                    (c < kn && attends(mb, p.causal, k0 + c, qi, q_offset));
                float dsv = 0.f;
                if (valid) {
                  const float pr =
                      expf(s[j][2 * half + e] * p.scale - m[half]) * l[half];
                  if constexpr (kDump)
                    if (qi < sq) dump(p, 2, tile, qi, k0 + c, pr);
                  dsv = pr * (kept_dp<kDropout, kScaleP>(
                                  p, keep(half, j, e), dp[j][2 * half + e]) -
                              r[half]);
                }
                s[j][2 * half + e] = dsv;
              }
          }
        };
        if (whole)
          grads_of(std::true_type());
        else
          grads_of(std::false_type());
#pragma unroll
        for (int kk = 0; kk < kKT / 16; ++kk) {
          uint32_t a[4];
          a[0] = pack_bf16x2(s[2 * kk][0], s[2 * kk][1]);
          a[1] = pack_bf16x2(s[2 * kk][2], s[2 * kk][3]);
          a[2] = pack_bf16x2(s[2 * kk + 1][0], s[2 * kk + 1][1]);
          a[3] = pack_bf16x2(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
          for (int n = 0; n < kDTiles; n += 2)
            if (8 * n < dh) {
              uint32_t bb[4];
              flash::load_b_pair_trans(bb, k_s, ld, kk, n, lane);
              mma_16816(dq_acc[n], a, bb[0], bb[1]);
              mma_16816(dq_acc[n + 1], a, bb[2], bb[3]);
            }
        }
      }
    }
    __syncthreads();  // this stage is consumed
  }

  if (!busy) return;
  const float f = kScaleP ? p.scale : p.scale * p.inv;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int qi = q0 + 16 * warp + g + 8 * half;
    if (qi >= sq) continue;
    bf16* dqb = p.dq + b * p.dq_sb + h * p.dq_sh + qi * p.dq_ss;
#pragma unroll
    for (int n = 0; n < kDTiles; ++n)
      if (8 * n < dh)
        *reinterpret_cast<uint32_t*>(dqb + 8 * n + 2 * t) = pack_bf16x2(
            dq_acc[n][2 * half] * f, dq_acc[n][2 * half + 1] * f);
  }
}

// (m, 1 / l, r) of query rows q0 .. q0 + kQT into st (3, kQT) and the two
// keep words of each row for keys k0 .. k0 + 63 into bw (kQT, 2), one
// 4-byte cp.async each; zeros past Sq and Sk
template <bool kDropout, int kQT>
__device__ __forceinline__ void load_row_data_async(float* st, uint32_t* bw,
                                                    const Params<bf16>& p,
                                                    int tile, int q0,
                                                    int k0) {
  const long long row0 = static_cast<long long>(tile) * p.sq + q0;
  for (int i = threadIdx.x; i < 3 * kQT; i += kThreadsTc) {
    const int which = i / kQT, r = i - which * kQT;
    const bool in = q0 + r < p.sq;
    cp_async_4(st + i, in ? p.stats + (row0 + r) * 3 + which : p.stats, in);
  }
  if (!kDropout) return;
  const int words = (p.sk + 31) / 32;
  for (int i = threadIdx.x; i < 2 * kQT; i += kThreadsTc) {
    const int r = i >> 1, w = k0 / 32 + (i & 1);
    const bool in = q0 + r < p.sq && w < words;
    cp_async_4(bw + i, in ? p.bits + (row0 + r) * words + w : p.bits, in);
  }
}

template <bool kDropout, bool kScaleP, int kMaxDh, bool kExact,
          bool kDump = false>
__global__ void __launch_bounds__(kThreadsTc)
packed_attention_bwd_dkdv_mma_kernel(Params<bf16> p) {
  constexpr int kQT = kQTileOf<kMaxDh>;
  constexpr int kDSteps = kMaxDh / 16, kDTiles = kMaxDh / 8;
  constexpr int kQTiles = kQT / 8;  // n-tiles (queries) of s^T
  extern __shared__ float4 smem4[];
  const int dh = kExact ? kMaxDh : p.dh, sq = p.sq, sk = p.sk;
  const int ld = dh + kPad;
  bf16* k_s = reinterpret_cast<bf16*>(smem4);
  bf16* v_s = k_s + kRows * ld;
  bf16* qd_s = v_s + kRows * ld;  // stage i: q at 2 i kQT ld, then dO
  float* st_s = reinterpret_cast<float*>(qd_s + 4 * kQT * ld);  // 2 x 3 kQT
  uint32_t* bw_s = reinterpret_cast<uint32_t*>(st_s + 6 * kQT);  // 2 x 2 kQT

  const int k0 = blockIdx.x * kRows;
  const int h = blockIdx.y, b = blockIdx.z;
  const int tile = b * gridDim.y + h;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int q_offset = sk - sq;
  const bf16* qb = p.q + b * p.q_sb + h * p.q_sh;
  const bf16* dob = p.dout + b * p.do_sb + h * p.do_sh;
  const uint8_t* mb =
      p.kv_mask == nullptr ? nullptr : p.kv_mask + static_cast<long long>(b) * sk;
  const int kn = min(kRows, sk - k0);
  const int n_tiles = (sq + kQT - 1) / kQT;
  const bool busy = 16 * warp < kn;  // warp-uniform: a key below Sk
  // the lane's keys, k0 + 16 w + g + 8 half
  bool key_in[2], key_ok[2];
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int kj = k0 + 16 * warp + g + 8 * half;
    key_in[half] = kj < sk;
    key_ok[half] = key_in[half] && (mb == nullptr || mb[kj] != 0);
  }

  load_rows_async<kRows>(k_s, ld, p.k + b * p.k_sb + h * p.k_sh, p.k_ss, k0,
                         kn, dh);
  load_rows_async<kRows>(v_s, ld, p.v + b * p.v_sb + h * p.v_sh, p.v_ss, k0,
                         kn, dh);
  load_rows_async<kQT>(qd_s, ld, qb, p.q_ss, 0, min(kQT, sq), dh);
  load_rows_async<kQT>(qd_s + kQT * ld, ld, dob, p.do_ss, 0, min(kQT, sq),
                       dh);
  load_row_data_async<kDropout, kQT>(st_s, bw_s, p, tile, 0, k0);
  cp_async_commit();

  float dk_acc[kDTiles][4], dv_acc[kDTiles][4];
#pragma unroll
  for (int n = 0; n < kDTiles; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[n][e] = dv_acc[n][e] = 0.f;

  for (int it = 0; it < n_tiles; ++it) {
    const int q0 = it * kQT;
    if (it + 1 < n_tiles) {
      const int stage = (it + 1) & 1, nq = q0 + kQT;
      bf16* next = qd_s + stage * 2 * kQT * ld;
      load_rows_async<kQT>(next, ld, qb, p.q_ss, nq, min(kQT, sq - nq), dh);
      load_rows_async<kQT>(next + kQT * ld, ld, dob, p.do_ss, nq,
                           min(kQT, sq - nq), dh);
      load_row_data_async<kDropout, kQT>(st_s + stage * 3 * kQT,
                                         bw_s + stage * 2 * kQT, p, tile, nq,
                                         k0);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const float* st = st_s + (it & 1) * 3 * kQT;
    const uint32_t* bw = bw_s + (it & 1) * 2 * kQT;
    const bf16* q_s = qd_s + (it & 1) * 2 * kQT * ld;
    const bf16* do_s = q_s + kQT * ld;

    if (busy) {
      // s^T = k q^T, dp^T = v dO^T: key rows, queries 8 j + 2 t + e
      float s[kQTiles][4], dp[kQTiles][4];
#pragma unroll
      for (int j = 0; j < kQTiles; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
      for (int ds = 0; ds < kDSteps; ++ds)
        if (16 * ds < dh) {
          uint32_t ka[4], va[4];
          flash::load_a_frag(ka, k_s, ld, warp, ds, lane);
          flash::load_a_frag(va, v_s, ld, warp, ds, lane);
#pragma unroll
          for (int j = 0; j < kQTiles; j += 2) {
            uint32_t bb[4];
            flash::load_b_pair(bb, q_s, ld, j, ds, lane);
            mma_16816(s[j], ka, bb[0], bb[1]);
            mma_16816(s[j + 1], ka, bb[2], bb[3]);
            flash::load_b_pair(bb, do_s, ld, j, ds, lane);
            mma_16816(dp[j], va, bb[0], bb[1]);
            mma_16816(dp[j + 1], va, bb[2], bb[3]);
          }
        }

      if constexpr (kDump) {
#pragma unroll
        for (int j = 0; j < kQTiles; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e)
#pragma unroll
            for (int half = 0; half < 2; ++half) {
              const int qi = q0 + 8 * j + 2 * t + e;
              if (qi < sq && key_in[half])
                dump(p, 1, tile, qi, k0 + 16 * warp + g + 8 * half,
                     s[j][2 * half + e]);
            }
      }
      // pd^T into s, ds^T into dp; a tile whose every (query, key) pair of
      // the warp is in range and attended skips the masking
      auto to_grads = [&](auto whole_tile) {
        constexpr bool kWhole = decltype(whole_tile)::value;
#pragma unroll
        for (int j = 0; j < kQTiles; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int rr = 8 * j + 2 * t + e, qi = q0 + rr;
            const float mx = st[rr], inv_l = st[kQT + rr],
                        r = st[2 * kQT + rr];
            const uint32_t word = kDropout ? bw[2 * rr + (warp >> 1)] : 0u;
#pragma unroll
            for (int half = 0; half < 2; ++half) {
              const int kj = k0 + 16 * warp + g + 8 * half;
              const bool valid = kWhole || (key_ok[half] &&
                                            !(p.causal && kj > qi + q_offset));
              const bool in = kWhole || (qi < sq && key_in[half]);
              float pd = 0.f, dsv = 0.f;
              if (in) {
                const float sc =
                    valid ? s[j][2 * half + e] * p.scale : kMaskValue;
                const float pr = expf(sc - mx) * inv_l;
                if constexpr (kDump)
                  if (valid) dump(p, 3, tile, qi, kj, pr);
                const bool kept =
                    !kDropout ||
                    ((word >> (16 * (warp & 1) + g + 8 * half)) & 1u) != 0u;
                pd = kept ? (kScaleP ? pr * p.inv : pr) : 0.f;
                dsv = valid ? pr * (kept_dp<kDropout, kScaleP>(
                                        p, kept, dp[j][2 * half + e]) -
                                    r)
                            : 0.f;
              }
              s[j][2 * half + e] = pd;
              dp[j][2 * half + e] = dsv;
            }
          }
      };
      const bool whole = __all_sync(
          0xffffffffu, key_ok[0] && key_ok[1] && q0 + kQT <= sq &&
                           !(p.causal && k0 + 16 * warp + 15 > q0 + q_offset));
      if (whole)
        to_grads(std::true_type());
      else
        to_grads(std::false_type());

      // dv += pd^T dO, dk += ds^T q; pd and ds rounded to bf16
#pragma unroll
      for (int kk = 0; kk < kQT / 16; ++kk) {
        uint32_t ap[4], as[4];
        ap[0] = pack_bf16x2(s[2 * kk][0], s[2 * kk][1]);
        ap[1] = pack_bf16x2(s[2 * kk][2], s[2 * kk][3]);
        ap[2] = pack_bf16x2(s[2 * kk + 1][0], s[2 * kk + 1][1]);
        ap[3] = pack_bf16x2(s[2 * kk + 1][2], s[2 * kk + 1][3]);
        as[0] = pack_bf16x2(dp[2 * kk][0], dp[2 * kk][1]);
        as[1] = pack_bf16x2(dp[2 * kk][2], dp[2 * kk][3]);
        as[2] = pack_bf16x2(dp[2 * kk + 1][0], dp[2 * kk + 1][1]);
        as[3] = pack_bf16x2(dp[2 * kk + 1][2], dp[2 * kk + 1][3]);
#pragma unroll
        for (int n = 0; n < kDTiles; n += 2)
          if (8 * n < dh) {
            uint32_t bb[4];
            flash::load_b_pair_trans(bb, do_s, ld, kk, n, lane);
            mma_16816(dv_acc[n], ap, bb[0], bb[1]);
            mma_16816(dv_acc[n + 1], ap, bb[2], bb[3]);
            flash::load_b_pair_trans(bb, q_s, ld, kk, n, lane);
            mma_16816(dk_acc[n], as, bb[0], bb[1]);
            mma_16816(dk_acc[n + 1], as, bb[2], bb[3]);
          }
      }
    }
    __syncthreads();  // this stage is consumed
  }

  if (!busy) return;
  const float fk = kScaleP ? p.scale : p.scale * p.inv;
  const float fv = kScaleP ? 1.f : p.inv;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    if (!key_in[half]) continue;
    const int kj = k0 + 16 * warp + g + 8 * half;
    bf16* dkb = p.dk + b * p.dk_sb + h * p.dk_sh + kj * p.dk_ss;
    bf16* dvb = p.dv + b * p.dv_sb + h * p.dv_sh + kj * p.dv_ss;
#pragma unroll
    for (int n = 0; n < kDTiles; ++n)
      if (8 * n < dh) {
        const int d = 8 * n + 2 * t;
        *reinterpret_cast<uint32_t*>(dkb + d) = pack_bf16x2(
            dk_acc[n][2 * half] * fk, dk_acc[n][2 * half + 1] * fk);
        *reinterpret_cast<uint32_t*>(dvb + d) = pack_bf16x2(
            dv_acc[n][2 * half] * fv, dv_acc[n][2 * half + 1] * fv);
      }
  }
}

template <bool kDropout, bool kScaleP, int kMaxDh, bool kExact,
          bool kDump = false>
cudaError_t launch(int phase, const Params<bf16>& p, cudaStream_t stream) {
  const size_t smem = phase == 0 ? smem_bytes_dq(p.dh)
                                 : smem_bytes_dkdv(p.dh, kQTileOf<kMaxDh>);
  auto kernel =
      phase == 0
          ? packed_attention_bwd_dq_mma_kernel<kDropout, kScaleP, kMaxDh,
                                               kExact, kDump>
          : packed_attention_bwd_dkdv_mma_kernel<kDropout, kScaleP, kMaxDh,
                                                 kExact, kDump>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const int tiles = ((phase == 0 ? p.sq : p.sk) + kRows - 1) / kRows;
  kernel<<<dim3(tiles, p.h, p.b), kThreadsTc, smem, stream>>>(p);
  return cudaGetLastError();
}

// Dh 64 and 128 exact; other multiples of 16 below 128 take the general
// Dh <= 128 kernels
template <bool kDropout, bool kScaleP>
cudaError_t dispatch_dh(int phase, const Params<bf16>& p,
                        cudaStream_t stream) {
  if (p.dh == 64) return launch<kDropout, kScaleP, 64, true>(phase, p, stream);
  if (p.dh == 128)
    return launch<kDropout, kScaleP, 128, true>(phase, p, stream);
  return launch<kDropout, kScaleP, 128, false>(phase, p, stream);
}

template <bool kScaleP>
cudaError_t dispatch(int phase, const Params<bf16>& p, cudaStream_t stream) {
  return p.threshold != 0u ? dispatch_dh<true, kScaleP>(phase, p, stream)
                           : dispatch_dh<false, kScaleP>(phase, p, stream);
}

}  // namespace tc

// dtype: 0 = float32, 1 = bfloat16; design: 0 = CUDA cores (any shape),
// 1 = tensor cores (bf16 where tc_fits holds for q, k, v, dO, dq, dk, dv
// and their 21 strides, Sq, Sk <= tc::kMaxSeq, and a bits scratch with
// dropout; refused otherwise); phase 0 = dq and the row statistics, 1 = dk
// and dv (reads the statistics; launch after phase 0 of the same design on
// one stream).  st: the batch, head and row strides of q, k, v, dO, dq, dk,
// dv in that order.  Dropout when threshold != 0.
template <bool kScaleP>
cudaError_t dispatch(int dtype, int design, int phase, const void* q,
                     const void* k, const void* v, const void* kv_mask,
                     const void* dout, void* dq, void* dk, void* dv,
                     void* stats, void* bits, int b, int sq, int sk, int h,
                     int dh, const long long (&st)[21], float scale,
                     int causal, float inv, unsigned int threshold,
                     unsigned long long seed, int head_base, int heads_total,
                     cudaStream_t stream) {
  if (dh > 128 || dh < 1 || (phase != 0 && phase != 1) ||
      (design != 0 && design != 1))
    return cudaErrorInvalidValue;
  if (design == 1) {
    const void* ptrs[7] = {q, k, v, dout, dq, dk, dv};
    if (dtype != 1 || sq > tc::kMaxSeq || sk > tc::kMaxSeq ||
        !flash::tc_fits(dh, ptrs, 7, st, 21) ||
        (threshold != 0u && bits == nullptr))
      return cudaErrorInvalidValue;
    return tc::dispatch<kScaleP>(
        phase,
        make_params<__nv_bfloat16>(q, k, v, kv_mask, dout, dq, dk, dv, stats,
                                   bits, b, sq, sk, h, dh, st, scale, causal,
                                   inv, threshold, seed, head_base,
                                   heads_total),
        stream);
  }
  if (dtype == 0)
    return launch_for<float, kScaleP>(
        phase,
        make_params<float>(q, k, v, kv_mask, dout, dq, dk, dv, stats, bits,
                           b, sq, sk, h, dh, st, scale, causal, inv,
                           threshold, seed, head_base, heads_total),
        stream);
  if (dtype == 1)
    return launch_for<__nv_bfloat16, kScaleP>(
        phase,
        make_params<__nv_bfloat16>(q, k, v, kv_mask, dout, dq, dk, dv, stats,
                                   bits, b, sq, sk, h, dh, st, scale, causal,
                                   inv, threshold, seed, head_base,
                                   heads_total),
        stream);
  return cudaErrorInvalidValue;
}

#ifdef M3P_SCORE_DUMP
// The debug instantiation: the tensor-core design at Dh 64 without
// dropout, each phase writing what it computes to ``scores`` (Params); built
// only with -DM3P_SCORE_DUMP, which no model path's library has.
template <bool kScaleP>
cudaError_t dump_scores(int phase, const void* q, const void* k,
                        const void* v, const void* kv_mask, const void* dout,
                        void* dq, void* dk, void* dv, void* stats, int b,
                        int sq, int sk, int h, int dh,
                        const long long (&st)[21], float scale, int causal,
                        float* scores, cudaStream_t stream) {
  const void* ptrs[7] = {q, k, v, dout, dq, dk, dv};
  if (dh != 64 || (phase != 0 && phase != 1) || sq > tc::kMaxSeq ||
      sk > tc::kMaxSeq || !flash::tc_fits(dh, ptrs, 7, st, 21) ||
      scores == nullptr)
    return cudaErrorInvalidValue;
  Params<__nv_bfloat16> p = make_params<__nv_bfloat16>(
      q, k, v, kv_mask, dout, dq, dk, dv, stats, nullptr, b, sq, sk, h, dh,
      st, scale, causal, 1.f, 0u, 0ull, 0, h);
  p.scores = scores;
  return tc::launch<false, kScaleP, 64, true, true>(phase, p, stream);
}
#endif

}  // namespace tile_bwd
}  // namespace m3p
