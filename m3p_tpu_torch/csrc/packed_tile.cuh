// Single-tile attention forward per (batch, head), sm_90a, shared by the
// packed-layout kernel (packed_attention.cu, #1) and the head-major one
// (small_attention.cu, #3).
//
//     o = softmax(scale * q k^T  masked by kv_mask and, if causal, by the
//                 end-aligned triangle ki <= qi + (Sk - Sq)) . v
//
// The two layouts differ only in their strides: head h of batch b starts at
// b * batch_stride + h * head_stride, and its rows lie row_stride apart.
// The packed layout (B, S, H*Dh) has head stride Dh and row stride H*Dh; the
// head-major layout (B, H, S, Dh) has head stride S*Dh and row stride Dh.
//
// With attention-weight dropout (a threshold > 0), p loses the entries that
// the Philox keep mask of tile b * H + h drops (philox.cuh) before P.V, and
// is scaled by inv = 1 / (1 - rate) in one of two places: kScaleP scales p
// in fp32 before it is rounded to the input type, as the Pallas
// _small_fwd_kernel does (#3); otherwise the output is scaled in the
// epilogue, as _packed_fwd_kernel does (#1).  Dropout is a template
// parameter: at rate 0 the kernel compiles to the same code as without it.
//
// No (B, H, Sq, Sk) tensor reaches device memory.  Masked scores take the
// finite value -0.7 * FLT_MAX, as mha_reference does, so a row without any
// valid key gives the mean of v over Sk and never NaN.
//
// The design is the simple one that is right: one block per (32-query
// tile, head, batch); K and then V pass through shared memory in 64-key
// tiles (fp32 at Sk = 512, Dh = 128 needs 115 KB); each warp owns four
// query rows, keeps their Sk scores in shared memory and runs an exact
// single-pass max/exp/sum softmax (Sk <= 512 needs no online rescaling)
// before P.V with the accumulators in registers.  The probabilities are
// rounded to the input type before P.V, as the Pallas kernels do.
// Tensor-core mma/wgmma and TMA are left for later work.

#pragma once

#include <cfloat>
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "philox.cuh"

namespace m3p {
namespace tile_fwd {

constexpr int kWarps = 8;
constexpr int kRowsPerWarp = 4;
constexpr int kQTile = kWarps * kRowsPerWarp;
constexpr int kKTile = 64;
constexpr int kMaxDh = 128;
constexpr int kDPerLane = kMaxDh / 32;
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

// Strides are in elements: batch (sb), head (sh) and row (ss) of each of
// q, k, v and o; the last dimension is contiguous.
struct Args {
  const void* q;
  const void* k;
  const void* v;
  const uint8_t* kv_mask;  // (B, Sk), 1 = attend, or null
  void* o;
  int b, sq, sk, h, dh;
  long long q_sb, q_sh, q_ss, k_sb, k_sh, k_ss;
  long long v_sb, v_sh, v_ss, o_sb, o_sh, o_ss;
  float scale;
  int causal;
  float inv;
  uint32_t threshold;
  unsigned long long seed;
};

inline size_t smem_bytes(int sk, int dh) {
  const size_t ld = static_cast<size_t>(dh) + 1;
  return sizeof(float) *
         (kQTile * ld + kKTile * ld + static_cast<size_t>(kQTile) * sk);
}

template <typename T, bool kDropout, bool kScaleP>
__global__ void __launch_bounds__(kWarps * 32)
packed_attention_fwd_kernel(Args a) {
  extern __shared__ float smem[];
  const int sq = a.sq, sk = a.sk, dh = a.dh;
  const int ld = dh + 1;  // odd row pitch: lanes reading one column of
                          // different rows fall into different banks
  float* q_s = smem;                 // (kQTile, ld)
  float* kv_s = q_s + kQTile * ld;   // (kKTile, ld)
  float* p_s = kv_s + kKTile * ld;   // (kQTile, sk)

  const int q0 = blockIdx.x * kQTile;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int q_offset = sk - sq;

  const T* qb = static_cast<const T*>(a.q) + b * a.q_sb + h * a.q_sh;
  const T* kb = static_cast<const T*>(a.k) + b * a.k_sb + h * a.k_sh;
  const T* vb = static_cast<const T*>(a.v) + b * a.v_sb + h * a.v_sh;
  T* ob = static_cast<T*>(a.o) + b * a.o_sb + h * a.o_sh;
  const uint8_t* mb = a.kv_mask == nullptr
                          ? nullptr
                          : a.kv_mask + static_cast<long long>(b) * sk;

  for (int i = tid; i < kQTile * dh; i += blockDim.x) {
    const int r = i / dh, d = i - r * dh;
    const int qi = q0 + r;
    q_s[r * ld + d] = qi < sq ? to_f(qb[qi * a.q_ss + d]) : 0.f;
  }

  // scores: p_s[r][j] = scale * q_r . k_j, or the mask value
  for (int k0 = 0; k0 < sk; k0 += kKTile) {
    const int kn = min(kKTile, sk - k0);
    __syncthreads();
    for (int i = tid; i < kn * dh; i += blockDim.x) {
      const int j = i / dh, d = i - j * dh;
      kv_s[j * ld + d] = to_f(kb[(k0 + j) * a.k_ss + d]);
    }
    __syncthreads();
    for (int rr = 0; rr < kRowsPerWarp; ++rr) {
      const int r = warp * kRowsPerWarp + rr;
      const int qi = q0 + r;
      if (qi >= sq) break;
      const float* qrow = q_s + r * ld;
      for (int j = lane; j < kn; j += 32) {
        const float* krow = kv_s + j * ld;
        float acc = 0.f;
        for (int d = 0; d < dh; ++d) acc = fmaf(qrow[d], krow[d], acc);
        const int kj = k0 + j;
        bool keep = mb == nullptr || mb[kj] != 0;
        if (a.causal && kj > qi + q_offset) keep = false;
        p_s[r * sk + kj] = keep ? acc * a.scale : kMaskValue;
      }
    }
  }
  __syncwarp();

  // exact softmax over each row, in place; rows belong to one warp
  for (int rr = 0; rr < kRowsPerWarp; ++rr) {
    const int r = warp * kRowsPerWarp + rr;
    if (q0 + r >= sq) break;
    float* prow = p_s + r * sk;
    float m = -FLT_MAX;
    for (int j = lane; j < sk; j += 32) m = fmaxf(m, prow[j]);
    m = warp_max(m);
    float sum = 0.f;
    for (int j = lane; j < sk; j += 32) {
      const float e = expf(prow[j] - m);
      prow[j] = e;
      sum += e;
    }
    sum = warp_sum(sum);
    if (kDropout) {
      // a lane owns the four columns of one Philox counter
      const int tile = b * gridDim.y + h;
      for (int j4 = lane; 4 * j4 < sk; j4 += 32) {
        const uint4 bits = keep_bits(a.seed, tile, q0 + r, j4);
#pragma unroll
        for (int w = 0; w < 4; ++w) {
          const int j = 4 * j4 + w;
          if (j < sk) {
            const float p = kScaleP ? prow[j] / sum * a.inv : prow[j] / sum;
            prow[j] = word(bits, w) >= a.threshold ? to_f(from_f<T>(p)) : 0.f;
          }
        }
      }
    } else {
      for (int j = lane; j < sk; j += 32)
        prow[j] = to_f(from_f<T>(prow[j] / sum));
    }
  }
  __syncwarp();

  // o_r = sum_j p[r][j] v_j; lane owns columns lane + 32 c
  float acc[kRowsPerWarp][kDPerLane];
#pragma unroll
  for (int rr = 0; rr < kRowsPerWarp; ++rr)
#pragma unroll
    for (int c = 0; c < kDPerLane; ++c) acc[rr][c] = 0.f;
  const int r0 = warp * kRowsPerWarp;
  const int rows = max(0, min(kRowsPerWarp, sq - (q0 + r0)));
  for (int k0 = 0; k0 < sk; k0 += kKTile) {
    const int kn = min(kKTile, sk - k0);
    __syncthreads();
    for (int i = tid; i < kn * dh; i += blockDim.x) {
      const int j = i / dh, d = i - j * dh;
      kv_s[j * ld + d] = to_f(vb[(k0 + j) * a.v_ss + d]);
    }
    __syncthreads();
    if (rows == 0) continue;
    for (int j = 0; j < kn; ++j) {
      const float* vrow = kv_s + j * ld;
      float vv[kDPerLane];
#pragma unroll
      for (int c = 0; c < kDPerLane; ++c) {
        const int d = lane + 32 * c;
        vv[c] = d < dh ? vrow[d] : 0.f;
      }
#pragma unroll
      for (int rr = 0; rr < kRowsPerWarp; ++rr) {
        if (rr >= rows) break;
        const float p = p_s[(r0 + rr) * sk + k0 + j];
#pragma unroll
        for (int c = 0; c < kDPerLane; ++c)
          acc[rr][c] = fmaf(p, vv[c], acc[rr][c]);
      }
    }
  }

#pragma unroll
  for (int rr = 0; rr < kRowsPerWarp; ++rr) {
    if (rr >= rows) break;
    const int qi = q0 + r0 + rr;
#pragma unroll
    for (int c = 0; c < kDPerLane; ++c) {
      const int d = lane + 32 * c;
      if (d < dh)
        ob[qi * a.o_ss + d] = from_f<T>(kDropout && !kScaleP
                                            ? acc[rr][c] * a.inv
                                            : acc[rr][c]);
    }
  }
}

template <typename T, bool kDropout, bool kScaleP>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  const size_t smem = smem_bytes(a.sk, a.dh);
  auto kernel = packed_attention_fwd_kernel<T, kDropout, kScaleP>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((a.sq + kQTile - 1) / kQTile, a.h, a.b);
  kernel<<<grid, kWarps * 32, smem, stream>>>(a);
  return cudaGetLastError();
}

// dtype: 0 = float32, 1 = bfloat16; dropout when a.threshold != 0
template <bool kScaleP>
cudaError_t dispatch(int dtype, const Args& a, cudaStream_t stream) {
  const bool dropout = a.threshold != 0u;
  if (dtype == 0)
    return dropout ? launch<float, true, kScaleP>(a, stream)
                   : launch<float, false, kScaleP>(a, stream);
  if (dtype == 1)
    return dropout ? launch<__nv_bfloat16, true, kScaleP>(a, stream)
                   : launch<__nv_bfloat16, false, kScaleP>(a, stream);
  return cudaErrorInvalidValue;
}

}  // namespace tile_fwd
}  // namespace m3p
