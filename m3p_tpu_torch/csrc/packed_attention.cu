// Packed-layout attention forward for Hopper (sm_90a).
//
// Replaces m3p_tpu/ops/attention.py::_packed_fwd_kernel (reached through
// small_attention_packed).  Per head h, a column slice h*Dh:(h+1)*Dh of the
// (B, S, H*Dh) projections:
//
//     o = softmax(scale * q k^T  masked by kv_mask and, if causal, by the
//                 end-aligned triangle ki <= qi + (Sk - Sq)) . v
//
// With attention-weight dropout (a threshold > 0), p loses the entries that
// the Philox keep mask of tile b * H + h drops (philox.cuh) before P.V, and
// the output is scaled by inv = 1 / (1 - rate) in the epilogue, as the
// Pallas kernel does.  Dropout is a template parameter: at rate 0 the
// kernel compiles to the same code as without it.
//
// q/k/v are read in the projection layout through the row and batch strides
// passed in, and o is written in the same layout: no head transpose and no
// (B, H, Sq, Sk) tensor in device memory.  Masked scores take the finite
// value -0.7 * FLT_MAX, as mha_reference does, so a row without any valid
// key gives the mean of v over Sk and never NaN.
//
// Bound: device memory.  At the serving shapes (B = 64, Sq = Sk = 164,
// H*Dh = 768, bf16) q, k, v and o are 64.5 MB, 19.3 us at 3.35 TB/s, against
// 5.3 GFLOP, 5.3 us at 989 TF/s; the refiner (S = 100) moves 39.3 MB,
// 11.7 us.  The design is the simple one that is right: one block per
// (32-query tile, head, batch); K and then V pass through shared memory in
// 64-key tiles (fp32 at Sk = 512, Dh = 128 needs 115 KB); each warp owns four
// query rows, keeps their Sk scores in shared memory and runs an exact
// single-pass max/exp/sum softmax (Sk <= 512 needs no online rescaling)
// before P.V with the accumulators in registers.  The probabilities are
// rounded to the input type before P.V, as the Pallas kernel does.
// Tensor-core mma/wgmma and TMA are left for later work.

#include <cfloat>
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "philox.cuh"

namespace {

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

size_t smem_bytes(int sk, int dh) {
  const size_t ld = static_cast<size_t>(dh) + 1;
  return sizeof(float) *
         (kQTile * ld + kKTile * ld + static_cast<size_t>(kQTile) * sk);
}

template <typename T, bool kDropout>
__global__ void __launch_bounds__(kWarps * 32)
packed_attention_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                            const T* __restrict__ v,
                            const uint8_t* __restrict__ kv_mask,
                            T* __restrict__ o, int sq, int sk, int dh,
                            long long q_sb, long long q_ss, long long k_sb,
                            long long k_ss, long long v_sb, long long v_ss,
                            long long o_sb, long long o_ss, float scale,
                            int causal, float inv, uint32_t threshold,
                            unsigned long long seed) {
  extern __shared__ float smem[];
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

  const T* qb = q + b * q_sb + static_cast<long long>(h) * dh;
  const T* kb = k + b * k_sb + static_cast<long long>(h) * dh;
  const T* vb = v + b * v_sb + static_cast<long long>(h) * dh;
  T* ob = o + b * o_sb + static_cast<long long>(h) * dh;
  const uint8_t* mb =
      kv_mask == nullptr ? nullptr : kv_mask + static_cast<long long>(b) * sk;

  for (int i = tid; i < kQTile * dh; i += blockDim.x) {
    const int r = i / dh, d = i - r * dh;
    const int qi = q0 + r;
    q_s[r * ld + d] = qi < sq ? to_f(qb[qi * q_ss + d]) : 0.f;
  }

  // scores: p_s[r][j] = scale * q_r . k_j, or the mask value
  for (int k0 = 0; k0 < sk; k0 += kKTile) {
    const int kn = min(kKTile, sk - k0);
    __syncthreads();
    for (int i = tid; i < kn * dh; i += blockDim.x) {
      const int j = i / dh, d = i - j * dh;
      kv_s[j * ld + d] = to_f(kb[(k0 + j) * k_ss + d]);
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
        if (causal && kj > qi + q_offset) keep = false;
        p_s[r * sk + kj] = keep ? acc * scale : kMaskValue;
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
        const uint4 bits = m3p::keep_bits(seed, tile, q0 + r, j4);
#pragma unroll
        for (int w = 0; w < 4; ++w) {
          const int j = 4 * j4 + w;
          if (j < sk)
            prow[j] = m3p::word(bits, w) >= threshold
                          ? to_f(from_f<T>(prow[j] / sum))
                          : 0.f;
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
      kv_s[j * ld + d] = to_f(vb[(k0 + j) * v_ss + d]);
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
        ob[qi * o_ss + d] = from_f<T>(kDropout ? acc[rr][c] * inv : acc[rr][c]);
    }
  }
}

template <typename T, bool kDropout>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* kv_mask, void* o, int b, int sq, int sk, int h,
                   int dh, long long q_sb, long long q_ss, long long k_sb,
                   long long k_ss, long long v_sb, long long v_ss,
                   long long o_sb, long long o_ss, float scale, int causal,
                   float inv, uint32_t threshold, unsigned long long seed,
                   cudaStream_t stream) {
  const size_t smem = smem_bytes(sk, dh);
  cudaError_t err = cudaFuncSetAttribute(
      packed_attention_fwd_kernel<T, kDropout>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((sq + kQTile - 1) / kQTile, h, b);
  packed_attention_fwd_kernel<T, kDropout>
      <<<grid, kWarps * 32, smem, stream>>>(
          static_cast<const T*>(q), static_cast<const T*>(k),
          static_cast<const T*>(v), static_cast<const uint8_t*>(kv_mask),
          static_cast<T*>(o), sq, sk, dh, q_sb, q_ss, k_sb, k_ss, v_sb, v_ss,
          o_sb, o_ss, scale, causal, inv, threshold, seed);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* q, const void* k, const void* v,
                     const void* kv_mask, void* o, int b, int sq, int sk,
                     int h, int dh, long long q_sb, long long q_ss,
                     long long k_sb, long long k_ss, long long v_sb,
                     long long v_ss, long long o_sb, long long o_ss,
                     float scale, int causal, float inv, uint32_t threshold,
                     unsigned long long seed, cudaStream_t stream) {
  if (threshold == 0u)
    return launch<T, false>(q, k, v, kv_mask, o, b, sq, sk, h, dh, q_sb,
                            q_ss, k_sb, k_ss, v_sb, v_ss, o_sb, o_ss, scale,
                            causal, inv, threshold, seed, stream);
  return launch<T, true>(q, k, v, kv_mask, o, b, sq, sk, h, dh, q_sb, q_ss,
                         k_sb, k_ss, v_sb, v_ss, o_sb, o_ss, scale, causal,
                         inv, threshold, seed, stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  kv_mask: (B, Sk) bytes, 1 = attend, or
// null.  Strides are in elements; the last dimension is contiguous.
// Dropout: threshold 0 = off; otherwise a weight is kept when its Philox
// word under `seed` is >= threshold, and inv = 1 / (1 - rate).
// Returns the cudaError_t of the launch (0 on success).
extern "C" int m3p_packed_attention_fwd(
    int dtype, const void* q, const void* k, const void* v,
    const void* kv_mask, void* o, int b, int sq, int sk, int h, int dh,
    long long q_sb, long long q_ss, long long k_sb, long long k_ss,
    long long v_sb, long long v_ss, long long o_sb, long long o_ss,
    float scale, int causal, float inv, unsigned int threshold,
    unsigned long long seed, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return static_cast<int>(dispatch<float>(
        q, k, v, kv_mask, o, b, sq, sk, h, dh, q_sb, q_ss, k_sb, k_ss, v_sb,
        v_ss, o_sb, o_ss, scale, causal, inv, threshold, seed, s));
  if (dtype == 1)
    return static_cast<int>(dispatch<__nv_bfloat16>(
        q, k, v, kv_mask, o, b, sq, sk, h, dh, q_sb, q_ss, k_sb, k_ss, v_sb,
        v_ss, o_sb, o_ss, scale, causal, inv, threshold, seed, s));
  return static_cast<int>(cudaErrorInvalidValue);
}
