// Flash-attention forward for Hopper (sm_90a), any sequence length.
//
// Replaces m3p_tpu/ops/attention.py::_flash_kernel (reached through
// flash_attention, the attention of every sequence longer than the packed
// kernels' 512).  Per head h, a column slice h*Dh:(h+1)*Dh of the
// (B, S, H*Dh) projections, read through the row and batch strides passed
// in (no head transpose):
//
//     o = softmax(scale * q k^T  masked by kv_mask and, if causal, by the
//                 end-aligned triangle kj <= qi + (Sk - Sq)) . v
//
// One block per (64-query tile, head, batch) walks the keys in 64-key tiles
// with the online softmax: running row max m and sum l of exp(s - m), the
// accumulator rescaled by exp(m_old - m_new) at each tile.  It writes o and
// the per-row (m, l) in fp32 to a (B, H, Sq, 2) array, which the backward
// reads.  Masked scores take the finite value -0.7 * FLT_MAX, as
// mha_reference does, so a row without any valid key averages v over Sk;
// keys past Sk in a ragged last tile are zero-filled and left out of m and
// l.  exp(s - m) is rounded to the input type before P.V, which sums in
// fp32.
//
// Dropout (threshold > 0, a template branch): the weights lose the entries
// the Philox keep mask of tile b * H + h drops at the global (row, col)
// (philox.cuh), after m and l are updated, and the output is scaled by
// inv = 1 / (1 - rate); the mask does not depend on the tile sizes, so it is
// the one the packed kernels and the plain version draw.
//
// Bound: at the long-context step (B = 8, S = 2048, H = 12, Dh = 64, bf16)
// q, k, v, o and the statistics are 102.3 MB, 0.031 ms at 3.35 TB/s, against
// 103.1 GFLOP, 0.104 ms at 989 TF/s: operations.  The design is the simple
// one that is right: the products run on CUDA cores out of shared memory,
// each thread holding a 4 x 4 register tile of scores and 4 rows x Dh/16
// columns of the accumulator.  Tensor-core mma/wgmma tiles and TMA are left
// for later work.

#include <cmath>

#include "flash_tile.cuh"

namespace {

using namespace m3p::flash;

constexpr int kWarps = kThreads / 32;
constexpr int kRowsPerWarp = kTile / kWarps;  // 8 rows of the softmax

template <typename T>
struct Params {
  const T* q;
  const T* k;
  const T* v;
  const uint8_t* kv_mask;  // (B, Sk), 1 = attend, or null
  T* o;
  float* stats;  // (B, H, Sq, 2): row max m, row sum l
  int b, sq, sk, h, dh;
  long long q_sb, q_ss, k_sb, k_ss, v_sb, v_ss, o_sb, o_ss;
  float scale;
  int causal;
  float inv;
  uint32_t threshold;
  unsigned long long seed;
};

size_t smem_bytes(int dh) {
  const size_t ld = static_cast<size_t>(dh) + 1;
  return sizeof(float) * (2 * kTile * ld + kTile * kPitch + 2 * kTile);
}

template <typename T, bool kDropout, int kMaxDh>
__global__ void __launch_bounds__(kThreads)
flash_attention_fwd_kernel(Params<T> p) {
  constexpr int kCols = kMaxDh / kSub;  // accumulator columns per thread
  extern __shared__ float smem[];
  const int dh = p.dh, sq = p.sq, sk = p.sk;
  const int ld = dh + 1;
  float* q_s = smem;                    // (kTile, ld)
  float* kv_s = q_s + kTile * ld;       // (kTile, ld): K, then V
  float* p_s = kv_s + kTile * ld;       // (kTile, kPitch): s, then p
  float* alpha_s = p_s + kTile * kPitch;  // (kTile): rescale of the tile
  float* l_s = alpha_s + kTile;         // (kTile): final row sums

  const int q0 = blockIdx.x * kTile;
  const int h = blockIdx.y, b = blockIdx.z;
  const int tile = b * gridDim.y + h;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int tx = tid % kSub, ty = tid / kSub;
  const int q_offset = sk - sq;
  const int rows = min(kTile, sq - q0);
  const long long hoff = static_cast<long long>(h) * dh;
  const T* kb = p.k + b * p.k_sb + hoff;
  const T* vb = p.v + b * p.v_sb + hoff;
  const uint8_t* mb =
      p.kv_mask == nullptr ? nullptr : p.kv_mask + static_cast<long long>(b) * sk;

  load_rows(q_s, p.q + b * p.q_sb + hoff, p.q_ss, q0, rows, dh, ld);

  float acc[kPer][kCols];
#pragma unroll
  for (int i = 0; i < kPer; ++i)
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[i][c] = 0.f;
  // running statistics of the warp's rows, the same in every lane
  float m_run[kRowsPerWarp], l_run[kRowsPerWarp];
#pragma unroll
  for (int rr = 0; rr < kRowsPerWarp; ++rr) {
    m_run[rr] = -INFINITY;
    l_run[rr] = 0.f;
  }

  for (int k0 = 0; k0 < sk; k0 += kTile) {
    const int kn = min(kTile, sk - k0);
    __syncthreads();  // the previous tile's V and p are consumed
    load_rows(kv_s, kb, p.k_ss, k0, kn, dh, ld);
    __syncthreads();
    float s[kPer][kPer];
    tile_dots(q_s, kv_s, ld, dh, s);
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int r = ty + kSub * i;
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        const int c = tx + kSub * j;
        float val = -INFINITY;  // past Sk: no weight at all
        if (c < kn)
          val = attends(mb, p.causal, k0 + c, q0 + r, q_offset)
                    ? s[i][j] * p.scale
                    : kMaskValue;
        p_s[r * kPitch + c] = val;
      }
    }
    __syncthreads();
    load_rows(kv_s, vb, p.v_ss, k0, kn, dh, ld);

    // online softmax: warp w owns rows 8 w .. 8 w + 7, a lane the columns
    // 2 lane and 2 lane + 1
#pragma unroll
    for (int rr = 0; rr < kRowsPerWarp; ++rr) {
      const int r = warp * kRowsPerWarp + rr;
      float* prow = p_s + r * kPitch;
      const float x0 = prow[2 * lane], x1 = prow[2 * lane + 1];
      const float m_new = fmaxf(m_run[rr], warp_max(fmaxf(x0, x1)));
      const float alpha = expf(m_run[rr] - m_new);
      float e0 = expf(x0 - m_new), e1 = expf(x1 - m_new);
      l_run[rr] = alpha * l_run[rr] + warp_sum(e0 + e1);
      m_run[rr] = m_new;
      if (kDropout) {
        // two lanes share the Philox counter of four columns
        const uint4 bits =
            m3p::keep_bits(p.seed, tile, q0 + r, k0 / 4 + (lane >> 1));
        const int w = 2 * (lane & 1);
        if (m3p::word(bits, w) < p.threshold) e0 = 0.f;
        if (m3p::word(bits, w + 1) < p.threshold) e1 = 0.f;
      }
      prow[2 * lane] = rounded<T>(e0);
      prow[2 * lane + 1] = rounded<T>(e1);
      if (lane == 0) alpha_s[r] = alpha;
    }
    __syncthreads();

    // acc = alpha acc + p V; thread rows ty + 16 i, columns tx + 16 c
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const float a = alpha_s[ty + kSub * i];
#pragma unroll
      for (int c = 0; c < kCols; ++c) acc[i][c] *= a;
    }
    for (int j = 0; j < kn; ++j) {
      float pv[kPer], vv[kCols];
#pragma unroll
      for (int i = 0; i < kPer; ++i) pv[i] = p_s[(ty + kSub * i) * kPitch + j];
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const int d = tx + kSub * c;
        vv[c] = d < dh ? kv_s[j * ld + d] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < kPer; ++i)
#pragma unroll
        for (int c = 0; c < kCols; ++c) acc[i][c] = fmaf(pv[i], vv[c], acc[i][c]);
    }
  }

  // statistics out; o = inv * acc / l
  float* stats = p.stats + (static_cast<long long>(tile) * sq + q0) * 2;
  if (lane == 0) {
#pragma unroll
    for (int rr = 0; rr < kRowsPerWarp; ++rr) {
      const int r = warp * kRowsPerWarp + rr;
      l_s[r] = l_run[rr];
      if (r < rows) {
        stats[r * 2 + 0] = m_run[rr];
        stats[r * 2 + 1] = l_run[rr];
      }
    }
  }
  __syncthreads();
  T* ob = p.o + b * p.o_sb + hoff;
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int r = ty + kSub * i;
    if (r >= rows) continue;
    const float f = p.inv / l_s[r];
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      const int d = tx + kSub * c;
      if (d < dh) ob[(q0 + r) * p.o_ss + d] = from_f<T>(acc[i][c] * f);
    }
  }
}

template <typename T, bool kDropout, int kMaxDh>
cudaError_t launch(const Params<T>& p, cudaStream_t stream) {
  const size_t smem = smem_bytes(p.dh);
  auto kernel = flash_attention_fwd_kernel<T, kDropout, kMaxDh>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kernel<<<dim3((p.sq + kTile - 1) / kTile, p.h, p.b), kThreads, smem,
           stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const Params<T>& p, cudaStream_t stream) {
  const bool dropout = p.threshold != 0u;
  if (p.dh <= 64)
    return dropout ? launch<T, true, 64>(p, stream)
                   : launch<T, false, 64>(p, stream);
  return dropout ? launch<T, true, 128>(p, stream)
                 : launch<T, false, 128>(p, stream);
}

template <typename T>
cudaError_t run(const void* q, const void* k, const void* v,
                const void* kv_mask, void* o, void* stats, int b, int sq,
                int sk, int h, int dh, const long long* strides, float scale,
                int causal, float inv, unsigned int threshold,
                unsigned long long seed, cudaStream_t stream) {
  Params<T> p;
  p.q = static_cast<const T*>(q);
  p.k = static_cast<const T*>(k);
  p.v = static_cast<const T*>(v);
  p.kv_mask = static_cast<const uint8_t*>(kv_mask);
  p.o = static_cast<T*>(o);
  p.stats = static_cast<float*>(stats);
  p.b = b;
  p.sq = sq;
  p.sk = sk;
  p.h = h;
  p.dh = dh;
  p.q_sb = strides[0];
  p.q_ss = strides[1];
  p.k_sb = strides[2];
  p.k_ss = strides[3];
  p.v_sb = strides[4];
  p.v_ss = strides[5];
  p.o_sb = strides[6];
  p.o_ss = strides[7];
  p.scale = scale;
  p.causal = causal;
  p.inv = inv;
  p.threshold = threshold;
  p.seed = seed;
  return dispatch<T>(p, stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  kv_mask: (B, Sk) bytes, 1 = attend, or
// null.  stats: (B, H, Sq, 2) fp32 out (row max, row sum).  Strides are in
// elements; the last dimension is contiguous.  Dropout: threshold 0 = off;
// otherwise a weight is kept when its Philox word under `seed` is >=
// threshold, and inv = 1 / (1 - rate).  Returns the cudaError_t of the
// launch (0 on success).
extern "C" int m3p_flash_attention_fwd(
    int dtype, const void* q, const void* k, const void* v,
    const void* kv_mask, void* o, void* stats, int b, int sq, int sk, int h,
    int dh, long long q_sb, long long q_ss, long long k_sb, long long k_ss,
    long long v_sb, long long v_ss, long long o_sb, long long o_ss,
    float scale, int causal, float inv, unsigned int threshold,
    unsigned long long seed, void* stream) {
  if (dh > 128 || dh < 1) return static_cast<int>(cudaErrorInvalidValue);
  const long long strides[8] = {q_sb, q_ss, k_sb, k_ss,
                                v_sb, v_ss, o_sb, o_ss};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return static_cast<int>(run<float>(q, k, v, kv_mask, o, stats, b, sq, sk,
                                       h, dh, strides, scale, causal, inv,
                                       threshold, seed, s));
  if (dtype == 1)
    return static_cast<int>(run<__nv_bfloat16>(
        q, k, v, kv_mask, o, stats, b, sq, sk, h, dh, strides, scale, causal,
        inv, threshold, seed, s));
  return static_cast<int>(cudaErrorInvalidValue);
}
