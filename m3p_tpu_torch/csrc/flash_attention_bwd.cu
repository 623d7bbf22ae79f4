// Flash-attention backward for Hopper (sm_90a), any sequence length.
//
// Replaces m3p_tpu/ops/attention.py::_flash_bwd_dkv_kernel and
// _flash_bwd_dq_kernel (reached through flash_attention_bwd), the backward
// of flash_attention.cu.  Per head h, a column slice of the (B, S, H*Dh)
// layout, with inv = 1 / (1 - rate), keep the Philox mask of tile
// b * H + h (philox.cuh; all ones at rate 0), (m, l) the forward's row
// statistics and di = rowsum(dO . O) (one torch op before the launches, as
// in JAX, where it is an XLA op outside the Pallas calls):
//
//     p  = exp(s - m) / l               dp = dO v^T
//     pd = keep . p . inv               ds = p . (keep . dp . inv - di)
//     dv = pd^T dO                      dk = scale ds^T q     dq = scale ds k
//
// p is recomputed from q, k and the statistics, and the mask regenerated
// from the seed, so neither is ever stored.  The products take operands
// rounded to the input type (pd and ds included) and sum in fp32.  A masked
// score gets no gradient (ds = 0), as in the vjp of mha_reference.
//
// Two launches, no atomics, so the result is the same on every run:
//   phase 0, one block per (64-key tile, head, batch): walks the query rows
//     in 64-row tiles and keeps dk and dv of its keys in registers;
//   phase 1, one block per (64-query tile, head, batch): walks the keys in
//     64-key tiles and keeps dq of its rows in registers.
// Each scores a (query, key) pair with the same fmaf chain as the forward.
//
// Bound: at the long-context step (B = 8, S = 2048, H = 12, Dh = 64, bf16)
// the five products are 257.7 GFLOP, 0.261 ms at 989 TF/s, against 202.9 MB
// of inputs and outputs, 0.061 ms at 3.35 TB/s: operations.  This design
// does seven (QK^T and dO V^T in both passes), on CUDA cores out of shared
// memory with 4 x 4 register tiles.  Tensor-core mma/wgmma tiles and TMA are
// left for later work.

#include <cmath>

#include "flash_tile.cuh"

namespace {

using namespace m3p::flash;

template <typename T>
struct Params {
  const T* q;
  const T* k;
  const T* v;
  const uint8_t* kv_mask;  // (B, Sk), 1 = attend, or null
  const T* dout;
  const float* stats;  // (B, H, Sq, 2): row max m, row sum l
  const float* di;     // (B, Sq, H): rowsum(dO . O)
  T* dq;
  T* dk;
  T* dv;
  int b, sq, sk, h, dh;
  long long q_sb, q_ss, k_sb, k_ss, v_sb, v_ss, do_sb, do_ss;
  long long dq_sb, dq_ss, dk_sb, dk_ss, dv_sb, dv_ss;
  float scale;
  int causal;
  float inv;
  uint32_t threshold;
  unsigned long long seed;
};

// both phases: q, dO, K, V tiles (kTile, ld); two (kTile, kPitch) tiles;
// (m, l, di) of the query tile; the keep bytes of a (kTile, kTile) tile
size_t smem_bytes(int dh) {
  const size_t ld = static_cast<size_t>(dh) + 1;
  return sizeof(float) * (4 * kTile * ld + 2 * kTile * kPitch + 3 * kTile) +
         kTile * kTile;
}

// st_s[3 r .. 3 r + 2] = (m, l, di) of query row q0 + r; (0, 1, 0) past Sq
template <typename T>
__device__ void load_stats(float* st_s, const Params<T>& p, int tile, int b,
                           int h, int q0, int rows) {
  for (int r = threadIdx.x; r < kTile; r += kThreads) {
    const bool in = r < rows;
    const long long row = static_cast<long long>(tile) * p.sq + q0 + r;
    st_s[3 * r + 0] = in ? p.stats[2 * row] : 0.f;
    st_s[3 * r + 1] = in ? p.stats[2 * row + 1] : 1.f;
    st_s[3 * r + 2] =
        in ? p.di[(static_cast<long long>(b) * p.sq + q0 + r) * p.h + h] : 0.f;
  }
}

// pd and ds of the thread's 4 x 4 (query, key) elements of the tile at
// (q0, k0), rounded to T; zero past Sq or Sk
template <typename T, bool kDropout>
__device__ __forceinline__ void grads_of_scores(
    const Params<T>& p, const uint8_t* mb, const float* st_s,
    const uint8_t* keep_s, int q0, int k0, int rows, int kn,
    const float (&s)[kPer][kPer], const float (&dp)[kPer][kPer],
    float (&pd)[kPer][kPer], float (&ds)[kPer][kPer]) {
  const int tx = threadIdx.x % kSub, ty = threadIdx.x / kSub;
  const int q_offset = p.sk - p.sq;
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int r = ty + kSub * i;
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int c = tx + kSub * j;
      float pdv = 0.f, dsv = 0.f;
      if (r < rows && c < kn) {
        const bool valid = attends(mb, p.causal, k0 + c, q0 + r, q_offset);
        const float sc = valid ? s[i][j] * p.scale : kMaskValue;
        const float pr = expf(sc - st_s[3 * r]) / st_s[3 * r + 1];
        const bool keep = !kDropout || keep_s[r * kTile + c] != 0;
        pdv = keep ? pr * p.inv : 0.f;
        dsv = valid ? pr * ((keep ? dp[i][j] * p.inv : 0.f) - st_s[3 * r + 2])
                    : 0.f;
      }
      pd[i][j] = rounded<T>(pdv);
      ds[i][j] = rounded<T>(dsv);
    }
  }
}

// ---------------------------------------------------------------------------
// phase 0: dk and dv
// ---------------------------------------------------------------------------

template <typename T, bool kDropout, int kMaxDh>
__global__ void __launch_bounds__(kThreads)
flash_attention_bwd_dkdv_kernel(Params<T> p) {
  constexpr int kCols = kMaxDh / kSub;
  extern __shared__ float smem[];
  const int dh = p.dh, sq = p.sq, sk = p.sk;
  const int ld = dh + 1;
  float* k_s = smem;                      // (kTile, ld)
  float* v_s = k_s + kTile * ld;          // (kTile, ld)
  float* q_s = v_s + kTile * ld;          // (kTile, ld)
  float* do_s = q_s + kTile * ld;         // (kTile, ld)
  float* pd_s = do_s + kTile * ld;        // (kTile, kPitch): pd[query][key]
  float* ds_s = pd_s + kTile * kPitch;    // (kTile, kPitch): ds[query][key]
  float* st_s = ds_s + kTile * kPitch;    // (kTile, 3)
  uint8_t* keep_s = reinterpret_cast<uint8_t*>(st_s + 3 * kTile);

  const int k0 = blockIdx.x * kTile;
  const int h = blockIdx.y, b = blockIdx.z;
  const int tile = b * gridDim.y + h;
  const int tx = threadIdx.x % kSub, ty = threadIdx.x / kSub;
  const int kn = min(kTile, sk - k0);
  const long long hoff = static_cast<long long>(h) * dh;
  const T* qb = p.q + b * p.q_sb + hoff;
  const T* dob = p.dout + b * p.do_sb + hoff;
  const uint8_t* mb =
      p.kv_mask == nullptr ? nullptr : p.kv_mask + static_cast<long long>(b) * sk;

  load_rows(k_s, p.k + b * p.k_sb + hoff, p.k_ss, k0, kn, dh, ld);
  load_rows(v_s, p.v + b * p.v_sb + hoff, p.v_ss, k0, kn, dh, ld);
  // thread keys ty + 16 i, columns tx + 16 c
  float dk_acc[kPer][kCols], dv_acc[kPer][kCols];
#pragma unroll
  for (int i = 0; i < kPer; ++i)
#pragma unroll
    for (int c = 0; c < kCols; ++c) dk_acc[i][c] = dv_acc[i][c] = 0.f;

  for (int q0 = 0; q0 < sq; q0 += kTile) {
    const int rows = min(kTile, sq - q0);
    __syncthreads();  // the previous query tile is consumed
    load_rows(q_s, qb, p.q_ss, q0, rows, dh, ld);
    load_rows(do_s, dob, p.do_ss, q0, rows, dh, ld);
    load_stats(st_s, p, tile, b, h, q0, rows);
    if (kDropout) fill_keep(keep_s, p.seed, p.threshold, tile, q0, k0);
    __syncthreads();
    float s[kPer][kPer], dp[kPer][kPer], pd[kPer][kPer], ds[kPer][kPer];
    tile_dots(q_s, k_s, ld, dh, s);
    tile_dots(do_s, v_s, ld, dh, dp);
    grads_of_scores<T, kDropout>(p, mb, st_s, keep_s, q0, k0, rows, kn, s,
                                 dp, pd, ds);
#pragma unroll
    for (int i = 0; i < kPer; ++i)
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        const int at = (ty + kSub * i) * kPitch + tx + kSub * j;
        pd_s[at] = pd[i][j];
        ds_s[at] = ds[i][j];
      }
    __syncthreads();
    for (int r = 0; r < rows; ++r) {
      float pv[kPer], sv[kPer], dov[kCols], qv[kCols];
#pragma unroll
      for (int i = 0; i < kPer; ++i) {
        pv[i] = pd_s[r * kPitch + ty + kSub * i];
        sv[i] = ds_s[r * kPitch + ty + kSub * i];
      }
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const int d = tx + kSub * c;
        dov[c] = d < dh ? do_s[r * ld + d] : 0.f;
        qv[c] = d < dh ? q_s[r * ld + d] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < kPer; ++i)
#pragma unroll
        for (int c = 0; c < kCols; ++c) {
          dv_acc[i][c] = fmaf(pv[i], dov[c], dv_acc[i][c]);
          dk_acc[i][c] = fmaf(sv[i], qv[c], dk_acc[i][c]);
        }
    }
  }

#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int j = ty + kSub * i;
    if (j >= kn) continue;
    T* dkb = p.dk + b * p.dk_sb + hoff + (k0 + j) * p.dk_ss;
    T* dvb = p.dv + b * p.dv_sb + hoff + (k0 + j) * p.dv_ss;
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      const int d = tx + kSub * c;
      if (d < dh) {
        dkb[d] = from_f<T>(dk_acc[i][c] * p.scale);
        dvb[d] = from_f<T>(dv_acc[i][c]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// phase 1: dq
// ---------------------------------------------------------------------------

template <typename T, bool kDropout, int kMaxDh>
__global__ void __launch_bounds__(kThreads)
flash_attention_bwd_dq_kernel(Params<T> p) {
  constexpr int kCols = kMaxDh / kSub;
  extern __shared__ float smem[];
  const int dh = p.dh, sq = p.sq, sk = p.sk;
  const int ld = dh + 1;
  float* q_s = smem;                      // (kTile, ld)
  float* do_s = q_s + kTile * ld;         // (kTile, ld)
  float* k_s = do_s + kTile * ld;         // (kTile, ld)
  float* v_s = k_s + kTile * ld;          // (kTile, ld)
  float* ds_s = v_s + kTile * ld;         // (kTile, kPitch): ds[query][key]
  float* st_s = ds_s + 2 * kTile * kPitch;  // (kTile, 3)
  uint8_t* keep_s = reinterpret_cast<uint8_t*>(st_s + 3 * kTile);

  const int q0 = blockIdx.x * kTile;
  const int h = blockIdx.y, b = blockIdx.z;
  const int tile = b * gridDim.y + h;
  const int tx = threadIdx.x % kSub, ty = threadIdx.x / kSub;
  const int rows = min(kTile, sq - q0);
  const long long hoff = static_cast<long long>(h) * dh;
  const T* kb = p.k + b * p.k_sb + hoff;
  const T* vb = p.v + b * p.v_sb + hoff;
  const uint8_t* mb =
      p.kv_mask == nullptr ? nullptr : p.kv_mask + static_cast<long long>(b) * sk;

  load_rows(q_s, p.q + b * p.q_sb + hoff, p.q_ss, q0, rows, dh, ld);
  load_rows(do_s, p.dout + b * p.do_sb + hoff, p.do_ss, q0, rows, dh, ld);
  load_stats(st_s, p, tile, b, h, q0, rows);
  // thread rows ty + 16 i, columns tx + 16 c
  float dq_acc[kPer][kCols];
#pragma unroll
  for (int i = 0; i < kPer; ++i)
#pragma unroll
    for (int c = 0; c < kCols; ++c) dq_acc[i][c] = 0.f;

  for (int k0 = 0; k0 < sk; k0 += kTile) {
    const int kn = min(kTile, sk - k0);
    __syncthreads();  // the previous key tile is consumed
    load_rows(k_s, kb, p.k_ss, k0, kn, dh, ld);
    load_rows(v_s, vb, p.v_ss, k0, kn, dh, ld);
    if (kDropout) fill_keep(keep_s, p.seed, p.threshold, tile, q0, k0);
    __syncthreads();
    float s[kPer][kPer], dp[kPer][kPer], pd[kPer][kPer], ds[kPer][kPer];
    tile_dots(q_s, k_s, ld, dh, s);
    tile_dots(do_s, v_s, ld, dh, dp);
    grads_of_scores<T, kDropout>(p, mb, st_s, keep_s, q0, k0, rows, kn, s,
                                 dp, pd, ds);
#pragma unroll
    for (int i = 0; i < kPer; ++i)
#pragma unroll
      for (int j = 0; j < kPer; ++j)
        ds_s[(ty + kSub * i) * kPitch + tx + kSub * j] = ds[i][j];
    __syncthreads();
    for (int j = 0; j < kn; ++j) {
      float sv[kPer], kv[kCols];
#pragma unroll
      for (int i = 0; i < kPer; ++i) sv[i] = ds_s[(ty + kSub * i) * kPitch + j];
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const int d = tx + kSub * c;
        kv[c] = d < dh ? k_s[j * ld + d] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < kPer; ++i)
#pragma unroll
        for (int c = 0; c < kCols; ++c)
          dq_acc[i][c] = fmaf(sv[i], kv[c], dq_acc[i][c]);
    }
  }

#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int r = ty + kSub * i;
    if (r >= rows) continue;
    T* dqb = p.dq + b * p.dq_sb + hoff + (q0 + r) * p.dq_ss;
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      const int d = tx + kSub * c;
      if (d < dh) dqb[d] = from_f<T>(dq_acc[i][c] * p.scale);
    }
  }
}

template <typename T, bool kDropout, int kMaxDh>
cudaError_t launch(int phase, const Params<T>& p, cudaStream_t stream) {
  const size_t smem = smem_bytes(p.dh);
  auto kernel = phase == 0 ? flash_attention_bwd_dkdv_kernel<T, kDropout, kMaxDh>
                           : flash_attention_bwd_dq_kernel<T, kDropout, kMaxDh>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const int tiles = ((phase == 0 ? p.sk : p.sq) + kTile - 1) / kTile;
  kernel<<<dim3(tiles, p.h, p.b), kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(int phase, const Params<T>& p, cudaStream_t stream) {
  const bool dropout = p.threshold != 0u;
  if (p.dh <= 64)
    return dropout ? launch<T, true, 64>(phase, p, stream)
                   : launch<T, false, 64>(phase, p, stream);
  return dropout ? launch<T, true, 128>(phase, p, stream)
                 : launch<T, false, 128>(phase, p, stream);
}

template <typename T>
cudaError_t run(int phase, const void* const* ptrs, int b, int sq, int sk,
                int h, int dh, const long long* strides, float scale,
                int causal, float inv, unsigned int threshold,
                unsigned long long seed, cudaStream_t stream) {
  Params<T> p;
  p.q = static_cast<const T*>(ptrs[0]);
  p.k = static_cast<const T*>(ptrs[1]);
  p.v = static_cast<const T*>(ptrs[2]);
  p.kv_mask = static_cast<const uint8_t*>(ptrs[3]);
  p.dout = static_cast<const T*>(ptrs[4]);
  p.stats = static_cast<const float*>(ptrs[5]);
  p.di = static_cast<const float*>(ptrs[6]);
  p.dq = static_cast<T*>(const_cast<void*>(ptrs[7]));
  p.dk = static_cast<T*>(const_cast<void*>(ptrs[8]));
  p.dv = static_cast<T*>(const_cast<void*>(ptrs[9]));
  p.b = b;
  p.sq = sq;
  p.sk = sk;
  p.h = h;
  p.dh = dh;
  long long* fields[14] = {&p.q_sb,  &p.q_ss,  &p.k_sb,  &p.k_ss,  &p.v_sb,
                           &p.v_ss,  &p.do_sb, &p.do_ss, &p.dq_sb, &p.dq_ss,
                           &p.dk_sb, &p.dk_ss, &p.dv_sb, &p.dv_ss};
  for (int i = 0; i < 14; ++i) *fields[i] = strides[i];
  p.scale = scale;
  p.causal = causal;
  p.inv = inv;
  p.threshold = threshold;
  p.seed = seed;
  return dispatch<T>(phase, p, stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  phase: 0 = dk and dv, 1 = dq (either
// order; both read only the inputs).  kv_mask: (B, Sk) bytes, 1 = attend,
// or null.  stats: the forward's (B, H, Sq, 2) fp32 (row max, row sum);
// di: (B, Sq, H) fp32 rowsum(dO . O).  Strides are in elements; the last
// dimension is contiguous.  Dropout: threshold 0 = off, else as
// m3p_flash_attention_fwd.  Returns the cudaError_t of the launch.
extern "C" int m3p_flash_attention_bwd(
    int dtype, int phase, const void* q, const void* k, const void* v,
    const void* kv_mask, const void* dout, const void* stats, const void* di,
    void* dq, void* dk, void* dv, int b, int sq, int sk, int h, int dh,
    long long q_sb, long long q_ss, long long k_sb, long long k_ss,
    long long v_sb, long long v_ss, long long do_sb, long long do_ss,
    long long dq_sb, long long dq_ss, long long dk_sb, long long dk_ss,
    long long dv_sb, long long dv_ss, float scale, int causal, float inv,
    unsigned int threshold, unsigned long long seed, void* stream) {
  if (dh > 128 || dh < 1 || (phase != 0 && phase != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const void* ptrs[10] = {q, k, v, kv_mask, dout, stats, di, dq, dk, dv};
  const long long strides[14] = {q_sb,  q_ss,  k_sb,  k_ss,  v_sb,
                                 v_ss,  do_sb, do_ss, dq_sb, dq_ss,
                                 dk_sb, dk_ss, dv_sb, dv_ss};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return static_cast<int>(run<float>(phase, ptrs, b, sq, sk, h, dh, strides,
                                       scale, causal, inv, threshold, seed,
                                       s));
  if (dtype == 1)
    return static_cast<int>(run<__nv_bfloat16>(phase, ptrs, b, sq, sk, h, dh,
                                               strides, scale, causal, inv,
                                               threshold, seed, s));
  return static_cast<int>(cudaErrorInvalidValue);
}
