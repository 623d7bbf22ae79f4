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
//   phase 0, one block per (key tile, head, batch): walks the query rows
//     in tiles and keeps dk and dv of its keys in registers;
//   phase 1, one block per (query tile, head, batch): walks the keys in
//     tiles and keeps dq of its rows in registers.
//
// Bound: at the long-context step (B = 8, S = 2048, H = 12, Dh = 64, bf16)
// the five products (q k^T, dO v^T, pd^T dO, ds^T q, ds k) are 257.7 GFLOP,
// 0.2606 ms at 989 TF/s, against 202.9 MB of inputs and outputs, 0.061 ms
// at 3.35 TB/s: operations.  Both designs do seven products, 360.8 GFLOP:
// phase 1 computes q k^T and dO v^T again rather than pass p and dp
// between the launches, which keeps the two launches free of atomics.
//
// Two designs; the C entry launches the one the caller names (tc_fits in
// flash_tile.cuh, ops/attention.py::_flash_design):
//
// Tensor cores (bf16, Dh a multiple of 16 up to 128, 16-byte aligned rows;
// the xMLM path): mma.sync m16n8k16 with fp32 sums, 8 warps a block.
//   Phase 0: 128 keys a block, 16 a warp, in the M dimension: s^T = k q^T
//     and dp^T = v dO^T with k and v as A fragments (ldmatrix) and q and
//     dO rows as B fragments (ldmatrix); pd^T and ds^T pass from C to A
//     fragments in registers (rounded to bf16 where the CUDA-core design
//     rounds them) for dv += pd^T dO and dk += ds^T q, with dO and q as
//     B fragments through ldmatrix.trans.  The queries come in tiles of 64
//     (32 at Dh 128, to spare registers), q, dO and their (m, l, di) two
//     stages deep by cp.async.
//   Phase 1: 128 queries a block, 16 a warp, in M: s = q k^T and
//     dp = dO v^T as in the forward, ds to A fragments, dq += ds k with K
//     through ldmatrix.trans; K and V in 64-key tiles two stages deep by
//     cp.async; the rows' (m, l, di) in registers.
//   Both: p = exp(s - m) times 1 / l (the reciprocal taken once a row);
//   a tile whose every (query, key) pair of a warp is in range and
//   attended skips the per-element masking (a warp vote).  Dropout: the
//   Philox keep bytes of each (query, key) tile are drawn once per block
//   tile into shared memory (fill_keep), 8 groups a thread.  Rows padded
//   by 8 bf16 keep ldmatrix free of bank conflicts.  Dh 64 and 128 are
//   compiled exact, other multiples of 16 take Dh <= 128 kernels.  Shared
//   memory at Dh 64: 83,456 bytes (phase 0), 81,920 (phase 1); one block
//   of 8 warps an SM.  Registers (nvcc -Xptxas -v, sm_90a; without / with
//   dropout): phase 0 228 / 224 at Dh 64, 240 / 240 at Dh 128, 214 / 223
//   in the Dh <= 128 kernel; phase 1 190 / 196, 224 / 230, 206 / 225; no
//   spills.
//   The forward and phase 1 issue the same mma sequence for a score (q as
//   A, k as B, the same k-steps in the same order), so they see the same
//   fp32 score bit for bit; phase 0 computes s^T = k q^T, the same products
//   summed over the same k-steps with the operands' roles swapped, which
//   PTX does not promise to round identically.  On an H100 the debug build
//   (kDump) shows phase 0's scores bitwise equal to the forward's at a
//   causal S = 600 (tests/test_torch_kernels.py).  The checks hold dk and
//   dv to the unchanged bf16 tolerance either way.
//
// CUDA cores (fp32, and bf16 outside those shapes): 64 x 64 tiles on CUDA
// cores out of shared memory with 4 x 4 register tiles (flash_tile.cuh),
// every pass scoring a (query, key) pair with the same fmaf chain as the
// forward, so all three see bitwise the same fp32 score.
//
// Left for later work: wgmma with TMA and warp specialisation, and a
// one-pass dq (an fp32 accumulator summed across the key blocks) that
// drops the two recomputed products.

#include <cmath>
#include <type_traits>

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
  int head_base, heads_total;  // the Philox tiles' heads (philox_tile)
  // the debug instantiation only (kDump, M3P_SCORE_DUMP): (B, H, Sq, Sk)
  // fp32, the unscaled scores q.k of the dk/dv pass
  float* scores;
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
  const int ptile = m3p::philox_tile(b, h, p.head_base, p.heads_total);
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
    if (kDropout) fill_keep(keep_s, p.seed, p.threshold, ptile, q0, k0);
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
  const int ptile = m3p::philox_tile(b, h, p.head_base, p.heads_total);
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
    if (kDropout) fill_keep(keep_s, p.seed, p.threshold, ptile, q0, k0);
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

// ---------------------------------------------------------------------------
// bf16 on the tensor cores: mma.sync m16n8k16, fp32 sums
// ---------------------------------------------------------------------------

namespace tc {

using bf16 = __nv_bfloat16;
using namespace m3p::mma;

constexpr int kBlockRows = 128;  // keys (phase 0) or queries (phase 1)
constexpr int kKTile = 64;       // keys of a phase-1 tile
constexpr int kPad = 8;          // bf16 padding of a shared row
static_assert(kKTile == kTile, "whole_tile votes over kTile keys");

// queries of a phase-0 tile: fewer at Dh 128 to spare registers
template <int kMaxDh>
constexpr int kQTileOf = kMaxDh <= 64 ? 64 : 32;

// phase 0: K and V (kBlockRows, ld); two stages of q and dO (kQT, ld) and
// of (m, l, di) (3, kQT) fp32; the keep bytes (kQT, kBlockRows)
size_t smem_bytes_dkdv(int dh, int qt) {
  return sizeof(bf16) * static_cast<size_t>(2 * kBlockRows + 4 * qt) *
             (dh + kPad) +
         sizeof(float) * 6 * qt + static_cast<size_t>(qt) * kBlockRows;
}

// phase 1: q and dO (kBlockRows, ld); two stages of K and V (kKTile, ld);
// the keep bytes (kBlockRows, kKTile)
size_t smem_bytes_dq(int dh) {
  return sizeof(bf16) * static_cast<size_t>(2 * kBlockRows + 4 * kKTile) *
             (dh + kPad) +
         static_cast<size_t>(kBlockRows) * kKTile;
}

// (m, l, di) of query rows q0 .. q0 + kQT into st (3, kQT), one 4-byte
// cp.async each; zeros past Sq
template <int kQT>
__device__ __forceinline__ void load_stats_async(float* st,
                                                 const Params<bf16>& p,
                                                 int tile, int b, int h,
                                                 int q0) {
  const int i = threadIdx.x;
  if (i >= 3 * kQT) return;
  const int which = i / kQT, r = i - which * kQT;
  const bool in = q0 + r < p.sq;
  const long long row = static_cast<long long>(tile) * p.sq + q0 + r;
  const float* src =
      which < 2 ? p.stats + 2 * row + which
                : p.di + (static_cast<long long>(b) * p.sq + q0 + r) * p.h + h;
  cp_async_4(st + i, in ? src : p.stats, in);
}

// pd and ds of one (query, key) element, as grads_of_scores computes them
// but for the division by l, a product with its reciprocal inv_l
template <bool kDropout>
__device__ __forceinline__ void grad_of_score(const Params<bf16>& p,
                                              bool in, bool valid, bool keep,
                                              float s, float dp, float m,
                                              float inv_l, float di,
                                              float& pd, float& ds) {
  pd = 0.f;
  ds = 0.f;
  if (in) {
    const float sc = valid ? s * p.scale : kMaskValue;
    const float pr = expf(sc - m) * inv_l;
    const bool kept = !kDropout || keep;
    pd = kept ? pr * p.inv : 0.f;
    ds = valid ? pr * ((kept ? dp * p.inv : 0.f) - di) : 0.f;
  }
}

// Phase 0: one block of 8 warps per (128-key tile, head, batch); warp w
// owns keys 16 w .. 16 w + 15 (a lane keys g and g + 8 of them) and walks
// the queries in kQT-row tiles, the next tile's q, dO and (m, l, di)
// arriving by cp.async while this one is used.  Keys are the M side:
// s^T = k q^T and dp^T = v dO^T, then dv += pd^T dO and dk += ds^T q with
// pd^T and ds^T passed from C to A fragments in registers.
template <bool kDropout, int kMaxDh, bool kExact, bool kDump = false>
__global__ void __launch_bounds__(kThreads, 1)
flash_attention_bwd_dkdv_mma_kernel(Params<bf16> p) {
  constexpr int kQT = kQTileOf<kMaxDh>;
  constexpr int kDSteps = kMaxDh / 16, kDTiles = kMaxDh / 8;
  constexpr int kQTiles = kQT / 8;  // n-tiles (queries) of s^T
  extern __shared__ float4 smem4[];
  const int dh = kExact ? kMaxDh : p.dh, sq = p.sq, sk = p.sk;
  const int ld = dh + kPad;
  bf16* k_s = reinterpret_cast<bf16*>(smem4);
  bf16* v_s = k_s + kBlockRows * ld;
  bf16* qd_s = v_s + kBlockRows * ld;  // stage i: q at 2 i kQT ld, then dO
  float* st_s = reinterpret_cast<float*>(qd_s + 4 * kQT * ld);  // 2 x 3 kQT
  uint8_t* keep_s = reinterpret_cast<uint8_t*>(st_s + 6 * kQT);

  const int k0 = blockIdx.x * kBlockRows;
  const int h = blockIdx.y, b = blockIdx.z;
  const int tile = b * gridDim.y + h;
  const int ptile = m3p::philox_tile(b, h, p.head_base, p.heads_total);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int q_offset = sk - sq;
  const long long hoff = static_cast<long long>(h) * dh;
  const bf16* qb = p.q + b * p.q_sb + hoff;
  const bf16* dob = p.dout + b * p.do_sb + hoff;
  const uint8_t* mb =
      p.kv_mask == nullptr ? nullptr : p.kv_mask + static_cast<long long>(b) * sk;
  const int kn = min(kBlockRows, sk - k0);
  const int n_tiles = (sq + kQT - 1) / kQT;
  // the lane's keys, k0 + 16 w + g + 8 half
  bool key_in[2], key_ok[2];
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int kj = k0 + 16 * warp + g + 8 * half;
    key_in[half] = kj < sk;
    key_ok[half] = key_in[half] && (mb == nullptr || mb[kj] != 0);
  }

  load_tile_async<kBlockRows>(k_s, ld, p.k + b * p.k_sb + hoff, p.k_ss, k0,
                              kn, dh);
  load_tile_async<kBlockRows>(v_s, ld, p.v + b * p.v_sb + hoff, p.v_ss, k0,
                              kn, dh);
  load_tile_async<kQT>(qd_s, ld, qb, p.q_ss, 0, min(kQT, sq), dh);
  load_tile_async<kQT>(qd_s + kQT * ld, ld, dob, p.do_ss, 0, min(kQT, sq),
                       dh);
  load_stats_async<kQT>(st_s, p, tile, b, h, 0);
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
      load_tile_async<kQT>(next, ld, qb, p.q_ss, nq, min(kQT, sq - nq), dh);
      load_tile_async<kQT>(next + kQT * ld, ld, dob, p.do_ss, nq,
                           min(kQT, sq - nq), dh);
      load_stats_async<kQT>(st_s + stage * 3 * kQT, p, tile, b, h, nq);
    }
    cp_async_commit();
    if (kDropout)
      fill_keep<kQT, kBlockRows>(keep_s, p.seed, p.threshold, ptile, q0,
                                 k0);
    cp_async_wait<1>();
    // the thread that copied a row's l replaces it by 1 / l (its own copy
    // is visible to it after the wait; past Sq, 1 / 0 is never read)
    float* st = st_s + (it & 1) * 3 * kQT;
    if (threadIdx.x >= kQT && threadIdx.x < 2 * kQT)
      st[threadIdx.x] = 1.f / st[threadIdx.x];
    __syncthreads();
    const bf16* q_s = qd_s + (it & 1) * 2 * kQT * ld;
    const bf16* do_s = q_s + kQT * ld;

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
        load_a_frag(ka, k_s, ld, warp, ds, lane);
        load_a_frag(va, v_s, ld, warp, ds, lane);
#pragma unroll
        for (int j = 0; j < kQTiles; j += 2) {
          uint32_t b[4];
          load_b_pair(b, q_s, ld, j, ds, lane);
          mma_16816(s[j], ka, b[0], b[1]);
          mma_16816(s[j + 1], ka, b[2], b[3]);
          load_b_pair(b, do_s, ld, j, ds, lane);
          mma_16816(dp[j], va, b[0], b[1]);
          mma_16816(dp[j + 1], va, b[2], b[3]);
        }
      }

    if constexpr (kDump) {
      // the debug instantiation: each score in range to p.scores
#pragma unroll
      for (int j = 0; j < kQTiles; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qi = q0 + 8 * j + 2 * t + (e & 1);
          if (qi < sq && key_in[e >> 1])
            p.scores[(static_cast<long long>(tile) * sq + qi) * sk + k0 +
                     16 * warp + g + 8 * (e >> 1)] = s[j][e];
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
          const int r = 8 * j + 2 * t + e, qi = q0 + r;
          const float m = st[r], inv_l = st[kQT + r], di = st[2 * kQT + r];
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int c = 16 * warp + g + 8 * half, kj = k0 + c;
            const bool valid =
                kWhole || (key_ok[half] && !(p.causal && kj > qi + q_offset));
            const bool in = kWhole || (qi < sq && key_in[half]);
            const bool keep = kDropout && keep_s[r * kBlockRows + c] != 0;
            float pd, dsv;
            grad_of_score<kDropout>(p, in, valid, keep, s[j][2 * half + e],
                                    dp[j][2 * half + e], m, inv_l, di, pd,
                                    dsv);
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
          uint32_t b[4];
          load_b_pair_trans(b, do_s, ld, kk, n, lane);
          mma_16816(dv_acc[n], ap, b[0], b[1]);
          mma_16816(dv_acc[n + 1], ap, b[2], b[3]);
          load_b_pair_trans(b, q_s, ld, kk, n, lane);
          mma_16816(dk_acc[n], as, b[0], b[1]);
          mma_16816(dk_acc[n + 1], as, b[2], b[3]);
        }
    }
    __syncthreads();  // this stage and keep_s are consumed
  }

#pragma unroll
  for (int half = 0; half < 2; ++half) {
    if (!key_in[half]) continue;
    const int kj = k0 + 16 * warp + g + 8 * half;
    bf16* dkb = p.dk + b * p.dk_sb + hoff + kj * p.dk_ss;
    bf16* dvb = p.dv + b * p.dv_sb + hoff + kj * p.dv_ss;
#pragma unroll
    for (int n = 0; n < kDTiles; ++n)
      if (8 * n < dh) {
        const int d = 8 * n + 2 * t;
        *reinterpret_cast<uint32_t*>(dkb + d) =
            pack_bf16x2(dk_acc[n][2 * half] * p.scale,
                        dk_acc[n][2 * half + 1] * p.scale);
        *reinterpret_cast<uint32_t*>(dvb + d) =
            pack_bf16x2(dv_acc[n][2 * half], dv_acc[n][2 * half + 1]);
      }
  }
}

// Phase 1: one block of 8 warps per (128-query tile, head, batch); warp w
// owns queries 16 w .. 16 w + 15 and walks the keys in 64-key tiles, the
// next tile's K and V arriving by cp.async.  Queries are the M side:
// s = q k^T and dp = dO v^T as in the forward, then dq += ds k.
template <bool kDropout, int kMaxDh, bool kExact>
__global__ void __launch_bounds__(kThreads, 1)
flash_attention_bwd_dq_mma_kernel(Params<bf16> p) {
  constexpr int kDSteps = kMaxDh / 16, kDTiles = kMaxDh / 8;
  constexpr int kKeyTiles = kKTile / 8;
  extern __shared__ float4 smem4[];
  const int dh = kExact ? kMaxDh : p.dh, sq = p.sq, sk = p.sk;
  const int ld = dh + kPad;
  bf16* q_s = reinterpret_cast<bf16*>(smem4);
  bf16* do_s = q_s + kBlockRows * ld;
  bf16* kv_s = do_s + kBlockRows * ld;  // stage i: K at 2 i kKTile ld, V
  uint8_t* keep_s = reinterpret_cast<uint8_t*>(kv_s + 4 * kKTile * ld);

  const int q0 = blockIdx.x * kBlockRows;
  const int h = blockIdx.y, b = blockIdx.z;
  const int tile = b * gridDim.y + h;
  const int ptile = m3p::philox_tile(b, h, p.head_base, p.heads_total);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int q_offset = sk - sq;
  const long long hoff = static_cast<long long>(h) * dh;
  const bf16* kb = p.k + b * p.k_sb + hoff;
  const bf16* vb = p.v + b * p.v_sb + hoff;
  const uint8_t* mb =
      p.kv_mask == nullptr ? nullptr : p.kv_mask + static_cast<long long>(b) * sk;
  const int rows = min(kBlockRows, sq - q0);
  const int n_tiles = (sk + kKTile - 1) / kKTile;

  load_tile_async<kBlockRows>(q_s, ld, p.q + b * p.q_sb + hoff, p.q_ss, q0,
                              rows, dh);
  load_tile_async<kBlockRows>(do_s, ld, p.dout + b * p.do_sb + hoff,
                              p.do_ss, q0, rows, dh);
  load_tile_async<kKTile>(kv_s, ld, kb, p.k_ss, 0, min(kKTile, sk), dh);
  load_tile_async<kKTile>(kv_s + kKTile * ld, ld, vb, p.v_ss, 0,
                          min(kKTile, sk), dh);
  cp_async_commit();

  // (m, 1 / l, di) of the lane's rows q0 + 16 w + g + 8 half; (0, 1, 0)
  // past Sq
  float m[2], inv_l[2], di[2];
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int qi = q0 + 16 * warp + g + 8 * half;
    const bool in = qi < sq;
    const long long row = static_cast<long long>(tile) * sq + qi;
    m[half] = in ? p.stats[2 * row] : 0.f;
    inv_l[half] = in ? 1.f / p.stats[2 * row + 1] : 1.f;
    di[half] =
        in ? p.di[(static_cast<long long>(b) * sq + qi) * p.h + h] : 0.f;
  }
  float dq_acc[kDTiles][4];
#pragma unroll
  for (int n = 0; n < kDTiles; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq_acc[n][e] = 0.f;

  for (int it = 0; it < n_tiles; ++it) {
    const int k0 = it * kKTile, kn = min(kKTile, sk - k0);
    if (it + 1 < n_tiles) {
      bf16* next = kv_s + ((it + 1) & 1) * 2 * kKTile * ld;
      const int nn = min(kKTile, sk - k0 - kKTile);
      load_tile_async<kKTile>(next, ld, kb, p.k_ss, k0 + kKTile, nn, dh);
      load_tile_async<kKTile>(next + kKTile * ld, ld, vb, p.v_ss,
                              k0 + kKTile, nn, dh);
    }
    cp_async_commit();
    if (kDropout)
      fill_keep<kBlockRows, kKTile>(keep_s, p.seed, p.threshold, ptile, q0,
                                    k0);
    cp_async_wait<1>();
    __syncthreads();
    const bf16* k_s = kv_s + (it & 1) * 2 * kKTile * ld;
    const bf16* v_s = k_s + kKTile * ld;

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
        load_a_frag(qa, q_s, ld, warp, ds, lane);
        load_a_frag(da, do_s, ld, warp, ds, lane);
#pragma unroll
        for (int j = 0; j < kKeyTiles; j += 2) {
          uint32_t b[4];
          load_b_pair(b, k_s, ld, j, ds, lane);
          mma_16816(s[j], qa, b[0], b[1]);
          mma_16816(s[j + 1], qa, b[2], b[3]);
          load_b_pair(b, v_s, ld, j, ds, lane);
          mma_16816(dp[j], da, b[0], b[1]);
          mma_16816(dp[j + 1], da, b[2], b[3]);
        }
      }

    // ds into s; a tile whose every key the warp's rows attend skips the
    // masking (rows past Sq only feed their own dq, which is not written)
    auto to_grads = [&](auto whole_tile) {
      constexpr bool kWhole = decltype(whole_tile)::value;
#pragma unroll
      for (int j = 0; j < kKeyTiles; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = 8 * j + 2 * t + e, kj = k0 + c;
          const bool key_ok =
              kWhole || (c < kn && (mb == nullptr || mb[kj] != 0));
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int r = 16 * warp + g + 8 * half, qi = q0 + r;
            const bool valid =
                kWhole || (key_ok && !(p.causal && kj > qi + q_offset));
            const bool in = kWhole || (qi < sq && c < kn);
            const bool keep = kDropout && keep_s[r * kKTile + c] != 0;
            float pd, dsv;
            grad_of_score<kDropout>(p, in, valid, keep, s[j][2 * half + e],
                                    dp[j][2 * half + e], m[half],
                                    inv_l[half], di[half], pd, dsv);
            s[j][2 * half + e] = dsv;
          }
        }
    };
    if (whole_tile(mb, p.causal, k0, kn, q0 + 16 * warp + q_offset, lane))
      to_grads(std::true_type());
    else
      to_grads(std::false_type());

    // dq += ds k, ds rounded to bf16
#pragma unroll
    for (int kk = 0; kk < kKTile / 16; ++kk) {
      uint32_t a[4];
      a[0] = pack_bf16x2(s[2 * kk][0], s[2 * kk][1]);
      a[1] = pack_bf16x2(s[2 * kk][2], s[2 * kk][3]);
      a[2] = pack_bf16x2(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      a[3] = pack_bf16x2(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
      for (int n = 0; n < kDTiles; n += 2)
        if (8 * n < dh) {
          uint32_t b[4];
          load_b_pair_trans(b, k_s, ld, kk, n, lane);
          mma_16816(dq_acc[n], a, b[0], b[1]);
          mma_16816(dq_acc[n + 1], a, b[2], b[3]);
        }
    }
    __syncthreads();  // this stage and keep_s are consumed
  }

#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int qi = q0 + 16 * warp + g + 8 * half;
    if (qi >= sq) continue;
    bf16* dqb = p.dq + b * p.dq_sb + hoff + qi * p.dq_ss;
#pragma unroll
    for (int n = 0; n < kDTiles; ++n)
      if (8 * n < dh)
        *reinterpret_cast<uint32_t*>(dqb + 8 * n + 2 * t) =
            pack_bf16x2(dq_acc[n][2 * half] * p.scale,
                        dq_acc[n][2 * half + 1] * p.scale);
  }
}

template <bool kDropout, int kMaxDh, bool kExact, bool kDump = false>
cudaError_t launch(int phase, const Params<bf16>& p, cudaStream_t stream) {
  const size_t smem = phase == 0
                          ? smem_bytes_dkdv(p.dh, kQTileOf<kMaxDh>)
                          : smem_bytes_dq(p.dh);
  auto kernel =
      phase == 0
          ? flash_attention_bwd_dkdv_mma_kernel<kDropout, kMaxDh, kExact,
                                                kDump>
          : flash_attention_bwd_dq_mma_kernel<kDropout, kMaxDh, kExact>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const int tiles = ((phase == 0 ? p.sk : p.sq) + kBlockRows - 1) / kBlockRows;
  kernel<<<dim3(tiles, p.h, p.b), kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

// Dh 64 and 128 exact; other multiples of 16 below 128 take the general
// Dh <= 128 kernels
template <bool kDropout>
cudaError_t dispatch_dh(int phase, const Params<bf16>& p,
                        cudaStream_t stream) {
  if (p.dh == 64) return launch<kDropout, 64, true>(phase, p, stream);
  if (p.dh == 128) return launch<kDropout, 128, true>(phase, p, stream);
  return launch<kDropout, 128, false>(phase, p, stream);
}

cudaError_t dispatch(int phase, const Params<bf16>& p, cudaStream_t stream) {
  return p.threshold != 0u ? dispatch_dh<true>(phase, p, stream)
                           : dispatch_dh<false>(phase, p, stream);
}

}  // namespace tc

template <typename T>
cudaError_t run(int phase, const void* const* ptrs, int b, int sq, int sk,
                int h, int dh, const long long* strides, float scale,
                int causal, float inv, unsigned int threshold,
                unsigned long long seed, int head_base, int heads_total,
                int design, cudaStream_t stream, float* scores = nullptr) {
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
  p.head_base = head_base;
  p.heads_total = heads_total;
  p.scores = scores;
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
#ifdef M3P_SCORE_DUMP
    if (scores != nullptr)
      return tc::launch<false, 64, true, true>(phase, p, stream);
#endif
    if (design == 1) return tc::dispatch(phase, p, stream);
  }
  return dispatch<T>(phase, p, stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  design: 0 = CUDA cores (any shape),
// 1 = tensor cores (bf16 where tc_fits holds for q, k, v, dO, dq, dk and
// dv; refused otherwise).  phase: 0 = dk and dv, 1 = dq (either order; both
// read only the inputs).  kv_mask: (B, Sk) bytes, 1 = attend,
// or null.  stats: the forward's (B, H, Sq, 2) fp32 (row max, row sum);
// di: (B, Sq, H) fp32 rowsum(dO . O).  Strides are in elements; the last
// dimension is contiguous.  Dropout: threshold 0 = off, else as
// m3p_flash_attention_fwd.  Returns the cudaError_t of the launch.
extern "C" int m3p_flash_attention_bwd(
    int dtype, int design, int phase, const void* q, const void* k,
    const void* v, const void* kv_mask, const void* dout, const void* stats,
    const void* di, void* dq, void* dk, void* dv, int b, int sq, int sk,
    int h, int dh,
    long long q_sb, long long q_ss, long long k_sb, long long k_ss,
    long long v_sb, long long v_ss, long long do_sb, long long do_ss,
    long long dq_sb, long long dq_ss, long long dk_sb, long long dk_ss,
    long long dv_sb, long long dv_ss, float scale, int causal, float inv,
    unsigned int threshold, unsigned long long seed, int head_base,
    int heads_total, void* stream) {
  const void* ptrs[10] = {q, k, v, kv_mask, dout, stats, di, dq, dk, dv};
  const long long strides[14] = {q_sb,  q_ss,  k_sb,  k_ss,  v_sb,
                                 v_ss,  do_sb, do_ss, dq_sb, dq_ss,
                                 dk_sb, dk_ss, dv_sb, dv_ss};
  const void* tc_ptrs[7] = {q, k, v, dout, dq, dk, dv};
  if (dh > 128 || dh < 1 || (phase != 0 && phase != 1) ||
      (design != 0 && design != 1) ||
      (design == 1 && (dtype != 1 || !tc_fits(dh, tc_ptrs, 7, strides, 14))))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return static_cast<int>(run<float>(phase, ptrs, b, sq, sk, h, dh, strides,
                                       scale, causal, inv, threshold, seed,
                                       head_base, heads_total, design, s));
  if (dtype == 1)
    return static_cast<int>(run<__nv_bfloat16>(phase, ptrs, b, sq, sk, h, dh,
                                               strides, scale, causal, inv,
                                               threshold, seed, head_base,
                                               heads_total, design, s));
  return static_cast<int>(cudaErrorInvalidValue);
}

#ifdef M3P_SCORE_DUMP
// The debug build's entry (nvcc -DM3P_SCORE_DUMP; the `gpu` test of
// tests/test_torch_kernels.py that compares the forward's scores with the
// backward's): bf16 on the tensor cores at Dh 64 without dropout, the
// arguments of m3p_flash_attention_bwd less dtype, design and dropout; the
// dk/dv pass (phase 0) also writes every unscaled score q.k in range to
// ``scores`` (B, H, Sq, Sk) fp32.
extern "C" int m3p_flash_attention_bwd_scores(
    int phase, const void* q, const void* k, const void* v,
    const void* kv_mask, const void* dout, const void* stats, const void* di,
    void* dq, void* dk, void* dv, int b, int sq, int sk, int h, int dh,
    long long q_sb, long long q_ss, long long k_sb, long long k_ss,
    long long v_sb, long long v_ss, long long do_sb, long long do_ss,
    long long dq_sb, long long dq_ss, long long dk_sb, long long dk_ss,
    long long dv_sb, long long dv_ss, float scale, int causal,
    float* scores, void* stream) {
  const void* ptrs[10] = {q, k, v, kv_mask, dout, stats, di, dq, dk, dv};
  const long long strides[14] = {q_sb,  q_ss,  k_sb,  k_ss,  v_sb,
                                 v_ss,  do_sb, do_ss, dq_sb, dq_ss,
                                 dk_sb, dk_ss, dv_sb, dv_ss};
  const void* tc_ptrs[7] = {q, k, v, dout, dq, dk, dv};
  if (dh != 64 || (phase != 0 && phase != 1) || scores == nullptr ||
      !tc_fits(dh, tc_ptrs, 7, strides, 14))
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(run<__nv_bfloat16>(
      phase, ptrs, b, sq, sk, h, dh, strides, scale, causal, 1.f, 0u, 0ull, 0,
      h, 1,
      static_cast<cudaStream_t>(stream), scores));
}
#endif
