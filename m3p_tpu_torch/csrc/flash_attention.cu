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
// A block per (query tile, head, batch) walks the keys in 64-key tiles
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
// 103.1 GFLOP, 0.1042 ms at 989 TF/s: operations.
//
// Two designs; the C entry launches the one the caller names (the rule is
// tc_fits in flash_tile.cuh, and ops/attention.py::_flash_design):
//
// Tensor cores (bf16, Dh a multiple of 16 up to 128, 16-byte aligned rows;
// the xMLM path): the FA2 shape on mma.sync m16n8k16 with fp32 sums.  One
// block of 8 warps per (128-query tile, head, batch); warp w owns query
// rows 16 w .. 16 w + 15, whose q is loaded once into A fragments
// (ldmatrix).  K and V arrive in 64-key bf16 tiles, two stages deep by
// cp.async (the next tile lands while this one is used), rows padded by 8
// elements so that ldmatrix meets no bank conflict.  s = q k^T takes K rows
// as B fragments (ldmatrix); the online softmax stays in registers, the
// row max and sum reduced over the 4 lanes of a quad by shuffles; p passes
// from C to A fragments in registers, rounded to bf16 where the CUDA-core
// design rounds it; o += p v takes V as B fragments (ldmatrix.trans).
// Dropout: lanes t and t ^ 1 of a quad hold the same Philox group of 4
// keys for the quad's two rows; each lane draws it for one of the rows and
// hands its partner the partner's two words by a shuffle, so every group
// is drawn once.  A key tile that every row of a warp attends (no ragged
// end, no masked key, under the causal diagonal; a warp vote) skips the
// per-element masking; no tile is skipped for causal masking.  Dh 64 and
// 128 are compiled exact, other multiples of 16 take a Dh <= 128 kernel
// that skips the steps past Dh.  Shared memory (128 + 4 x 64) x (Dh + 8)
// bf16: 55,296 bytes at Dh 64 (two blocks an SM), 104,448 at Dh 128.
// Registers (nvcc -Xptxas -v, sm_90a; without / with dropout): 128 / 128
// at Dh 64 (the bound of two blocks an SM), 197 / 233 at Dh 128, 203 / 216
// in the Dh <= 128 kernel; no spills.
//
// CUDA cores (fp32, which keeps its 1e-5 parity with the plain version
// that tensor cores without TF32 cannot give, and bf16 outside those
// shapes): the products run out of shared memory in fp32, each thread
// holding a 4 x 4 register tile of scores and 4 rows x Dh/16 columns of
// the accumulator (flash_tile.cuh); 117-128 registers, no spills.
//
// Left for later work: wgmma from shared memory with TMA loads and warp
// specialisation (a producer warp keeping the K/V ring full), skipping the
// key tiles a causal row never sees.

#include <cmath>
#include <type_traits>

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
  int head_base, heads_total;  // the Philox tiles' heads (philox_tile)
  // the debug instantiation only (kDump, M3P_SCORE_DUMP): (B, H, Sq, Sk)
  // fp32, the unscaled scores q.k
  float* scores;
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
  const int ptile = m3p::philox_tile(b, h, p.head_base, p.heads_total);
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
            m3p::keep_bits(p.seed, ptile, q0 + r, k0 / 4 + (lane >> 1));
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

// ---------------------------------------------------------------------------
// bf16 on the tensor cores: mma.sync m16n8k16, fp32 sums
// ---------------------------------------------------------------------------

namespace tc {

using bf16 = __nv_bfloat16;
using namespace m3p::mma;

constexpr int kQTile = 128;  // query rows of a block: 16 per warp
constexpr int kKTile = 64;   // keys of a tile
constexpr int kPad = 8;      // bf16 padding of a shared row
constexpr int kKeyTiles = kKTile / 8;  // n-tiles of a warp's scores
static_assert(kKTile == kTile, "whole_tile votes over kTile keys");

// q (kQTile, ld) and two stages of K and V (kKTile, ld), ld = dh + kPad
size_t smem_bytes(int dh) {
  return sizeof(bf16) * static_cast<size_t>(kQTile + 4 * kKTile) *
         (dh + kPad);
}

// One block of 8 warps per (128-query tile, head, batch); warp w owns query
// rows 16 w .. 16 w + 15 (a lane rows g and g + 8 of them, g = lane / 4)
// and walks the keys in 64-key tiles, the next tile's K and V arriving by
// cp.async while this one is used.  kExact: Dh == kMaxDh, known to the
// compiler (the xMLM path's 64); else Dh <= kMaxDh and the steps past Dh
// are skipped.
template <bool kDropout, int kMaxDh, bool kExact, bool kDump = false>
__global__ void __launch_bounds__(kThreads, kMaxDh <= 64 ? 2 : 1)
flash_attention_fwd_mma_kernel(Params<bf16> p) {
  constexpr int kDSteps = kMaxDh / 16;  // k-steps of q k^T
  constexpr int kDTiles = kMaxDh / 8;   // n-tiles of the accumulator
  extern __shared__ float4 smem4[];
  const int dh = kExact ? kMaxDh : p.dh, sq = p.sq, sk = p.sk;
  const int ld = dh + kPad;
  bf16* q_s = reinterpret_cast<bf16*>(smem4);
  bf16* kv_s = q_s + kQTile * ld;  // stage i: K at 2 i kKTile ld, then V

  const int q0 = blockIdx.x * kQTile;
  const int h = blockIdx.y, b = blockIdx.z;
  const int tile = b * gridDim.y + h;
  const int ptile = m3p::philox_tile(b, h, p.head_base, p.heads_total);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int q_offset = sk - sq;
  const int row0 = q0 + 16 * warp + g;  // the lane's rows: row0, row0 + 8
  const long long hoff = static_cast<long long>(h) * dh;
  const bf16* kb = p.k + b * p.k_sb + hoff;
  const bf16* vb = p.v + b * p.v_sb + hoff;
  const uint8_t* mb =
      p.kv_mask == nullptr ? nullptr : p.kv_mask + static_cast<long long>(b) * sk;
  const int n_tiles = (sk + kKTile - 1) / kKTile;

  load_tile_async<kQTile>(q_s, ld, p.q + b * p.q_sb + hoff, p.q_ss, q0,
                          min(kQTile, sq - q0), dh);
  load_tile_async<kKTile>(kv_s, ld, kb, p.k_ss, 0, min(kKTile, sk), dh);
  load_tile_async<kKTile>(kv_s + kKTile * ld, ld, vb, p.v_ss, 0,
                          min(kKTile, sk), dh);
  cp_async_commit();

  uint32_t qf[kDSteps][4];
  float acc[kDTiles][4];
#pragma unroll
  for (int n = 0; n < kDTiles; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  // running max and sum of rows row0, row0 + 8, the same in a quad's lanes
  float m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.f, 0.f};

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
    cp_async_wait<1>();  // this tile (and q) have arrived
    __syncthreads();
    if (it == 0) {
#pragma unroll
      for (int ds = 0; ds < kDSteps; ++ds)
        if (16 * ds < dh)
          ldmatrix_x4(qf[ds], q_s + (16 * warp + (lane & 15)) * ld +
                                  16 * ds + (lane >> 4) * 8);
    }
    const bf16* k_s = kv_s + (it & 1) * 2 * kKTile * ld;
    const bf16* v_s = k_s + kKTile * ld;

    // s = q k^T: keys 8 j + 2 t + e of the tile in s[j][2 half + e]
    float s[kKeyTiles][4];
#pragma unroll
    for (int j = 0; j < kKeyTiles; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int ds = 0; ds < kDSteps; ++ds)
#pragma unroll
      for (int j = 0; j < kKeyTiles; j += 2)
        if (16 * ds < dh) {
          uint32_t b[4];
          ldmatrix_x4(b, k_s + (8 * j + (lane & 7) + (lane >> 4) * 8) * ld +
                             16 * ds + ((lane >> 3) & 1) * 8);
          mma_16816(s[j], qf[ds], b[0], b[1]);
          mma_16816(s[j + 1], qf[ds], b[2], b[3]);
        }
    if constexpr (kDump) {
      // the debug instantiation: each score in range to p.scores
#pragma unroll
      for (int j = 0; j < kKeyTiles; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qi = row0 + 8 * (e >> 1), c = 8 * j + 2 * t + (e & 1);
          if (qi < sq && c < kn)
            p.scores[(static_cast<long long>(tile) * sq + qi) * sk + k0 + c] =
                s[j][e];
        }
    }

    // scale and mask; masked scores take kMaskValue, keys past Sk -inf.  A
    // tile whose every key the warp's rows attend (no ragged end, no masked
    // key, wholly under the causal diagonal) only scales.
    float mx[2] = {m_run[0], m_run[1]};
    if (whole_tile(mb, p.causal, k0, kn, q0 + 16 * warp + q_offset, lane)) {
#pragma unroll
      for (int j = 0; j < kKeyTiles; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[j][e] *= p.scale;
          mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
        }
    } else {
#pragma unroll
      for (int j = 0; j < kKeyTiles; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = 8 * j + 2 * t + e, kj = k0 + c;
          const bool in = c < kn;
          const bool key_ok = in && (mb == nullptr || mb[kj] != 0);
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int qi = row0 + 8 * half;
            float& x = s[j][2 * half + e];
            x = !in ? -INFINITY
                    : (key_ok && !(p.causal && kj > qi + q_offset))
                          ? x * p.scale
                          : kMaskValue;
            mx[half] = fmaxf(mx[half], x);
          }
        }
    }
    // online softmax over the quad that holds a row
    float alpha[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      mx[half] = fmaxf(mx[half], __shfl_xor_sync(0xffffffffu, mx[half], 1));
      mx[half] = fmaxf(mx[half], __shfl_xor_sync(0xffffffffu, mx[half], 2));
      alpha[half] = expf(m_run[half] - mx[half]);
    }
#pragma unroll
    for (int j = 0; j < kKeyTiles; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] = expf(s[j][e] - mx[e >> 1]);
        sum[e >> 1] += s[j][e];
      }
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      sum[half] += __shfl_xor_sync(0xffffffffu, sum[half], 1);
      sum[half] += __shfl_xor_sync(0xffffffffu, sum[half], 2);
      l_run[half] = alpha[half] * l_run[half] + sum[half];
      m_run[half] = mx[half];
    }
    if (kDropout) {
      // Lanes t and t ^ 1 hold the same Philox group of 4 keys (8 j + 4
      // (t / 2) ..) for both rows: each draws it for one row (row0 + 8
      // (t & 1)) and hands the partner the two words of its keys by a
      // shuffle, so every group is drawn once.
      const int mine = 2 * (t & 1), theirs = 2 - mine;
#pragma unroll
      for (int j = 0; j < kKeyTiles; ++j) {
        const uint4 w = m3p::keep_bits(p.seed, ptile, row0 + 8 * (t & 1),
                                       k0 / 4 + 2 * j + (t >> 1));
        const uint32_t own0 = m3p::word(w, mine);
        const uint32_t own1 = m3p::word(w, mine + 1);
        const uint32_t got0 =
            __shfl_xor_sync(0xffffffffu, m3p::word(w, theirs), 1);
        const uint32_t got1 =
            __shfl_xor_sync(0xffffffffu, m3p::word(w, theirs + 1), 1);
        // element (half, e): own words for half == t & 1
        const uint32_t w00 = (t & 1) ? got0 : own0;
        const uint32_t w01 = (t & 1) ? got1 : own1;
        const uint32_t w10 = (t & 1) ? own0 : got0;
        const uint32_t w11 = (t & 1) ? own1 : got1;
        if (w00 < p.threshold) s[j][0] = 0.f;
        if (w01 < p.threshold) s[j][1] = 0.f;
        if (w10 < p.threshold) s[j][2] = 0.f;
        if (w11 < p.threshold) s[j][3] = 0.f;
      }
    }

    // acc = alpha acc + p v, p rounded to bf16 in the A fragments
#pragma unroll
    for (int n = 0; n < kDTiles; ++n) {
      acc[n][0] *= alpha[0];
      acc[n][1] *= alpha[0];
      acc[n][2] *= alpha[1];
      acc[n][3] *= alpha[1];
    }
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
          ldmatrix_x4_trans(b, v_s + (16 * kk + (lane & 15)) * ld + 8 * n +
                                   (lane >> 4) * 8);
          mma_16816(acc[n], a, b[0], b[1]);
          mma_16816(acc[n + 1], a, b[2], b[3]);
        }
    }
    __syncthreads();  // this stage is consumed before the next prefetch
  }

  // statistics out; o = inv * acc / l
  bf16* ob = p.o + b * p.o_sb + hoff;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = row0 + 8 * half;
    if (r >= sq) continue;
    if (t == 0) {
      float* st = p.stats + (static_cast<long long>(tile) * sq + r) * 2;
      st[0] = m_run[half];
      st[1] = l_run[half];
    }
    const float f = p.inv / l_run[half];
#pragma unroll
    for (int n = 0; n < kDTiles; ++n)
      if (8 * n < dh)
        *reinterpret_cast<uint32_t*>(ob + r * p.o_ss + 8 * n + 2 * t) =
            pack_bf16x2(acc[n][2 * half] * f, acc[n][2 * half + 1] * f);
  }
}

template <bool kDropout, int kMaxDh, bool kExact, bool kDump = false>
cudaError_t launch(const Params<bf16>& p, cudaStream_t stream) {
  const size_t smem = smem_bytes(p.dh);
  auto kernel = flash_attention_fwd_mma_kernel<kDropout, kMaxDh, kExact,
                                               kDump>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kernel<<<dim3((p.sq + kQTile - 1) / kQTile, p.h, p.b), kThreads, smem,
           stream>>>(p);
  return cudaGetLastError();
}

// Dh 64 and 128 exact; other multiples of 16 below 128 take the general
// Dh <= 128 kernel
template <bool kDropout>
cudaError_t dispatch_dh(const Params<bf16>& p, cudaStream_t stream) {
  if (p.dh == 64) return launch<kDropout, 64, true>(p, stream);
  if (p.dh == 128) return launch<kDropout, 128, true>(p, stream);
  return launch<kDropout, 128, false>(p, stream);
}

cudaError_t dispatch(const Params<bf16>& p, cudaStream_t stream) {
  return p.threshold != 0u ? dispatch_dh<true>(p, stream)
                           : dispatch_dh<false>(p, stream);
}

}  // namespace tc

template <typename T>
cudaError_t run(const void* q, const void* k, const void* v,
                const void* kv_mask, void* o, void* stats, int b, int sq,
                int sk, int h, int dh, const long long* strides, float scale,
                int causal, float inv, unsigned int threshold,
                unsigned long long seed, int head_base, int heads_total,
                int design, cudaStream_t stream, float* scores = nullptr) {
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
  p.head_base = head_base;
  p.heads_total = heads_total;
  p.scores = scores;
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
#ifdef M3P_SCORE_DUMP
    if (scores != nullptr) return tc::launch<false, 64, true, true>(p, stream);
#endif
    if (design == 1) return tc::dispatch(p, stream);
  }
  return dispatch<T>(p, stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  design: 0 = CUDA cores (any shape),
// 1 = tensor cores (bf16 where tc_fits holds for q, k, v and o; refused
// otherwise).  kv_mask: (B, Sk) bytes, 1 = attend, or null.  stats:
// (B, H, Sq, 2) fp32 out (row max, row sum).  Strides are in elements; the
// last dimension is contiguous.  Dropout: threshold 0 = off;
// otherwise a weight is kept when its Philox word under `seed` is >=
// threshold, and inv = 1 / (1 - rate).  Returns the cudaError_t of the
// launch (0 on success).
extern "C" int m3p_flash_attention_fwd(
    int dtype, int design, const void* q, const void* k, const void* v,
    const void* kv_mask, void* o, void* stats, int b, int sq, int sk, int h,
    int dh, long long q_sb, long long q_ss, long long k_sb, long long k_ss,
    long long v_sb, long long v_ss, long long o_sb, long long o_ss,
    float scale, int causal, float inv, unsigned int threshold,
    unsigned long long seed, int head_base, int heads_total, void* stream) {
  const long long strides[8] = {q_sb, q_ss, k_sb, k_ss,
                                v_sb, v_ss, o_sb, o_ss};
  const void* ptrs[4] = {q, k, v, o};
  if (dh > 128 || dh < 1 || (design != 0 && design != 1) ||
      (design == 1 && (dtype != 1 || !tc_fits(dh, ptrs, 4, strides, 8))))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return static_cast<int>(run<float>(q, k, v, kv_mask, o, stats, b, sq, sk,
                                       h, dh, strides, scale, causal, inv,
                                       threshold, seed, head_base,
                                       heads_total, design, s));
  if (dtype == 1)
    return static_cast<int>(run<__nv_bfloat16>(
        q, k, v, kv_mask, o, stats, b, sq, sk, h, dh, strides, scale, causal,
        inv, threshold, seed, head_base, heads_total, design, s));
  return static_cast<int>(cudaErrorInvalidValue);
}

#ifdef M3P_SCORE_DUMP
// The debug build's entry (nvcc -DM3P_SCORE_DUMP; the `gpu` test of
// tests/test_torch_kernels.py that compares the forward's scores with the
// backward's): bf16 on the tensor cores at Dh 64 without dropout, the
// arguments of m3p_flash_attention_fwd less dtype, design and dropout; the
// kernel also writes every unscaled score q.k in range to ``scores`` (B, H,
// Sq, Sk) fp32.
extern "C" int m3p_flash_attention_fwd_scores(
    const void* q, const void* k, const void* v, const void* kv_mask,
    void* o, void* stats, int b, int sq, int sk, int h, int dh,
    long long q_sb, long long q_ss, long long k_sb, long long k_ss,
    long long v_sb, long long v_ss, long long o_sb, long long o_ss,
    float scale, int causal, float* scores, void* stream) {
  const long long strides[8] = {q_sb, q_ss, k_sb, k_ss,
                                v_sb, v_ss, o_sb, o_ss};
  const void* ptrs[4] = {q, k, v, o};
  if (dh != 64 || scores == nullptr || !tc_fits(dh, ptrs, 4, strides, 8))
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(run<__nv_bfloat16>(
      q, k, v, kv_mask, o, stats, b, sq, sk, h, dh, strides, scale, causal,
      1.f, 0u, 0ull, 0, h, 1, static_cast<cudaStream_t>(stream), scores));
}
#endif
