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
// valid key gives the mean of v over Sk and never NaN.  The softmax is
// exact, not rescaled online: p = exp(s - m) / l over the whole row is
// rounded to the input type before P.V, as the plain versions and the
// Pallas kernels round it.
//
// Bound: device memory.  At the flagship joint shape (B = 80, H = 12,
// S = 164, Dh = 64, bf16) q, k, v and o are 80.6 MB, 0.024 ms at 3.35 TB/s,
// against 6.6 GFLOP, 0.007 ms at 989 TF/s.
//
// Two designs; the C entries launch the one the caller names
// (ops/attention.py::_packed_design and _small_design) and refuse a
// tensor-core launch outside its rule:
//   tensor cores (namespace tc below; bf16, tc_fits of flash_tile.cuh and
//     Sq, Sk <= 512, the model's paths): mma.sync m16n8k16 with fp32 sums,
//     cp.async tile loads, 4-warp blocks of 64 queries, two passes over
//     64-key tiles (the row statistics, then p and P.V);
//   CUDA cores (fp32, and bf16 outside that rule): one block per (32-query
//     tile, head, batch); K and then V pass through shared memory in 64-key
//     tiles (fp32 at Sk = 512, Dh = 128 needs 115 KB); each warp owns four
//     query rows, keeps their Sk scores in shared memory and runs a
//     single-pass max/exp/sum softmax before P.V with the accumulators in
//     registers.
// Left for later work: wgmma and TMA, and one pass (the scores held in
// registers) where Sk is small.

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
  int head_base, heads_total;  // the Philox tiles' heads (philox_tile)
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
      const int tile = philox_tile(b, h, a.head_base, a.heads_total);
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

// ---------------------------------------------------------------------------
// bf16 on the tensor cores: mma.sync m16n8k16, fp32 sums
// ---------------------------------------------------------------------------
//
// One block of 4 warps per (64-query tile, head, batch); warp w owns queries
// 16 w .. 16 w + 15 in the M dimension (a lane rows g and g + 8, g = lane /
// 4) and holds their q as A fragments in registers, loaded once.  K (and in
// the second pass V) arrive in 64-key tiles, two stages deep by cp.async,
// rows padded by 8 bf16 against ldmatrix bank conflicts.  The block walks
// the key tiles twice:
//   pass 1: s = q k^T, masked and scaled; the row max m and l = sum
//     exp(s - m) online in registers (l rescaled when the running max
//     grows), max over the quad of lanes that share a row by shuffles;
//   pass 2: s again, the same products in the same order, so bitwise the
//     same scores; p = exp(s - m) / l, the keep mask (Philox, once per
//     element: lanes t and t ^ 1 share a group of four keys and each draws
//     it for one of their two rows, as flash_attention.cu does) and inv
//     with kScaleP, rounded to bf16 in the C-to-A fragment repack, then
//     o += p v with V as B fragments by ldmatrix.trans.
// Three products where the math needs two; the second read of K comes from
// L2 (21 KB a head at S = 164).  Keys past Sk in a ragged last tile are
// zero-filled and left out of m and l (score -FLT_MAX); a masked key inside
// Sk counts at the mask value.  A tile whose every key the warp's rows
// attend skips the per-element masking (a warp vote); a warp whose rows all
// lie past Sq only helps stage the tiles.  o leaves through the warp's own
// rows of the q tile, as 16-byte stores.  Dh 64 and 128 compile exact,
// other multiples of 16 take the Dh <= 128 kernel.
// Shared memory: q (64, Dh + 8) and two stages of K and V (64, Dh + 8),
// 46,080 bytes at Dh 64, 87,040 at Dh 128.  Registers (nvcc -Xptxas -v,
// sm_90a; #1's and #3's instantiations alike): 128 at Dh 64, with or
// without dropout, held there by the launch bound so that four blocks
// share an SM (one instantiation took 130 without it, and ran three);
// 200 / 216 (Dh <= 128 / exact 128) without dropout and 217 / 218 with it;
// no spills.

namespace tc {

using bf16 = __nv_bfloat16;
using namespace m3p::mma;

constexpr int kWarps = 4;
constexpr int kThreadsTc = 32 * kWarps;
constexpr int kRows = 16 * kWarps;  // queries of a block
constexpr int kKT = 64;             // keys of a tile
constexpr int kPad = 8;             // bf16 padding of a shared row
constexpr int kMaxSeq = 512;        // Sq, Sk the design takes
static_assert(kKT == flash::kTile, "whole_tile votes over flash::kTile keys");

inline size_t smem_bytes(int dh) {
  return sizeof(bf16) * static_cast<size_t>(kRows + 4 * kKT) * (dh + kPad);
}

// blocks an SM the registers must leave room for: four at Dh 64 (128
// registers a thread; 46 KB of shared memory each)
template <int kMaxDh>
constexpr int kMinBlocks = kMaxDh <= 64 ? 4 : 1;

template <bool kDropout, bool kScaleP, int kMaxDh, bool kExact>
__global__ void __launch_bounds__(kThreadsTc, kMinBlocks<kMaxDh>)
packed_attention_fwd_mma_kernel(Args a) {
  constexpr int kDSteps = kMaxDh / 16, kDTiles = kMaxDh / 8;
  constexpr int kKeyTiles = kKT / 8;
  extern __shared__ float4 smem4[];
  const int dh = kExact ? kMaxDh : a.dh, sq = a.sq, sk = a.sk;
  const int ld = dh + kPad;
  bf16* q_s = reinterpret_cast<bf16*>(smem4);
  bf16* kv_s = q_s + kRows * ld;  // stage i: K at 2 i kKT ld, then V

  const int q0 = blockIdx.x * kRows;
  const int h = blockIdx.y, b = blockIdx.z;
  const int tile = philox_tile(b, h, a.head_base, a.heads_total);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int q_offset = sk - sq;
  const bf16* kb = static_cast<const bf16*>(a.k) + b * a.k_sb + h * a.k_sh;
  const bf16* vb = static_cast<const bf16*>(a.v) + b * a.v_sb + h * a.v_sh;
  const uint8_t* mb = a.kv_mask == nullptr
                          ? nullptr
                          : a.kv_mask + static_cast<long long>(b) * sk;
  const int rows = min(kRows, sq - q0);
  const int n_tiles = (sk + kKT - 1) / kKT;
  const bool busy = 16 * warp < rows;  // warp-uniform: a row below Sq
  const int row0 = q0 + 16 * warp + g;  // the lane's first row

  flash::load_tile_async<kRows, kThreadsTc>(
      q_s, ld, static_cast<const bf16*>(a.q) + b * a.q_sb + h * a.q_sh,
      a.q_ss, q0, rows, dh);
  flash::load_tile_async<kKT, kThreadsTc>(kv_s, ld, kb, a.k_ss, 0,
                                          min(kKT, sk), dh);
  cp_async_commit();

  // the lane's rows row0 + 8 half: running max and the lane's share of l;
  // from pass 2 on, l holds 1 / l of the whole row
  float m[2] = {-FLT_MAX, -FLT_MAX}, l[2] = {0.f, 0.f};
  uint32_t qa[kDSteps][4];
  float o[kDTiles][4];
#pragma unroll
  for (int n = 0; n < kDTiles; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;

  for (int it = 0; it < 2 * n_tiles; ++it) {
    const bool pass2 = it >= n_tiles;
    const int k0 = (pass2 ? it - n_tiles : it) * kKT;
    const int kn = min(kKT, sk - k0);
    if (it + 1 < 2 * n_tiles) {
      bf16* next = kv_s + ((it + 1) & 1) * 2 * kKT * ld;
      const int nk0 = ((it + 1) % n_tiles) * kKT, nn = min(kKT, sk - nk0);
      flash::load_tile_async<kKT, kThreadsTc>(next, ld, kb, a.k_ss, nk0, nn,
                                              dh);
      if (it + 1 >= n_tiles)
        flash::load_tile_async<kKT, kThreadsTc>(next + kKT * ld, ld, vb,
                                                a.v_ss, nk0, nn, dh);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const bf16* k_s = kv_s + (it & 1) * 2 * kKT * ld;
    const bf16* v_s = k_s + kKT * ld;

    if (busy) {
      if (it == 0) {
#pragma unroll
        for (int ds = 0; ds < kDSteps; ++ds)
          if (16 * ds < dh) flash::load_a_frag(qa[ds], q_s, ld, warp, ds, lane);
      }
      if (it == n_tiles) {
#pragma unroll
        for (int half = 0; half < 2; ++half)
          l[half] = 1.f / flash::quad_sum(l[half]);
      }

      // s = q k^T: the lane's rows, keys 8 j + 2 t + e
      float s[kKeyTiles][4];
#pragma unroll
      for (int j = 0; j < kKeyTiles; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
      for (int ds = 0; ds < kDSteps; ++ds)
        if (16 * ds < dh) {
#pragma unroll
          for (int j = 0; j < kKeyTiles; j += 2) {
            uint32_t bb[4];
            flash::load_b_pair(bb, k_s, ld, j, ds, lane);
            mma_16816(s[j], qa[ds], bb[0], bb[1]);
            mma_16816(s[j + 1], qa[ds], bb[2], bb[3]);
          }
        }

      // the scores in place: scaled, the mask value where not attended,
      // -FLT_MAX past Sk (a weight of exactly 0); a tile whose every key
      // the warp's rows attend skips the masking (rows past Sq feed only
      // their own results, which are not written)
      auto score = [&](auto whole_tile) {
        constexpr bool kWhole = decltype(whole_tile)::value;
#pragma unroll
        for (int j = 0; j < kKeyTiles; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int c = 8 * j + 2 * t + (e & 1);
            const int qi = row0 + 8 * (e >> 1);
            float& sc = s[j][e];
            if (kWhole)
              sc *= a.scale;
            else if (c >= kn)
              sc = -FLT_MAX;
            else
              sc = flash::attends(mb, a.causal, k0 + c, qi, q_offset)
                       ? sc * a.scale
                       : kMaskValue;
          }
      };
      if (flash::whole_tile(mb, a.causal, k0, kn, q0 + 16 * warp + q_offset,
                            lane))
        score(std::true_type());
      else
        score(std::false_type());

      if (!pass2) {
        // pass 1: the online row statistics
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          float mx = -FLT_MAX;
#pragma unroll
          for (int j = 0; j < kKeyTiles; ++j)
            mx = fmaxf(mx, fmaxf(s[j][2 * half], s[j][2 * half + 1]));
          const float m_new = fmaxf(m[half], flash::quad_max(mx));
          float ls = 0.f;
#pragma unroll
          for (int j = 0; j < kKeyTiles; ++j)
            ls += expf(s[j][2 * half] - m_new) +
                  expf(s[j][2 * half + 1] - m_new);
          l[half] = l[half] * expf(m[half] - m_new) + ls;
          m[half] = m_new;
        }
      } else {
        // pass 2: p = exp(s - m) / l, dropped and scaled, into s
#pragma unroll
        for (int j = 0; j < kKeyTiles; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            s[j][e] = expf(s[j][e] - m[e >> 1]) * l[e >> 1];
        if (kDropout) {
          // lanes t and t ^ 1 hold the same Philox group of 4 keys (8 j +
          // 4 (t / 2) ..) for both rows: each draws it for one row (row0 +
          // 8 (t & 1)) and hands the partner the two words of its keys
          const int mine = 2 * (t & 1), theirs = 2 - mine;
#pragma unroll
          for (int j = 0; j < kKeyTiles; ++j) {
            const uint4 w = keep_bits(a.seed, tile, row0 + 8 * (t & 1),
                                      k0 / 4 + 2 * j + (t >> 1));
            const uint32_t own0 = word(w, mine), own1 = word(w, mine + 1);
            const uint32_t got0 =
                __shfl_xor_sync(0xffffffffu, word(w, theirs), 1);
            const uint32_t got1 =
                __shfl_xor_sync(0xffffffffu, word(w, theirs + 1), 1);
            // element e: row half e / 2, key 8 j + 2 t + e % 2
            const uint32_t bits[4] = {(t & 1) ? got0 : own0,
                                      (t & 1) ? got1 : own1,
                                      (t & 1) ? own0 : got0,
                                      (t & 1) ? own1 : got1};
#pragma unroll
            for (int e = 0; e < 4; ++e)
              s[j][e] = bits[e] >= a.threshold
                            ? (kScaleP ? s[j][e] * a.inv : s[j][e])
                            : 0.f;
          }
        }
        // o += p v, p rounded to bf16 in the A fragments
#pragma unroll
        for (int kk = 0; kk < kKT / 16; ++kk) {
          uint32_t pa[4];
          pa[0] = pack_bf16x2(s[2 * kk][0], s[2 * kk][1]);
          pa[1] = pack_bf16x2(s[2 * kk][2], s[2 * kk][3]);
          pa[2] = pack_bf16x2(s[2 * kk + 1][0], s[2 * kk + 1][1]);
          pa[3] = pack_bf16x2(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
          for (int n = 0; n < kDTiles; n += 2)
            if (8 * n < dh) {
              uint32_t bb[4];
              flash::load_b_pair_trans(bb, v_s, ld, kk, n, lane);
              mma_16816(o[n], pa, bb[0], bb[1]);
              mma_16816(o[n + 1], pa, bb[2], bb[3]);
            }
        }
      }
    }
    __syncthreads();  // this stage is consumed
  }

  if (!busy) return;
  // o out through the warp's own 16 rows of the q tile (read only at the
  // start), then 16 bytes a store
  const float f = kDropout && !kScaleP ? a.inv : 1.f;
  bf16* o_s = q_s + 16 * warp * ld;
#pragma unroll
  for (int n = 0; n < kDTiles; ++n)
    if (8 * n < dh) {
#pragma unroll
      for (int half = 0; half < 2; ++half)
        *reinterpret_cast<uint32_t*>(o_s + (g + 8 * half) * ld + 8 * n +
                                     2 * t) =
            pack_bf16x2(o[n][2 * half] * f, o[n][2 * half + 1] * f);
    }
  __syncwarp();
  bf16* ob = static_cast<bf16*>(a.o) + b * a.o_sb + h * a.o_sh;
  const int vecs = dh >> 3;
  for (int i = lane; i < 16 * vecs; i += 32) {
    const int r = i / vecs, c = (i - r * vecs) << 3;
    const int qi = q0 + 16 * warp + r;
    if (qi < sq)
      *reinterpret_cast<uint4*>(ob + qi * a.o_ss + c) =
          *reinterpret_cast<const uint4*>(o_s + r * ld + c);
  }
}

template <bool kDropout, bool kScaleP, int kMaxDh, bool kExact>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  const size_t smem = smem_bytes(a.dh);
  auto kernel =
      packed_attention_fwd_mma_kernel<kDropout, kScaleP, kMaxDh, kExact>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((a.sq + kRows - 1) / kRows, a.h, a.b);
  kernel<<<grid, kThreadsTc, smem, stream>>>(a);
  return cudaGetLastError();
}

// Dh 64 and 128 exact; other multiples of 16 below 128 take the general
// Dh <= 128 kernel
template <bool kDropout, bool kScaleP>
cudaError_t dispatch_dh(const Args& a, cudaStream_t stream) {
  if (a.dh == 64) return launch<kDropout, kScaleP, 64, true>(a, stream);
  if (a.dh == 128) return launch<kDropout, kScaleP, 128, true>(a, stream);
  return launch<kDropout, kScaleP, 128, false>(a, stream);
}

}  // namespace tc

// dtype: 0 = float32, 1 = bfloat16; design: 0 = CUDA cores (any shape), 1 =
// tensor cores (bf16 where tc_fits holds for q, k, v and o and their batch,
// head and row strides, and Sq, Sk <= tc::kMaxSeq; refused otherwise);
// dropout when a.threshold != 0
template <bool kScaleP>
cudaError_t dispatch(int dtype, int design, const Args& a,
                     cudaStream_t stream) {
  const bool dropout = a.threshold != 0u;
  if (a.dh < 1 || a.dh > kMaxDh || (design != 0 && design != 1))
    return cudaErrorInvalidValue;
  if (design == 1) {
    const void* ptrs[4] = {a.q, a.k, a.v, a.o};
    const long long st[12] = {a.q_sb, a.q_sh, a.q_ss, a.k_sb, a.k_sh, a.k_ss,
                              a.v_sb, a.v_sh, a.v_ss, a.o_sb, a.o_sh, a.o_ss};
    if (dtype != 1 || a.sq > tc::kMaxSeq || a.sk > tc::kMaxSeq ||
        !flash::tc_fits(a.dh, ptrs, 4, st, 12))
      return cudaErrorInvalidValue;
    return dropout ? tc::dispatch_dh<true, kScaleP>(a, stream)
                   : tc::dispatch_dh<false, kScaleP>(a, stream);
  }
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
