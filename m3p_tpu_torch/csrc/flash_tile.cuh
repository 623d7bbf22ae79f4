// Tile helpers shared by the flash-attention forward and backward kernels
// (flash_attention.cu, flash_attention_bwd.cu), sm_90a; the tensor-core
// designs of the single-tile forward and backward (packed_tile.cuh,
// packed_tile_bwd.cuh) take their rule (tc_fits), their cp.async tile
// loads, fragment loads and quad reductions from here too.
//
// Each of the two files holds two designs of its kernel, and its C entry
// point launches the one the caller names: bf16 on the tensor cores
// (mma.sync, mma.cuh) where `tc_fits` holds, and on CUDA cores, fp32 and
// bf16 at any shape.  Below, the CUDA-core design's tile: a block works
// on 64 x 64 (query x key) tiles with 256 threads laid out 16 x 16: thread
// (ty, tx) = (tid / 16, tid % 16) owns query rows ty + 16 i and keys (or
// head-dim columns) tx + 16 j, i, j < 4.  Operand tiles sit in shared
// memory as fp32 with an odd row pitch (dh + 1), so the 16 lanes that read
// one column of 16 different rows hit 16 banks.

#pragma once

#include <cfloat>
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "mma.cuh"
#include "philox.cuh"

namespace m3p {
namespace flash {

constexpr int kThreads = 256;
constexpr int kTile = 64;             // query rows and keys of a tile
constexpr int kSub = 16;              // threads along each tile side
constexpr int kPer = kTile / kSub;    // rows (keys) a thread owns: 4
constexpr int kPitch = kTile + 1;     // row pitch of a (64, 64) fp32 tile
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

// x rounded to T and back: the operand of a product in the input type
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

// max and sum over the quad of lanes that hold one row of an mma.sync C
// fragment (lanes 4 g .. 4 g + 3)
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// rows [row0, row0 + n) of a (S, H*Dh) slab (row stride `stride`, head
// columns at src) into an fp32 (kTile, ld) tile; rows n .. kTile are zero
template <typename T>
__device__ void load_rows(float* dst, const T* src, long long stride,
                          int row0, int n, int dh, int ld) {
  for (int i = threadIdx.x; i < kTile * dh; i += kThreads) {
    const int r = i / dh, d = i - r * dh;
    dst[r * ld + d] = r < n ? to_f(src[(row0 + r) * stride + d]) : 0.f;
  }
}

// does query qi attend to key kj (key mask and end-aligned causal triangle)
__device__ __forceinline__ bool attends(const uint8_t* mb, int causal, int kj,
                                        int qi, int q_offset) {
  return (mb == nullptr || mb[kj] != 0) && !(causal && kj > qi + q_offset);
}

// acc[i][j] = a_s[row ty + 16 i] . b_s[row tx + 16 j] over d < dh, an fmaf
// chain in d order (the forward and both backward passes score a (query,
// key) pair with the same chain, so they see bitwise the same score)
__device__ __forceinline__ void tile_dots(const float* a_s, const float* b_s,
                                          int ld, int dh,
                                          float (&acc)[kPer][kPer]) {
  const int tx = threadIdx.x % kSub, ty = threadIdx.x / kSub;
#pragma unroll
  for (int i = 0; i < kPer; ++i)
#pragma unroll
    for (int j = 0; j < kPer; ++j) acc[i][j] = 0.f;
  for (int d = 0; d < dh; ++d) {
    float a[kPer], b[kPer];
#pragma unroll
    for (int i = 0; i < kPer; ++i) a[i] = a_s[(ty + kSub * i) * ld + d];
#pragma unroll
    for (int j = 0; j < kPer; ++j) b[j] = b_s[(tx + kSub * j) * ld + d];
#pragma unroll
    for (int i = 0; i < kPer; ++i)
#pragma unroll
      for (int j = 0; j < kPer; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
  }
}

// keep_s[r * kCols + c] = Philox keep bit of (row q0 + r, key k0 + c) in
// `tile`, for the whole kRows x kCols tile (k0 is a multiple of 4)
template <int kRows = kTile, int kCols = kTile>
__device__ void fill_keep(uint8_t* keep_s, unsigned long long seed,
                          uint32_t threshold, int tile, int q0, int k0) {
  constexpr int kGroups = kCols / 4;
  for (int i = threadIdx.x; i < kRows * kGroups; i += kThreads) {
    const int r = i / kGroups, g = i - r * kGroups;
    const uint4 bits = keep_bits(seed, tile, q0 + r, k0 / 4 + g);
    uint8_t* out = keep_s + r * kCols + 4 * g;
    out[0] = bits.x >= threshold;
    out[1] = bits.y >= threshold;
    out[2] = bits.z >= threshold;
    out[3] = bits.w >= threshold;
  }
}

// rows [row0, row0 + n) of a (S, H*Dh) bf16 slab (row stride `stride`,
// head columns at src) into a (kRows, ld) shared tile, one 16-byte cp.async
// per 8 columns, by the kBlockThreads threads of the block; rows n .. kRows
// are zero-filled.  The caller commits.
template <int kRows, int kBlockThreads = kThreads>
__device__ __forceinline__ void load_tile_async(__nv_bfloat16* dst, int ld,
                                                const __nv_bfloat16* src,
                                                long long stride, int row0,
                                                int n, int dh) {
  const int vecs = dh >> 3;
  for (int i = threadIdx.x; i < kRows * vecs; i += kBlockThreads) {
    const int r = i / vecs, c = (i - r * vecs) << 3;
    const bool in = r < n;
    mma::cp_async_16(dst + r * ld + c,
                     in ? src + (row0 + r) * stride + c : src, in);
  }
}

// Whether all kTile keys from k0 are attended by every query row at or
// after r0, given limit = r0 + Sk - Sq (the causal diagonal of row r0): a
// full tile (kn == kTile), no masked key, no key past that diagonal.
// Warp-uniform: each lane reads kTile / 32 mask bytes, then a vote.
__device__ __forceinline__ bool whole_tile(const uint8_t* mb, int causal,
                                           int k0, int kn, int limit,
                                           int lane) {
  bool whole = kn == kTile && !(causal && k0 + kTile - 1 > limit);
  if (whole && mb != nullptr) {
#pragma unroll
    for (int i = 0; i < kTile / 32; ++i)
      whole = whole && mb[k0 + lane + 32 * i] != 0;
  }
  return __all_sync(0xffffffffu, whole);
}

// the A fragment of rows 16 w .. 16 w + 15, columns 16 ds .. of a shared
// (rows, ld) tile
__device__ __forceinline__ void load_a_frag(uint32_t (&a)[4],
                                            const __nv_bfloat16* s, int ld,
                                            int warp, int ds, int lane) {
  mma::ldmatrix_x4(a, s + (16 * warp + (lane & 15)) * ld + 16 * ds +
                          (lane >> 4) * 8);
}

// the B fragments of rows 8 j .. 8 j + 15 (two n-tiles), columns 16 ds ..
// (the k side) of a shared (rows, ld) tile: b[0], b[1] of n-tile j, b[2],
// b[3] of n-tile j + 1
__device__ __forceinline__ void load_b_pair(uint32_t (&b)[4],
                                            const __nv_bfloat16* s, int ld,
                                            int j, int ds, int lane) {
  mma::ldmatrix_x4(b, s + (8 * j + (lane & 7) + (lane >> 4) * 8) * ld +
                          16 * ds + ((lane >> 3) & 1) * 8);
}

// the B fragments of rows 16 kk .. 16 kk + 15 (the k side), columns 8 n ..
// 8 n + 15 (two n-tiles) of a shared (rows, ld) tile
__device__ __forceinline__ void load_b_pair_trans(uint32_t (&b)[4],
                                                  const __nv_bfloat16* s,
                                                  int ld, int kk, int n,
                                                  int lane) {
  mma::ldmatrix_x4_trans(b, s + (16 * kk + (lane & 15)) * ld + 8 * n +
                                (lane >> 4) * 8);
}

// The tensor-core design takes bf16 tensors whose head dim is a multiple of
// 16 up to 128, whose base pointers are 16-byte aligned and whose strides
// (batch and row; head too in the head-major layout) are multiples of 8
// elements, so that every head's row starts on 16 bytes (cp.async,
// ldmatrix).  ops/attention.py::_tensor_cores_fit applies the same rule to
// choose the design (_flash_design, _packed_design, _small_design); the C
// entry points refuse a tensor-core launch that breaks it.
inline bool tc_fits(int dh, const void* const* ptrs, int n_ptrs,
                    const long long* strides, int n_strides) {
  if (dh < 1 || dh > 128 || dh % 16 != 0) return false;
  for (int i = 0; i < n_ptrs; ++i)
    if (reinterpret_cast<uintptr_t>(ptrs[i]) % 16 != 0) return false;
  for (int i = 0; i < n_strides; ++i)
    if (strides[i] % 8 != 0) return false;
  return true;
}

}  // namespace flash
}  // namespace m3p
