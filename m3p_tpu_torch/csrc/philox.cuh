// Philox4x32-10 for the port's kernels (sm_90a).
//
// The same generator as m3p_tpu_torch/ops/philox.py, which documents the
// mask rule: key (seed_lo, seed_hi), counter (col / 4, row, tile, 0),
// element (row, col) takes word col % 4, and is kept when its word is at or
// above the threshold uint32(min(rate * 2^32, 2^32 - 1)).  The bits depend on
// (seed, tile, row, col) only, so the forward, the backward and the plain
// version all draw the same mask.  The fused residual dropout keys its mask
// by the flat element index instead (flat_bits below).

#pragma once

#include <cstdint>

namespace m3p {

__device__ __forceinline__ uint4 philox4x32_10(uint4 c, uint32_t k0,
                                               uint32_t k1) {
#pragma unroll
  for (int i = 0; i < 10; ++i) {
    const uint32_t lo0 = 0xD2511F53u * c.x;
    const uint32_t hi0 = __umulhi(0xD2511F53u, c.x);
    const uint32_t lo1 = 0xCD9E8D57u * c.z;
    const uint32_t hi1 = __umulhi(0xCD9E8D57u, c.z);
    c = make_uint4(hi1 ^ c.y ^ k0, lo1, hi0 ^ c.w ^ k1, lo0);
    k0 += 0x9E3779B9u;
    k1 += 0xBB67AE85u;
  }
  return c;
}

// The Philox tile of batch b, local head h of a call over the heads
// head_base .. head_base + H - 1 of a tensor with heads_total heads (a
// tensor-parallel rank holds a slice of the heads): b * heads_total +
// head_base + h, the tile the whole tensor's call gives that head.  A call
// over every head passes head_base 0 and heads_total H.
__device__ __forceinline__ int philox_tile(int b, int h, int head_base,
                                           int heads_total) {
  return b * heads_total + head_base + h;
}

// The four words for columns 4 * col4 .. 4 * col4 + 3 of `row` in `tile`.
__device__ __forceinline__ uint4 keep_bits(unsigned long long seed, int tile,
                                           int row, int col4) {
  return philox4x32_10(
      make_uint4(static_cast<uint32_t>(col4), static_cast<uint32_t>(row),
                 static_cast<uint32_t>(tile), 0u),
      static_cast<uint32_t>(seed), static_cast<uint32_t>(seed >> 32));
}

// The four words for the flat elements 4 * group .. 4 * group + 3 of the
// elementwise mask (the fused residual dropout; keep_mask_flat in
// m3p_tpu_torch/ops/philox.py): counter (group lo, group hi, 0, 0).
__device__ __forceinline__ uint4 flat_bits(unsigned long long seed,
                                           unsigned long long group) {
  return philox4x32_10(
      make_uint4(static_cast<uint32_t>(group),
                 static_cast<uint32_t>(group >> 32), 0u, 0u),
      static_cast<uint32_t>(seed), static_cast<uint32_t>(seed >> 32));
}

__device__ __forceinline__ uint32_t word(const uint4& w, int i) {
  return i == 0 ? w.x : i == 1 ? w.y : i == 2 ? w.z : w.w;
}

}  // namespace m3p
