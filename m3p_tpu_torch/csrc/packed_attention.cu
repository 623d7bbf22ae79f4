// Packed-layout attention forward for Hopper (sm_90a).
//
// Replaces m3p_tpu/ops/attention.py::_packed_fwd_kernel (:1016, reached
// through small_attention_packed).  Per head h, a column slice
// h*Dh:(h+1)*Dh of the (B, S, H*Dh) projections, the single-tile attention
// of packed_tile.cuh: q/k/v are read in the projection layout through the
// row and batch strides passed in (head stride Dh), and o is written in the
// same layout, so there is no head transpose.  With attention-weight
// dropout the output is scaled by inv = 1 / (1 - rate) in the epilogue, as
// the Pallas kernel does.
//
// Bound: device memory.  At the serving shapes (B = 64, Sq = Sk = 164,
// H*Dh = 768, bf16) q, k, v and o are 64.5 MB, 19.3 us at 3.35 TB/s, against
// 5.3 GFLOP, 5.3 us at 989 TF/s; at the training shapes (B = 80) 80.6 MB,
// 24 us; the refiner (S = 100) moves 39.3 MB, 11.7 us at B = 64.  The two
// designs are packed_tile.cuh's: bf16 on the tensor cores (mma.sync,
// cp.async; the model's paths), CUDA cores otherwise.  wgmma, TMA and a
// single pass at small Sk are left for later work.

#include "packed_tile.cuh"

// dtype: 0 = float32, 1 = bfloat16.  design: 0 = CUDA cores (any shape),
// 1 = tensor cores (refused outside the rule of packed_tile.cuh's
// dispatch).  kv_mask: (B, Sk) bytes, 1 = attend, or null.  Strides are in
// elements; the last dimension is contiguous.  Dropout: threshold 0 = off;
// otherwise a weight is kept when its Philox word under `seed` is >=
// threshold, and inv = 1 / (1 - rate).  Returns the cudaError_t of the
// launch (0 on success).
extern "C" int m3p_packed_attention_fwd(
    int dtype, int design, const void* q, const void* k, const void* v,
    const void* kv_mask, void* o, int b, int sq, int sk, int h, int dh,
    long long q_sb, long long q_ss, long long k_sb, long long k_ss,
    long long v_sb, long long v_ss, long long o_sb, long long o_ss,
    float scale, int causal, float inv, unsigned int threshold,
    unsigned long long seed, int head_base, int heads_total, void* stream) {
  // the packed layout: head h is the column slice h*Dh:(h+1)*Dh
  const m3p::tile_fwd::Args a{q, k, v, static_cast<const uint8_t*>(kv_mask),
                              o, b, sq, sk, h, dh,
                              q_sb, dh, q_ss, k_sb, dh, k_ss,
                              v_sb, dh, v_ss, o_sb, dh, o_ss,
                              scale, causal, inv, threshold, seed,
                              head_base, heads_total};
  return static_cast<int>(m3p::tile_fwd::dispatch<false>(
      dtype, design, a, static_cast<cudaStream_t>(stream)));
}
