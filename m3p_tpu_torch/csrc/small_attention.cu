// Head-major attention forward and backward for Hopper (sm_90a).
//
// Replaces m3p_tpu/ops/attention.py::_small_fwd_kernel (:696, reached
// through small_attention) and _small_bwd_kernel (:713, through
// small_attention_bwd and the custom vjp _attention_pallas_small):
// single-tile attention on (B, H, S, Dh) tensors, Sq, Sk <= 512, with a key
// mask, the end-aligned causal triangle and Philox attention-weight dropout
// keyed by tile b * H + h (the mask the packed kernels draw for that batch
// and head).  The tile code is packed_tile.cuh's and packed_tile_bwd.cuh's,
// with head stride S * Dh and row stride Dh, and with inv = 1 / (1 - rate)
// inside the rounded operands, as the Pallas kernels do:
//
//     forward:   p  = softmax(...) in fp32;  o = round(keep ? p.inv : 0) . v
//     backward:  pd = keep ? p.inv : 0       dpd = keep ? dp.inv : 0
//                r  = rowsum(p.dpd)          ds = p . (dpd - r)
//                dv = round(pd)^T dO   dk = scale round(ds)^T q
//                dq = scale round(ds) k
//
// Bound: device memory.  At the flagship joint shape (B = 80, H = 12,
// S = 164, Dh = 64, bf16) the forward moves q, k, v and o, 80.6 MB, 24 us
// at 3.35 TB/s (6.6 GFLOP, 7 us at 989 TF/s); the backward moves q, k, v,
// dO, dq, dk, dv, 141 MB, 42 us (16.5 GFLOP, 17 us).  Both directions have
// two designs (packed_tile.cuh, packed_tile_bwd.cuh): bf16 on the tensor
// cores (mma.sync, cp.async), CUDA cores otherwise.  wgmma, TMA and a
// single forward pass at small Sk are left for later work.

#include "packed_tile.cuh"
#include "packed_tile_bwd.cuh"

// dtype: 0 = float32, 1 = bfloat16.  design: 0 = CUDA cores (any shape),
// 1 = tensor cores (refused outside the rule of packed_tile.cuh's
// dispatch).  q/o (B, H, Sq, Dh), k/v (B, H, Sk, Dh) with the batch, head
// and row strides given in elements (the last dimension contiguous).
// kv_mask: (B, Sk) bytes, 1 = attend, or null.  Dropout: threshold 0 =
// off; otherwise a weight is kept when its Philox word under `seed` is >=
// threshold, and inv = 1 / (1 - rate).  Returns the cudaError_t of the
// launch (0 on success).
extern "C" int m3p_small_attention_fwd(
    int dtype, int design, const void* q, const void* k, const void* v,
    const void* kv_mask, void* o, int b, int sq, int sk, int h, int dh,
    long long q_sb, long long q_sh, long long q_ss, long long k_sb,
    long long k_sh, long long k_ss, long long v_sb, long long v_sh,
    long long v_ss, long long o_sb, long long o_sh, long long o_ss,
    float scale, int causal, float inv, unsigned int threshold,
    unsigned long long seed, int head_base, int heads_total, void* stream) {
  const m3p::tile_fwd::Args a{q, k, v, static_cast<const uint8_t*>(kv_mask),
                              o, b, sq, sk, h, dh,
                              q_sb, q_sh, q_ss, k_sb, k_sh, k_ss,
                              v_sb, v_sh, v_ss, o_sb, o_sh, o_ss,
                              scale, causal, inv, threshold, seed,
                              head_base, heads_total};
  return static_cast<int>(m3p::tile_fwd::dispatch<true>(
      dtype, design, a, static_cast<cudaStream_t>(stream)));
}

// design: 0 = CUDA cores (any shape), 1 = tensor cores (refused outside
// the rule of packed_tile_bwd.cuh's dispatch).  phase: 0 = dq and the row
// statistics, 1 = dk and dv (reads the statistics; launch after phase 0 of
// the same design on one stream).  stats: (B, H, Sq, 3) fp32 scratch.
// bits: with dropout on the tensor cores, a (B, H, Sq, ceil(Sk / 32))
// 32-bit scratch, else null.  strides: the batch, head and row strides of
// q, k, v, dO, dq, dk and dv, in that order (21 values).  Otherwise as the
// forward.
extern "C" int m3p_small_attention_bwd(
    int dtype, int design, int phase, const void* q, const void* k,
    const void* v, const void* kv_mask, const void* dout, void* dq, void* dk,
    void* dv, void* stats, void* bits, int b, int sq, int sk, int h, int dh,
    const long long* strides, float scale, int causal, float inv,
    unsigned int threshold, unsigned long long seed, int head_base,
    int heads_total, void* stream) {
  long long st[21];
  for (int i = 0; i < 21; ++i) st[i] = strides[i];
  return static_cast<int>(m3p::tile_bwd::dispatch<true>(
      dtype, design, phase, q, k, v, kv_mask, dout, dq, dk, dv, stats, bits,
      b, sq, sk, h, dh, st, scale, causal, inv, threshold, seed, head_base,
      heads_total, static_cast<cudaStream_t>(stream)));
}
