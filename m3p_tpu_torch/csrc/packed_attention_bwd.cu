// Packed-layout attention backward for Hopper (sm_90a).
//
// Replaces m3p_tpu/ops/attention.py::_packed_bwd_kernel (reached through
// small_attention_packed_bwd), the backward of packed_attention.cu: the
// single-tile backward of packed_tile_bwd.cuh on the column slice
// h*Dh:(h+1)*Dh of the (B, S, H*Dh) layout (head stride Dh), with inv
// = 1 / (1 - rate) applied after the products, as the Pallas kernel does:
//
//     r  = rowsum(keep.p.dp)                  ds = p . (keep.dp - r)
//     dv = inv * (keep.p)^T dO
//     dk = scale * inv * ds^T q               dq = scale * inv * ds k
//
// Bound: at the training shapes (B = 80, S = 164, H*Dh = 768, bf16) q, k,
// v, dO in and dq, dk, dv out are 141 MB, 42 us at 3.35 TB/s, against
// 16.5 GFLOP, 17 us at 989 TF/s.  The two designs (bf16 on the tensor
// cores, CUDA cores otherwise) are packed_tile_bwd.cuh's.

#include "packed_tile_bwd.cuh"

// dtype: 0 = float32, 1 = bfloat16.  design: 0 = CUDA cores (any shape),
// 1 = tensor cores (refused outside the rule of packed_tile_bwd.cuh's
// dispatch).  phase: 0 = dq and the row statistics, 1 = dk and dv (reads
// the statistics; launch after phase 0 of the same design on one stream).
// kv_mask: (B, Sk) bytes, 1 = attend, or null.  stats: (B, H, Sq, 3) fp32
// scratch.  bits: with dropout on the tensor cores, a (B, H, Sq,
// ceil(Sk / 32)) 32-bit scratch, else null.  Strides are in elements; the
// last dimension is contiguous.  Dropout: threshold 0 = off, else as
// m3p_packed_attention_fwd.  Returns the cudaError_t of the launch (0 on
// success).
extern "C" int m3p_packed_attention_bwd(
    int dtype, int design, int phase, const void* q, const void* k,
    const void* v, const void* kv_mask, const void* dout, void* dq, void* dk,
    void* dv, void* stats, void* bits, int b, int sq, int sk, int h, int dh,
    long long q_sb, long long q_ss, long long k_sb, long long k_ss,
    long long v_sb, long long v_ss, long long do_sb, long long do_ss,
    long long dq_sb, long long dq_ss, long long dk_sb, long long dk_ss,
    long long dv_sb, long long dv_ss, float scale, int causal, float inv,
    unsigned int threshold, unsigned long long seed, int head_base,
    int heads_total, void* stream) {
  // the packed layout: head h is the column slice h*Dh:(h+1)*Dh
  const long long st[21] = {q_sb,  dh, q_ss,  k_sb,  dh, k_ss,
                            v_sb,  dh, v_ss,  do_sb, dh, do_ss,
                            dq_sb, dh, dq_ss, dk_sb, dh, dk_ss,
                            dv_sb, dh, dv_ss};
  return static_cast<int>(m3p::tile_bwd::dispatch<false>(
      dtype, design, phase, q, k, v, kv_mask, dout, dq, dk, dv, stats, bits,
      b, sq, sk, h, dh, st, scale, causal, inv, threshold, seed, head_base,
      heads_total, static_cast<cudaStream_t>(stream)));
}

#ifdef M3P_SCORE_DUMP
// The debug build's entry (nvcc -DM3P_SCORE_DUMP; the `gpu` test of
// tests/test_torch_kernels.py that compares the two phases' scores): bf16
// on the tensor cores at Dh 64 without dropout, the arguments of
// m3p_packed_attention_bwd less design, dropout and bits; each phase writes
// the scores q.k and the p it computes to ``scores`` (4, B, H, Sq, Sk) fp32:
// slots 0 and 1 the scores of phases 0 and 1 at every (query, key) in range,
// slots 2 and 3 their p where the pair is attended.
extern "C" int m3p_packed_attention_bwd_scores(
    int phase, const void* q, const void* k, const void* v,
    const void* kv_mask, const void* dout, void* dq, void* dk, void* dv,
    void* stats, int b, int sq, int sk, int h, int dh, long long q_sb,
    long long q_ss, long long k_sb, long long k_ss, long long v_sb,
    long long v_ss, long long do_sb, long long do_ss, long long dq_sb,
    long long dq_ss, long long dk_sb, long long dk_ss, long long dv_sb,
    long long dv_ss, float scale, int causal, float* scores, void* stream) {
  const long long st[21] = {q_sb,  dh, q_ss,  k_sb,  dh, k_ss,
                            v_sb,  dh, v_ss,  do_sb, dh, do_ss,
                            dq_sb, dh, dq_ss, dk_sb, dh, dk_ss,
                            dv_sb, dh, dv_ss};
  return static_cast<int>(m3p::tile_bwd::dump_scores<false>(
      phase, q, k, v, kv_mask, dout, dq, dk, dv, stats, b, sq, sk, h, dh, st,
      scale, causal, scores, static_cast<cudaStream_t>(stream)));
}
#endif
