// Warp-level tensor-core, asynchronous-copy and cluster helpers shared by
// the port's tensor-core kernels (fused_ffn.cu, flash_attention.cu,
// flash_attention_bwd.cu, packed_tile*.cuh), sm_90a.
//
// Fragments follow the PTX layouts of mma.sync m16n8k16 with bf16 operands
// and fp32 sums.  With g = lane / 4 and t = lane % 4:
//   A (m 16 x k 16, row): a[0] (row g, k 2t, 2t + 1), a[1] (row g + 8, the
//     same k), a[2] (row g, k 2t + 8, 2t + 9), a[3] (row g + 8, k 2t + 8..);
//   B (k 16 x n 8, col):  b0 (k 2t, 2t + 1, n g), b1 (k 2t + 8, 2t + 9, n g);
//   C (m 16 x n 8):       c[0], c[1] (row g, n 2t, 2t + 1), c[2], c[3]
//                         (row g + 8, the same n).
// So the C fragments of two neighbouring n-tiles, rounded and packed in
// pairs, are the A fragment of a product over those 16 columns.
//
// Every function here is a warp-wide instruction, a copy or a cluster
// primitive; this header is the one place the kernels reach the hardware's
// matrix, async-copy and cluster units, so a CPU emulation of the kernels
// replaces it alone.

#pragma once

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace m3p {
namespace mma {

// d += a . b (m16n8k16, bf16 operands, fp32 sums)
__device__ __forceinline__ void mma_16816(float (&d)[4],
                                          const uint32_t (&a)[4],
                                          uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// the B fragment (k 16 x n 8) of a row-major (k, n) shared tile: lane l < 16
// points at row l, column 0 of the tile
__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t& b0, uint32_t& b1,
                                                  const __nv_bfloat16* p) {
  const uint32_t addr = smem_addr(p);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
      : "=r"(b0), "=r"(b1)
      : "r"(addr));
}

// four 8 x 8 matrices; lane 8 i + r points at row r of matrix i.  The A
// fragment (m 16 x k 16) of a row-major (m, k) tile of pitch ld: lane l
// points at row l % 16, column 8 (l / 16).  The B fragments of two
// neighbouring n-tiles of a row-major (n, k) tile: lane l points at row
// l % 8 + 8 (l / 16), column 8 (l / 8 % 2); r[0], r[1] are the first
// n-tile's b0, b1, r[2], r[3] the second's
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4],
                                            const __nv_bfloat16* p) {
  const uint32_t addr = smem_addr(p);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// the B fragments (k 16 x n 8) of two neighbouring n-tiles of a row-major
// (k, n) shared tile: lane l points at row l % 16, column 8 (l / 16); r[0],
// r[1] are the first n-tile's b0, b1, r[2], r[3] the second's
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const __nv_bfloat16* p) {
  const uint32_t addr = smem_addr(p);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// the A fragment (m 16 x k 16) at s of a row-major shared tile of pitch ld
__device__ __forceinline__ void load_a(uint32_t (&a)[4],
                                       const __nv_bfloat16* s, int ld,
                                       int lane) {
  const __nv_bfloat16* p = s + (lane >> 2) * ld + 2 * (lane & 3);
  a[0] = *reinterpret_cast<const uint32_t*>(p);
  a[1] = *reinterpret_cast<const uint32_t*>(p + 8 * ld);
  a[2] = *reinterpret_cast<const uint32_t*>(p + 8);
  a[3] = *reinterpret_cast<const uint32_t*>(p + 8 * ld + 8);
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16(lo))) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16(hi)))
          << 16);
}

// 16 bytes from global src to shared dst (both 16-byte aligned), through
// L2 only; zeros when !valid (src is then not read)
__device__ __forceinline__ void cp_async_16(void* dst, const void* src,
                                            bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :
               : "r"(smem_addr(dst)), "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

// 4 bytes from global src to shared dst (both 4-byte aligned), through L1
// and L2; zeros when !valid (src is then not read)
__device__ __forceinline__ void cp_async_4(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :
               : "r"(smem_addr(dst)), "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

// close the group of this thread's copies issued since the last commit
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" : : : "memory");
}

// wait until at most kPending of this thread's committed groups are in
// flight (a __syncthreads then shows every thread's copies to the block)
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" : : "n"(kPending) : "memory");
}

// ---- thread block clusters (fused_ffn.cu's cluster design) ----

// this block's rank in its cluster
__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

// the address of p (in this block's shared memory) in the shared memory of
// the cluster's block `rank`, usable by generic loads and stores
template <typename T>
__device__ __forceinline__ T* map_rank(T* p, uint32_t rank) {
  uint64_t out;
  asm volatile("mapa.u64 %0, %1, %2;\n"
               : "=l"(out)
               : "l"(reinterpret_cast<uint64_t>(p)), "r"(rank));
  return reinterpret_cast<T*>(out);
}

// the split cluster barrier: every thread of every block of the cluster
// arrives (releasing its earlier stores, to shared memory of any block of
// the cluster included) and later waits (acquiring the others'); a thread
// alternates the two
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" : : : "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" : : : "memory");
}

}  // namespace mma
}  // namespace m3p
