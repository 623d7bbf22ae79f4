// Fused encoder FFN + LayerNorm forward for Hopper (sm_90a).
//
// Replaces m3p_tpu/ops/fused_ffn.py::_kernel (reached through
// fused_ffn_ln).  Per row of x (M, D), with W1 (D, H) and W2 (H, D):
//
//     h   = gelu_erf(x W1 + b1)            fp32 sums, then rounded to T
//     y   = h W2 + b2 + x                  fp32 sums
//     out = (y - mean) * rsqrt(var + eps) * gamma + beta, rounded to T
//
// with a two-pass fp32 mean and variance over the row, as the Pallas kernel
// computes them.  The (M, H) hidden never reaches device memory.
//
// Bound: operations.  At the fused FFN tool's shape (M = 13120, D = 768,
// H = 3072, bf16) the two products are 4 M D H = 123.8 GFLOP, 0.125 ms at
// 989 TF/s, against 49.7 MB of x, out, W1 and W2, 0.015 ms at 3.35 TB/s;
// in fp32 the same work is 1.85 ms at the 67 TF/s of the CUDA cores.
// W1 and W2 (9.4 MB in bf16) cannot stay on chip, so each row tile reads
// them again (from L2); the row tile sets how many bytes a product needs.
//
// Three designs; ops/fused_ffn.py::_ffn_design names the one a call takes
// and the C entry refuses a design outside its rule.  All three walk H in
// chunks of 64 hidden units: A, the hidden chunk = x . W1[:, chunk], then
// b1, GELU (erff) and the rounding to T; B, acc += hidden chunk .
// W2[chunk, :], the fp32 accumulator in registers.
//
// "cluster" (bf16, D % 128 == 0, D <= 768, H % 64 == 0, x, W1, W2 and out
// 16-byte aligned; namespace cl): a thread block cluster of two blocks on
// neighbouring SMs per 64-row tile.  Block rank r owns the output columns
// [r D / 2, (r + 1) D / 2), so each keeps a (64, D / 2) fp32 accumulator
// (96 registers a thread at D = 768), and computes hidden units
// [32 r, 32 r + 32) of each chunk from the W1 columns it alone reads; it
// stores its half of the rounded hidden chunk into both blocks' shared
// memory (distributed shared memory), and a split cluster barrier
// (arrive after A(c), wait after B(c - 1)) hands each block its peer's
// half.  W1 and W2 stream through two cp.async stages ((384, 32) of W1
// and the chunk's (64, D / 2) of W2: 30 and 49 KB at D = 768), one
// __syncthreads a stage, the next stage in flight while one multiplies.
// Stages are as large as shared memory allows: each costs a block barrier
// and the wait for its load; smaller stages in a deeper ring ran slower
// on the H100 (python -m m3p_tpu_torch.probe_fused_ffn times them).  One
// tile's W1 and W2 are read once between the two blocks: 1.93 GB at the
// tool's shape (205 tiles x 9.44 MB, a count), half of "tile32"'s.  The
// epilogue exchanges each row's two partial sums (mean, then squared
// deviations) with the peer.  x (97 KB) and the two stages (98 KB) fill
// the block's shared memory (230,400 bytes at D = 768), so D stops at 768.
//
// "tile32" (bf16, D % 64 == 0, H % 8 == 0, 16-byte aligned x, W1, W2, out
// 4-byte aligned; namespace tc): one block of 256 threads per 32-row tile;
// each chunk of W1 (D, 64) and then of W2 (64, D) comes into shared memory
// whole, four 16-byte loads in flight per thread.  x and the hidden chunk
// are A fragments read from row-major shared tiles, W1 and W2 B fragments
// loaded with ldmatrix.trans from their row-major (k, n) tiles; warp w
// computes hidden units 8w .. 8w + 7 in A and owns four 8-column n-tiles
// of every 256 columns in B.  Each block reads W1 and W2 whole, 3.9 GB
// over the tool's 410 blocks.  Rows padded by 8 bf16 keep the fragment
// loads free of bank conflicts in both tensor-core designs.
//
// "cuda_cores" (fp32, and bf16 outside both rules) runs in fp32 on CUDA
// cores: no TF32, so fp32 keeps its parity with the plain version.  x sits
// in shared memory in fp32, transposed (D, 32); W1 comes in (64, 64)
// slices and W2 in (64, 256) slabs; warp w owns rows 4w .. 4w + 3: in A
// lane l computes hidden units l and l + 32, one broadcast float4 of x and
// two loads of W1 feeding 8 FMAs; in B lane l owns the columns l + 32 c,
// one broadcast float4 of the hidden and 8 loads of W2 feeding 32 FMAs;
// each row's D sums lie in one warp for the epilogue.
//
// "cluster" runs at 9x its bound and 6x its time at the mma.sync ceiling;
// without its W1/W2 loads it still takes 71 % of its time, so the
// products' own path binds first (PERF.md sections 6 and 7).
// wgmma (operands read from shared memory by the tensor cores), TMA and
// multicast over a 2 x 2 cluster (fewer passes over W1 and W2) are left for
// later work.
//
// Registers (nvcc -Xptxas -v, sm_90a), no spills: "cluster" 110, 103,
// 129, 139, 160, 175 at D = 128 .. 768; "tile32" 96, 133, 193, 249 and
// "cuda_cores" 123, 132, 167, 228 (bf16 229 at D <= 1024) at D <= 256,
// 512, 768, 1024.

#include <algorithm>
#include <cstdint>
#include <type_traits>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "mma.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 32;                  // rows of x per block
constexpr int kRowsPerWarp = kRows / (kThreads / 32);   // 4
constexpr int kHc = 64;                    // hidden units per chunk
constexpr int kKc = 64;                    // rows of a W1 slice
constexpr int kSlab = 256;                 // columns of a W2 slab
constexpr int kColsPerSlab = kSlab / 32;   // accumulator columns per lane
constexpr int kHPitch = kRows + 4;         // row pitch of the hidden chunk
constexpr int kWFloats = kHc * kSlab;      // >= kKc * kHc

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

__device__ __forceinline__ float warp_sum(float x) {
  for (int off = 16; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

__device__ __forceinline__ float gelu_erf(float v) {
  return 0.5f * v * (1.0f + erff(v * 0.70710678118654752f));
}

// the output column of accumulator column c of a lane: slab c / 8, then
// lane + 32 (c % 8) within the slab
__device__ __forceinline__ int column(int c, int lane) {
  return (c / kColsPerSlab) * kSlab + (c % kColsPerSlab) * 32 + lane;
}

size_t smem_bytes(int d) {
  return sizeof(float) * (static_cast<size_t>(d) * kRows + kWFloats +
                          kHc * kHPitch);
}

// kSlabs: W2 slabs of 256 columns the accumulator spans (D <= 256 kSlabs)
template <typename T, int kSlabs>
__global__ void __launch_bounds__(kThreads, 1)
fused_ffn_ln_kernel(const T* __restrict__ x, const T* __restrict__ w1,
                    const T* __restrict__ b1, const T* __restrict__ w2,
                    const T* __restrict__ b2, const T* __restrict__ gamma,
                    const T* __restrict__ beta, T* __restrict__ out, int m,
                    int d, int h, float eps) {
  constexpr int kCols = kSlabs * kColsPerSlab;
  extern __shared__ float4 smem4[];
  float* x_s = reinterpret_cast<float*>(smem4);  // (d, kRows): x transposed
  float* w_s = x_s + static_cast<size_t>(d) * kRows;  // W1 slice / W2 slab
  float* h_s = w_s + kWFloats;                   // (kHc, kHPitch)

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int r0 = warp * kRowsPerWarp;            // the warp's first row
  const long long m0 = static_cast<long long>(blockIdx.x) * kRows;
  const int rows = static_cast<int>(min(static_cast<long long>(kRows),
                                        m - m0));

  for (int i = tid; i < kRows * d; i += kThreads) {
    const int r = i / d, c = i - r * d;
    x_s[c * kRows + r] = r < rows ? to_f(x[(m0 + r) * d + c]) : 0.f;
  }

  float acc[kRowsPerWarp][kCols];
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i)
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[i][c] = 0.f;

  for (int c0 = 0; c0 < h; c0 += kHc) {
    // ---- A: the hidden chunk ----
    float hacc[kRowsPerWarp][2];
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) hacc[i][0] = hacc[i][1] = 0.f;
    for (int d0 = 0; d0 < d; d0 += kKc) {
      __syncthreads();  // w_s and h_s are free (the last slab is done)
      for (int i = tid; i < kKc * kHc; i += kThreads) {
        const int dd = i / kHc, c = i - dd * kHc;
        const int gd = d0 + dd, gc = c0 + c;
        w_s[i] = gd < d && gc < h
                     ? to_f(w1[static_cast<long long>(gd) * h + gc])
                     : 0.f;
      }
      __syncthreads();
      const int kn = min(kKc, d - d0);
      for (int dd = 0; dd < kn; ++dd) {
        const float4 xv =
            *reinterpret_cast<const float4*>(x_s + (d0 + dd) * kRows + r0);
        const float wa = w_s[dd * kHc + lane];
        const float wb = w_s[dd * kHc + lane + 32];
        const float xr[kRowsPerWarp] = {xv.x, xv.y, xv.z, xv.w};
#pragma unroll
        for (int i = 0; i < kRowsPerWarp; ++i) {
          hacc[i][0] = fmaf(xr[i], wa, hacc[i][0]);
          hacc[i][1] = fmaf(xr[i], wb, hacc[i][1]);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int gc = c0 + lane + 32 * j;
      const float bias = gc < h ? to_f(b1[gc]) : 0.f;
      float hv[kRowsPerWarp];
#pragma unroll
      for (int i = 0; i < kRowsPerWarp; ++i)
        hv[i] = gc < h ? to_f(from_f<T>(gelu_erf(hacc[i][j] + bias))) : 0.f;
      *reinterpret_cast<float4*>(h_s + (lane + 32 * j) * kHPitch + r0) =
          make_float4(hv[0], hv[1], hv[2], hv[3]);
    }

    // ---- B: acc += hidden chunk . W2[chunk, :] ----
#pragma unroll
    for (int s = 0; s < kSlabs; ++s) {
      __syncthreads();  // h_s written; w_s free
      for (int i = tid; i < kHc * kSlab; i += kThreads) {
        const int kk = i / kSlab, c = i - kk * kSlab;
        const int gk = c0 + kk, gc = s * kSlab + c;
        w_s[i] = gk < h && gc < d
                     ? to_f(w2[static_cast<long long>(gk) * d + gc])
                     : 0.f;
      }
      __syncthreads();
      const int kn = min(kHc, h - c0);
      for (int kk = 0; kk < kn; ++kk) {
        const float4 hv =
            *reinterpret_cast<const float4*>(h_s + kk * kHPitch + r0);
        const float hr[kRowsPerWarp] = {hv.x, hv.y, hv.z, hv.w};
        const float* wrow = w_s + kk * kSlab + lane;
#pragma unroll
        for (int cc = 0; cc < kColsPerSlab; ++cc) {
          const float wv = wrow[32 * cc];
#pragma unroll
          for (int i = 0; i < kRowsPerWarp; ++i)
            acc[i][s * kColsPerSlab + cc] =
                fmaf(hr[i], wv, acc[i][s * kColsPerSlab + cc]);
        }
      }
    }
  }

  // ---- epilogue: + b2 + x, LayerNorm over the row, one rounding ----
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    const int r = r0 + i;
    if (r < rows) {  // uniform over the warp
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const int col = column(c, lane);
        if (col < d) {
          acc[i][c] = acc[i][c] + to_f(b2[col]) + x_s[col * kRows + r];
          sum += acc[i][c];
        }
      }
      const float mu = warp_sum(sum) / static_cast<float>(d);
      float sq = 0.f;
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const float t = acc[i][c] - mu;
        if (column(c, lane) < d) sq += t * t;
      }
      const float rstd = rsqrtf(warp_sum(sq) / static_cast<float>(d) + eps);
      T* orow = out + (m0 + r) * d;
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const int col = column(c, lane);
        if (col < d)
          orow[col] = from_f<T>((acc[i][c] - mu) * rstd * to_f(gamma[col]) +
                                to_f(beta[col]));
      }
    }
  }
}

// ---------------------------------------------------------------------------
// bf16 on the tensor cores: mma.sync m16n8k16, fp32 accumulators
// ---------------------------------------------------------------------------

namespace tc {

using m3p::mma::ldmatrix_x2_trans;
using m3p::mma::load_a;
using m3p::mma::mma_16816;
using m3p::mma::pack_bf16x2;

constexpr int kPad = 8;                    // bf16 padding of a shared row
constexpr int kNPerWarp = kSlab / 8 / (kThreads / 32);  // n-tiles: 4

// x (kRows, D + kPad), one chunk of W1 (D, kHc + kPad) or of W2
// (kHc, D + kPad), the hidden chunk (kRows, kHc + kPad), and the row sums
size_t smem_bytes(int d) {
  const size_t w = std::max(static_cast<size_t>(d) * (kHc + kPad),
                            static_cast<size_t>(kHc) * (d + kPad));
  return sizeof(__nv_bfloat16) *
             (static_cast<size_t>(kRows) * (d + kPad) + w +
              kRows * (kHc + kPad)) +
         sizeof(float) * kRows * (kThreads / 32);
}

// rows [r0, r0 + nr) x columns [c0, c0 + nc) of a row-major (rows, cols)
// matrix into shared memory of pitch ld, zero outside the matrix, in
// 16-byte vectors (nc a multiple of 8); four loads in flight per thread
__device__ __forceinline__ void stage(__nv_bfloat16* dst, int ld,
                                      const __nv_bfloat16* src, long long cols,
                                      long long r0, int nr, long long rows,
                                      long long c0, int nc) {
  constexpr int kInFlight = 4;
  const int vecs = nc / 8, n = nr * vecs;
  for (int base = threadIdx.x; base < n; base += kInFlight * kThreads) {
    uint4 v[kInFlight];
#pragma unroll
    for (int u = 0; u < kInFlight; ++u) {
      const int i = base + u * kThreads;
      const int r = i / vecs, c = (i - r * vecs) * 8;
      v[u] = make_uint4(0u, 0u, 0u, 0u);
      if (i < n && r0 + r < rows && c0 + c < cols)
        v[u] = *reinterpret_cast<const uint4*>(src + (r0 + r) * cols + c0 +
                                               c);
    }
#pragma unroll
    for (int u = 0; u < kInFlight; ++u) {
      const int i = base + u * kThreads;
      const int r = i / vecs, c = (i - r * vecs) * 8;
      if (i < n) *reinterpret_cast<uint4*>(dst + r * ld + c) = v[u];
    }
  }
}

// One block of 256 threads per 32-row tile, as the CUDA-core kernel, with
// the products on the tensor cores.  A: warp w computes the hidden units
// 8w .. 8w + 7 of the chunk for both 16-row halves; B: warp w owns the
// n-tiles 32 s + 4 w + j (j < 4) of each 256-column slab s, 2 x 4 x kSlabs
// fragments of 4 fp32 sums.  The epilogue reduces each row's sums over the
// 4 lanes of a quad with shuffles and over the 8 warps in shared memory.
// Needs D % 64 == 0, H % 8 == 0 and 16-byte aligned x, W1, W2.
template <int kSlabs>
__global__ void __launch_bounds__(kThreads, 1)
fused_ffn_ln_mma_kernel(const __nv_bfloat16* __restrict__ x,
                        const __nv_bfloat16* __restrict__ w1,
                        const __nv_bfloat16* __restrict__ b1,
                        const __nv_bfloat16* __restrict__ w2,
                        const __nv_bfloat16* __restrict__ b2,
                        const __nv_bfloat16* __restrict__ gamma,
                        const __nv_bfloat16* __restrict__ beta,
                        __nv_bfloat16* __restrict__ out, int m, int d, int h,
                        float eps) {
  constexpr int kNt = kSlabs * kNPerWarp;
  constexpr int kWarps = kThreads / 32;
  constexpr int ldw1 = kHc + kPad, ldh = kHc + kPad;
  extern __shared__ float4 smem4[];
  const int ldx = d + kPad, ldw2 = d + kPad;
  __nv_bfloat16* x_s = reinterpret_cast<__nv_bfloat16*>(smem4);
  __nv_bfloat16* w_s = x_s + kRows * ldx;       // a chunk of W1 or W2
  __nv_bfloat16* h_s = w_s + max(d * ldw1, kHc * ldw2);  // (kRows, ldh)
  float* red = reinterpret_cast<float*>(h_s + kRows * ldh);  // (kRows, 8)

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const long long m0 = static_cast<long long>(blockIdx.x) * kRows;

  stage(x_s, ldx, x, d, m0, kRows, m, 0, d);

  float acc[2][kNt][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int n = 0; n < kNt; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][n][e] = 0.f;

  for (int c0 = 0; c0 < h; c0 += kHc) {
    // ---- A: the hidden chunk ----
    float hacc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
    __syncthreads();  // w_s and h_s are free (the last chunk is done)
    stage(w_s, ldw1, w1, h, 0, d, d, c0, kHc);
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < d; kk += 16) {
      uint32_t b0, b1v;
      ldmatrix_x2_trans(b0, b1v, w_s + (kk + (lane & 15)) * ldw1 + 8 * warp);
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        uint32_t a[4];
        load_a(a, x_s + mt * 16 * ldx + kk, ldx, lane);
        mma_16816(hacc[mt], a, b0, b1v);
      }
    }
    const int col = 8 * warp + 2 * t;     // hidden unit within the chunk
    const bool live = c0 + col < h;       // H % 8 == 0: both or neither
    const float bias0 = live ? __bfloat162float(b1[c0 + col]) : 0.f;
    const float bias1 = live ? __bfloat162float(b1[c0 + col + 1]) : 0.f;
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = 16 * mt + g + 8 * half;
        const float v0 = live ? gelu_erf(hacc[mt][2 * half] + bias0) : 0.f;
        const float v1 =
            live ? gelu_erf(hacc[mt][2 * half + 1] + bias1) : 0.f;
        *reinterpret_cast<uint32_t*>(h_s + r * ldh + col) =
            pack_bf16x2(v0, v1);
      }

    // ---- B: acc += hidden chunk . W2[chunk, :] ----
    __syncthreads();  // h_s written; w_s free
    stage(w_s, ldw2, w2, d, c0, kHc, h, 0, d);
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kHc; kk += 16) {
      uint32_t a0[4], a1[4];
      load_a(a0, h_s + kk, ldh, lane);
      load_a(a1, h_s + 16 * ldh + kk, ldh, lane);
#pragma unroll
      for (int n = 0; n < kNt; ++n) {
        // this warp's n-tile n % 4 of the 256 columns n / 4
        const int col = kSlab * (n / kNPerWarp) +
                        8 * (kNPerWarp * warp + n % kNPerWarp);
        if (col < d) {  // uniform over the warp
          uint32_t b0, b1v;
          ldmatrix_x2_trans(b0, b1v, w_s + (kk + (lane & 15)) * ldw2 + col);
          mma_16816(acc[0][n], a0, b0, b1v);
          mma_16816(acc[1][n], a1, b0, b1v);
        }
      }
    }
  }

  // ---- epilogue: + b2 + x, LayerNorm over the row, one rounding ----
  // lane (g, t) holds rows 16 mt + g + 8 half, columns 2t, 2t + 1 of each
  // n-tile; a row's D columns lie in the 4 lanes of a quad in all 8 warps
  float part[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int n = 0; n < kNt; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int half = e >> 1, r = 16 * mt + g + 8 * half;
        const int c = 8 * (kWarps * kNPerWarp * (n / kNPerWarp) +
                           kNPerWarp * warp + n % kNPerWarp) +
                      2 * t + (e & 1);
        if (c < d) {
          acc[mt][n][e] = acc[mt][n][e] + __bfloat162float(b2[c]) +
                          __bfloat162float(x_s[r * ldx + c]);
          part[mt][half] += acc[mt][n][e];
        }
      }
  float mu[2][2], rstd[2][2];
#pragma unroll
  for (int pass = 0; pass < 2; ++pass) {
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        float v = part[mt][half];
        v += __shfl_xor_sync(0xffffffffu, v, 1);
        v += __shfl_xor_sync(0xffffffffu, v, 2);
        if (t == 0) red[(16 * mt + g + 8 * half) * kWarps + warp] = v;
      }
    __syncthreads();
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const float* row = red + (16 * mt + g + 8 * half) * kWarps;
        float total = 0.f;
#pragma unroll
        for (int w = 0; w < kWarps; ++w) total += row[w];
        if (pass == 0)
          mu[mt][half] = total / static_cast<float>(d);
        else
          rstd[mt][half] = rsqrtf(total / static_cast<float>(d) + eps);
        part[mt][half] = 0.f;
      }
    if (pass == 0) {
      __syncthreads();  // red is read by every thread before it is reused
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int n = 0; n < kNt; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int half = e >> 1;
            const int c = 8 * (kWarps * kNPerWarp * (n / kNPerWarp) +
                               kNPerWarp * warp + n % kNPerWarp) +
                          2 * t + (e & 1);
            const float dv = acc[mt][n][e] - mu[mt][half];
            if (c < d) part[mt][half] += dv * dv;
          }
    }
  }
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const long long row = m0 + 16 * mt + g + 8 * half;
      if (row >= m) continue;
#pragma unroll
      for (int n = 0; n < kNt; ++n) {
        const int c = 8 * (kWarps * kNPerWarp * (n / kNPerWarp) +
                           kNPerWarp * warp + n % kNPerWarp) +
                      2 * t;
        if (c >= d) continue;
        float o[2];
#pragma unroll
        for (int e = 0; e < 2; ++e)
          o[e] = (acc[mt][n][2 * half + e] - mu[mt][half]) * rstd[mt][half] *
                     __bfloat162float(gamma[c + e]) +
                 __bfloat162float(beta[c + e]);
        *reinterpret_cast<uint32_t*>(out + row * d + c) =
            pack_bf16x2(o[0], o[1]);
      }
    }
}

}  // namespace tc

// ---------------------------------------------------------------------------
// bf16 on a cluster of two blocks: mma.sync, a cp.async ring, and the
// hidden chunk shared through distributed shared memory
// ---------------------------------------------------------------------------

namespace cl {

using m3p::mma::cluster_arrive;
using m3p::mma::cluster_rank;
using m3p::mma::cluster_wait;
using m3p::mma::cp_async_16;
using m3p::mma::cp_async_commit;
using m3p::mma::cp_async_wait;
using m3p::mma::ldmatrix_x2_trans;
using m3p::mma::ldmatrix_x4;
using m3p::mma::ldmatrix_x4_trans;
using m3p::mma::map_rank;
using m3p::mma::mma_16816;
using m3p::mma::pack_bf16x2;

constexpr int kRows = 64;         // rows of x per cluster
constexpr int kHc = 64;           // hidden units per chunk, 32 per block
constexpr int kHalf = kHc / 2;
constexpr int kPad = 8;           // bf16 padding of a shared row
constexpr int kStages = 2;        // slots of the ring
constexpr int kW2Rows = kHc;      // a W2 stage is the chunk's (64, D / 2)
constexpr int kHBufs = 3;         // hidden chunk buffers
constexpr int kLdw1 = kHalf + kPad;
constexpr int kLdh = kHc + kPad;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxD = 768;        // shared memory (Shape<768>::bytes)

template <int kD>
struct Shape {
  static constexpr int ldx = kD + kPad;
  static constexpr int ldw2 = kD / 2 + kPad;
  // rows (k) of a W1 stage (w1_rows, 32)
  static constexpr int w1_rows = kD % 384 == 0   ? 384
                                 : kD % 256 == 0 ? 256
                                                 : 128;
  static constexpr int slot = w1_rows * kLdw1 > kW2Rows * ldw2
                                  ? w1_rows * kLdw1
                                  : kW2Rows * ldw2;
  static constexpr int kA = kD / w1_rows;   // W1 stages per chunk
  static constexpr int kB = kHc / kW2Rows;  // W2 stages per chunk
  // x (kRows, ldx), the ring, the hidden buffers (kRows, kLdh) in bf16;
  // the epilogue's row sums (kRows, kWarps) and the row sums exchanged
  // ([pass][rank][row]) in fp32: 230,400 bytes at D = 768
  static constexpr size_t bytes =
      2 * (static_cast<size_t>(kRows) * ldx +
           static_cast<size_t>(kStages) * slot + kHBufs * kRows * kLdh) +
      4 * (kRows * kWarps + 2 * 2 * kRows);
};

// Stage i of a block's sequence: chunk 0's kA W1 stages, then for each
// chunk c >= 1 its kA W1 stages followed by chunk c - 1's kB W2 stages,
// then the last chunk's W2 stages.  Returns true for a W2 stage.
template <int kA, int kB>
__device__ __forceinline__ bool stage_of(int i, int nc, int& chunk,
                                         int& slice) {
  if (i < kA) {
    chunk = 0;
    slice = i;
    return false;
  }
  i -= kA;
  const int c = i / (kA + kB) + 1, j = i - (c - 1) * (kA + kB);
  if (c == nc) {
    chunk = nc - 1;
    slice = j;
    return true;
  }
  if (j < kA) {
    chunk = c;
    slice = j;
    return false;
  }
  chunk = c - 1;
  slice = j - kA;
  return true;
}

// A cluster of two blocks of 256 threads per 64-row tile; block rank r owns
// output columns [r D / 2, (r + 1) D / 2) and hidden units [32 r, 32 r + 32)
// of every 64-unit chunk.  Both keep the whole (64, D) tile of x in shared
// memory and stream their own W1 columns and W2 block through two
// cp.async stages (one in flight while the other multiplies), in the order
// A(0), A(1), B(0), A(2), B(1), ...:
//   A(c): the block's (64, 32) half of hidden chunk c = x . W1[:, cols];
//         warp w computes the (16, 16) tile of rows 16 (w % 4) .. and units
//         16 (w / 4) ..; then b1, GELU, the rounding to bf16, and the tile
//         is stored into both blocks' hidden buffer c % 3 (the peer's
//         through distributed shared memory); then the cluster barrier's
//         arrive;
//   B(c): acc (64, D / 2) += hidden chunk c . W2[chunk rows, own columns];
//         warp w owns kNt 8-column n-tiles, all 64 rows (4 kNt fragments);
//         after B(c - 1) the barrier's wait for chunk c, so a block waits
//         for its peer's half while it works on the chunk before.
// Three hidden buffers: the peer writes buffer (c + 1) % 3 only after this
// block has arrived for chunk c, which it does after B(c - 2).
// The epilogue sums each row over the block's D / 2 columns (mean, then
// squared deviations), exchanges the two partial sums through distributed
// shared memory, and both blocks normalise their own columns.
// Needs bf16, D = 128 kNt, H % 64 == 0, x, W1, W2 and out 16-byte aligned.
template <int kNt>
__global__ void __cluster_dims__(2, 1, 1) __launch_bounds__(kThreads, 1)
fused_ffn_ln_cluster_kernel(const __nv_bfloat16* __restrict__ x,
                            const __nv_bfloat16* __restrict__ w1,
                            const __nv_bfloat16* __restrict__ b1,
                            const __nv_bfloat16* __restrict__ w2,
                            const __nv_bfloat16* __restrict__ b2,
                            const __nv_bfloat16* __restrict__ gamma,
                            const __nv_bfloat16* __restrict__ beta,
                            __nv_bfloat16* __restrict__ out, int m, int h,
                            float eps) {
  constexpr int kD = 128 * kNt, kDh = kD / 2;
  using S = Shape<kD>;
  constexpr int ldx = S::ldx, ldw2 = S::ldw2, kA = S::kA, kB = S::kB;
  constexpr int kW1Rows = S::w1_rows;
  extern __shared__ float4 smem4[];
  __nv_bfloat16* x_s = reinterpret_cast<__nv_bfloat16*>(smem4);
  __nv_bfloat16* ring = x_s + kRows * ldx;
  __nv_bfloat16* h_s = ring + kStages * S::slot;
  float* red_e = reinterpret_cast<float*>(h_s + kHBufs * kRows * kLdh);
  float* xchg = red_e + kRows * kWarps;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const uint32_t rank = cluster_rank(), peer = rank ^ 1u;
  const long long m0 = static_cast<long long>(blockIdx.x >> 1) * kRows;
  const int nc = h / kHc, total = nc * (kA + kB);

  const int g = lane >> 2, t = lane & 3;
  // phase A's (16, 16) tile of this warp: rows arow .., units 16 np ..
  const int arow = 16 * (warp & 3), np = warp >> 2;
  for (int v = tid; v < kRows * (kD / 8); v += kThreads) {
    const int r = v / (kD / 8), c = (v - r * (kD / 8)) * 8;
    const bool ok = m0 + r < m;
    cp_async_16(x_s + r * ldx + c, x + (ok ? (m0 + r) * kD + c : 0), ok);
  }
  cp_async_commit();

  const auto load_stage = [&](int i) {
    if (i >= total) return;
    int chunk, slice;
    __nv_bfloat16* dst = ring + (i % kStages) * S::slot;
    if (!stage_of<kA, kB>(i, nc, chunk, slice)) {
      const __nv_bfloat16* src =
          w1 + static_cast<long long>(slice) * kW1Rows * h + chunk * kHc +
          rank * kHalf;
      for (int v = tid; v < kW1Rows * (kHalf / 8); v += kThreads) {
        const int r = v >> 2, c = (v & 3) * 8;
        cp_async_16(dst + r * kLdw1 + c,
                    src + static_cast<long long>(r) * h + c, true);
      }
    } else {
      const __nv_bfloat16* src =
          w2 + static_cast<long long>(chunk * kHc + slice * kW2Rows) * kD +
          rank * kDh;
      for (int v = tid; v < kW2Rows * (kDh / 8); v += kThreads) {
        const int r = v / (kDh / 8), c = (v - r * (kDh / 8)) * 8;
        cp_async_16(dst + r * ldw2 + c, src + r * kD + c, true);
      }
    }
  };
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    load_stage(s);
    cp_async_commit();
  }
  cluster_arrive();  // the peer has started once the matching wait passes

  float acc[4][kNt][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int n = 0; n < kNt; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][n][e] = 0.f;
  float hacc[2][4];
  __nv_bfloat16 bias[2][2];  // b1 of this lane's four hidden units in A(c)
  // the hidden units of this lane within the chunk: col + 8 nt, + 1
  const int col = rank * kHalf + 16 * np + 2 * t;

#pragma unroll 1
  for (int i = 0; i < total; ++i) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // stage i landed; slot (i - 1) % kStages is free
    load_stage(i + kStages - 1);
    cp_async_commit();
    int chunk, slice;
    const bool is_w2 = stage_of<kA, kB>(i, nc, chunk, slice);
    const __nv_bfloat16* ws = ring + (i % kStages) * S::slot;
    if (!is_w2) {
      // ---- A: this warp's (16, 16) tile of the block's hidden half ----
      if (slice == 0) {
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
          for (int e = 0; e < 4; ++e) hacc[nt][e] = 0.f;
          bias[nt][0] = b1[chunk * kHc + col + 8 * nt];
          bias[nt][1] = b1[chunk * kHc + col + 8 * nt + 1];
        }
      }
#pragma unroll
      for (int s = 0; s < kW1Rows / 16; ++s) {
        uint32_t a[4], b[4];
        ldmatrix_x4(a, x_s + (arow + (lane & 15)) * ldx +
                           slice * kW1Rows + 16 * s + 8 * (lane >> 4));
        ldmatrix_x4_trans(b, ws + (16 * s + (lane & 15)) * kLdw1 + 16 * np +
                                 8 * (lane >> 4));
        mma_16816(hacc[0], a, b[0], b[1]);
        mma_16816(hacc[1], a, b[2], b[3]);
      }
      if (slice == kA - 1) {
        if (chunk == 0) cluster_wait();  // the peer runs: its memory is ours
        __nv_bfloat16* hb = h_s + (chunk % kHBufs) * kRows * kLdh;
        __nv_bfloat16* hb_peer = map_rank(hb, peer);
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int row = arow + g + 8 * half;
            const uint32_t packed = pack_bf16x2(
                gelu_erf(hacc[nt][2 * half] + __bfloat162float(bias[nt][0])),
                gelu_erf(hacc[nt][2 * half + 1] +
                         __bfloat162float(bias[nt][1])));
            const int at = row * kLdh + col + 8 * nt;
            *reinterpret_cast<uint32_t*>(hb + at) = packed;
            *reinterpret_cast<uint32_t*>(hb_peer + at) = packed;
          }
        cluster_arrive();                // this block's half of chunk c
        if (chunk == 0) cluster_wait();  // B(0) follows at once
      }
    } else {
      // ---- B: acc += hidden chunk . W2[chunk rows, own columns] ----
      const __nv_bfloat16* hb = h_s + (chunk % kHBufs) * kRows * kLdh;
#pragma unroll
      for (int ks = 0; ks < kW2Rows / 16; ++ks) {
        const int kk = slice * kW2Rows + 16 * ks;
        uint32_t a[4][4];
#pragma unroll
        for (int mt = 0; mt < 4; ++mt)
          ldmatrix_x4(a[mt], hb + (16 * mt + (lane & 15)) * kLdh + kk +
                                 8 * (lane >> 4));
        const __nv_bfloat16* wrow = ws + (16 * ks + (lane & 15)) * ldw2 +
                                    warp * kNt * 8 + 8 * (lane >> 4);
#pragma unroll
        for (int p = 0; p < kNt / 2; ++p) {
          uint32_t bb[4];
          ldmatrix_x4_trans(bb, wrow + 16 * p);
#pragma unroll
          for (int mt = 0; mt < 4; ++mt) {
            mma_16816(acc[mt][2 * p], a[mt], bb[0], bb[1]);
            mma_16816(acc[mt][2 * p + 1], a[mt], bb[2], bb[3]);
          }
        }
        if constexpr (kNt % 2 == 1) {
          uint32_t b0, b1v;
          ldmatrix_x2_trans(b0, b1v, ws + (16 * ks + (lane & 15)) * ldw2 +
                                         warp * kNt * 8 + 8 * (kNt - 1));
#pragma unroll
          for (int mt = 0; mt < 4; ++mt)
            mma_16816(acc[mt][kNt - 1], a[mt], b0, b1v);
        }
      }
      // the peer's half of chunk c + 1, while this block worked on chunk c
      if (slice == kB - 1 && chunk + 1 < nc) cluster_wait();
    }
  }
  cp_async_wait<0>();

  // ---- epilogue: + b2 + x, LayerNorm over the row, one rounding ----
  // lane (g, t) of warp w holds rows 16 mt + g + 8 half and columns
  // rank D / 2 + 8 (kNt w + n) + 2t, + 1; a row's D / 2 columns lie in the
  // 4 lanes of a quad in all 8 warps, the other D / 2 in the peer
  const int c0 = rank * kDh + warp * kNt * 8 + 2 * t;
  float part[4][2];
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = 16 * mt + g + 8 * half;
      float s = 0.f;
#pragma unroll
      for (int n = 0; n < kNt; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = c0 + 8 * n + e;
          float& v = acc[mt][n][2 * half + e];
          v = v + __bfloat162float(b2[c]) +
              __bfloat162float(x_s[r * ldx + c]);
          s += v;
        }
      part[mt][half] = s;
    }
  float mu[4][2], rstd[4][2];
  float* xchg_peer = map_rank(xchg, peer);
#pragma unroll
  for (int pass = 0; pass < 2; ++pass) {
#pragma unroll
    for (int mt = 0; mt < 4; ++mt)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        float v = part[mt][half];
        v += __shfl_xor_sync(0xffffffffu, v, 1);
        v += __shfl_xor_sync(0xffffffffu, v, 2);
        if (t == 0) red_e[(16 * mt + g + 8 * half) * kWarps + warp] = v;
      }
    __syncthreads();
    if (tid < kRows) {
      float s = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) s += red_e[tid * kWarps + w];
      const int at = (2 * pass + static_cast<int>(rank)) * kRows + tid;
      xchg[at] = s;
      xchg_peer[at] = s;
    }
    cluster_arrive();  // both blocks' row sums of this pass are in place;
    cluster_wait();    // red_e is free again
#pragma unroll
    for (int mt = 0; mt < 4; ++mt)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = 16 * mt + g + 8 * half;
        const float sum = xchg[2 * pass * kRows + r] +
                          xchg[(2 * pass + 1) * kRows + r];
        if (pass == 0)
          mu[mt][half] = sum / static_cast<float>(kD);
        else
          rstd[mt][half] = rsqrtf(sum / static_cast<float>(kD) + eps);
      }
    if (pass == 0) {
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          float s = 0.f;
#pragma unroll
          for (int n = 0; n < kNt; ++n)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const float dv = acc[mt][n][2 * half + e] - mu[mt][half];
              s += dv * dv;
            }
          part[mt][half] = s;
        }
    }
  }
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const long long row = m0 + 16 * mt + g + 8 * half;
      if (row >= m) continue;
#pragma unroll
      for (int n = 0; n < kNt; ++n) {
        const int c = c0 + 8 * n;
        float o[2];
#pragma unroll
        for (int e = 0; e < 2; ++e)
          o[e] = (acc[mt][n][2 * half + e] - mu[mt][half]) * rstd[mt][half] *
                     __bfloat162float(gamma[c + e]) +
                 __bfloat162float(beta[c + e]);
        *reinterpret_cast<uint32_t*>(out + row * kD + c) =
            pack_bf16x2(o[0], o[1]);
      }
    }
}

template <int kNt>
cudaError_t launch(const __nv_bfloat16* x, const __nv_bfloat16* w1,
                   const __nv_bfloat16* b1, const __nv_bfloat16* w2,
                   const __nv_bfloat16* b2, const __nv_bfloat16* gamma,
                   const __nv_bfloat16* beta, __nv_bfloat16* out, int m,
                   int h, float eps, cudaStream_t stream) {
  const auto kernel = fused_ffn_ln_cluster_kernel<kNt>;
  const size_t smem = Shape<128 * kNt>::bytes;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const long long tiles = (static_cast<long long>(m) + kRows - 1) / kRows;
  kernel<<<static_cast<unsigned>(2 * tiles), kThreads, smem, stream>>>(
      x, w1, b1, w2, b2, gamma, beta, out, m, h, eps);
  return cudaGetLastError();
}

template <int kNt>
cudaError_t occupancy(int* clusters) {
  const auto kernel = fused_ffn_ln_cluster_kernel<kNt>;
  const size_t smem = Shape<128 * kNt>::bytes;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(2 * 1024, 1, 1);
  config.blockDim = dim3(kThreads, 1, 1);
  config.dynamicSmemBytes = smem;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = 2;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  config.attrs = &attr;
  config.numAttrs = 1;
  return cudaOccupancyMaxActiveClusters(clusters, kernel, &config);
}

// D = 128 kNt for kNt = d / 128 in 1 .. kMaxD / 128
template <typename F>
cudaError_t with_nt(int d, F&& f) {
  switch (d / 128) {
    case 1: return f(std::integral_constant<int, 1>());
    case 2: return f(std::integral_constant<int, 2>());
    case 3: return f(std::integral_constant<int, 3>());
    case 4: return f(std::integral_constant<int, 4>());
    case 5: return f(std::integral_constant<int, 5>());
    case 6: return f(std::integral_constant<int, 6>());
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace cl

enum Design { kCudaCores = 0, kTile32 = 1, kCluster = 2 };

bool aligned(const void* p, uintptr_t n) {
  return reinterpret_cast<uintptr_t>(p) % n == 0;
}

// the rule of each bf16 design (ops/fused_ffn.py::_ffn_design)
bool tile32_fits(const void* x, const void* w1, const void* w2,
                 const void* out, int d, int h) {
  return d % 64 == 0 && h % 8 == 0 && aligned(x, 16) && aligned(w1, 16) &&
         aligned(w2, 16) && aligned(out, 4);
}

bool cluster_fits(const void* x, const void* w1, const void* w2,
                  const void* out, int d, int h) {
  return d % 128 == 0 && d <= cl::kMaxD && h % 64 == 0 && aligned(x, 16) &&
         aligned(w1, 16) && aligned(w2, 16) && aligned(out, 16);
}

template <typename Kernel, typename... Args>
cudaError_t launch(Kernel kernel, size_t smem, int m, cudaStream_t stream,
                   Args... args) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kernel<<<(m + kRows - 1) / kRows, kThreads, smem, stream>>>(args...);
  return cudaGetLastError();
}

// the 32-row kernels for D <= 256 kSlabs: the tensor-core one (design
// kTile32, bf16) or the CUDA-core one
template <typename T, int kSlabs>
cudaError_t launch_for(int design, const T* x, const T* w1, const T* b1,
                       const T* w2, const T* b2, const T* gamma,
                       const T* beta, T* out, int m, int d, int h, float eps,
                       cudaStream_t stream) {
  if constexpr (sizeof(T) == 2) {
    if (design == kTile32)
      return launch(tc::fused_ffn_ln_mma_kernel<kSlabs>, tc::smem_bytes(d), m,
                    stream, x, w1, b1, w2, b2, gamma, beta, out, m, d, h, eps);
  }
  return launch(fused_ffn_ln_kernel<T, kSlabs>, smem_bytes(d), m, stream, x,
                w1, b1, w2, b2, gamma, beta, out, m, d, h, eps);
}

template <typename T>
cudaError_t dispatch(int design, const void* x, const void* w1,
                     const void* b1, const void* w2, const void* b2,
                     const void* gamma, const void* beta, void* out, int m,
                     int d, int h, float eps, cudaStream_t stream) {
  const auto args = [&](auto slabs) {
    return launch_for<T, decltype(slabs)::value>(
        design, static_cast<const T*>(x), static_cast<const T*>(w1),
        static_cast<const T*>(b1), static_cast<const T*>(w2),
        static_cast<const T*>(b2), static_cast<const T*>(gamma),
        static_cast<const T*>(beta), static_cast<T*>(out), m, d, h, eps,
        stream);
  };
  switch ((d + kSlab - 1) / kSlab) {
    case 1:
      return args(std::integral_constant<int, 1>());
    case 2:
      return args(std::integral_constant<int, 2>());
    case 3:
      return args(std::integral_constant<int, 3>());
    case 4:
      return args(std::integral_constant<int, 4>());
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; design: 0 = CUDA cores, 1 = the 32-row
// tensor-core kernel ("tile32"), 2 = the two-block cluster; every tensor
// contiguous and of that type: x and out (M, D), w1 (D, H), b1 (H), w2
// (H, D), b2, gamma, beta (D).  1 <= D <= 1024, H >= 1, M >= 1; designs 1
// and 2 take bf16 within their rule (tile32_fits, cluster_fits) alone.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int m3p_fused_ffn_ln(int dtype, int design, const void* x,
                                const void* w1, const void* b1,
                                const void* w2, const void* b2,
                                const void* gamma, const void* beta,
                                void* out, int m, int d, int h, float eps,
                                void* stream) {
  if (m < 1 || d < 1 || d > 4 * kSlab || h < 1 || design < kCudaCores ||
      design > kCluster)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (design == kCluster) {
    if (dtype != 1 || !cluster_fits(x, w1, w2, out, d, h))
      return static_cast<int>(cudaErrorInvalidValue);
    using B = __nv_bfloat16;
    return static_cast<int>(cl::with_nt(d, [&](auto nt) {
      return cl::launch<decltype(nt)::value>(
          static_cast<const B*>(x), static_cast<const B*>(w1),
          static_cast<const B*>(b1), static_cast<const B*>(w2),
          static_cast<const B*>(b2), static_cast<const B*>(gamma),
          static_cast<const B*>(beta), static_cast<B*>(out), m, h, eps, s);
    }));
  }
  if (design == kTile32 &&
      (dtype != 1 || !tile32_fits(x, w1, w2, out, d, h)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0)
    return static_cast<int>(dispatch<float>(design, x, w1, b1, w2, b2, gamma,
                                            beta, out, m, d, h, eps, s));
  if (dtype == 1)
    return static_cast<int>(dispatch<__nv_bfloat16>(
        design, x, w1, b1, w2, b2, gamma, beta, out, m, d, h, eps, s));
  return static_cast<int>(cudaErrorInvalidValue);
}

// The most clusters of the cluster design at width d that the card runs at
// once (cudaOccupancyMaxActiveClusters), into *clusters.
extern "C" int m3p_fused_ffn_ln_cluster_occupancy(int d, int* clusters) {
  if (d % 128 != 0 || d > cl::kMaxD)
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cl::with_nt(d, [&](auto nt) {
    return cl::occupancy<decltype(nt)::value>(clusters);
  }));
}
