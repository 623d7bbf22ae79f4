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
//
// Two kernels, one block of 256 threads per 32-row tile each, both with
// the same walk: the tile of x stays in shared memory for the block's
// life, and the block goes over H in chunks of 64 hidden units:
//   A. the (32, 64) hidden chunk = x . W1[:, chunk], W1 streamed from L2
//      through shared memory; then b1, GELU (erff), the rounding to T, and
//      the chunk into shared memory;
//   B. acc += hidden chunk . W2[chunk, :], W2 streamed the same way; the
//      (32, D) fp32 accumulator lives in registers.
// W1 and W2 (9.4 MB in bf16) cannot stay on chip; each block reads them
// once from L2, 3.9 GB over the tool's 410 blocks.
//
// bf16 (D % 64 == 0, H % 8 == 0, 16-byte aligned x, W1, W2) runs both
// products on the tensor cores, mma.sync m16n8k16 with fp32 sums (the
// fragment helpers of mma.cuh).  Each
// chunk of W1 (D, 64) and then of W2 (64, D) comes into shared memory
// whole, four 16-byte loads in flight per thread.  x and the hidden chunk
// are A fragments read from row-major shared tiles, W1 and W2 B fragments
// loaded with ldmatrix.trans from their row-major (k, n) tiles; warp w
// computes hidden units 8w .. 8w + 7 in A and owns four 8-column n-tiles
// of every 256 columns in B.  Rows padded by 8 bf16 keep the fragment
// loads free of bank conflicts.  The epilogue reduces each row over the 4
// lanes of a quad with shuffles and over the 8 warps through shared
// memory.
//
// fp32 (and bf16 outside those shapes) runs on CUDA cores in fp32: no
// TF32, so fp32 keeps its parity with the plain version.  x sits in
// shared memory in fp32, transposed (D, 32); W1 comes in (64, 64) slices
// and W2 in (64, 256) slabs; warp w owns rows 4w .. 4w + 3: in A lane l
// computes hidden units l and l + 32, one broadcast float4 of x and two
// loads of W1 feeding 8 FMAs; in B lane l owns the columns l + 32 c, one
// broadcast float4 of the hidden and 8 loads of W2 feeding 32 FMAs; each
// row's D sums lie in one warp for the epilogue.
//
// wgmma, TMA and a larger row tile (fewer passes over W1 and W2) are left
// for later work.
//
// Registers (nvcc -Xptxas -v, sm_90a), no spills: tensor-core kernel 96,
// 133, 193, 249 and CUDA-core kernel 123, 132, 167, 228 at D <= 256, 512,
// 768, 1024.

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

// the kernel for D <= 256 kSlabs: the tensor-core one for bf16 at D % 64 ==
// 0, H % 8 == 0 and 16-byte aligned x, W1, W2 (and 4-byte aligned out),
// else the CUDA-core one
template <typename T, int kSlabs>
cudaError_t launch_for(const T* x, const T* w1, const T* b1, const T* w2,
                       const T* b2, const T* gamma, const T* beta, T* out,
                       int m, int d, int h, float eps, cudaStream_t stream) {
  const auto aligned = [](const void* p, uintptr_t n) {
    return reinterpret_cast<uintptr_t>(p) % n == 0;
  };
  if constexpr (sizeof(T) == 2) {
    if (d % 64 == 0 && h % 8 == 0 && aligned(x, 16) && aligned(w1, 16) &&
        aligned(w2, 16) && aligned(out, 4))
      return launch(tc::fused_ffn_ln_mma_kernel<kSlabs>, tc::smem_bytes(d), m,
                    stream, x, w1, b1, w2, b2, gamma, beta, out, m, d, h, eps);
  }
  return launch(fused_ffn_ln_kernel<T, kSlabs>, smem_bytes(d), m, stream, x,
                w1, b1, w2, b2, gamma, beta, out, m, d, h, eps);
}

template <typename T>
cudaError_t dispatch(const void* x, const void* w1, const void* b1,
                     const void* w2, const void* b2, const void* gamma,
                     const void* beta, void* out, int m, int d, int h,
                     float eps, cudaStream_t stream) {
  const auto args = [&](auto slabs) {
    return launch_for<T, decltype(slabs)::value>(
        static_cast<const T*>(x), static_cast<const T*>(w1),
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

// dtype: 0 = float32, 1 = bfloat16; every tensor contiguous and of that
// type: x and out (M, D), w1 (D, H), b1 (H), w2 (H, D), b2, gamma, beta (D).
// 1 <= D <= 1024, H >= 1, M >= 1.  Returns the cudaError_t of the launch
// (0 on success).
extern "C" int m3p_fused_ffn_ln(int dtype, const void* x, const void* w1,
                                const void* b1, const void* w2,
                                const void* b2, const void* gamma,
                                const void* beta, void* out, int m, int d,
                                int h, float eps, void* stream) {
  if (m < 1 || d < 1 || d > 4 * kSlab || h < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return static_cast<int>(dispatch<float>(x, w1, b1, w2, b2, gamma, beta,
                                            out, m, d, h, eps, s));
  if (dtype == 1)
    return static_cast<int>(dispatch<__nv_bfloat16>(
        x, w1, b1, w2, b2, gamma, beta, out, m, d, h, eps, s));
  return static_cast<int>(cudaErrorInvalidValue);
}
