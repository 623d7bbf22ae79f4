// Fused residual dropout for Hopper (sm_90a).
//
// Replaces the two kernels of m3p_tpu/ops/dropout.py, both reached through
// _grid_call's pallas_call:
//   #7 _fwd_kernel:  out = residual + where(keep, x * scale, 0)
//                    (fused_dropout_add_kernel below);
//   #8 _bwd_kernel:  out = where(keep, g * scale, 0), the backward of #7 and
//                    both directions of dropout_scale
//                    (fused_dropout_scale_kernel below).
// scale = 1 / (1 - rate), rounded to the tensor's dtype by the caller (as
// jnp.asarray(scale, x.dtype) does in the Pallas kernels).
//
// Mask: the TPU kernels seed the hardware PRNG per (seed, 512 x 128 grid
// step), which Hopper cannot reproduce.  Here element i of the flat tensor
// takes word i % 4 of Philox4x32-10 at counter (i / 4 lo, i / 4 hi, 0, 0)
// under the key (seed lo, seed hi), and is kept when that word is at or
// above the threshold (philox.cuh flat_bits; keep_mask_flat in
// m3p_tpu_torch/ops/philox.py).  The mask is a function of (seed, i) alone,
// so the backward regenerates the forward's mask, and the plain version
// draws it too.
//
// Numerics: the product and the sum are each rounded once to the dtype,
// written with __fmul_rn/__fadd_rn so that nvcc contracts nothing into an
// FMA; the plain version in m3p_tpu_torch/ops/dropout.py computes the same
// roundings, and the two agree bit for bit.
//
// Bound: device memory.  At the MCT step's residual (80 x 164 x 768 bf16,
// 20.15 MB a tensor) #7 reads x and the residual and writes the output,
// 60.5 MB, 0.0180 ms at 3.35 TB/s; #8 reads g and writes dx, 40.3 MB,
// 0.0120 ms.  Philox4x32-10 is of the same order: 10 rounds of two 32 x 32
// -> 64-bit multiplies and two three-way xors per 4 elements.
//
// Three designs, by the alignment of the pointers (the width code the
// caller passes; ops/dropout.py::_dropout_design names it, and the C entry
// refuses a width the pointers do not allow):
//   "wide" (2; every pointer 16-byte aligned): each thread moves 16 bytes
//     per tensor per step (8 bf16 elements, two Philox blocks, or 4 fp32,
//     one), and issues the loads of kUnroll steps before their Philox and
//     stores; the 10 round keys (seed + i (0x9E3779B9, 0xBB67AE85)) are
//     computed once per thread before the loop, so that a round is two
//     multiplies and two xors; the grid is at most as many blocks as the
//     SMs hold at once (cudaOccupancyMaxActiveBlocksPerMultiprocessor),
//     each thread walking the vectors with a grid stride; the elements past
//     the last whole 16 bytes go element by element;
//   "narrow" (1; every pointer aligned to 4 elements): each thread draws
//     one Philox block for 4 consecutive elements and moves them with one
//     8-byte (bf16) or 16-byte (fp32) access per tensor, 8 blocks of 256
//     threads per SM;
//   "scalar" (0): the narrow loop with one access per element.

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "philox.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 8;

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
  return __float2bfloat16_rn(x);
}

// Four consecutive elements, aligned to their size: one vector access.
template <typename T>
struct alignas(4 * sizeof(T)) Pack4 {
  T v[4];
};

// keep ? x * scale : 0, the product rounded to T; plus r, the sum rounded
// to T, with the residual.
template <typename T, bool kResidual>
__device__ __forceinline__ T drop_one(T x, T r, bool keep, float scale) {
  const float p = to_f(from_f<T>(__fmul_rn(to_f(x), scale)));
  const float kept = keep ? p : 0.0f;
  if constexpr (kResidual) return from_f<T>(__fadd_rn(to_f(r), kept));
  return from_f<T>(kept);
}

template <typename T, bool kResidual>
__device__ __forceinline__ void run(const T* __restrict__ x,
                                    const T* __restrict__ res,
                                    T* __restrict__ out, long long n,
                                    float scale, uint32_t threshold,
                                    unsigned long long seed, int vec) {
  const long long groups = (n + 3) / 4;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long g = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       g < groups; g += stride) {
    const uint4 bits =
        m3p::flat_bits(seed, static_cast<unsigned long long>(g));
    const long long i0 = 4 * g;
    if (vec && i0 + 4 <= n) {
      const Pack4<T> xv = *reinterpret_cast<const Pack4<T>*>(x + i0);
      Pack4<T> rv;
      if constexpr (kResidual)
        rv = *reinterpret_cast<const Pack4<T>*>(res + i0);
      Pack4<T> ov;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        T r{};
        if constexpr (kResidual) r = rv.v[j];
        ov.v[j] = drop_one<T, kResidual>(
            xv.v[j], r, m3p::word(bits, j) >= threshold, scale);
      }
      *reinterpret_cast<Pack4<T>*>(out + i0) = ov;
    } else {
      for (int j = 0; j < 4 && i0 + j < n; ++j) {
        T r{};
        if constexpr (kResidual) r = res[i0 + j];
        out[i0 + j] = drop_one<T, kResidual>(
            x[i0 + j], r, m3p::word(bits, j) >= threshold, scale);
      }
    }
  }
}

// Philox4x32-10 of counter c under the round keys k0[i], k1[i]
__device__ __forceinline__ uint4 philox_keyed(uint4 c,
                                              const uint32_t (&k0)[10],
                                              const uint32_t (&k1)[10]) {
#pragma unroll
  for (int i = 0; i < 10; ++i) {
    const uint32_t lo0 = 0xD2511F53u * c.x;
    const uint32_t hi0 = __umulhi(0xD2511F53u, c.x);
    const uint32_t lo1 = 0xCD9E8D57u * c.z;
    const uint32_t hi1 = __umulhi(0xCD9E8D57u, c.z);
    c = make_uint4(hi1 ^ c.y ^ k0[i], lo1, hi0 ^ c.w ^ k1[i], lo0);
  }
  return c;
}

constexpr int kUnroll = 2;   // steps whose loads a thread issues together

// The wide design: 16-byte vectors of kV elements, kV / 4 Philox blocks
// each (vector v holds groups kV / 4 v ..), the same mask and roundings as
// run().
template <typename T, bool kResidual>
__device__ __forceinline__ void run_wide(const T* __restrict__ x,
                                         const T* __restrict__ res,
                                         T* __restrict__ out, long long n,
                                         float scale, uint32_t threshold,
                                         unsigned long long seed) {
  constexpr int kV = 16 / sizeof(T), kG = kV / 4;
  uint32_t k0[10], k1[10];
  k0[0] = static_cast<uint32_t>(seed);
  k1[0] = static_cast<uint32_t>(seed >> 32);
#pragma unroll
  for (int i = 1; i < 10; ++i) {
    k0[i] = k0[i - 1] + 0x9E3779B9u;
    k1[i] = k1[i - 1] + 0xBB67AE85u;
  }
  const long long nv = n / kV;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const long long first =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const uint4* xv = reinterpret_cast<const uint4*>(x);
  const uint4* rv = reinterpret_cast<const uint4*>(res);
  uint4* ov = reinterpret_cast<uint4*>(out);
  for (long long v0 = first; v0 < nv; v0 += kUnroll * stride) {
    uint4 xs[kUnroll], rs[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long v = v0 + u * stride;
      if (v < nv) {
        xs[u] = xv[v];
        if constexpr (kResidual) rs[u] = rv[v];
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long v = v0 + u * stride;
      if (v >= nv) break;
      const T* xe = reinterpret_cast<const T*>(&xs[u]);
      const T* re = reinterpret_cast<const T*>(&rs[u]);
      uint4 o;
      T* oe = reinterpret_cast<T*>(&o);
#pragma unroll
      for (int j = 0; j < kG; ++j) {
        const unsigned long long grp =
            static_cast<unsigned long long>(v) * kG + j;
        const uint4 bits = philox_keyed(
            make_uint4(static_cast<uint32_t>(grp),
                       static_cast<uint32_t>(grp >> 32), 0u, 0u),
            k0, k1);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          T r{};
          if constexpr (kResidual) r = re[4 * j + e];
          oe[4 * j + e] = drop_one<T, kResidual>(
              xe[4 * j + e], r, m3p::word(bits, e) >= threshold, scale);
        }
      }
      ov[v] = o;
    }
  }
  // the ragged tail: elements nv kV .. n - 1, element by element
  if (first == 0) {
    for (long long i = nv * kV; i < n; ++i) {
      const uint4 bits =
          m3p::flat_bits(seed, static_cast<unsigned long long>(i / 4));
      const bool keep = m3p::word(bits, static_cast<int>(i % 4)) >= threshold;
      T r{};
      if constexpr (kResidual) r = res[i];
      out[i] = drop_one<T, kResidual>(x[i], r, keep, scale);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    fused_dropout_add_wide_kernel(const T* __restrict__ x,
                                  const T* __restrict__ res,
                                  T* __restrict__ out, long long n,
                                  float scale, uint32_t threshold,
                                  unsigned long long seed) {
  run_wide<T, true>(x, res, out, n, scale, threshold, seed);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    fused_dropout_scale_wide_kernel(const T* __restrict__ x,
                                    T* __restrict__ out, long long n,
                                    float scale, uint32_t threshold,
                                    unsigned long long seed) {
  run_wide<T, false>(x, nullptr, out, n, scale, threshold, seed);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    fused_dropout_add_kernel(const T* __restrict__ x,
                             const T* __restrict__ res, T* __restrict__ out,
                             long long n, float scale, uint32_t threshold,
                             unsigned long long seed, int vec) {
  run<T, true>(x, res, out, n, scale, threshold, seed, vec);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    fused_dropout_scale_kernel(const T* __restrict__ x, T* __restrict__ out,
                               long long n, float scale, uint32_t threshold,
                               unsigned long long seed, int vec) {
  run<T, false>(x, nullptr, out, n, scale, threshold, seed, vec);
}

enum Width { kScalar = 0, kNarrow = 1, kWide = 2 };

cudaError_t sm_count(int* sms) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  return cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
}

// the narrow and scalar grid: a block per 256 groups of 4, at most 8 blocks
// per SM
cudaError_t grid_for(long long n, int* blocks) {
  int sms = 0;
  cudaError_t err = sm_count(&sms);
  if (err != cudaSuccess) return err;
  const long long groups = (n + 3) / 4;
  const long long want = (groups + kThreads - 1) / kThreads;
  const long long most = static_cast<long long>(sms) * kBlocksPerSm;
  *blocks = static_cast<int>(want < most ? want : most);
  return cudaSuccess;
}

// the wide grid: a block per kUnroll 256 vectors, at most as many blocks as
// the SMs hold at once
template <typename Kernel>
cudaError_t wide_grid(Kernel kernel, long long n, int vec_elems,
                      int* blocks) {
  int sms = 0, per_sm = 0;
  cudaError_t err = sm_count(&sms);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      kThreads, 0);
  if (err != cudaSuccess) return err;
  const long long vecs = n / vec_elems;
  const long long want =
      (vecs + static_cast<long long>(kThreads) * kUnroll - 1) /
      (static_cast<long long>(kThreads) * kUnroll);
  const long long most = static_cast<long long>(sms) * per_sm;
  *blocks = static_cast<int>(want < 1 ? 1 : want < most ? want : most);
  return cudaSuccess;
}

bool aligned(const void* p, uintptr_t n) {
  return reinterpret_cast<uintptr_t>(p) % n == 0;
}

template <typename T>
cudaError_t launch(const void* x, const void* res, void* out, long long n,
                   float scale, uint32_t threshold, unsigned long long seed,
                   int width, cudaStream_t stream) {
  const uintptr_t need = width == kWide     ? 16
                         : width == kNarrow ? 4 * sizeof(T)
                                            : sizeof(T);
  if (width < kScalar || width > kWide || !aligned(x, need) ||
      !aligned(out, need) || (res != nullptr && !aligned(res, need)))
    return cudaErrorInvalidValue;
  const T* xt = static_cast<const T*>(x);
  const T* rt = static_cast<const T*>(res);
  T* ot = static_cast<T*>(out);
  int blocks = 0;
  cudaError_t err;
  if (width == kWide) {
    if (res != nullptr) {
      err = wide_grid(fused_dropout_add_wide_kernel<T>, n, 16 / sizeof(T),
                      &blocks);
      if (err != cudaSuccess) return err;
      fused_dropout_add_wide_kernel<T><<<blocks, kThreads, 0, stream>>>(
          xt, rt, ot, n, scale, threshold, seed);
    } else {
      err = wide_grid(fused_dropout_scale_wide_kernel<T>, n, 16 / sizeof(T),
                      &blocks);
      if (err != cudaSuccess) return err;
      fused_dropout_scale_wide_kernel<T><<<blocks, kThreads, 0, stream>>>(
          xt, ot, n, scale, threshold, seed);
    }
    return cudaGetLastError();
  }
  err = grid_for(n, &blocks);
  if (err != cudaSuccess) return err;
  const int vec = width == kNarrow;
  if (res != nullptr) {
    fused_dropout_add_kernel<T><<<blocks, kThreads, 0, stream>>>(
        xt, rt, ot, n, scale, threshold, seed, vec);
  } else {
    fused_dropout_scale_kernel<T><<<blocks, kThreads, 0, stream>>>(
        xt, ot, n, scale, threshold, seed, vec);
  }
  return cudaGetLastError();
}

int dispatch(int dtype, const void* x, const void* res, void* out,
             long long n, float scale, unsigned int threshold,
             unsigned long long seed, int width, void* stream) {
  if (n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return static_cast<int>(
        launch<float>(x, res, out, n, scale, threshold, seed, width, s));
  if (dtype == 1)
    return static_cast<int>(launch<__nv_bfloat16>(x, res, out, n, scale,
                                                  threshold, seed, width, s));
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  x, res, out: n contiguous elements of
// that dtype.  scale: 1 / (1 - rate) rounded to the dtype.  An element is
// kept when its Philox word under `seed` is >= threshold.  width: the
// design, 2 "wide" (every pointer 16-byte aligned), 1 "narrow" (every
// pointer aligned to 4 elements) or 0 "scalar".  Returns the cudaError_t of
// the launch (0 on success).
extern "C" int m3p_fused_dropout_add(int dtype, const void* x,
                                     const void* res, void* out, long long n,
                                     float scale, unsigned int threshold,
                                     unsigned long long seed, int width,
                                     void* stream) {
  if (res == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return dispatch(dtype, x, res, out, n, scale, threshold, seed, width,
                  stream);
}

extern "C" int m3p_fused_dropout_scale(int dtype, const void* x, void* out,
                                       long long n, float scale,
                                       unsigned int threshold,
                                       unsigned long long seed, int width,
                                       void* stream) {
  return dispatch(dtype, x, nullptr, out, n, scale, threshold, seed, width,
                  stream);
}
