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
// 0.0120 ms.  The design: a grid-stride loop in which each thread draws one
// Philox block (4 words) for 4 consecutive elements and moves them with one
// 16-byte (fp32) or 8-byte (bf16) access per tensor when every pointer is
// aligned, scalar accesses otherwise and for the ragged tail.  Philox-10
// costs about 100 integer instructions per 4 elements, which at the SM's
// 64 INT32 lanes is of the order of the memory time; 8 blocks of 256
// threads per SM keep enough loads in flight to cover it.

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

cudaError_t grid_for(long long n, int* blocks) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const long long groups = (n + 3) / 4;
  const long long want = (groups + kThreads - 1) / kThreads;
  const long long most = static_cast<long long>(sms) * kBlocksPerSm;
  *blocks = static_cast<int>(want < most ? want : most);
  return cudaSuccess;
}

template <typename T>
cudaError_t launch(const void* x, const void* res, void* out, long long n,
                   float scale, uint32_t threshold, unsigned long long seed,
                   int vec, cudaStream_t stream) {
  int blocks = 0;
  cudaError_t err = grid_for(n, &blocks);
  if (err != cudaSuccess) return err;
  if (res != nullptr) {
    fused_dropout_add_kernel<T><<<blocks, kThreads, 0, stream>>>(
        static_cast<const T*>(x), static_cast<const T*>(res),
        static_cast<T*>(out), n, scale, threshold, seed, vec);
  } else {
    fused_dropout_scale_kernel<T><<<blocks, kThreads, 0, stream>>>(
        static_cast<const T*>(x), static_cast<T*>(out), n, scale, threshold,
        seed, vec);
  }
  return cudaGetLastError();
}

int dispatch(int dtype, const void* x, const void* res, void* out,
             long long n, float scale, unsigned int threshold,
             unsigned long long seed, int vec, void* stream) {
  if (n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return static_cast<int>(
        launch<float>(x, res, out, n, scale, threshold, seed, vec, s));
  if (dtype == 1)
    return static_cast<int>(launch<__nv_bfloat16>(x, res, out, n, scale,
                                                  threshold, seed, vec, s));
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  x, res, out: n contiguous elements of
// that dtype.  scale: 1 / (1 - rate) rounded to the dtype.  An element is
// kept when its Philox word under `seed` is >= threshold.  vec: 1 when every
// pointer is aligned to 4 elements (vector accesses).  Returns the
// cudaError_t of the launch (0 on success).
extern "C" int m3p_fused_dropout_add(int dtype, const void* x,
                                     const void* res, void* out, long long n,
                                     float scale, unsigned int threshold,
                                     unsigned long long seed, int vec,
                                     void* stream) {
  if (res == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return dispatch(dtype, x, res, out, n, scale, threshold, seed, vec, stream);
}

extern "C" int m3p_fused_dropout_scale(int dtype, const void* x, void* out,
                                       long long n, float scale,
                                       unsigned int threshold,
                                       unsigned long long seed, int vec,
                                       void* stream) {
  return dispatch(dtype, x, nullptr, out, n, scale, threshold, seed, vec,
                  stream);
}
