// K7: fused RMSNorm, for Hopper (sm_90a).
//
// Replaces the Pallas kernel repro/kernels/rmsnorm.py:_rmsnorm_kernel
// (launched by rmsnorm).  Same function: y = x * rsqrt(mean(x^2) + eps) *
// scale over the last axis of x (rows, d), in f32 inside, y in x's dtype,
// the scale cast to f32.
//
// What bounds it on this card: the bytes, x read once and y written once
// (plus the (d,) scale), against 3.35 TB/s; it does 4 operations an element.
//
// What the design does about it: one warp per row, 8 rows per block of 256
// threads, so any row count launches (the reference lowered its row block
// until it divided the rows).  A warp sums x^2 in f32 over its row, lanes
// taking 16-byte vectors where d is a multiple of the vector width and the
// rows are 16-byte aligned (scalar loads otherwise), reduces with shuffles,
// then reads its row again (from L1/L2) to write y.  A later step keeps the
// row in registers or shared memory so x is read from HBM exactly once.

#include <cuda_fp16.h>

#include "common.cuh"

namespace {

constexpr int WARPS = 8;
constexpr int DTYPE_F16 = 2;   // beside common.cuh's DTYPE_F32 (0) and DTYPE_BF16 (1)

__device__ __forceinline__ float load_f(float x) { return x; }
__device__ __forceinline__ float load_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float load_f(__half x) { return __half2float(x); }

template <typename T> __device__ __forceinline__ T store_f(float x);
template <> __device__ __forceinline__ float store_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 store_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}
template <> __device__ __forceinline__ __half store_f<__half>(float x) {
  return __float2half(x);
}

template <typename T, typename S, bool VEC>
__global__ void __launch_bounds__(WARPS * 32)
    rmsnorm_kernel(const T* __restrict__ x, const S* __restrict__ scale, T* __restrict__ y,
                   long long rows, int d, float eps) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const long long row = (long long)blockIdx.x * WARPS + warp;
  if (row >= rows) return;
  const T* xr = x + row * d;
  T* yr = y + row * d;
  constexpr int V = 16 / sizeof(T);   // elements per 16-byte vector

  float ss = 0.f;
  if constexpr (VEC) {
    const uint4* xv = reinterpret_cast<const uint4*>(xr);
    for (int i = lane; i < d / V; i += 32) {
      uint4 u = xv[i];
      const T* e = reinterpret_cast<const T*>(&u);
#pragma unroll
      for (int j = 0; j < V; ++j) {
        float f = load_f(e[j]);
        ss += f * f;
      }
    }
  } else {
    for (int i = lane; i < d; i += 32) {
      float f = load_f(xr[i]);
      ss += f * f;
    }
  }
  ss = repro::warp_sum(ss);
  const float r = rsqrtf(ss / (float)d + eps);

  if constexpr (VEC) {
    const uint4* xv = reinterpret_cast<const uint4*>(xr);
    uint4* yv = reinterpret_cast<uint4*>(yr);
    for (int i = lane; i < d / V; i += 32) {
      uint4 u = xv[i];
      const T* e = reinterpret_cast<const T*>(&u);
      uint4 o;
      T* oe = reinterpret_cast<T*>(&o);
#pragma unroll
      for (int j = 0; j < V; ++j) oe[j] = store_f<T>(load_f(e[j]) * r * load_f(scale[i * V + j]));
      yv[i] = o;
    }
  } else {
    for (int i = lane; i < d; i += 32) yr[i] = store_f<T>(load_f(xr[i]) * r * load_f(scale[i]));
  }
}

template <typename T, typename S>
int launch(const void* x, const void* scale, void* y, long long rows, int d, float eps, bool vec,
           cudaStream_t stream) {
  const long long blocks = (rows + WARPS - 1) / WARPS;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  auto* xs = static_cast<const T*>(x);
  auto* ss = static_cast<const S*>(scale);
  auto* ys = static_cast<T*>(y);
  if (vec)
    rmsnorm_kernel<T, S, true><<<(unsigned)blocks, WARPS * 32, 0, stream>>>(xs, ss, ys, rows, d, eps);
  else
    rmsnorm_kernel<T, S, false><<<(unsigned)blocks, WARPS * 32, 0, stream>>>(xs, ss, ys, rows, d, eps);
  return (int)cudaGetLastError();
}

template <typename T>
int by_scale(int scale_dtype, const void* x, const void* scale, void* y, long long rows, int d,
             float eps, bool vec, cudaStream_t stream) {
  switch (scale_dtype) {
    case repro::DTYPE_F32: return launch<T, float>(x, scale, y, rows, d, eps, vec, stream);
    case repro::DTYPE_BF16: return launch<T, __nv_bfloat16>(x, scale, y, rows, d, eps, vec, stream);
    case DTYPE_F16: return launch<T, __half>(x, scale, y, rows, d, eps, vec, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// x, y: (rows, d) contiguous of dtype x_dtype; scale: (d,) of scale_dtype.
// vec != 0 asks for the 16-byte path: the wrapper passes it only where d is
// a multiple of 16 / sizeof(x) and x and y are 16-byte aligned.
extern "C" int repro_rmsnorm(const void* x, const void* scale, void* y, int x_dtype,
                             int scale_dtype, long long rows, int d, float eps, int vec,
                             void* stream) {
  if (rows <= 0 || d <= 0) return (int)cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  switch (x_dtype) {
    case repro::DTYPE_F32: return by_scale<float>(scale_dtype, x, scale, y, rows, d, eps, vec, s);
    case repro::DTYPE_BF16:
      return by_scale<__nv_bfloat16>(scale_dtype, x, scale, y, rows, d, eps, vec, s);
    case DTYPE_F16: return by_scale<__half>(scale_dtype, x, scale, y, rows, d, eps, vec, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
