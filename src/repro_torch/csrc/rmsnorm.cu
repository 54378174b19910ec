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
// What the design does about it: each row of x is read from device memory
// exactly once, the scale once per block, and x and y go through L2 with
// evict-first hints (ld/st.global.cs), since each is touched once.  Blocks are persistent (at most
// as many as fit on the card at once) and stage the scale in shared memory
// as f32 once, while their first rows are on the way.
// - Rows of up to 4 KB whose d is a multiple of the 16-byte vector and whose
//   x and y are 16-byte aligned (the wrapper's `vec`): one warp per row,
//   8 rows at a time per block.  A lane loads its VPL 16-byte vectors of
//   the row into registers, all at once (VPL = 8 at d = 2048 in bf16), sums
//   x^2 in f32, the warp reduces by shuffles, and the lane writes y from
//   the same registers with 16-byte stores.
// - Any other row (d = 2047, d = 8192, f32 at d = 2048, misaligned): one
//   block per row.  The
//   block loads the row into shared memory (16-byte vectors where `vec`,
//   elements otherwise) while it sums x^2, reduces through shared memory,
//   then writes y from shared memory.  A row too long for shared memory
//   beside the scale (d above 25,600 in f32, 34,133 in bf16) is read a
//   second time from device memory (L2) instead, and its scale from device
//   memory on every row; no configuration has such a row.

#include <cuda_fp16.h>

#include "common.cuh"

namespace {

constexpr int WARPS = 8;                // warps a block
constexpr int THREADS = WARPS * 32;
constexpr int DTYPE_F16 = 2;   // beside common.cuh's DTYPE_F32 (0) and DTYPE_BF16 (1)
constexpr int MAX_SMEM = 200 * 1024;    // dynamic shared memory a block may ask for
constexpr int MAX_VPL = 8;              // 16-byte vectors a lane holds: rows up to 4 KB

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

// the scale, cast to f32, into shared memory, once per block
template <typename S>
__device__ __forceinline__ void stage_scale(const S* __restrict__ scale, float* scale_s, int d) {
  for (int i = threadIdx.x; i < d; i += blockDim.x) scale_s[i] = load_f(scale[i]);
  __syncthreads();
}

// One warp per row, the row in registers: lane l holds the 16-byte vectors
// l, l + 32, ..., l + 32 (VPL - 1) of it.
template <typename T, typename S, int VPL>
__global__ void __launch_bounds__(THREADS)
    rmsnorm_rows(const T* __restrict__ x, const S* __restrict__ scale, T* __restrict__ y,
                 long long rows, int d, float eps) {
  extern __shared__ float scale_s[];
  constexpr int V = 16 / sizeof(T);     // elements a vector
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int nv = d / V;                 // vectors a row
  const long long stride = (long long)gridDim.x * WARPS;
  long long row = (long long)blockIdx.x * WARPS + warp;
  uint4 u[VPL];
  // a row's vectors, every load issued before any is used; the first row
  // travels while the scale is staged
#define REPRO_LOAD_ROW                                                   \
  {                                                                      \
    const uint4* xv = reinterpret_cast<const uint4*>(x + row * d);       \
    _Pragma("unroll") for (int k = 0; k < VPL; ++k) {                    \
      const int i = lane + 32 * k;                                       \
      u[k] = row < rows && i < nv ? __ldcs(xv + i) : make_uint4(0, 0, 0, 0); \
    }                                                                    \
  }
  REPRO_LOAD_ROW
  stage_scale(scale, scale_s, d);
  while (row < rows) {
    float ss = 0.f;
#pragma unroll
    for (int k = 0; k < VPL; ++k) {
      if (lane + 32 * k < nv) {
        const T* e = reinterpret_cast<const T*>(&u[k]);
#pragma unroll
        for (int j = 0; j < V; ++j) {
          const float f = load_f(e[j]);
          ss = fmaf(f, f, ss);
        }
      }
    }
    ss = repro::warp_sum(ss);
    const float r = rsqrtf(ss / (float)d + eps);
    uint4* yv = reinterpret_cast<uint4*>(y + row * d);
#pragma unroll
    for (int k = 0; k < VPL; ++k) {
      const int i = lane + 32 * k;
      if (i < nv) {
        const T* e = reinterpret_cast<const T*>(&u[k]);
        const float* sc = scale_s + i * V;
        uint4 o;
        T* oe = reinterpret_cast<T*>(&o);
#pragma unroll
        for (int j = 0; j < V; ++j) oe[j] = store_f<T>(load_f(e[j]) * r * sc[j]);
        __stcs(yv + i, o);
      }
    }
    row += stride;
    REPRO_LOAD_ROW
  }
#undef REPRO_LOAD_ROW
}

// One block per row.  STAGE: the scale and the row go through shared
// memory; otherwise (a row too long for it) the second pass reads the row
// again from device memory and the scale from device memory on every row.
template <typename T, typename S, bool VEC, bool STAGE>
__global__ void __launch_bounds__(THREADS)
    rmsnorm_block(const T* __restrict__ x, const S* __restrict__ scale, T* __restrict__ y,
                  long long rows, int d, float eps) {
  extern __shared__ float scale_s[];
  __shared__ float red[WARPS];
  constexpr int V = 16 / sizeof(T);
  T* row_s = reinterpret_cast<T*>(scale_s + ((d + 3) & ~3));   // 16-byte aligned
  if constexpr (STAGE) stage_scale(scale, scale_s, d);
  auto sc = [&](int i) {
    if constexpr (STAGE) return scale_s[i];
    else return load_f(scale[i]);
  };
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (long long row = blockIdx.x; row < rows; row += gridDim.x) {
    const T* xr = x + row * d;
    T* yr = y + row * d;
    float ss = 0.f;
    if constexpr (VEC) {
      const uint4* xv = reinterpret_cast<const uint4*>(xr);
      for (int i = threadIdx.x; i < d / V; i += THREADS) {
        const uint4 u = __ldcs(xv + i);
        if constexpr (STAGE) reinterpret_cast<uint4*>(row_s)[i] = u;
        const T* e = reinterpret_cast<const T*>(&u);
#pragma unroll
        for (int j = 0; j < V; ++j) {
          const float f = load_f(e[j]);
          ss = fmaf(f, f, ss);
        }
      }
    } else {
      for (int i = threadIdx.x; i < d; i += THREADS) {
        const T u = xr[i];
        if constexpr (STAGE) row_s[i] = u;
        const float f = load_f(u);
        ss = fmaf(f, f, ss);
      }
    }
    ss = repro::warp_sum(ss);
    if (lane == 0) red[warp] = ss;
    __syncthreads();                    // red and row_s complete
    float tot = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) tot += red[w];
    const float r = rsqrtf(tot / (float)d + eps);
    const T* src = STAGE ? row_s : xr;
    if constexpr (VEC) {
      const uint4* sv = reinterpret_cast<const uint4*>(src);
      uint4* yv = reinterpret_cast<uint4*>(yr);
      for (int i = threadIdx.x; i < d / V; i += THREADS) {
        const uint4 u = sv[i];
        const T* e = reinterpret_cast<const T*>(&u);
        uint4 o;
        T* oe = reinterpret_cast<T*>(&o);
#pragma unroll
        for (int j = 0; j < V; ++j) oe[j] = store_f<T>(load_f(e[j]) * r * sc(i * V + j));
        __stcs(yv + i, o);
      }
    } else {
      for (int i = threadIdx.x; i < d; i += THREADS) yr[i] = store_f<T>(load_f(src[i]) * r * sc(i));
    }
    __syncthreads();                    // red and row_s are rewritten by the next row
  }
}

// Launch KERNEL on at most as many blocks as are resident on the card at
// once (the SM count and the kernel's occupancy at `smem`, asked once).
template <auto KERNEL, typename T, typename S>
int run(long long blocks, int smem, const void* x, const void* scale, void* y, long long rows,
        int d, float eps, cudaStream_t stream) {
  static int cap = 0, cap_smem = -1;
  if (cap_smem != smem) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(KERNEL, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, KERNEL, THREADS, smem);
    if (e != cudaSuccess) return (int)e;
    if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
    cap = sms * per_sm;
    cap_smem = smem;
  }
  const int grid = (int)(blocks < cap ? blocks : cap);
  KERNEL<<<grid, THREADS, smem, stream>>>(static_cast<const T*>(x), static_cast<const S*>(scale),
                                          static_cast<T*>(y), rows, d, eps);
  return (int)cudaGetLastError();
}

template <typename T, typename S>
int launch(const void* x, const void* scale, void* y, long long rows, int d, float eps, bool vec,
           cudaStream_t stream) {
  constexpr int V = 16 / sizeof(T);
  const int scale_bytes = ((d + 3) & ~3) * 4;
  if (vec && d / V <= 32 * MAX_VPL) {   // the row in registers: a warp a row
    const long long blocks = (rows + WARPS - 1) / WARPS;
    const int vpl = (d / V + 31) / 32;
#define REPRO_ROWS(N)                                                                    \
  if (vpl <= N)                                                                          \
    return run<rmsnorm_rows<T, S, N>, T, S>(blocks, scale_bytes, x, scale, y, rows, d, eps, \
                                            stream);
    REPRO_ROWS(1)
    REPRO_ROWS(2)
    REPRO_ROWS(4)
    REPRO_ROWS(8)
#undef REPRO_ROWS
  }
  const long long staged = (long long)scale_bytes + (long long)d * sizeof(T);
  const bool stage = staged <= MAX_SMEM;
  const int smem = stage ? (int)staged : 0;
#define REPRO_BLOCK(VEC, STAGE)                                                              \
  if (vec == VEC && stage == STAGE)                                                          \
    return run<rmsnorm_block<T, S, VEC, STAGE>, T, S>(rows, smem, x, scale, y, rows, d, eps, \
                                                      stream);
  REPRO_BLOCK(true, true)
  REPRO_BLOCK(false, true)
  REPRO_BLOCK(true, false)
  REPRO_BLOCK(false, false)
#undef REPRO_BLOCK
  return (int)cudaErrorInvalidValue;
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
