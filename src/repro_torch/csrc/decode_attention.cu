// K5: single-token decode attention over a ring-buffer KV cache, for Hopper
// (sm_90a).
//
// Replaces the Pallas kernel repro/kernels/decode_attention.py:_decode_kernel
// (launched by decode_attention).  Same function: one query token per batch
// row against the cache k/v (B, S, Hkv, D), valid where kpos >= 0 &&
// kpos <= t (&& kpos > t - window), online softmax in f32, O = 0 on a row
// with no valid key.
//
// What bounds it on this card: the bytes of K and V read,
// 2*B*S*Hkv*D*sizeof(T), against 3.35 TB/s; it does ~2 operations a byte.
//
// What the design does about it: one block per (KV head, batch row), so the
// g = Hq/Hkv query heads of a group share every K/V row loaded (the TPU
// kernel's grid is per query head and reads each row g times).  Eight warps
// split the keys in chunks of 32; in a chunk each lane scores one key against
// all g heads with 16-byte loads, the warp updates its running (m, l) by
// shuffles, and the lanes then switch to owning head dims to accumulate P V
// with coalesced V-row loads, skipping keys that are not valid.  The warps'
// (m, l, acc) combine through shared memory at the end.  `t` is a plain int
// argument; any S works (the chunk tail is masked).  A split-K
// (flash-decoding) grid for B*Hkv below the 132 SMs is a later step.

#include <stdint.h>

#include "common.cuh"

namespace {

using repro::NEG_INF;
using repro::from_f;
using repro::to_f;
using bf16 = __nv_bfloat16;

constexpr int NWARPS = 8;
constexpr int NTHREADS = NWARPS * 32;
constexpr int MAXG = 8;  // query heads per KV head

struct Params {
  const void* q;     // (B, 1, Hq, D)
  const void* k;     // (B, S, Hkv, D)
  const void* v;
  const int* kpos;   // (B, S)
  void* o;           // (B, 1, Hq, D)
  int B, S, Hq, Hkv, t, window;  // window <= 0: none
  float scale;
};

template <typename T> struct Vec;
template <> struct Vec<float> {
  using U = float4;
  static constexpr int N = 4;
  static __device__ __forceinline__ void unpack(const U& u, float* f) {
    f[0] = u.x; f[1] = u.y; f[2] = u.z; f[3] = u.w;
  }
};
template <> struct Vec<bf16> {
  using U = uint4;
  static constexpr int N = 8;
  static __device__ __forceinline__ void unpack(const U& u, float* f) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 x = __bfloat1622float2(h[i]);
      f[2 * i] = x.x;
      f[2 * i + 1] = x.y;
    }
  }
};

template <typename T, int D>
__global__ void __launch_bounds__(NTHREADS) decode_kernel(const Params p) {
  constexpr int DL = (D + 31) / 32;  // head dims per lane: d = lane + 32 * i
  using V = Vec<T>;
  __shared__ float q_s[MAXG][D];
  __shared__ float p_s[NWARPS][MAXG][32];
  __shared__ float m_w[NWARPS][MAXG];
  __shared__ float l_w[NWARPS][MAXG];
  __shared__ float acc_w[NWARPS][MAXG][D];

  const int hk = blockIdx.x, b = blockIdx.y;
  const int G = p.Hq / p.Hkv;
  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;

  const T* qg = static_cast<const T*>(p.q) + ((long long)b * p.Hq + hk * G) * D;
  for (int i = tid; i < G * D; i += NTHREADS) q_s[i / D][i % D] = to_f(qg[i]) * p.scale;
  __syncthreads();

  const long long row = (long long)p.Hkv * D;  // elements from one key to the next
  const T* kg = static_cast<const T*>(p.k) + ((long long)b * p.S * p.Hkv + hk) * D;
  const T* vg = static_cast<const T*>(p.v) + ((long long)b * p.S * p.Hkv + hk) * D;
  const int* kp = p.kpos + (long long)b * p.S;

  float m[MAXG], l[MAXG], acc[MAXG][DL];
#pragma unroll
  for (int g = 0; g < MAXG; ++g) {
    m[g] = NEG_INF;
    l[g] = 0.f;
#pragma unroll
    for (int i = 0; i < DL; ++i) acc[g][i] = 0.f;
  }

  const int nchunks = (p.S + 31) / 32;
  for (int ch = w; ch < nchunks; ch += NWARPS) {
    const int j = ch * 32 + lane;
    bool ok = false;
    if (j < p.S) {
      const int pos = kp[j];
      ok = pos >= 0 && pos <= p.t && (p.window <= 0 || pos > p.t - p.window);
    }
    const unsigned valid = __ballot_sync(0xffffffffu, ok);
    if (valid == 0u) continue;  // nothing to add: m, l and acc stay as they are

    float s[MAXG];
#pragma unroll
    for (int g = 0; g < MAXG; ++g) s[g] = 0.f;
    if (ok) {
      const typename V::U* kr = reinterpret_cast<const typename V::U*>(kg + j * row);
#pragma unroll 4
      for (int c = 0; c < D / V::N; ++c) {
        float kv[V::N];
        V::unpack(kr[c], kv);
#pragma unroll
        for (int g = 0; g < MAXG; ++g) {
          if (g < G) {
#pragma unroll
            for (int e = 0; e < V::N; ++e) s[g] = fmaf(q_s[g][c * V::N + e], kv[e], s[g]);
          }
        }
      }
    }

#pragma unroll
    for (int g = 0; g < MAXG; ++g) {
      if (g < G) {
        const float sg = ok ? s[g] : NEG_INF;
        const float m_new = fmaxf(m[g], repro::warp_max(sg));
        const float alpha = expf(m[g] - m_new);
        const float pg = ok ? expf(sg - m_new) : 0.f;  // masked: exactly 0
        l[g] = l[g] * alpha + repro::warp_sum(pg);
        m[g] = m_new;
        p_s[w][g][lane] = pg;
#pragma unroll
        for (int i = 0; i < DL; ++i) acc[g][i] *= alpha;
      }
    }
    __syncwarp();
    for (int jj = 0; jj < 32; ++jj) {
      if (!((valid >> jj) & 1u)) continue;
      const T* vr = vg + (ch * 32 + jj) * row;
#pragma unroll
      for (int i = 0; i < DL; ++i) {
        const int d = lane + 32 * i;
        if (d < D) {
          const float vv = to_f(vr[d]);
#pragma unroll
          for (int g = 0; g < MAXG; ++g)
            if (g < G) acc[g][i] = fmaf(p_s[w][g][jj], vv, acc[g][i]);
        }
      }
    }
    __syncwarp();  // p_s is rewritten by the next chunk
  }

#pragma unroll
  for (int g = 0; g < MAXG; ++g) {
    if (g < G) {
      if (lane == 0) {
        m_w[w][g] = m[g];
        l_w[w][g] = l[g];
      }
#pragma unroll
      for (int i = 0; i < DL; ++i) {
        const int d = lane + 32 * i;
        if (d < D) acc_w[w][g][d] = acc[g][i];
      }
    }
  }
  __syncthreads();

  T* og = static_cast<T*>(p.o) + ((long long)b * p.Hq + hk * G) * D;
  for (int i = tid; i < G * D; i += NTHREADS) {
    const int g = i / D, d = i % D;
    float M = NEG_INF;
    for (int ww = 0; ww < NWARPS; ++ww) M = fmaxf(M, m_w[ww][g]);
    float L = 0.f, O = 0.f;
    for (int ww = 0; ww < NWARPS; ++ww) {
      const float sc = expf(m_w[ww][g] - M);
      L = fmaf(l_w[ww][g], sc, L);
      O = fmaf(acc_w[ww][g][d], sc, O);
    }
    og[i] = from_f<T>(O / fmaxf(L, 1e-30f));
  }
}

template <typename T>
int dispatch(int D, const Params& p, cudaStream_t s) {
  const dim3 grid(p.Hkv, p.B);
  switch (D) {
    case 16: decode_kernel<T, 16><<<grid, NTHREADS, 0, s>>>(p); break;
    case 64: decode_kernel<T, 64><<<grid, NTHREADS, 0, s>>>(p); break;
    case 96: decode_kernel<T, 96><<<grid, NTHREADS, 0, s>>>(p); break;
    case 128: decode_kernel<T, 128><<<grid, NTHREADS, 0, s>>>(p); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int repro_decode_attention(const void* q, const void* k, const void* v,
                                      const void* kpos, void* o, int dtype, int B, int S,
                                      int Hq, int Hkv, int D, int t, int window, float scale,
                                      void* stream) {
  if (Hkv <= 0 || Hq % Hkv != 0 || Hq / Hkv > MAXG) return (int)cudaErrorInvalidValue;
  const Params p{q, k, v, static_cast<const int*>(kpos), o, B, S, Hq, Hkv, t, window, scale};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == repro::DTYPE_F32) return dispatch<float>(D, p, s);
  if (dtype == repro::DTYPE_BF16) return dispatch<bf16>(D, p, s);
  return (int)cudaErrorInvalidValue;
}
