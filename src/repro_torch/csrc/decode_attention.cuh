// The single-token decode attention body shared by K5 (decode_attention.cu,
// a ring cache) and K6 (paged_decode_attention.cu, a block-paged pool).
//
// One block per (KV head, batch row), so the g = Hq/Hkv query heads of a
// group share every K/V row loaded.  Keys are taken in chunks of 32, chunk ch
// by warp ch % 8; in a chunk each lane scores one key against all g heads
// with 16-byte loads, the warp updates its running (m, l) by shuffles, and the
// lanes then switch to owning head dims to accumulate P V with coalesced
// V-row loads, skipping keys that are not valid (a masked key is never read).
// The warps' (m, l, acc) combine through shared memory at the end.  Scores,
// softmax and accumulation are in f32; the output is cast at the end; a row
// with no valid key gives O = 0.
//
// The two layouts differ only in where key j's row lies and whether it is
// valid (KeyRows below).  The chunk-to-warp assignment and every operation's
// order are the same for both, so K6 over a pool equals K5 over the same K/V
// laid out contiguously (kpos = logical position, -1 on unmapped pages)
// bit for bit.  Any head dim D that is a multiple of 8 up to 128: the body
// is instantiated for DMAX = 16/32/64/96/128 (its shared arrays and
// per-lane registers) and loops over D, in D/8 (bf16) or D/4 (f32) 16-byte
// vectors per K row.

#pragma once

#include <stdint.h>

#include "common.cuh"

namespace repro {
namespace decode {

constexpr int NWARPS = 8;
constexpr int NTHREADS = NWARPS * 32;
constexpr int MAXG = 8;  // query heads per KV head

struct Params {
  const void* q;           // (B, 1, Hq, D)
  const void* k;           // ring: (B, S, Hkv, D); paged: (n_pages, ps, Hkv, D)
  const void* v;
  const int* kpos;         // ring: (B, S) positions, -1 = empty slot
  const int* page_table;   // paged: (B, n_max) physical pages, -1 = unmapped
  const int* ts;           // (B,) per-row query positions, or null: t for all rows
  void* o;                 // (B, 1, Hq, D)
  int B, S, Hq, Hkv, D, t, window;  // paged: S = n_max * ps; window <= 0: none
  int ps, n_max;
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
template <> struct Vec<__nv_bfloat16> {
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

// Where key j of row b lies (its row offset into k and v, in units of D
// elements) and whether the query at position t may attend to it.
template <bool PAGED>
struct KeyRows {
  const int* kpos;
  const int* page_table;
  int S, Hkv, window, ps, n_max, b, hk, t;

  // keys [lo, hi) hold every valid one: the loop over chunks stays inside
  __device__ __forceinline__ void range(int* lo, int* hi) const {
    if (PAGED) {  // positions are implicit: key j sits at position j
      *hi = min(t + 1, S);
      *lo = window > 0 ? max(0, t - window + 1) : 0;
    } else {      // positions are data (kpos): any slot may hold any
      *lo = 0;
      *hi = S;
    }
  }

  __device__ __forceinline__ bool key(int j, int lo, int hi, long long* off) const {
    if (j < lo || j >= hi) return false;
    if (PAGED) {  // unmapped (-1) pages are skipped: the trash page is never read
      const int page = page_table[(long long)b * n_max + j / ps];
      if (page < 0) return false;
      *off = ((long long)page * ps + j % ps) * Hkv + hk;
      return true;
    }
    const int pos = kpos[(long long)b * S + j];
    if (pos < 0 || pos > t || (window > 0 && pos <= t - window)) return false;
    *off = ((long long)b * S + j) * Hkv + hk;
    return true;
  }
};

template <typename T, int DMAX, bool PAGED>
__global__ void __launch_bounds__(NTHREADS) decode_kernel(const Params p) {
  constexpr int DL = (DMAX + 31) / 32;  // head dims per lane: d = lane + 32 * i
  using V = Vec<T>;
  __shared__ float q_s[MAXG][DMAX];
  __shared__ float p_s[NWARPS][MAXG][32];
  __shared__ float m_w[NWARPS][MAXG];
  __shared__ float l_w[NWARPS][MAXG];
  __shared__ float acc_w[NWARPS][MAXG][DMAX];
  const int D = p.D;  // <= DMAX, a multiple of 8

  const int hk = blockIdx.x, b = blockIdx.y;
  const int G = p.Hq / p.Hkv;
  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  const int t = p.ts != nullptr ? p.ts[b] : p.t;
  const KeyRows<PAGED> rows{p.kpos, p.page_table, p.S, p.Hkv, p.window, p.ps, p.n_max,
                            b, hk, t};

  const T* qg = static_cast<const T*>(p.q) + ((long long)b * p.Hq + hk * G) * D;
  for (int i = tid; i < G * D; i += NTHREADS) q_s[i / D][i % D] = to_f(qg[i]) * p.scale;
  __syncthreads();

  const T* kbase = static_cast<const T*>(p.k);
  const T* vbase = static_cast<const T*>(p.v);

  float m[MAXG], l[MAXG], acc[MAXG][DL];
#pragma unroll
  for (int g = 0; g < MAXG; ++g) {
    m[g] = NEG_INF;
    l[g] = 0.f;
#pragma unroll
    for (int i = 0; i < DL; ++i) acc[g][i] = 0.f;
  }

  int lo, hi;
  rows.range(&lo, &hi);
  const int ch_lo = lo / 32, ch_hi = hi > lo ? (hi + 31) / 32 : 0;
  // chunk ch belongs to warp ch % NWARPS whatever the range, so that both
  // layouts sum in the same order
  for (int ch = (ch_lo / NWARPS) * NWARPS + w; ch < ch_hi; ch += NWARPS) {
    const int j = ch * 32 + lane;
    long long off = 0;  // row offset in units of D elements
    const bool ok = ch >= ch_lo && rows.key(j, lo, hi, &off);
    const unsigned valid = __ballot_sync(0xffffffffu, ok);
    if (valid == 0u) continue;  // nothing to add: m, l and acc stay as they are

    float s[MAXG];
#pragma unroll
    for (int g = 0; g < MAXG; ++g) s[g] = 0.f;
    if (ok) {
      const typename V::U* kr = reinterpret_cast<const typename V::U*>(kbase + off * D);
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
        const float m_new = fmaxf(m[g], warp_max(sg));
        const float alpha = expf(m[g] - m_new);
        const float pg = ok ? expf(sg - m_new) : 0.f;  // masked: exactly 0
        l[g] = l[g] * alpha + warp_sum(pg);
        m[g] = m_new;
        p_s[w][g][lane] = pg;
#pragma unroll
        for (int i = 0; i < DL; ++i) acc[g][i] *= alpha;
      }
    }
    __syncwarp();
    for (int jj = 0; jj < 32; ++jj) {
      const long long offj = __shfl_sync(0xffffffffu, off, jj);
      if (!((valid >> jj) & 1u)) continue;
      const T* vr = vbase + offj * D;
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

template <typename T, bool PAGED>
int launch(const Params& p, cudaStream_t s) {
  const dim3 grid(p.Hkv, p.B);
  if (p.D <= 16) decode_kernel<T, 16, PAGED><<<grid, NTHREADS, 0, s>>>(p);
  else if (p.D <= 32) decode_kernel<T, 32, PAGED><<<grid, NTHREADS, 0, s>>>(p);
  else if (p.D <= 64) decode_kernel<T, 64, PAGED><<<grid, NTHREADS, 0, s>>>(p);
  else if (p.D <= 96) decode_kernel<T, 96, PAGED><<<grid, NTHREADS, 0, s>>>(p);
  else decode_kernel<T, 128, PAGED><<<grid, NTHREADS, 0, s>>>(p);
  return (int)cudaGetLastError();
}

template <bool PAGED>
int dispatch(int dtype, int D, Params p, cudaStream_t s) {
  if (p.Hkv <= 0 || p.Hq % p.Hkv != 0 || p.Hq / p.Hkv > MAXG || p.B <= 0 || D < 8 ||
      D > 128 || D % 8)
    return (int)cudaErrorInvalidValue;
  p.D = D;
  if (dtype == DTYPE_F32) return launch<float, PAGED>(p, s);
  if (dtype == DTYPE_BF16) return launch<__nv_bfloat16, PAGED>(p, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace decode
}  // namespace repro
