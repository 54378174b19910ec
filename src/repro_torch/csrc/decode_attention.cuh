// The single-token decode attention body shared by K5 (decode_attention.cu,
// a ring cache) and K6 (paged_decode_attention.cu, a block-paged pool):
// flash-decoding, the keys split across blocks so that a small B * Hkv
// fills the card, then the splits combined in a fixed order.
//
// Split kernel: one block per (split, KV head, batch row), so the g = Hq/Hkv
// query heads of a group share every K/V row loaded.  Split s holds the
// logical keys [s * split_len, (s + 1) * split_len): split_len is a multiple
// of 32 that the wrapper picks from B, Hkv and S alone, so the boundaries sit
// on the same absolute keys for a ring and for a pool of the same length.
// Inside a split, keys go in chunks of 32.  A warp owns query heads: with
// g >= 4 the four warps take heads w and w + 4 of every chunk; with g = 2 or
// 3 two warps share a chunk and the two pairs take alternate chunks; with
// g = 1 each warp takes every fourth chunk.  A step copies the block's
// chunks' K and V rows into shared memory with 16-byte cp.async (any row
// address: the same code gathers K6's pages; rows of invalid keys are
// zero-filled without a read), the next step's copies in flight while this
// one is used.  Lane j scores key j against the warp's heads from shared
// memory (rows padded by 16 bytes, so the lanes' 16-byte reads do not
// conflict), the warp updates its running (m, l) by shuffles, and the lanes
// then own pairs of head dims to accumulate P V over the 32 V rows, each
// key's p passed by shuffle.  A chunk with no valid key is skipped, and a
// split wholly outside the keys the query can see reads nothing.  The
// (m, l, acc) of the warps that share a head combine through shared memory
// into the split's partial, which goes to an f32 workspace: (m, l) per
// (row, head, split), and acc only where l > 0.
//
// Combine kernel: one block per (query head, batch row) weighs the splits,
// e^(m - M), 0 for those with l = 0 (whose acc is never read, so an empty
// split leaves O exact), sums acc over them in a fixed order with many loads
// in flight, and writes O = sum(acc w) / sum(l w) in the output dtype; a row
// with no valid key gives O = 0.  It is launched with programmatic
// dependent launch, so its blocks are resident before the split kernel ends
// and wait for it with griddepcontrol.wait.  No atomics anywhere: equal
// inputs give equal bits.
//
// The two layouts differ only in where key j's row lies and whether it is
// valid (KeyRows below).  The split plan, the chunk-to-warp assignment and
// every operation's order are the same for both, so K6 over a pool equals
// K5 over the same K/V laid out contiguously (kpos = logical position, -1 on
// unmapped pages) bit for bit.  Any head dim D that is a multiple of 8 up to
// 128: the body is instantiated for DMAX = 16/32/64/96/128 (its shared
// arrays and per-lane registers) and loops over D.  Scores, softmax and
// accumulation are in f32.

#pragma once

#include <stdint.h>

#include "common.cuh"

namespace repro {
namespace decode {

constexpr int NWARPS = 4;
constexpr int NTHREADS = NWARPS * 32;
constexpr int MAXG = 8;                 // query heads per KV head
constexpr int CHUNK = 32;               // keys a warp takes at a time
constexpr int SMEM_MAX = 200 * 1024;    // dynamic shared memory a split block may ask for
constexpr int COMBINE_THREADS = 128;
constexpr int MAX_SPLITS = 4096;       // the combine's weights stay in shared memory

struct Params {
  const void* q;           // (B, 1, Hq, D)
  const void* k;           // ring: (B, S, Hkv, D); paged: (n_pages, ps, Hkv, D)
  const void* v;
  const int* kpos;         // ring: (B, S) positions, -1 = empty slot
  const int* page_table;   // paged: (B, n_max) physical pages, -1 = unmapped
  const int* ts;           // (B,) per-row query positions, or null: t for all rows
  void* o;                 // (B, 1, Hq, D)
  float* ws;               // (B*Hq*n_splits) (m, l) pairs, then (B*Hq*n_splits, D) acc
  int B, S, Hq, Hkv, D, t, window;  // paged: S = n_max * ps; window <= 0: none
  int ps, n_max;
  int split_len, n_splits;
  int stages;              // chunks a warp has in flight: 2 where a warp takes several
  float scale;
};

template <typename T> struct Vec;
template <> struct Vec<float> {
  using U = float4;
  static constexpr int N = 4;
  static __device__ __forceinline__ void unpack(const U& u, float* f) {
    f[0] = u.x; f[1] = u.y; f[2] = u.z; f[3] = u.w;
  }
  // the head dims d, d + 1 of a row
  static __device__ __forceinline__ float2 pair(const float* row, int d) {
    return *reinterpret_cast<const float2*>(row + d);
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
  static __device__ __forceinline__ float2 pair(const __nv_bfloat16* row, int d) {
    return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(row + d));
  }
};

// How the g heads of a group map onto the warps: WC warps share a chunk
// (the most of 4, 2, 1 that is at most g), warp w taking heads w % WC,
// w % WC + WC (at most HPW of them), and the R = NWARPS / WC groups of warps
// take alternate chunks.
constexpr int HPW = 2;
__host__ __device__ constexpr int warps_per_chunk(int g) { return g >= 4 ? 4 : g >= 2 ? 2 : 1; }

// A split block's shared memory: `stages` steps of R chunks of K rows and of
// V rows, each row padded by 16 bytes.  Two stages (one step copied while the
// other is used) where the split takes more than one step and they fit; one
// otherwise.
template <typename T, int DMAX>
struct Layout {
  static constexpr int ROW = DMAX * (int)sizeof(T) + 16;
  static constexpr int TILE = CHUNK * ROW;                 // one chunk's K (or V)
  static constexpr int smem(int stages, int R) { return stages * R * 2 * TILE; }
  static_assert(2 * TILE >= NWARPS * HPW * DMAX * 4, "the warps' acc reuse the tiles");
};

// 16 bytes from gmem to smem, or (n = 0) 16 zero bytes and no read
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, int n) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem), "r"(n)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Where key j of row b lies (its row index into k and v, in units of D
// elements) and whether the query at position t may attend to it.
template <bool PAGED>
struct KeyRows {
  const int* kpos;
  const int* page_table;
  int S, Hkv, window, ps, n_max, b, hk, t;

  // keys [lo, hi) hold every valid one: the splits stay inside
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

// One warp's work on one chunk of 32 keys whose K and V rows sit in shared
// memory at ks (V one tile after K), for its NH heads wl, wl + WC: lane j
// scores key j, the online softmax moves (m, l, acc), then lane l
// accumulates P V for head dims 2 l + 64 i, each key's p passed by shuffle.
// A masked key has p = 0 and a zero row, so it adds exactly 0.
template <int NH, typename T, int DMAX>
__device__ __forceinline__ void chunk(const unsigned char* ks, int lane, int vpr, int D, int wl,
                                      int WC, const float (*q_s)[DMAX], bool ok,
                                      float (&m)[HPW], float (&l)[HPW],
                                      float (&acc)[HPW][2 * ((DMAX + 63) / 64)]) {
  using L = Layout<T, DMAX>;
  using V = Vec<T>;
  constexpr int DP = (DMAX + 63) / 64;
  const typename V::U* kr = reinterpret_cast<const typename V::U*>(ks + lane * L::ROW);
  float s0[NH], s1[NH];                 // two partial sums: a shorter dependent chain
#pragma unroll
  for (int h = 0; h < NH; ++h) s0[h] = s1[h] = 0.f;
#pragma unroll 4
  for (int cv = 0; cv < vpr; ++cv) {
    float kv[V::N];
    V::unpack(kr[cv], kv);
#pragma unroll
    for (int h = 0; h < NH; ++h) {
      const float4* qv = reinterpret_cast<const float4*>(q_s[wl + WC * h] + cv * V::N);
#pragma unroll
      for (int e4 = 0; e4 < V::N / 4; ++e4) {
        const float4 q4 = qv[e4];
        s0[h] = fmaf(q4.x, kv[4 * e4], s0[h]);
        s1[h] = fmaf(q4.y, kv[4 * e4 + 1], s1[h]);
        s0[h] = fmaf(q4.z, kv[4 * e4 + 2], s0[h]);
        s1[h] = fmaf(q4.w, kv[4 * e4 + 3], s1[h]);
      }
    }
  }
  float pk[NH];
#pragma unroll
  for (int h = 0; h < NH; ++h) {
    const float sg = ok ? s0[h] + s1[h] : NEG_INF;
    const float m_new = fmaxf(m[h], warp_max(sg));
    const float alpha = expf(m[h] - m_new);
    pk[h] = ok ? expf(sg - m_new) : 0.f;  // masked: exactly 0
    l[h] = l[h] * alpha + warp_sum(pk[h]);
    m[h] = m_new;
#pragma unroll
    for (int i = 0; i < 2 * DP; ++i) acc[h][i] *= alpha;
  }
  const T* vs = reinterpret_cast<const T*>(ks + L::TILE);
#pragma unroll 8
  for (int jj = 0; jj < CHUNK; ++jj) {
    const T* vr = vs + jj * (L::ROW / (int)sizeof(T));
    float pj[NH];
#pragma unroll
    for (int h = 0; h < NH; ++h) pj[h] = __shfl_sync(0xffffffffu, pk[h], jj);
#pragma unroll
    for (int i = 0; i < DP; ++i) {
      const int d = 2 * lane + 64 * i;
      if (d < D) {
        const float2 vv = V::pair(vr, d);
#pragma unroll
        for (int h = 0; h < NH; ++h) {
          acc[h][2 * i] = fmaf(pj[h], vv.x, acc[h][2 * i]);
          acc[h][2 * i + 1] = fmaf(pj[h], vv.y, acc[h][2 * i + 1]);
        }
      }
    }
  }
}

template <typename T, int DMAX, bool PAGED>
__global__ void __launch_bounds__(NTHREADS) decode_split_kernel(const Params p) {
  using L = Layout<T, DMAX>;
  using V = Vec<T>;
  constexpr int DP = (DMAX + 63) / 64;  // head-dim pairs a lane owns: d = 2 lane + 64 i
  extern __shared__ __align__(16) unsigned char ring[];
  __shared__ __align__(16) float q_s[MAXG][DMAX];   // read as float4 broadcasts
  __shared__ unsigned valid_s[2][NWARPS];   // per stage, per group of warps
  __shared__ float m_w[NWARPS][HPW];
  __shared__ float l_w[NWARPS][HPW];

  // the combine kernel may be scheduled now; it waits for this grid's end
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");

  const int split = blockIdx.x, hk = blockIdx.y, b = blockIdx.z;
  const int G = p.Hq / p.Hkv, D = p.D;
  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  const int WC = warps_per_chunk(G), R = NWARPS / WC;
  const int grp = w / WC, wl = w % WC;  // this warp's group; its heads are wl, wl + WC
  const bool two = wl + WC < G;         // whether it owns a second head
  const int t = p.ts != nullptr ? p.ts[b] : p.t;
  const KeyRows<PAGED> rows{p.kpos, p.page_table, p.S, p.Hkv, p.window, p.ps, p.n_max,
                            b, hk, t};
  int lo_all, hi_all;
  rows.range(&lo_all, &hi_all);
  const int s0 = split * p.split_len;
  const int lo = max(lo_all, s0), hi = min(hi_all, min(s0 + p.split_len, p.S));
  const long long r0 = (long long)b * p.Hq + hk * G;   // the group's first (row, head)
  float* ws_ml = p.ws;
  float* ws_acc = p.ws + 2LL * p.B * p.Hq * p.n_splits;
  if (lo >= hi) {                       // nothing this query may see: an empty partial
    if (tid < G) {
      const long long r = (r0 + tid) * p.n_splits + split;
      ws_ml[2 * r] = NEG_INF;
      ws_ml[2 * r + 1] = 0.f;
    }
    return;
  }

  float m[HPW], l[HPW], acc[HPW][2 * DP];
#pragma unroll
  for (int h = 0; h < HPW; ++h) {
    m[h] = NEG_INF;
    l[h] = 0.f;
#pragma unroll
    for (int i = 0; i < 2 * DP; ++i) acc[h][i] = 0.f;
  }

  const char* kg = static_cast<const char*>(p.k);
  const char* vg = static_cast<const char*>(p.v);
  const long long row_bytes = (long long)D * sizeof(T);
  const int vpr = D / V::N;             // 16-byte vectors a row
  const int stages = p.stages;
  const int c0 = s0 / CHUNK, c_lo = lo / CHUNK, c_hi = (hi + CHUNK - 1) / CHUNK;
  // step kk takes chunk c0 + R (k0 + kk) + grp for each group; steps before
  // k0 hold no key in [lo, hi)
  const int k0 = (c_lo - c0) / R;
  auto tile = [=](int st) { return ring + (st * R + grp) * 2 * L::TILE; };   // this group's K

  // Copy this group's chunk of step kk into stage st (the group's WC warps
  // share the rows; invalid keys' rows are zero-filled); note its valid keys.
  auto issue = [=](int kk, int st) {
    const int cc = c0 + R * (k0 + kk) + grp;
    long long off = 0;
    const bool ok = cc < c_hi && rows.key(cc * CHUNK + lane, lo, hi, &off);
    const unsigned valid = __ballot_sync(0xffffffffu, ok);
    if (wl == 0 && lane == 0) valid_s[st][grp] = valid;
    if (valid != 0u) {
      unsigned char* kd = tile(st);
      unsigned char* vd = kd + L::TILE;
      for (int vi = wl * 32 + lane; vi < CHUNK * vpr; vi += WC * 32) {
        const int key = vi / vpr, col = vi - key * vpr;
        const long long src = __shfl_sync(0xffffffffu, off, key) * row_bytes + col * 16;
        const bool there = (valid >> key) & 1u;
        cp_async16(kd + key * L::ROW + col * 16, there ? kg + src : kg, there ? 16 : 0);
        cp_async16(vd + key * L::ROW + col * 16, there ? vg + src : vg, there ? 16 : 0);
      }
    }
    cp_async_commit();
  };

  const int steps = (c_hi - c0 + R - 1) / R - k0;
  issue(0, 0);                          // the first step's rows travel while q loads
  const T* qg = static_cast<const T*>(p.q) + r0 * D;
  for (int i = tid; i < G * D; i += NTHREADS) q_s[i / D][i % D] = to_f(qg[i]) * p.scale;
  for (int kk = 0; kk < steps; ++kk) {
    const int st = stages == 2 ? (kk & 1) : 0;
    if (stages == 2) {
      if (kk + 1 < steps) issue(kk + 1, st ^ 1);
      else cp_async_commit();
      cp_async_wait<1>();
    } else {
      if (kk > 0) issue(kk, 0);
      cp_async_wait<0>();
    }
    __syncthreads();                    // every thread's copies of this step (and q) landed
    const unsigned valid = valid_s[st][grp];
    if (valid != 0u) {                  // else nothing to add: m, l and acc stay as they are
      const unsigned char* ks = tile(st);
      const bool ok = (valid >> lane) & 1u;
      if (two) chunk<2, T, DMAX>(ks, lane, vpr, D, wl, WC, q_s, ok, m, l, acc);
      else chunk<1, T, DMAX>(ks, lane, vpr, D, wl, WC, q_s, ok, m, l, acc);
    }
    __syncthreads();                    // this stage is rewritten by a later step
  }
  cp_async_wait<0>();
  __syncthreads();

  // the (m, l, acc) of the R warps that share each head into the split's
  // partial, in group order; acc through the tiles
  float* acc_w = reinterpret_cast<float*>(ring);   // [NWARPS][HPW][DMAX]
#pragma unroll
  for (int h = 0; h < HPW; ++h) {
    if (lane == 0) {
      m_w[w][h] = m[h];
      l_w[w][h] = l[h];
    }
#pragma unroll
    for (int i = 0; i < DP; ++i) {
      const int d = 2 * lane + 64 * i;
      if (d < D) {
        acc_w[(w * HPW + h) * DMAX + d] = acc[h][2 * i];
        acc_w[(w * HPW + h) * DMAX + d + 1] = acc[h][2 * i + 1];
      }
    }
  }
  __syncthreads();
  for (int i = tid; i < G * D; i += NTHREADS) {
    const int g = i / D, d = i % D;
    const int h = g / WC, wg = g % WC;  // head g lives in warps wg + WC r, slot h
    float M = NEG_INF;
    for (int r = 0; r < R; ++r) M = fmaxf(M, m_w[wg + WC * r][h]);
    float Lsum = 0.f, O = 0.f;
    for (int r = 0; r < R; ++r) {
      const int ww = wg + WC * r;
      const float sc = expf(m_w[ww][h] - M);
      Lsum = fmaf(l_w[ww][h], sc, Lsum);
      O = fmaf(acc_w[(ww * HPW + h) * DMAX + d], sc, O);
    }
    const long long r = (r0 + g) * p.n_splits + split;
    if (d == 0) {
      ws_ml[2 * r] = M;
      ws_ml[2 * r + 1] = Lsum;
    }
    if (Lsum > 0.f) ws_acc[r * D + d] = O;
  }
}

// One block per (query head, batch row).  The splits' weights e^(m - M) go
// to shared memory (0 for an empty split, whose acc is never read); the
// threads then sum acc over the splits in groups of COMBINE_THREADS / D,
// eight loads in flight each, and the groups are added in order.
template <typename T>
__global__ void __launch_bounds__(COMBINE_THREADS) decode_combine_kernel(const Params p) {
  extern __shared__ float w_s[];        // n_splits weights, then groups x D partial sums
  __shared__ float red[COMBINE_THREADS / 32];
  // the split kernel's partials are complete and visible past this point
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  const int tid = threadIdx.x, lane = tid & 31, wid = tid >> 5;
  const int n = p.n_splits, D = p.D;
  const long long r = (long long)blockIdx.y * p.Hq + blockIdx.x;   // (row, head)
  const float* ml = p.ws + r * n * 2;
  const float* acc = p.ws + 2LL * p.B * p.Hq * n + r * n * D;

  float M = NEG_INF;
  for (int s = tid; s < n; s += COMBINE_THREADS) M = fmaxf(M, ml[2 * s]);
  M = warp_max(M);
  if (lane == 0) red[wid] = M;
  __syncthreads();
  M = red[0];
#pragma unroll
  for (int w = 1; w < COMBINE_THREADS / 32; ++w) M = fmaxf(M, red[w]);
  __syncthreads();                      // red is rewritten below

  float Lsum = 0.f;
  for (int s = tid; s < n; s += COMBINE_THREADS) {
    const float ls = ml[2 * s + 1];
    const float w = ls > 0.f ? expf(ml[2 * s] - M) : 0.f;   // an empty split weighs 0
    w_s[s] = w;
    Lsum = fmaf(ls, w, Lsum);
  }
  Lsum = warp_sum(Lsum);
  if (lane == 0) red[wid] = Lsum;
  __syncthreads();                      // w_s and red complete
  Lsum = 0.f;
#pragma unroll
  for (int w = 0; w < COMBINE_THREADS / 32; ++w) Lsum += red[w];

  const int groups = COMBINE_THREADS / D;   // D <= 128
  float* part = w_s + n;
  const int gi = tid / D, d = tid - gi * D;
  if (gi < groups) {
    float O = 0.f;
    for (int s0 = gi; s0 < n; s0 += 8 * groups) {
      float a[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) {     // every load issued before any is used
        const int s = s0 + u * groups;
        a[u] = s < n && w_s[s] != 0.f ? acc[(long long)s * D + d] : 0.f;
      }
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const int s = s0 + u * groups;
        if (s < n) O = fmaf(a[u], w_s[s], O);
      }
    }
    part[gi * D + d] = O;
  }
  __syncthreads();
  if (tid < D) {
    float O = 0.f;
    for (int g = 0; g < groups; ++g) O += part[g * D + tid];
    static_cast<T*>(p.o)[r * D + tid] = from_f<T>(O / fmaxf(Lsum, 1e-30f));
  }
}

template <typename T, int DMAX, bool PAGED>
int launch(Params p, cudaStream_t s) {
  using L = Layout<T, DMAX>;
  static bool sized = false;            // the most dynamic shared memory, allowed once
  if (!sized) {
    const cudaError_t e = cudaFuncSetAttribute(decode_split_kernel<T, DMAX, PAGED>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               SMEM_MAX);
    if (e != cudaSuccess) return (int)e;
    sized = true;
  }
  const int R = NWARPS / warps_per_chunk(p.Hq / p.Hkv);
  p.stages = p.split_len > R * CHUNK && L::smem(2, R) <= SMEM_MAX ? 2 : 1;
  decode_split_kernel<T, DMAX, PAGED>
      <<<dim3(p.n_splits, p.Hkv, p.B), NTHREADS, L::smem(p.stages, R), s>>>(p);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;

  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(p.Hq, p.B);
  cfg.blockDim = dim3(COMBINE_THREADS);
  cfg.dynamicSmemBytes = (p.n_splits + COMBINE_THREADS) * sizeof(float);
  cfg.stream = s;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, decode_combine_kernel<T>, p);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

template <typename T, bool PAGED>
int by_dim(const Params& p, cudaStream_t s) {
  if (p.D <= 16) return launch<T, 16, PAGED>(p, s);
  if (p.D <= 32) return launch<T, 32, PAGED>(p, s);
  if (p.D <= 64) return launch<T, 64, PAGED>(p, s);
  if (p.D <= 96) return launch<T, 96, PAGED>(p, s);
  return launch<T, 128, PAGED>(p, s);
}

template <bool PAGED>
int dispatch(int dtype, int D, Params p, cudaStream_t s) {
  if (p.Hkv <= 0 || p.Hq % p.Hkv != 0 || p.Hq / p.Hkv > MAXG || p.B <= 0 || p.B > 65535 ||
      p.Hkv > 65535 || p.Hq > 65535 || D < 8 || D > 128 || D % 8 || p.S <= 0 ||
      p.ws == nullptr || p.split_len <= 0 || p.split_len % CHUNK || p.n_splits <= 0 ||
      p.n_splits > MAX_SPLITS ||
      (long long)(p.n_splits - 1) * p.split_len >= p.S ||
      (long long)p.n_splits * p.split_len < p.S)
    return (int)cudaErrorInvalidValue;
  p.D = D;
  if (dtype == DTYPE_F32) return by_dim<float, PAGED>(p, s);
  if (dtype == DTYPE_BF16) return by_dim<__nv_bfloat16, PAGED>(p, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace decode
}  // namespace repro
