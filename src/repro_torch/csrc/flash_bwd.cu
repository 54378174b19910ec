// K2, K3, K4: the flash-attention backward for Hopper (sm_90a).
//
// Replace the Pallas kernels of repro/kernels/flash_attention.py (launched by
// _backward):
//   K2 _delta_kernel: delta = rowsum(dO * O) per (b, h, q) row, f32;
//   K3 _dq_kernel:    dQ = scale * sum_k dS K, with P = exp(s - lse) * mask
//                     recomputed and dS = P * (dO V^T - delta);
//   K4 _dkv_kernel:   dV = sum_q P^T dO and dK = scale * sum_q dS^T Q, the
//                     GQA group of each KV head summed inside.
// The masks are K1's: causal, sliding window and segment ids, over aligned
// positions; masked entries are zeroed explicitly (on a row with no valid key
// lse = -1e30 + log(1e-30), so exp(s - lse) would not be 0).
//
// What bounds them on this card: K2 is a streaming reduction, bound by bytes
// (O and dO read once, delta written once; its design is noted beside it).
// K3 does three products and K4 four, each 2*B*Hq*D*(causal pairs)
// operations (S = Q K^T and dP = dO V^T in both; dQ = dS K in K3; dV = P^T dO
// and dK = dS^T Q in K4), so both are bound by tensor-core operations against
// 989 TFLOP/s in bf16; their bytes are ~D/S as many.
//
// bf16, what the design does about it: every product runs on wgmma from
// tiles that TMA brings into shared memory, warp-specialised as K1 is (one
// producer thread issues the loads, and its warpgroup gives its registers up
// with setmaxnreg, 24 / 240; two consumer warpgroups own 64 rows each), in
// persistent blocks (one per SM) that walk the work items longest first,
// serpentine over the rounds.  The accumulators stay in registers for the whole item and are
// scaled and stored once; the score tiles never leave registers (P and dS
// are rounded to bf16 there, in the layout wgmma takes for its A operand).
//   K3: an item is (128-row q tile, query head, batch row).  Q and dO are
//   loaded once an item; K and V tiles of BK keys (128 at D <= 64, 64
//   above, where dQ takes 64 registers a thread) stream through K1's ring of
//   full/empty mbarriers, which runs on across items.  S = Q K^T and
//   dP = dO V^T are wgmma from shared memory (both K-major), P = exp2(S
//   scale log2e - lse log2e) and dS = P (dP - delta) are computed in
//   registers with each row's lse and delta, and dQ += dS K is wgmma with dS
//   from registers and K read MN-major from the same tile (K1's P V).
//   K4: an item is (128-key tile, KV head, batch row); each consumer keeps dK
//   and dV of its 64 keys in registers.  K and V are loaded once an item; the
//   g query heads of the group and, for each, the 64-row q tiles that
//   _block_relevant keeps (causal lower bound, window upper bound) stream
//   through a ring whose stage holds Q, dO and the tile's lse and delta
//   (TMA through 1-D maps over the flat (B Hq Sq) arrays: any Sq).  The
//   products are transposed so that keys are wgmma's M and no tile is ever
//   transposed: S^T = K Q^T and dP^T = V dO^T from shared memory (K-major),
//   P^T and dS^T in registers with each column's lse and delta, then
//   dV += P^T dO and dK += dS^T Q with dO and Q read MN-major.  The group sum
//   happens in the accumulators: no atomics and one fixed summation order, so
//   equal inputs give equal bits (the bitwise crash -> resume relies on it).
// Both follow K1's rules against ptxas's serialization of wgmma: no branch
// around a product in the main loop (a warpgroup computes the tiles outside
// its own causal or window bounds fully masked; the warpgroup index is read
// through a shuffle), each product is its own stage (waited on before any
// register it reads or writes is touched), masks are tested only on tiles
// that cross the diagonal, the window edge or a ragged tail; segment ids take
// their own instantiation, which skips the tiles that the segment-range test
// of _block_relevant rules out.  The D tail past 64 or 128 columns and the
// ragged Sq/Sk tails arrive as zeros (TMA's fill) and are masked; only D
// columns are stored.
//
// f32 (the identity checks' path): one block of 4 warps per 64-row q tile
// (K3) or 64-row k tile (K4), tiles staged through shared memory by plain
// loads, FMA loops, D padded with zeros to 16/32/64/96/128 in shared memory;
// K4 takes q tiles of 32 rows so that four tiles and two accumulators fit.

#include <stdint.h>

#include <climits>

#include "common.cuh"
#include "hopper.cuh"

namespace {

using bf16 = __nv_bfloat16;
namespace hp = repro::hopper;

constexpr size_t SMEM_LIMIT = 232448;  // bytes a block may use on an H100
constexpr float LOG2E = 1.4426950408889634f;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const float* lse;    // (B, Hq, Sq)
  const float* delta;  // (B, Hq, Sq)
  const int* seg;      // (B, S) or nullptr
  void* dq;            // (B, Sq, Hq, D) contiguous
  void* dk;            // (B, Sk, Hkv, D) contiguous
  void* dv;            // (B, Sk, Hkv, D) contiguous
  int B, Sq, Sk, Hq, Hkv, D;
  long long q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, do_sb, do_ss, do_sh;
  int causal, window;  // window <= 0: none
  float scale;
};

// ---------------------------------------------------------------------------
// K2: delta = rowsum(dO * O)
// ---------------------------------------------------------------------------
//
// Bound by bytes: O and dO read once, delta written once,
// 2·B·Sq·Hq·D·elt + 4·B·Hq·Sq bytes over 3.35 TB/s (33.6 MB, 10.0 us, at the
// training shape (4, 1024, 32, 64) in bf16); 2 operations an element.
//
// What the design does about it:
//   - The B·Sq query positions, in (b, s) order, are dealt out in equal
//     contiguous runs of `per_block` (the wrapper's delta_split), one run to
//     a block, at most four blocks an SM: the whole grid is resident at once
//     and every block has the same work, so no SM idles through a tail
//     (tiles of a fixed size left part of the grid for a second wave).
//     A block takes its run in chunks of up to
//     DELTA_CHUNK positions across all Hq heads: chunk·Hq rows r = s·Hq + h,
//     one contiguous slab of each tensor in the layout the model makes.
//   - Every load is 16 bytes (8 bf16 or 4 f32): a row is V = D·elt/16 of them
//     (D is a multiple of 8).  A row belongs to an aligned group of G lanes,
//     V rounded up to a power of two (15 of 16 lanes at D 120 in bf16); each
//     thread issues the loads of DELTA_ROWS rows before it uses the first.
//     O is read with an evict-first hint (no kernel reads it after K2); dO
//     with the default policy, since K3 and K4 read it next.
//   - A lane's partial is its vector's dot product in a fixed order; the
//     group sums its lanes by xor shuffles, and the group's first lane keeps
//     the result.  No atomics, and the order depends on D alone, not on the
//     run or the grid: equal inputs give equal bits (the bitwise crash ->
//     resume relies on it).
//   - A chunk's sums wait in shared memory, transposed (head-major, padded
//     against bank conflicts), and leave as runs delta[b, h, s0 : s0 + n]
//     of the chunk's positions, consecutive threads on consecutive floats.
//   - One instantiation per dtype; D, V and G are runtime values.

constexpr int DELTA_THREADS = 256;
constexpr int DELTA_ROWS = 4;    // rows a thread has in flight
constexpr int DELTA_CHUNK = 32;  // positions a block reduces before it stores
constexpr int DELTA_MAX_HEADS = 256;  // the chunk's row sums: at most 33 KB of shared memory

// the dot product of two 16-byte vectors of T, in f32, in one fixed order
template <typename T>
__device__ __forceinline__ float dot16(const uint4& a, const uint4& b);

template <>
__device__ __forceinline__ float dot16<float>(const uint4& a, const uint4& b) {
  float acc = __uint_as_float(a.x) * __uint_as_float(b.x);
  acc = fmaf(__uint_as_float(a.y), __uint_as_float(b.y), acc);
  acc = fmaf(__uint_as_float(a.z), __uint_as_float(b.z), acc);
  return fmaf(__uint_as_float(a.w), __uint_as_float(b.w), acc);
}

template <>
__device__ __forceinline__ float dot16<bf16>(const uint4& a, const uint4& b) {
  const __nv_bfloat162* x = reinterpret_cast<const __nv_bfloat162*>(&a);
  const __nv_bfloat162* y = reinterpret_cast<const __nv_bfloat162*>(&b);
  float acc = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 xf = __bfloat1622float2(x[i]);
    const float2 yf = __bfloat1622float2(y[i]);
    acc = fmaf(xf.x, yf.x, acc);
    acc = fmaf(xf.y, yf.y, acc);
  }
  return acc;
}

// (b, s) of position pos = b·Sq + s, stepped from (b, s) of an earlier one:
// no division on the loads' path (Sq may be below a chunk's 32 positions)
__device__ __forceinline__ void step_pos(int& b, int& s, int by, int Sq) {
  s += by;
  while (s >= Sq) {
    s -= Sq;
    ++b;
  }
}

// strides in elements; V vectors a row, G = V rounded up to a power of two;
// block k owns positions [k·per_block, (k + 1)·per_block) of the B·Sq
template <typename T>
__global__ void __launch_bounds__(DELTA_THREADS)
    flash_delta_kernel(const T* __restrict__ o, const T* __restrict__ dout,
                       float* __restrict__ delta, int B, int Sq, int Hq, int V, int G,
                       int per_block, long long o_sb, long long o_ss, long long o_sh,
                       long long do_sb, long long do_ss, long long do_sh) {
  extern __shared__ float sums[];               // [Hq][DELTA_CHUNK + 1]
  constexpr int pitch = DELTA_CHUNK + 1;
  const int p_begin = blockIdx.x * per_block;   // B·Sq < 2^31: the wrapper's check
  const int p_end = min(B * Sq, p_begin + per_block);
  const int lane_g = threadIdx.x & (G - 1);     // this lane's vector of its row
  const int per_pass = DELTA_THREADS / G;       // rows the block covers at once
  const int my_row = threadIdx.x / G;
  int b0 = p_begin / Sq, s0 = p_begin - b0 * Sq;  // (b, s) of the chunk's first position
  for (int c0 = p_begin; c0 < p_end; c0 += DELTA_CHUNK) {
    const int n_c = min(DELTA_CHUNK, p_end - c0);
    const int rows = n_c * Hq;
    // the round's bound is block-uniform, so every lane reaches the shuffles
    for (int r0 = 0; r0 < rows; r0 += DELTA_ROWS * per_pass) {
      uint4 x[DELTA_ROWS], y[DELTA_ROWS];
#pragma unroll
      for (int u = 0; u < DELTA_ROWS; ++u) {
        const int r = r0 + u * per_pass + my_row;
        x[u] = y[u] = make_uint4(0u, 0u, 0u, 0u);
        if (r < rows && lane_g < V) {
          const int j = r / Hq, h = r - j * Hq;
          int b = b0, s = s0;
          step_pos(b, s, j, Sq);
          x[u] = __ldcs(reinterpret_cast<const uint4*>(o + b * o_sb + s * o_ss + h * o_sh) +
                        lane_g);
          y[u] = __ldg(reinterpret_cast<const uint4*>(dout + b * do_sb + s * do_ss +
                                                      h * do_sh) + lane_g);
        }
      }
#pragma unroll
      for (int u = 0; u < DELTA_ROWS; ++u) {
        float p = dot16<T>(x[u], y[u]);
        for (int off = G >> 1; off > 0; off >>= 1) p += __shfl_xor_sync(0xffffffffu, p, off);
        const int r = r0 + u * per_pass + my_row;
        if (lane_g == 0 && r < rows) {
          const int j = r / Hq;
          sums[(r - j * Hq) * pitch + j] = p;
        }
      }
    }
    __syncthreads();
    for (int i = threadIdx.x; i < Hq * n_c; i += DELTA_THREADS) {
      const int h = i / n_c, j = i - h * n_c;
      int b = b0, s = s0;
      step_pos(b, s, j, Sq);
      delta[((long long)b * Hq + h) * Sq + s] = sums[h * pitch + j];
    }
    step_pos(b0, s0, n_c, Sq);
    __syncthreads();                             // the sums are free for the next chunk
  }
}

template <typename T>
int launch_delta(const void* o, const void* dout, float* delta, int B, int Sq, int Hq, int D,
                 int per_block, const long long* st, cudaStream_t s) {
  const int V = D * (int)sizeof(T) / 16;
  int G = 1;
  while (G < V) G <<= 1;
  if (G > 32) return (int)cudaErrorInvalidValue;
  const int blocks = (B * Sq + per_block - 1) / per_block;
  const size_t smem = (size_t)Hq * (DELTA_CHUNK + 1) * sizeof(float);
  flash_delta_kernel<T><<<(unsigned)blocks, DELTA_THREADS, smem, s>>>(
      static_cast<const T*>(o), static_cast<const T*>(dout), delta, B, Sq, Hq, V, G, per_block,
      st[0], st[1], st[2], st[3], st[4], st[5]);
  return (int)cudaGetLastError();
}

// ===========================================================================
// bf16: wgmma + TMA
// ===========================================================================

constexpr int NTHREADS = 384;  // warpgroups 0, 1: consumers; thread 256: producer

// a 64 x 64 ATOMS accumulator (rows row0, row0 + 8 of this thread) times
// `mul`, stored as bf16 rows of a (.., D) tensor: row r at out + r * pitch;
// rows from `rows` on and columns from D on are not written
template <int ATOMS>
__device__ __forceinline__ void store_rows(const float (&x)[ATOMS][32], float mul, bf16* out,
                                           long long pitch, int row0, int rows, int D,
                                           int lane) {
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int r = row0 + 8 * rr;
    if (r >= rows) continue;
    bf16* orow = out + (long long)r * pitch;
#pragma unroll
    for (int a = 0; a < ATOMS; ++a)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = 64 * a + 8 * j + 2 * (lane % 4);
        if (col < D)
          *reinterpret_cast<uint32_t*>(orow + col) =
              hp::pack_bf16(x[a][4 * j + 2 * rr] * mul, x[a][4 * j + 2 * rr + 1] * mul);
      }
  }
}

// the id range [lo, hi] of positions [r0, r1) of a segment-id row, over the
// 128 threads of consumer warpgroup c (named barrier 1 + c); positions past
// r1 take no part
__device__ __forceinline__ void seg_range(const int* segb, int r0, int r1, int c, int tid,
                                          int* lo, int* hi) {
  __shared__ int red[2][2][4];
  int l = INT_MAX, h = INT_MIN;
  if (tid < 64 && r0 + tid < r1) l = h = segb[r0 + tid];
  for (int o = 16; o > 0; o >>= 1) {
    l = min(l, __shfl_xor_sync(0xffffffffu, l, o));
    h = max(h, __shfl_xor_sync(0xffffffffu, h, o));
  }
  const int w = tid / 32;
  if (tid % 32 == 0) red[c][0][w] = l, red[c][1][w] = h;
  hp::named_sync(1 + c, 128);
  *lo = min(min(red[c][0][0], red[c][0][1]), min(red[c][0][2], red[c][0][3]));
  *hi = max(max(red[c][1][0], red[c][1][1]), max(red[c][1][2], red[c][1][3]));
  hp::named_sync(1 + c, 128);  // red is rewritten for the next item
}

// ---------------------------------------------------------------------------
// K3: dQ
// ---------------------------------------------------------------------------

constexpr int DQ_BQ = 128;  // query rows per item: two consumer warpgroups of 64

template <int DP>  // D padded to a multiple of 64: 64 or 128
struct DqRing {
  static constexpr int ATOMS = DP / 64;
  static constexpr int BK = DP == 64 ? 128 : 64;  // keys per tile
  static constexpr int STAGES = DP == 64 ? 3 : 4;
  static constexpr uint32_t Q_BYTES = DQ_BQ * DP * 2;  // Q or dO of an item
  static constexpr uint32_t KV_BYTES = BK * DP * 2;    // one K or V tile
  static constexpr uint32_t q_off = 0;                 // Q, then dO
  static constexpr uint32_t kv_off = 2 * Q_BYTES;      // stage s: K at +2s KV_BYTES, V after it
  static constexpr uint32_t bar_off = kv_off + STAGES * 2 * KV_BYTES;
  // full[STAGES], empty[STAGES], Q full and empty; 1024 bytes of slack to
  // align the base
  static constexpr uint32_t bytes = bar_off + 8 * (2 * STAGES + 2) + 1024;
  static_assert(bytes <= SMEM_LIMIT, "dQ ring exceeds shared memory");
};

// The k tiles of width bk that _block_relevant keeps for query rows
// [r0, r1): keys below the last row when causal, from the first row's window
// start when windowed.  [*begin, *end) in tile units.
__device__ __forceinline__ void k_tile_range(const Params& p, int r0, int r1, int bk,
                                             int* begin, int* end) {
  int k_hi = p.Sk;
  if (p.causal) k_hi = min(k_hi, r1);
  const int k_lo = p.window > 0 ? max(0, r0 - p.window + 1) : 0;
  *begin = k_lo / bk;
  *end = max(*begin, (k_hi + bk - 1) / bk);
}

template <int DP, bool SEG>
__global__ void __launch_bounds__(NTHREADS, 1)
    flash_dq_wgmma(const __grid_constant__ CUtensorMap tm_q,
                   const __grid_constant__ CUtensorMap tm_do,
                   const __grid_constant__ CUtensorMap tm_k,
                   const __grid_constant__ CUtensorMap tm_v, const Params p) {
  using R = DqRing<DP>;
  constexpr int BK = R::BK;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw = hp::smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;  // swizzled tiles start on 1024 bytes
  const uint32_t sq = base + R::q_off, sdo = sq + R::Q_BYTES;
  const uint32_t bar = base + R::bar_off;
  auto full = [&](int s) { return bar + 8u * s; };
  auto empty = [&](int s) { return bar + 8u * (R::STAGES + s); };
  const uint32_t qfull = bar + 8u * (2 * R::STAGES), qempty = qfull + 8u;
  auto sk = [&](int s) { return base + R::kv_off + 2u * s * R::KV_BYTES; };
  auto sv = [&](int s) { return sk(s) + R::KV_BYTES; };

  const int n_qt = (p.Sq + DQ_BQ - 1) / DQ_BQ;
  const int per_qt = p.Hq * p.B;
  const int n_items = n_qt * per_qt;
  const int n_rounds = (n_items + gridDim.x - 1) / gridDim.x;
  // this block's item of round r (K1's order): q tile n_qt - 1 - w / per_qt
  // (the long causal tiles first), then head and batch row; serpentine
  auto item = [&](int r, int* q0, int* h, int* b) {
    const int w = r * gridDim.x + ((r & 1) ? gridDim.x - 1 - blockIdx.x : blockIdx.x);
    if (w >= n_items) return false;
    *q0 = (n_qt - 1 - w / per_qt) * DQ_BQ;
    *h = (w % per_qt) % p.Hq;
    *b = (w % per_qt) / p.Hq;
    return true;
  };

  const int wg = threadIdx.x / 128;
  if (threadIdx.x == 0) {
    for (int s = 0; s < R::STAGES; ++s) {
      hp::mbar_init(full(s), 1);
      hp::mbar_init(empty(s), 256);  // every consumer thread releases the stage
    }
    hp::mbar_init(qfull, 1);
    hp::mbar_init(qempty, 256);
    hp::fence_barrier_init();
  }
  __syncthreads();

  if (wg == 2) {
    // ---------------- producer ----------------
    hp::setmaxnreg_dec<24>();
    if (threadIdx.x == 256) {
      int n = 0, it = 0;  // tiles and items loaded so far
      for (int r = 0; r < n_rounds; ++r) {
        int q0, h, b;
        if (!item(r, &q0, &h, &b)) continue;
        const int hk = h / (p.Hq / p.Hkv);
        int kt_begin, kt_end;
        k_tile_range(p, q0, min(q0 + DQ_BQ, p.Sq), BK, &kt_begin, &kt_end);
        hp::mbar_wait(qempty, (it & 1) ^ 1);  // the first item passes
        hp::mbar_arrive_expect_tx(qfull, 2 * R::Q_BYTES);
        for (int a = 0; a < R::ATOMS; ++a) {
          hp::tma_load_4d(sq + a * DQ_BQ * 128, &tm_q, qfull, 64 * a, h, q0, b);
          hp::tma_load_4d(sdo + a * DQ_BQ * 128, &tm_do, qfull, 64 * a, h, q0, b);
        }
        for (int kt = kt_begin; kt < kt_end; ++kt, ++n) {
          const int s = n % R::STAGES;
          hp::mbar_wait(empty(s), ((n / R::STAGES) & 1) ^ 1);  // the first round passes
          hp::mbar_arrive_expect_tx(full(s), 2 * R::KV_BYTES);
          for (int a = 0; a < R::ATOMS; ++a) {
            hp::tma_load_4d(sk(s) + a * BK * 128, &tm_k, full(s), 64 * a, hk, kt * BK, b);
            hp::tma_load_4d(sv(s) + a * BK * 128, &tm_v, full(s), 64 * a, hk, kt * BK, b);
          }
        }
        ++it;
      }
    }
    return;
  }

  // ---------------- consumers ----------------
  hp::setmaxnreg_inc<240>();
  // rows [64c, 64c + 64) of the q tile; read through a shuffle so that ptxas
  // sees it warp-uniform and keeps the branches on it from serializing wgmma
  const int c = __shfl_sync(0xffffffffu, wg, 0);
  const int tid = threadIdx.x % 128, w = tid / 32, lane = tid % 32;
  const float sl2 = p.scale * LOG2E;
  const uint32_t sqc = sq + c * 64 * 128, sdoc = sdo + c * 64 * 128;

  int n = 0, it = 0;  // tiles and items consumed so far
  for (int r = 0; r < n_rounds; ++r) {
    int q0, h, b;
    if (!item(r, &q0, &h, &b)) continue;
    int kt_begin, kt_end;
    k_tile_range(p, q0, min(q0 + DQ_BQ, p.Sq), BK, &kt_begin, &kt_end);
    const int T = kt_end - kt_begin;
    const int qp0 = q0 + 64 * c + 16 * w + lane / 4, qp1 = qp0 + 8;  // this thread's rows
    const int wq0 = q0 + 64 * c, wq1 = min(wq0 + 64, p.Sq);         // the warpgroup's rows
    const bool live = wq0 < p.Sq;
    int wk_hi = p.Sk;
    if (p.causal) wk_hi = min(wk_hi, wq1);
    const int wk_lo = p.window > 0 ? max(0, wq0 - p.window + 1) : 0;
    const int* segb = SEG ? p.seg + (long long)b * p.Sq : nullptr;
    // the rows' lse (log2 units) and delta; rows past Sq get 0, which with
    // their zero Q and dO gives dS = 0 (and they are not stored)
    const long long row0 = ((long long)b * p.Hq + h) * p.Sq;
    const float l0 = qp0 < p.Sq ? p.lse[row0 + qp0] * LOG2E : 0.f;
    const float l1 = qp1 < p.Sq ? p.lse[row0 + qp1] * LOG2E : 0.f;
    const float d0 = qp0 < p.Sq ? p.delta[row0 + qp0] : 0.f;
    const float d1 = qp1 < p.Sq ? p.delta[row0 + qp1] : 0.f;
    int sq0 = 0, sq1 = 0, slo = 0, shi = -1;  // segment ids: the rows', the warpgroup's range
    if (SEG && live) {
      sq0 = qp0 < p.Sq ? segb[qp0] : INT_MAX;
      sq1 = qp1 < p.Sq ? segb[qp1] : INT_MAX;
      seg_range(segb, wq0, wq1, c, tid, &slo, &shi);
    }

    // zero the masked entries of P (64 x BK) on a tile that crosses an edge of
    // the warpgroup's rows: the Sk tail, the causal diagonal, the window, a
    // tile outside the warpgroup's bounds, segment ids.  Interior tiles take
    // no per-element test.
    auto mask_tile = [&](float (&x)[BK / 2], int k0) {
      const bool out = !live || k0 >= wk_hi || k0 + BK <= wk_lo;
      const bool diag = p.causal && k0 + BK - 1 > wq0;
      const bool other = SEG || out || k0 + BK > p.Sk || (p.window > 0 && k0 < wq1 - p.window);
      if (!diag && !other) return;
      if (!other) {
        // the causal diagonal alone: one compare of the column against the
        // row's last visible key
        const int t0 = qp0 - k0 - 2 * (lane % 4), t1 = t0 + 8;
#pragma unroll
        for (int j = 0; j < BK / 2; ++j)
          if (8 * (j / 4) + (j & 1) > ((j & 2) ? t1 : t0)) x[j] = 0.f;
        return;
      }
#pragma unroll
      for (int j = 0; j < BK / 2; ++j) {
        const int kpos = k0 + 8 * (j / 4) + 2 * (lane % 4) + (j & 1);
        const int qpos = (j & 2) ? qp1 : qp0;
        bool ok = !out && kpos < p.Sk;
        if (p.causal) ok = ok && kpos <= qpos;
        if (p.window > 0) ok = ok && kpos > qpos - p.window;
        if (SEG) ok = ok && segb[kpos] == ((j & 2) ? sq1 : sq0);
        if (!ok) x[j] = 0.f;
      }
    };

    float dq[R::ATOMS][32];
    hp::zero_acc(dq);
    hp::mbar_wait(qfull, it & 1);
    for (int i = 0; i < T; ++i) {
      const int s = (n + i) % R::STAGES;
      hp::mbar_wait(full(s), ((n + i) / R::STAGES) & 1);
      const int k0 = (kt_begin + i) * BK;
      bool skip = false;
      if constexpr (SEG) {
        skip = !live || k0 >= wk_hi || k0 + BK <= wk_lo;
        if (!skip) {
          // does any key of the tile carry an id of the warpgroup's rows?
          const int kk = k0 + tid;
          const int ks = (tid < BK && kk < p.Sk) ? segb[kk] : 0;
          skip = !hp::barrier_or(1 + c, 128, tid < BK && kk < p.Sk && ks >= slo && ks <= shi);
        }
        skip = __shfl_sync(0xffffffffu, skip, 0);  // warp-uniform for ptxas, as c
      }
      if (!skip) {
        float sc[BK / 2], dp[BK / 2];
        hp::wgmma_fence();
        hp::mma_ss<BK, DP>(sc, sqc, DQ_BQ * 128, sk(s), BK * 128);
        hp::mma_ss<BK, DP>(dp, sdoc, DQ_BQ * 128, sv(s), BK * 128);
        hp::wgmma_commit();
        hp::wgmma_wait<0>();
        hp::fence_regs(sc);
        hp::fence_regs(dp);
        if (!SEG && i + 1 == T) hp::mbar_arrive(qempty);  // the producer may load the next Q
        // P = 2^(s scale log2e - lse log2e), masked entries 0, then dS
#pragma unroll
        for (int j = 0; j < BK / 2; ++j) sc[j] = hp::ex2(fmaf(sc[j], sl2, -((j & 2) ? l1 : l0)));
        mask_tile(sc, k0);
#pragma unroll
        for (int j = 0; j < BK / 2; ++j) dp[j] = sc[j] * (dp[j] - ((j & 2) ? d1 : d0));
        uint32_t ds[BK / 16][4];
        hp::pack_a(dp, ds);
        hp::fence_acc(dq);
        hp::wgmma_fence();
        hp::mma_rs<BK>(dq, ds, sk(s), BK * 128);  // dQ += dS K, K read MN-major
        hp::wgmma_commit();
        hp::wgmma_wait<0>();
        hp::fence_acc(dq);
        hp::fence_regs(ds);
      }
      hp::mbar_arrive(empty(s));
    }
    if (SEG || T == 0) hp::mbar_arrive(qempty);
    n += T;
    ++it;

    bf16* dqg = static_cast<bf16*>(p.dq) + (((long long)b * p.Sq) * p.Hq + h) * p.D;
    store_rows(dq, p.scale, dqg, (long long)p.Hq * p.D, qp0, p.Sq, p.D, lane);
  }
}

// ---------------------------------------------------------------------------
// K4: dK and dV, the GQA group summed inside
// ---------------------------------------------------------------------------

constexpr int DKV_BK = 128;  // keys per item: two consumer warpgroups of 64
constexpr int DKV_BQ = 64;   // query rows per tile

template <int DP>  // D padded to a multiple of 64: 64 or 128
struct DkvRing {
  static constexpr int ATOMS = DP / 64;
  static constexpr int STAGES = 4;
  static constexpr uint32_t KV_BYTES = DKV_BK * DP * 2;  // K or V of an item
  static constexpr uint32_t Q_BYTES = DKV_BQ * DP * 2;   // one Q or dO tile
  static constexpr uint32_t k_off = 0;
  static constexpr uint32_t v_off = KV_BYTES;
  static constexpr uint32_t ring_off = 2 * KV_BYTES;  // stage s: Q at +2s Q_BYTES, dO after it
  // lse of stage s at stat_off + 4 BQ s, delta STAGES rows on
  static constexpr uint32_t stat_off = ring_off + STAGES * 2 * Q_BYTES;
  static constexpr uint32_t bar_off = stat_off + 2 * STAGES * DKV_BQ * 4;
  // full[STAGES], empty[STAGES], K/V full and empty; 1024 bytes of slack to
  // align the base
  static constexpr uint32_t bytes = bar_off + 8 * (2 * STAGES + 2) + 1024;
  static_assert(bytes <= SMEM_LIMIT, "dK/dV ring exceeds shared memory");
};

// The q tiles that _block_relevant keeps for the keys [k0, k0 + DKV_BK):
// from the first key when causal, up to the last key's window end when
// windowed.  [*begin, *end) in tile units.
__device__ __forceinline__ void q_tile_range(const Params& p, int k0, int* begin, int* end) {
  const int q_lo = p.causal ? k0 : 0;
  int q_hi = p.Sq;
  if (p.window > 0) q_hi = min(q_hi, min(k0 + DKV_BK, p.Sk) - 1 + p.window);
  *begin = q_lo / DKV_BQ;
  *end = max(*begin, (q_hi + DKV_BQ - 1) / DKV_BQ);
}

template <int DP, bool SEG>
__global__ void __launch_bounds__(NTHREADS, 1)
    flash_dkv_wgmma(const __grid_constant__ CUtensorMap tm_q,
                    const __grid_constant__ CUtensorMap tm_do,
                    const __grid_constant__ CUtensorMap tm_k,
                    const __grid_constant__ CUtensorMap tm_v,
                    const __grid_constant__ CUtensorMap tm_lse,
                    const __grid_constant__ CUtensorMap tm_delta, const Params p) {
  using R = DkvRing<DP>;
  constexpr int BQ = DKV_BQ;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw = hp::smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;  // swizzled tiles start on 1024 bytes
  const float* const stats =
      reinterpret_cast<const float*>(smem_raw + (base - raw) + R::stat_off);
  const uint32_t sk = base + R::k_off, sv = base + R::v_off;
  const uint32_t bar = base + R::bar_off;
  auto full = [&](int s) { return bar + 8u * s; };
  auto empty = [&](int s) { return bar + 8u * (R::STAGES + s); };
  const uint32_t kvfull = bar + 8u * (2 * R::STAGES), kvempty = kvfull + 8u;
  auto sq = [&](int s) { return base + R::ring_off + 2u * s * R::Q_BYTES; };
  auto sdo = [&](int s) { return sq(s) + R::Q_BYTES; };
  auto lse_s = [&](int s) { return base + R::stat_off + 4u * s * BQ; };
  auto delta_s = [&](int s) { return lse_s(R::STAGES + s); };

  const int g = p.Hq / p.Hkv;
  const int n_kt = (p.Sk + DKV_BK - 1) / DKV_BK;
  const int per_kt = p.Hkv * p.B;
  const int n_items = n_kt * per_kt;
  const int n_rounds = (n_items + gridDim.x - 1) / gridDim.x;
  // this block's item of round r: k tile w / per_kt (the first k tiles see
  // the most causal q tiles: longest first), then KV head and batch row;
  // serpentine over the rounds
  auto item = [&](int r, int* k0, int* hk, int* b) {
    const int w = r * gridDim.x + ((r & 1) ? gridDim.x - 1 - blockIdx.x : blockIdx.x);
    if (w >= n_items) return false;
    *k0 = (w / per_kt) * DKV_BK;
    *hk = (w % per_kt) % p.Hkv;
    *b = (w % per_kt) / p.Hkv;
    return true;
  };

  const int wg = threadIdx.x / 128;
  if (threadIdx.x == 0) {
    for (int s = 0; s < R::STAGES; ++s) {
      hp::mbar_init(full(s), 1);
      hp::mbar_init(empty(s), 256);  // every consumer thread releases the stage
    }
    hp::mbar_init(kvfull, 1);
    hp::mbar_init(kvempty, 256);
    hp::fence_barrier_init();
  }
  __syncthreads();

  if (wg == 2) {
    // ---------------- producer ----------------
    hp::setmaxnreg_dec<24>();
    if (threadIdx.x == 256) {
      int n = 0, it = 0;  // tiles and items loaded so far
      for (int r = 0; r < n_rounds; ++r) {
        int k0, hk, b;
        if (!item(r, &k0, &hk, &b)) continue;
        int qt_begin, qt_end;
        q_tile_range(p, k0, &qt_begin, &qt_end);
        hp::mbar_wait(kvempty, (it & 1) ^ 1);  // the first item passes
        hp::mbar_arrive_expect_tx(kvfull, 2 * R::KV_BYTES);
        for (int a = 0; a < R::ATOMS; ++a) {
          hp::tma_load_4d(sk + a * DKV_BK * 128, &tm_k, kvfull, 64 * a, hk, k0, b);
          hp::tma_load_4d(sv + a * DKV_BK * 128, &tm_v, kvfull, 64 * a, hk, k0, b);
        }
        for (int h = hk * g; h < (hk + 1) * g; ++h) {
          // lse and delta of rows q0.. of (b, h): elements past the row's
          // end belong to the next row (or are zeros) and are masked
          const int row = (b * p.Hq + h) * p.Sq;
          for (int q0 = qt_begin * BQ; q0 < qt_end * BQ; q0 += BQ, ++n) {
            const int s = n % R::STAGES;
            hp::mbar_wait(empty(s), ((n / R::STAGES) & 1) ^ 1);  // the first round passes
            hp::mbar_arrive_expect_tx(full(s), 2 * R::Q_BYTES + 2 * BQ * 4);
            for (int a = 0; a < R::ATOMS; ++a) {
              hp::tma_load_4d(sq(s) + a * BQ * 128, &tm_q, full(s), 64 * a, h, q0, b);
              hp::tma_load_4d(sdo(s) + a * BQ * 128, &tm_do, full(s), 64 * a, h, q0, b);
            }
            hp::tma_load_1d(lse_s(s), &tm_lse, full(s), row + q0);
            hp::tma_load_1d(delta_s(s), &tm_delta, full(s), row + q0);
          }
        }
        ++it;
      }
    }
    return;
  }

  // ---------------- consumers ----------------
  hp::setmaxnreg_inc<240>();
  // keys [64c, 64c + 64) of the item; read through a shuffle so that ptxas
  // sees it warp-uniform and keeps the branches on it from serializing wgmma
  const int c = __shfl_sync(0xffffffffu, wg, 0);
  const int tid = threadIdx.x % 128, w = tid / 32, lane = tid % 32;
  const float sl2 = p.scale * LOG2E;
  const uint32_t skc = sk + c * 64 * 128, svc = sv + c * 64 * 128;

  int n = 0, it = 0;  // tiles and items consumed so far
  for (int r = 0; r < n_rounds; ++r) {
    int k0, hk, b;
    if (!item(r, &k0, &hk, &b)) continue;
    int qt_begin, qt_end;
    q_tile_range(p, k0, &qt_begin, &qt_end);
    const int nq = qt_end - qt_begin;
    const int T = g * nq;
    const int kp0 = k0 + 64 * c + 16 * w + lane / 4, kp1 = kp0 + 8;  // this thread's keys
    const int wk0 = k0 + 64 * c, wk1 = min(wk0 + 64, p.Sk);         // the warpgroup's keys
    const bool live = wk0 < p.Sk;
    const int* segb = SEG ? p.seg + (long long)b * p.Sq : nullptr;
    int sk0 = 0, sk1 = 0, slo = 0, shi = -1;  // segment ids: the keys', the warpgroup's range
    if (SEG && live) {
      sk0 = kp0 < p.Sk ? segb[kp0] : INT_MAX;
      sk1 = kp1 < p.Sk ? segb[kp1] : INT_MAX;
      seg_range(segb, wk0, wk1, c, tid, &slo, &shi);
    }

    // zero the masked entries of P^T (64 keys x 64 queries) on a tile that
    // crosses an edge of the warpgroup's keys: the causal diagonal, the
    // window, the Sq or Sk tail, a tile outside the warpgroup's bounds,
    // segment ids.  Interior tiles take no per-element test.
    auto mask_tile = [&](float (&x)[32], int q0) {
      const bool out = !live || (p.causal && q0 + BQ <= wk0) ||
                       (p.window > 0 && q0 >= wk1 - 1 + p.window);
      const bool diag = p.causal && wk0 + 63 > q0;
      const bool other = SEG || out || q0 + BQ > p.Sq || wk0 + 64 > p.Sk ||
                         (p.window > 0 && q0 + BQ - 1 >= wk0 + p.window);
      if (!diag && !other) return;
      if (!other) {
        // the causal diagonal alone: a key past the column's query is masked
        const int t0 = kp0 - q0 - 2 * (lane % 4), t1 = t0 + 8;
#pragma unroll
        for (int j = 0; j < 32; ++j)
          if (8 * (j / 4) + (j & 1) < ((j & 2) ? t1 : t0)) x[j] = 0.f;
        return;
      }
#pragma unroll
      for (int j = 0; j < 32; ++j) {
        const int qpos = q0 + 8 * (j / 4) + 2 * (lane % 4) + (j & 1);
        const int kpos = (j & 2) ? kp1 : kp0;
        bool ok = !out && qpos < p.Sq && kpos < p.Sk;
        if (p.causal) ok = ok && kpos <= qpos;
        if (p.window > 0) ok = ok && kpos > qpos - p.window;
        if (SEG) ok = ok && segb[qpos] == ((j & 2) ? sk1 : sk0);
        if (!ok) x[j] = 0.f;
      }
    };

    float dk[R::ATOMS][32], dv[R::ATOMS][32];
    hp::zero_acc(dk);
    hp::zero_acc(dv);
    hp::mbar_wait(kvfull, it & 1);
    for (int i = 0; i < T; ++i) {
      const int q0 = (qt_begin + i % nq) * BQ;
      const int s = (n + i) % R::STAGES;
      hp::mbar_wait(full(s), ((n + i) / R::STAGES) & 1);
      bool skip = false;
      if constexpr (SEG) {
        skip = !live || (p.causal && q0 + BQ <= wk0) || (p.window > 0 && q0 >= wk1 - 1 + p.window);
        if (!skip) {
          // does any query of the tile carry an id of the warpgroup's keys?
          const int qq = q0 + tid;
          const int qs = (tid < BQ && qq < p.Sq) ? segb[qq] : 0;
          skip = !hp::barrier_or(1 + c, 128, tid < BQ && qq < p.Sq && qs >= slo && qs <= shi);
        }
        skip = __shfl_sync(0xffffffffu, skip, 0);  // warp-uniform for ptxas, as c
      }
      if (!skip) {
        float sc[32], dp[32];
        hp::wgmma_fence();
        hp::mma_ss<64, DP>(sc, skc, DKV_BK * 128, sq(s), BQ * 128);   // S^T = K Q^T
        hp::mma_ss<64, DP>(dp, svc, DKV_BK * 128, sdo(s), BQ * 128);  // dP^T = V dO^T
        hp::wgmma_commit();
        hp::wgmma_wait<0>();
        hp::fence_regs(sc);
        hp::fence_regs(dp);
        if (!SEG && i + 1 == T) hp::mbar_arrive(kvempty);  // the producer may load the next K/V
        // P^T = 2^(s scale log2e - lse log2e), masked entries 0, then dS^T;
        // column 8jb + 2(lane % 4) + e of the tile reads its query's lse, delta
        const float* ls = stats + s * BQ;
        const float* ds_ = stats + (R::STAGES + s) * BQ;
#pragma unroll
        for (int jb = 0; jb < 8; ++jb) {
          const float2 l = *reinterpret_cast<const float2*>(ls + 8 * jb + 2 * (lane % 4));
          const float l0 = l.x * LOG2E, l1 = l.y * LOG2E;
#pragma unroll
          for (int e = 0; e < 4; ++e)
            sc[4 * jb + e] = hp::ex2(fmaf(sc[4 * jb + e], sl2, -((e & 1) ? l1 : l0)));
        }
        mask_tile(sc, q0);
#pragma unroll
        for (int jb = 0; jb < 8; ++jb) {
          const float2 dl = *reinterpret_cast<const float2*>(ds_ + 8 * jb + 2 * (lane % 4));
#pragma unroll
          for (int e = 0; e < 4; ++e)
            dp[4 * jb + e] = sc[4 * jb + e] * (dp[4 * jb + e] - ((e & 1) ? dl.y : dl.x));
        }
        uint32_t pt[4][4], dst[4][4];
        hp::pack_a(sc, pt);
        hp::pack_a(dp, dst);
        hp::fence_acc(dv);
        hp::fence_acc(dk);
        hp::wgmma_fence();
        hp::mma_rs<BQ>(dv, pt, sdo(s), BQ * 128);  // dV += P^T dO, dO read MN-major
        hp::mma_rs<BQ>(dk, dst, sq(s), BQ * 128);  // dK += dS^T Q, Q read MN-major
        hp::wgmma_commit();
        hp::wgmma_wait<0>();
        hp::fence_acc(dv);
        hp::fence_acc(dk);
        hp::fence_regs(pt);
        hp::fence_regs(dst);
      }
      hp::mbar_arrive(empty(s));
    }
    if (SEG || T == 0) hp::mbar_arrive(kvempty);
    n += T;
    ++it;

    const long long pitch = (long long)p.Hkv * p.D;
    bf16* dkg = static_cast<bf16*>(p.dk) + ((long long)b * p.Sk * p.Hkv + hk) * p.D;
    bf16* dvg = static_cast<bf16*>(p.dv) + ((long long)b * p.Sk * p.Hkv + hk) * p.D;
    store_rows(dk, p.scale, dkg, pitch, kp0, p.Sk, p.D, lane);
    store_rows(dv, 1.f, dvg, pitch, kp0, p.Sk, p.D, lane);
  }
}

template <typename Kern>
int set_smem(Kern kernel, size_t bytes, bool& done) {
  // above 48 KB a kernel has to opt in, once per instantiation
  if (done) return 0;
  const cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e != cudaSuccess) return (int)e;
  done = true;
  return 0;
}

// The tile maps: Q and dO with `q_rows`-row boxes, K and V with `k_rows`.
bool tile_maps(const Params& p, int q_rows, int k_rows, CUtensorMap (&m)[4]) {
  return hp::make_tensor_map_bhsd(&m[0], p.q, p.B, p.Sq, p.Hq, p.D, p.q_sb, p.q_ss, p.q_sh,
                                  q_rows) &&
         hp::make_tensor_map_bhsd(&m[1], p.dout, p.B, p.Sq, p.Hq, p.D, p.do_sb, p.do_ss,
                                  p.do_sh, q_rows) &&
         hp::make_tensor_map_bhsd(&m[2], p.k, p.B, p.Sk, p.Hkv, p.D, p.k_sb, p.k_ss, p.k_sh,
                                  k_rows) &&
         hp::make_tensor_map_bhsd(&m[3], p.v, p.B, p.Sk, p.Hkv, p.D, p.v_sb, p.v_ss, p.v_sh,
                                  k_rows);
}

// Opt in to `smem` bytes, and one persistent block per SM over `items`
// work items.
template <typename Kern>
int grid_for(Kern kernel, uint32_t smem, bool& attr_set, long long items, int* grid) {
  if (const int e = set_smem(kernel, smem, attr_set)) return e;
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  *grid = (int)(items < sms ? items : sms);
  return (int)e;
}

template <int DP, bool SEG>
int launch_dq_bf16(const Params& p, cudaStream_t stream) {
  using R = DqRing<DP>;
  static bool attr_set = false;
  CUtensorMap m[4];
  if (!tile_maps(p, DQ_BQ, R::BK, m)) return (int)cudaErrorInvalidValue;
  int grid = 0;
  const long long items = (long long)((p.Sq + DQ_BQ - 1) / DQ_BQ) * p.Hq * p.B;
  if (const int e = grid_for(flash_dq_wgmma<DP, SEG>, R::bytes, attr_set, items, &grid)) return e;
  flash_dq_wgmma<DP, SEG><<<grid, NTHREADS, R::bytes, stream>>>(m[0], m[1], m[2], m[3], p);
  return (int)cudaGetLastError();
}

template <int DP, bool SEG>
int launch_dkv_bf16(const Params& p, cudaStream_t stream) {
  using R = DkvRing<DP>;
  static bool attr_set = false;
  CUtensorMap m[4], tl, td;
  const long long rows = (long long)p.B * p.Hq * p.Sq;
  if (!tile_maps(p, DKV_BQ, DKV_BK, m) || !hp::make_tensor_map_f32(&tl, p.lse, rows, DKV_BQ) ||
      !hp::make_tensor_map_f32(&td, p.delta, rows, DKV_BQ))
    return (int)cudaErrorInvalidValue;
  int grid = 0;
  const long long items = (long long)((p.Sk + DKV_BK - 1) / DKV_BK) * p.Hkv * p.B;
  if (const int e = grid_for(flash_dkv_wgmma<DP, SEG>, R::bytes, attr_set, items, &grid))
    return e;
  flash_dkv_wgmma<DP, SEG><<<grid, NTHREADS, R::bytes, stream>>>(m[0], m[1], m[2], m[3], tl, td,
                                                                 p);
  return (int)cudaGetLastError();
}

int dispatch_dq_bf16(const Params& p, cudaStream_t s) {
  const bool seg = p.seg != nullptr;
  if (p.D <= 64) return seg ? launch_dq_bf16<64, true>(p, s) : launch_dq_bf16<64, false>(p, s);
  return seg ? launch_dq_bf16<128, true>(p, s) : launch_dq_bf16<128, false>(p, s);
}

int dispatch_dkv_bf16(const Params& p, cudaStream_t s) {
  const bool seg = p.seg != nullptr;
  if (p.D <= 64) return seg ? launch_dkv_bf16<64, true>(p, s) : launch_dkv_bf16<64, false>(p, s);
  return seg ? launch_dkv_bf16<128, true>(p, s) : launch_dkv_bf16<128, false>(p, s);
}

// ===========================================================================
// f32: FMA loops
// ===========================================================================

constexpr int FTHREADS = 128;  // 4 warps
constexpr int FBK = 64;        // key rows per tile

constexpr size_t align128(size_t x) { return (x + 127) / 128 * 128; }

template <int D>  // D padded to 16/32/64/96/128; rows take an odd pitch (no bank conflicts)
struct DqLayout {
  static constexpr int BQ = 64;
  static constexpr int LDT = D + 1;    // Q, dO, K, V rows
  static constexpr int LDP = FBK + 1;  // dS rows
  static constexpr int LDS = FBK + 4;  // S, dP rows
  static constexpr int LDO = D + 4;    // dQ accumulator rows
  static constexpr size_t q_off = 0;
  static constexpr size_t do_off = align128(q_off + 4 * BQ * LDT);
  static constexpr size_t k_off = align128(do_off + 4 * BQ * LDT);
  static constexpr size_t v_off = align128(k_off + 4 * FBK * LDT);
  static constexpr size_t s_off = align128(v_off + 4 * FBK * LDT);
  static constexpr size_t dp_off = align128(s_off + 4 * BQ * LDS);
  static constexpr size_t ds_off = align128(dp_off + 4 * BQ * LDS);
  static constexpr size_t acc_off = align128(ds_off + 4 * BQ * LDP);
  static constexpr size_t lse_off = align128(acc_off + 4 * BQ * LDO);
  static constexpr size_t delta_off = lse_off + 4 * BQ;
  static constexpr size_t qs_off = delta_off + 4 * BQ;
  static constexpr size_t ks_off = qs_off + 4 * BQ;
  static constexpr size_t bytes = ks_off + 4 * FBK;
  static_assert(bytes <= SMEM_LIMIT, "dQ tiles exceed shared memory");
};

template <int D>
struct DkvLayout {
  // q tiles of 32 rows, so that K, V, Q, dO and both accumulators fit in
  // shared memory at D = 128
  static constexpr int BQ = 32;
  static constexpr int LDT = D + 1;    // K, V, Q, dO rows
  static constexpr int LDS = FBK + 4;  // S, dP rows (q-major)
  static constexpr int LDP = BQ + 1;   // P^T, dS^T rows (k-major)
  static constexpr int LDO = D + 4;    // dK, dV accumulator rows
  static constexpr size_t k_off = 0;
  static constexpr size_t v_off = align128(k_off + 4 * FBK * LDT);
  static constexpr size_t q_off = align128(v_off + 4 * FBK * LDT);
  static constexpr size_t do_off = align128(q_off + 4 * BQ * LDT);
  static constexpr size_t s_off = align128(do_off + 4 * BQ * LDT);
  static constexpr size_t dp_off = align128(s_off + 4 * BQ * LDS);
  static constexpr size_t pt_off = align128(dp_off + 4 * BQ * LDS);
  static constexpr size_t dst_off = align128(pt_off + 4 * FBK * LDP);
  static constexpr size_t dk_off = align128(dst_off + 4 * FBK * LDP);
  static constexpr size_t dv_off = align128(dk_off + 4 * FBK * LDO);
  static constexpr size_t lse_off = align128(dv_off + 4 * FBK * LDO);
  static constexpr size_t delta_off = lse_off + 4 * BQ;
  static constexpr size_t qs_off = delta_off + 4 * BQ;
  static constexpr size_t ks_off = qs_off + 4 * BQ;
  static constexpr size_t bytes = ks_off + 4 * FBK;
  static_assert(bytes <= SMEM_LIMIT, "dK/dV tiles exceed shared memory");
};

// rows [row0, row0 + rows) of one head into shared memory, DP columns;
// rows past `avail` and columns past `d` are zero
template <int DP>
__device__ __forceinline__ void load_tile(float* dst, int ld, const float* src,
                                          long long row_stride, int row0, int avail, int rows,
                                          int d) {
  for (int idx = threadIdx.x; idx < rows * DP; idx += FTHREADS) {
    const int r = idx / DP, c = idx % DP;
    dst[r * ld + c] = (r < avail && c < d) ? src[(long long)(row0 + r) * row_stride + c] : 0.f;
  }
}

__device__ __forceinline__ bool visible(const Params& p, int qpos, int kpos, int qs, int ks,
                                        bool has_seg) {
  bool ok = qpos < p.Sq && kpos < p.Sk;
  if (p.causal) ok = ok && kpos <= qpos;
  if (p.window > 0) ok = ok && kpos > qpos - p.window;
  if (has_seg) ok = ok && qs == ks;
  return ok;
}

// C (M x N) = A (M x KD) . B (N x KD)^T
template <int M, int N, int KD>
__device__ __forceinline__ void mm_abt(const float* A, int lda, const float* B, int ldb,
                                       float* C, int ldc) {
  for (int idx = threadIdx.x; idx < M * N; idx += FTHREADS) {
    const int r = idx / N, c = idx % N;
    const float* ar = A + r * lda;
    const float* br = B + c * ldb;
    float acc = 0.f;
#pragma unroll 8
    for (int d = 0; d < KD; ++d) acc = fmaf(ar[d], br[d], acc);
    C[r * ldc + c] = acc;
  }
}

// C (M x N) += A (M x KC) . B (KC x N)
template <int M, int KC, int N>
__device__ __forceinline__ void mm_acc(const float* A, int lda, const float* B, int ldb,
                                       float* C, int ldc) {
  for (int idx = threadIdx.x; idx < M * N; idx += FTHREADS) {
    const int r = idx / N, c = idx % N;
    const float* ar = A + r * lda;
    float acc = 0.f;
#pragma unroll 8
    for (int kk = 0; kk < KC; ++kk) acc = fmaf(ar[kk], B[kk * ldb + c], acc);
    C[r * ldc + c] += acc;
  }
}

template <int D>
__global__ void __launch_bounds__(FTHREADS) flash_dq_f32(const Params p) {
  using L = DqLayout<D>;
  constexpr int BQ = L::BQ;
  extern __shared__ __align__(128) unsigned char smem[];
  float* Qs = reinterpret_cast<float*>(smem + L::q_off);
  float* dOs = reinterpret_cast<float*>(smem + L::do_off);
  float* Ks = reinterpret_cast<float*>(smem + L::k_off);
  float* Vs = reinterpret_cast<float*>(smem + L::v_off);
  float* Ss = reinterpret_cast<float*>(smem + L::s_off);
  float* dPs = reinterpret_cast<float*>(smem + L::dp_off);
  float* dSs = reinterpret_cast<float*>(smem + L::ds_off);
  float* acc = reinterpret_cast<float*>(smem + L::acc_off);
  float* lse_s = reinterpret_cast<float*>(smem + L::lse_off);
  float* delta_s = reinterpret_cast<float*>(smem + L::delta_off);
  int* qseg_s = reinterpret_cast<int*>(smem + L::qs_off);
  int* kseg_s = reinterpret_cast<int*>(smem + L::ks_off);

  const int tid = threadIdx.x;
  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (p.Hq / p.Hkv);
  const int nq = min(BQ, p.Sq - q0);
  const bool has_seg = p.seg != nullptr;
  const float* qg = static_cast<const float*>(p.q) + b * p.q_sb + h * p.q_sh;
  const float* dog = static_cast<const float*>(p.dout) + b * p.do_sb + h * p.do_sh;
  const float* kg = static_cast<const float*>(p.k) + b * p.k_sb + hk * p.k_sh;
  const float* vg = static_cast<const float*>(p.v) + b * p.v_sb + hk * p.v_sh;
  const long long row0 = ((long long)b * p.Hq + h) * p.Sq;
  const int* segb = has_seg ? p.seg + (long long)b * p.Sq : nullptr;

  load_tile<D>(Qs, L::LDT, qg, p.q_ss, q0, nq, BQ, p.D);
  load_tile<D>(dOs, L::LDT, dog, p.do_ss, q0, nq, BQ, p.D);
  for (int i = tid; i < BQ * L::LDO; i += FTHREADS) acc[i] = 0.f;
  if (tid < BQ) {
    lse_s[tid] = tid < nq ? p.lse[row0 + q0 + tid] : 0.f;
    delta_s[tid] = tid < nq ? p.delta[row0 + q0 + tid] : 0.f;
    qseg_s[tid] = (has_seg && tid < nq) ? segb[q0 + tid] : 0;
  }
  __syncthreads();

  int qmin = INT_MAX, qmax = INT_MIN;
  if (has_seg) {
    for (int r = 0; r < nq; ++r) {
      qmin = min(qmin, qseg_s[r]);
      qmax = max(qmax, qseg_s[r]);
    }
  }
  // the k tiles _block_relevant keeps for this q tile
  int kt_begin = 0, kt_end = 0;
  {
    int k_hi = p.Sk;
    if (p.causal) k_hi = min(k_hi, q0 + nq);
    const int k_lo = p.window > 0 ? max(0, q0 - p.window + 1) : 0;
    kt_begin = k_lo / FBK;
    kt_end = (k_hi + FBK - 1) / FBK;
  }

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k0 = kt * FBK;
    const int nk = min(FBK, p.Sk - k0);
    __syncthreads();  // the previous tile is done with Ks, Vs, dSs, kseg_s
    load_tile<D>(Ks, L::LDT, kg, p.k_ss, k0, nk, FBK, p.D);
    load_tile<D>(Vs, L::LDT, vg, p.v_ss, k0, nk, FBK, p.D);
    if (has_seg && tid < FBK) kseg_s[tid] = tid < nk ? segb[k0 + tid] : 0;
    __syncthreads();
    if (has_seg) {
      const int hit = tid < nk && kseg_s[tid] >= qmin && kseg_s[tid] <= qmax;
      if (!__syncthreads_or(hit)) continue;
    }
    mm_abt<BQ, FBK, D>(Qs, L::LDT, Ks, L::LDT, Ss, L::LDS);
    mm_abt<BQ, FBK, D>(dOs, L::LDT, Vs, L::LDT, dPs, L::LDS);
    __syncthreads();
    for (int idx = tid; idx < BQ * FBK; idx += FTHREADS) {
      const int r = idx / FBK, c = idx % FBK;
      float ds = 0.f;  // masked: exactly 0
      if (visible(p, q0 + r, k0 + c, qseg_s[r], kseg_s[c], has_seg)) {
        const float pr = expf(Ss[r * L::LDS + c] * p.scale - lse_s[r]);
        ds = pr * (dPs[r * L::LDS + c] - delta_s[r]);
      }
      dSs[r * L::LDP + c] = ds;
    }
    __syncthreads();
    mm_acc<BQ, FBK, D>(dSs, L::LDP, Ks, L::LDT, acc, L::LDO);
  }
  __syncthreads();

  float* dqg = static_cast<float*>(p.dq);
  for (int idx = tid; idx < nq * p.D; idx += FTHREADS) {
    const int r = idx / p.D, d = idx % p.D;
    dqg[(((long long)b * p.Sq + q0 + r) * p.Hq + h) * p.D + d] = acc[r * L::LDO + d] * p.scale;
  }
}

template <int D>
__global__ void __launch_bounds__(FTHREADS) flash_dkv_f32(const Params p) {
  using L = DkvLayout<D>;
  constexpr int BQ = L::BQ;
  extern __shared__ __align__(128) unsigned char smem[];
  float* Ks = reinterpret_cast<float*>(smem + L::k_off);
  float* Vs = reinterpret_cast<float*>(smem + L::v_off);
  float* Qs = reinterpret_cast<float*>(smem + L::q_off);
  float* dOs = reinterpret_cast<float*>(smem + L::do_off);
  float* Ss = reinterpret_cast<float*>(smem + L::s_off);
  float* dPs = reinterpret_cast<float*>(smem + L::dp_off);
  float* PTs = reinterpret_cast<float*>(smem + L::pt_off);
  float* dSTs = reinterpret_cast<float*>(smem + L::dst_off);
  float* dKs = reinterpret_cast<float*>(smem + L::dk_off);
  float* dVs = reinterpret_cast<float*>(smem + L::dv_off);
  float* lse_s = reinterpret_cast<float*>(smem + L::lse_off);
  float* delta_s = reinterpret_cast<float*>(smem + L::delta_off);
  int* qseg_s = reinterpret_cast<int*>(smem + L::qs_off);
  int* kseg_s = reinterpret_cast<int*>(smem + L::ks_off);

  const int tid = threadIdx.x;
  const int k0 = blockIdx.x * FBK, hk = blockIdx.y, b = blockIdx.z;
  const int g = p.Hq / p.Hkv;
  const int nk = min(FBK, p.Sk - k0);
  const bool has_seg = p.seg != nullptr;
  const float* kg = static_cast<const float*>(p.k) + b * p.k_sb + hk * p.k_sh;
  const float* vg = static_cast<const float*>(p.v) + b * p.v_sb + hk * p.v_sh;
  const int* segb = has_seg ? p.seg + (long long)b * p.Sq : nullptr;

  load_tile<D>(Ks, L::LDT, kg, p.k_ss, k0, nk, FBK, p.D);
  load_tile<D>(Vs, L::LDT, vg, p.v_ss, k0, nk, FBK, p.D);
  for (int i = tid; i < FBK * L::LDO; i += FTHREADS) {
    dKs[i] = 0.f;
    dVs[i] = 0.f;
  }
  if (tid < FBK) kseg_s[tid] = (has_seg && tid < nk) ? segb[k0 + tid] : 0;
  __syncthreads();

  int kmin = INT_MAX, kmax = INT_MIN;
  if (has_seg) {
    for (int c = 0; c < nk; ++c) {
      kmin = min(kmin, kseg_s[c]);
      kmax = max(kmax, kseg_s[c]);
    }
  }
  // the q tiles _block_relevant keeps for this k tile: from the tile's first
  // key when causal, up to its last key's window end when windowed
  const int q_lo = p.causal ? k0 : 0;
  int q_hi = p.Sq;
  if (p.window > 0) q_hi = min(q_hi, k0 + nk - 1 + p.window);
  const int qt_begin = q_lo / BQ, qt_end = (q_hi + BQ - 1) / BQ;

  for (int hh = 0; hh < g; ++hh) {
    const int h = hk * g + hh;
    const float* qg = static_cast<const float*>(p.q) + b * p.q_sb + h * p.q_sh;
    const float* dog = static_cast<const float*>(p.dout) + b * p.do_sb + h * p.do_sh;
    const long long row0 = ((long long)b * p.Hq + h) * p.Sq;
    for (int qt = qt_begin; qt < qt_end; ++qt) {
      const int q0 = qt * BQ;
      const int nq = min(BQ, p.Sq - q0);
      __syncthreads();  // the previous tile is done with Qs, dOs, PTs, dSTs, lse_s, ...
      load_tile<D>(Qs, L::LDT, qg, p.q_ss, q0, nq, BQ, p.D);
      load_tile<D>(dOs, L::LDT, dog, p.do_ss, q0, nq, BQ, p.D);
      if (tid < BQ) {
        lse_s[tid] = tid < nq ? p.lse[row0 + q0 + tid] : 0.f;
        delta_s[tid] = tid < nq ? p.delta[row0 + q0 + tid] : 0.f;
        qseg_s[tid] = (has_seg && tid < nq) ? segb[q0 + tid] : 0;
      }
      __syncthreads();
      if (has_seg) {
        const int hit = tid < nq && qseg_s[tid] >= kmin && qseg_s[tid] <= kmax;
        if (!__syncthreads_or(hit)) continue;
      }
      mm_abt<BQ, FBK, D>(Qs, L::LDT, Ks, L::LDT, Ss, L::LDS);
      mm_abt<BQ, FBK, D>(dOs, L::LDT, Vs, L::LDT, dPs, L::LDS);
      __syncthreads();
      for (int idx = tid; idx < BQ * FBK; idx += FTHREADS) {
        const int r = idx / FBK, c = idx % FBK;
        float pr = 0.f, ds = 0.f;  // masked: exactly 0
        if (visible(p, q0 + r, k0 + c, qseg_s[r], kseg_s[c], has_seg)) {
          pr = expf(Ss[r * L::LDS + c] * p.scale - lse_s[r]);
          ds = pr * (dPs[r * L::LDS + c] - delta_s[r]);
        }
        PTs[c * L::LDP + r] = pr;
        dSTs[c * L::LDP + r] = ds;
      }
      __syncthreads();
      mm_acc<FBK, BQ, D>(PTs, L::LDP, dOs, L::LDT, dVs, L::LDO);
      mm_acc<FBK, BQ, D>(dSTs, L::LDP, Qs, L::LDT, dKs, L::LDO);
    }
  }
  __syncthreads();

  float* dkg = static_cast<float*>(p.dk);
  float* dvg = static_cast<float*>(p.dv);
  for (int idx = tid; idx < nk * p.D; idx += FTHREADS) {
    const int r = idx / p.D, d = idx % p.D;
    const long long off = (((long long)b * p.Sk + k0 + r) * p.Hkv + hk) * p.D + d;
    dkg[off] = dKs[r * L::LDO + d] * p.scale;
    dvg[off] = dVs[r * L::LDO + d];
  }
}

template <int D>
int launch_dq_f32(const Params& p, cudaStream_t stream) {
  using L = DqLayout<D>;
  static bool attr_set = false;
  if (const int e = set_smem(flash_dq_f32<D>, L::bytes, attr_set)) return e;
  const dim3 grid((p.Sq + L::BQ - 1) / L::BQ, p.Hq, p.B);
  flash_dq_f32<D><<<grid, FTHREADS, L::bytes, stream>>>(p);
  return (int)cudaGetLastError();
}

template <int D>
int launch_dkv_f32(const Params& p, cudaStream_t stream) {
  using L = DkvLayout<D>;
  static bool attr_set = false;
  if (const int e = set_smem(flash_dkv_f32<D>, L::bytes, attr_set)) return e;
  const dim3 grid((p.Sk + FBK - 1) / FBK, p.Hkv, p.B);
  flash_dkv_f32<D><<<grid, FTHREADS, L::bytes, stream>>>(p);
  return (int)cudaGetLastError();
}

// the tiles of D padded to the next of 16/32/64/96/128
int dispatch_dq_f32(const Params& p, cudaStream_t s) {
  if (p.D <= 16) return launch_dq_f32<16>(p, s);
  if (p.D <= 32) return launch_dq_f32<32>(p, s);
  if (p.D <= 64) return launch_dq_f32<64>(p, s);
  if (p.D <= 96) return launch_dq_f32<96>(p, s);
  return launch_dq_f32<128>(p, s);
}

int dispatch_dkv_f32(const Params& p, cudaStream_t s) {
  if (p.D <= 16) return launch_dkv_f32<16>(p, s);
  if (p.D <= 32) return launch_dkv_f32<32>(p, s);
  if (p.D <= 64) return launch_dkv_f32<64>(p, s);
  if (p.D <= 96) return launch_dkv_f32<96>(p, s);
  return launch_dkv_f32<128>(p, s);
}

Params make_params(const void* q, const void* k, const void* v, const void* dout,
                   const void* lse, const void* delta, const void* seg, void* dq, void* dk,
                   void* dv, int B, int Sq, int Sk, int Hq, int Hkv, int D, const long long* st,
                   int causal, int window, float scale) {
  return Params{q, k, v, dout,
                static_cast<const float*>(lse), static_cast<const float*>(delta),
                static_cast<const int*>(seg), dq, dk, dv,
                B, Sq, Sk, Hq, Hkv, D,
                st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], st[9], st[10], st[11],
                causal, window, scale};
}

// also refuses (B Hq Sq) rows past int: K4 addresses lse and delta by int
bool bad_shape(int B, int Sq, int Hq, int Hkv, int D) {
  return Hkv <= 0 || Hq % Hkv != 0 || D < 8 || D > 128 || D % 8 != 0 ||
         (long long)B * Hq * Sq > INT_MAX;
}

}  // namespace

// strides: O (b, s, h), dO (b, s, h), in elements; per_block: the wrapper's
// delta_split
extern "C" int repro_flash_delta(const void* o, const void* dout, void* delta, int dtype, int B,
                                 int Sq, int Hq, int D, int per_block, long long o_sb,
                                 long long o_ss, long long o_sh, long long do_sb,
                                 long long do_ss, long long do_sh, void* stream) {
  if (B <= 0 || Sq <= 0 || Hq <= 0 || per_block <= 0 || D < 8 || D % 8 != 0 ||
      Hq > DELTA_MAX_HEADS || (long long)B * Sq + per_block > INT_MAX)
    return (int)cudaErrorInvalidValue;
  const long long st[6] = {o_sb, o_ss, o_sh, do_sb, do_ss, do_sh};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* out = static_cast<float*>(delta);
  if (dtype == repro::DTYPE_F32)
    return launch_delta<float>(o, dout, out, B, Sq, Hq, D, per_block, st, s);
  if (dtype == repro::DTYPE_BF16)
    return launch_delta<bf16>(o, dout, out, B, Sq, Hq, D, per_block, st, s);
  return (int)cudaErrorInvalidValue;
}

// strides: q (b, s, h), k (b, s, h), v (b, s, h), dO (b, s, h), in elements
extern "C" int repro_flash_dq(const void* q, const void* k, const void* v, const void* dout,
                              const void* lse, const void* delta, const void* seg, void* dq,
                              int dtype, int B, int Sq, int Sk, int Hq, int Hkv, int D,
                              const long long* strides, int causal, int window, float scale,
                              void* stream) {
  if (bad_shape(B, Sq, Hq, Hkv, D)) return (int)cudaErrorInvalidValue;
  const Params p = make_params(q, k, v, dout, lse, delta, seg, dq, nullptr, nullptr, B, Sq, Sk,
                               Hq, Hkv, D, strides, causal, window, scale);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == repro::DTYPE_F32) return dispatch_dq_f32(p, s);
  if (dtype == repro::DTYPE_BF16) return dispatch_dq_bf16(p, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" int repro_flash_dkv(const void* q, const void* k, const void* v, const void* dout,
                               const void* lse, const void* delta, const void* seg, void* dk,
                               void* dv, int dtype, int B, int Sq, int Sk, int Hq, int Hkv,
                               int D, const long long* strides, int causal, int window,
                               float scale, void* stream) {
  if (bad_shape(B, Sq, Hq, Hkv, D)) return (int)cudaErrorInvalidValue;
  const Params p = make_params(q, k, v, dout, lse, delta, seg, nullptr, dk, dv, B, Sq, Sk, Hq,
                               Hkv, D, strides, causal, window, scale);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == repro::DTYPE_F32) return dispatch_dkv_f32(p, s);
  if (dtype == repro::DTYPE_BF16) return dispatch_dkv_bf16(p, s);
  return (int)cudaErrorInvalidValue;
}
