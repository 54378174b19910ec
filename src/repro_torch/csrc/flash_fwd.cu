// K1: flash-attention forward for Hopper (sm_90a).
//
// Replaces the Pallas kernel repro/kernels/flash_attention.py:_fwd_kernel
// (launched by _forward).  Same function: online-softmax attention with the
// causal, sliding-window and segment-id masks, GQA through h / g, output O and
// lse = m + log(max(l, 1e-30)) per row in f32 (natural log: K3 and K4
// recompute P = exp(s - lse) from it).  A fully masked row gives O = 0 and
// lse = -1e30 + log(1e-30), as the reference does.  Any head dim D that is a
// multiple of 8 up to 128, any Sq and Sk.
//
// What bounds it on this card: tensor-core operations, 4*B*Hq*Sq*Sk*D
// (about halved when causal) against 989 TFLOP/s in bf16; the bytes (q, k,
// v and O once each) are ~D/Sk as many.
//
// bf16, what the design does about it.  The work items are (128-row q
// tile, query head, batch row); one persistent block per SM walks them, the
// long causal q tiles first and in serpentine order over the rounds (the
// block that took the longest item of one round takes the shortest of the
// next), so the blocks finish together.  Three warpgroups: two consumers
// own 64 query rows each (wgmma's M), one producer thread issues TMA loads
// (the producer warpgroup gives its registers to the consumers with
// setmaxnreg, 24 / 240).  Q is loaded once an item, and the next item's Q
// as soon as both consumers have issued their last Q K^T; K and V tiles of
// BK = 128 keys go through a ring of stages (3 at D <= 64, 2 above, within
// the 227 KB of shared memory) that runs on across items, guarded by
// full/empty mbarriers, so the loads of the next tiles (the next item's
// first ones included) overlap the products and epilogue of this one.  BK = 128 halves the barriers and the
// softmax passes of BK = 64 and keeps the S accumulator at 64 registers a
// thread.  The tensor maps read (B, S, H, D) through its strides, swizzled
// 128 bytes; the D tail past a multiple of 64 and the ragged Sq/Sk tails
// arrive as zeros (TMA's out-of-bounds fill), and only D columns are
// written.  S = Q K^T is wgmma m64n128k16 from shared memory into registers;
// the online softmax runs there in the log2 domain (scale * log2 e folded
// into one FFMA per score, ex2; lse converted back to natural log), row max
// and sum by shuffles in the accumulator's quad, and tests masks only on
// tiles that cross the causal diagonal (one compare a score there), the
// window edge or the Sk tail, or where segment ids are given.  P is rounded to bf16 in registers, in the
// layout wgmma takes for its A operand, and O += P V is wgmma m64n64k16 per
// 64 columns of V, V read MN-major from the TMA tile (no transpose); O stays
// in registers.
//
// Overlap.  Within a consumer, S of tile j is issued together with P V of
// tile j - 1 and the softmax of tile j runs while P V does; between the
// consumers, named barriers make them take turns at issuing products, so
// one's softmax overlaps the other's products.  ptxas serializes every
// wgmma of a kernel (a wait after each) if one sits in a branch it cannot
// prove uniform, or if a register a product in flight reads is written
// before its wait: so the main loop has no data-dependent branch (a
// warpgroup computes its tiles outside its own causal/window bounds fully
// masked), the warpgroup index is read through a shuffle, the softmax
// writes P over S only after S's wait and packs it to bf16 only after the
// previous P V's wait, and P V is a pipeline stage of its own.  Segment ids
// take their own instantiation, which skips the tiles whose keys carry none
// of a warpgroup's rows' ids (the segment range test of _block_relevant)
// without the in-warpgroup overlap.  No atomics: equal inputs give equal
// bits.
//
// What bounds this design, and the next redesign.  At the causal shapes of
// the main path (S = 500-1024) a diagonal tile costs a whole tile for half
// its scores, and each item's epilogue (O stored from registers, 4 bytes a
// thread) stalls its consumer; at D = 64 the ex2 of the softmax takes the
// special-function units about as long as the tensor cores take for the
// products.  A third consumer warpgroup at D = 64 (192-row tiles), a TMA
// store of O from shared memory, and a host wrapper that encodes the tensor
// maps once per tensor are left for K1's next redesign.
//
// f32 (the identity checks' path): one block of 4 warps per 64-row q tile,
// tiles staged through shared memory by plain loads, FMA loops, two threads
// per softmax row; D padded with zeros to 16/32/64/96/128 in shared memory.

#include <stdint.h>

#include <climits>

#include "common.cuh"
#include "hopper.cuh"

namespace {

using repro::NEG_INF;
using bf16 = __nv_bfloat16;
namespace hp = repro::hopper;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const int* seg;  // (B, S) or nullptr
  void* o;         // (B, Sq, Hq, D) contiguous
  float* lse;      // (B, Hq, Sq)
  int B, Sq, Sk, Hq, Hkv, D;
  long long q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh;
  int causal, window;  // window <= 0: none
  float scale;
};

// The k tiles of width bk that _block_relevant keeps for query rows
// [r0, r1): keys below the last row when causal, from the first row's window
// start when windowed.  [*begin, *end) in tile units.
__device__ __forceinline__ void tile_range(const Params& p, int r0, int r1, int bk, int* begin,
                                           int* end) {
  int k_hi = p.Sk;
  if (p.causal) k_hi = min(k_hi, r1);
  const int k_lo = p.window > 0 ? max(0, r0 - p.window + 1) : 0;
  *begin = k_lo / bk;
  *end = max(*begin, (k_hi + bk - 1) / bk);
}

// ===========================================================================
// bf16: wgmma + TMA ring
// ===========================================================================

constexpr int BQ = 128;        // query rows per block: two consumer warpgroups of 64
constexpr int BK = 128;        // keys per tile
constexpr int NTHREADS = 384;  // warpgroups 0, 1: consumers; 2: producer
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

template <int DP>  // D padded to a multiple of 64: 64 or 128
struct Ring {
  static constexpr int ATOMS = DP / 64;              // 64-column TMA boxes per row
  static constexpr int STAGES = DP == 64 ? 3 : 2;
  static constexpr uint32_t Q_BYTES = BQ * DP * 2;
  static constexpr uint32_t KV_BYTES = BK * DP * 2;  // one K or V tile
  static constexpr uint32_t q_off = 0;
  static constexpr uint32_t kv_off = Q_BYTES;        // stage s: K at +2s KV_BYTES, V after it
  static constexpr uint32_t bar_off = kv_off + STAGES * 2 * KV_BYTES;
  // full[STAGES], empty[STAGES], Q full and empty; 1024 bytes of slack to
  // align the base
  static constexpr uint32_t bytes = bar_off + 8 * (2 * STAGES + 2) + 1024;
};

struct SegInfo {  // a consumer's segment ids: its two rows', and its rows' range
  int q0, q1, lo, hi;
};

struct RowState {  // a thread's two rows: running max (log2 units) and partial sum
  float m0, m1, l0, l1;
};

// One tile of the online softmax on raw scores sc (masked ones -1e30): the
// new row maxima, P = 2^(s sl2 - m) in f32 into pe (which may be sc), the
// partial row sums, and the factors al0/al1 by which O must be rescaled.  A
// row with every key masked so far keeps m = -1e30; its exponents are taken
// against 0 and give exactly 0.
__device__ __forceinline__ void softmax_tile(RowState& st, float (&sc)[64], float (&pe)[64],
                                             float sl2, float& al0, float& al1) {
  float mx0 = NEG_INF, mx1 = NEG_INF;
#pragma unroll
  for (int j = 0; j < 64; ++j) {
    if (j & 2) mx1 = fmaxf(mx1, sc[j]);
    else mx0 = fmaxf(mx0, sc[j]);
  }
#pragma unroll
  for (int o2 = 1; o2 <= 2; o2 <<= 1) {
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, o2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, o2));
  }
  // to log2 units (sl2 > 0 keeps the max)
  const float mn0 = fmaxf(st.m0, mx0 == NEG_INF ? NEG_INF : mx0 * sl2);
  const float mn1 = fmaxf(st.m1, mx1 == NEG_INF ? NEG_INF : mx1 * sl2);
  const float b0 = mn0 == NEG_INF ? 0.f : mn0, b1 = mn1 == NEG_INF ? 0.f : mn1;
  al0 = hp::ex2(st.m0 - b0);
  al1 = hp::ex2(st.m1 - b1);
  st.m0 = mn0;
  st.m1 = mn1;
  float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
  for (int j = 0; j < 64; j += 2) {
    const bool r1 = j & 2;
    pe[j] = hp::ex2(fmaf(sc[j], sl2, -(r1 ? b1 : b0)));
    pe[j + 1] = hp::ex2(fmaf(sc[j + 1], sl2, -(r1 ? b1 : b0)));
    if (r1) sum1 += pe[j] + pe[j + 1];
    else sum0 += pe[j] + pe[j + 1];
  }
  st.l0 = st.l0 * al0 + sum0;
  st.l1 = st.l1 * al1 + sum1;
}

template <int ATOMS>
__device__ __forceinline__ void rescale_o(float (&o)[ATOMS][32], float al0, float al1) {
#pragma unroll
  for (int a = 0; a < ATOMS; ++a)
#pragma unroll
    for (int j = 0; j < 32; ++j) o[a][j] *= (j & 2) ? al1 : al0;
}

// Persistent: one block per SM walks the work items (q tile, head, batch
// row), the long causal q tiles first; in round r a block takes item
// r * gridDim.x + its index, counted backwards in odd rounds, so the blocks
// that took the longest items of one round take the shortest of the next.  The
// producer runs ahead across items: it loads the next item's Q as soon as
// both consumers have issued their last Q K^T of this one, and the K/V ring
// goes on across items, so a block pays the first loads and its launch once.
//
// SEG: segment ids are given.  Without them the main loop has no
// data-dependent branch around a product (ptxas serializes wgmma inside
// branches it cannot prove uniform), so a warpgroup's tiles outside its own
// bounds are computed fully masked; with them a warpgroup skips the tiles
// whose keys carry none of its rows' ids.
template <int DP, bool SEG>
__global__ void __launch_bounds__(NTHREADS, 1)
    flash_fwd_wgmma(const __grid_constant__ CUtensorMap tm_q,
                    const __grid_constant__ CUtensorMap tm_k,
                    const __grid_constant__ CUtensorMap tm_v, const Params p) {
  using R = Ring<DP>;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw = hp::smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;  // swizzled tiles start on 1024 bytes
  const uint32_t sq = base + R::q_off;
  const uint32_t bar = base + R::bar_off;
  auto full = [&](int s) { return bar + 8u * s; };
  auto empty = [&](int s) { return bar + 8u * (R::STAGES + s); };
  const uint32_t qfull = bar + 8u * (2 * R::STAGES), qempty = qfull + 8u;
  auto sk = [&](int s) { return base + R::kv_off + 2u * s * R::KV_BYTES; };
  auto sv = [&](int s) { return sk(s) + R::KV_BYTES; };

  const int n_qt = (p.Sq + BQ - 1) / BQ;
  const int per_qt = p.Hq * p.B;
  const int n_items = n_qt * per_qt;
  const int n_rounds = (n_items + gridDim.x - 1) / gridDim.x;
  // this block's item of round r, or -1: q tile n_qt - 1 - w / per_qt (the
  // long causal tiles first), then head and batch row
  auto item = [&](int r, int* q0, int* h, int* b) {
    const int w = r * gridDim.x + ((r & 1) ? gridDim.x - 1 - blockIdx.x : blockIdx.x);
    if (w >= n_items) return false;
    *q0 = (n_qt - 1 - w / per_qt) * BQ;
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
        tile_range(p, q0, min(q0 + BQ, p.Sq), BK, &kt_begin, &kt_end);
        hp::mbar_wait(qempty, (it & 1) ^ 1);  // the first item passes
        hp::mbar_arrive_expect_tx(qfull, R::Q_BYTES);
        for (int a = 0; a < R::ATOMS; ++a)
          hp::tma_load_4d(sq + a * BQ * 128, &tm_q, qfull, 64 * a, h, q0, b);
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
  const uint32_t sqc = sq + c * 64 * 128;
  // the two consumers take turns at issuing their products (named barriers
  // 3 and 4): while one runs its softmax, the tensor cores run the other's
  auto turn_begin = [&]() { hp::named_sync(3 + c, 256); };

  int n = 0, it = 0;  // tiles and items consumed so far
  for (int r = 0; r < n_rounds; ++r) {
    int q0, h, b;
    if (!item(r, &q0, &h, &b)) continue;
    int kt_begin, kt_end;
    tile_range(p, q0, min(q0 + BQ, p.Sq), BK, &kt_begin, &kt_end);
    const int T = kt_end - kt_begin;
    const int qp0 = q0 + 64 * c + 16 * w + lane / 4, qp1 = qp0 + 8;  // this thread's rows
    const int wq0 = q0 + 64 * c, wq1 = min(wq0 + 64, p.Sq);         // the warpgroup's rows
    const bool live = wq0 < p.Sq;
    int wk_hi = p.Sk;
    if (p.causal) wk_hi = min(wk_hi, wq1);
    const int wk_lo = p.window > 0 ? max(0, wq0 - p.window + 1) : 0;
    const int* segb = SEG ? p.seg + (long long)b * p.Sq : nullptr;
    auto turn_end = [&](int i) {
      if (!(c == 1 && i + 1 == T)) hp::named_arrive(4 - c, 256);
    };

    SegInfo sg{0, 0, 0, -1};
    if (SEG && live) {
      sg.q0 = qp0 < p.Sq ? segb[qp0] : INT_MAX;
      sg.q1 = qp1 < p.Sq ? segb[qp1] : INT_MAX;
      // the warpgroup's id range, for the tile skip: rows past Sq take no part
      const int r = wq0 + tid;
      int lo = INT_MAX, hi = INT_MIN;
      if (tid < 64 && r < wq1) lo = hi = segb[r];
      for (int o = 16; o > 0; o >>= 1) {
        lo = min(lo, __shfl_xor_sync(0xffffffffu, lo, o));
        hi = max(hi, __shfl_xor_sync(0xffffffffu, hi, o));
      }
      __shared__ int red[2][2][4];
      if (lane == 0) red[c][0][w] = lo, red[c][1][w] = hi;
      hp::named_sync(1 + c, 128);
      sg.lo = min(min(red[c][0][0], red[c][0][1]), min(red[c][0][2], red[c][0][3]));
      sg.hi = max(max(red[c][1][0], red[c][1][1]), max(red[c][1][2], red[c][1][3]));
      hp::named_sync(1 + c, 128);  // red is rewritten for the next item
    }

    // masks on a tile that crosses an edge of the warpgroup's rows: the Sk
    // tail, the causal diagonal, the window, a tile outside the warpgroup's
    // bounds, segment ids.  Interior tiles take no per-element test.
    auto mask_tile = [&](float (&sc)[64], int k0) {
      const bool out = !live || k0 >= wk_hi || k0 + BK <= wk_lo;
      const bool diag = p.causal && k0 + BK - 1 > wq0;
      const bool other = SEG || out || k0 + BK > p.Sk || (p.window > 0 && k0 < wq1 - p.window);
      if (!diag && !other) return;
      if (!other) {
        // the causal diagonal alone: one compare of the column against the
        // row's last visible key
        const int t0 = qp0 - k0 - 2 * (lane % 4), t1 = t0 + 8;
#pragma unroll
        for (int j = 0; j < 64; ++j)
          if (8 * (j / 4) + (j & 1) > ((j & 2) ? t1 : t0)) sc[j] = NEG_INF;
        return;
      }
#pragma unroll
      for (int j = 0; j < 64; ++j) {
        const int kpos = k0 + 8 * (j / 4) + 2 * (lane % 4) + (j & 1);
        const int qpos = (j & 2) ? qp1 : qp0;
        bool ok = !out && kpos < p.Sk;
        if (p.causal) ok = ok && kpos <= qpos;
        if (p.window > 0) ok = ok && kpos > qpos - p.window;
        if (SEG) ok = ok && segb[kpos] == ((j & 2) ? sg.q1 : sg.q0);
        if (!ok) sc[j] = NEG_INF;
      }
    };

    float o[R::ATOMS][32];
    hp::zero_acc(o);
    RowState st{NEG_INF, NEG_INF, 0.f, 0.f};
    float sc[64], al0, al1;
    hp::mbar_wait(qfull, it & 1);
    if (c == 1 && T > 0) hp::named_arrive(3, 256);
    if (T == 0) hp::mbar_arrive(qempty);

    if constexpr (!SEG) {
      // S of tile i is issued with P V of tile i - 1, and the softmax of
      // tile i overlaps that product
      if (T > 0) {
        uint32_t pp[BK / 16][4];
        int s_prev = n % R::STAGES;
        hp::mbar_wait(full(s_prev), (n / R::STAGES) & 1);
        turn_begin();
        hp::wgmma_fence();
        hp::mma_ss<BK, DP>(sc, sqc, BQ * 128, sk(s_prev), BK * 128);
        hp::wgmma_commit();
        turn_end(0);
        hp::wgmma_wait<0>();
        hp::fence_regs(sc);
        if (T == 1) hp::mbar_arrive(qempty);  // the producer may load the next Q
        mask_tile(sc, kt_begin * BK);
        softmax_tile(st, sc, sc, sl2, al0, al1);  // O is still 0
        hp::pack_a(sc, pp);
        for (int i = 1; i < T; ++i) {
          const int s = (n + i) % R::STAGES;
          hp::mbar_wait(full(s), ((n + i) / R::STAGES) & 1);
          turn_begin();
          hp::fence_acc(o);
          hp::wgmma_fence();
          hp::mma_ss<BK, DP>(sc, sqc, BQ * 128, sk(s), BK * 128);
          hp::wgmma_commit();
          // P V in a pipeline stage of its own: the softmax below rewrites
          // S's registers while it runs
          hp::wgmma_fence();
          hp::mma_rs<BK>(o, pp, sv(s_prev), BK * 128);
          hp::wgmma_commit();
          turn_end(i);
          hp::wgmma_wait<1>();  // S is the older group
          hp::fence_regs(sc);
          if (i + 1 == T) hp::mbar_arrive(qempty);
          mask_tile(sc, (kt_begin + i) * BK);
          softmax_tile(st, sc, sc, sl2, al0, al1);  // in place: S is done
          hp::wgmma_wait<0>();
          hp::fence_acc(o);
          hp::fence_regs(pp);
          hp::mbar_arrive(empty(s_prev));
          // O holds the tiles before this one, relative to the old max
          rescale_o(o, al0, al1);
          hp::pack_a(sc, pp);
          s_prev = s;
        }
        hp::fence_acc(o);
        hp::wgmma_fence();
        hp::mma_rs<BK>(o, pp, sv(s_prev), BK * 128);
        hp::wgmma_commit();
        hp::wgmma_wait<0>();
        hp::fence_acc(o);
        hp::fence_regs(pp);
        hp::mbar_arrive(empty(s_prev));
      }
    } else {
      for (int i = 0; i < T; ++i) {
        const int s = (n + i) % R::STAGES;
        hp::mbar_wait(full(s), ((n + i) / R::STAGES) & 1);
        const int k0 = (kt_begin + i) * BK;
        bool skip = !live || k0 >= wk_hi || k0 + BK <= wk_lo;
        if (!skip) {
          // does any key of the tile carry an id of the warpgroup's rows?
          const int kk = k0 + tid;
          const int ks = kk < p.Sk ? segb[kk] : 0;
          skip = !hp::barrier_or(1 + c, 128, kk < p.Sk && ks >= sg.lo && ks <= sg.hi);
        }
        skip = __shfl_sync(0xffffffffu, skip, 0);  // warp-uniform for ptxas, as c
        turn_begin();
        if (!skip) {
          hp::wgmma_fence();
          hp::mma_ss<BK, DP>(sc, sqc, BQ * 128, sk(s), BK * 128);
          hp::wgmma_commit();
        }
        turn_end(i);
        if (!skip) {
          hp::wgmma_wait<0>();
          hp::fence_regs(sc);
          mask_tile(sc, k0);
          // not in place: the branch around the products keeps ptxas from
          // seeing S's stage closed
          float pe[64];
          softmax_tile(st, sc, pe, sl2, al0, al1);
          rescale_o(o, al0, al1);
          uint32_t pn[BK / 16][4];
          hp::pack_a(pe, pn);
          hp::fence_acc(o);
          hp::wgmma_fence();
          hp::mma_rs<BK>(o, pn, sv(s), BK * 128);
          hp::wgmma_commit();
          hp::wgmma_wait<0>();
          hp::fence_acc(o);
          hp::fence_regs(pn);
        }
        hp::mbar_arrive(empty(s));
      }
      if (T > 0) hp::mbar_arrive(qempty);
    }
    n += T;
    ++it;

    // epilogue: the quad's partial sums, then O / l (D columns only) and lse
#pragma unroll
    for (int o2 = 1; o2 <= 2; o2 <<= 1) {
      st.l0 += __shfl_xor_sync(0xffffffffu, st.l0, o2);
      st.l1 += __shfl_xor_sync(0xffffffffu, st.l1, o2);
    }
    const float L0 = fmaxf(st.l0, 1e-30f), L1 = fmaxf(st.l1, 1e-30f);
    const float inv0 = 1.f / L0, inv1 = 1.f / L1;
    bf16* og = static_cast<bf16*>(p.o);
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const int qpos = rr ? qp1 : qp0;
      if (qpos >= p.Sq) continue;
      const float inv = rr ? inv1 : inv0;
      bf16* orow = og + (((long long)b * p.Sq + qpos) * p.Hq + h) * p.D;
#pragma unroll
      for (int a = 0; a < R::ATOMS; ++a)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int col = 64 * a + 8 * j + 2 * (lane % 4);
          if (col < p.D)
            *reinterpret_cast<uint32_t*>(orow + col) =
                hp::pack_bf16(o[a][4 * j + 2 * rr] * inv, o[a][4 * j + 2 * rr + 1] * inv);
        }
      if (lane % 4 == 0) {
        const float m = rr ? st.m1 : st.m0;
        p.lse[((long long)b * p.Hq + h) * p.Sq + qpos] =
            (m == NEG_INF ? NEG_INF : m * LN2) + logf(rr ? L1 : L0);
      }
    }
  }
}

template <int DP, bool SEG>
int launch_wgmma(const CUtensorMap& tq, const CUtensorMap& tk, const CUtensorMap& tv,
                 const Params& p, cudaStream_t stream) {
  using R = Ring<DP>;
  static bool attr_set = false;  // per instantiation: above 48 KB needs opting in
  if (!attr_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_fwd_wgmma<DP, SEG>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)R::bytes);
    if (e != cudaSuccess) return (int)e;
    attr_set = true;
  }
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  const long long items = (long long)((p.Sq + BQ - 1) / BQ) * p.Hq * p.B;
  const int grid = (int)(items < sms ? items : sms);  // one block per SM, persistent
  flash_fwd_wgmma<DP, SEG><<<grid, NTHREADS, R::bytes, stream>>>(tq, tk, tv, p);
  return (int)cudaGetLastError();
}

template <int DP>
int launch_bf16(const Params& p, cudaStream_t stream) {
  CUtensorMap tq, tk, tv;
  if (!hp::make_tensor_map_bhsd(&tq, p.q, p.B, p.Sq, p.Hq, p.D, p.q_sb, p.q_ss, p.q_sh, BQ) ||
      !hp::make_tensor_map_bhsd(&tk, p.k, p.B, p.Sk, p.Hkv, p.D, p.k_sb, p.k_ss, p.k_sh, BK) ||
      !hp::make_tensor_map_bhsd(&tv, p.v, p.B, p.Sk, p.Hkv, p.D, p.v_sb, p.v_ss, p.v_sh, BK))
    return (int)cudaErrorInvalidValue;
  return p.seg != nullptr ? launch_wgmma<DP, true>(tq, tk, tv, p, stream)
                          : launch_wgmma<DP, false>(tq, tk, tv, p, stream);
}

// ===========================================================================
// f32: FMA loops
// ===========================================================================

constexpr int FBQ = 64;
constexpr int FBK = 64;
constexpr int FTHREADS = 128;  // 4 warps; two threads per softmax row

constexpr size_t align128(size_t x) { return (x + 127) / 128 * 128; }

template <int DP>  // D padded to 16/32/64/96/128
struct F32Layout {
  static constexpr int LDT = DP + 1;  // Q, K, V rows: an odd pitch, no bank conflicts
  static constexpr int LDP = FBK + 1;
  static constexpr int LDS = FBK + 4;
  static constexpr int LDO = DP + 4;
  static constexpr size_t q_off = 0;
  static constexpr size_t k_off = align128(q_off + 4 * FBQ * LDT);
  static constexpr size_t v_off = align128(k_off + 4 * FBK * LDT);
  static constexpr size_t p_off = align128(v_off + 4 * FBK * LDT);
  static constexpr size_t s_off = align128(p_off + 4 * FBQ * LDP);
  static constexpr size_t o_off = align128(s_off + 4 * FBQ * LDS);
  static constexpr size_t m_off = align128(o_off + 4 * FBQ * LDO);
  static constexpr size_t l_off = m_off + 4 * FBQ;
  static constexpr size_t qs_off = l_off + 4 * FBQ;
  static constexpr size_t ks_off = qs_off + 4 * FBQ;
  static constexpr size_t bytes = ks_off + 4 * FBK;
};

// rows [row0, row0 + rows) of one head; rows past `avail` and columns past
// D are zero (a zero V row times a zeroed probability stays 0)
template <int DP>
__device__ __forceinline__ void load_tile_f32(float* dst, int ld, const float* src,
                                              long long row_stride, int row0, int avail,
                                              int rows, int D) {
  for (int idx = threadIdx.x; idx < rows * DP; idx += FTHREADS) {
    const int r = idx / DP, c = idx % DP;
    dst[r * ld + c] = (r < avail && c < D) ? src[(long long)(row0 + r) * row_stride + c] : 0.f;
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

template <int DP>
__global__ void __launch_bounds__(FTHREADS) flash_fwd_f32(const Params p) {
  using L = F32Layout<DP>;
  extern __shared__ __align__(128) unsigned char smem[];
  float* Qs = reinterpret_cast<float*>(smem + L::q_off);
  float* Ks = reinterpret_cast<float*>(smem + L::k_off);
  float* Vs = reinterpret_cast<float*>(smem + L::v_off);
  float* Ps = reinterpret_cast<float*>(smem + L::p_off);
  float* Ss = reinterpret_cast<float*>(smem + L::s_off);
  float* Os = reinterpret_cast<float*>(smem + L::o_off);
  float* m_s = reinterpret_cast<float*>(smem + L::m_off);
  float* l_s = reinterpret_cast<float*>(smem + L::l_off);
  int* qseg_s = reinterpret_cast<int*>(smem + L::qs_off);
  int* kseg_s = reinterpret_cast<int*>(smem + L::ks_off);

  const int tid = threadIdx.x;
  const int q0 = blockIdx.x * FBQ, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (p.Hq / p.Hkv);
  const int nq = min(FBQ, p.Sq - q0);
  const bool has_seg = p.seg != nullptr;
  const float* qg = static_cast<const float*>(p.q) + b * p.q_sb + h * p.q_sh;
  const float* kg = static_cast<const float*>(p.k) + b * p.k_sb + hk * p.k_sh;
  const float* vg = static_cast<const float*>(p.v) + b * p.v_sb + hk * p.v_sh;
  const int* segb = has_seg ? p.seg + (long long)b * p.Sq : nullptr;

  load_tile_f32<DP>(Qs, L::LDT, qg, p.q_ss, q0, nq, FBQ, p.D);
  for (int i = tid; i < FBQ * L::LDO; i += FTHREADS) Os[i] = 0.f;
  if (tid < FBQ) {
    m_s[tid] = NEG_INF;
    l_s[tid] = 0.f;
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
  int kt_begin, kt_end;
  tile_range(p, q0, q0 + nq, FBK, &kt_begin, &kt_end);

  const int r = tid >> 1, half = tid & 1;
  const int qpos = q0 + r;

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k0 = kt * FBK;
    const int nk = min(FBK, p.Sk - k0);
    __syncthreads();  // the previous tile is done with Ks, Vs, Ps, kseg_s
    load_tile_f32<DP>(Ks, L::LDT, kg, p.k_ss, k0, nk, FBK, p.D);
    load_tile_f32<DP>(Vs, L::LDT, vg, p.v_ss, k0, nk, FBK, p.D);
    if (has_seg && tid < FBK) kseg_s[tid] = tid < nk ? segb[k0 + tid] : 0;
    __syncthreads();
    if (has_seg) {
      // conservative: a (q, k) pair with equal ids needs kseg in [qmin, qmax]
      const int hit = tid < nk && kseg_s[tid] >= qmin && kseg_s[tid] <= qmax;
      if (!__syncthreads_or(hit)) continue;
    }
    // S = Q K^T (unscaled)
    for (int idx = tid; idx < FBQ * FBK; idx += FTHREADS) {
      const int rr = idx / FBK, cc = idx % FBK;
      const float* qr = Qs + rr * L::LDT;
      const float* kr = Ks + cc * L::LDT;
      float acc = 0.f;
#pragma unroll 8
      for (int d = 0; d < DP; ++d) acc = fmaf(qr[d], kr[d], acc);
      Ss[rr * L::LDS + cc] = acc;
    }
    __syncthreads();

    const float m_prev = m_s[r], l_prev = l_s[r];
    const int qs = qseg_s[r];
    float* srow = Ss + r * L::LDS + half * 32;
    float mx = NEG_INF;
#pragma unroll 4
    for (int j = 0; j < 32; ++j) {
      const int cc = half * 32 + j;
      const bool ok = visible(p, qpos, k0 + cc, qs, kseg_s[cc], has_seg);
      const float sv = ok ? srow[j] * p.scale : NEG_INF;
      srow[j] = sv;
      mx = fmaxf(mx, sv);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    const float m_cur = fmaxf(m_prev, mx);
    const float alpha = expf(m_prev - m_cur);
    float* prow = Ps + r * L::LDP + half * 32;
    float sum = 0.f;
#pragma unroll 4
    for (int j = 0; j < 32; ++j) {
      const int cc = half * 32 + j;
      const bool ok = visible(p, qpos, k0 + cc, qs, kseg_s[cc], has_seg);
      const float pj = ok ? expf(srow[j] - m_cur) : 0.f;  // masked: exactly 0
      prow[j] = pj;
      sum += pj;
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    float* orow = Os + r * L::LDO + half * (DP / 2);
    for (int d = 0; d < DP / 2; ++d) orow[d] *= alpha;
    if (half == 0) {
      m_s[r] = m_cur;
      l_s[r] = l_prev * alpha + sum;
    }
    __syncthreads();
    // O += P V
    for (int idx = tid; idx < FBQ * DP; idx += FTHREADS) {
      const int rr = idx / DP, d = idx % DP;
      const float* pr = Ps + rr * L::LDP;
      float acc = 0.f;
#pragma unroll 8
      for (int cc = 0; cc < FBK; ++cc) acc = fmaf(pr[cc], Vs[cc * L::LDT + d], acc);
      Os[rr * L::LDO + d] += acc;
    }
  }
  __syncthreads();

  if (qpos < p.Sq) {
    const float l = fmaxf(l_s[r], 1e-30f);
    float* og = static_cast<float*>(p.o) + (((long long)b * p.Sq + qpos) * p.Hq + h) * p.D;
    const float* orow = Os + r * L::LDO;
    for (int d = half; d < p.D; d += 2) og[d] = orow[d] / l;
    if (half == 0) p.lse[((long long)b * p.Hq + h) * p.Sq + qpos] = m_s[r] + logf(l);
  }
}

template <int DP>
int launch_f32(const Params& p, cudaStream_t stream) {
  using L = F32Layout<DP>;
  static bool attr_set = false;
  if (!attr_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_fwd_f32<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L::bytes);
    if (e != cudaSuccess) return (int)e;
    attr_set = true;
  }
  const dim3 grid((p.Sq + FBQ - 1) / FBQ, p.Hq, p.B);
  flash_fwd_f32<DP><<<grid, FTHREADS, L::bytes, stream>>>(p);
  return (int)cudaGetLastError();
}

int dispatch_f32(const Params& p, cudaStream_t s) {
  if (p.D <= 16) return launch_f32<16>(p, s);
  if (p.D <= 32) return launch_f32<32>(p, s);
  if (p.D <= 64) return launch_f32<64>(p, s);
  if (p.D <= 96) return launch_f32<96>(p, s);
  return launch_f32<128>(p, s);
}

}  // namespace

extern "C" int repro_flash_fwd(const void* q, const void* k, const void* v, const void* seg,
                               void* o, void* lse, int dtype, int B, int Sq, int Sk, int Hq,
                               int Hkv, int D, long long q_sb, long long q_ss, long long q_sh,
                               long long k_sb, long long k_ss, long long k_sh, long long v_sb,
                               long long v_ss, long long v_sh, int causal, int window,
                               float scale, void* stream) {
  if (Hkv <= 0 || Hq % Hkv != 0 || D < 8 || D > 128 || D % 8 != 0)
    return (int)cudaErrorInvalidValue;
  const Params p{q, k, v, static_cast<const int*>(seg), o, static_cast<float*>(lse),
                 B, Sq, Sk, Hq, Hkv, D, q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh,
                 causal, window, scale};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == repro::DTYPE_F32) return dispatch_f32(p, s);
  if (dtype == repro::DTYPE_BF16) return D <= 64 ? launch_bf16<64>(p, s) : launch_bf16<128>(p, s);
  return (int)cudaErrorInvalidValue;
}
