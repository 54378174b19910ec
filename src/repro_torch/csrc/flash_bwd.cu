// K2, K3, K4: the flash-attention backward for Hopper (sm_90a).
//
// Replace the Pallas kernels of repro/kernels/flash_attention.py (launched by
// _backward):
//   K2 _delta_kernel: delta = rowsum(dO * O) per (b, h, q) row, f32;
//   K3 _dq_kernel:    dQ = scale * sum_k dS K, with P = exp(s - lse) * mask
//                     recomputed and dS = P * (dO V^T - delta);
//   K4 _dkv_kernel:   dV = sum_q P^T dO and dK = scale * sum_q dS^T Q.
// The masks are K1's: causal, sliding window and segment ids, over aligned
// positions; masked entries are zeroed explicitly (on a row with no valid key
// lse = -1e30, so exp(s - lse) would be 1, not 0).
//
// What bounds them on this card: K2 is a streaming reduction, bound by bytes
// (O and dO read once, delta written once).  K3 does three products per
// (q, k) tile pair and K4 four, so both are bound by tensor-core operations
// (about halved when causal); their bytes are ~D/S as many.
//
// What the design does about it: K2 gives one warp to each row; rows are
// taken in memory order (b, q, h), so neighbouring warps read neighbouring
// rows.  K3 is one block of 4 warps per (64-row q tile, query head, batch
// row); it keeps Q, dO, lse and delta of the tile in shared memory, sweeps the
// K/V tiles that _block_relevant keeps (causal upper bound, window lower
// bound, segment-id interval test) and accumulates dQ in f32 in shared
// memory.  K4 is one block per (64-row k tile, KV head, batch row): it keeps
// K and V in shared memory and sweeps the g query heads of its group and, for
// each, the q tiles that can see the k tile, so the GQA group sum happens in
// its f32 accumulators: no (B, Hq, Sk, D) intermediate, no atomics, and a
// fixed summation order.  In bf16 every product runs on the tensor cores
// through WMMA with f32 accumulation, P and dS rounded to bf16 before their
// products; f32 keeps FMA loops (and q tiles of 32 rows in K4, so four tiles
// and two accumulators fit in shared memory).  Ragged q/k tails are
// zero-filled and masked.  A simple first kernel: no wgmma, TMA or warp
// specialisation yet.

#include <mma.h>
#include <stdint.h>

#include <climits>
#include <type_traits>

#include "common.cuh"

namespace {

using repro::from_f;
using repro::to_f;
using bf16 = __nv_bfloat16;

constexpr int NTHREADS = 128;  // 4 warps; with WMMA warp w owns rows [16w, 16w + 16)
constexpr int BK = 64;         // key rows per tile
constexpr size_t SMEM_LIMIT = 232448;  // bytes a block may use on an H100
constexpr int DELTA_WARPS = 8;

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
  int B, Sq, Sk, Hq, Hkv;
  long long q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, do_sb, do_ss, do_sh;
  int causal, window;  // window <= 0: none
  float scale;
};

constexpr size_t align128(size_t x) { return (x + 127) / 128 * 128; }

template <typename T>
struct Pads {
  // f32 rows get an odd pitch (fewer bank conflicts in the FMA loops); bf16
  // rows a pitch that keeps every 16-row WMMA fragment 32-byte aligned
  static constexpr int PAD = std::is_same<T, float>::value ? 1 : 8;
};

template <typename T, int D>
struct DqLayout {
  static constexpr int BQ = 64;
  static constexpr int LDT = D + Pads<T>::PAD;   // Q, dO, K, V rows
  static constexpr int LDP = BK + Pads<T>::PAD;  // dS rows
  static constexpr int LDS = BK + 4;             // S, dP rows (f32)
  static constexpr int LDO = D + 4;              // dQ accumulator rows (f32)
  static constexpr size_t q_off = 0;
  static constexpr size_t do_off = align128(q_off + sizeof(T) * BQ * LDT);
  static constexpr size_t k_off = align128(do_off + sizeof(T) * BQ * LDT);
  static constexpr size_t v_off = align128(k_off + sizeof(T) * BK * LDT);
  static constexpr size_t s_off = align128(v_off + sizeof(T) * BK * LDT);
  static constexpr size_t dp_off = align128(s_off + sizeof(float) * BQ * LDS);
  static constexpr size_t ds_off = align128(dp_off + sizeof(float) * BQ * LDS);
  static constexpr size_t acc_off = align128(ds_off + sizeof(T) * BQ * LDP);
  static constexpr size_t lse_off = align128(acc_off + sizeof(float) * BQ * LDO);
  static constexpr size_t delta_off = lse_off + sizeof(float) * BQ;
  static constexpr size_t qs_off = delta_off + sizeof(float) * BQ;
  static constexpr size_t ks_off = qs_off + sizeof(int) * BQ;
  static constexpr size_t bytes = ks_off + sizeof(int) * BK;
};

template <typename T, int D>
struct DkvLayout {
  // f32 takes q tiles of 32 rows so that K, V, Q, dO and both accumulators
  // fit in shared memory at D = 128; bf16 takes 64 (one WMMA strip per warp)
  static constexpr int BQ = std::is_same<T, float>::value ? 32 : 64;
  static constexpr int LDT = D + Pads<T>::PAD;   // K, V, Q, dO rows
  static constexpr int LDS = BK + 4;             // S, dP rows (q-major, f32)
  static constexpr int LDP = BQ + Pads<T>::PAD;  // P^T, dS^T rows (k-major)
  static constexpr int LDO = D + 4;              // dK, dV accumulator rows (f32)
  static constexpr size_t k_off = 0;
  static constexpr size_t v_off = align128(k_off + sizeof(T) * BK * LDT);
  static constexpr size_t q_off = align128(v_off + sizeof(T) * BK * LDT);
  static constexpr size_t do_off = align128(q_off + sizeof(T) * BQ * LDT);
  static constexpr size_t s_off = align128(do_off + sizeof(T) * BQ * LDT);
  static constexpr size_t dp_off = align128(s_off + sizeof(float) * BQ * LDS);
  static constexpr size_t pt_off = align128(dp_off + sizeof(float) * BQ * LDS);
  static constexpr size_t dst_off = align128(pt_off + sizeof(T) * BK * LDP);
  static constexpr size_t dk_off = align128(dst_off + sizeof(T) * BK * LDP);
  static constexpr size_t dv_off = align128(dk_off + sizeof(float) * BK * LDO);
  static constexpr size_t lse_off = align128(dv_off + sizeof(float) * BK * LDO);
  static constexpr size_t delta_off = lse_off + sizeof(float) * BQ;
  static constexpr size_t qs_off = delta_off + sizeof(float) * BQ;
  static constexpr size_t ks_off = qs_off + sizeof(int) * BQ;
  static constexpr size_t bytes = ks_off + sizeof(int) * BK;
};

// rows [row0, row0 + rows) of one head into shared memory; rows past `avail`
// are zero
template <typename T, int D>
__device__ __forceinline__ void load_tile(T* dst, int ld, const T* src, long long row_stride,
                                          int row0, int avail, int rows) {
  for (int idx = threadIdx.x; idx < rows * D; idx += NTHREADS) {
    const int r = idx / D, c = idx % D;
    dst[r * ld + c] = r < avail ? src[(long long)(row0 + r) * row_stride + c] : from_f<T>(0.f);
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

// C (M x N, f32) = A (M x KD) . B (N x KD)^T
template <typename T, int M, int N, int KD>
__device__ __forceinline__ void mm_abt(const T* A, int lda, const T* B, int ldb, float* C,
                                       int ldc) {
  if constexpr (std::is_same<T, bf16>::value) {
    static_assert(M == 16 * (NTHREADS / 32), "one 16-row strip per warp");
    using namespace nvcuda;
    const int w = threadIdx.x / 32;
#pragma unroll
    for (int j = 0; j < N / 16; ++j) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> c;
      wmma::fill_fragment(c, 0.f);
#pragma unroll
      for (int kk = 0; kk < KD / 16; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
        // B stored row-major (n, kd) is B^T in column-major
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> b;
        wmma::load_matrix_sync(a, A + (16 * w) * lda + 16 * kk, lda);
        wmma::load_matrix_sync(b, B + (16 * j) * ldb + 16 * kk, ldb);
        wmma::mma_sync(c, a, b, c);
      }
      wmma::store_matrix_sync(C + (16 * w) * ldc + 16 * j, c, ldc, wmma::mem_row_major);
    }
  } else {
    for (int idx = threadIdx.x; idx < M * N; idx += NTHREADS) {
      const int r = idx / N, c = idx % N;
      const float* ar = A + r * lda;
      const float* br = B + c * ldb;
      float acc = 0.f;
#pragma unroll 8
      for (int d = 0; d < KD; ++d) acc = fmaf(ar[d], br[d], acc);
      C[r * ldc + c] = acc;
    }
  }
}

// C (M x N, f32) += A (M x KC) . B (KC x N)
template <typename T, int M, int KC, int N>
__device__ __forceinline__ void mm_acc(const T* A, int lda, const T* B, int ldb, float* C,
                                       int ldc) {
  if constexpr (std::is_same<T, bf16>::value) {
    static_assert(M == 16 * (NTHREADS / 32), "one 16-row strip per warp");
    using namespace nvcuda;
    const int w = threadIdx.x / 32;
#pragma unroll
    for (int j = 0; j < N / 16; ++j) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> c;
      wmma::load_matrix_sync(c, C + (16 * w) * ldc + 16 * j, ldc, wmma::mem_row_major);
#pragma unroll
      for (int kk = 0; kk < KC / 16; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b;
        wmma::load_matrix_sync(a, A + (16 * w) * lda + 16 * kk, lda);
        wmma::load_matrix_sync(b, B + (16 * kk) * ldb + 16 * j, ldb);
        wmma::mma_sync(c, a, b, c);
      }
      wmma::store_matrix_sync(C + (16 * w) * ldc + 16 * j, c, ldc, wmma::mem_row_major);
    }
  } else {
    for (int idx = threadIdx.x; idx < M * N; idx += NTHREADS) {
      const int r = idx / N, c = idx % N;
      const float* ar = A + r * lda;
      float acc = 0.f;
#pragma unroll 8
      for (int kk = 0; kk < KC; ++kk) acc = fmaf(ar[kk], B[kk * ldb + c], acc);
      C[r * ldc + c] += acc;
    }
  }
}

// ---------------------------------------------------------------------------
// K2: delta = rowsum(dO * O)
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(DELTA_WARPS * 32)
    flash_delta_kernel(const T* o, const T* dout, float* delta, int B, int Sq, int Hq, int D,
                       long long o_sb, long long o_ss, long long o_sh, long long do_sb,
                       long long do_ss, long long do_sh) {
  const long long row = (long long)blockIdx.x * DELTA_WARPS + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= (long long)B * Sq * Hq) return;  // the whole warp leaves together
  const int h = (int)(row % Hq);
  const long long bs = row / Hq;
  const int s = (int)(bs % Sq);
  const int b = (int)(bs / Sq);
  const T* orow = o + b * o_sb + s * o_ss + h * o_sh;
  const T* drow = dout + b * do_sb + s * do_ss + h * do_sh;
  float acc = 0.f;
  for (int d = lane; d < D; d += 32) acc = fmaf(to_f(orow[d]), to_f(drow[d]), acc);
  acc = repro::warp_sum(acc);
  if (lane == 0) delta[((long long)b * Hq + h) * Sq + s] = acc;
}

// ---------------------------------------------------------------------------
// K3: dQ
// ---------------------------------------------------------------------------

template <typename T, int D>
__global__ void __launch_bounds__(NTHREADS) flash_dq_kernel(const Params p) {
  using L = DqLayout<T, D>;
  constexpr int BQ = L::BQ;
  extern __shared__ __align__(128) unsigned char smem[];
  T* Qs = reinterpret_cast<T*>(smem + L::q_off);
  T* dOs = reinterpret_cast<T*>(smem + L::do_off);
  T* Ks = reinterpret_cast<T*>(smem + L::k_off);
  T* Vs = reinterpret_cast<T*>(smem + L::v_off);
  float* Ss = reinterpret_cast<float*>(smem + L::s_off);
  float* dPs = reinterpret_cast<float*>(smem + L::dp_off);
  T* dSs = reinterpret_cast<T*>(smem + L::ds_off);
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
  const T* qg = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* dog = static_cast<const T*>(p.dout) + b * p.do_sb + h * p.do_sh;
  const T* kg = static_cast<const T*>(p.k) + b * p.k_sb + hk * p.k_sh;
  const T* vg = static_cast<const T*>(p.v) + b * p.v_sb + hk * p.v_sh;
  const long long row0 = ((long long)b * p.Hq + h) * p.Sq;
  const int* segb = has_seg ? p.seg + (long long)b * p.Sq : nullptr;

  load_tile<T, D>(Qs, L::LDT, qg, p.q_ss, q0, nq, BQ);
  load_tile<T, D>(dOs, L::LDT, dog, p.do_ss, q0, nq, BQ);
  for (int i = tid; i < BQ * L::LDO; i += NTHREADS) acc[i] = 0.f;
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
  int k_hi = p.Sk;
  if (p.causal) k_hi = min(k_hi, q0 + nq);
  const int k_lo = p.window > 0 ? max(0, q0 - p.window + 1) : 0;
  const int kt_begin = k_lo / BK, kt_end = (k_hi + BK - 1) / BK;

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k0 = kt * BK;
    const int nk = min(BK, p.Sk - k0);
    __syncthreads();  // the previous tile is done with Ks, Vs, dSs, kseg_s
    load_tile<T, D>(Ks, L::LDT, kg, p.k_ss, k0, nk, BK);
    load_tile<T, D>(Vs, L::LDT, vg, p.v_ss, k0, nk, BK);
    if (has_seg && tid < BK) kseg_s[tid] = tid < nk ? segb[k0 + tid] : 0;
    __syncthreads();
    if (has_seg) {
      const int hit = tid < nk && kseg_s[tid] >= qmin && kseg_s[tid] <= qmax;
      if (!__syncthreads_or(hit)) continue;
    }
    mm_abt<T, BQ, BK, D>(Qs, L::LDT, Ks, L::LDT, Ss, L::LDS);
    mm_abt<T, BQ, BK, D>(dOs, L::LDT, Vs, L::LDT, dPs, L::LDS);
    __syncthreads();
    for (int idx = tid; idx < BQ * BK; idx += NTHREADS) {
      const int r = idx / BK, c = idx % BK;
      float ds = 0.f;  // masked: exactly 0
      if (visible(p, q0 + r, k0 + c, qseg_s[r], kseg_s[c], has_seg)) {
        const float pr = expf(Ss[r * L::LDS + c] * p.scale - lse_s[r]);
        ds = pr * (dPs[r * L::LDS + c] - delta_s[r]);
      }
      dSs[r * L::LDP + c] = from_f<T>(ds);
    }
    __syncthreads();
    mm_acc<T, BQ, BK, D>(dSs, L::LDP, Ks, L::LDT, acc, L::LDO);
  }
  __syncthreads();

  T* dqg = static_cast<T*>(p.dq);
  for (int idx = tid; idx < nq * D; idx += NTHREADS) {
    const int r = idx / D, d = idx % D;
    dqg[(((long long)b * p.Sq + q0 + r) * p.Hq + h) * D + d] = from_f<T>(acc[r * L::LDO + d] * p.scale);
  }
}

// ---------------------------------------------------------------------------
// K4: dK and dV, the GQA group summed inside
// ---------------------------------------------------------------------------

template <typename T, int D>
__global__ void __launch_bounds__(NTHREADS) flash_dkv_kernel(const Params p) {
  using L = DkvLayout<T, D>;
  constexpr int BQ = L::BQ;
  extern __shared__ __align__(128) unsigned char smem[];
  T* Ks = reinterpret_cast<T*>(smem + L::k_off);
  T* Vs = reinterpret_cast<T*>(smem + L::v_off);
  T* Qs = reinterpret_cast<T*>(smem + L::q_off);
  T* dOs = reinterpret_cast<T*>(smem + L::do_off);
  float* Ss = reinterpret_cast<float*>(smem + L::s_off);
  float* dPs = reinterpret_cast<float*>(smem + L::dp_off);
  T* PTs = reinterpret_cast<T*>(smem + L::pt_off);
  T* dSTs = reinterpret_cast<T*>(smem + L::dst_off);
  float* dKs = reinterpret_cast<float*>(smem + L::dk_off);
  float* dVs = reinterpret_cast<float*>(smem + L::dv_off);
  float* lse_s = reinterpret_cast<float*>(smem + L::lse_off);
  float* delta_s = reinterpret_cast<float*>(smem + L::delta_off);
  int* qseg_s = reinterpret_cast<int*>(smem + L::qs_off);
  int* kseg_s = reinterpret_cast<int*>(smem + L::ks_off);

  const int tid = threadIdx.x;
  const int k0 = blockIdx.x * BK, hk = blockIdx.y, b = blockIdx.z;
  const int g = p.Hq / p.Hkv;
  const int nk = min(BK, p.Sk - k0);
  const bool has_seg = p.seg != nullptr;
  const T* kg = static_cast<const T*>(p.k) + b * p.k_sb + hk * p.k_sh;
  const T* vg = static_cast<const T*>(p.v) + b * p.v_sb + hk * p.v_sh;
  const int* segb = has_seg ? p.seg + (long long)b * p.Sq : nullptr;

  load_tile<T, D>(Ks, L::LDT, kg, p.k_ss, k0, nk, BK);
  load_tile<T, D>(Vs, L::LDT, vg, p.v_ss, k0, nk, BK);
  for (int i = tid; i < BK * L::LDO; i += NTHREADS) {
    dKs[i] = 0.f;
    dVs[i] = 0.f;
  }
  if (tid < BK) kseg_s[tid] = (has_seg && tid < nk) ? segb[k0 + tid] : 0;
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
    const T* qg = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
    const T* dog = static_cast<const T*>(p.dout) + b * p.do_sb + h * p.do_sh;
    const long long row0 = ((long long)b * p.Hq + h) * p.Sq;
    for (int qt = qt_begin; qt < qt_end; ++qt) {
      const int q0 = qt * BQ;
      const int nq = min(BQ, p.Sq - q0);
      __syncthreads();  // the previous tile is done with Qs, dOs, PTs, dSTs, lse_s, ...
      load_tile<T, D>(Qs, L::LDT, qg, p.q_ss, q0, nq, BQ);
      load_tile<T, D>(dOs, L::LDT, dog, p.do_ss, q0, nq, BQ);
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
      mm_abt<T, BQ, BK, D>(Qs, L::LDT, Ks, L::LDT, Ss, L::LDS);
      mm_abt<T, BQ, BK, D>(dOs, L::LDT, Vs, L::LDT, dPs, L::LDS);
      __syncthreads();
      for (int idx = tid; idx < BQ * BK; idx += NTHREADS) {
        const int r = idx / BK, c = idx % BK;
        float pr = 0.f, ds = 0.f;  // masked: exactly 0
        if (visible(p, q0 + r, k0 + c, qseg_s[r], kseg_s[c], has_seg)) {
          pr = expf(Ss[r * L::LDS + c] * p.scale - lse_s[r]);
          ds = pr * (dPs[r * L::LDS + c] - delta_s[r]);
        }
        PTs[c * L::LDP + r] = from_f<T>(pr);
        dSTs[c * L::LDP + r] = from_f<T>(ds);
      }
      __syncthreads();
      mm_acc<T, BK, BQ, D>(PTs, L::LDP, dOs, L::LDT, dVs, L::LDO);
      mm_acc<T, BK, BQ, D>(dSTs, L::LDP, Qs, L::LDT, dKs, L::LDO);
    }
  }
  __syncthreads();

  T* dkg = static_cast<T*>(p.dk);
  T* dvg = static_cast<T*>(p.dv);
  for (int idx = tid; idx < nk * D; idx += NTHREADS) {
    const int r = idx / D, d = idx % D;
    const long long off = (((long long)b * p.Sk + k0 + r) * p.Hkv + hk) * D + d;
    dkg[off] = from_f<T>(dKs[r * L::LDO + d] * p.scale);
    dvg[off] = from_f<T>(dVs[r * L::LDO + d]);
  }
}

// ---------------------------------------------------------------------------
// launches
// ---------------------------------------------------------------------------

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

template <typename T, int D>
int launch_dq(const Params& p, cudaStream_t stream) {
  using L = DqLayout<T, D>;
  static_assert(L::bytes <= SMEM_LIMIT, "dQ tiles exceed shared memory");
  static bool attr_set = false;
  if (const int e = set_smem(flash_dq_kernel<T, D>, L::bytes, attr_set)) return e;
  const dim3 grid((p.Sq + L::BQ - 1) / L::BQ, p.Hq, p.B);
  flash_dq_kernel<T, D><<<grid, NTHREADS, L::bytes, stream>>>(p);
  return (int)cudaGetLastError();
}

template <typename T, int D>
int launch_dkv(const Params& p, cudaStream_t stream) {
  using L = DkvLayout<T, D>;
  static_assert(L::bytes <= SMEM_LIMIT, "dK/dV tiles exceed shared memory");
  static bool attr_set = false;
  if (const int e = set_smem(flash_dkv_kernel<T, D>, L::bytes, attr_set)) return e;
  const dim3 grid((p.Sk + BK - 1) / BK, p.Hkv, p.B);
  flash_dkv_kernel<T, D><<<grid, NTHREADS, L::bytes, stream>>>(p);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_dq(int D, const Params& p, cudaStream_t s) {
  switch (D) {
    case 16: return launch_dq<T, 16>(p, s);
    case 64: return launch_dq<T, 64>(p, s);
    case 96: return launch_dq<T, 96>(p, s);
    case 128: return launch_dq<T, 128>(p, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <typename T>
int dispatch_dkv(int D, const Params& p, cudaStream_t s) {
  switch (D) {
    case 16: return launch_dkv<T, 16>(p, s);
    case 64: return launch_dkv<T, 64>(p, s);
    case 96: return launch_dkv<T, 96>(p, s);
    case 128: return launch_dkv<T, 128>(p, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

Params make_params(const void* q, const void* k, const void* v, const void* dout,
                   const void* lse, const void* delta, const void* seg, void* dq, void* dk,
                   void* dv, int B, int Sq, int Sk, int Hq, int Hkv, const long long* st,
                   int causal, int window, float scale) {
  return Params{q, k, v, dout,
                static_cast<const float*>(lse), static_cast<const float*>(delta),
                static_cast<const int*>(seg), dq, dk, dv,
                B, Sq, Sk, Hq, Hkv,
                st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], st[9], st[10], st[11],
                causal, window, scale};
}

}  // namespace

extern "C" int repro_flash_delta(const void* o, const void* dout, void* delta, int dtype, int B,
                                 int Sq, int Hq, int D, long long o_sb, long long o_ss,
                                 long long o_sh, long long do_sb, long long do_ss,
                                 long long do_sh, void* stream) {
  const long long rows = (long long)B * Sq * Hq;
  const unsigned blocks = (unsigned)((rows + DELTA_WARPS - 1) / DELTA_WARPS);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* out = static_cast<float*>(delta);
  if (dtype == repro::DTYPE_F32) {
    flash_delta_kernel<float><<<blocks, DELTA_WARPS * 32, 0, s>>>(
        static_cast<const float*>(o), static_cast<const float*>(dout), out, B, Sq, Hq, D,
        o_sb, o_ss, o_sh, do_sb, do_ss, do_sh);
  } else if (dtype == repro::DTYPE_BF16) {
    flash_delta_kernel<bf16><<<blocks, DELTA_WARPS * 32, 0, s>>>(
        static_cast<const bf16*>(o), static_cast<const bf16*>(dout), out, B, Sq, Hq, D,
        o_sb, o_ss, o_sh, do_sb, do_ss, do_sh);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// strides: q (b, s, h), k (b, s, h), v (b, s, h), dO (b, s, h), in elements
extern "C" int repro_flash_dq(const void* q, const void* k, const void* v, const void* dout,
                              const void* lse, const void* delta, const void* seg, void* dq,
                              int dtype, int B, int Sq, int Sk, int Hq, int Hkv, int D,
                              const long long* strides, int causal, int window, float scale,
                              void* stream) {
  if (Hkv <= 0 || Hq % Hkv != 0) return (int)cudaErrorInvalidValue;
  const Params p = make_params(q, k, v, dout, lse, delta, seg, dq, nullptr, nullptr, B, Sq, Sk,
                               Hq, Hkv, strides, causal, window, scale);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == repro::DTYPE_F32) return dispatch_dq<float>(D, p, s);
  if (dtype == repro::DTYPE_BF16) return dispatch_dq<bf16>(D, p, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" int repro_flash_dkv(const void* q, const void* k, const void* v, const void* dout,
                               const void* lse, const void* delta, const void* seg, void* dk,
                               void* dv, int dtype, int B, int Sq, int Sk, int Hq, int Hkv,
                               int D, const long long* strides, int causal, int window,
                               float scale, void* stream) {
  if (Hkv <= 0 || Hq % Hkv != 0) return (int)cudaErrorInvalidValue;
  const Params p = make_params(q, k, v, dout, lse, delta, seg, nullptr, dk, dv, B, Sq, Sk, Hq,
                               Hkv, strides, causal, window, scale);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == repro::DTYPE_F32) return dispatch_dkv<float>(D, p, s);
  if (dtype == repro::DTYPE_BF16) return dispatch_dkv<bf16>(D, p, s);
  return (int)cudaErrorInvalidValue;
}
