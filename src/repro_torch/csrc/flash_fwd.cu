// K1: flash-attention forward for Hopper (sm_90a).
//
// Replaces the Pallas kernel repro/kernels/flash_attention.py:_fwd_kernel
// (launched by _forward).  Same function: online-softmax attention with the
// causal, sliding-window and segment-id masks, GQA through h / g, output O and
// lse = m + log(max(l, 1e-30)) per row in f32.
//
// What bounds it on this card: tensor-core operations, 4*B*Hq*Sq*Sk*D
// (about halved when causal) against 989 TFLOP/s in bf16; the bytes
// (q, k, v and O once each) are ~D/Sk as many.
//
// What the design does about it: one block of 4 warps per (64-row q tile,
// query head, batch row); Q stays in shared memory; K/V tiles of 64 rows are
// staged through shared memory and the tile loop is bounded the way
// _block_relevant bounds it (causal upper bound, window lower bound, and a
// segment-id test that skips tiles with no id of the q tile).  In bf16 both
// products (S = Q K^T and O += P V) run on the tensor cores through WMMA with
// f32 accumulation; in f32 they are FMA loops, which keeps f32 parity tight.
// The online softmax runs in f32, two threads per row.  Masked scores are
// -1e30 and masked probabilities are zeroed explicitly, so a fully masked row
// gives O = 0 and lse = -1e30 + log(1e-30), as the reference does.  q/k/v are
// read straight from the (B, S, H, D) layout through the strides passed in;
// ragged Sq/Sk tails are zero-filled and masked.  A simple first kernel:
// no wgmma, TMA or warp specialisation yet.

#include <mma.h>
#include <stdint.h>

#include <climits>
#include <type_traits>

#include "common.cuh"

namespace {

using repro::NEG_INF;
using repro::from_f;
using repro::to_f;
using bf16 = __nv_bfloat16;

constexpr int BQ = 64;
constexpr int BK = 64;
constexpr int NTHREADS = 128;  // 4 warps; warp w owns S/O rows [16w, 16w + 16)

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const int* seg;  // (B, S) or nullptr
  void* o;         // (B, Sq, Hq, D) contiguous
  float* lse;      // (B, Hq, Sq)
  int B, Sq, Sk, Hq, Hkv;
  long long q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh;
  int causal, window;  // window <= 0: none
  float scale;
};

constexpr size_t align128(size_t x) { return (x + 127) / 128 * 128; }

template <typename T, int D>
struct Layout {
  // f32 rows get an odd pitch (no bank conflicts in the FMA loops); bf16 rows
  // a pitch that keeps every 16-row WMMA fragment 32-byte aligned
  static constexpr int PAD = std::is_same<T, float>::value ? 1 : 8;
  static constexpr int LDT = D + PAD;   // Q, K, V rows
  static constexpr int LDP = BK + PAD;  // P rows
  static constexpr int LDS = BK + 4;    // S rows (f32)
  static constexpr int LDO = D + 4;     // O accumulator rows (f32)
  static constexpr size_t q_off = 0;
  static constexpr size_t k_off = align128(q_off + sizeof(T) * BQ * LDT);
  static constexpr size_t v_off = align128(k_off + sizeof(T) * BK * LDT);
  static constexpr size_t p_off = align128(v_off + sizeof(T) * BK * LDT);
  static constexpr size_t s_off = align128(p_off + sizeof(T) * BQ * LDP);
  static constexpr size_t o_off = align128(s_off + sizeof(float) * BQ * LDS);
  static constexpr size_t m_off = align128(o_off + sizeof(float) * BQ * LDO);
  static constexpr size_t l_off = m_off + sizeof(float) * BQ;
  static constexpr size_t qs_off = l_off + sizeof(float) * BQ;
  static constexpr size_t ks_off = qs_off + sizeof(int) * BQ;
  static constexpr size_t bytes = ks_off + sizeof(int) * BK;
};

// rows [row0, row0 + rows) of one head into shared memory; rows past `avail`
// are zero (a zero V row times a zeroed probability stays 0)
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

// S = Q K^T (unscaled), BQ x BK, f32
template <typename T, int D>
__device__ __forceinline__ void scores(const T* Qs, const T* Ks, float* Ss) {
  using L = Layout<T, D>;
  if constexpr (std::is_same<T, bf16>::value) {
    using namespace nvcuda;
    const int w = threadIdx.x / 32;
#pragma unroll
    for (int j = 0; j < BK / 16; ++j) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> c;
      wmma::fill_fragment(c, 0.f);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
        // K stored row-major (key, dim) is K^T in column-major
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> b;
        wmma::load_matrix_sync(a, Qs + (16 * w) * L::LDT + 16 * kk, L::LDT);
        wmma::load_matrix_sync(b, Ks + (16 * j) * L::LDT + 16 * kk, L::LDT);
        wmma::mma_sync(c, a, b, c);
      }
      wmma::store_matrix_sync(Ss + (16 * w) * L::LDS + 16 * j, c, L::LDS, wmma::mem_row_major);
    }
  } else {
    for (int idx = threadIdx.x; idx < BQ * BK; idx += NTHREADS) {
      const int r = idx / BK, c = idx % BK;
      const float* qr = Qs + r * L::LDT;
      const float* kr = Ks + c * L::LDT;
      float acc = 0.f;
#pragma unroll 8
      for (int d = 0; d < D; ++d) acc = fmaf(qr[d], kr[d], acc);
      Ss[r * L::LDS + c] = acc;
    }
  }
}

// O += P V, BQ x D, f32 accumulator in shared memory
template <typename T, int D>
__device__ __forceinline__ void accumulate_pv(const T* Ps, const T* Vs, float* Os) {
  using L = Layout<T, D>;
  if constexpr (std::is_same<T, bf16>::value) {
    using namespace nvcuda;
    const int w = threadIdx.x / 32;
#pragma unroll
    for (int j = 0; j < D / 16; ++j) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> c;
      wmma::load_matrix_sync(c, Os + (16 * w) * L::LDO + 16 * j, L::LDO, wmma::mem_row_major);
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b;
        wmma::load_matrix_sync(a, Ps + (16 * w) * L::LDP + 16 * kk, L::LDP);
        wmma::load_matrix_sync(b, Vs + (16 * kk) * L::LDT + 16 * j, L::LDT);
        wmma::mma_sync(c, a, b, c);
      }
      wmma::store_matrix_sync(Os + (16 * w) * L::LDO + 16 * j, c, L::LDO, wmma::mem_row_major);
    }
  } else {
    for (int idx = threadIdx.x; idx < BQ * D; idx += NTHREADS) {
      const int r = idx / D, d = idx % D;
      const float* pr = Ps + r * L::LDP;
      float acc = 0.f;
#pragma unroll 8
      for (int c = 0; c < BK; ++c) acc = fmaf(pr[c], Vs[c * L::LDT + d], acc);
      Os[r * L::LDO + d] += acc;
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(NTHREADS) flash_fwd_kernel(const Params p) {
  using L = Layout<T, D>;
  extern __shared__ __align__(128) unsigned char smem[];
  T* Qs = reinterpret_cast<T*>(smem + L::q_off);
  T* Ks = reinterpret_cast<T*>(smem + L::k_off);
  T* Vs = reinterpret_cast<T*>(smem + L::v_off);
  T* Ps = reinterpret_cast<T*>(smem + L::p_off);
  float* Ss = reinterpret_cast<float*>(smem + L::s_off);
  float* Os = reinterpret_cast<float*>(smem + L::o_off);
  float* m_s = reinterpret_cast<float*>(smem + L::m_off);
  float* l_s = reinterpret_cast<float*>(smem + L::l_off);
  int* qseg_s = reinterpret_cast<int*>(smem + L::qs_off);
  int* kseg_s = reinterpret_cast<int*>(smem + L::ks_off);

  const int tid = threadIdx.x;
  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (p.Hq / p.Hkv);
  const int nq = min(BQ, p.Sq - q0);
  const bool has_seg = p.seg != nullptr;
  const T* qg = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* kg = static_cast<const T*>(p.k) + b * p.k_sb + hk * p.k_sh;
  const T* vg = static_cast<const T*>(p.v) + b * p.v_sb + hk * p.v_sh;
  const int* segb = has_seg ? p.seg + (long long)b * p.Sq : nullptr;

  load_tile<T, D>(Qs, L::LDT, qg, p.q_ss, q0, nq, BQ);
  for (int i = tid; i < BQ * L::LDO; i += NTHREADS) Os[i] = 0.f;
  if (tid < BQ) {
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
  // the tiles _block_relevant keeps: keys up to the tile's last row when
  // causal, from the first row's window start when windowed
  int k_hi = p.Sk;
  if (p.causal) k_hi = min(k_hi, q0 + nq);
  const int k_lo = p.window > 0 ? max(0, q0 - p.window + 1) : 0;
  const int kt_begin = k_lo / BK, kt_end = (k_hi + BK - 1) / BK;

  const int r = tid >> 1, half = tid & 1;  // softmax: two threads per row
  const int qpos = q0 + r;

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k0 = kt * BK;
    const int nk = min(BK, p.Sk - k0);
    __syncthreads();  // the previous tile is done with Ks, Vs, Ps, kseg_s
    load_tile<T, D>(Ks, L::LDT, kg, p.k_ss, k0, nk, BK);
    load_tile<T, D>(Vs, L::LDT, vg, p.v_ss, k0, nk, BK);
    if (has_seg && tid < BK) kseg_s[tid] = tid < nk ? segb[k0 + tid] : 0;
    __syncthreads();
    if (has_seg) {
      // conservative: a (q, k) pair with equal ids needs kseg in [qmin, qmax]
      const int hit = tid < nk && kseg_s[tid] >= qmin && kseg_s[tid] <= qmax;
      if (!__syncthreads_or(hit)) continue;
    }
    scores<T, D>(Qs, Ks, Ss);
    __syncthreads();

    const float m_prev = m_s[r], l_prev = l_s[r];
    const int qs = qseg_s[r];
    float* srow = Ss + r * L::LDS + half * 32;
    float mx = NEG_INF;
#pragma unroll 4
    for (int j = 0; j < 32; ++j) {
      const int c = half * 32 + j;
      const bool ok = visible(p, qpos, k0 + c, qs, kseg_s[c], has_seg);
      const float s = ok ? srow[j] * p.scale : NEG_INF;
      srow[j] = s;
      mx = fmaxf(mx, s);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    const float m_cur = fmaxf(m_prev, mx);
    const float alpha = expf(m_prev - m_cur);
    T* prow = Ps + r * L::LDP + half * 32;
    float sum = 0.f;
#pragma unroll 4
    for (int j = 0; j < 32; ++j) {
      const int c = half * 32 + j;
      const bool ok = visible(p, qpos, k0 + c, qs, kseg_s[c], has_seg);
      const float pj = ok ? expf(srow[j] - m_cur) : 0.f;  // masked: exactly 0
      prow[j] = from_f<T>(pj);
      sum += pj;
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    float* orow = Os + r * L::LDO + half * (D / 2);
    for (int d = 0; d < D / 2; ++d) orow[d] *= alpha;
    if (half == 0) {
      m_s[r] = m_cur;
      l_s[r] = l_prev * alpha + sum;
    }
    __syncthreads();
    accumulate_pv<T, D>(Ps, Vs, Os);
  }
  __syncthreads();

  if (qpos < p.Sq) {
    const float l = fmaxf(l_s[r], 1e-30f);
    T* og = static_cast<T*>(p.o) + (((long long)b * p.Sq + qpos) * p.Hq + h) * D + half * (D / 2);
    const float* orow = Os + r * L::LDO + half * (D / 2);
    for (int d = 0; d < D / 2; ++d) og[d] = from_f<T>(orow[d] / l);
    if (half == 0) p.lse[((long long)b * p.Hq + h) * p.Sq + qpos] = m_s[r] + logf(l);
  }
}

template <typename T, int D>
int launch(const Params& p, cudaStream_t stream) {
  using L = Layout<T, D>;
  static bool attr_set = false;  // per instantiation: above 48 KB needs opting in
  if (!attr_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L::bytes);
    if (e != cudaSuccess) return (int)e;
    attr_set = true;
  }
  const dim3 grid((p.Sq + BQ - 1) / BQ, p.Hq, p.B);
  flash_fwd_kernel<T, D><<<grid, NTHREADS, L::bytes, stream>>>(p);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(int D, const Params& p, cudaStream_t s) {
  switch (D) {
    case 16: return launch<T, 16>(p, s);
    case 64: return launch<T, 64>(p, s);
    case 96: return launch<T, 96>(p, s);
    case 128: return launch<T, 128>(p, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" int repro_flash_fwd(const void* q, const void* k, const void* v, const void* seg,
                               void* o, void* lse, int dtype, int B, int Sq, int Sk, int Hq,
                               int Hkv, int D, long long q_sb, long long q_ss, long long q_sh,
                               long long k_sb, long long k_ss, long long k_sh, long long v_sb,
                               long long v_ss, long long v_sh, int causal, int window,
                               float scale, void* stream) {
  if (Hkv <= 0 || Hq % Hkv != 0) return (int)cudaErrorInvalidValue;
  const Params p{q, k, v, static_cast<const int*>(seg), o, static_cast<float*>(lse),
                 B, Sq, Sk, Hq, Hkv, q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh,
                 causal, window, scale};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == repro::DTYPE_F32) return dispatch<float>(D, p, s);
  if (dtype == repro::DTYPE_BF16) return dispatch<bf16>(D, p, s);
  return (int)cudaErrorInvalidValue;
}
