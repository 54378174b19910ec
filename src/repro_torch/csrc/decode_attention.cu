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
// What the design does about it: flash-decoding (decode_attention.cuh, the
// body shared with K6).  The keys are split into the wrapper's split_len
// chunks, so (split, KV head, batch row) blocks fill the 132 SMs even at a
// small B * Hkv; each block copies its K/V rows into shared memory with
// cp.async, the next chunk's in flight while one is used, and each warp
// owns query heads of the group, so its softmax and P V need no exchange
// with other warps; a second small kernel combines the splits in order.  The g = Hq/Hkv query heads of
// a group share every K/V row loaded (the TPU kernel's grid is per query
// head and reads each row g times).  The query position is a plain int `t`
// for every row, or a device int32 (B,) `ts` of one per row (the
// continuous-batching slot step: no host scalar, no loop over slots).  Any S
// works (the chunk tail is masked).  ws is the wrapper's f32 workspace of
// B*Hq*n_splits*(D + 2) floats.

#include "decode_attention.cuh"

extern "C" int repro_decode_attention(const void* q, const void* k, const void* v,
                                      const void* kpos, const void* ts, void* o, void* ws,
                                      int dtype, int B, int S, int Hq, int Hkv, int D, int t,
                                      int window, int split_len, int n_splits, float scale,
                                      void* stream) {
  repro::decode::Params p{};
  p.q = q;
  p.k = k;
  p.v = v;
  p.kpos = static_cast<const int*>(kpos);
  p.ts = static_cast<const int*>(ts);
  p.o = o;
  p.ws = static_cast<float*>(ws);
  p.B = B;
  p.S = S;
  p.Hq = Hq;
  p.Hkv = Hkv;
  p.t = t;
  p.window = window;
  p.split_len = split_len;
  p.n_splits = n_splits;
  p.scale = scale;
  return repro::decode::dispatch<false>(dtype, D, p, static_cast<cudaStream_t>(stream));
}
