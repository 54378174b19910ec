// K6: single-token decode attention through a block-paged KV pool, for
// Hopper (sm_90a).
//
// Replaces the Pallas kernel
// repro/kernels/decode_attention.py:_paged_decode_kernel (launched by
// paged_decode_attention).  Same function: K5's attention, but logical page
// ik of row b is physical page page_table[b, ik] of the shared pool
// k/v (n_pages, ps, Hkv, D); token j of logical page ik sits at position
// ik*ps + j; a key is valid where its page is mapped (>= 0) and its position
// is <= ts[b] (&& > ts[b] - window).  ts and page_table are device int32
// tensors: no host scalar, no sync in the decode step.
//
// What bounds it on this card: the bytes of the K and V rows the queries
// can see, 2*Hkv*D*sizeof(T) per valid key, against 3.35 TB/s.
//
// What the design does about it: the body is K5's (decode_attention.cuh):
// the logical keys [0, n_max*ps) split at the same absolute boundaries as a
// ring of that length, (split, KV head, batch row) blocks, the g query heads
// of a group sharing each K/V row, chunks of 32 logical keys (whole or
// parts of pages; any page size works).  Each lane reads its key's physical
// page from the table, and the warp gathers the valid rows into shared
// memory with 16-byte cp.async.  Splits and chunks are bounded to the keys
// [ts - window + 1, ts]: those wholly past ts or before the window read
// nothing, and keys on an unmapped page are never copied, so the trash page
// 0 (where inactive rows scatter their writes) is never read.  Skipping a
// wholly masked key is exact: the reference adds p = 0 for it and leaves m
// unchanged.  Gathering whole pages with TMA is a later step.

#include "decode_attention.cuh"

extern "C" int repro_paged_decode_attention(const void* q, const void* k_pool,
                                            const void* v_pool, const void* page_table,
                                            const void* ts, void* o, void* ws, int dtype,
                                            int B, int n_max, int ps, int Hq, int Hkv, int D,
                                            int window, int split_len, int n_splits,
                                            float scale, void* stream) {
  if (ps <= 0 || n_max <= 0 || ts == nullptr) return (int)cudaErrorInvalidValue;
  repro::decode::Params p{};
  p.q = q;
  p.k = k_pool;
  p.v = v_pool;
  p.page_table = static_cast<const int*>(page_table);
  p.ts = static_cast<const int*>(ts);
  p.o = o;
  p.ws = static_cast<float*>(ws);
  p.B = B;
  p.S = n_max * ps;
  p.Hq = Hq;
  p.Hkv = Hkv;
  p.window = window;
  p.ps = ps;
  p.n_max = n_max;
  p.split_len = split_len;
  p.n_splits = n_splits;
  p.scale = scale;
  return repro::decode::dispatch<true>(dtype, D, p, static_cast<cudaStream_t>(stream));
}
