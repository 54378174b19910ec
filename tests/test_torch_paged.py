"""The port's block-paged KV serving against the JAX reference, on the CPU.

K6's plain version is held against the reference's Pallas kernel
``_paged_decode_kernel`` in interpret mode (2e-5 in f32, 2e-2 in bf16) over
page sizes, head groupings, windows, unmapped pages, permuted physical
pages and a position per row; K5's per-row form against the reference's
vmapped single-row decode.  ``kvpool`` is driven through the same
operations as the reference's objects.  The paged scheduler, on bridged
weights, must give the reference's greedy tokens and ``ServingStats``
under one fake clock, on its default path and with its Pallas kernels
forced.  Traps (d), (e) and (g) of the port's serving slice each have a
test here.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import store
from repro.kernels import ref as jref
from repro.kernels.decode_attention import paged_decode_attention as pallas_paged
from repro.models import transformer as jtf
from repro.runtime import flags
from repro.session import kvpool as jkv
from repro.session.infer import InferenceSession as RefSession
from repro.session.scheduler import ContinuousBatchingScheduler as RefScheduler
from repro.session.scheduler import RequestQueue as RefQueue
from repro_torch.checkpoint.bridge import params_from_numpy
from repro_torch.configs import get_config
from repro_torch.kernels import build, ops, ref
from repro_torch.kernels import decode_attention as da
from repro_torch.models import api as model_api
from repro_torch.models import transformer as ttf
from repro_torch.session import (ContinuousBatchingScheduler, InferenceSession,
                                 RequestQueue, kvpool)

ARCHS = ["granite_3_2b", "gpt_20b"]
TOL = {"float32": 2e-5, "bfloat16": 2e-2}
CHAT_GENS = [40, 6, 6, 8, 6, 10, 6, 8, 6, 6, 8, 6]
_REF = {}


def _pair(arch, path="default"):
    """(reference session, port session on the CPU with its weights); one
    reference session per (arch, path) for the module, the "pallas" one
    called only under its flags (they are read at trace time)."""
    if (arch, path) not in _REF:
        _REF[arch, path] = RefSession.from_recipe(arch, reduced=True, seed=0)
    ref_sess = _REF[arch, path]
    flat = {k: np.asarray(v) for k, v in store._flatten(ref_sess.params)}
    return ref_sess, InferenceSession.from_params(get_config(arch).reduced(),
                                                  params_from_numpy(flat), device="cpu")


class FakeClock:
    def __init__(self):
        self.n = 0

    def __call__(self):
        self.n += 1
        return float(self.n)


def chat_stream(vocab, seed=0):
    """``benchmarks/run.py``'s chat-shaped workload: a 48-token shared system
    prompt, suffixes of 4-10 tokens, gens ``CHAT_GENS``."""
    rs = np.random.RandomState(seed)
    sysp = rs.randint(1, vocab, size=48).astype(np.int32)
    prompts = [np.concatenate([sysp, rs.randint(1, vocab, size=4 + 2 * (i % 4))
                               .astype(np.int32)]) for i in range(len(CHAT_GENS))]
    return prompts, list(CHAT_GENS)


def drive(scheduler, queue_cls, prompts, gens, *, stop_token=None):
    """Serve through ``scheduler`` under a fresh fake clock → (outputs in
    submit order, stats as a dict)."""
    clock = FakeClock()
    queue = queue_cls(clock=clock)
    rids = [queue.submit(p, m, stop_token=stop_token) for p, m in zip(prompts, gens)]
    outputs, stats = scheduler.run(queue, clock=clock)
    return [outputs[r] for r in rids], dataclasses.asdict(stats)


def assert_same_serving(want, got):
    (wo, ws), (go, gs) = want, got
    assert len(wo) == len(go)
    for i, (a, b) in enumerate(zip(wo, go)):
        np.testing.assert_array_equal(b, a, err_msg=f"request {i}")
    assert gs == ws


def both_schedulers(ref_sess, port, **kw):
    return (RefScheduler(ref_sess, paged=True, **kw),
            ContinuousBatchingScheduler(port, paged=True, **kw))


def close(got, want, tol):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


# ---------------------------------------------------------------------------
# K6 and K5's per-row form
# ---------------------------------------------------------------------------

def _pool_case(ps, n_max, g, *, D=16, Hkv=2, seed=0):
    """Four rows over one pool of shuffled physical pages: row 0 mid-page,
    row 1 on a page boundary, rows 2 and 3 at the table's last position,
    row 3 with an unmapped hole at logical page 1.  The trash page holds
    finite noise, as inactive rows leave it."""
    rs = np.random.RandomState(seed)
    ts = np.array([5, 2 * ps, n_max * ps - 1, n_max * ps - 1], np.int32)
    B, n_pages = len(ts), 1 + len(ts) * n_max
    q = rs.standard_normal((B, 1, Hkv * g, D)).astype(np.float32)
    kp, vp = (rs.standard_normal((n_pages, ps, Hkv, D)).astype(np.float32) for _ in range(2))
    phys = rs.permutation(np.arange(1, n_pages)).astype(np.int32)
    pt = np.full((B, n_max), -1, np.int32)
    for b, t in enumerate(ts):
        n = t // ps + 1
        pt[b, :n] = phys[b * n_max:b * n_max + n]
    pt[3, 1] = -1
    return q, kp, vp, pt, ts


def _as(dtype, *arrs):
    """The same numpy arrays as torch tensors and jax arrays; float arrays
    in ``dtype``."""
    def t(a):
        x = torch.from_numpy(a)
        return x.to(getattr(torch, dtype)) if a.dtype == np.float32 else x

    def j(a):
        return jnp.asarray(a, jnp.dtype(dtype)) if a.dtype == np.float32 else jnp.asarray(a)

    return [t(a) for a in arrs], [j(a) for a in arrs]


# every pair of (page size, group, window) values, in each dtype
@pytest.mark.parametrize("dtype,ps,g,window", [
    ("float32", 16, 1, None), ("float32", 16, 4, 8), ("float32", 128, 1, 8),
    ("float32", 128, 4, None), ("bfloat16", 16, 1, 8), ("bfloat16", 16, 4, None),
    ("bfloat16", 128, 1, None), ("bfloat16", 128, 4, 8)])
def test_paged_plain_matches_pallas_kernel(dtype, ps, g, window):
    n_max = 4 if ps == 16 else 3
    (q, kp, vp, pt, ts), (jq, jkp, jvp, jpt, jts) = _as(dtype, *_pool_case(ps, n_max, g))
    o = da.paged_decode_attention_plain(q, kp, vp, pt, ts=ts, window=window)
    jo = pallas_paged(jq, jkp, jvp, jpt, ts=jts, window=window, interpret=True)
    assert o.dtype == q.dtype and o.shape == q.shape
    close(o, jo, TOL[dtype])
    # the port's oracle agrees with the reference's oracle as well
    close(ref.paged_decode_attention_reference(q, kp, vp, pt, ts=ts, window=window),
          jref.paged_decode_attention_reference(jq, jkp, jvp, jpt, ts=jts, window=window),
          TOL[dtype])


@pytest.mark.parametrize("window", [None, 40])
def test_paged_plain_equals_contiguous_plain_bitwise(window):
    """K6's plain version over a pool equals K5's plain version over the
    same K/V laid out contiguously (kpos = position, -1 on unmapped pages),
    row by row, bit for bit; a row with no mapped page gives 0."""
    q, kp, vp, pt, ts = (torch.from_numpy(a) for a in _pool_case(16, 4, 4))
    pt[0] = -1                                   # row 0: nothing mapped
    o = da.paged_decode_attention_plain(q, kp, vp, pt, ts=ts, window=window)
    assert (o[0] == 0).all()
    for b in range(4):
        kc, vc, kpos = (torch.zeros((1, 64, 2, 16)), torch.zeros((1, 64, 2, 16)),
                        torch.full((1, 64), -1, dtype=torch.int32))
        for i in range(4):
            if pt[b, i] >= 0:
                kc[0, 16 * i:16 * i + 16] = kp[pt[b, i]]
                vc[0, 16 * i:16 * i + 16] = vp[pt[b, i]]
                kpos[0, 16 * i:16 * i + 16] = torch.arange(16 * i, 16 * i + 16)
        oc = da.decode_attention_plain(q[b:b + 1], kc, vc, kpos, t=int(ts[b]), window=window)
        assert torch.equal(o[b:b + 1], oc)


@pytest.mark.parametrize("window", [None, 8])
@pytest.mark.parametrize("g", [1, 4])
def test_decode_per_row_positions_match_vmapped_reference(g, window):
    """K5's per-row form (``t`` a (B,) tensor) against the reference's
    single-row decode vmapped over rows, on ring caches that hold each row's
    own history (one has wrapped); and, in f32, to one call per row at its
    int position (to summation order: a batched einsum may block its sums
    differently)."""
    rs = np.random.RandomState(1)
    B, S, Hkv, D = 4, 40, 2, 16
    ts = np.array([3, 39, 57, 20], np.int32)
    q = rs.standard_normal((B, 1, Hkv * g, D)).astype(np.float32)
    k, v = (rs.standard_normal((B, S, Hkv, D)).astype(np.float32) for _ in range(2))
    kpos = np.full((B, S), -1, np.int32)
    for b, t in enumerate(ts):
        for p in range(max(0, t - S + 1), t + 1):
            kpos[b, p % S] = p
    for dtype in ("float32", "bfloat16"):
        (tq, tk, tv, tkp, tts), (jq, jk, jv, jkp, jts) = _as(dtype, q, k, v, kpos, ts)
        got = da.decode_attention_plain(tq, tk, tv, tkp, t=tts, window=window)
        want = jax.vmap(lambda q1, k1, v1, p1, t1: jref.decode_attention_reference(
            q1[None], k1[None], v1[None], p1[None], t=t1, window=window)[0])(jq, jk, jv, jkp, jts)
        close(got, want, TOL[dtype])
        for b in range(B if dtype == "float32" else 0):
            one = da.decode_attention_plain(tq[b:b + 1], tk[b:b + 1], tv[b:b + 1],
                                            tkp[b:b + 1], t=int(ts[b]), window=window)
            close(got[b:b + 1], one.numpy(), 1e-6)
        close(ref.decode_attention_reference(tq, tk, tv, tkp, t=tts, window=window), want,
              TOL[dtype])


def test_paged_dispatch_and_wrapper_checks():
    """On CPU tensors the dispatch takes the plain version and counts no
    launch; the kernel wrappers refuse CPU tensors and bad inputs, as K5's
    do."""
    q, kp, vp, pt, ts = (torch.from_numpy(a) for a in _pool_case(16, 4, 4))
    build.launch_counts.clear()
    assert torch.equal(ops.paged_decode_attention(q, kp, vp, pt, ts=ts),
                       da.paged_decode_attention_plain(q, kp, vp, pt, ts=ts))
    k, v = torch.zeros((4, 8, 2, 16)), torch.zeros((4, 8, 2, 16))
    assert torch.equal(ops.decode_attention(q, k, v, torch.zeros((4, 8), dtype=torch.int32),
                                            t=ts),
                       da.decode_attention_plain(q, k, v, torch.zeros((4, 8), dtype=torch.int32),
                                                 t=ts))
    with pytest.raises(ValueError, match="CUDA"):
        da.paged_decode_attention(q, kp, vp, pt, ts=ts)
    with pytest.raises(ValueError, match="CUDA"):
        da.decode_attention(q, k, v, torch.zeros((4, 8), dtype=torch.int32), t=ts)
    with pytest.raises(ValueError, match="page_table"):
        da.paged_decode_attention(q, kp, vp, pt[:2], ts=ts)
    with pytest.raises(ValueError, match="Hq"):
        da.paged_decode_attention(q[:, :, :3], kp, vp, pt, ts=ts)
    with pytest.raises(ValueError, match="pool"):
        da.paged_decode_attention(q, kp[..., :8], vp, pt, ts=ts)
    assert sum(build.launch_counts.values()) == 0


# ---------------------------------------------------------------------------
# kvpool: the reference's objects and the port's, through the same operations
# ---------------------------------------------------------------------------

def _kv_state(mgr, copies):
    pool, cache = mgr.pool, mgr.cache
    return (mgr.tables.tolist(), mgr.n_mapped.tolist(), pool._rc.tolist(), list(pool._free),
            list(cache._pages.items()), sorted(cache._tails.items()),
            (cache.lookups, cache.hits, cache.hit_tokens), list(copies))


def test_kvpool_matches_reference_objects():
    """Admission with prefix sharing (full pages and a partial tail), COW at
    admission and at the first decode write, growth by a page, retire, and
    LRU eviction under pool pressure: every table, refcount, free list,
    cache entry and counter equals the reference's after every operation."""
    rs = np.random.RandomState(2)
    sysp = rs.randint(1, 256, size=21).astype(np.int32)
    prompts = [np.concatenate([sysp, rs.randint(1, 256, size=n).astype(np.int32)])
               for n in (3, 11, 0, 6)] + [rs.randint(1, 256, size=9).astype(np.int32)]
    mgrs = []
    for mod in (jkv, kvpool):
        copies = []
        pool = mod.PagePool(14, 8)
        mgrs.append((mod.PagedKVManager(pool, 3, 6, prefix_cache=mod.PrefixCache(pool),
                                        copy_page=lambda s, d, c=copies: c.append((s, d))),
                     copies))

    def both(op):
        outs = [op(mgr) for mgr, _ in mgrs]
        assert outs[0] == outs[1]
        assert _kv_state(*mgrs[0]) == _kv_state(*mgrs[1])

    def serve(slot, prompt, grow):
        both(lambda m: m.admit(slot, prompt))
        both(lambda m: m.register(slot, prompt))
        for pos in range(len(prompt), len(prompt) + grow):
            both(lambda m: m.ensure_writable(slot, pos))

    serve(0, prompts[0], 5)           # publishes the system prompt's pages and tail
    serve(1, prompts[1], 3)           # shares 2 full pages + a partial tail: COW
    both(lambda m: m.free_slot(0))
    serve(2, prompts[2], 2)           # the whole prompt cached: limit len - 1
    serve(0, prompts[3], 9)
    both(lambda m: m.free_slot(1))
    both(lambda m: m.free_slot(2))
    serve(1, prompts[4], 12)          # no hit; growth under pressure evicts (LRU)
    both(lambda m: m.cache.evict(100))
    assert mgrs[1][0].cache.hits >= 3 and len(mgrs[1][1]) >= 2


def test_trap_e_prefix_hashing_and_hits():
    """(e) ``page_hashes`` is chained over the same seed, byte for byte; on
    the chat stream the port's prefix hits, shared tokens and hit rate
    equal the reference's (and BENCH_serving.json's 0.5818)."""
    assert kvpool.TRASH_PAGE == jkv.TRASH_PAGE == 0
    assert kvpool._HASH_SEED == jkv._HASH_SEED
    rs = np.random.RandomState(3)
    for n, ps in ((40, 16), (33, 8), (15, 16)):
        p = rs.randint(0, 2 ** 31 - 1, size=n).astype(np.int32)
        assert kvpool.page_hashes(p, ps) == jkv.page_hashes(p, ps)
    ref_sess, port = _pair("granite_3_2b")
    prompts, gens = chat_stream(256)
    rs_, ps_ = both_schedulers(ref_sess, port, n_slots=4, max_len=98, page_size=16)
    want = drive(rs_, RefQueue, prompts, gens)
    got = drive(ps_, RequestQueue, prompts, gens)
    assert_same_serving(want, got)
    assert ps_._paged()[0].cache.hits == rs_._paged()[0].cache.hits == got[1]["prefix_hits"]
    assert got[1]["prefix_hits"] == 8 and round(got[1]["prefix_hit_rate"], 4) == 0.5818
    assert round(got[1]["stranded_fraction"], 4) == 0.0988 and got[1]["prefill_tokens"] == 276
    assert round(got[1]["pool_occupancy"], 4) == 0.6346


# ---------------------------------------------------------------------------
# the paged stream
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch,bucket", [("gpt_20b", True), ("h2o_danube_3_4b", True),
                                         ("granite_3_2b", False)])
def test_paged_stream_tokens_and_stats_equal_reference(arch, bucket):
    ref_sess, port = _pair(arch)
    prompts, gens = chat_stream(ref_sess.cfg.vocab_size, seed=1)
    if not bucket:                   # every prompt length compiles in the reference
        prompts, gens = prompts[:6], gens[:6]
    rs_, ps_ = both_schedulers(ref_sess, port, n_slots=4, max_len=98, page_size=16,
                               bucket_prefills=bucket)
    want, got = drive(rs_, RefQueue, prompts, gens), drive(ps_, RequestQueue, prompts, gens)
    assert_same_serving(want, got)
    # and the contiguous arm's tokens: the paged arm's, except under a
    # window (h2o's 32), where the contiguous arm keeps a ring of `window`
    # slots that a bucketed admission prefill (up to 64 positions) fills with
    # pad positions over valid keys.  That is the reference's contiguous arm,
    # which the port reproduces: there the port's arm is held to the
    # reference's, token for token
    same, _ = port.serve(prompts, gens, n_slots=4, max_len=98, bucket_prefills=bucket)
    if port.cfg.swa_window is None:
        want_same = got[0]
    else:
        want_same, _ = ref_sess.serve(prompts, gens, n_slots=4, max_len=98,
                                      bucket_prefills=bucket)
        assert any(not np.array_equal(a, b) for a, b in zip(want_same, want[0]))
    for a, b in zip(same, want_same):
        np.testing.assert_array_equal(a, b)


def test_paged_serve_matches_reference_with_pallas_kernels():
    """The reference with its flash kernel and ``_paged_decode_kernel``
    forced (interpret mode), page 16, on the first half of the stream (MHA
    here; GQA through the contiguous arm in ``test_torch_scheduler.py``)."""
    ref_sess, port = _pair("gpt_20b", "pallas")
    prompts, gens = chat_stream(ref_sess.cfg.vocab_size, seed=2)
    prompts, gens = prompts[:6], gens[:6]
    with flags.flag_ctx(flash_attention=True, flash_decode=True, pallas_interpret="1"):
        want, _ = ref_sess.serve(prompts, gens, n_slots=4, paged=True)
    got, _ = port.serve(prompts, gens, n_slots=4, paged=True)
    for a, b in zip(want, got):
        np.testing.assert_array_equal(b, a)


def test_paged_stop_token_and_pool_pressure_match_reference():
    """A stop token, and a pool too small for every request at once
    (admissions deferred, FIFO kept, pages evicted from the prefix cache)."""
    ref_sess, port = _pair("granite_3_2b")
    prompts, gens = chat_stream(256, seed=4)
    first, _ = port.serve(prompts, gens, n_slots=4, paged=True)
    stop = int(first[0][len(prompts[0]) + 2])
    rs_, ps_ = both_schedulers(ref_sess, port, n_slots=4, max_len=98, page_size=16, n_pages=12)
    want = drive(rs_, RefQueue, prompts, gens, stop_token=stop)
    got = drive(ps_, RequestQueue, prompts, gens, stop_token=stop)
    assert_same_serving(want, got)
    assert len(got[0][0]) == len(prompts[0]) + 3 and got[0][0][-1] == stop
    assert got[1]["pool_pages"] == 11 and got[1]["max_queue_depth"] == len(prompts)


# ---------------------------------------------------------------------------
# traps
# ---------------------------------------------------------------------------

def test_trap_d_suffix_prefill_after_a_prefix_hit():
    """(d) Two siblings adopt one cached prefix that ends mid-page, then
    diverge: the admission COWs the shared boundary page before the suffix
    prefill writes into it, query positions start at ``hist_lens``, and the
    stale bytes left in the copied page stay masked.  Three waves through
    one scheduler (its prefix cache kept): tokens, stats, page tables and
    refcounts equal the reference's after each wave."""
    ref_sess, port = _pair("granite_3_2b")
    rs = np.random.RandomState(5)
    sysp = rs.randint(1, 256, size=12).astype(np.int32)
    waves = [[np.concatenate([sysp, rs.randint(1, 256, size=n).astype(np.int32)])
              for n in lens] for lens in ((4,), (3, 7), (5,))]
    rs_, ps_ = both_schedulers(ref_sess, port, n_slots=2, max_len=40, page_size=8)
    for prompts in waves:
        gens = [6] * len(prompts)
        want = drive(rs_, RefQueue, prompts, gens)
        got = drive(ps_, RequestQueue, prompts, gens)
        assert_same_serving(want, got)
        (jm, _), (tm, _) = rs_._paged(), ps_._paged()
        assert tm.pool._rc.tolist() == jm.pool._rc.tolist()
        assert tm.tables.tolist() == jm.tables.tolist()
        for p, o in zip(prompts, got[0]):         # each equals its solo decode
            np.testing.assert_array_equal(o, port.generate(p[None], 6)[0].numpy())
    assert got[1]["prefix_hits"] == 1


def test_trap_d_paged_prefill_equals_reference_at_history_offsets():
    """(d), one level down: ``lm_paged_prefill`` of suffixes at
    ``hist_lens`` 0, 12 (mid-page, into a copied page holding stale bytes)
    and 16 (a page boundary) gives the reference's logits and pool."""
    ref_sess, port = _pair("granite_3_2b")
    cfg, tcfg = ref_sess.cfg, port.cfg
    rs = np.random.RandomState(6)
    ps, n_pages = 8, 12
    pool_np = rs.standard_normal((cfg.n_layers, n_pages, ps, cfg.n_kv_heads, cfg.hd)
                                 ).astype(np.float32)
    tables = np.array([[1, 2, 3, -1], [4, 5, 6, -1], [7, 8, 9, 10]], np.int32)
    hist = np.array([0, 12, 16], np.int32)
    lens = np.array([11, 7, 13], np.int32)
    tokens = rs.randint(0, 256, size=(3, 13)).astype(np.int32)
    batch = {"tokens": tokens, "hist_lens": hist, "lengths": lens}
    jl, jp = jtf.lm_paged_prefill(cfg, ref_sess.params, {k: jnp.asarray(v) for k, v in batch.items()},
                                  {"blocks": {"k": jnp.asarray(pool_np), "v": jnp.asarray(-pool_np)}},
                                  jnp.asarray(tables))
    tpool = {"blocks": [{"k": torch.from_numpy(pool_np[i].copy()),
                         "v": torch.from_numpy(-pool_np[i])} for i in range(cfg.n_layers)]}
    tl, tpool = ttf.lm_paged_prefill(tcfg, port.params,
                                     {k: torch.from_numpy(v) for k, v in batch.items()}, tpool,
                                     torch.from_numpy(tables))
    close(tl, jl, 2e-5)
    for i, lp in enumerate(tpool["blocks"]):
        # the trash page takes the pad rows' writes in any order: not compared
        close(lp["k"][1:], np.asarray(jp["blocks"]["k"])[i, 1:], 2e-5)
        close(lp["v"][1:], np.asarray(jp["blocks"]["v"])[i, 1:], 2e-5)


def test_trap_g_inactive_rows_scatter_into_the_trash_page():
    """(g) Inactive rows (unmapped tables, position 0) all write slot 0 of
    the trash page in one step, in no defined order.  Nothing reads it: the
    active rows' logits equal those of a step without the inactive rows,
    whatever the trash page held before, and equal the reference's."""
    ref_sess, port = _pair("granite_3_2b")
    cfg, tcfg = ref_sess.cfg, port.cfg
    rs = np.random.RandomState(7)
    ps, n_pages, L = 8, 8, cfg.n_layers
    pool_np = rs.standard_normal((L, n_pages, ps, cfg.n_kv_heads, cfg.hd)).astype(np.float32)
    tables = np.array([[1, 2, -1], [3, 4, 5], [-1, -1, -1], [-1, -1, -1]], np.int32)
    ts = np.array([11, 20, 0, 0], np.int32)
    toks = np.array([5, 9, 0, 0], np.int32)

    def port_step(rows, trash):
        pool = {"blocks": [{"k": torch.from_numpy(pool_np[i].copy()),
                            "v": torch.from_numpy(pool_np[i] * 0.5)} for i in range(L)]}
        for lp in pool["blocks"]:
            lp["k"][0], lp["v"][0] = trash, -trash
        logits, pool = ttf.lm_paged_decode_step(
            tcfg, port.params, torch.from_numpy(toks[rows]), torch.from_numpy(ts[rows]), pool,
            torch.from_numpy(tables[rows]))
        return logits, pool

    all_rows, active = np.arange(4), np.arange(2)
    full, pool = port_step(all_rows, 0.0)
    assert not (pool["blocks"][0]["k"][0, 0] == 0).all()   # the trash page was written
    noisy, _ = port_step(all_rows, 1e4)
    alone, _ = port_step(active, 0.0)
    close(full[:2], alone.numpy(), 1e-6)
    close(noisy[:2], alone.numpy(), 1e-6)
    jl, _ = jtf.lm_paged_decode_step(
        cfg, ref_sess.params, jnp.asarray(toks), jnp.asarray(ts),
        {"blocks": {"k": jnp.asarray(pool_np), "v": jnp.asarray(pool_np * 0.5)}},
        jnp.asarray(tables))
    close(full[:2], np.asarray(jl)[:2], 2e-5)


def test_pool_ops_and_unsupported_family(monkeypatch):
    """The pool has one (n_pages, ps, Hkv, hd) k/v pair per layer in the
    compute dtype; ``pool_copy_page`` copies a page in every layer; a family
    without paged support is refused as the reference refuses it."""
    _, port = _pair("gpt_20b")
    pool = port.init_paged_pool(5, 4)
    cfg = port.cfg
    assert len(pool["blocks"]) == cfg.n_layers
    for lp in pool["blocks"]:
        for x in (lp["k"], lp["v"]):
            assert x.shape == (5, 4, cfg.n_kv_heads, cfg.hd) and x.dtype == cfg.compute_dtype
            x.copy_(torch.randn(x.shape))
    before = [lp["k"].clone() for lp in pool["blocks"]]
    pool = port.pool_copy_page(pool, 3, 1)
    for b, lp in zip(before, pool["blocks"]):
        assert torch.equal(lp["k"][1], b[3]) and torch.equal(lp["k"][[0, 2, 3, 4]],
                                                               b[[0, 2, 3, 4]])
    assert model_api.supports_paged_cache(cfg)
    monkeypatch.setattr(type(port.family), "supports_paged_cache", lambda self, c: False)
    assert not model_api.supports_paged_cache(cfg)
    with pytest.raises(ValueError, match="paged"):
        ContinuousBatchingScheduler(port, n_slots=1, max_len=16, paged=True)
    with pytest.raises(NotImplementedError, match="not ported"):
        ttf.lm_paged_pool_init(dataclasses.replace(cfg, family="vlm"), 3, 4, device="cpu")
