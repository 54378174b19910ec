"""The port's continuous-batching scheduler on contiguous slots against the
JAX reference, on the CPU.

Weights are the reference's ``lm_init`` parameters, bridged by path; inputs
are made from a seed with numpy.  The padded (bucketed, batched) admission
prefill, the slot step with a position per row and the slot operations must
agree with the reference's; a chat-shaped request stream served by both
schedulers under one fake clock must give identical greedy tokens and equal
``ServingStats``, field for field, on the reference's default path and with
its Pallas kernels forced (interpret mode).  Traps (a)-(c) and (f) of the
port's serving slice each have a test here; the paged arm's are in
``test_torch_paged.py``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import store
from repro.core import stepfn as jstepfn
from repro.core.recipe import ParallelismConfig
from repro.models import transformer as jtf
from repro.runtime import flags
from repro.session.infer import InferenceSession as RefSession
from repro.session.scheduler import ContinuousBatchingScheduler as RefScheduler
from repro.session.scheduler import RequestQueue as RefQueue
from repro_torch.checkpoint.bridge import params_from_numpy
from repro_torch.configs import get_config
from repro_torch.core import stepfn
from repro_torch.models import transformer as ttf
from repro_torch.session import (ContinuousBatchingScheduler, InferenceSession,
                                 RequestQueue)

ARCHS = ["granite_3_2b", "gpt_20b"]
CHAT_GENS = [40, 6, 6, 8, 6, 10, 6, 8, 6, 6, 8, 6]
_REF = {}


def _pair(arch, path="default"):
    """(reference session, port session on the CPU with its weights).  One
    reference session per (arch, path) is kept for the module, so its jitted
    steps compile once; the "pallas" one is only ever called inside
    ``_flags("pallas")``, since the flags are read at trace time."""
    if (arch, path) not in _REF:
        _REF[arch, path] = RefSession.from_recipe(arch, reduced=True, seed=0)
    ref = _REF[arch, path]
    flat = {k: np.asarray(v) for k, v in store._flatten(ref.params)}
    return ref, InferenceSession.from_params(get_config(arch).reduced(),
                                             params_from_numpy(flat), device="cpu")


def _flags(path):
    if path == "pallas":
        return flags.flag_ctx(flash_attention=True, flash_decode=True, pallas_interpret="1")
    return flags.flag_ctx()


class FakeClock:
    """Returns 1, 2, 3, ... : two schedulers that call it in the same order
    see the same times."""

    def __init__(self):
        self.n = 0

    def __call__(self):
        self.n += 1
        return float(self.n)


def chat_stream(vocab, seed=0):
    """The chat-shaped workload of ``benchmarks/run.py``: a 48-token shared
    system prompt, suffixes of 4-10 tokens, mostly short replies."""
    rs = np.random.RandomState(seed)
    sysp = rs.randint(1, vocab, size=48).astype(np.int32)
    prompts = [np.concatenate([sysp, rs.randint(1, vocab, size=4 + 2 * (i % 4))
                               .astype(np.int32)]) for i in range(len(CHAT_GENS))]
    return prompts, list(CHAT_GENS)


def drive(scheduler_cls, queue_cls, sess, prompts, gens, *, stop_token=None, **kw):
    """Serve ``prompts`` through a fresh scheduler under a fresh fake clock
    → (outputs in submit order, stats as a dict)."""
    clock = FakeClock()
    queue = queue_cls(clock=clock)
    rids = [queue.submit(p, m, stop_token=stop_token) for p, m in zip(prompts, gens)]
    kw.setdefault("max_len", max(len(p) for p in prompts) + max(gens))
    sched = scheduler_cls(sess, **kw)
    outputs, stats = sched.run(queue, clock=clock)
    return [outputs[r] for r in rids], dataclasses.asdict(stats)


def assert_same_serving(want, got):
    (wo, ws), (go, gs) = want, got
    assert len(wo) == len(go)
    for i, (a, b) in enumerate(zip(wo, go)):
        np.testing.assert_array_equal(b, a, err_msg=f"request {i}")
    assert gs == ws


def _tokens(B, S, vocab, seed):
    return np.random.RandomState(seed).randint(0, vocab, size=(B, S)).astype(np.int32)


def close(got, want, tol=2e-5):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


# ---------------------------------------------------------------------------
# the stream, contiguous arm
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch,bucket", [("granite_3_2b", True), ("gpt_20b", True),
                                         ("h2o_danube_3_4b", True), ("granite_3_2b", False)])
def test_stream_tokens_and_stats_equal_reference(arch, bucket):
    ref, port = _pair(arch)
    prompts, gens = chat_stream(ref.cfg.vocab_size)
    if not bucket:                   # every prompt length compiles in the reference
        prompts, gens = prompts[:6], gens[:6]
    kw = dict(n_slots=4, bucket_prefills=bucket, max_len=98)
    want = drive(RefScheduler, RefQueue, ref, prompts, gens, **kw)
    got = drive(ContinuousBatchingScheduler, RequestQueue, port, prompts, gens, **kw)
    assert_same_serving(want, got)
    if bucket:                       # the stream's figures in BENCH_serving.json
        assert round(got[1]["stranded_fraction"], 4) == 0.2977
        assert got[1]["prefill_tokens"] == 660 and round(got[1]["occupancy"], 4) == 0.6667


def test_serve_matches_reference_with_pallas_kernels():
    """The reference with its flash and decode kernels forced (interpret
    mode), on the first half of the stream; the slot caches are 128 wide so
    that its decode kernel tiles (GQA here; MHA through the paged arm in
    ``test_torch_paged.py``)."""
    ref, port = _pair("granite_3_2b", "pallas")
    prompts, gens = chat_stream(ref.cfg.vocab_size, seed=1)
    prompts, gens = prompts[:6], gens[:6]
    with _flags("pallas"):
        want, _ = ref.serve(prompts, gens, n_slots=4, max_len=128)
    got, _ = port.serve(prompts, gens, n_slots=4, max_len=128)
    for a, b in zip(want, got):
        np.testing.assert_array_equal(b, a)


def test_stop_token_matches_reference():
    ref, port = _pair("granite_3_2b")
    prompts, gens = chat_stream(ref.cfg.vocab_size, seed=2)
    first, _ = port.serve(prompts, gens, n_slots=4)
    stop = int(first[0][len(prompts[0]) + 2])     # request 0 stops at its third token
    want = drive(RefScheduler, RefQueue, ref, prompts, gens, stop_token=stop, n_slots=4)
    got = drive(ContinuousBatchingScheduler, RequestQueue, port, prompts, gens,
                stop_token=stop, n_slots=4)
    assert_same_serving(want, got)
    assert len(got[0][0]) == len(prompts[0]) + 3 and got[0][0][-1] == stop


def test_generate_list_delegates_to_serve():
    _, port = _pair("gpt_20b")
    prompts, gens = chat_stream(port.cfg.vocab_size, seed=3)
    prompts, gens = prompts[1:4], gens[1:4]
    outs = port.generate(prompts, gens, n_slots=2)
    want, stats = port.serve(prompts, gens, n_slots=2)
    assert port.last_stats == stats and stats.requests == 3
    for a, b in zip(outs, want):
        np.testing.assert_array_equal(a, b)
    # and each equals the request served alone through uniform generate()
    for p, m, o in zip(prompts, gens, outs):
        np.testing.assert_array_equal(o, port.generate(p[None], m)[0].numpy())


# ---------------------------------------------------------------------------
# traps
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_trap_a_padded_prefill(arch):
    """(a) Right-padded rows with ``lengths`` and ``segment_ids`` -1 on the
    pad tail: logits at ``lengths - 1``, padded cache slots invalidated
    (pos -1), and each real row's logits and caches equal an unpadded
    prefill of that row alone; and all of it equal to the reference's."""
    ref, port = _pair(arch)
    cfg, tcfg = ref.cfg, port.cfg
    L, max_len, lens = 16, 24, np.array([16, 9, 3], np.int32)
    toks = _tokens(3, L, cfg.vocab_size, seed=4)
    seg = np.where(np.arange(L)[None] < lens[:, None], 0, -1).astype(np.int32)
    jl, jc = jtf.lm_prefill(cfg, ref.params, {"tokens": jnp.asarray(toks),
                                             "lengths": jnp.asarray(lens),
                                             "segment_ids": jnp.asarray(seg)},
                            jtf.lm_cache_init(cfg, 3, max_len))
    batch = {"tokens": torch.from_numpy(toks), "lengths": torch.from_numpy(lens),
             "segment_ids": torch.from_numpy(seg)}
    tl, tc = ttf.lm_prefill(tcfg, port.params, batch,
                            ttf.lm_cache_init(tcfg, 3, max_len, device="cpu"))
    close(tl, jl)
    for i, c in enumerate(tc["blocks"]):
        np.testing.assert_array_equal(c["pos"].numpy(), np.asarray(jc["blocks"]["pos"])[i])
        close(c["k"], np.asarray(jc["blocks"]["k"])[i])
        assert (c["pos"].numpy() < lens[:, None]).all()
        assert ((c["pos"].numpy() >= 0).sum(1) == lens).all()
    for b, n in enumerate(lens):
        sl, sc = ttf.lm_prefill(tcfg, port.params,
                                {"tokens": torch.from_numpy(toks[b:b + 1, :n])},
                                ttf.lm_cache_init(tcfg, 1, max_len, device="cpu"))
        close(tl[b:b + 1], sl.numpy())
        for c, s in zip(tc["blocks"], sc["blocks"]):
            close(c["k"][b:b + 1, :n], s["k"][:, :n].numpy())
            np.testing.assert_array_equal(c["pos"][b:b + 1].numpy(), s["pos"].numpy())


@pytest.mark.parametrize("arch", ARCHS)
def test_trap_b_slot_step_positions_per_row(arch):
    """(b) One slot step with ``ts = [P0, P1, ...]`` equals B single-row
    decode steps (the RoPE angle, the ring slot ``ts % size``, the validity
    ``kpos <= ts[b]``), and the reference's vmapped slot step; then the slot
    operations move, reset and insert rows as the reference's do."""
    ref, port = _pair(arch)
    cfg, tcfg = ref.cfg, port.cfg
    B, size, ts = 3, 12, np.array([5, 14, 9], np.int32)   # row 1 has wrapped the ring
    jc = jtf.lm_cache_init(cfg, B, size)
    tc = ttf.lm_cache_init(tcfg, B, size, device="cpu")
    # fill each row with its own history, teacher-forced, one position at a time
    hist = _tokens(B, int(ts.max()), cfg.vocab_size, seed=6)
    jstep = jax.jit(jstepfn.make_slot_serve_step(cfg, ParallelismConfig()))
    for t in range(int(ts.max())):
        pos = np.minimum(t, ts - 1).astype(np.int32)   # rows stop at their own depth
        _, jc = jstep(ref.params, jnp.asarray(hist[np.arange(B), pos]), jnp.asarray(pos), jc)
        stepfn.make_slot_serve_step(tcfg)(port.params, torch.from_numpy(hist[np.arange(B), pos]),
                                          torch.from_numpy(pos), tc)
    for i, c in enumerate(tc["blocks"]):
        np.testing.assert_array_equal(c["pos"].numpy(), np.asarray(jc["blocks"]["pos"])[i])
    tok = _tokens(1, B, cfg.vocab_size, seed=5)[0]
    want, jc = jstep(ref.params, jnp.asarray(tok), jnp.asarray(ts), jc)
    # each row alone, at its own int position, on a copy of its cache row
    singles = torch.cat([
        ttf.lm_decode_step(tcfg, port.params, torch.from_numpy(tok[b:b + 1]), int(ts[b]),
                           stepfn.cache_slice_slots(tcfg, tc, b, 1))[0] for b in range(B)])
    logits, _ = ttf.lm_decode_step(tcfg, port.params, torch.from_numpy(tok),
                                   torch.from_numpy(ts), stepfn.cache_slice_slots(tcfg, tc, 0, B))
    close(logits, singles.numpy(), 1e-6)
    got, tc = port.slot_step(port.params, torch.from_numpy(tok), torch.from_numpy(ts), tc)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert torch.equal(got, singles.argmax(-1).to(torch.int32))
    # slot operations: zero row 1, move row 2 into it, as the reference does
    jz = jstepfn.cache_zero_slot(cfg, jc, jnp.int32(1))
    jz = jstepfn.cache_insert_slot(cfg, jz, jstepfn.cache_take_slot(cfg, jz, jnp.int32(2)),
                                   jnp.int32(1))
    port.zero_slot(tc, 1)
    assert (tc["blocks"][0]["pos"][1] == -1).all() and (tc["blocks"][0]["k"][1] == 0).all()
    port.insert_slot(tc, port.take_slot(tc, 2), 1)
    for i, c in enumerate(tc["blocks"]):
        np.testing.assert_array_equal(c["pos"].numpy(), np.asarray(jz["blocks"]["pos"])[i])
        close(c["v"], np.asarray(jz["blocks"]["v"])[i])


def test_trap_b_per_row_step_equals_separate_steps_from_one_cache():
    """(b), within the port: a prefill of three prompts of different
    lengths, then one slot step at ``ts = lengths``, equals each prompt
    decoded alone at its own position."""
    _, port = _pair("granite_3_2b")
    cfg = port.cfg
    lens, max_len = [7, 12, 3], 20
    prompts = [_tokens(1, n, cfg.vocab_size, seed=10 + n)[0] for n in lens]
    caches = port.init_cache(3, max_len)
    firsts = []
    for b, p in enumerate(prompts):
        one = port.init_cache(1, max_len)
        logits, one = port.prefill_cache_step(port.params, {"tokens": torch.from_numpy(p[None])},
                                              one)
        firsts.append(int(logits.argmax(-1)))
        port.insert_slot(caches, one, b)
    toks = torch.tensor(firsts, dtype=torch.int32)
    nxt, _ = port.slot_step(port.params, toks, torch.tensor(lens, dtype=torch.int32), caches)
    for b, p in enumerate(prompts):
        alone = port.generate(p[None], 2)[0].numpy()
        assert alone[-2] == firsts[b] and alone[-1] == int(nxt[b])


def test_trap_c_bucket_capped_at_max_len():
    """(c) A prompt of 20 buckets to 32, past a 24-wide ring: the bucket is
    capped at ``max_len`` (positions p and p + size would collide), and the
    tokens still equal the reference's and each request's solo decode."""
    ref, port = _pair("granite_3_2b")
    max_len = 24
    for n in (24, 40, 98):
        sched = ContinuousBatchingScheduler(port, n_slots=2, max_len=n)
        assert [sched._bucket_len(P) for P in (1, 16, 17, 20, 24, 33)] == \
            [RefScheduler(ref, n_slots=2, max_len=n)._bucket_len(P)
             for P in (1, 16, 17, 20, 24, 33)]
        assert sched._bucket_len(20) == min(32, n)
    rs = np.random.RandomState(7)
    prompts = [rs.randint(1, 256, size=n).astype(np.int32) for n in (20, 13, 18)]
    gens = [4, 3, 4]
    want = drive(RefScheduler, RefQueue, ref, prompts, gens, n_slots=2, max_len=max_len)
    got = drive(ContinuousBatchingScheduler, RequestQueue, port, prompts, gens, n_slots=2,
                max_len=max_len)
    assert_same_serving(want, got)
    for p, m, o in zip(prompts, gens, got[0]):
        np.testing.assert_array_equal(o, port.generate(p[None], m)[0].numpy())


def test_trap_f_stats_equal_under_an_irregular_clock():
    """(f) Every ``ServingStats`` field, the times included, equals the
    reference's when both read one clock that advances unevenly; with more
    requests than slots and stop tokens, so that admissions happen
    mid-flight and slots retire early."""

    class Squares(FakeClock):
        def __call__(self):
            self.n += 1
            return 0.001 * self.n * self.n

    ref, port = _pair("gpt_20b")
    prompts, gens = chat_stream(ref.cfg.vocab_size)
    results = []
    for sess, sched_cls, queue_cls in ((ref, RefScheduler, RefQueue),
                                       (port, ContinuousBatchingScheduler, RequestQueue)):
        clock = Squares()
        queue = queue_cls(clock=clock)
        for p, m in zip(prompts, gens):
            queue.submit(p, m, stop_token=int(p[-1]))
        outputs, stats = sched_cls(sess, n_slots=4, max_len=98).run(queue, clock=clock)
        results.append((outputs, stats))
    (wo, ws), (go, gs) = results
    assert set(wo) == set(go)
    for rid in wo:
        np.testing.assert_array_equal(go[rid], wo[rid])
    for f in dataclasses.fields(ws):
        assert getattr(gs, f.name) == getattr(ws, f.name), f.name
    assert gs.max_queue_depth == len(prompts) and gs.mean_queue_wait_s > 0


def test_requests_that_cannot_fit_are_refused_before_any_work():
    _, port = _pair("granite_3_2b")
    sched = ContinuousBatchingScheduler(port, n_slots=1, max_len=8)
    queue = RequestQueue()
    queue.submit(np.zeros(6, np.int32), 4)
    with pytest.raises(ValueError, match="max_len"):
        sched.run(queue)
    assert len(queue) == 1
    with pytest.raises(ValueError, match="at least one token"):
        queue.submit(np.zeros(0, np.int32), 2)
    with pytest.raises(ValueError, match=">= 1"):
        queue.submit(np.zeros(3, np.int32), 0)
