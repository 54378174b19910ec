"""The port's VLM family (``internvl2_1b``) against the JAX reference, on
the CPU, in f32 at reduced size (2 layers, d 64, 4/2 heads, 8 vision
tokens), the reference's weights and train states bridged to the port:

* the prefill logits over ``[vision_embeds; tokens]`` (2e-5), the loss and
  its gradients with and without a ``loss_mask`` (the vision positions
  masked when there is none: 1e-5 relative, 5e-4), three ``TrainSession``
  steps at gas 2 on the data pipeline's vision embeddings (params 1e-5),
  ``evaluate`` and ``perplexity``;
* serving: the cache-populating prefill with vision embeddings then
  decode, ``generate`` (text only) and the slot stream (tokens and
  ``ServingStats`` exact); the paged pool refused in the reference's words;
* the pipeline at pp 2: at gas 1 the reference's ``pipeline_loss``, which
  counts the vision positions when there is no mask; at gas 2, where the
  reference's pipeline raises (it splices the whole batch's embeddings into
  one micro-batch), the port splits them per micro-batch and gives the
  reference's ``loss_fn`` with an explicit mask;
* over gloo, tp 2: with the vocabulary-parallel table (vocab 256) and with
  a whole table under sequence parallel (an odd vocab, as the full
  config's 151655): prefill, ``generate`` and one step equal the
  reference's one device.
"""

import dataclasses
import functools
import os
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.core import pipeline as jpipe
from repro.core.recipe import ParallelismConfig as JPlan
from repro.data import DataConfig as JDataConfig
from repro.models import api as japi
from repro.models import init_params as jinit_params
from repro.session.evalsess import EvalSession as RefEval
from repro.session.infer import InferenceSession as RefInference
from repro.session.scheduler import ContinuousBatchingScheduler as RefScheduler
from repro.session.scheduler import RequestQueue as RefQueue
from repro.session.train import TrainSession as RefTrainSession
from repro_torch.checkpoint.bridge import params_from_numpy, state_from_numpy, state_to_numpy
from repro_torch.configs import get_config
from repro_torch.core import pipeline, sharding, stepfn, zero
from repro_torch.core.recipe import ParallelismConfig
from repro_torch.core.tree import tree_leaves, tree_map
from repro_torch.data import DataConfig
from repro_torch.models import api as tapi
from repro_torch.session import (ContinuousBatchingScheduler, EvalSession, InferenceSession,
                                 RequestQueue, TrainSession)
from test_torch_moe import _flat, _train_cfgs
from test_torch_moe_serving import _drive

ROOT = Path(__file__).resolve().parents[1]
ARCH = "internvl2_1b"
SEQ, BATCH, GAS = 32, 4, 2


def _cfgs(**kw):
    return (dataclasses.replace(jget_config(ARCH).reduced(), **kw),
            dataclasses.replace(get_config(ARCH).reduced(), **kw))


def _batch(seed=0, *, mask=False, batch=BATCH, vocab=256):
    jcfg, _ = _cfgs()
    rng = np.random.default_rng(seed)
    b = {"tokens": rng.integers(0, vocab, (batch, SEQ)).astype(np.int32),
         "labels": rng.integers(0, vocab, (batch, SEQ)).astype(np.int32),
         "vision_embeds": rng.standard_normal((batch, jcfg.n_vision_tokens,
                                               jcfg.d_model)).astype(np.float32)}
    if mask:
        b["loss_mask"] = (rng.random((batch, SEQ)) < 0.7).astype(np.float32)
    return b


def _j(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def _t(b):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in b.items()}


@functools.lru_cache(maxsize=None)
def _params(vocab=256):
    jcfg, cfg = _cfgs(vocab_size=vocab)
    jparams = jinit_params(jcfg, jax.random.PRNGKey(0))
    return jcfg, cfg, jparams, _flat(jparams)


def _serving_pair():
    jcfg, cfg, jparams, flat = _params()
    return (RefInference.from_params(jcfg, jparams),
            InferenceSession.from_params(cfg, params_from_numpy(flat), device="cpu"))


# ===========================================================================
# forward, loss and steps
# ===========================================================================

def test_prefill_logits_with_vision_match_reference():
    """The first nv positions are the vision embeddings: the logits of
    every position and of the last (2e-5) equal the reference's, and
    differ from the text-only prefill's."""
    ref, port = _serving_pair()
    b = _batch()
    b.pop("labels")
    got = {}
    for last_only in (False, True):
        want = np.asarray(ref.prefill(_j(b), last_only=last_only))
        got[last_only] = port.prefill(b, last_only=last_only).numpy()
        np.testing.assert_allclose(got[last_only], want, atol=2e-5, rtol=2e-5)
    text = port.prefill({"tokens": b["tokens"]}, last_only=False).numpy()
    assert np.abs(text - got[False]).max() > 1e-3
    assert port.family.extra_input_specs(port.cfg, 3) == {
        "vision_embeds": ((3, port.cfg.n_vision_tokens, port.cfg.d_model), torch.float32)}


@pytest.mark.parametrize("mask", [False, True], ids=["vision-masked", "loss_mask"])
def test_loss_and_grads_match_reference(mask):
    """``lm_loss`` and every gradient: without a ``loss_mask`` the vision
    positions bear no loss (as the reference's), with one the mask rules;
    loss 1e-5 relative, gradients 5e-4."""
    jcfg, cfg, jparams, flat = _params()
    b = _batch(1, mask=mask)
    (jl, jm), jg = jax.value_and_grad(lambda p: japi.loss_fn(jcfg, p, _j(b)),
                                      has_aux=True)(jparams)
    params = tree_map(lambda x: x.clone().requires_grad_(), params_from_numpy(flat))
    loss, m = tapi.loss_fn(cfg, params, _t(b))
    leaves = [p for _, p in tree_leaves(params)]
    grads = torch.autograd.grad(loss, leaves)
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=1e-5)
    np.testing.assert_allclose(float(m["xent"].detach()), float(jm["xent"]), rtol=1e-5)
    want = params_from_numpy(_flat(jg))
    for (path, w), g in zip(tree_leaves(want), grads):
        np.testing.assert_allclose(g.numpy(), w.numpy(), atol=5e-4, rtol=5e-4, err_msg=str(path))
    if not mask:
        b["loss_mask"] = np.ones((BATCH, SEQ), np.float32)
        whole, _ = tapi.loss_fn(cfg, params, _t(b))
        assert abs(float(whole.detach()) - float(loss.detach())) > 1e-4


@functools.lru_cache(maxsize=None)
def _sessions():
    """The reference's TrainSession and the port's holding its state, gas 2,
    their batches drawn by each package's data pipeline (vision embeddings
    included)."""
    jtc, tc = _train_cfgs()
    ref = RefTrainSession(_cfgs()[0], plan=JPlan(gas=GAS), seed=5, train_cfg=jtc,
                          data_cfg=JDataConfig(seq_len=SEQ, global_batch=BATCH, seed=7))
    port = TrainSession(_cfgs()[1], plan=ParallelismConfig(gas=GAS), train_cfg=tc,
                        device="cpu", data_cfg=DataConfig(seq_len=SEQ, global_batch=BATCH,
                                                          seed=7))
    port.state = state_from_numpy(_flat(ref.state))
    steps = [({k: float(v) for k, v in ref.step().items()},
              {k: float(v) for k, v in port.step().items()}) for _ in range(3)]
    return ref, port, steps


def test_three_steps_match_reference():
    """Three steps at gas 2 (each micro-batch its rows of the vision
    embeddings): the batches are the reference's, the metrics 1e-5 and the
    params after them 1e-5."""
    ref, port, steps = _sessions()
    for i in (0, 5):
        a, b = ref.batches(i), port.batches(i)
        assert set(a) == set(b) and "vision_embeds" in a
        for k in a:
            np.testing.assert_array_equal(np.asarray(b[k]), np.asarray(a[k]))
    for mr, mp in steps:
        for k in ("loss", "xent", "grad_norm", "lr", "skipped"):
            np.testing.assert_allclose(mp[k], mr[k], rtol=1e-5, atol=1e-6, err_msg=k)
    want = _flat(ref.state)
    got = state_to_numpy(port.state)
    for k, w in want.items():
        if k.startswith("params/"):
            np.testing.assert_allclose(got[k], w, atol=1e-5, rtol=1e-5, err_msg=k)


def test_evaluate_and_perplexity_match_reference():
    """``evaluate`` on a batch with vision embeddings and the perplexity
    sweep over two of the pipeline's batches, on the trained weights."""
    ref, port, _ = _sessions()
    batch = port.batches(7)
    mr, mp = ref.evaluate(batch), port.evaluate(batch)
    np.testing.assert_allclose(float(mp["xent"]), float(mr["xent"]), rtol=1e-5)
    want = RefEval(ref.cfg, params=ref.state["params"]).perplexity(
        ref.batches(i) for i in (8, 9))
    got = EvalSession.from_train_session(port).perplexity(port.batches(i) for i in (8, 9))
    assert got["n_tokens"] == want["n_tokens"] and got["n_batches"] == want["n_batches"]
    np.testing.assert_allclose(got["xent"], want["xent"], rtol=1e-5)
    np.testing.assert_allclose(got["perplexity"], want["perplexity"], rtol=1e-5)


# ===========================================================================
# serving
# ===========================================================================

def test_cache_prefill_with_vision_then_decode_tokens_exact():
    """The cache-populating prefill over ``[vision; text]``, then 10 decode
    steps: the prefill's logits 2e-5 and every token equal the reference's
    (the decode step is token-only, as the reference's)."""
    ref, port = _serving_pair()
    b = _batch(3)
    b.pop("labels")
    L = SEQ + 10
    jcaches = ref.init_cache(BATCH, L)
    jl, jcaches = ref.prefill_cache_step(ref.params, _j(b), jcaches)
    caches = port.init_cache(BATCH, L)
    with torch.inference_mode():
        tl, caches = port.prefill_cache_step(port.params, _t(b), caches)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=2e-5, rtol=2e-5)
    jtok = jnp.argmax(jl, axis=-1).astype(jnp.int32)
    tok = tl.argmax(-1).to(torch.int32)
    for t in range(SEQ, L):
        np.testing.assert_array_equal(tok.numpy(), np.asarray(jtok))
        jtok, jcaches = ref.serve_step(ref.params, jtok, jnp.int32(t), jcaches)
        with torch.inference_mode():
            tok, caches = port.serve_step(port.params, tok, t, caches)
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jtok))


def test_generate_and_stream_equal_reference():
    """``generate`` (text only, B 8) and the contiguous slot stream
    (bucketed admission prefills): tokens and every ``ServingStats`` field
    equal on one fake clock.  ``paged=True`` raises in both, and the port's
    paged pool raises in the words of the reference's family hook."""
    ref, port = _serving_pair()
    prompts = np.random.RandomState(2).randint(0, 256, (8, 12)).astype(np.int32)
    np.testing.assert_array_equal(port.generate(prompts, 8).numpy(),
                                  np.asarray(ref.generate(prompts, 8)))
    rs = np.random.RandomState(4)
    lens = [5, 9, 7, 12, 9, 5, 3]
    stream = [rs.randint(1, 256, size=n).astype(np.int32) for n in lens]
    gens = [6, 3, 8, 4, 5, 7, 3]
    kw = dict(n_slots=3, max_len=24)
    want = _drive(RefScheduler, RefQueue, ref, stream, gens, **kw)
    got = _drive(ContinuousBatchingScheduler, RequestQueue, port, stream, gens, **kw)
    for a, b in zip(want[0], got[0]):
        np.testing.assert_array_equal(b, a)
    assert got[1] == want[1]
    assert not tapi.supports_paged_cache(port.cfg)
    with pytest.raises(ValueError, match="paged"):
        port.serve(stream[:2], 2, paged=True)
    with pytest.raises(ValueError, match="paged"):
        ref.serve(stream[:2], 2, paged=True)
    with pytest.raises(NotImplementedError, match="vlm: paged KV pool unsupported"):
        port.init_paged_pool(4, 8)


# ===========================================================================
# the pipeline
# ===========================================================================

def _ref_pipeline(jcfg, jparams, b, plan):
    stacked = dict(jparams, blocks=jpipe.stack_for_pipeline(jparams["blocks"], plan.pp, plan.vpp))
    return jpipe.pipeline_loss(jcfg, stacked, _j(b), plan)


def test_pipeline_gas1_counts_the_vision_positions_as_the_reference():
    """pp 2 at gas 1 without a mask: the reference's ``pipeline_loss`` bears
    the loss at the vision positions too (its ``lm_loss`` does not), and so
    does the port's (1e-5 relative)."""
    jcfg, cfg, jparams, flat = _params()
    b = _batch(4)
    want, _ = _ref_pipeline(jcfg, jparams, b, JPlan(pp=2, gas=1))
    got, m = pipeline.pipeline_loss(cfg, params_from_numpy(flat), _t(b),
                                    ParallelismConfig(pp=2, gas=1))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    masked, _ = japi.loss_fn(jcfg, jparams, _j(b))
    assert abs(float(want) - float(masked)) > 1e-4 and float(m["aux"]) == 0.0


def test_pipeline_gas2_splits_vision_per_micro_batch():
    """pp 2 at gas 2 with a ``loss_mask``: the reference's pipeline raises
    (it concatenates the whole batch's vision embeddings into one
    micro-batch); the port gives each micro-batch its rows, and its loss
    (1e-5 relative) and 1F1B gradients (5e-4) are the reference's
    ``loss_fn`` on the whole batch."""
    jcfg, cfg, jparams, flat = _params()
    b = _batch(5, mask=True)
    with pytest.raises(TypeError, match="concatenate"):
        _ref_pipeline(jcfg, jparams, b, JPlan(pp=2, gas=2))
    (jl, _), jg = jax.value_and_grad(lambda p: japi.loss_fn(jcfg, p, _j(b)),
                                     has_aux=True)(jparams)
    plan = ParallelismConfig(pp=2, gas=2)
    got, _ = pipeline.pipeline_loss(cfg, params_from_numpy(flat), _t(b), plan)
    np.testing.assert_allclose(float(got), float(jl), rtol=1e-5)
    params = tree_map(lambda x: x.clone().requires_grad_(), params_from_numpy(flat))
    tb = _t(b)
    micro = pipeline.split_micros(tb, 2)
    pipeline.run_pipeline(cfg, plan, params, [{k: x[i] for k, x in micro.items()}
                                              for i in range(2)],
                          seed=1.0 / pipeline.denominator(tb))
    want = params_from_numpy(_flat(jg))
    for (path, w), (_, p) in zip(tree_leaves(want), tree_leaves(params)):
        np.testing.assert_allclose(p.grad.numpy(), w.numpy(), atol=5e-4, rtol=5e-4,
                                   err_msg=str(path))


# ===========================================================================
# tensor parallelism over gloo
# ===========================================================================

# (case, plan keywords, vocabulary): the reduced vocabulary of 256 is cut
# over tp (the splice follows the lookup's all-reduce); an odd one keeps the
# table whole, as the full config's 151655 does
CASES = [("tp2-vocab-parallel", dict(tp=2), 256),
         ("tp2-sp-whole-table", dict(tp=2, sequence_parallel=True), 255)]


def test_whole_heads_allow_tp2_and_refuse_tp4():
    cfg = get_config(ARCH)
    mesh = lambda t: SimpleNamespace(shape={"tp": t, "pp": 1, "data": 1, "pod": 1})
    stepfn.check_plan(ParallelismConfig(tp=2), mesh(2), cfg)
    with pytest.raises(ValueError, match="n_heads=14"):
        stepfn.check_plan(ParallelismConfig(tp=4), mesh(4), cfg)


def _ref_one_device(vocab, tmp):
    """The reference on one device: one step from the initial state,
    prefill logits and greedy tokens of the initial weights."""
    jcfg, _ = _cfgs(vocab_size=vocab)
    ref = RefTrainSession(jcfg, plan=JPlan(gas=GAS), seed=5, train_cfg=_train_cfgs()[0],
                          data_cfg=JDataConfig(seq_len=SEQ, global_batch=BATCH, seed=7))
    params = jax.tree_util.tree_map(lambda x: jnp.array(x, copy=True), ref.state["params"])
    batch = ref.batches(0)
    np.savez(tmp / f"v{vocab}_state.npz", **_flat(ref.state))
    np.savez(tmp / f"v{vocab}_batch.npz", **batch)
    return params, batch, ref


def _finish_reference(params, batch, ref, tmp):
    jcfg = ref.cfg
    inf = RefInference.from_params(jcfg, params)
    out = {"prefill": np.asarray(inf.prefill(
        {k: jnp.asarray(batch[k]) for k in ("tokens", "vision_embeds")}, last_only=False)),
        "tokens": np.asarray(inf.generate(np.load(tmp / "prompts.npy"), 6))}
    out["metrics"] = {k: float(v) for k, v in ref.step(batch).items()}
    out["state"] = _flat(ref.state)
    return out


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("vlm")
    np.save(tmp / "prompts.npy",
            np.random.RandomState(9).randint(0, 255, (4, 10)).astype(np.int32))
    started = {v: _ref_one_device(v, tmp) for v in sorted({c[2] for c in CASES})}
    env = {**os.environ, "PYTHONPATH": os.pathsep.join([str(ROOT / "src"), str(ROOT / "tests")]),
           "JAX_PLATFORMS": "cpu", "OMP_NUM_THREADS": "1"}
    code = f"import test_torch_vlm as t; t._rank_main({str(tmp)!r})"
    procs = [subprocess.Popen([sys.executable, "-c", code], env={**env, "RANK": str(r)},
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(2)]
    refs = {v: _finish_reference(*started[v], tmp) for v in started}
    for r, p in enumerate(procs):
        try:
            log = p.communicate(timeout=300)[0]
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        assert p.returncode == 0, f"rank {r}:\n{log[-4000:]}"
    return SimpleNamespace(tmp=tmp, refs=refs)


def _rank_main(tmp):
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_recipe_mesh
    tmp = Path(tmp)
    rank = int(os.environ["RANK"])
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{tmp}/store", rank=rank, world_size=2)
    mesh = make_recipe_mesh(tp=2, device_type="cpu")
    for case, plan_kw, vocab in CASES:
        _, cfg = _cfgs(vocab_size=vocab)
        plan = ParallelismConfig(gas=GAS, **plan_kw)
        flat = dict(np.load(tmp / f"v{vocab}_state.npz"))
        batch = dict(np.load(tmp / f"v{vocab}_batch.npz"))
        params = params_from_numpy({k[len("params/"):]: v for k, v in flat.items()
                                    if k.startswith("params/")})
        out = {}
        inf = InferenceSession.from_params(cfg, params, plan=plan, mesh=mesh, device="cpu")
        out["table_rows"] = np.array(inf.params["embed"].shape[0])
        out["prefill"] = inf.prefill({k: batch[k] for k in ("tokens", "vision_embeds")},
                                     last_only=False).numpy()
        out["tokens"] = inf.generate(np.load(tmp / "prompts.npy"), 6).numpy()
        sess = TrainSession(cfg, plan=plan, mesh=mesh, device="cpu", train_cfg=_train_cfgs()[1],
                            data_cfg=DataConfig(seq_len=SEQ, global_batch=BATCH, seed=7))
        hints = zero.family_hints(cfg)
        state = state_from_numpy(flat)
        state["params"] = sharding.shard_params(state["params"], mesh, plan, hints=hints)
        for key in ("m", "v"):
            state["opt"][key] = sharding.shard_state(state["opt"][key], mesh, plan, hints=hints)
        sess.state = state
        for k, v in sess.step(batch).items():
            out[f"metric/{k}"] = np.asarray(float(v))
        out.update(state_to_numpy({"params": sharding.gather_params(
            sess.state["params"], mesh, plan, cfg)}))
        np.savez(tmp / f"{case}_r{rank}.npz", **out)
    dist.barrier()
    dist.destroy_process_group()


@pytest.mark.parametrize("case", [c[0] for c in CASES])
def test_tp2_over_gloo_matches_reference(world, case):
    """On both ranks: prefill logits with vision embeddings (1e-5), greedy
    tokens (exact), one step's loss, xent and norm (1e-5) and params (1e-5,
    noise-floor entries held to 2·lr) equal the reference's one device; the
    table is cut over tp at vocab 256 and whole at 255."""
    _, _, vocab = dict((c[0], c) for c in CASES)[case]
    want = world.refs[vocab]
    lr = want["metrics"]["lr"]
    for rank in (0, 1):
        got = dict(np.load(world.tmp / f"{case}_r{rank}.npz"))
        assert int(got["table_rows"]) == (128 if vocab == 256 else 255)
        np.testing.assert_allclose(got["prefill"], want["prefill"], atol=1e-5, rtol=1e-5)
        np.testing.assert_array_equal(got["tokens"], want["tokens"])
        for k in ("loss", "xent", "grad_norm", "skipped"):
            np.testing.assert_allclose(got[f"metric/{k}"], want["metrics"][k], rtol=1e-5,
                                       atol=1e-7, err_msg=k)
        for key, w in want["state"].items():
            if not key.startswith("params/"):
                continue
            g_ref = np.abs(want["state"]["opt/m/" + key[len("params/"):]]) / 0.1
            noise = g_ref <= 1e-6 * g_ref.max()
            d = np.abs(got[key] - w)
            ok = d <= 1e-5 + 1e-5 * np.abs(w)
            assert (ok | (noise & (d <= 2 * lr))).all(), key
