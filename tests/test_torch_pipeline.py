"""The port's pipeline parallelism (``core.pipeline``: 1F1B and interleaved
virtual stages, remat "stage", pp under ZeRO and tp, the checkpoint and
elastic re-plan of a pipelined state) against the JAX reference, on the
CPU, in f32 at reduced size.

Four parts (the train steps against the reference's ``make_train_step``
and the fleet's re-plan are in ``test_torch_pipeline_steps.py``):

* **The schedule in one process**, mirroring ``tests/test_pipeline.py``:
  the port's in-process schedule against ``repro.core.pipeline`` on the
  same weights and batch: the loss (rtol 1e-5), the gradients (atol 2e-6,
  rtol 2e-4), packed segments, remat "stage", the stack layout, the plan's
  validation; and the schedule's own laws (each stage's micro-batches in
  flight, its messages, no deadlock).
* **The checkpoint** without a mesh: a pp 2 checkpoint restores at pp 1
  and pp 4 and in the reference's store
  (``tests/test_checkpoint.py::test_elastic_replan_pp``).
* **The ZeRO rules under pp**, with ``==`` and no process group: every
  leaf's parameter and optimizer-state spec of the seven dense configs
  equals the reference's on its pp-stacked tree.
* **Over gloo**: one fixture starts a world of 2 ranks and one of 4, which
  run every case of their world once: pp 2 (vpp 1, vpp 2, remat stage), pp
  2 x tp 2 (sequence parallel) and pp 2 x dp 2 (ZeRO 1 and 3), one step
  each from the reference's weights, held to the reference on one device;
  the leaves every stage holds keep equal bits over pp; the messages and
  collectives a step are exact (``chip_smoke.expected_pp_p2p``); a pp 2
  crash and resume of ``TrainSession.run`` is bitwise, and its checkpoint
  restores at pp 1 and 4 on one device.
"""

import dataclasses
import functools
import json
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

from repro.checkpoint import elastic as jelastic
from repro.checkpoint import store as jstore
from repro.configs import get_config as jget_config
from repro.core import pipeline as jpipe
from repro.core import stepfn as jstepfn
from repro.core import zero as jzero
from repro.core.recipe import ParallelismConfig as JPlan
from repro.models import api as japi
from repro.optim.adamw import AdamWConfig as JAdamW
from repro.runtime.resilience import ResilienceConfig as JResilience
from repro_torch.checkpoint import bridge, store
from repro_torch.checkpoint.bridge import params_from_numpy, state_from_numpy, state_to_numpy
from repro_torch.configs import PORTED, get_config
from repro_torch.core import pipeline, stepfn, zero
from repro_torch.core.recipe import ParallelismConfig
from repro_torch.core.tree import tree_leaves, tree_map
from repro_torch.data import DataConfig
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.runtime.resilience import ResilienceConfig
from repro_torch.session import TrainSession

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke  # noqa: E402  (the message counts phase 22 asserts on the card)

KEY = jax.random.PRNGKey(0)
# peak LR 1e-4, as tests/test_torch_training.py's three steps: at 1e-3 Adam
# turns the f32-level differences of a near-zero gradient entry into single
# entries past 1e-5
SEQ, BATCH, GAS, LR = 32, 8, 4, 1e-4


def _flat(tree):
    return {k: np.asarray(v) for k, v in jstore._flatten(tree)}


def _cfgs(arch="granite_3_2b", n_layers=4):
    j = jget_config(arch).reduced()
    p = get_config(arch).reduced()
    if n_layers:
        j, p = dataclasses.replace(j, n_layers=n_layers), dataclasses.replace(p, n_layers=n_layers)
    return j, p


def _batch(vocab, packed=False, mask=False, seed=0):
    rng = np.random.default_rng(seed)
    b = {"tokens": rng.integers(0, vocab, (BATCH, SEQ)).astype(np.int32),
         "labels": rng.integers(0, vocab, (BATCH, SEQ)).astype(np.int32)}
    if packed:
        pos = np.arange(SEQ)[None]
        cut = np.arange(BATCH)[:, None] % (SEQ - 2) + 1
        b["segment_ids"] = np.where(pos < cut, 1, 2).astype(np.int32)
    if mask:
        b["loss_mask"] = (rng.random((BATCH, SEQ)) < 0.6).astype(np.float32)
    return b


def _tensors(b):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in b.items()}


@functools.lru_cache(maxsize=None)
def _setup(arch="granite_3_2b", n_layers=4):
    jcfg, cfg = _cfgs(arch, n_layers)
    jparams = japi.init_params(jcfg, KEY)
    return jcfg, cfg, jparams, _flat(jparams)


def _port_params(flat):
    return tree_map(lambda x: x.clone(), params_from_numpy(flat))


# ===========================================================================
# the schedule in one process, against repro.core.pipeline
# ===========================================================================

def _ref_loss(jcfg, jparams, batch, plan):
    stacked = dict(jparams, blocks=jpipe.stack_for_pipeline(jparams["blocks"], plan.pp, plan.vpp))
    return float(jpipe.pipeline_loss(jcfg, stacked, {k: jnp.asarray(v) for k, v in batch.items()},
                                     plan)[0])


@pytest.mark.parametrize("pp,vpp,gas,n_layers", [
    (2, 1, 2, 0), (2, 1, 4, 0), (2, 1, 8, 0), (2, 1, 4, 4), (2, 2, 4, 4), (2, 2, 8, 4)],
    ids=["pp2-g2", "pp2-g4", "pp2-g8", "pp2-v1-g4-L4", "pp2-v2-g4-L4", "pp2-v2-g8-L4"])
def test_pipeline_loss_equivalence(pp, vpp, gas, n_layers):
    """``pipeline_loss`` of the port (the stages in this process) equals the
    reference's superstep scan, rtol 1e-5 (reduced granite: 2 layers, or 4
    for the interleaved cases)."""
    jcfg, cfg, jparams, flat = _setup("granite_3_2b", n_layers)
    batch = _batch(cfg.vocab_size)
    want = _ref_loss(jcfg, jparams, batch, JPlan(pp=pp, vpp=vpp, gas=gas))
    got, m = pipeline.pipeline_loss(cfg, _port_params(flat), _tensors(batch),
                                    ParallelismConfig(pp=pp, vpp=vpp, gas=gas))
    np.testing.assert_allclose(float(got), want, rtol=1e-5)
    assert float(m["aux"]) == 0.0 and float(m["xent"]) == float(got)


def _port_grads(cfg, flat, batch, plan):
    """The port's gradient of the pipelined loss: the 1F1B passes over
    every stage in this process, each backward seeded with 1 / Σ mask."""
    params = _port_params(flat)
    for _, p in tree_leaves(params):
        p.requires_grad_()
    tb = _tensors(batch)
    micro = pipeline.split_micros(tb, plan.gas)
    out = pipeline.run_pipeline(cfg, plan, params, [{k: x[i] for k, x in micro.items()}
                                                    for i in range(plan.gas)],
                                seed=1.0 / pipeline.denominator(tb))
    return state_to_numpy(tree_map(lambda p: p.grad, params)), out


def _ref_grads(jcfg, jparams, batch, plan):
    stacked = dict(jparams, blocks=jpipe.stack_for_pipeline(jparams["blocks"], plan.pp, plan.vpp))
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    g = jax.grad(lambda p: jpipe.pipeline_loss(jcfg, p, jb, plan)[0])(stacked)
    return bridge.unstack_pipeline(_flat(g), plan)


@pytest.mark.parametrize("vpp,remat,packed,mask", [
    (1, "full", False, False), (2, "full", False, False), (2, "stage", False, False),
    (2, "full", True, True)], ids=["vpp1", "vpp2", "vpp2-stage", "vpp2-packed-mask"])
def test_pipeline_grad_equivalence(vpp, remat, packed, mask):
    """Every parameter's gradient through the port's schedule equals the
    reference's ``jax.grad`` through its scan: atol 2e-6, rtol 2e-4 (the
    test_pipeline.py tolerances); remat "stage" and packed segments under a
    loss mask too."""
    jcfg, cfg, jparams, flat = _setup()
    batch = _batch(cfg.vocab_size, packed=packed, mask=mask)
    want = _ref_grads(jcfg, jparams, batch, JPlan(pp=2, gas=4, vpp=vpp, remat_policy=remat))
    got, out = _port_grads(cfg, flat, batch,
                           ParallelismConfig(pp=2, gas=4, vpp=vpp, remat_policy=remat))
    assert set(got) == set(want)
    for k, w in want.items():
        np.testing.assert_allclose(got[k], w, atol=2e-6, rtol=2e-4, err_msg=k)
    sched = pipeline.Schedule(2, vpp, 4)
    assert out["in_flight"] == [sched.in_flight(p) for p in range(2)]


def test_interleaved_packed_segments():
    jcfg, cfg, jparams, flat = _setup()
    batch = _batch(cfg.vocab_size, packed=True)
    want = _ref_loss(jcfg, jparams, batch, JPlan(pp=2, gas=4, vpp=2))
    got, _ = pipeline.pipeline_loss(cfg, _port_params(flat), _tensors(batch),
                                    ParallelismConfig(pp=2, gas=4, vpp=2))
    np.testing.assert_allclose(float(got), want, rtol=1e-5)


def test_interleaved_stage_remat():
    """Remat "stage": the loss is the reference's, and the chunk recomputes
    whole in the backward (the flash forward runs three times a layer: the
    forward, the chunk's recompute and the layer's own)."""
    from repro_torch.kernels import flash_attention as fa
    jcfg, cfg, jparams, flat = _setup()
    batch = _batch(cfg.vocab_size)
    plan = ParallelismConfig(pp=2, gas=4, vpp=2, remat_policy="stage")
    want = _ref_loss(jcfg, jparams, batch, JPlan(pp=2, gas=4, vpp=2, remat_policy="stage"))
    got, _ = pipeline.pipeline_loss(cfg, _port_params(flat), _tensors(batch), plan)
    np.testing.assert_allclose(float(got), want, rtol=1e-5)
    calls = {"flash_fwd_plain": 0, "flash_delta_plain": 0}

    def counting(name):
        real = getattr(fa, name)

        def fn(*a, **k):
            calls[name] += 1
            return real(*a, **k)
        return fn

    for policy, per_layer in (("full", 2), ("stage", 3)):
        calls.update(dict.fromkeys(calls, 0))
        with pytest.MonkeyPatch.context() as mp:
            for name in calls:
                mp.setattr(fa, name, counting(name))
            _port_grads(cfg, flat, batch, dataclasses.replace(plan, remat_policy=policy))
        assert calls == {"flash_fwd_plain": per_layer * cfg.n_layers * plan.gas,
                         "flash_delta_plain": cfg.n_layers * plan.gas}, (policy, calls)


@pytest.mark.parametrize("vpp", [1, 2])
def test_stack_unstack_roundtrip(vpp):
    """``stack_for_pipeline`` nests the per-layer blocks as the reference
    stacks its leaves (chunk c = v·PP + p at [v][p]); unstack inverts it."""
    jcfg, cfg, jparams, flat = _setup()
    params = _port_params(flat)
    stacked = pipeline.stack_for_pipeline(params["blocks"], 2, vpp)
    ref = _flat(jpipe.stack_for_pipeline(jparams["blocks"], 2, vpp))
    for key, leaf in ref.items():
        path = tuple(key.split("/"))
        for idx in np.ndindex(*leaf.shape[:2 if vpp == 1 else 3]):
            node = stacked
            for i in idx:
                node = node[i]
            for p in path:
                node = node[p]
            np.testing.assert_array_equal(node.numpy(), leaf[idx], err_msg=(key, idx))
    back = pipeline.unstack_from_pipeline(stacked, vpp)
    assert all(a is b for a, b in zip(back, params["blocks"])) and len(back) == 4
    flat_ref = bridge.unstack_pipeline({"params/blocks/" + k: v for k, v in ref.items()},
                                       JPlan(pp=2, vpp=vpp))
    for k, v in _flat(jparams["blocks"]).items():
        np.testing.assert_array_equal(flat_ref["params/blocks/" + k], v, err_msg=k)


def test_validate_constraints():
    _, cfg = _cfgs(n_layers=8)
    with pytest.raises(ValueError, match="gas"):
        ParallelismConfig(pp=2, gas=3, vpp=2).validate(8)
    with pytest.raises(ValueError, match="divide"):
        ParallelismConfig(pp=2, gas=4, vpp=2).validate(6)
    ParallelismConfig(pp=2, gas=4, vpp=2).validate(8)
    with pytest.raises(ValueError, match="gas"):
        stepfn.check_plan(ParallelismConfig(pp=2, gas=3, vpp=2), cfg=cfg)
    with pytest.raises(ValueError, match="divide"):
        stepfn.check_plan(ParallelismConfig(pp=3), cfg=cfg)
    stepfn.check_plan(ParallelismConfig(pp=2, gas=4, vpp=2, remat_policy="stage"), cfg=cfg)
    for jp, p in ((JPlan(pp=2, gas=3, vpp=2), ParallelismConfig(pp=2, gas=3, vpp=2)),):
        with pytest.raises(ValueError) as a:
            jp.validate(8)
        with pytest.raises(ValueError) as b:
            p.validate(8)
        assert str(a.value) == str(b.value)


SCHEDULES = [(pp, vpp, gas) for pp in (2, 3, 4) for vpp in (1, 2, 3) for gas in (1, 2, 4, 6, 8, 12)
             if vpp == 1 or gas % pp == 0]


def test_schedule_laws():
    """Every stage runs each (micro-batch, chunk row) once forward and once
    backward, a backward after its forward; in flight is the closed form
    (min(gas, pp - p) for 1F1B); ``expected_pp_p2p`` counts the actions
    that send, and the ring's messages balance; the stages' orders run in
    one process without deadlock."""
    for pp, vpp, gas in SCHEDULES:
        s = pipeline.Schedule(pp, vpp, gas)
        sent = received = 0
        for p in range(pp):
            acts = s.actions(p)
            f = [(m, v) for k, m, v in acts if k == "F"]
            b = [(m, v) for k, m, v in acts if k == "B"]
            assert sorted(f) == sorted(b) == sorted((m, v) for m in range(gas)
                                                    for v in range(vpp))
            assert all(acts.index(("F", m, v)) < acts.index(("B", m, v)) for m, v in f)
            assert s.in_flight(p) == s.in_flight_formula(p), (pp, vpp, gas, p)
            if vpp == 1:
                assert s.in_flight(p) == min(gas, pp - p)
            n, _ = chip_smoke.expected_pp_p2p(pp, vpp, gas, p, mbs=1, seq=1, d_model=1,
                                              itemsize=1)
            # each forward but the last chunk's sends once, so does each
            # backward but chunk 0's
            assert n["send@pp"] == sum(
                (k == "F" and s.chunk(p, v) < s.last) + (k == "B" and s.chunk(p, v) > 0)
                for k, _, v in acts)
            sent += n["send@pp"]
            received += n["recv@pp"]
        assert sent == received == 2 * gas * (vpp * pp - 1)
        stages = [SimpleNamespace(forward=lambda m, v, x: torch.zeros(()),
                                  backward=lambda m, v, dy: torch.zeros(()))
                  for _ in range(pp)]
        pipeline._run_in_process(s, stages, forward_only=False)
    assert ParallelismConfig(pp=4, gas=8, vpp=2).bubble_fraction == pytest.approx(3 / 19)


# ===========================================================================
# the train step, against the reference's make_train_step
# ===========================================================================

def _train_cfgs(**rs):
    kw = dict(peak_lr=LR, warmup=2, total_steps=10)
    return (jstepfn.TrainConfig(adam=JAdamW(), resilience=JResilience(**rs), **kw),
            stepfn.TrainConfig(adam=AdamWConfig(), resilience=ResilienceConfig(**rs), **kw))


# ===========================================================================
# the checkpoint, without a mesh
# ===========================================================================

def test_elastic_replan_pp(tmp_path):
    """A checkpoint written by ``TrainSession.run`` at pp 2 restores at pp 1
    and pp 4 (the same bits) and in the reference's store, whose pp 2
    restack is the port's state."""
    _, cfg = _cfgs(n_layers=4)
    dc = DataConfig(seq_len=SEQ, global_batch=BATCH)
    _, tc = _train_cfgs()

    def sess(pp):
        return TrainSession(cfg, plan=ParallelismConfig(pp=pp, gas=GAS), train_cfg=tc,
                            data_cfg=dc, device="cpu", seed=4)

    s2 = sess(2)
    s2.run(2, ckpt_dir=str(tmp_path), ckpt_every=2, async_ckpt=False, log=lambda _m: None)
    want = state_to_numpy(s2.state)
    for pp in (1, 4):
        restored, extra, step = store.restore_latest(tmp_path, sess(pp).state,
                                                     log=lambda _m: None)
        assert step == 2 and extra["next_step"] == 2
        for k, v in state_to_numpy(restored).items():
            np.testing.assert_array_equal(v, want[k], err_msg=(pp, k))
    jcfg, _ = _cfgs(n_layers=4)
    jplan = JPlan(pp=2, gas=GAS)
    template = jelastic.canonicalize_state(jstepfn.init_state(jcfg, jplan, KEY), jplan)
    jstate, _, step = jstore.restore_latest(tmp_path, template, log=lambda _m: None)
    assert step == 2
    restacked = _flat(jelastic.reshard_state(jstate, jplan))
    assert restacked["params/blocks/attn/wq"].shape[:2] == (2, 2)
    for k, v in bridge.unstack_pipeline(restacked, jplan).items():
        np.testing.assert_array_equal(v, want[k], err_msg=k)


# ===========================================================================
# the ZeRO rules under pp, with ==
# ===========================================================================

RULE_PLANS = [dict(pp=2, vpp=1), dict(pp=2, vpp=2), dict(pp=2, dp=2, zero_stage=1),
              dict(pp=2, dp=2, zero_stage=3)]


# the configs the port pipelines: deepseek-moe's stack of 27 layers after its
# dense first one is divisible by no pp·vpp > 1 (it raises, as in the
# reference); the xLSTM and the encoder-decoder have no ``blocks`` stack,
# which is all the reference's pipeline stacks, and it cannot pipeline them
# (its step fails on both: ``test_torch_xlstm``/``test_torch_whisper``)
PP_ARCHS = [a for a in PORTED if a not in ("deepseek_moe_16b", "xlstm_125m", "whisper_base")]


@functools.lru_cache(maxsize=None)
def _stacked_shapes(arch, n_layers, pp, vpp):
    jcfg = dataclasses.replace(jget_config(arch), n_layers=n_layers)
    return jax.eval_shape(lambda k: jstepfn.init_state(jcfg, JPlan(pp=pp, vpp=vpp, gas=pp), k)
                          ["params"], KEY)


def _paths(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {"/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path): leaf
            for path, leaf in flat}


def _pad(spec, n):
    spec = tuple(spec)
    return spec + (None,) * (n - len(spec))


@pytest.mark.parametrize("kw", RULE_PLANS, ids=["pp2", "pp2-vpp2", "pp2-dp2-z1", "pp2-dp2-z3"])
@pytest.mark.parametrize("arch", PP_ARCHS)
def test_zero_rules_equal_reference_under_pp(arch, kw):
    """``zero.param_shardings``/``opt_shardings`` on the port's per-layer
    leaves equal the reference's specs on its pp-stacked tree (the stacking
    axes ``("pp", None)`` or ``(None, "pp", None)`` ahead), full size; the
    layer count cut to a multiple of pp·vpp where it is not one.  Where the
    reference's rule spreads a stacking axis (qwen1.5's biases, hymba's
    SSM vectors and conv; Queue 3) the port keeps the parameter's spec."""
    plan = ParallelismConfig(gas=2, **kw)
    full = jget_config(arch).n_layers
    n_layers = full - full % (plan.pp * plan.vpp)
    shapes = _paths(_stacked_shapes(arch, n_layers, plan.pp, plan.vpp))
    names = ("pod", "data", "pp", "tp")
    sizes = (1, plan.dp, plan.pp, 1)
    jmesh = jax.sharding.AbstractMesh(sizes, names)
    jplan = JPlan(gas=2, **kw)
    jcfg = dataclasses.replace(jget_config(arch), n_layers=n_layers)
    params = _stacked_shapes(arch, n_layers, plan.pp, plan.vpp)
    jp = _paths(jzero.param_shardings(jcfg, params, jmesh, jplan))
    jo = _paths(jzero.opt_shardings(jzero.param_shardings(jcfg, params, jmesh, jplan), params,
                                    jmesh, jplan))
    mesh = SimpleNamespace(shape=dict(zip(names, sizes)), axis_names=names)
    lead = len(pipeline.stack_shape(n_layers, plan))
    port = [(tuple(p.replace("blocks/", "blocks/0/").split("/")) if p.startswith("blocks/")
             else tuple(p.split("/")), leaf.shape[lead:] if p.startswith("blocks/")
             else leaf.shape) for p, leaf in shapes.items()]
    pp_ = zero.param_shardings(port, mesh, plan, hints=zero.family_hints(get_config(arch)))
    po = zero.opt_shardings(pp_, port, mesh, plan, n_layers)
    prefix = ("pp", None) if plan.vpp == 1 else (None, "pp", None)
    layer_axis = set()
    for (path, leaf), (ppath, shape) in zip(shapes.items(), port):
        k = lead if path.startswith("blocks/") else 0
        want_p = _pad(jp[path].spec, len(leaf.shape))
        want_o = _pad(jo[path].spec, len(leaf.shape))
        assert _pad(pp_[ppath], len(shape)) == want_p[k:], (path, "param")
        if k:
            assert want_p[:k] == prefix, (path, want_p)
        if k and want_o[:k] != prefix:
            assert want_o[k:] == want_p[k:] and po[ppath] == pp_[ppath], path
            layer_axis.add(path)
        else:
            assert _pad(po[ppath], len(shape)) == want_o[k:], (path, "opt")
    # qwen1.5's attention biases; hymba's per-head SSM vectors and its
    # depthwise conv, whose only divisible dims are the stacking axes
    assert layer_axis <= {"blocks/attn/bq", "blocks/attn/bk", "blocks/attn/bv",
                          "blocks/ssm/A_log", "blocks/ssm/D", "blocks/ssm/dt_bias",
                          "blocks/ssm/conv"}, layer_axis


# ===========================================================================
# over gloo
# ===========================================================================

ARCH = "gpt_36b"
# (case id, world, mesh keywords, plan keywords, the reference's plan)
CASES = [
    ("pp2", 2, dict(pp=2), dict(), "v1"),
    ("pp2-vpp2", 2, dict(pp=2), dict(vpp=2), "v2"),
    ("pp2-vpp2-stage", 2, dict(pp=2), dict(vpp=2, remat_policy="stage"), "v2-stage"),
    ("pp2-tp2-sp", 4, dict(pp=2, tp=2), dict(tp=2, sequence_parallel=True), "v1"),
    ("pp2-dp2-z1", 4, dict(pp=2), dict(dp=2, zero_stage=1), "v1"),
    ("pp2-dp2-z3", 4, dict(pp=2), dict(dp=2, zero_stage=3), "v1"),
]
REFS = {"v1": dict(), "v2": dict(vpp=2), "v2-stage": dict(vpp=2, remat_policy="stage")}


def _gpt():
    return _cfgs(ARCH, 4)


def _ref_steps(tmp):
    """The reference on one device: one step of every plan from the same
    weights and batch → {ref: (metrics, canonical flat state)}."""
    jcfg, cfg = _gpt()
    jtc, _ = _train_cfgs()
    state = jstepfn.init_state(jcfg, JPlan(), KEY, jtc)
    b = _batch(cfg.vocab_size, seed=3)
    out = {}
    for name, kw in REFS.items():
        jplan = JPlan(pp=2, gas=GAS, **kw)
        st = jelastic.reshard_state(state, jplan)
        st, m = jstepfn.make_train_step(jcfg, jplan, jtc)(st, {k: jnp.asarray(v)
                                                              for k, v in b.items()})
        out[name] = ({k: float(v) for k, v in m.items()},
                     _flat(jelastic.canonicalize_state(st, jplan)))
    return out


def _start_world(world, tmp):
    env = {**os.environ, "PYTHONPATH": os.pathsep.join([str(ROOT / "src"), str(ROOT / "tests")]),
           "JAX_PLATFORMS": "cpu", "OMP_NUM_THREADS": "1"}
    code = f"import test_torch_pipeline as t; t._rank_main({world}, {str(tmp)!r})"
    return [subprocess.Popen([sys.executable, "-c", code], env={**env, "RANK": str(r)},
                             stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for r in range(world)]


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("pipeline")
    jcfg, cfg = _gpt()
    # the inputs first (the ranks read them), then the ranks, then the
    # reference's runs while they train
    jtc, _ = _train_cfgs()
    flat = _flat(jstepfn.init_state(jcfg, JPlan(), KEY, jtc))
    np.savez(tmp / "init.npz", **flat)
    np.savez(tmp / "batch.npz", **_batch(cfg.vocab_size, seed=3))
    procs = {w: _start_world(w, tmp) for w in (2, 4)}
    refs = _ref_steps(tmp)
    logs = {}
    for w, ps in procs.items():
        for r, p in enumerate(ps):
            try:
                logs[(w, r)] = p.communicate(timeout=400)[0]
            except subprocess.TimeoutExpired:
                for q in ps:
                    q.kill()
                raise
            assert p.returncode == 0, f"world {w} rank {r}:\n{logs[(w, r)][-4000:]}"
    return SimpleNamespace(tmp=tmp, refs=refs)


def _rank_main(world, tmp):
    """One rank of a world: every case of the world, results under ``tmp``."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_recipe_mesh
    tmp = Path(tmp)
    rank = int(os.environ["RANK"])
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{tmp}/store{world}", rank=rank,
                            world_size=world)
    meshes = {}
    extra = {}
    for case, w, mesh_kw, kw, _ in CASES:
        if w != world:
            continue
        key = json.dumps(mesh_kw, sort_keys=True)
        if key not in meshes:
            meshes[key] = make_recipe_mesh(device_type="cpu", **mesh_kw)
        got, extra[case] = _rank_case(meshes[key], kw, tmp)
        np.savez(tmp / f"{case}_r{rank}.npz", **got)
    if world == 2:
        extra["ckpt"] = _rank_checkpoint(meshes[json.dumps(dict(pp=2))], tmp, rank)
    (tmp / f"extra{world}_r{rank}.json").write_text(json.dumps(extra))
    dist.barrier()
    dist.destroy_process_group()


def _plan(mesh, **kw):
    return ParallelismConfig(pp=mesh.shape["pp"], gas=GAS, **kw)


def _rank_case(mesh, kw, tmp):
    """One step from the reference's weights (counted: the messages and
    collectives by group, the activations in flight), a second one; the
    whole state after the first, this rank's own leaves outside the blocks
    after the second."""
    from repro_torch.checkpoint.elastic import host_snapshot, reshard_state
    from repro_torch.core import tp
    _, cfg = _gpt()
    plan = _plan(mesh, **kw)
    _, tc = _train_cfgs()
    sess = TrainSession(cfg, plan=plan, mesh=mesh, device="cpu", train_cfg=tc,
                        data_cfg=DataConfig(seq_len=SEQ, global_batch=BATCH))
    sess.state = reshard_state(state_from_numpy(dict(np.load(tmp / "init.npz"))), plan,
                               mesh=mesh)
    batch = dict(np.load(tmp / "batch.npz"))
    tp.reset()
    m = sess.step(batch)
    counts = {"got": dict(tp.by_group), "bytes": dict(tp.bytes_by_group),
              "in_flight": list(sess.train_step.in_flight), "coords": mesh.coords}
    out = {f"metric/{k}": np.asarray(float(v)) for k, v in m.items()}
    out.update({k: v for k, v in host_snapshot(sess.state, plan, mesh=mesh, cfg=cfg)
                if k.startswith(("params/", "opt/m/"))})
    sess.step(batch)
    for path, x in tree_leaves(sess.state["params"]):
        if path[0] != "blocks":
            out["own/" + "/".join(map(str, path))] = x.detach().numpy().copy()
    return out, counts


def _ckpt_session(mesh, plan):
    _, cfg = _gpt()
    return TrainSession(cfg, plan=plan, mesh=mesh, device="cpu", seed=3,
                        train_cfg=stepfn.TrainConfig(peak_lr=1e-3, warmup=1, total_steps=8),
                        data_cfg=DataConfig(seq_len=SEQ, global_batch=BATCH))


def _rank_checkpoint(mesh, tmp, rank):
    """pp 2: crash at step 3 after a checkpoint at step 2, resume in a fresh
    session, against a run that never crashed; ``to_inference`` gathers the
    stages' blocks."""
    from repro_torch.checkpoint.elastic import host_snapshot
    plan = _plan(mesh)
    ck = tmp / "ck_pp2"
    sess = _ckpt_session(mesh, plan)
    try:
        sess.run(4, ckpt_dir=str(ck), ckpt_every=2, fail_at_step=3, log=lambda _m: None)
        crashed = False
    except RuntimeError as e:
        crashed = "injected failure at step 3" in str(e)
    sess = _ckpt_session(mesh, plan)
    out = sess.run(4, ckpt_dir=str(ck), ckpt_every=2, log=lambda _m: None)
    np.savez(tmp / f"ck_resumed_r{rank}.npz",
             **dict(host_snapshot(sess.state, plan, mesh=mesh, cfg=sess.cfg)))
    inf = sess.to_inference()
    np.savez(tmp / f"ck_inference_r{rank}.npz",
             **{"/".join(map(str, p)): x.numpy() for p, x in tree_leaves(inf.params)})
    sess = _ckpt_session(mesh, plan)
    sess.run(4, log=lambda _m: None)
    np.savez(tmp / f"ck_straight_r{rank}.npz",
             **dict(host_snapshot(sess.state, plan, mesh=mesh, cfg=sess.cfg)))
    return {"crashed": crashed, "resumed_from": out["resumed_from"],
            "events": [(e.step, e.kind) for e in out["events"]]}


def _case(worlds, case, rank=0):
    return np.load(worlds.tmp / f"{case}_r{rank}.npz")


def _extra(worlds, world, rank=0):
    return json.loads((worlds.tmp / f"extra{world}_r{rank}.json").read_text())


@pytest.mark.parametrize("case", [c[0] for c in CASES])
def test_mesh_step_matches_reference(worlds, case):
    """One step on the mesh from the reference's weights: loss 1e-5
    relative, the verdict's metrics, params within 1e-5 (Adam's noise-floor
    entries, |m| <= 1e-6 of the leaf's largest, held to 2·lr and at most
    1e-4 of the entries) and the first moment (0.1 x the clipped gradient)
    within 5e-4; the same loss on every rank."""
    _, world, _, _, ref = dict((c[0], c) for c in CASES)[case]
    metrics, after = worlds.refs[ref]
    got = _case(worlds, case)
    np.testing.assert_allclose(got["metric/loss"], metrics["loss"], rtol=1e-5)
    for k in ("xent", "grad_norm", "lr", "skipped", "all_finite", "nonfinite_micros",
              "bad_micro_bits", "n_replicas"):
        np.testing.assert_allclose(got[f"metric/{k}"], metrics[k], rtol=1e-5, atol=1e-6,
                                   err_msg=k)
    floor, total = 0, 0
    for key, w in after.items():
        if not key.startswith("params/"):
            continue
        m = after["opt/m/" + key[len("params/"):]]
        noise = np.abs(m) <= 1e-6 * np.abs(m).max()
        np.testing.assert_allclose(got["opt/m/" + key[len("params/"):]] / 0.1, m / 0.1,
                                   atol=5e-4, rtol=5e-4, err_msg=key)
        d = np.abs(got[key] - w)
        ok = d <= 1e-5 + 1e-5 * np.abs(w)
        assert (ok | (noise & (d <= 2 * metrics["lr"]))).all(), key
        floor += int((~ok).sum())
        total += d.size
    assert floor <= 1e-4 * total, (floor, total)
    for r in range(1, world):
        assert float(_case(worlds, case, r)["metric/loss"]) == float(got["metric/loss"])


@pytest.mark.parametrize("case", [c[0] for c in CASES])
def test_shared_leaves_equal_over_pp(worlds, case):
    """The leaves outside the blocks (the tied table, the final norm), which
    every stage holds and updates from the gradient summed over the pp
    line, keep the same bits on every stage after two steps."""
    world = dict((c[0], c[1]) for c in CASES)[case]
    coords = [_extra(worlds, world, r)[case]["coords"] for r in range(world)]
    for r in range(world):
        for q in range(world):
            same = all(coords[r][a] == coords[q][a] for a in ("pod", "data", "tp"))
            if q <= r or not same:
                continue
            a, b = _case(worlds, case, r), _case(worlds, case, q)
            keys = [k for k in a.files if k.startswith("own/")]
            assert keys and set(keys) == {k for k in b.files if k.startswith("own/")}
            for k in keys:
                np.testing.assert_array_equal(a[k], b[k], err_msg=(r, q, k))


@pytest.mark.parametrize("case", [c[0] for c in CASES])
def test_messages_and_collectives_exact(worlds, case):
    """Each rank's sends and receives over the pp line and their bytes are
    ``chip_smoke.expected_pp_p2p``'s; the pp line also carries one
    all-reduce of the shared leaves' gradients and one of the loss, the
    world two of the norm (the gate's and the step's); on a pp-only mesh
    that is every collective.  The most activations each stage kept is the
    schedule's ``in_flight``."""
    _, world, _, kw, _ = dict((c[0], c) for c in CASES)[case]
    _, cfg = _gpt()
    plan = ParallelismConfig(pp=2, gas=GAS, **kw)
    sched = pipeline.Schedule(plan.pp, plan.vpp, plan.gas)
    for r in range(world):
        c = _extra(worlds, world, r)[case]
        stage = c["coords"]["pp"]
        n, nbytes = chip_smoke.expected_pp_p2p(
            plan.pp, plan.vpp, plan.gas, stage, plan.tp, mbs=BATCH // GAS // plan.dp, seq=SEQ,
            d_model=cfg.d_model, itemsize=4, sp=plan.sequence_parallel)
        for k in n:
            assert c["got"][k] == n[k] and c["bytes"][k] == nbytes[k], (r, k)
        assert c["got"]["all_reduce@pp"] == 2 and c["got"]["all_reduce@world"] == 2, r
        if world == 2:
            assert set(c["got"]) == {"send@pp", "recv@pp", "all_reduce@pp", "all_reduce@world"}
        assert c["in_flight"] == [sched.in_flight(stage)], r


def test_checkpoint_crash_resume_bitwise(worlds):
    """pp 2 on the mesh: ``TrainSession.run`` crashed at step 3 resumes from
    its step-2 checkpoint with the bits of a run that never crashed, both
    ranks logging the same events; ``to_inference`` holds the whole
    canonical params on both ranks."""
    ex = [_extra(worlds, 2, r)["ckpt"] for r in range(2)]
    assert ex[0]["crashed"] and ex[0]["resumed_from"] == 2
    assert ex[0]["events"] == ex[1]["events"]
    for r in range(2):
        a = np.load(worlds.tmp / f"ck_resumed_r{r}.npz")
        b = np.load(worlds.tmp / f"ck_straight_r{r}.npz")
        assert set(a.files) == set(b.files)
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        inf = np.load(worlds.tmp / f"ck_inference_r{r}.npz")
        for k in inf.files:
            parts = k.split("/")
            want = (b["params/blocks/" + "/".join(parts[2:])][int(parts[1])]
                    if parts[0] == "blocks" else b["params/" + k])
            np.testing.assert_array_equal(inf[k], want, err_msg=k)


def test_mesh_checkpoint_restores_at_pp1_pp4_and_in_reference(worlds):
    """The pp 2 mesh's checkpoint holds the canonical state: the port
    restores it on one device at pp 1 and pp 4 with the bits the mesh
    gathered, and so does the reference's store."""
    ck = worlds.tmp / "ck_pp2"
    assert store.list_steps(ck) == [2, 4]
    want = np.load(worlds.tmp / "ck_straight_r0.npz")
    for pp in (1, 4):
        sess = _ckpt_session(None, ParallelismConfig(pp=pp, gas=GAS))
        one, _, step = store.restore_latest(ck, sess.state, log=lambda _m: None)
        assert step == 4
        for k, v in state_to_numpy(one).items():
            np.testing.assert_array_equal(v, want[k], err_msg=(pp, k))
    jcfg, _ = _gpt()
    template = jstepfn.init_state(jcfg, JPlan(), KEY)
    jstate, extra, step = jstore.restore_latest(ck, template, log=lambda _m: None)
    assert step == 4 and extra["next_step"] == 4
    for k, v in _flat(jstate).items():
        np.testing.assert_array_equal(v, want[k], err_msg=k)
