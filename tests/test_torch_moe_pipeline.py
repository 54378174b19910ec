"""The port's MoE family under pipeline parallelism, against the JAX
reference, on the CPU, in f32 at reduced size.

* **In one process**: reduced ``olmoe_1b_7b`` at 4 layers, pp 2 and gas 4,
  at vpp 1, vpp 2 and under remat "stage": ``pipeline_loss`` (loss, xent and
  the load-balance loss, 1e-5 relative) and the gradients of the 1F1B
  passes against ``jax.grad`` of the reference's ``pipeline_loss`` (5e-4),
  the routers of both stages included and nonzero; reduced
  ``deepseek_moe_16b`` with an even stack (6 layers, 2 of them the dense
  unstacked ``pre_blocks``) the same at pp 2; deepseek at its own reduced
  depth (one stacked layer) raises in both packages; three
  ``TrainSession`` steps at pp 2 against the reference's.
* **Over gloo**: a world of two ranks (pp 2: olmoe, and deepseek with its
  ``pre_blocks`` on every stage) and one of four (pp 2 x dp 2: each
  micro-batch routed in two groups, one a replica, as the reference's
  ``moe_groups(dp)``).  Each rank trains three steps from the reference's
  weights through ``TrainSession.run``, which checkpoints the last; the
  metrics and the parameters equal the reference's ``TrainSession`` at pp 2
  (1e-5), the messages are ``chip_smoke.expected_pp_p2p``'s, ``evaluate``
  then gives the reference's ``pipeline_loss`` on its trained weights, and
  the checkpoint restores in the reference's store and on one device at
  pp 1.
"""

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

from repro.checkpoint import store as jstore
from repro.core import pipeline as jpipe
from repro.core import stepfn as jstepfn
from repro.core.recipe import ParallelismConfig as JPlan
from repro.data import DataConfig as JDataConfig
from repro.models import init_params as jinit_params
from repro.session.train import TrainSession as RefTrainSession
from repro_torch.checkpoint import bridge, store
from repro_torch.checkpoint.bridge import params_from_numpy, state_from_numpy, state_to_numpy
from repro_torch.core import pipeline
from repro_torch.core.recipe import ParallelismConfig
from repro_torch.core.tree import tree_map
from repro_torch.data import DataConfig
from repro_torch.session import TrainSession
from test_torch_moe import _cfgs, _flat, _train_cfgs
from test_torch_moe_mesh import _ref_groups

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke  # noqa: E402  (the message counts phase 25 asserts on the card)

SEQ, BATCH, GAS = 32, 8, 4
# the configs under test: olmoe at 4 of its layers, deepseek at 6 with 2
# dense unstacked ones ahead of an even stack of 4
SHAPES = {"olmoe": ("olmoe_1b_7b", dict(n_layers=4)),
          "deepseek": ("deepseek_moe_16b", dict(n_layers=6, first_k_dense=2))}


def _batch(seed=0, vocab=256):
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, vocab, (BATCH, SEQ)).astype(np.int32),
            "labels": rng.integers(0, vocab, (BATCH, SEQ)).astype(np.int32)}


@functools.lru_cache(maxsize=None)
def _setup(name):
    arch, kw = SHAPES[name]
    jcfg, cfg = _cfgs(arch, **kw)
    jparams = jinit_params(jcfg, jax.random.PRNGKey(0))
    return jcfg, cfg, jparams, _flat(jparams)


def _ref_loss_and_grads(jcfg, jparams, batch, plan):
    stacked = dict(jparams, blocks=jpipe.stack_for_pipeline(jparams["blocks"], plan.pp, plan.vpp))
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    (loss, m), g = jax.value_and_grad(lambda p: jpipe.pipeline_loss(jcfg, p, jb, plan),
                                      has_aux=True)(stacked)
    return ({"loss": float(loss), "xent": float(m["xent"]), "aux": float(m["aux"])},
            bridge.unstack_pipeline(_flat(g), plan))


def _port_loss_and_grads(cfg, flat, batch, plan):
    """``pipeline_loss`` (forwards only), then the 1F1B passes' gradients:
    each backward seeded with 1 / Σ mask and AUX_LOSS_COEF / gas."""
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    loss, m = pipeline.pipeline_loss(cfg, params_from_numpy(flat), tb, plan)
    params = tree_map(lambda x: x.clone().requires_grad_(), params_from_numpy(flat))
    micro = pipeline.split_micros(tb, plan.gas)
    out = pipeline.run_pipeline(cfg, plan, params,
                                [{k: x[i] for k, x in micro.items()} for i in range(plan.gas)],
                                seed=1.0 / pipeline.denominator(tb), aux_seed=0.01 / plan.gas)
    assert float(out["aux"]) / plan.gas == float(m["aux"])
    return ({"loss": float(loss), "xent": float(m["xent"]), "aux": float(m["aux"])},
            state_to_numpy(tree_map(lambda p: p.grad, params)))


@pytest.mark.parametrize("name,vpp,remat", [
    ("olmoe", 1, "full"), ("olmoe", 2, "full"), ("olmoe", 2, "stage"), ("deepseek", 1, "full")],
    ids=["olmoe-vpp1", "olmoe-vpp2", "olmoe-vpp2-stage", "deepseek-pre2-vpp1"])
def test_pipeline_loss_and_grads_match_reference(name, vpp, remat):
    """Loss, xent and aux 1e-5 relative; every gradient 5e-4 (the router's,
    the experts', deepseek's shared experts' and its ``pre_blocks``'), the
    routers' atol 2e-6 and rtol 2e-4; the router of every layer, on both
    stages, takes a nonzero gradient."""
    jcfg, cfg, jparams, flat = _setup(name)
    batch = _batch()
    want_m, want_g = _ref_loss_and_grads(jcfg, jparams, batch,
                                         JPlan(pp=2, gas=GAS, vpp=vpp, remat_policy=remat))
    got_m, got_g = _port_loss_and_grads(cfg, flat, batch,
                                        ParallelismConfig(pp=2, gas=GAS, vpp=vpp,
                                                          remat_policy=remat))
    for k in ("loss", "xent", "aux"):
        np.testing.assert_allclose(got_m[k], want_m[k], rtol=1e-5, err_msg=k)
    assert want_m["aux"] > 0
    assert set(got_g) == set(want_g)
    for k, w in want_g.items():
        np.testing.assert_allclose(got_g[k], w, atol=5e-4, rtol=5e-4, err_msg=k)
    # the load-balance loss's part of a router's gradient is near 5e-4 in
    # places: the routers are held to the test_pipeline.py tolerances
    router = got_g["blocks/moe/router"]
    np.testing.assert_allclose(router, want_g["blocks/moe/router"], atol=2e-6, rtol=2e-4)
    assert router.shape[0] == cfg.n_layers - cfg.first_k_dense
    assert all(np.abs(r).max() > 0 for r in router)
    if name == "deepseek":
        assert any(k.startswith("pre_blocks/1/") and np.abs(v).max() > 0
                   for k, v in got_g.items())


def test_unsplittable_stack_raises_in_both():
    """deepseek at its reduced depth: 2 layers, 1 of them unstacked, so a
    stack of 1 that pp 2 cannot split: the reference asserts, the port
    raises a ``ValueError`` naming the stack."""
    jcfg, cfg = _cfgs("deepseek_moe_16b")
    batch = _batch()
    with pytest.raises(ValueError, match="stacked blocks"):
        pipeline.pipeline_loss(cfg, params_from_numpy(_flat(jinit_params(
            jcfg, jax.random.PRNGKey(0)))), {k: torch.from_numpy(v) for k, v in batch.items()},
            ParallelismConfig(pp=2, gas=2))
    with pytest.raises(AssertionError, match="not divisible by pp"):
        jpipe.stack_for_pipeline(jinit_params(jcfg, jax.random.PRNGKey(0))["blocks"], 2)


# ===========================================================================
# steps: the reference's TrainSession at pp 2
# ===========================================================================

EVAL_STEP = 7


@functools.lru_cache(maxsize=None)
def _ref_session(name, groups=1):
    """The reference at pp 2 on one device, its batches routed in
    ``groups`` groups a micro-batch; → (its initial canonical state, the
    metrics of three steps, its canonical state after them, its
    ``pipeline_loss`` metrics on batch ``EVAL_STEP`` after them, each
    micro-batch routed as one group)."""
    arch, kw = SHAPES[name]
    jcfg, _ = _cfgs(arch, **kw)
    jplan = JPlan(pp=2, gas=GAS)
    ref = RefTrainSession(jcfg, plan=jplan, seed=5, train_cfg=_train_cfgs()[0],
                          data_cfg=JDataConfig(seq_len=SEQ, global_batch=BATCH, seed=7))
    initial = bridge.unstack_pipeline(_flat(ref.state), jplan)
    with _ref_groups(groups):
        metrics = [{k: float(v) for k, v in ref.step().items()} for _ in range(3)]
    _, ev = jpipe.pipeline_loss(jcfg, ref.state["params"],
                                {k: jnp.asarray(v) for k, v in ref.batches(EVAL_STEP).items()},
                                jplan)
    return (initial, metrics, bridge.unstack_pipeline(_flat(ref.state), jplan),
            {k: float(v) for k, v in ev.items()})


def _port_session(name, plan, mesh=None):
    arch, kw = SHAPES[name]
    _, cfg = _cfgs(arch, **kw)
    return TrainSession(cfg, plan=plan, mesh=mesh, device="cpu", train_cfg=_train_cfgs()[1],
                        data_cfg=DataConfig(seq_len=SEQ, global_batch=BATCH, seed=7))


def _params_close(got, want, lr):
    """Every parameter within 1e-5 (entries whose gradient sits at the f32
    noise floor held to 2·lr)."""
    for key, w in want.items():
        if not key.startswith("params/"):
            continue
        g_ref = np.abs(want["opt/m/" + key[len("params/"):]]) / 0.1
        noise = g_ref <= 1e-6 * g_ref.max()
        d = np.abs(got[key] - w)
        ok = d <= 1e-5 + 1e-5 * np.abs(w)
        assert (ok | (noise & (d <= 2 * lr))).all(), key


def test_three_steps_in_one_process_match_reference():
    """olmoe at pp 2 (vpp 2) without a mesh: three steps' metrics (the
    load-balance loss among them) 1e-5 and params 1e-5."""
    initial, metrics, after, _ = _ref_session("olmoe")
    sess = _port_session("olmoe", ParallelismConfig(pp=2, gas=GAS, vpp=2))
    sess.state = state_from_numpy(initial)
    for mr in metrics:
        mp = sess.step()
        for k in ("loss", "xent", "aux", "grad_norm", "skipped"):
            np.testing.assert_allclose(float(mp[k]), mr[k], rtol=1e-5, atol=1e-7, err_msg=k)
    _params_close(state_to_numpy(sess.state), after, metrics[-1]["lr"])


# ===========================================================================
# over gloo
# ===========================================================================

# (case, world, config, mesh keywords, plan keywords, reference groups)
CASES = [
    ("olmoe-pp2", 2, "olmoe", dict(pp=2), dict(), 1),
    ("deepseek-pp2", 2, "deepseek", dict(pp=2), dict(), 1),
    ("olmoe-pp2-dp2", 4, "olmoe", dict(pp=2), dict(dp=2, zero_stage=1), 2),
]
CASE_IDS = [c[0] for c in CASES]


def _spec(case):
    return dict((c[0], c) for c in CASES)[case]


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """The inputs first (the ranks read them), then the worlds of 2 and 4,
    then the reference's runs while they train."""
    tmp = tmp_path_factory.mktemp("moe_pp")
    refs = {}
    for name in SHAPES:
        _, kw = SHAPES[name]
        jcfg, _ = _cfgs(SHAPES[name][0], **kw)
        ref = RefTrainSession(jcfg, plan=JPlan(pp=2, gas=GAS), seed=5,
                              data_cfg=JDataConfig(seq_len=SEQ, global_batch=BATCH, seed=7))
        np.savez(tmp / f"{name}_init.npz", **bridge.unstack_pipeline(_flat(ref.state),
                                                                      JPlan(pp=2, gas=GAS)))
    env = {**os.environ, "PYTHONPATH": os.pathsep.join([str(ROOT / "src"), str(ROOT / "tests")]),
           "JAX_PLATFORMS": "cpu", "OMP_NUM_THREADS": "1"}
    procs = {}
    for world in (2, 4):
        code = f"import test_torch_moe_pipeline as t; t._rank_main({world}, {str(tmp)!r})"
        procs[world] = [subprocess.Popen([sys.executable, "-c", code],
                                         env={**env, "RANK": str(r)}, stdout=subprocess.PIPE,
                                         stderr=subprocess.STDOUT, text=True)
                        for r in range(world)]
    for case, _, name, _, _, groups in CASES:
        if (name, groups) not in refs:
            refs[(name, groups)] = _ref_session(name, groups)
    for world, ps in procs.items():
        for r, p in enumerate(ps):
            try:
                log = p.communicate(timeout=300)[0]
            except subprocess.TimeoutExpired:
                for q in ps:
                    q.kill()
                raise
            assert p.returncode == 0, f"world {world} rank {r}:\n{log[-4000:]}"
    return SimpleNamespace(tmp=tmp, refs={c[0]: refs[(c[2], c[5])] for c in CASES})


def _rank_main(world, tmp):
    """One rank: every case of its world through ``TrainSession.run`` (three
    steps, a checkpoint at the third), results under ``tmp``."""
    import torch.distributed as dist
    from repro_torch.checkpoint.elastic import host_snapshot, reshard_state
    from repro_torch.core import tp
    from repro_torch.launch.mesh import make_recipe_mesh
    tmp = Path(tmp)
    rank = int(os.environ["RANK"])
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{tmp}/store{world}", rank=rank,
                            world_size=world)
    mesh = make_recipe_mesh(pp=2, device_type="cpu")
    for case, w, name, _, plan_kw, _ in CASES:
        if w != world:
            continue
        plan = ParallelismConfig(pp=2, gas=GAS, **plan_kw)
        sess = _port_session(name, plan, mesh)
        sess.state = reshard_state(state_from_numpy(dict(np.load(tmp / f"{name}_init.npz"))),
                                   plan, mesh=mesh, cfg=sess.cfg)
        tp.reset()
        out = sess.run(3, ckpt_dir=str(tmp / f"ck_{case}"), ckpt_every=3, async_ckpt=False,
                       log_every=1, log=lambda _m: None)
        got = {f"metric{i}/{k}": np.asarray(float(v)) for i, h in enumerate(out["history"])
               for k, v in h.items() if isinstance(v, (int, float))}
        got["counts"] = np.array(json.dumps({"got": dict(tp.by_group),
                                             "bytes": dict(tp.bytes_by_group),
                                             "coords": mesh.coords}))
        got.update({f"eval/{k}": np.asarray(float(v))
                    for k, v in sess.evaluate(sess.batches(EVAL_STEP)).items()})
        got.update(host_snapshot(sess.state, plan, mesh=mesh, cfg=sess.cfg))
        np.savez(tmp / f"{case}_r{rank}.npz", **got)
    dist.barrier()
    dist.destroy_process_group()


def _got(worlds, case, rank=0):
    return dict(np.load(worlds.tmp / f"{case}_r{rank}.npz"))


@pytest.mark.parametrize("case", CASE_IDS)
def test_mesh_steps_match_reference(worlds, case):
    """Three steps over gloo: each step's loss, xent and aux 1e-5 relative;
    the parameters after them 1e-5 against the reference's TrainSession at
    pp 2 (its steps routing in the case's groups); every rank the same
    losses and the same parameters."""
    _, world, _, _, _, _ = _spec(case)
    _, metrics, after, _ = worlds.refs[case]
    got = _got(worlds, case)
    for i, mr in enumerate(metrics):
        for k in ("loss", "xent", "aux"):
            np.testing.assert_allclose(got[f"metric{i}/{k}"], mr[k], rtol=1e-5, err_msg=(i, k))
    _params_close(got, after, metrics[-1]["lr"])
    for r in range(1, world):
        other = _got(worlds, case, r)
        for i in range(3):
            assert float(other[f"metric{i}/loss"]) == float(got[f"metric{i}/loss"])
        for k in got:
            if k.startswith("params/"):
                np.testing.assert_array_equal(other[k], got[k], err_msg=(r, k))


@pytest.mark.parametrize("case", CASE_IDS)
def test_mesh_eval_matches_reference(worlds, case):
    """``evaluate`` after the three steps runs the pipeline's forwards on
    every rank (under dp each replica takes the micro-batches whole: the
    reference's eval routes a micro-batch as one group): xent and aux equal
    the reference's ``pipeline_loss`` on its trained weights (1e-5
    relative), on every rank."""
    _, world, _, _, _, _ = _spec(case)
    want = worlds.refs[case][3]
    for r in range(world):
        got = _got(worlds, case, r)
        for k in ("xent", "aux"):
            np.testing.assert_allclose(got[f"eval/{k}"], want[k], rtol=1e-5, err_msg=(r, k))


@pytest.mark.parametrize("case", CASE_IDS)
def test_mesh_messages_exact(worlds, case):
    """Each rank's sends and receives over the pp line and their bytes are
    three steps of ``chip_smoke.expected_pp_p2p``'s."""
    _, world, name, _, plan_kw, _ = _spec(case)
    cfg = _setup(name)[1]
    dp = plan_kw.get("dp", 1)
    for r in range(world):
        c = json.loads(str(_got(worlds, case, r)["counts"]))
        n, nbytes = chip_smoke.expected_pp_p2p(2, 1, GAS, c["coords"]["pp"], mbs=BATCH // GAS // dp,
                                               seq=SEQ, d_model=cfg.d_model, itemsize=4)
        for k in n:
            assert c["got"][k] == 3 * n[k] and c["bytes"][k] == 3 * nbytes[k], (r, k)


@pytest.mark.parametrize("case", CASE_IDS)
def test_mesh_checkpoint_restores_in_reference_and_at_pp1(worlds, case):
    """The step-3 checkpoint of the mesh holds the reference's canonical
    layout (the expert stacks ``(L, E, ...)``, deepseek's unstacked
    ``pre_blocks/<i>``): the reference's store restores it, restacks it at
    pp 2 and holds the mesh's bits; the port restores it on one device at
    pp 1 (the elastic re-plan) with the same bits."""
    _, _, name, _, _, _ = _spec(case)
    ck = worlds.tmp / f"ck_{case}"
    assert store.list_steps(ck) == [3]
    want = _got(worlds, case)
    jcfg = _setup(name)[0]
    template = jstepfn.init_state(jcfg, JPlan(), jax.random.PRNGKey(0))
    jstate, extra, step = jstore.restore_latest(ck, template, log=lambda _m: None)
    assert step == 3 and extra["next_step"] == 3
    flat = _flat(jstate)
    assert flat["params/blocks/moe/w_gate"].shape[:2] == (jcfg.n_layers - jcfg.first_k_dense,
                                                          jcfg.n_experts)
    if jcfg.first_k_dense:
        assert "params/pre_blocks/1/mlp/w_gate" in flat
    for k, v in flat.items():
        np.testing.assert_array_equal(v, want[k], err_msg=k)
    from repro.checkpoint import elastic as jelastic
    restacked = _flat(jelastic.reshard_state(jstate, JPlan(pp=2, gas=GAS)))
    assert restacked["params/blocks/moe/router"].shape[:2] == (2, (jcfg.n_layers
                                                                   - jcfg.first_k_dense) // 2)
    one = _port_session(name, ParallelismConfig(gas=GAS))
    restored, _, step = store.restore_latest(ck, one.state, log=lambda _m: None)
    assert step == 3
    for k, v in state_to_numpy(restored).items():
        np.testing.assert_array_equal(v, want[k], err_msg=k)
