"""The port's MoE family over gloo, against the JAX reference, on the CPU.

Reduced ``olmoe_1b_7b`` and ``deepseek_moe_16b`` in f32, the same
numpy-seeded state in both packages:

* one world of two ranks, spawned once: tp 2 (expert parallel without
  sequence parallel, and under it with shared experts and with 3 experts
  that tp leaves whole) against the reference on one device, and dp 2 (two
  routing groups: the GAS path at ZeRO 1 and 3, and the vote) against the
  reference whose steps route in ``moe_groups(2)``: one step each, and on
  the tp and GAS cases ``evaluate`` (one group, as the reference's eval
  step), the prefill logits and the greedy tokens of ``generate`` (on dp 2
  in two groups);
* in the same world, a dense stack's ``EvalSession`` built from a seed on a
  pp 2 mesh (each stage drawing every block and keeping its own) gives the
  reference's xent on the one-device weights of that seed.
"""

import contextlib
import dataclasses
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

from repro.configs import get_config as jget_config
from repro.core import stepfn as jstepfn
from repro.models import moe as jmoe
from repro.session.evalsess import EvalSession as RefEval
from repro.session.infer import InferenceSession as RefInference
from repro_torch.checkpoint.bridge import params_from_numpy, state_from_numpy, state_to_numpy
from repro_torch.configs import get_config
from repro_torch.core import sharding, tp, zero
from repro_torch.core.recipe import ParallelismConfig
from repro_torch.core.tree import tree_leaves
from repro_torch.data import DataConfig
from repro_torch.session import EvalSession, InferenceSession, TrainSession
from test_torch_moe import (BATCH, GAS, SEQ, _cfgs, _flat, _ref_batch, _ref_session,
                            _ref_steps, _train_cfgs, store_unflatten)

ROOT = Path(__file__).resolve().parents[1]

# ===========================================================================
# over gloo: tp 2 (expert parallel), dp 2 (routing groups), pp 2 (eval build)
# ===========================================================================

# (case, arch, plan keywords, config keywords, resilience, reference groups)
CASES = [
    ("olmoe-tp2-nosp", "olmoe_1b_7b", dict(tp=2), {}, {}, 1),
    ("deepseek-tp2-sp", "deepseek_moe_16b", dict(tp=2, sequence_parallel=True), {}, {}, 1),
    ("olmoe_e3-tp2-sp", "olmoe_1b_7b", dict(tp=2, sequence_parallel=True),
     dict(n_experts=3), {}, 1),
    ("olmoe-dp2-z1", "olmoe_1b_7b", dict(dp=2, zero_stage=1), {}, dict(consensus=False), 2),
    ("deepseek-dp2-z3", "deepseek_moe_16b", dict(dp=2, zero_stage=3), {},
     dict(consensus=False), 2),
    ("olmoe-dp2-vote", "olmoe_1b_7b", dict(dp=2, zero_stage=1), {},
     dict(consensus_replicas=2), 2),
]
CASE_IDS = [c[0] for c in CASES]
# the cases that also evaluate, prefill and generate
SERVED = ["olmoe-tp2-nosp", "deepseek-tp2-sp", "olmoe-dp2-z1", "deepseek-dp2-z3"]
# the dense stack whose EvalSession is built from a seed on a pp 2 mesh
PP_ARCH, PP_LAYERS, PP_SEED = "granite_3_2b", 4, 11


def _case_spec(case):
    return dict((c[0], c) for c in CASES)[case]


@contextlib.contextmanager
def _ref_groups(n):
    """The reference's steps routing in ``n`` groups on one device (its
    steps set ``moe_groups(dp·pods)`` only on a mesh)."""
    real = jstepfn.moe_groups
    jstepfn.moe_groups = lambda _n: jmoe.moe_groups(n)
    try:
        yield
    finally:
        jstepfn.moe_groups = real


def _setting(case):
    """What the reference's result depends on: tp and sequence parallel
    leave it as one device's."""
    _, arch, plan_kw, cfg_kw, res, groups = _case_spec(case)
    return arch, tuple(sorted(cfg_kw.items())), tuple(sorted(res.items())), groups, \
        case in SERVED


def _one_device(case):
    """Whether the reference for ``case`` is ``_ref_steps``' (its config,
    resilience and routing as one device's)."""
    _, cfg_kw, res, groups, _ = _setting(case)
    return not cfg_kw and not res and groups == 1


def _reference(case, sessions, tmp):
    """One reference step from the case's state, and for a served case the
    eval metrics, the prefill logits and the greedy tokens of the state's
    weights, the steps routing in the case's groups."""
    arch, cfg_kw, _, groups, serve = _setting(case)
    jcfg, _ = _cfgs(arch, **dict(cfg_kw))
    out = {}
    if _one_device(case):
        steps = _ref_steps(arch, 1)
        params, batch = steps.params, steps.batch
        out["metrics"], out["state"] = steps.metrics[0], steps.after1
    else:
        ref = sessions[_setting(case)]
        with _ref_groups(groups):
            params = jax.tree_util.tree_map(lambda x: jnp.array(x, copy=True),
                                            ref.state["params"])
            batch = ref.batches(0)
            out["metrics"] = {k: float(v) for k, v in ref.step(batch).items()}
        out["state"] = _flat(ref.state)
    if serve:
        with _ref_groups(groups):
            out["eval"] = {k: float(RefEval(jcfg, params=params).evaluate(batch)[k])
                           for k in ("xent", "aux")}
            inf = RefInference.from_params(jcfg, params)
            out["prefill"] = np.asarray(inf.prefill({"tokens": batch["tokens"]},
                                                    last_only=False))
            out["tokens"] = np.asarray(inf.generate(np.load(tmp / "prompts.npy"), 6))
    return out


def _pp_cfgs():
    return (dataclasses.replace(jget_config(PP_ARCH).reduced(), n_layers=PP_LAYERS),
            dataclasses.replace(get_config(PP_ARCH).reduced(), n_layers=PP_LAYERS))


def _pp_reference(tmp):
    """The reference's xent on the one-device weights of ``PP_SEED`` (the
    port's one-device ``EvalSession`` bridged), and that session's own."""
    jcfg, cfg = _pp_cfgs()
    batch = dict(np.load(tmp / "pp_batch.npz"))
    one = EvalSession(cfg, seed=PP_SEED, device="cpu")
    flat = state_to_numpy({"params": one.params})
    params = jax.tree_util.tree_map(jnp.asarray, store_unflatten(
        {k[len("params/"):]: v for k, v in flat.items()}))
    return {"xent": float(RefEval(jcfg, params=params).evaluate(batch)["xent"]),
            "port": float(one.evaluate(batch)["xent"])}


def _write_inputs(tmp):
    """Each case's initial state and batch for the ranks → the reference
    sessions, one per setting."""
    np.save(tmp / "prompts.npy",
            np.random.RandomState(9).randint(0, 256, (4, 10)).astype(np.int32))
    np.savez(tmp / "pp_batch.npz", **_ref_batch(_pp_cfgs()[0]))
    sessions = {}
    for case, arch, _, cfg_kw, res, _ in CASES:
        if _one_device(case):
            steps = _ref_steps(arch, 1)
            state, batch = steps.initial, steps.batch
        else:
            key = _setting(case)
            if key not in sessions:
                sessions[key] = _ref_session(_cfgs(arch, **cfg_kw)[0], **res)
            state, batch = _flat(sessions[key].state), sessions[key].batches(0)
        np.savez(tmp / f"{case}_state.npz", **state)
        np.savez(tmp / f"{case}_batch.npz", **batch)
    return sessions


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The world of two run once: inputs written, ranks started, the
    references computed while they run."""
    tmp = tmp_path_factory.mktemp("moe")
    sessions = _write_inputs(tmp)
    env = {**os.environ, "PYTHONPATH": os.pathsep.join([str(ROOT / "src"), str(ROOT / "tests")]),
           "JAX_PLATFORMS": "cpu", "OMP_NUM_THREADS": "1"}
    code = f"import test_torch_moe_mesh as t; t._rank_main({str(tmp)!r})"
    procs = [subprocess.Popen([sys.executable, "-c", code], env={**env, "RANK": str(r)},
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(2)]
    done = {}
    for case in CASE_IDS:
        if _setting(case) not in done:
            done[_setting(case)] = _reference(case, sessions, tmp)
    refs = {case: done[_setting(case)] for case in CASE_IDS}
    pp = _pp_reference(tmp)
    logs = []
    for r, p in enumerate(procs):
        try:
            logs.append(p.communicate(timeout=300)[0])
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        assert p.returncode == 0, f"rank {r}:\n{logs[-1][-4000:]}"
    return SimpleNamespace(tmp=tmp, refs=refs, pp=pp)


def _rank_main(tmp):
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_recipe_mesh
    tmp = Path(tmp)
    rank = int(os.environ["RANK"])
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{tmp}/store", rank=rank,
                            world_size=2)
    meshes = {"tp": make_recipe_mesh(tp=2, device_type="cpu"),
              "dp": make_recipe_mesh(pods=1, tp=1, device_type="cpu")}
    for case, arch, plan_kw, cfg_kw, res, _ in CASES:
        mesh = meshes["tp" if "tp" in plan_kw else "dp"]
        np.savez(tmp / f"{case}_r{rank}.npz", **_rank_case(case, mesh, tmp))
    _, cfg = _pp_cfgs()
    ev = EvalSession(cfg, plan=ParallelismConfig(pp=2, gas=2), seed=PP_SEED, device="cpu",
                     mesh=make_recipe_mesh(pp=2, device_type="cpu"))
    np.savez(tmp / f"pp_r{rank}.npz", n_blocks=np.array(len(ev.params["blocks"])),
             xent=np.array(float(ev.evaluate(dict(np.load(tmp / "pp_batch.npz")))["xent"])))
    dist.barrier()
    dist.destroy_process_group()


def _rank_case(case, mesh, tmp):
    _, arch, plan_kw, cfg_kw, res, _ = _case_spec(case)
    _, cfg = _cfgs(arch, **cfg_kw)
    plan = ParallelismConfig(gas=GAS, **plan_kw)
    hints = zero.family_hints(cfg)
    flat = dict(np.load(tmp / f"{case}_state.npz"))
    batch = dict(np.load(tmp / f"{case}_batch.npz"))
    sess = TrainSession(cfg, plan=plan, mesh=mesh, device="cpu",
                        train_cfg=_train_cfgs(**res)[1],
                        data_cfg=DataConfig(seq_len=SEQ, global_batch=BATCH))
    state = state_from_numpy(flat)
    whole = state["params"]
    for tree, key in ((state, "params"), (state["opt"], "m"), (state["opt"], "v")):
        tree[key] = (sharding.shard_params(tree[key], mesh, plan, hints=hints) if key == "params"
                     else sharding.shard_state(tree[key], mesh, plan, hints=hints))
    sess.state = state
    out = {}
    local = sess.state["params"]
    back = sharding.gather_params(local, mesh, plan, cfg.vocab_size, cfg.d_model, hints=hints)
    out["roundtrip_bitwise"] = np.array(all(
        torch.equal(a, b) for (_, a), (_, b) in zip(tree_leaves(back), tree_leaves(whole))))
    out["n_sharded"] = np.array(sum(x.shape != dict(tree_leaves(whole))[p].shape
                                    for p, x in tree_leaves(local)))
    if case in SERVED:
        metrics = EvalSession.from_train_session(sess).evaluate(batch)
        for k in ("xent", "aux"):
            out[f"eval/{k}"] = np.asarray(float(metrics[k]))
    tp.reset()
    for k, v in sess.step(batch).items():
        out[f"metric/{k}"] = np.asarray(float(v))
    out["counts"] = np.array(json.dumps(dict(tp.by_group)))
    tree = sharding.gather_params(sess.state["params"], mesh, plan, cfg.vocab_size, cfg.d_model,
                                  hints=hints)
    out.update(state_to_numpy({"params": tree}))
    if case in SERVED:
        inf = InferenceSession.from_params(cfg, params_from_numpy(
            {k[len("params/"):]: v for k, v in flat.items() if k.startswith("params/")}),
            plan=plan, mesh=mesh, device="cpu")
        out["prefill"] = inf.prefill({"tokens": batch["tokens"]}, last_only=False).numpy()
        out["tokens"] = inf.generate(np.load(tmp / "prompts.npy"), 6).numpy()
    return out


def _got(world, case, rank=0):
    return dict(np.load(world.tmp / f"{case}_r{rank}.npz"))

@pytest.mark.parametrize("case", CASE_IDS)
def test_step_over_gloo_matches_reference(world, case):
    """One AdamW step (gas 2): loss, xent, aux and the gate's metrics 1e-5;
    every parameter 1e-5 (entries whose gradient is at the f32 noise floor
    held to 2·lr); the same loss on both ranks; the shards gather back to
    the bridged weights bit for bit."""
    _, arch, plan_kw, cfg_kw, _, _ = _case_spec(case)
    got, other = _got(world, case), _got(world, case, 1)
    want = world.refs[case]
    assert bool(got["roundtrip_bitwise"])
    if "tp" in plan_kw:
        assert int(got["n_sharded"]) > 0
    for k in ("loss", "xent", "aux", "grad_norm", "lr", "skipped", "n_replicas"):
        np.testing.assert_allclose(got[f"metric/{k}"], want["metrics"][k], rtol=1e-5,
                                   atol=1e-7, err_msg=k)
    assert float(other["metric/loss"]) == float(got["metric/loss"])
    lr = want["metrics"]["lr"]
    for key, w in want["state"].items():
        if not key.startswith("params/"):
            continue
        g_ref = np.abs(want["state"]["opt/m/" + key[len("params/"):]]) / 0.1
        noise = g_ref <= 1e-6 * g_ref.max()
        d = np.abs(got[key] - w)
        ok = d <= 1e-5 + 1e-5 * np.abs(w)
        assert (ok | (noise & (d <= 2 * lr))).all(), key


@pytest.mark.parametrize("case", SERVED)
def test_serving_over_gloo_matches_reference(world, case):
    """Eval xent and aux (1e-5), prefill logits (1e-5) and greedy tokens
    (exact) under expert parallelism and in dp 2's two routing groups, on
    both ranks."""
    want = world.refs[case]
    for rank in (0, 1):
        got = _got(world, case, rank)
        for k in ("xent", "aux"):
            np.testing.assert_allclose(got[f"eval/{k}"], want["eval"][k], rtol=1e-5, err_msg=k)
        np.testing.assert_allclose(got["prefill"], want["prefill"], atol=1e-5, rtol=1e-5)
        np.testing.assert_array_equal(got["tokens"], want["tokens"])


def test_collectives_over_gloo(world):
    """Expert parallel: without sequence parallel the MoE layer's combine
    is all-reduced over tp (no all-gather); under it the tokens are
    gathered before the routing and the combine reduce-scattered after."""
    counts = {case: json.loads(str(_got(world, case)["counts"])) for case in CASE_IDS}
    assert counts["olmoe-tp2-nosp"].get("all_gather@tp", 0) == 0
    assert counts["olmoe-tp2-nosp"]["all_reduce@tp"] > 0
    for case in ("deepseek-tp2-sp", "olmoe_e3-tp2-sp"):
        assert counts[case]["all_gather@tp"] > 0 and counts[case]["reduce_scatter@tp"] > 0


def test_eval_session_from_seed_on_a_pp_mesh(world):
    """Each stage keeps its own half of the 4 blocks it draws, and the
    pipeline's eval gives the reference's xent on the one-device weights of
    the same seed (1e-5), on both ranks."""
    np.testing.assert_allclose(world.pp["port"], world.pp["xent"], rtol=1e-5)
    for rank in (0, 1):
        got = dict(np.load(world.tmp / f"pp_r{rank}.npz"))
        assert int(got["n_blocks"]) == PP_LAYERS // 2
        np.testing.assert_allclose(float(got["xent"]), world.pp["xent"], rtol=1e-5)
