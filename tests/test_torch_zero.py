"""The port's sharded data parallelism (ZeRO 1-3, dp and pods on the mesh,
the consensus vote over real replicas, the checkpoint of a sharded state)
against the JAX reference, on the CPU.

Five parts, mirroring ``tests/test_torch_tp.py``:

* **The rules**, with ``==`` and no process group: for every leaf of the
  seven ported configs, full size and reduced, ``zero.param_shardings`` and
  ``zero.opt_shardings`` give the reference's specs (its side through
  ``jax.eval_shape`` on an abstract mesh) at dp 2, 4 and 8, pods 2, zero 1
  and 3, tp 1 and 2.
* **The numerics**, over gloo: one fixture starts a world of 2 ranks and
  one of 4 (``python`` subprocesses), which run every case of their world
  and write what they saw; the parametrised tests read it.  Each case is
  one AdamW step at gas 2 from the reference's weights, held to the
  reference on one device: loss 1e-5 relative, the skip gate's metrics,
  params 1e-5 (Adam's noise-floor entries held to 2·lr and counted), the
  int8 error feedback but for rounding ties.
* **The stages against each other**: at dp 2 in f32 ZeRO 1-3 give ZeRO 0's
  bits where each sum has the same two addends (the vote at gas 2, the
  GAS path at gas 1, and ZeRO 1-2 on the GAS path at gas 2); ZeRO-3's
  per-micro-batch reduce-scatter on the GAS path at gas 2, and dp 4, within
  1e-5.
* **The vote** over real replicas: the same bits on every rank and the
  bits of the port's one-device ``consensus_replicas = 2``, for each bad
  replica, both bad and strict mode.
* **The checkpoint** of a ZeRO-3 dp 2 state: a crash and resume of
  ``TrainSession.run`` on the mesh is bitwise, the files load in the
  reference's store and restore at dp 1, and a one-device checkpoint
  restores at dp 2.  And the collectives a step by stage, against
  ``chip_smoke.expected_dp_collectives``, which phase 21 asserts on the card.
"""

import functools
import json
import os
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

from repro.checkpoint import store as jstore
from repro.configs import get_config as jget_config
from repro.core import stepfn as jstepfn
from repro.core import zero as jzero
from repro.core.recipe import ParallelismConfig as JPlan
from repro.data import DataConfig as JDataConfig
from repro.models import init_params as jinit_params
from repro.optim.adamw import AdamWConfig as JAdamW
from repro.session.train import TrainSession as RefTrainSession
from repro_torch.checkpoint import store
from repro_torch.checkpoint.bridge import state_from_numpy
from repro_torch.configs import PORTED, get_config
from repro_torch.core import stepfn, zero
from repro_torch.core.recipe import ParallelismConfig
from repro_torch.core.tree import tree_leaves
from repro_torch.data import DataConfig
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.runtime.resilience import ResilienceConfig

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke  # noqa: E402  (the collective counts phase 21 asserts on the card)

SEQ, BATCH, GAS = 32, 8, 2
LR = 1e-4
ARCHS = {"granite": "granite_3_2b", "gpt": "gpt_36b"}
# (case id, world, mesh, arch, plan keywords, vote, compression)
MESHES = {"dp2": dict(), "dp4": dict(), "tp2dp2": dict(tp=2), "pods2dp2": dict(pods=2)}
CASES = [
    *[(f"dp2-z{z}-{'vote' if v else 'gas'}", 2, "dp2", "granite", dict(zero_stage=z), v, None)
      for z in (0, 1, 2, 3) for v in (True, False)],
    ("dp2-z3-gas-g1", 2, "dp2", "granite", dict(zero_stage=3, gas=1), False, None),
    ("dp2-z0-gas-g1", 2, "dp2", "granite", dict(zero_stage=0, gas=1), False, None),
    ("dp2-z2-overlap", 2, "dp2", "granite", dict(zero_stage=2, overlap_zero=True), False, None),
    ("dp2-z3-once", 2, "dp2", "granite", dict(zero_stage=3, gather_params_once=True), False,
     None),
    ("dp2-z3-once-vote", 2, "dp2", "granite", dict(zero_stage=3, gather_params_once=True),
     True, None),
    ("dp2-z1-int8", 2, "dp2", "granite", dict(zero_stage=1), True, "int8_ef"),
    ("dp2-z3-int8", 2, "dp2", "granite", dict(zero_stage=3), False, "int8_ef"),
    ("dp2-gpt-z3-vote", 2, "dp2", "gpt", dict(zero_stage=3), True, None),
    ("dp4-z1-vote", 4, "dp4", "gpt", dict(zero_stage=1), True, None),
    ("dp4-z3-gas", 4, "dp4", "gpt", dict(zero_stage=3), False, None),
    ("dp4-z2-overlap", 4, "dp4", "gpt", dict(zero_stage=2, overlap_zero=True), False, None),
    ("tp2dp2-z1-vote", 4, "tp2dp2", "gpt", dict(zero_stage=1), True, None),
    ("tp2dp2-z3-gas-sp", 4, "tp2dp2", "gpt", dict(zero_stage=3, sequence_parallel=True),
     False, None),
    ("tp2dp2-z2-int8", 4, "tp2dp2", "granite", dict(zero_stage=2), True, "int8_ef"),
    ("pods2dp2-z1-vote", 4, "pods2dp2", "gpt", dict(zero_stage=1), True, None),
    ("pods2dp2-z3-gas", 4, "pods2dp2", "gpt", dict(zero_stage=3), False, None),
]
CASE_IDS = [c[0] for c in CASES]
# ZeRO 1-3 against ZeRO 0 at dp 2, f32: (case, its ZeRO-0 twin, bitwise)
STAGE_PAIRS = [(f"dp2-z{z}-vote", "dp2-z0-vote", True) for z in (1, 2, 3)] + \
              [(f"dp2-z{z}-gas", "dp2-z0-gas", z < 3) for z in (1, 2, 3)] + \
              [("dp2-z3-gas-g1", "dp2-z0-gas-g1", True)]
VOTES = ("bad0", "bad1", "both", "strict")
COUNTED = [(z, v) for z in (0, 1, 2, 3) for v in (True, False)]


def _flat(tree):
    return {k: np.asarray(v) for k, v in jstore._flatten(tree)}


def _train_cfgs(compression=None, vote=True, **rs):
    kw = dict(peak_lr=LR, warmup=2, total_steps=10, compression=compression)
    return (jstepfn.TrainConfig(adam=JAdamW(), **kw),
            stepfn.TrainConfig(adam=AdamWConfig(), resilience=ResilienceConfig(
                consensus=vote, **rs), **kw))


# ===========================================================================
# the rules, with ==
# ===========================================================================

MESH_SHAPES = [(2, 1, 1), (4, 1, 1), (8, 1, 1), (2, 2, 1), (2, 1, 2), (4, 1, 2), (8, 1, 2),
               (2, 2, 2)]


@functools.lru_cache(maxsize=None)
def _ref_params(arch, reduced):
    jcfg = jget_config(arch)
    jcfg = jcfg.reduced() if reduced else jcfg
    return jax.eval_shape(lambda k: jinit_params(jcfg, k), jax.random.PRNGKey(0))


def _jpaths(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {"/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path): leaf
            for path, leaf in flat}


STACKS = ("blocks", "enc_blocks", "dec_blocks")


def _pad(spec, n):
    spec = tuple(spec)
    return spec + (None,) * (n - len(spec))


@pytest.mark.parametrize("reduced", [False, True], ids=["full", "reduced"])
@pytest.mark.parametrize("zero_stage", [1, 3])
@pytest.mark.parametrize("arch", PORTED)
def test_zero_rules_equal_reference(arch, zero_stage, reduced):
    """Every leaf's parameter and optimizer-state spec equals the
    reference's (its stacked block leaves without the leading layer axis)
    at dp 2, 4 and 8, pods 2 and tp 1 and 2."""
    params = _ref_params(arch, reduced)
    shapes = _jpaths(params)
    # each stack's layers: ``blocks`` (none in the xLSTM, whose layers are
    # all unstacked), an encoder-decoder's ``enc_blocks`` and ``dec_blocks``
    n_layers = {s: shapes[f"{s}/attn/wq"].shape[0] for s in STACKS
                if f"{s}/attn/wq" in shapes}
    layer_axis = set()
    for dp, pods, tp_size in MESH_SHAPES:
        sizes = (pods, dp, 1, tp_size)
        names = ("pod", "data", "pp", "tp")
        jmesh = jax.sharding.AbstractMesh(sizes, names)
        jplan = JPlan(dp=dp, pods=pods, tp=tp_size, zero_stage=zero_stage)
        jcfg = jget_config(arch)
        jp = jzero.param_shardings(jcfg, params, jmesh, jplan)
        jo = jzero.opt_shardings(jp, params, jmesh, jplan)
        jp, jo = _jpaths(jp), _jpaths(jo)
        mesh = SimpleNamespace(shape=dict(zip(names, sizes)), axis_names=names)
        plan = ParallelismConfig(dp=dp, pods=pods, tp=tp_size, zero_stage=zero_stage)
        port_shapes = []
        for path, leaf in shapes.items():
            stack = path.split("/")[0]
            stacked = stack in STACKS
            port_shapes.append((tuple(path.replace(f"{stack}/", f"{stack}/0/", 1).split("/"))
                                if stacked else tuple(path.split("/")),
                                leaf.shape[1:] if stacked else leaf.shape))
        pp_ = zero.param_shardings(port_shapes, mesh, plan,
                                   hints=zero.family_hints(get_config(arch)))
        po = zero.opt_shardings(pp_, port_shapes, mesh, plan, n_layers)
        for (path, leaf), (ppath, shape) in zip(shapes.items(), port_shapes):
            k = 1 if path.split("/")[0] in STACKS else 0
            want_o = _pad(jo[path].spec, len(leaf.shape))
            assert _pad(pp_[ppath], len(shape)) == _pad(jp[path].spec, len(leaf.shape))[k:], \
                (arch, dp, pods, tp_size, path, "param")
            if k and want_o[0] is not None:
                # the reference spreads whole layers of this leaf's state
                # (its other dims as the parameter's); the port keeps it whole
                assert want_o[1:] == _pad(jp[path].spec, len(leaf.shape))[1:]
                assert po[ppath] == pp_[ppath]
                layer_axis.add(path)
            else:
                assert _pad(po[ppath], len(shape)) == want_o[k:], \
                    (arch, dp, pods, tp_size, path, "opt")
    # only qwen1.5's attention biases (one dim, carrying the tp axis), and
    # hymba's per-head SSM vectors (one dim, pinned whole by its hints) and,
    # at full size, its depthwise conv
    ssm = {"blocks/ssm/A_log", "blocks/ssm/D", "blocks/ssm/dt_bias"}
    assert layer_axis == {"qwen15_32b": {"blocks/attn/bq", "blocks/attn/bk", "blocks/attn/bv"},
                          "hymba_15b": ssm if reduced else ssm | {"blocks/ssm/conv"}
                          }.get(arch, set()), layer_axis


def test_zero_shard_on_the_layer_axis_keeps_the_state_whole():
    """A leaf whose only divisible dim is the stacking axis keeps the
    parameter's spec for its state (the reference would spread its layers)."""
    mesh = SimpleNamespace(shape={"pod": 1, "data": 2, "pp": 1, "tp": 1},
                           axis_names=("pod", "data", "pp", "tp"))
    shapes = [(("blocks", 0, "norm1", "scale"), (3,)), (("blocks", 0, "attn", "bq"), (4,))]
    plan = ParallelismConfig(dp=2)
    p = zero.param_shardings(shapes, mesh, plan)
    assert zero.opt_shardings(p, shapes, mesh, plan, 8) == {
        ("blocks", 0, "norm1", "scale"): (None,), ("blocks", 0, "attn", "bq"): ("tp",)}
    stacked = {path: zero.zero_shard((None,) + p[path], (8,) + shape, mesh, ("data",))
               for path, shape in shapes}
    assert stacked == {("blocks", 0, "norm1", "scale"): ("data", None),
                       ("blocks", 0, "attn", "bq"): ("data", "tp")}


# ===========================================================================
# the numerics over gloo
# ===========================================================================

def _ref_session(name, compression=None):
    return RefTrainSession(jget_config(ARCHS[name]).reduced(), plan=JPlan(gas=GAS), seed=5,
                           data_cfg=JDataConfig(seq_len=SEQ, global_batch=BATCH, seed=7),
                           train_cfg=_train_cfgs(compression)[0])


def _write_inputs(name, tmp):
    ref = _ref_session(name)
    np.savez(tmp / f"{name}_state.npz", **_flat(ref.state))
    np.savez(tmp / f"{name}_batch.npz", **ref.batches(0))


def _reference(name):
    out = {}
    for comp in (None, "int8_ef"):
        ref = _ref_session(name, comp)
        out[comp] = ({k: float(v) for k, v in ref.step(ref.batches(0)).items()},
                     _flat(ref.state))
    return out


def _start_world(world, tmp):
    env = {**os.environ, "PYTHONPATH": os.pathsep.join([str(ROOT / "src"), str(ROOT / "tests")]),
           "JAX_PLATFORMS": "cpu", "OMP_NUM_THREADS": "1"}
    code = f"import test_torch_zero as t; t._rank_main({world}, {str(tmp)!r})"
    return [subprocess.Popen([sys.executable, "-c", code], env={**env, "RANK": str(r)},
                             stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for r in range(world)]


def _one_device_votes(tmp):
    """The port's one-device ``consensus_replicas = 2`` on every vote case,
    from the reference's weights: {case: (metrics, params)}."""
    from repro_torch.session import TrainSession
    flat = dict(np.load(tmp / "granite_state.npz"))
    batch = dict(np.load(tmp / "granite_batch.npz"))
    out = {}
    for z in (1, 3):
        for case in VOTES:
            sess = TrainSession(get_config("granite_3_2b").reduced(), device="cpu",
                                plan=ParallelismConfig(gas=GAS, zero_stage=z),
                                train_cfg=_vote_cfg(case, replicas=2),
                                data_cfg=DataConfig(seq_len=SEQ, global_batch=BATCH))
            sess.state = state_from_numpy(flat)
            m = sess.step(dict(batch, _chaos_grad_scale=_vote_scale(case)))
            out[f"z{z}-{case}"] = ({k: float(v) for k, v in m.items()},
                                   {"/".join(map(str, p)): x.detach().clone()
                                    for p, x in tree_leaves(sess.state["params"])})
    return out


def _vote_cfg(case, replicas=0):
    return _train_cfgs(None, True, consensus_replicas=replicas,
                       mask_divergent_replicas=case != "strict")[1]


def _vote_scale(case):
    """Per (replica, micro-batch) gradient scale: NaN in the bad replicas."""
    bad = {"bad0": (0,), "bad1": (1,), "both": (0, 1), "strict": (1,)}[case]
    s = np.ones((2, GAS), np.float32)
    for r in bad:
        s[r] = np.nan
    return s.reshape(-1)


def _one_device_checkpoint(tmp):
    """A one-device port run of 2 steps checkpointed at step 2, and its
    state then (for the ranks to restore at dp 2)."""
    from repro_torch.checkpoint.bridge import state_to_numpy
    sess = _ckpt_session(None, None)
    sess.run(2, ckpt_dir=str(tmp / "ck_dp1"), ckpt_every=2, async_ckpt=False,
             log=lambda _m: None)
    np.savez(tmp / "ck_dp1_state.npz", **state_to_numpy(sess.state))


def _ckpt_session(mesh, plan):
    from repro_torch.session import TrainSession
    return TrainSession(get_config("granite_3_2b").reduced(), device="cpu", seed=3,
                        plan=plan or ParallelismConfig(), mesh=mesh,
                        train_cfg=stepfn.TrainConfig(peak_lr=1e-3, warmup=1, total_steps=8),
                        data_cfg=DataConfig(seq_len=SEQ, global_batch=4))


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """Each world run once: the inputs written first, the ranks started, the
    references computed while they run."""
    tmp = tmp_path_factory.mktemp("zero")
    for name in ARCHS:
        _write_inputs(name, tmp)
    _one_device_checkpoint(tmp)
    procs = {w: _start_world(w, tmp) for w in (2, 4)}
    refs = {name: _reference(name) for name in ARCHS}
    votes = _one_device_votes(tmp)
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
    return SimpleNamespace(tmp=tmp, refs=refs, votes=votes, logs=logs)


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
    for key, kw in MESHES.items():
        if (key == "dp2") == (world == 2):
            meshes[key] = make_recipe_mesh(device_type="cpu", **kw)
    for case, w, mesh, name, kw, vote, comp in CASES:
        if w == world:
            np.savez(tmp / f"{case}_r{rank}.npz",
                     **_rank_case(name, meshes[mesh], kw, vote, comp, tmp))
    extra = {"mesh": {k: {"shape": m.shape, "coords": m.coords, "plane": m.plane_index}
                      for k, m in meshes.items()}}
    if world == 2:
        mesh = meshes["dp2"]
        extra["votes"] = _rank_votes(mesh, tmp, rank)
        extra["counts"] = {f"z{z}-{'vote' if v else 'gas'}": _rank_counts(mesh, z, v)
                           for z, v in COUNTED}
        extra["ckpt"] = _rank_checkpoint(mesh, tmp, rank)
    (tmp / f"extra{world}_r{rank}.json").write_text(json.dumps(extra))
    dist.barrier()
    dist.destroy_process_group()


def _plan(mesh, **kw):
    return ParallelismConfig(tp=mesh.shape["tp"], dp=mesh.shape["data"],
                             pods=mesh.shape["pod"], **dict(dict(gas=GAS), **kw))


def _whole(sess):
    """The session's state, whole (gathered over the mesh), as numpy."""
    from repro_torch.checkpoint.elastic import host_snapshot
    return dict(host_snapshot(sess.state, sess.plan, mesh=sess.mesh, cfg=sess.cfg))


def _rank_case(name, mesh, kw, vote, comp, tmp):
    from repro_torch.checkpoint.elastic import reshard_state
    from repro_torch.session import TrainSession
    cfg = get_config(ARCHS[name]).reduced()
    plan = _plan(mesh, **kw)
    flat = dict(np.load(tmp / f"{name}_state.npz"))
    batch = dict(np.load(tmp / f"{name}_batch.npz"))
    sess = TrainSession(cfg, plan=plan, mesh=mesh, device="cpu",
                        train_cfg=_train_cfgs(comp, vote)[1],
                        data_cfg=DataConfig(seq_len=SEQ, global_batch=BATCH))
    state = state_from_numpy(flat)
    if comp:
        from repro_torch.optim.compress import init_error_feedback
        state["ef"] = init_error_feedback(state["params"])
    sess.state = reshard_state(state, plan, mesh=mesh)
    out = {f"metric/{k}": np.asarray(float(v)) for k, v in sess.step(batch).items()}
    for k, v in _whole(sess).items():
        if k.startswith(("params/", "opt/m/", "ef/")):
            out[k] = v
    return out


def _rank_votes(mesh, tmp, rank):
    """Each vote case at ZeRO 1 and 3: the metrics, and the whole params
    after the step written per rank."""
    from repro_torch.checkpoint.elastic import reshard_state
    from repro_torch.session import TrainSession
    flat = dict(np.load(tmp / "granite_state.npz"))
    batch = dict(np.load(tmp / "granite_batch.npz"))
    out = {}
    for z in (1, 3):
        for case in VOTES:
            plan = _plan(mesh, zero_stage=z)
            sess = TrainSession(get_config("granite_3_2b").reduced(), plan=plan, mesh=mesh,
                                device="cpu", train_cfg=_vote_cfg(case),
                                data_cfg=DataConfig(seq_len=SEQ, global_batch=BATCH))
            sess.state = reshard_state(state_from_numpy(flat), plan, mesh=mesh)
            m = sess.step(dict(batch, _chaos_grad_scale=_vote_scale(case)))
            out[f"z{z}-{case}"] = {k: float(v) for k, v in m.items()}
            np.savez(tmp / f"vote-z{z}-{case}_r{rank}.npz",
                     **{k: v for k, v in _whole(sess).items() if k.startswith("params/")})
    return out


def _rank_counts(mesh, z, vote):
    """The collectives of one train step of reduced gpt-3.6b at dp 2, gas
    2, by kind and group, with the expected ones from the session's layout."""
    from repro_torch.core import tp
    from repro_torch.session import TrainSession
    cfg = get_config("gpt_36b").reduced()
    plan = _plan(mesh, zero_stage=z)
    sess = TrainSession(cfg, plan=plan, mesh=mesh, device="cpu",
                        train_cfg=_train_cfgs(None, vote)[1],
                        data_cfg=DataConfig(seq_len=SEQ, global_batch=BATCH))
    sess.step()
    tp.reset()
    sess.step()
    layout = zero.Layout(cfg, plan, mesh, sess.state["params"])
    want = chip_smoke.expected_dp_collectives(layout, cfg.n_layers, GAS, vote=vote,
                                              remat=plan.remat_policy)
    return {"got": dict(tp.by_group), "bytes": dict(tp.bytes_by_group), "want": want}


def _rank_checkpoint(mesh, tmp, rank):
    """ZeRO-3 at dp 2: crash at step 3 after a checkpoint at step 2, resume
    in a fresh session, against an uninterrupted run; then a one-device
    checkpoint restored on the mesh."""
    plan = _plan(mesh, zero_stage=3, gas=1)
    ck = tmp / "ck_dp2"
    events = {}
    sess = _ckpt_session(mesh, plan)
    try:
        sess.run(4, ckpt_dir=str(ck), ckpt_every=2, fail_at_step=3, log=lambda _m: None)
        crashed = False
    except RuntimeError as e:
        crashed = "injected failure at step 3" in str(e)
    sess = _ckpt_session(mesh, plan)
    out = sess.run(4, ckpt_dir=str(ck), ckpt_every=2, log=lambda _m: None)
    events["resumed"] = [(e.step, e.kind) for e in out["events"]]
    resumed_from = out["resumed_from"]
    np.savez(tmp / f"ck_resumed_r{rank}.npz", **_whole(sess))
    sess = _ckpt_session(mesh, plan)
    sess.run(4, log=lambda _m: None)
    np.savez(tmp / f"ck_straight_r{rank}.npz", **_whole(sess))
    # the one-device checkpoint at step 2, restored at dp 2 under ZeRO-3
    sess = _ckpt_session(mesh, plan)
    out = sess.run(2, ckpt_dir=str(tmp / "ck_dp1"), log=lambda _m: None)
    np.savez(tmp / f"ck_from_dp1_r{rank}.npz", **_whole(sess))
    return {"crashed": crashed, "resumed_from": resumed_from,
            "from_dp1_resumed": out["resumed_from"], "events": events}


def _case(worlds, case, rank=0):
    return np.load(worlds.tmp / f"{case}_r{rank}.npz")


def _spec(case):
    return dict((c[0], c) for c in CASES)[case]


@pytest.mark.parametrize("case", [c[0] for c in CASES if c[4].get("gas", GAS) == GAS])
def test_dp_step_matches_reference(worlds, case):
    """One AdamW step (gas 2 unless the case says 1, remat full): loss 1e-5
    relative, the skip gate's metrics, and every parameter after it within
    1e-5 (Adam's noise floor held to 2·lr); the gradients (m = 0.1·g)
    within 5e-4; the same loss on every rank."""
    _, world, _, name, kw, vote, comp = _spec(case)
    got = _case(worlds, case)
    metrics, after = worlds.refs[name][comp]
    np.testing.assert_allclose(got["metric/loss"], metrics["loss"], rtol=1e-5)
    for k in ("xent", "grad_norm", "lr", "skipped", "all_finite", "nonfinite_micros",
              "bad_micro_bits", "bad_replicas", "gnorm_z"):
        np.testing.assert_allclose(got[f"metric/{k}"], metrics[k], rtol=1e-5, atol=1e-6,
                                   err_msg=k)
    assert float(got["metric/n_replicas"]) == (world // (2 if "tp2" in case else 1)
                                               if vote else 1)
    floor, total = 0, 0
    for key, w in after.items():
        if not key.startswith("params/"):
            continue
        m = after["opt/m/" + key[len("params/"):]]
        g_ref = np.abs(m) / 0.1
        noise = g_ref <= 1e-6 * g_ref.max()
        np.testing.assert_allclose(got["opt/m/" + key[len("params/"):]] / 0.1, m / 0.1,
                                   atol=5e-4, rtol=5e-4, err_msg=key)
        d = np.abs(got[key] - w)
        ok = d <= 1e-5 + 1e-5 * np.abs(w)
        assert (ok | (noise & (d <= 2 * metrics["lr"]))).all(), key
        floor += int((~ok).sum())
        total += d.size
    assert floor <= 1e-4 * total, (floor, total)
    if comp:
        ties, n = 0, 0
        for key, w in after.items():
            if key.startswith("ef/"):
                ties += int((np.abs(got[key] - w) > 1e-5).sum())
                n += w.size
        assert ties <= 1e-4 * n, (ties, n)
    for r in range(1, world):
        other = _case(worlds, case, r)
        assert float(other["metric/loss"]) == float(got["metric/loss"])
        assert float(other["metric/grad_norm"]) == float(got["metric/grad_norm"])


@pytest.mark.parametrize("case,twin,bitwise", STAGE_PAIRS,
                         ids=[f"{a}-vs-{b}" for a, b, _ in STAGE_PAIRS])
def test_zero_stages_agree(worlds, case, twin, bitwise):
    """ZeRO 1-3 against ZeRO 0 at dp 2 in f32: the same bits where every sum
    has the same two addends; ZeRO-3's per-micro-batch reduce-scatter on the
    GAS path adds four in another order, held to 1e-5."""
    a, b = _case(worlds, case), _case(worlds, twin)
    keys = [k for k in b.files if k.startswith(("params/", "opt/m/"))]
    assert keys
    for k in keys:
        if bitwise:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        else:
            np.testing.assert_allclose(a[k], b[k], atol=1e-5, rtol=1e-5, err_msg=k)
    assert (float(a["metric/loss"]) == float(b["metric/loss"])) or not bitwise


def test_zero_stages_agree_at_dp4(worlds):
    a, b = _case(worlds, "dp4-z3-gas"), _case(worlds, "dp4-z2-overlap")
    for k in (k for k in a.files if k.startswith("params/")):
        np.testing.assert_allclose(a[k], b[k], atol=1e-5, rtol=1e-5, err_msg=k)


@pytest.mark.parametrize("z", [1, 3])
@pytest.mark.parametrize("case", VOTES)
def test_vote_over_real_replicas(worlds, case, z):
    """The verdict and the params after it: the same bits on both ranks, and
    the bits of the port's one-device ``consensus_replicas = 2``; one bad
    replica is masked, both skip with the params frozen, strict mode skips
    on one."""
    ranks = [json.loads((worlds.tmp / f"extra2_r{r}.json").read_text())["votes"][f"z{z}-{case}"]
             for r in range(2)]
    assert ranks[0] == ranks[1] or all(
        a == b or (np.isnan(a) and np.isnan(b)) for a, b in zip(ranks[0].values(),
                                                                ranks[1].values()))
    m = ranks[0]
    want_m, want_p = worlds.votes[f"z{z}-{case}"]
    skip = {"bad0": 0.0, "bad1": 0.0, "both": 1.0, "strict": 1.0}[case]
    assert m["skipped"] == skip and m["n_replicas"] == 2.0
    assert m["bad_replicas"] == (2.0 if case == "both" else 1.0)
    for k in ("skipped", "bad_replicas", "n_replicas", "grad_norm", "loss"):
        assert m[k] == want_m[k] or (np.isnan(m[k]) and np.isnan(want_m[k])), k
    p = [np.load(worlds.tmp / f"vote-z{z}-{case}_r{r}.npz") for r in range(2)]
    for key, w in want_p.items():
        np.testing.assert_array_equal(_layer(p[0], key), w.numpy(), err_msg=key)
        np.testing.assert_array_equal(_layer(p[1], key), _layer(p[0], key), err_msg=key)
    if skip:
        flat = dict(np.load(worlds.tmp / "granite_state.npz"))
        for key in p[0].files:
            np.testing.assert_array_equal(p[0][key], flat[key], err_msg=key)


def _layer(npz, key):
    """A port leaf path (``blocks/<i>/...``) out of a whole state's
    reference-layout file."""
    parts = key.split("/")
    if parts[0] == "blocks":
        return npz["params/blocks/" + "/".join(parts[2:])][int(parts[1])]
    return npz["params/" + key]


def test_checkpoint_crash_resume_bitwise(worlds):
    """A ZeRO-3 dp 2 ``TrainSession.run`` crashed at step 3 resumes from its
    step-2 checkpoint in a fresh session and ends with the bits of a run
    that never crashed, on both ranks; every rank logged the same events."""
    ex = [json.loads((worlds.tmp / f"extra2_r{r}.json").read_text())["ckpt"] for r in range(2)]
    assert ex[0]["crashed"] and ex[0]["resumed_from"] == 2
    assert ex[0]["events"] == ex[1]["events"]
    for r in range(2):
        a = np.load(worlds.tmp / f"ck_resumed_r{r}.npz")
        b = np.load(worlds.tmp / f"ck_straight_r{r}.npz")
        assert set(a.files) == set(b.files)
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_sharded_checkpoint_loads_in_reference_store_and_at_dp1(worlds):
    """The ZeRO-3 dp 2 checkpoint is the reference's file format: the
    reference's store restores it onto its own state's structure with the
    bits the mesh gathered, and the port restores it on one device."""
    ck = worlds.tmp / "ck_dp2"
    steps = store.list_steps(ck)
    assert steps == [2, 4]
    ref = RefTrainSession(jget_config("granite_3_2b").reduced(), seed=3,
                          data_cfg=JDataConfig(seq_len=SEQ, global_batch=4))
    jstate, extra, step = jstore.restore_latest(ck, ref.state, log=lambda _m: None)
    assert step == 4 and extra["next_step"] == 4
    want = np.load(worlds.tmp / "ck_straight_r0.npz")
    got = _flat(jstate)
    assert set(got) == set(want.files)
    for k, v in got.items():
        np.testing.assert_array_equal(v, want[k], err_msg=k)
    sess = _ckpt_session(None, None)
    one, _, step = store.restore_latest(ck, sess.state, log=lambda _m: None)
    assert step == 4
    from repro_torch.checkpoint.bridge import state_to_numpy
    for k, v in state_to_numpy(one).items():
        np.testing.assert_array_equal(v, want[k], err_msg=k)


def test_one_device_checkpoint_restores_at_dp2(worlds):
    want = np.load(worlds.tmp / "ck_dp1_state.npz")
    ex = json.loads((worlds.tmp / "extra2_r0.json").read_text())["ckpt"]
    assert ex["from_dp1_resumed"] == 2
    for r in range(2):
        got = np.load(worlds.tmp / f"ck_from_dp1_r{r}.npz")
        for k in want.files:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("z,vote", COUNTED, ids=[f"z{z}-{'vote' if v else 'gas'}"
                                                  for z, v in COUNTED])
def test_collective_counts_per_step(worlds, z, vote):
    """One step's collectives by kind and group equal
    ``chip_smoke.expected_dp_collectives`` (what phase 21 asserts on the
    card); the gradient's all-reduces (ZeRO 0-1) or reduce-scatters (from
    ZeRO 2) carry every parameter's bytes in f32."""
    c = json.loads((worlds.tmp / "extra2_r0.json").read_text())["counts"][
        f"z{z}-{'vote' if vote else 'gas'}"]
    assert c["got"] == c["want"]
    n_params = get_config("gpt_36b").reduced().n_params()
    moved = sum(v for k, v in c["bytes"].items()
                if k in ("all_reduce@pod,data", "reduce_scatter@pod,data",
                         "reduce_scatter@data", "all_reduce@data"))
    assert moved >= 4 * n_params


def test_meshes_in_a_world_of_four(worlds):
    m = json.loads((worlds.tmp / "extra4_r0.json").read_text())["mesh"]
    assert m["dp4"]["shape"] == {"pod": 1, "data": 4, "pp": 1, "tp": 1}
    assert m["tp2dp2"]["shape"] == {"pod": 1, "data": 2, "pp": 1, "tp": 2}
    assert m["pods2dp2"]["shape"] == {"pod": 2, "data": 2, "pp": 1, "tp": 1}
    planes = [json.loads((worlds.tmp / f"extra4_r{r}.json").read_text())["mesh"]["pods2dp2"]
              for r in range(4)]
    assert [p["plane"] for p in planes] == [0, 1, 2, 3]
    assert [p["coords"]["pod"] for p in planes] == [0, 0, 1, 1]


def test_without_a_mesh_dp_computes_as_one_device():
    """dp 2 and ZeRO-3 without a mesh: the bits of dp = 1 (the reference
    computes them on one device too)."""
    dc = DataConfig(seq_len=SEQ, global_batch=4)
    from repro_torch.session import TrainSession
    a = TrainSession.from_recipe("gpt_36b", reduced=True, device="cpu", data_cfg=dc)
    b = TrainSession.from_recipe("gpt_36b", reduced=True, device="cpu", data_cfg=dc,
                                 plan=ParallelismConfig(dp=2, zero_stage=3,
                                                        overlap_zero=True))
    ma, mb = a.step(), b.step()
    assert all(torch.equal(ma[k], mb[k]) for k in ma)
    assert all(torch.equal(x, y) for (_, x), (_, y) in zip(tree_leaves(a.state["params"]),
                                                         tree_leaves(b.state["params"])))
