"""The port's tensor parallelism against the JAX reference, on the CPU.

Three parts:

* **The rules**, with ``==`` and no process group: ``spec_for_path`` and
  the sanitized resolution of every leaf of the seven ported configs at
  full size (the reference's side through ``jax.eval_shape``) for tp 2, 4,
  8 and 16; ``axis_mapping``, ``fsdp_axes`` and the mesh factorization.
* **The numerics**, over gloo: one fixture starts each world (2 and 4
  ranks, ``python`` subprocesses on the CPU) once; every rank runs every
  case of its world and writes what it saw under ``tmp_path``, and one
  parametrised test per case and quantity reads it.  Each case holds the
  port at tp = 2 or 4, sequence parallel off and on, to the reference on
  one device, from the reference's weights (``init_params`` →
  ``bridge.params_from_numpy`` → ``shard_params``): one AdamW step at gas 2
  (loss 1e-5 relative, the skip gate's metrics, every parameter 1e-5), one
  with int8 error feedback (the feedback 1e-5 but for rounding ties),
  prefill logits (1e-5) and 8 greedy tokens (identical).
* **The collective counts** per step at tp = 2 for each remat policy, the
  ``gather_params`` / ``shard_params`` round trip, ``to_inference`` and
  every refusal of a plan on a mesh (what waits for a later part of the
  recipe, and plans the mesh does not match).
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
import numpy as np
import pytest
import torch

from repro.checkpoint import store
from repro.configs import get_config as jget_config
from repro.core import recipe as jrecipe
from repro.core import sharding as jshd
from repro.core import stepfn as jstepfn
from repro.core import zero as jzero
from repro.core.recipe import ParallelismConfig as JPlan
from repro.data import DataConfig as JDataConfig
from repro.models import init_params as jinit_params
from repro.optim.adamw import AdamWConfig as JAdamW
from repro.session.infer import InferenceSession as RefInference
from repro.session.train import TrainSession as RefTrainSession
from repro_torch.checkpoint.bridge import params_from_numpy, state_from_numpy
from repro_torch.configs import PORTED, get_config
from repro_torch.core import recipe, sharding, stepfn, tp, zero
from repro_torch.core.recipe import ParallelismConfig
from repro_torch.core.tree import tree_leaves, tree_map
from repro_torch.data import DataConfig
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.optim.compress import init_error_feedback

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke  # noqa: E402  (the collective counts phase 20 asserts on the card)
SEQ, BATCH, GAS, PROMPT, NEW = 32, 4, 2, 16, 8
LR = 1e-4
# (case id, arch, tp, sequence parallel; each name's config overrides):
# granite at an odd vocabulary leaves its (tied) table whole, as the full
# config's 49155 does, and at an odd d_ff its MLPs (``layers.mlp_apply``)
ARCHS = {"granite": ("granite_3_2b", {}), "granite_v259": ("granite_3_2b", {"vocab_size": 259}),
         "granite_ff129": ("granite_3_2b", {"d_ff": 129}),
         "gpt": ("gpt_36b", {}), "qwen": ("qwen15_32b", {}),
         "h2o": ("h2o_danube_3_4b", {})}
CASES = [(f"{a}-tp{n}-{'sp' if sp else 'nosp'}", a, n, sp)
         for a, n in (("granite", 2), ("granite_v259", 2), ("granite_ff129", 2), ("gpt", 2),
                      ("qwen", 2), ("h2o", 2), ("gpt", 4))
         for sp in (False, True)]
CASE_IDS = [c[0] for c in CASES]
REMATS = ("none", "full", "dots")
PARALLEL = "Queue 1, item 3: the parallel recipe over torch.distributed"
REFUSALS = ("pp", "dp", "pods", "consensus_replicas", "tp_axis", "fleet", "heads",
            "slot_step", "paged_step", "paged_prefill", "serve")
# refused in the world of four, on its tp 2 x dp 2 mesh
REFUSALS_4 = ("dp_short", "consensus_replicas_3", "rows")
# what a ValueError names: the mesh's axes against the plan's
VALUE_ERRORS = {"heads": ("tp=2", "n_kv_heads=3"),
                "pp": ("plan pp=2", "pp axis is 1 ranks wide"),
                "dp": ("plan dp=2", "data axis is 1 ranks wide"),
                "pods": ("plan pods=2", "pod axis is 1 ranks wide"),
                "consensus_replicas": ("consensus_replicas=2", "dp*pods=1"),
                "tp_axis": ("plan tp=1", "tp axis is 2 ranks wide"),
                "dp_short": ("plan dp=1", "data axis is 2 ranks wide"),
                "consensus_replicas_3": ("consensus_replicas=3", "dp*pods=2"),
                "rows": ("not divisible by the 2 data-parallel replicas",)}


def _flat(tree):
    return {k: np.asarray(v) for k, v in store._flatten(tree)}


def _train_cfgs(compression=None):
    kw = dict(peak_lr=LR, warmup=2, total_steps=10, compression=compression)
    return (jstepfn.TrainConfig(adam=JAdamW(), **kw),
            stepfn.TrainConfig(adam=AdamWConfig(), **kw))


# ===========================================================================
# the rules, with ==
# ===========================================================================

def _port_mesh(tp_size):
    return SimpleNamespace(shape={"pod": 1, "data": 1, "pp": 1, "tp": tp_size},
                           axis_names=("pod", "data", "pp", "tp"))


@functools.lru_cache(maxsize=None)
def _ref_shapes(arch):
    """The reference's full-size parameter shapes, flattened by path."""
    jcfg = jget_config(arch)
    return tuple(store._flatten(jax.eval_shape(lambda k: jinit_params(jcfg, k),
                                               jax.random.PRNGKey(0))))


@pytest.mark.parametrize("tp_size", [2, 4, 5, 8, 16])
@pytest.mark.parametrize("arch", PORTED)
def test_param_rules_equal_reference(arch, tp_size):
    """Every leaf at full size: ``spec_for_path`` (the family's hints
    first, the MoE family's expert placements) gives the reference's
    logical axes (without its leading ``layers`` axis), the sanitized
    resolution gives its ``PartitionSpec``, and the spec the port places the
    leaf by (``zero.param_shardings``, which ``shard_params`` cuts) is that
    resolution."""
    jmesh = jax.sharding.AbstractMesh((1, 1, 1, tp_size), ("pod", "data", "pp", "tp"))
    jrules = jshd.AxisRules(jmesh, jrecipe.axis_mapping(JPlan(tp=tp_size)))
    mesh = _port_mesh(tp_size)
    plan = ParallelismConfig(tp=tp_size)
    rules = sharding.AxisRules(mesh, recipe.axis_mapping(plan))
    leaves = []
    jhints, hints = jzero.family_hints(jget_config(arch)), zero.family_hints(get_config(arch))
    assert hints == jhints
    for path, leaf in _ref_shapes(arch):
        # the reference's stacks: ``blocks``, an encoder-decoder's two
        stack = path.split("/")[0]
        stacked = stack in ("blocks", "enc_blocks", "dec_blocks")
        want = jshd.spec_for_path(path, leaf.shape, stacked_axes=int(stacked),
                                  extra_rules=jhints)
        shape = leaf.shape[1:] if stacked else leaf.shape
        ppath = path.replace(f"{stack}/", f"{stack}/0/", 1) if stacked else path
        got = sharding.spec_for_path(ppath, shape, extra_rules=hints)
        assert got == (want[1:] if stacked else want), path
        jspec = tuple(jshd.sanitize(jax.sharding.NamedSharding(jmesh, jrules.resolve(want)),
                                    leaf.shape, jmesh).spec)
        spec = sharding.sanitize(rules.resolve(got), shape, mesh)
        jspec = jspec + (None,) * (len(leaf.shape) - len(jspec))
        assert spec == (jspec[1:] if stacked else jspec), path
        leaves.append((tuple(ppath.split("/")), shape, spec))
    placed = zero.param_shardings([(p, s) for p, s, _ in leaves], mesh, plan, hints=hints)
    for p, _, spec in leaves:
        assert placed[p] == spec, p


@pytest.mark.parametrize("sp", [False, True])
@pytest.mark.parametrize("zero", [1, 3])
def test_axis_mapping_and_fsdp_axes_equal_reference(sp, zero):
    plan = ParallelismConfig(tp=2, sequence_parallel=sp, zero_stage=zero)
    jplan = JPlan(tp=2, sequence_parallel=sp, zero_stage=zero)
    assert recipe.axis_mapping(plan) == jrecipe.axis_mapping(jplan)
    assert recipe.fsdp_axes(plan) == jrecipe.fsdp_axes(jplan)


def test_recipe_mesh_factorization():
    """The mirror of the reference's: TP innermost (consecutive ranks share
    a tp group), and a plan that does not factorize the grid raises the
    reference's error."""
    plan = ParallelismConfig(tp=2, pp=2, dp=2)
    grid = recipe.factorize_production_mesh(np.arange(8).reshape(2, 4), plan)
    assert grid.shape == (1, 2, 2, 2)
    assert grid[0, 0, 0, 1] == grid[0, 0, 0, 0] + 1
    assert recipe.factorize_production_mesh(np.arange(16).reshape(2, 2, 4),
                                            dataclasses.replace(plan, pods=2)).shape == (2, 2, 2, 2)
    jmesh = jax.sharding.Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ("data", "model"))
    with pytest.raises(ValueError) as want:
        jrecipe.factorize_production_mesh(jmesh, JPlan(tp=2))
    with pytest.raises(ValueError) as got:
        recipe.factorize_production_mesh(np.arange(1).reshape(1, 1), ParallelismConfig(tp=2))
    assert str(got.value) == str(want.value)


def test_without_rules_the_regions_are_the_identity():
    x = torch.randn(2, 4, 8)
    assert tp.size() == 1 and not tp.sequence_parallel()
    for f in (tp.copy_to_tp, tp.reduce_from_tp, tp.enter, tp.leave):
        assert f(x) is x
    assert sharding.constrain(x, "batch", "seq", None) is x
    assert tp.gather_vocab(x) is x


# ===========================================================================
# the numerics over gloo
# ===========================================================================

def _ref_cfg(name):
    arch, kw = ARCHS[name]
    return dataclasses.replace(jget_config(arch).reduced(), **kw)


def _ref_session(name, compression=None):
    return RefTrainSession(_ref_cfg(name), plan=JPlan(gas=GAS), seed=5,
                           data_cfg=JDataConfig(seq_len=SEQ, global_batch=BATCH, seed=7),
                           train_cfg=_train_cfgs(compression)[0])


def _write_inputs(name, tmp):
    """The reference's initial train state, first batch and prompts, for
    the ranks."""
    ref = _ref_session(name)
    np.savez(tmp / f"{name}_state.npz", **_flat(ref.state))
    np.savez(tmp / f"{name}_batch.npz", **ref.batches(0))
    np.save(tmp / f"{name}_prompts.npy", np.random.RandomState(9).randint(
        0, ref.cfg.vocab_size, (3, PROMPT)).astype(np.int32))


def _reference(name, tmp):
    """The reference on one device: one step with and without int8 error
    feedback, prefill logits and greedy tokens."""
    out = {}
    for comp in (None, "int8_ef"):
        ref = _ref_session(name, comp)
        # a copy: the reference's step donates its state
        params = jax.tree_util.tree_map(lambda x: jax.numpy.array(x, copy=True),
                                        ref.state["params"])
        batch = ref.batches(0)
        out[comp] = ({k: float(v) for k, v in ref.step(batch).items()}, _flat(ref.state))
    inf = RefInference.from_params(ref.cfg, params)
    out["prefill"] = np.asarray(inf.prefill({"tokens": batch["tokens"]}, last_only=False))
    out["tokens"] = np.asarray(inf.generate(np.load(tmp / f"{name}_prompts.npy"), NEW))
    return out


def _start_world(world, tmp):
    env = {**os.environ, "PYTHONPATH": os.pathsep.join([str(ROOT / "src"), str(ROOT / "tests")]),
           "JAX_PLATFORMS": "cpu", "OMP_NUM_THREADS": "1"}
    code = f"import test_torch_tp as t; t._rank_main({world}, {str(tmp)!r})"
    return [subprocess.Popen([sys.executable, "-c", code], env={**env, "RANK": str(r)},
                             stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for r in range(world)]


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """Each world run once: the reference's inputs written first, the ranks
    started, the reference's results computed while they run."""
    tmp = tmp_path_factory.mktemp("tp")
    for name in ARCHS:
        _write_inputs(name, tmp)
    procs = {w: _start_world(w, tmp) for w in (2, 4)}
    refs = {name: _reference(name, tmp) for name in ARCHS}
    logs = {}
    for w, ps in procs.items():
        for r, p in enumerate(ps):
            try:
                logs[(w, r)] = p.communicate(timeout=240)[0]
            except subprocess.TimeoutExpired:
                for q in ps:
                    q.kill()
                raise
            assert p.returncode == 0, f"world {w} rank {r}:\n{logs[(w, r)][-4000:]}"
    return SimpleNamespace(tmp=tmp, refs=refs, logs=logs)


def _rank_main(world, tmp):
    """One rank of a world: every case of the world, results under ``tmp``."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_recipe_mesh
    tmp = Path(tmp)
    rank = int(os.environ["RANK"])
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{tmp}/store{world}", rank=rank,
                            world_size=world)
    mesh = make_recipe_mesh(tp=world, device_type="cpu")
    for case, name, n, sp in CASES:
        if n == world:
            np.savez(tmp / f"{case}_r{rank}.npz", **_rank_case(name, sp, mesh, tmp))
    extra = {}
    if world == 2:
        extra["counts"] = {f"{r}-{sp}": _rank_counts(r, sp, mesh)
                           for r in REMATS for sp in (False, True)}
        extra["refusals"] = _rank_refusals(mesh, tmp)
        extra["backward_thread_equal"] = _rank_backward_thread(mesh)
    else:
        m2 = make_recipe_mesh(tp=2, device_type="cpu")
        extra["mesh_tp2_in_4"] = {"shape": m2.shape, "coords": m2.coords,
                                  "devices": m2.devices.tolist()}
        extra["refusals"] = _rank_refusals_4(m2)
    (tmp / f"extra{world}_r{rank}.json").write_text(json.dumps(extra))
    dist.barrier()
    dist.destroy_process_group()


def _case_cfg(name):
    arch, kw = ARCHS[name]
    return dataclasses.replace(get_config(arch).reduced(), **kw)


def _sharded_state(flat, mesh, plan):
    """The reference's train state, this rank's slices of it."""
    state = state_from_numpy(flat)
    for tree, key in ((state, "params"), (state, "ef"), (state["opt"], "m"),
                      (state["opt"], "v")):
        if key in tree:
            tree[key] = sharding.shard_params(tree[key], mesh, plan)
    return state


def _rank_case(name, sp, mesh, tmp):
    from repro_torch.models import transformer
    from repro_torch.session import InferenceSession, TrainSession
    cfg = _case_cfg(name)
    plan = ParallelismConfig(tp=mesh.shape["tp"], gas=GAS, sequence_parallel=sp)
    flat = dict(np.load(tmp / f"{name}_state.npz"))
    batch = dict(np.load(tmp / f"{name}_batch.npz"))
    prompts = np.load(tmp / f"{name}_prompts.npy")
    out = {}
    whole = params_from_numpy(flat)
    shapes = {p: x.shape for p, x in tree_leaves(whole)}
    local = sharding.shard_params(whole, mesh, plan)
    back = sharding.gather_params(local, mesh, plan, cfg)
    out["roundtrip_bitwise"] = np.array(all(
        torch.equal(a, b) for (_, a), (_, b) in zip(tree_leaves(back), tree_leaves(whole))))
    out["n_sharded"] = np.array(sum(x.shape != shapes[p] for p, x in tree_leaves(local)))
    for comp, tag in ((None, "plain"), ("int8_ef", "int8")):
        sess = TrainSession(cfg, plan=plan, mesh=mesh, device="cpu",
                            train_cfg=_train_cfgs(comp)[1],
                            data_cfg=DataConfig(seq_len=SEQ, global_batch=BATCH))
        sess.state = _sharded_state(flat, mesh, plan)
        if comp:
            sess.state["ef"] = init_error_feedback(sess.state["params"])
        if tag == "plain":
            out["to_inference_tokens"] = sess.to_inference().generate(prompts, NEW).numpy()
        for k, v in sess.step(batch).items():
            out[f"{tag}/metric/{k}"] = np.asarray(float(v))
        for key, local in (("params", sess.state["params"]), ("m", sess.state["opt"]["m"]),
                           ("ef", sess.state.get("ef"))):
            if local is not None:
                tree = sharding.gather_params(local, mesh, plan, cfg)
                for path, x in tree_leaves(tree):
                    out[f"{tag}/{key}/" + "/".join(map(str, path))] = x.detach().numpy()
    if not sp:
        # replicated leaves' gradients are equal on every rank without SP
        params = _sharded_state(flat, mesh, plan)["params"]
        leaves = [p.requires_grad_() for _, p in tree_leaves(params)]
        tb = {k: torch.from_numpy(v[: BATCH // GAS]) for k, v in batch.items()}
        with sharding.axis_rules(mesh, recipe.axis_mapping(plan)):
            loss, _ = transformer.lm_loss(cfg, params, tb)
            grads = torch.autograd.grad(loss, leaves)
        for (path, p), g in zip(tree_leaves(params), grads):
            if p.shape == shapes[path]:
                out["grad/" + "/".join(map(str, path))] = g.numpy()
    inf = InferenceSession.from_params(cfg, whole, plan=plan, mesh=mesh, device="cpu")
    out["prefill"] = inf.prefill({"tokens": batch["tokens"]}, last_only=False).numpy()
    tp.counts.clear()
    out["tokens"] = inf.generate(prompts, NEW).numpy()
    out["generate_counts"] = np.array(json.dumps(dict(tp.counts)))
    return out


def _rank_counts(remat, sp, mesh):
    """Collectives of one train step of reduced gpt-3.6b at tp = 2, gas 2,
    by kind: {kind: [calls, bytes]}."""
    from repro_torch.session import TrainSession
    cfg = get_config("gpt_36b").reduced()
    plan = ParallelismConfig(tp=2, gas=GAS, remat_policy=remat, sequence_parallel=sp)
    sess = TrainSession(cfg, plan=plan, mesh=mesh, device="cpu", train_cfg=_train_cfgs()[1],
                        data_cfg=DataConfig(seq_len=SEQ, global_batch=BATCH))
    tp.counts.clear()
    tp.nbytes.clear()
    sess.step()
    return {k: [tp.counts[k], tp.nbytes[k]] for k in tp.counts}


def _rank_backward_thread(mesh):
    """Gradients of a remat-full, sequence-parallel loss with the backward
    (and so the blocks' recompute) on another thread, as autograd runs a
    CUDA backward, against the same on this thread: the installed rules
    must be seen there too."""
    import threading
    from repro_torch.models import transformer
    cfg = get_config("gpt_36b").reduced()
    plan = ParallelismConfig(tp=2, sequence_parallel=True)
    from repro_torch.models import api
    gen = torch.Generator().manual_seed(0)
    params = sharding.shard_params(api.init_params(cfg, gen), mesh, plan)
    tokens = torch.randint(0, cfg.vocab_size, (2, SEQ), generator=gen)
    batch = {"tokens": tokens, "labels": tokens}
    grads = []
    for other in (False, True):
        local = tree_map(lambda x: x.detach().requires_grad_(), params)
        leaves = [p for _, p in tree_leaves(local)]
        with sharding.axis_rules(mesh, recipe.axis_mapping(plan)):
            loss, _ = transformer.lm_loss(cfg, local, batch, remat_policy="full")
            if other:
                box = []
                t = threading.Thread(target=lambda: box.append(
                    torch.autograd.grad(loss, leaves)))
                t.start()
                t.join(timeout=120)
                grads.append(box[0])
            else:
                grads.append(torch.autograd.grad(loss, leaves))
    return all(torch.equal(a, b) for a, b in zip(*grads))


def _rank_refusals(mesh, tmp):
    """{what: the message it raised} for every plan a mesh refuses."""
    from repro_torch.runtime.resilience import ResilienceConfig
    from repro_torch.session import InferenceSession, TrainSession
    cfg = get_config("granite_3_2b").reduced()
    out = {}

    def catch(key, fn):
        try:
            fn()
        except (NotImplementedError, ValueError) as e:
            out[key] = f"{type(e).__name__}: {e}"

    base = ParallelismConfig(tp=2)
    for key, plan in (("pp", dataclasses.replace(base, pp=2)),
                      ("dp", dataclasses.replace(base, dp=2)),
                      ("pods", dataclasses.replace(base, pods=2)),
                      ("tp_axis", dataclasses.replace(base, tp=1))):
        catch(key, lambda plan=plan: stepfn.make_train_step(cfg, plan, mesh=mesh))
    tcfg = stepfn.TrainConfig(resilience=ResilienceConfig(consensus_replicas=2))
    catch("consensus_replicas", lambda: stepfn.make_train_step(cfg, base, tcfg, mesh=mesh))
    catch("heads", lambda: stepfn.make_train_step(
        dataclasses.replace(cfg, n_heads=6, n_kv_heads=3), base, mesh=mesh))
    catch("slot_step", lambda: stepfn.make_slot_serve_step(cfg, base, mesh))
    catch("paged_step", lambda: stepfn.make_paged_serve_step(cfg, base, mesh))
    catch("paged_prefill", lambda: stepfn.make_paged_prefill(cfg, base, mesh))
    inf = InferenceSession.from_recipe(cfg, plan=base, mesh=mesh, device="cpu")
    catch("serve", lambda: inf.serve([np.arange(4)], 2))
    from repro_torch.runtime.fleet import FleetController
    sess = TrainSession(cfg, plan=base, mesh=mesh, device="cpu",
                        data_cfg=DataConfig(seq_len=SEQ, global_batch=BATCH))
    catch("fleet", lambda: sess.run(2, fleet=FleetController(n_replicas=2)))
    return out


def _rank_refusals_4(mesh):
    """{what: the message it raised} for the plans the tp 2 x dp 2 mesh of a
    world of four refuses."""
    from repro_torch.runtime.resilience import ResilienceConfig
    from repro_torch.session import TrainSession
    cfg = get_config("granite_3_2b").reduced()
    out = {}

    def catch(key, fn):
        try:
            fn()
        except (NotImplementedError, ValueError) as e:
            out[key] = f"{type(e).__name__}: {e}"

    base = ParallelismConfig(tp=2, dp=2, gas=GAS)
    catch("dp_short", lambda: stepfn.make_train_step(cfg, dataclasses.replace(base, dp=1),
                                                     mesh=mesh))
    tcfg = stepfn.TrainConfig(resilience=ResilienceConfig(consensus_replicas=3))
    catch("consensus_replicas_3", lambda: stepfn.make_train_step(cfg, base, tcfg, mesh=mesh))
    sess = TrainSession(cfg, plan=base, mesh=mesh, device="cpu",
                        train_cfg=stepfn.TrainConfig(
                            resilience=ResilienceConfig(consensus=False)),
                        data_cfg=DataConfig(seq_len=SEQ, global_batch=2))
    catch("rows", sess.step)
    return out


def _rank(worlds, case, rank=0):
    n = dict((c, k) for c, _, k, _ in CASES)[case]
    return np.load(worlds.tmp / f"{case}_r{rank}.npz"), n


def _name(case):
    return dict((c, a) for c, a, _, _ in CASES)[case]


@pytest.mark.parametrize("case", CASE_IDS)
def test_tp_step_matches_reference(worlds, case):
    """One AdamW step (gas 2, remat full): loss 1e-5 relative, the skip
    gate's metrics, and every parameter after it within 1e-5; the same on
    every rank."""
    got, n = _rank(worlds, case)
    metrics, after = worlds.refs[_name(case)][None]
    np.testing.assert_allclose(got["plain/metric/loss"], metrics["loss"], rtol=1e-5)
    for k in ("xent", "grad_norm", "lr", "skipped", "all_finite", "nonfinite_micros",
              "bad_micro_bits", "n_replicas", "bad_replicas", "gnorm_z"):
        np.testing.assert_allclose(got[f"plain/metric/{k}"], metrics[k], rtol=1e-5, atol=1e-6,
                                   err_msg=k)
    assert float(got["plain/metric/skipped"]) == 0.0
    want = params_from_numpy({k[len("params/"):]: v for k, v in after.items()
                              if k.startswith("params/")})
    # the first AdamW update is lr·g/(|g| + eps): a gradient entry at the
    # f32 noise floor (|g| ≤ 1e-6 of its leaf's largest, ~1e-9, the order of
    # eps) can move by up to 2·lr as the tp sums reorder it, so such entries
    # are held to 2·lr and must stay rare; every other entry to 1e-5.  The
    # gradients themselves (the first moment m = 0.1·g) are held to the
    # one-device tests' gradient tolerance, 5e-4
    m = dict(tree_leaves(params_from_numpy({k[len("opt/m/"):]: v for k, v in after.items()
                                            if k.startswith("opt/m/")})))
    floor, total = 0, 0
    for path, w in tree_leaves(want):
        key = "/".join(map(str, path))
        g_ref = np.abs(m[path].numpy()) / 0.1
        noise = g_ref <= 1e-6 * g_ref.max()
        np.testing.assert_allclose(got["plain/m/" + key] / 0.1, m[path].numpy() / 0.1,
                                   atol=5e-4, rtol=5e-4, err_msg=key)
        d = np.abs(got["plain/params/" + key] - w.numpy())
        ok = d <= 1e-5 + 1e-5 * np.abs(w.numpy())
        assert (ok | (noise & (d <= 2 * metrics["lr"]))).all(), key
        floor += int((~ok).sum())
        total += d.size
    assert floor <= 1e-4 * total, (floor, total)
    for r in range(1, n):
        other, _ = _rank(worlds, case, r)
        assert float(other["plain/metric/loss"]) == float(got["plain/metric/loss"])
        assert float(other["plain/metric/grad_norm"]) == float(got["plain/metric/grad_norm"])


@pytest.mark.parametrize("case", CASE_IDS)
def test_tp_int8_error_feedback_matches_reference(worlds, case):
    """With int8 error feedback the scale is one max over the whole
    reference leaf (all-reduced over the tp group): the feedback after one
    step agrees within 1e-5 but for entries on a rounding tie (at most 1e-4
    of them), as in the one-device test."""
    got, _ = _rank(worlds, case)
    metrics, after = worlds.refs[_name(case)]["int8_ef"]
    np.testing.assert_allclose(got["int8/metric/loss"], metrics["loss"], rtol=1e-5)
    np.testing.assert_allclose(got["int8/metric/grad_norm"], metrics["grad_norm"], rtol=1e-5)
    want = params_from_numpy({k[len("ef/"):]: v for k, v in after.items()
                              if k.startswith("ef/")})
    ties, total = 0, 0
    for path, w in tree_leaves(want):
        d = np.abs(got["int8/ef/" + "/".join(map(str, path))] - w.numpy())
        ties += int((d > 1e-5).sum())
        total += d.size
    assert ties <= 1e-4 * total, (ties, total)


@pytest.mark.parametrize("case", CASE_IDS)
def test_tp_prefill_matches_reference(worlds, case):
    got, _ = _rank(worlds, case)
    np.testing.assert_allclose(got["prefill"], worlds.refs[_name(case)]["prefill"],
                               atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("case", CASE_IDS)
def test_tp_generate_matches_reference(worlds, case):
    """8 greedy tokens identical on every rank to the reference's, and
    ``TrainSession.to_inference`` (gathered to one device) gives them too."""
    got, n = _rank(worlds, case)
    want = worlds.refs[_name(case)]["tokens"]
    np.testing.assert_array_equal(got["tokens"], want)
    np.testing.assert_array_equal(got["to_inference_tokens"], want)
    cfg = _case_cfg(_name(case))
    assert json.loads(str(got["generate_counts"])) == chip_smoke.expected_serving_collectives(
        cfg.n_layers, NEW - 1, vocab_parallel=cfg.vocab_size % n == 0, sp=case.endswith("-sp"),
        whole_mlp=cfg.d_ff % n != 0)
    for r in range(1, n):
        np.testing.assert_array_equal(_rank(worlds, case, r)[0]["tokens"], want)


@pytest.mark.parametrize("case", CASE_IDS)
def test_gather_params_inverts_shard_params(worlds, case):
    got, n = _rank(worlds, case)
    assert bool(got["roundtrip_bitwise"])
    assert int(got["n_sharded"]) > 0


@pytest.mark.parametrize("case", [c for c in CASE_IDS if c.endswith("nosp")])
def test_replicated_gradients_equal_on_every_rank_without_sp(worlds, case):
    """Without sequence parallel no replicated leaf's gradient needs a
    reduce: the regions leave them bitwise equal on every rank."""
    ranks = [_rank(worlds, case, r)[0] for r in range(_rank(worlds, case)[1])]
    keys = [k for k in ranks[0].files if k.startswith("grad/")]
    assert any("norm" in k for k in keys)
    for k in keys:
        for other in ranks[1:]:
            np.testing.assert_array_equal(other[k], ranks[0][k], err_msg=k)


@pytest.mark.parametrize("sp", [False, True])
@pytest.mark.parametrize("remat", REMATS)
def test_collective_counts_per_step(worlds, remat, sp):
    """One train step's collectives by kind equal the integers that
    ``chip_smoke.py`` phase 20 asserts on the card
    (``chip_smoke.expected_collectives``); the activation all-reduces carry
    (mbs, S, d) each."""
    counts = json.loads((worlds.tmp / "extra2_r0.json").read_text())["counts"][f"{remat}-{sp}"]
    cfg = get_config("gpt_36b").reduced()
    want = chip_smoke.expected_collectives(cfg.n_layers, GAS, remat=remat, sp=sp,
                                           vocab_parallel=True)
    assert {k: v[0] for k, v in counts.items()} == want
    act = BATCH // GAS * SEQ * cfg.d_model * 4             # f32 activations
    if not sp:
        assert counts["all_reduce"][1] >= (counts["all_reduce"][0] - 1 - 2 * GAS) * act


@pytest.mark.parametrize("what", REFUSALS + REFUSALS_4)
def test_mesh_refuses_what_waits(worlds, what):
    """What waits for a later part of the recipe raises NotImplementedError
    naming its ROADMAP item; a plan the mesh's axes do not match, a
    ``consensus_replicas`` other than the mesh's replicas and a batch the
    replicas do not divide raise ValueError naming both sides."""
    world = 4 if what in REFUSALS_4 else 2
    msg = json.loads((worlds.tmp / f"extra{world}_r0.json").read_text())["refusals"][what]
    if what in VALUE_ERRORS:
        assert msg.startswith("ValueError"), msg
        assert all(part in msg for part in VALUE_ERRORS[what]), msg
    else:
        assert msg.startswith("NotImplementedError") and PARALLEL in msg, msg


def test_backward_on_another_thread_sees_the_rules(worlds):
    """Autograd runs a CUDA backward on its own device threads; the blocks'
    recompute there must still run the tp regions."""
    assert json.loads((worlds.tmp / "extra2_r0.json").read_text())["backward_thread_equal"]


def test_recipe_mesh_in_a_world_of_four(worlds):
    m = json.loads((worlds.tmp / "extra4_r0.json").read_text())["mesh_tp2_in_4"]
    assert m["shape"] == {"pod": 1, "data": 2, "pp": 1, "tp": 2}
    assert m["devices"] == [[[[0, 1]], [[2, 3]]]]
    assert m["coords"] == {"pod": 0, "data": 0, "pp": 0, "tp": 0}


def test_without_a_mesh_tp_computes_as_one_device():
    """tp = 2 without a mesh: the same bits as tp = 1 (the reference
    computes it on one device too); a pipeline whose stages do not divide
    the layers is refused."""
    dc = DataConfig(seq_len=SEQ, global_batch=BATCH)
    from repro_torch.session import TrainSession
    a = TrainSession.from_recipe("gpt_36b", reduced=True, device="cpu", data_cfg=dc)
    b = TrainSession.from_recipe("gpt_36b", reduced=True, device="cpu", data_cfg=dc,
                                 plan=ParallelismConfig(tp=2, sequence_parallel=True))
    ma, mb = a.step(), b.step()
    assert all(torch.equal(ma[k], mb[k]) for k in ma)
    assert all(torch.equal(x, y) for (_, x), (_, y) in zip(tree_leaves(a.state["params"]),
                                                         tree_leaves(b.state["params"])))
    with pytest.raises(ValueError, match="does not divide n_layers=2"):
        stepfn.check_plan(ParallelismConfig(pp=3), cfg=get_config("gpt_36b").reduced())
