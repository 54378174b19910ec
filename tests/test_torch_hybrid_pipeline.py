"""The port's hybrid family (``hymba_15b``) under the pipeline and over
gloo, against the JAX reference, on the CPU, in f32:

* the pipeline at pp 2 (vpp 1, vpp 2, vpp 2 under remat "stage") on 8
  layers, whose global layers {0, 4, 7} fall on both stages: loss 1e-5
  relative against the reference's ``pipeline_loss`` (as
  ``tests/test_pipeline.py`` holds it) and against one device, every
  gradient 5e-4 against ``jax.grad`` of it, and each block run with the
  window of its layer in the whole stack;
* over gloo, a world of two ranks at a 4-layer cut: dp 2 at ZeRO-3 (the
  GAS path) and pp 2 (vpp 2, each rank its stage's layers, SWA and global
  ones) one step each against the reference's one-device step from the
  same state.
"""

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

from repro.core import pipeline as jpipe
from repro.core.recipe import ParallelismConfig as JPlan
from repro.models import init_params as jinit_params
from repro_torch.checkpoint import bridge
from repro_torch.checkpoint.bridge import params_from_numpy, state_from_numpy
from repro_torch.core import pipeline
from repro_torch.core.recipe import ParallelismConfig
from repro_torch.core.tree import tree_leaves, tree_map
from repro_torch.models import transformer as T
from test_torch_hybrid_train import BATCH, GAS, SEQ, _cfgs, _ref_steps, _session
from test_torch_hybrid import _one_thread  # noqa: F401 (autouse)
from test_torch_moe import _flat
from test_torch_moe_pipeline import _params_close

ROOT = Path(__file__).resolve().parents[1]
# the pipeline's cut (global layers on both stages); the gloo world's (pp 2
# x vpp 2 divides it: stage 0 holds layers 0 and 2, both global, stage 1
# layer 1 (window 32) and the global 3)
PP_LAYERS, MESH_LAYERS = 8, 4


# ===========================================================================
# the pipeline
# ===========================================================================

@functools.lru_cache(maxsize=None)
def _pp_setup():
    jcfg, cfg = _cfgs(PP_LAYERS)
    jparams = jinit_params(jcfg, jax.random.PRNGKey(2))
    rng = np.random.default_rng(3)
    batch = {"tokens": rng.integers(0, 256, (BATCH, SEQ)).astype(np.int32),
             "labels": rng.integers(0, 256, (BATCH, SEQ)).astype(np.int32)}
    return jcfg, cfg, jparams, _flat(jparams), batch


@functools.lru_cache(maxsize=None)
def _ref_pipeline(vpp):
    """The reference's ``pipeline_loss`` at pp 2 and its gradients, as the
    port's canonical flat leaves (remat changes neither)."""
    jcfg, _, jparams, _, batch = _pp_setup()
    jplan = JPlan(pp=2, vpp=vpp, gas=GAS)
    stacked = dict(jparams, blocks=jpipe.stack_for_pipeline(jparams["blocks"], 2, vpp))
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    (loss, _), jg = jax.value_and_grad(lambda p: jpipe.pipeline_loss(jcfg, p, jb, jplan),
                                       has_aux=True)(stacked)
    return float(loss), bridge.unstack_pipeline(_flat(jg), jplan)


@pytest.mark.parametrize("vpp,remat", [(1, "full"), (2, "full"), (2, "stage")],
                         ids=["vpp1", "vpp2", "vpp2-stage"])
def test_pipeline_matches_reference_and_one_device(vpp, remat, monkeypatch):
    """pp 2 on 8 layers, global layers {0, 4, 7}: at vpp 1 stage 0 holds
    layers 0-3 and stage 1 layers 4-7; at vpp 2 stage 0 holds chunks 0 and
    2 (layers 0, 1, 4, 5), stage 1 chunks 1 and 3.  The loss equals the
    reference's ``pipeline_loss`` and one device's (1e-5 relative), every
    gradient ``jax.grad`` of the reference's (5e-4, the reference at remat
    "full"), and every block ran with its layer's window."""
    _, cfg, _, flat, batch = _pp_setup()
    assert T.layer_windows(cfg) == [None, 32, 32, 32, None, 32, 32, None]
    want, want_flat = _ref_pipeline(vpp)
    plan = ParallelismConfig(pp=2, vpp=vpp, gas=GAS, remat_policy=remat)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    params = tree_map(lambda x: x.clone().requires_grad_(), params_from_numpy(flat))
    layer_of = {id(bp["attn"]["wq"]): i for i, bp in enumerate(params["blocks"])}
    seen = {}
    real = T.block_apply

    def recording(cfg_, p, x, pos, *, window, **kw):
        seen.setdefault(layer_of[id(p["attn"]["wq"])], set()).add(window)
        return real(cfg_, p, x, pos, window=window, **kw)

    monkeypatch.setattr(T, "block_apply", recording)
    got, _ = pipeline.pipeline_loss(cfg, params, tb, plan)
    micro = pipeline.split_micros(tb, GAS)
    pipeline.run_pipeline(cfg, plan, params, [{k: x[i] for k, x in micro.items()}
                                              for i in range(GAS)],
                          seed=1.0 / pipeline.denominator(tb))
    monkeypatch.setattr(T, "block_apply", real)
    one, _ = T.lm_loss(cfg, params_from_numpy(flat), tb)
    np.testing.assert_allclose(float(got), want, rtol=1e-5)
    np.testing.assert_allclose(float(got), float(one), rtol=1e-5)
    assert seen == {i: {w} for i, w in enumerate(T.layer_windows(cfg))}
    want_g = params_from_numpy(want_flat)
    for (path, w), (_, p) in zip(tree_leaves(want_g), tree_leaves(params)):
        np.testing.assert_allclose(p.grad.numpy(), w.numpy(), atol=5e-4, rtol=5e-4,
                                   err_msg=str(path))


# ===========================================================================
# over gloo
# ===========================================================================

# (case, mesh keywords, plan keywords): each one step from the reference's
# initial state on its first batch
CASES = [("dp2-z3", dict(pods=1, tp=1), dict(dp=2, zero_stage=3)),
         ("pp2-vpp2", dict(pp=2), dict(pp=2, vpp=2))]
CASE_IDS = [c[0] for c in CASES]


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("hybrid")
    r = _ref_steps(1, MESH_LAYERS, consensus=False)
    np.savez(tmp / "init.npz", **r.initial)
    np.savez(tmp / "batch.npz", **r.batch)
    env = {**os.environ, "PYTHONPATH": os.pathsep.join([str(ROOT / "src"), str(ROOT / "tests")]),
           "JAX_PLATFORMS": "cpu", "OMP_NUM_THREADS": "1"}
    code = f"import test_torch_hybrid_pipeline as t; t._rank_main({str(tmp)!r})"
    procs = [subprocess.Popen([sys.executable, "-c", code], env={**env, "RANK": str(rank)},
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for rank in range(2)]
    for rank, p in enumerate(procs):
        try:
            log = p.communicate(timeout=300)[0]
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        assert p.returncode == 0, f"rank {rank}:\n{log[-4000:]}"
    return SimpleNamespace(tmp=tmp, ref=r)


def _rank_main(tmp):
    import torch.distributed as dist
    from repro_torch.checkpoint.elastic import host_snapshot, reshard_state
    from repro_torch.launch.mesh import make_recipe_mesh
    tmp = Path(tmp)
    rank = int(os.environ["RANK"])
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{tmp}/store", rank=rank, world_size=2)
    batch = dict(np.load(tmp / "batch.npz"))
    for case, mesh_kw, plan_kw in CASES:
        mesh = make_recipe_mesh(device_type="cpu", **mesh_kw)
        plan = ParallelismConfig(gas=GAS, **plan_kw)
        sess = _session(plan, mesh, MESH_LAYERS, consensus=False)
        sess.state = reshard_state(state_from_numpy(dict(np.load(tmp / "init.npz"))), plan,
                                   mesh=mesh, cfg=sess.cfg)
        got = {f"metric/{k}": np.asarray(float(v)) for k, v in sess.step(batch).items()}
        got["n_blocks"] = np.array(len(sess.state["params"]["blocks"]))
        got.update(host_snapshot(sess.state, plan, mesh=mesh, cfg=sess.cfg))
        np.savez(tmp / f"{case}_r{rank}.npz", **got)
    dist.barrier()
    dist.destroy_process_group()


@pytest.mark.parametrize("case", CASE_IDS)
def test_step_over_gloo_matches_reference(world, case):
    """One step (gas 2) on the mesh: loss, xent and grad_norm 1e-5 against
    the reference's one-device step, the same loss on both ranks, and every
    parameter after it 1e-5 (entries at the f32 noise floor 2·lr)."""
    want_m, want = world.ref.metrics[0], world.ref.states[0]
    got = {rank: dict(np.load(world.tmp / f"{case}_r{rank}.npz")) for rank in (0, 1)}
    for k in ("loss", "xent", "grad_norm", "lr", "skipped"):
        np.testing.assert_allclose(float(got[0][f"metric/{k}"]), want_m[k], rtol=1e-5,
                                   atol=1e-7, err_msg=k)
    assert float(got[1]["metric/loss"]) == float(got[0]["metric/loss"])
    n_blocks = MESH_LAYERS // 2 if case.startswith("pp2") else MESH_LAYERS
    assert int(got[0]["n_blocks"]) == int(got[1]["n_blocks"]) == n_blocks
    _params_close(got[0], want, want_m["lr"])
