"""The port's pipeline-parallel train step and the fleet's pipeline
re-plan against the JAX reference, on the CPU, in f32 at reduced size (the
helpers of ``test_torch_pipeline.py``; a file of its own so that ``--dist
loadfile`` runs it beside that one):

* **The train step**: three AdamW steps at pp 2 (vpp 1 and 2) against the
  reference's ``make_train_step``: loss 1e-5 relative, params 1e-5, a
  product chaos scale, the one global verdict, ``consensus_replicas``
  ignored.
* **The re-plan** without a mesh: the loop's ``shrink_plan`` re-plan from
  pp 4 to pp 2 gives the reference's events and params.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import stepfn as jstepfn
from repro.core.recipe import ParallelismConfig as JPlan
from repro.data import DataConfig as JDataConfig
from repro.runtime.chaos import FaultPlan as JFaultPlan
from repro.runtime.fleet import FleetConfig as JFleetConfig
from repro.runtime.fleet import FleetController as JFleet
from repro.session.train import TrainSession as RefTrainSession
from repro_torch.checkpoint import bridge
from repro_torch.checkpoint.bridge import state_from_numpy, state_to_numpy
from repro_torch.core import stepfn
from repro_torch.core.recipe import ParallelismConfig
from repro_torch.data import DataConfig
from repro_torch.runtime.chaos import FaultPlan
from repro_torch.runtime.fleet import FleetConfig, FleetController
from repro_torch.session import TrainSession
from test_torch_pipeline import (BATCH, GAS, KEY, SEQ, _batch, _cfgs, _flat, _setup,
                                 _tensors, _train_cfgs)


# ===========================================================================
# the train step, against the reference's make_train_step
# ===========================================================================

def _chaos(i):
    """Step 0 clean, step 1 a product scale of 0.5, step 2 NaN in one
    micro-batch (the whole step skipped: one global verdict)."""
    return [None, np.array([1.0, 0.5, 1.0, 1.0], np.float32),
            np.array([1.0, np.nan, 1.0, 1.0], np.float32)][i]


@pytest.mark.parametrize("vpp", [1, 2])
def test_train_steps_match_reference(vpp):
    """Three AdamW steps at pp 2 with ``consensus_replicas = 2`` (ignored at
    pp > 1 by both): loss 1e-5 relative, the verdict's metrics, params and
    the first moment within 1e-5."""
    jcfg, cfg, _, _ = _setup()
    jplan = JPlan(pp=2, gas=GAS, vpp=vpp)
    plan = ParallelismConfig(pp=2, gas=GAS, vpp=vpp)
    jtc, tc = _train_cfgs(consensus_replicas=2)
    jstate = jstepfn.init_state(jcfg, jplan, KEY, jtc)
    state = state_from_numpy(bridge.unstack_pipeline(_flat(jstate), jplan))
    jstep = jax.jit(jstepfn.make_train_step(jcfg, jplan, jtc))
    step = stepfn.make_train_step(cfg, plan, tc)
    for i in range(3):
        b = _batch(cfg.vocab_size, seed=i)
        jb = {k: jnp.asarray(v) for k, v in b.items()}
        tb = _tensors(b)
        if _chaos(i) is not None:
            jb["_chaos_grad_scale"] = jnp.asarray(_chaos(i))
            tb["_chaos_grad_scale"] = torch.from_numpy(_chaos(i))
        jstate, jm = jstep(jstate, jb)
        state, m = step(state, tb)
        for k, v in jm.items():
            np.testing.assert_allclose(float(m[k]), float(v), rtol=1e-5, atol=1e-7,
                                       err_msg=(i, k))
    assert float(m["skipped"]) == 1.0 and float(m["n_replicas"]) == 1.0
    assert float(m["nonfinite_micros"]) == 1.0 and float(m["bad_micro_bits"]) == 1.0
    want = bridge.unstack_pipeline(_flat(jstate), jplan)
    got = state_to_numpy(state)
    assert set(got) == set(want)
    for k, w in want.items():
        if k.startswith(("params/", "opt/m/")):
            np.testing.assert_allclose(got[k], w, atol=1e-5, rtol=1e-5, err_msg=k)


# ===========================================================================
# the re-plan, without a mesh
# ===========================================================================

def _replan_run(pkg, init, d):
    """pp 4 at dp 1 with a fleet of 2 replicas: losing replica 1 at step 7
    halves the pipeline (``shrink_plan``), restoring the step-4
    checkpoint."""
    jcfg, cfg = _cfgs(n_layers=4)
    rs = dict(max_consecutive_skips=3)
    if pkg == "ref":
        sess = RefTrainSession(jcfg, plan=JPlan(pp=4, gas=4), seed=0,
                               train_cfg=_train_cfgs(**rs)[0],
                               data_cfg=JDataConfig(seq_len=SEQ, global_batch=BATCH))
        fleet, faults = JFleet(2, JFleetConfig(straggler_factor=float("inf"))), JFaultPlan
    else:
        sess = TrainSession(cfg, plan=ParallelismConfig(pp=4, gas=4), seed=0, device="cpu",
                            train_cfg=_train_cfgs(**rs)[1],
                            data_cfg=DataConfig(seq_len=SEQ, global_batch=BATCH))
        sess.state = state_from_numpy(init)
        fleet, faults = FleetController(2, FleetConfig(straggler_factor=float("inf"))), FaultPlan
    out = sess.run(10, ckpt_dir=d, ckpt_every=4, async_ckpt=False, log_every=1,
                   chaos=faults(lose_replica={7: 1}), fleet=fleet, log=lambda _m: None)
    return out, sess


def test_fleet_replan_halves_the_pipeline(tmp_path):
    """The loop's re-plan from pp 4 to pp 2 without a mesh: the reference's
    events, plan, losses (1e-5) and final params (1e-5)."""
    ro, rsess = _replan_run("ref", None, str(tmp_path / "r"))
    init = bridge.unstack_pipeline(_flat(RefTrainSession(
        _cfgs(n_layers=4)[0], plan=JPlan(pp=4, gas=4), seed=0,
        data_cfg=JDataConfig(seq_len=SEQ, global_batch=BATCH)).state), JPlan(pp=4, gas=4))
    po, psess = _replan_run("port", init, str(tmp_path / "p"))
    ev = lambda out: [(e.step, e.kind) for e in out["events"] if e.kind != "straggler"]
    assert ev(po) == ev(ro) and ("replan" in [k for _, k in ev(po)])
    assert po["plan"].pp == ro["plan"].pp == 2 and po["plan"].gas == ro["plan"].gas
    assert psess.plan.pp == 2
    rp = [e.detail for e in po["events"] if e.kind == "replan"][0]
    rr = [e.detail for e in ro["events"] if e.kind == "replan"][0]
    for k in ("steps_lost", "restored_step", "old_plan", "new_plan"):
        assert rp[k] == rr[k], k
    assert [h["step"] for h in po["history"]] == [h["step"] for h in ro["history"]]
    np.testing.assert_allclose([h["loss"] for h in po["history"]],
                               [h["loss"] for h in ro["history"]], rtol=1e-5)
    want = bridge.unstack_pipeline(_flat(rsess.state), JPlan(pp=2, gas=4))
    got = state_to_numpy(psess.state)
    for k, w in want.items():
        np.testing.assert_allclose(got[k], w, rtol=1e-5, atol=1e-5, err_msg=k)
