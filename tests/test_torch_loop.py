"""The port's fault-tolerant training loop against the JAX reference, on the CPU.

Reduced granite in f32, both packages from the same weights (the
reference's initial train state carried across by path).  Held to the
reference: the six scenarios of ``benchmarks/run.py:resilience_bench``
(skip, rollback, crash_restart, ckpt_retry, consensus_skip,
replica_loss_replan) through ``TrainSession.run`` with the same fault
plans, cadences and step counts: event kinds and steps (``straggler``
events are timing-driven and left out), every counter, the final plan,
losses (1e-5 relative) and final params (1e-5); at the benchmark's own
settings the port gives exactly the figures in ``BENCH_resilience.json``.
Also: checkpoints cross between the packages both ways (the store and a
resumed ``run``), the store's fault paths, the consensus step, the
trackers, the advisor and the CLI.
"""

import contextlib
import dataclasses
import io
import json
import os
import shutil
import subprocess
import sys
import threading
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.checkpoint import RetryPolicy as JRetryPolicy
from repro.checkpoint import store as jstore
from repro.core import stepfn as jstepfn
from repro.core.recipe import ParallelismConfig as JPlan
from repro.core.recipe import RecipeAdvisor as JAdvisor
from repro.core.systems import TPU_V5E
from repro.data import DataConfig as JDataConfig
from repro.runtime.chaos import FaultPlan as JFaultPlan
from repro.runtime.fleet import FleetController as JFleet
from repro.runtime.resilience import ResilienceConfig as JResilience
from repro.session.tracker import JsonlTracker as JJsonl
from repro.session.train import TrainSession as RefTrainSession
from repro_torch.checkpoint import RetryPolicy, store
from repro_torch.checkpoint.bridge import state_from_numpy, state_to_numpy
from repro_torch.core import stepfn
from repro_torch.core.recipe import ParallelismConfig, RecipeAdvisor
from repro_torch.core.systems import H100_SXM, System
from repro_torch.core.tree import tree_leaves
from repro_torch.data import DataConfig
from repro_torch.launch import train as launch_train
from repro_torch.runtime.chaos import ChaosError, FaultPlan
from repro_torch.runtime.fleet import FleetController
from repro_torch.runtime.resilience import ResilienceConfig
from repro_torch.session import TrainSession
from repro_torch.session.tracker import JsonlTracker

ROOT = Path(__file__).resolve().parents[1]
SEQ, BATCH, LR = 128, 8, 1e-3          # resilience_bench's settings
SCENARIOS = ["skip", "rollback", "crash_restart", "ckpt_retry", "consensus_skip",
             "replica_loss_replan"]


def _flat(tree):
    return {k: np.asarray(v) for k, v in jstore._flatten(tree)}


def _quiet(_msg):
    pass


# ---------------------------------------------------------------------------
# the two packages, side by side
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Pkg:
    name: str
    Session: type
    stepfn: object
    Plan: type
    Data: type
    Faults: type
    Resilience: type
    Retry: type
    Fleet: type


REF = Pkg("ref", RefTrainSession, jstepfn, JPlan, JDataConfig, JFaultPlan, JResilience,
          JRetryPolicy, JFleet)
PORT = Pkg("port", TrainSession, stepfn, ParallelismConfig, DataConfig, FaultPlan,
           ResilienceConfig, RetryPolicy, FleetController)


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    """This module trains many small sessions; two intra-op threads keep it
    from crowding the timing-sensitive tests that other workers run beside
    it (the reference's straggler events are wall-time driven)."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def init_flat():
    """The reference's initial train state (reduced granite, seed 0)."""
    sess = RefTrainSession.from_recipe("granite_3_2b", reduced=True, seed=0,
                                       data_cfg=JDataConfig(seq_len=SEQ, global_batch=BATCH))
    return _flat(sess.state)


def _session(pkg, init, steps, rs_kw=None, plan_kw=None, lr=LR, seq=SEQ, batch=BATCH):
    rs = pkg.Resilience(**(rs_kw or {}))
    sess = pkg.Session.from_recipe(
        "granite_3_2b", reduced=True, seed=0, plan=pkg.Plan(**(plan_kw or {})),
        train_cfg=pkg.stepfn.TrainConfig(peak_lr=lr, warmup=2, total_steps=steps,
                                         resilience=rs),
        data_cfg=pkg.Data(seq_len=seq, global_batch=batch),
        **({"device": "cpu"} if pkg is PORT else {}))
    if pkg is PORT:
        sess.state = state_from_numpy(init)
    return sess


def _scenario(pkg, name, init, d):
    """One resilience_bench scenario on ``pkg`` (checkpoints under ``d``),
    logging every step → the run's output dict and the final train state."""
    run = dict(log_every=1, log=_quiet)
    if name == "skip":
        sess = _session(pkg, init, 12, dict(max_consecutive_skips=3))
        out = sess.run(12, ckpt_dir=d, ckpt_every=4, async_ckpt=False,
                       chaos=pkg.Faults(nan_grad_steps=(6,)), **run)
    elif name == "rollback":
        sess = _session(pkg, init, 16, dict(max_consecutive_skips=3, rewarm_steps=4))
        out = sess.run(16, ckpt_dir=d, ckpt_every=4, async_ckpt=False,
                       chaos=pkg.Faults(nan_grad_steps=(6, 7, 8)), **run)
    elif name == "crash_restart":
        with pytest.raises(RuntimeError, match="injected failure at step 10"):
            _session(pkg, init, 12).run(12, ckpt_dir=d, ckpt_every=4, async_ckpt=False,
                                        chaos=pkg.Faults(crash_at=10), **run)
        sess = _session(pkg, init, 12)
        out = sess.run(12, ckpt_dir=d, ckpt_every=4, async_ckpt=False, **run)
    elif name == "ckpt_retry":
        sess = _session(pkg, init, 8)
        out = sess.run(8, ckpt_dir=d, ckpt_every=4, async_ckpt=False,
                       chaos=pkg.Faults(ckpt_write_failures=2),
                       ckpt_retry=pkg.Retry(attempts=4, backoff_s=0.001, sleep=lambda s: None),
                       **run)
    elif name == "consensus_skip":
        sess = _session(pkg, init, 8, dict(consensus_replicas=2), dict(dp=2))
        out = sess.run(8, chaos=pkg.Faults(replica_nan={4: (1,)}, replicas=2), **run)
    elif name == "replica_loss_replan":
        sess = _session(pkg, init, 12, plan_kw=dict(dp=2))
        out = sess.run(12, ckpt_dir=d, ckpt_every=4, async_ckpt=False,
                       chaos=pkg.Faults(lose_replica={7: 1}), fleet=pkg.Fleet(2), **run)
    else:
        raise KeyError(name)
    return out, sess


def _figures(name, out):
    """The scenario's BENCH_resilience.json figures (timings left out)."""
    ev = lambda kind: next(e for e in out["events"] if e.kind == kind).detail
    if name == "skip":
        return {"injected_nan_steps": 1, "steps_skipped": out["skipped_steps"],
                "rollbacks": out["rollbacks"]}
    if name == "rollback":
        rb = ev("rollback")
        return {k: rb[k] for k in ("steps_lost", "data_skipped", "rewarm_steps")}
    if name == "crash_restart":
        return {"crash_at": 10, "resumed_from": out["resumed_from"],
                "steps_lost": 10 - out["resumed_from"]}
    if name == "ckpt_retry":
        return {"injected_failures": 2, "retry_attempts": 4,
                "write_gave_up": sum(e.kind == "ckpt_write_failed" for e in out["events"]),
                "resumable": out["resumed_from"] is None}
    if name == "consensus_skip":
        return {"replicas": 2, "injected_divergent_replicas": 1,
                "steps_skipped": out["skipped_steps"],
                "verdict": "masked" if not out["skipped_steps"] else "skipped"}
    rp = ev("replan")
    return {"lost_replica_at_step": 7, "replans": out["replans"], "new_dp": out["plan"].dp,
            "steps_lost": rp["steps_lost"]}


@pytest.fixture(scope="module")
def scenarios(init_flat, tmp_path_factory):
    """Every scenario on both packages, once: {name: {pkg: (out, final flat)}}."""
    res = {}
    for name in SCENARIOS:
        res[name] = {}
        for pkg in (REF, PORT):
            d = tmp_path_factory.mktemp(f"{name}_{pkg.name}")
            out, sess = _scenario(pkg, name, init_flat, str(d))
            flat = _flat(sess.state) if pkg is REF else state_to_numpy(sess.state)
            res[name][pkg.name] = (out, flat)
    return res


def _events(out):
    return [(e.step, e.kind) for e in out["events"] if e.kind != "straggler"]


@pytest.mark.parametrize("name", SCENARIOS)
def test_scenario_matches_reference(scenarios, name):
    (ro, rflat), (po, pflat) = scenarios[name]["ref"], scenarios[name]["port"]
    assert _events(po) == _events(ro)
    for k in ("resumed_from", "data_offset", "skipped_steps", "rollbacks", "replans"):
        assert po[k] == ro[k], k
    assert dataclasses.asdict(po["plan"]) == dataclasses.asdict(ro["plan"])
    for pe, re_ in zip([e for e in po["events"] if e.kind != "straggler"],
                       [e for e in ro["events"] if e.kind != "straggler"]):
        for k in ("steps_lost", "data_skipped", "rewarm_steps", "restored_step", "data_index",
                  "batch_hash", "bad_micros", "consecutive", "new_plan", "old_plan"):
            if k in re_.detail:
                assert pe.detail[k] == re_.detail[k], (pe.kind, k)
    assert [h["step"] for h in po["history"]] == [h["step"] for h in ro["history"]]
    for hp, hr in zip(po["history"], ro["history"]):
        assert set(hp) == set(hr)
        np.testing.assert_allclose(hp["loss"], hr["loss"], rtol=1e-5, err_msg=str(hp["step"]))
        for k in ("skipped", "all_finite", "bad_replicas", "n_replicas", "bad_micro_bits",
                  "nonfinite_micros", "lr"):
            np.testing.assert_allclose(hp[k], hr[k], rtol=1e-6, err_msg=k)
    assert set(pflat) == set(rflat)
    for k, want in rflat.items():
        np.testing.assert_allclose(pflat[k], want, rtol=1e-5, atol=1e-5, err_msg=k)


def test_port_reproduces_bench_resilience_figures(scenarios):
    bench = json.loads((ROOT / "BENCH_resilience.json").read_text())["scenarios"]
    for name in SCENARIOS:
        got = _figures(name, scenarios[name]["port"][0])
        want = {k: v for k, v in bench[name].items() if k in got}
        assert got == want, name
    assert _figures("rollback", scenarios["rollback"]["port"][0]) == {
        "steps_lost": 5, "data_skipped": 5, "rewarm_steps": 4}


# ---------------------------------------------------------------------------
# checkpoints cross between the packages
# ---------------------------------------------------------------------------

def test_port_checkpoint_restores_in_reference_and_back(init_flat, tmp_path):
    ref = _session(REF, init_flat, 4)
    port = _session(PORT, init_flat, 4)
    ref.run(2, log=_quiet)
    port.run(2, log=_quiet)
    store.save_checkpoint(tmp_path / "p", 2, port.state, extra={"next_step": 2})
    state, extra, step = jstore.restore_latest(tmp_path / "p", ref.state, log=_quiet)
    assert (step, extra) == (2, {"next_step": 2})
    got, want = _flat(state), state_to_numpy(port.state)
    assert list(got) == list(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    # and the reference's checkpoint into the port
    jstore.save_checkpoint(tmp_path / "r", 3, ref.state, extra={"next_step": 3})
    tstate, extra, step = store.restore_latest(tmp_path / "r", port.state, log=_quiet)
    assert (step, extra) == (3, {"next_step": 3})
    assert all(t.device.type == "cpu" for _, t in tree_leaves(tstate))
    for k, v in _flat(ref.state).items():
        np.testing.assert_array_equal(state_to_numpy(tstate)[k], v, err_msg=k)


@pytest.mark.parametrize("first", ["ref", "port"])
def test_checkpoint_resumes_across_packages_through_the_loop(init_flat, tmp_path, first):
    """One package trains 8 steps (checkpoints every 4), the other resumes
    the directory at step 8 and trains to 12; its losses for steps 8-11
    equal an uninterrupted 12-step run of the first package."""
    a, b = (REF, PORT) if first == "ref" else (PORT, REF)
    small = dict(seq=32, batch=4)
    whole = _session(a, init_flat, 12, **small).run(12, log_every=1, log=_quiet)["history"]
    _session(a, init_flat, 12, **small).run(8, ckpt_dir=tmp_path, ckpt_every=4,
                                            async_ckpt=False, log=_quiet)
    out = _session(b, init_flat, 12, **small).run(12, ckpt_dir=tmp_path, ckpt_every=4,
                                                  async_ckpt=False, log_every=1, log=_quiet)
    assert out["resumed_from"] == 8
    assert [h["step"] for h in out["history"]] == [8, 9, 10, 11]
    np.testing.assert_allclose([h["loss"] for h in out["history"]],
                               [h["loss"] for h in whole[8:]], rtol=1e-5)


# ---------------------------------------------------------------------------
# the store's fault paths
# ---------------------------------------------------------------------------

@pytest.fixture
def small_state():
    sess = TrainSession.from_recipe("granite_3_2b", reduced=True, device="cpu",
                                    data_cfg=DataConfig(seq_len=16, global_batch=2))
    return sess


def _equal_states(a, b):
    fa, fb = state_to_numpy(a), state_to_numpy(b)
    return list(fa) == list(fb) and all(np.array_equal(fa[k], fb[k]) for k in fa)


def test_corrupt_leaf_falls_back_to_the_older_step(small_state, tmp_path):
    sess = small_state
    store.save_checkpoint(tmp_path, 4, sess.state, extra={"next_step": 4})
    sess.step()
    store.save_checkpoint(tmp_path, 8, sess.state, extra={"next_step": 8})
    leaf = tmp_path / "step_00000008" / "leaf_00003.npy"
    arr = np.load(leaf)
    np.save(leaf, arr + 1)
    logs = []
    state, extra, step = store.restore_latest(tmp_path, sess.state, log=logs.append)
    assert step == 4 and extra == {"next_step": 4}
    assert any("step 8 unusable" in m and "corrupt leaf" in m for m in logs)
    assert not _equal_states(state, sess.state)
    shutil.rmtree(tmp_path / "step_00000004")
    assert store.restore_latest(tmp_path, sess.state, log=logs.append) == (None, None, None)


def test_orphan_tmp_is_collected_and_keep_is_honored(small_state, tmp_path):
    (tmp_path / "step_00000099.tmp").mkdir()
    (tmp_path / "step_00000099.tmp" / "leaf_00000.npy").write_bytes(b"partial")
    for s in (1, 2, 3, 4):
        store.save_checkpoint(tmp_path, s, small_state.state, keep=2)
    assert store.list_steps(tmp_path) == [3, 4]
    assert not list(tmp_path.glob("*.tmp"))


def test_retry_policy_absorbs_injected_io_failures(small_state, tmp_path):
    plan = FaultPlan(ckpt_write_failures=2, ckpt_read_failures=1)
    retry = RetryPolicy(attempts=3, backoff_s=0.0, sleep=lambda s: None)
    store.save_checkpoint(tmp_path, 1, small_state.state, retry=retry, log=_quiet,
                          fault_hook=plan.ckpt_write_hook())
    state, _, step = store.restore_latest(tmp_path, small_state.state, retry=retry,
                                          log=_quiet, fault_hook=plan.ckpt_read_hook())
    assert step == 1 and _equal_states(state, small_state.state)
    assert plan.counts() == {"ckpt_write_fail": 2, "ckpt_read_fail": 1}
    # more failures than attempts: the last one surfaces, from the writer too
    plan = FaultPlan(ckpt_write_failures=3)
    with pytest.raises(ChaosError):
        store.save_checkpoint(tmp_path, 2, small_state.state, retry=retry, log=_quiet,
                              fault_hook=plan.ckpt_write_hook())
    plan = FaultPlan(ckpt_partial_leaf=2)
    writer = store.save_checkpoint(tmp_path, 3, small_state.state, background=True,
                                   retry=RetryPolicy(attempts=1), log=_quiet,
                                   fault_hook=plan.ckpt_write_hook())
    assert isinstance(writer.exception(), ChaosError)
    assert store.list_steps(tmp_path) == [1] and (tmp_path / "step_00000003.tmp").exists()


def test_background_write_records_the_state_at_call_time(small_state, tmp_path):
    """The port's step updates the state in place: the snapshot must be a
    copy.  The writer is held before its first leaf until the next step has
    run, so a snapshot of views would record the later step."""
    sess = small_state
    sess.step()
    before = state_to_numpy(sess.state)
    go = threading.Event()
    writer = store.save_checkpoint(tmp_path, 1, sess.state, background=True,
                                   fault_hook=lambda i: go.wait(timeout=60))
    sess.step()
    go.set()
    writer.join()
    after = state_to_numpy(sess.state)
    assert not np.array_equal(after["params/embed"], before["params/embed"])
    state, _, _ = store.restore_latest(tmp_path, sess.state, log=_quiet)
    got = state_to_numpy(state)
    for k in before:
        np.testing.assert_array_equal(got[k], before[k], err_msg=k)


# ---------------------------------------------------------------------------
# the consensus step
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case,nan_rows,mask", [
    ("one_bad_masked", (1,), True), ("all_bad_skipped", (0, 1), True),
    ("one_bad_strict", (1,), False)])
def test_consensus_step_matches_reference(init_flat, case, nan_rows, mask):
    kw = dict(consensus_replicas=2, mask_divergent_replicas=mask)
    small = dict(seq=32, batch=4)          # one row per (replica, micro-batch)
    ref = _session(REF, init_flat, 4, kw, dict(dp=2, gas=2), **small)
    port = _session(PORT, init_flat, 4, kw, dict(dp=2, gas=2), **small)
    clean = dict(port.batches(0), _chaos_grad_scale=np.ones(4, np.float32))
    ref.step(clean)                        # the reference traces its step once
    port.step(clean)
    scale = np.ones((2, 2), np.float32)
    scale[list(nan_rows), :] = np.nan
    batch = dict(port.batches(1), _chaos_grad_scale=scale.reshape(-1))
    mr = {k: float(v) for k, v in ref.step(batch).items()}
    mp = {k: float(v) for k, v in port.step(batch).items()}
    assert set(mp) == set(mr)
    assert mp["n_replicas"] == mr["n_replicas"] == 2.0
    assert mp["bad_replicas"] == mr["bad_replicas"] == float(len(nan_rows))
    assert mp["bad_micro_bits"] == mr["bad_micro_bits"] == 3.0
    assert mp["nonfinite_micros"] == mr["nonfinite_micros"] == 2.0 * len(nan_rows)
    assert mp["skipped"] == mr["skipped"] == float(case != "one_bad_masked")
    for k in ("loss", "xent", "grad_norm", "gnorm_z", "all_finite", "lr"):
        np.testing.assert_allclose(mp[k], mr[k], rtol=1e-5, atol=1e-7, err_msg=k)
    # params within 1e-5; the moments (the first holds the step's clipped
    # gradients) within 1e-5 of each leaf's largest entry
    want, got = _flat(ref.state), state_to_numpy(port.state)
    for k in want:
        scale = float(np.abs(want[k]).max()) if want[k].size else 0.0
        if k.startswith("params/"):
            scale = max(scale, 1.0)
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-5 * scale, err_msg=k)


# ---------------------------------------------------------------------------
# trackers and the advisor
# ---------------------------------------------------------------------------

def test_jsonl_trackers_write_equal_records(tmp_path):
    import jax.numpy as jnp
    ref, port = JJsonl(tmp_path / "r.jsonl"), JsonlTracker(tmp_path / "p.jsonl")
    for t, scalar in ((ref, jnp.float32), (port, lambda x: torch.tensor(x, dtype=torch.float32))):
        t.log_metrics(0, {"loss": scalar(2.5), "lr": 1e-3, "skipped": scalar(0.0)})
        t.log_event(3, "skip", {"grad_norm": scalar(float("nan")), "consecutive": 1,
                                "bad_micros": [0, 2], "batch_hash": "ab12"})
        t.log_event(4, "rollback", {"steps_lost": 5, "restored_step": 0, "reason": None})
        t.finish()
        t.finish()
    assert (tmp_path / "p.jsonl").read_text() == (tmp_path / "r.jsonl").read_text()


def _plans():
    for tp in (1, 8, 16, 32):
        for pp, vpp in ((1, 1), (2, 1), (4, 1), (4, 2)):
            for gas in (1, 4, 8, 16):
                for zero, pods in ((1, 1), (3, 1), (3, 2)):
                    yield dict(tp=tp, pp=pp, vpp=vpp, gas=gas, zero_stage=zero, pods=pods)


def test_recipe_advisor_matches_reference():
    sysm = System(name="ref_fast_domain", peak_flops=0, hbm_bytes=0, hbm_bw=0,
                  fast_domain=TPU_V5E.fast_domain, fast_bw=0, slow_bw=0)
    ref, port = JAdvisor(TPU_V5E), RecipeAdvisor(sysm)
    n = 0
    for kw in _plans():
        for n_layers in (None, 8, 40):
            assert port.check(ParallelismConfig(**kw), n_layers=n_layers) == \
                ref.check(JPlan(**kw), n_layers=n_layers), (kw, n_layers)
            n += 1
    for pack in (False, True):
        for mean in (10.0, 100.0):
            dc = dict(seq_len=128, global_batch=4, pack_documents=pack)
            assert port.check(ParallelismConfig(), data_cfg=DataConfig(**dc), mean_doc_len=mean) \
                == ref.check(JPlan(), data_cfg=JDataConfig(**dc), mean_doc_len=mean)
    for n_layers, devices in ((40, 8), (40, 64), (24, 16)):
        assert dataclasses.asdict(port.suggest(n_layers, devices)) == \
            dataclasses.asdict(ref.suggest(n_layers, devices))
    assert n == 4 * 4 * 4 * 3 * 3
    assert RecipeAdvisor().system is H100_SXM and H100_SXM.fast_domain == 8
    assert "tp" in RecipeAdvisor().check(ParallelismConfig(tp=16))


# ---------------------------------------------------------------------------
# the CLI, and the port standing alone
# ---------------------------------------------------------------------------

CLI = ["--arch", "granite_3_2b", "--reduced", "--steps", "8", "--seq", "32", "--batch", "4",
       "--ckpt-every", "4"]


def test_cli_crash_then_resume_on_cpu(tmp_path):
    args = CLI + ["--ckpt-dir", str(tmp_path), "--device", "cpu"]
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf), pytest.raises(RuntimeError, match="step 6"):
        launch_train.main(args + ["--fail-at", "6"])
    assert store.list_steps(tmp_path) == [4]
    assert "[advisor:pack]" not in buf.getvalue() and "[train] granite" in buf.getvalue()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = launch_train.main(args)
    text = buf.getvalue()
    assert "[loop] resumed from checkpoint at step 4" in text
    assert out["resumed_from"] == 4 and [h["step"] for h in out["history"]] == [4, 5, 6, 7]
    assert "[train] done in" in text and store.list_steps(tmp_path) == [4, 8]


def test_cli_chaos_flags_drive_skip_consensus_and_replan(tmp_path):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = launch_train.main(CLI + ["--ckpt-dir", str(tmp_path), "--device", "cpu",
                                       "--fleet-replicas", "2", "--dp", "2",
                                       "--chaos-replica-nan", "2:1",
                                       "--chaos-lose-replica", "5:1"])
    text = buf.getvalue()
    kinds = [e.kind for e in out["events"] if e.kind != "straggler"]
    assert kinds == ["replica_lost", "replan"] and out["plan"].dp == 1
    assert "[fleet] step 5: replica_lost (replica 1)" in text and "re-plan(s)" in text
    assert out["skipped_steps"] == 0           # the divergent replica was masked


def test_cli_needs_cuda_unless_cpu_is_asked(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        launch_train.main(CLI + ["--ckpt-dir", str(tmp_path)])


def test_loop_runs_without_jax_or_reference(tmp_path):
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['repro'] = None\n"
        "import math\n"
        "import repro_torch.checkpoint, repro_torch.checkpoint.store\n"
        "import repro_torch.checkpoint.elastic, repro_torch.checkpoint.bridge\n"
        "import repro_torch.runtime.flags, repro_torch.runtime.resilience\n"
        "import repro_torch.runtime.watchdog, repro_torch.runtime.chaos\n"
        "import repro_torch.runtime.fleet, repro_torch.runtime.train_loop\n"
        "import repro_torch.session.tracker, repro_torch.core.recipe\n"
        "import repro_torch.core.systems, repro_torch.launch.train\n"
        "import repro_torch.kernels.rmsnorm, repro_torch.kernels.ops\n"
        "from repro_torch.core.recipe import ParallelismConfig\n"
        "from repro_torch.data import DataConfig\n"
        "from repro_torch.runtime.chaos import FaultPlan\n"
        "from repro_torch.session import TrainSession\n"
        "s = TrainSession.from_recipe('granite_3_2b', reduced=True, device='cpu',\n"
        "                             plan=ParallelismConfig(gas=2),\n"
        "                             data_cfg=DataConfig(seq_len=16, global_batch=4))\n"
        f"out = s.run(2, ckpt_dir={str(tmp_path)!r}, ckpt_every=1, log=lambda m: None,\n"
        "            chaos=FaultPlan(nan_grad_steps=(1,), gas=2))\n"
        "assert out['skipped_steps'] == 1 and math.isfinite(out['history'][0]['loss'])\n"
        "assert not [m for m, v in sys.modules.items()\n"
        "            if v is not None and (m == 'jax' or m.startswith('jax.'))]\n"
        "print('ok')\n")
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    r = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                       text=True, timeout=300)
    assert r.returncode == 0 and r.stdout.strip() == "ok", r.stderr[-2000:]
