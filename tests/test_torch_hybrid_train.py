"""The port's hybrid family (``hymba_15b``) trained, against the JAX
reference, on the CPU, in f32, the reference's weights and states bridged
to the port:

* three ``TrainSession`` steps at gas 2 on one device (the 5-layer cut of
  ``test_torch_hybrid``, 48 positions: past the window of 32), metrics
  1e-5 and params 1e-5; one step under remat "dots" and "stage" equal to
  remat "full"'s; ``evaluate`` and ``perplexity``;
* the training CLI at ``--reduced``: a crash, then the resume.

The pipeline and the gloo world are in ``test_torch_hybrid_pipeline.py``.
"""

import contextlib
import dataclasses
import functools
import io
from types import SimpleNamespace

import numpy as np
import pytest

from repro.configs import get_config as jget_config
from repro.core.recipe import ParallelismConfig as JPlan
from repro.data import DataConfig as JDataConfig
from repro.session.evalsess import EvalSession as RefEval
from repro.session.train import TrainSession as RefTrainSession
from repro_torch.checkpoint.bridge import state_from_numpy, state_to_numpy
from repro_torch.configs import get_config
from repro_torch.core.recipe import ParallelismConfig
from repro_torch.data import DataConfig
from repro_torch.session import EvalSession, TrainSession
from test_torch_hybrid import _one_thread  # noqa: F401 (autouse)
from test_torch_moe import _flat, _train_cfgs
from test_torch_moe_pipeline import _params_close

ARCH = "hymba_15b"
SEQ, BATCH, GAS = 48, 4, 2
STEP_LAYERS = 5


def _cfgs(n_layers):
    return (dataclasses.replace(jget_config(ARCH).reduced(), n_layers=n_layers),
            dataclasses.replace(get_config(ARCH).reduced(), n_layers=n_layers))


def _data():
    return (JDataConfig(seq_len=SEQ, global_batch=BATCH, seed=7),
            DataConfig(seq_len=SEQ, global_batch=BATCH, seed=7))


@functools.lru_cache(maxsize=None)
def _ref_steps(n_steps=3, n_layers=STEP_LAYERS, **res):
    """The reference on one device at gas 2: its initial state, its first
    batch, each step's metrics and its state after each step."""
    jcfg, _ = _cfgs(n_layers)
    ref = RefTrainSession(jcfg, plan=JPlan(gas=GAS), seed=5, train_cfg=_train_cfgs(**res)[0],
                          data_cfg=_data()[0])
    initial, batch = _flat(ref.state), ref.batches(0)
    metrics, states = [], []
    for i in range(n_steps):
        metrics.append({k: float(v) for k, v in ref.step(ref.batches(i)).items()})
        states.append(_flat(ref.state))
    return SimpleNamespace(ref=ref, initial=initial, batch=batch, metrics=metrics,
                           states=states)


def _session(plan=None, mesh=None, n_layers=STEP_LAYERS, **res):
    _, cfg = _cfgs(n_layers)
    return TrainSession(cfg, plan=plan or ParallelismConfig(gas=GAS), mesh=mesh, device="cpu",
                        train_cfg=_train_cfgs(**res)[1], data_cfg=_data()[1])


def test_three_steps_match_reference():
    """Three AdamW steps at gas 2 (remat full): loss, xent, grad_norm, lr
    and the gate's verdict 1e-5; every parameter after them 1e-5 (the SSM's
    ``(H,)`` vectors take weight decay as the reference's ``(L, H)``)."""
    r = _ref_steps()
    sess = _session()
    sess.state = state_from_numpy(r.initial)
    for i, mr in enumerate(r.metrics):
        mp = sess.step(sess.batches(i))
        for k in ("loss", "xent", "grad_norm", "lr", "skipped"):
            np.testing.assert_allclose(float(mp[k]), mr[k], rtol=1e-5, atol=1e-7, err_msg=k)
    _params_close(state_to_numpy(sess.state), r.states[-1], r.metrics[-1]["lr"])


@pytest.mark.parametrize("remat", ["dots", "stage"])
def test_remat_policies_take_the_full_policys_step(remat):
    """One step under remat "dots" and "stage" (= "full" at pp 1): the
    loss, grad_norm and params of remat "full"."""
    r = _ref_steps()
    out = {}
    for policy in ("full", remat):
        sess = _session(ParallelismConfig(gas=GAS, remat_policy=policy))
        sess.state = state_from_numpy(r.initial)
        out[policy] = ({k: float(v) for k, v in sess.step(sess.batches(0)).items()},
                       state_to_numpy(sess.state))
    for k in ("loss", "grad_norm"):
        np.testing.assert_allclose(out[remat][0][k], out["full"][0][k], rtol=1e-6, err_msg=k)
    for k, v in out["full"][1].items():
        np.testing.assert_allclose(out[remat][1][k], v, atol=1e-6, rtol=1e-6, err_msg=k)


def test_evaluate_and_perplexity_match_reference():
    r = _ref_steps()
    sess = _session()
    sess.state = state_from_numpy(r.states[-1])
    batch = sess.batches(7)
    mr = r.ref.evaluate(r.ref.batches(7))
    np.testing.assert_allclose(float(sess.evaluate(batch)["xent"]), float(mr["xent"]),
                               rtol=1e-5)
    want = RefEval(r.ref.cfg, params=r.ref.state["params"]).perplexity(
        r.ref.batches(i) for i in (8, 9))
    got = EvalSession.from_train_session(sess).perplexity(sess.batches(i) for i in (8, 9))
    assert got["n_tokens"] == want["n_tokens"]
    np.testing.assert_allclose(got["perplexity"], want["perplexity"], rtol=1e-5)


# ===========================================================================
# the CLI
# ===========================================================================

def test_train_cli_crash_then_resume_on_cpu(tmp_path):
    from repro_torch.checkpoint import store
    from repro_torch.launch import train as launch_train
    args = ["--arch", ARCH, "--reduced", "--steps", "4", "--seq", "40", "--batch", "2",
            "--ckpt-every", "2", "--ckpt-dir", str(tmp_path), "--device", "cpu"]
    with contextlib.redirect_stdout(io.StringIO()), pytest.raises(RuntimeError, match="step 3"):
        launch_train.main(args + ["--fail-at", "3"])
    assert store.list_steps(tmp_path) == [2]
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = launch_train.main(args)
    assert "[loop] resumed from checkpoint at step 2" in buf.getvalue()
    assert [h["step"] for h in out["history"]] == [2, 3]
    assert all(np.isfinite(h["loss"]) for h in out["history"])
