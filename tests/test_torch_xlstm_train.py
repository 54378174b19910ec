"""The port's xLSTM family (``xlstm_125m``) trained, against the JAX
reference, on the CPU, in f32 at ``reduced()`` (4 layers, sLSTM at {1,
3}), the reference's states bridged to the port:

* three ``TrainSession`` steps at gas 2 over 300 positions (three mLSTM
  chunks, the last ragged): metrics 1e-5 and params 1e-5, the unstacked
  layers' 1-D leaves undecayed as in the reference; one step under remat
  "dots" and "stage" equal to remat "full"'s; ``evaluate`` and
  ``perplexity``;
* the state written back through the bridge is the reference's tree;
* the training CLI at ``--reduced``: a crash, then the resume.

``_steps``, ``_session`` and ``check_*`` take the architecture, so
``tests/test_torch_whisper_train.py`` runs the same checks.
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
from repro_torch.optim import adamw
from repro_torch.session import EvalSession, TrainSession
from test_torch_hybrid import _one_thread  # noqa: F401 (autouse)
from test_torch_moe import _flat, _train_cfgs
from test_torch_moe_pipeline import _params_close

ARCH = "xlstm_125m"
BATCH, GAS = 4, 2


def _cfgs(arch, **kw):
    return (dataclasses.replace(jget_config(arch).reduced(), **kw),
            dataclasses.replace(get_config(arch).reduced(), **kw))


def _data(seq):
    return (JDataConfig(seq_len=seq, global_batch=BATCH, seed=7),
            DataConfig(seq_len=seq, global_batch=BATCH, seed=7))


@functools.lru_cache(maxsize=None)
def _steps(arch, seq, cfg_kw=(), n_steps=3):
    """The reference on one device at gas 2: its initial state, each step's
    metrics and its state after each step."""
    jcfg, _ = _cfgs(arch, **dict(cfg_kw))
    ref = RefTrainSession(jcfg, plan=JPlan(gas=GAS), seed=5, train_cfg=_train_cfgs()[0],
                          data_cfg=_data(seq)[0])
    initial = _flat(ref.state)
    metrics, states = [], []
    for i in range(n_steps):
        metrics.append({k: float(v) for k, v in ref.step(ref.batches(i)).items()})
        states.append(_flat(ref.state))
    return SimpleNamespace(ref=ref, initial=initial, metrics=metrics, states=states)


def _session(arch, seq, cfg_kw=(), plan=None):
    _, cfg = _cfgs(arch, **dict(cfg_kw))
    return TrainSession(cfg, plan=plan or ParallelismConfig(gas=GAS), device="cpu",
                        train_cfg=_train_cfgs()[1], data_cfg=_data(seq)[1])


def check_three_steps(arch, seq, cfg_kw=()):
    """Three AdamW steps: loss, xent, grad_norm, lr and the gate's verdict
    1e-5, every parameter after them 1e-5; → the port's final state."""
    r = _steps(arch, seq, cfg_kw)
    sess = _session(arch, seq, cfg_kw)
    sess.state = state_from_numpy(r.initial)
    for i, mr in enumerate(r.metrics):
        mp = sess.step(sess.batches(i))
        for k in ("loss", "xent", "grad_norm", "lr", "skipped"):
            np.testing.assert_allclose(float(mp[k]), mr[k], rtol=1e-5, atol=1e-7, err_msg=k)
    got = state_to_numpy(sess.state)
    _params_close(got, r.states[-1], r.metrics[-1]["lr"])
    assert set(got) == set(r.states[-1])
    return sess


def check_remat_policy(arch, seq, remat, cfg_kw=()):
    """One step under ``remat``: the loss, grad_norm and params of remat
    "full"."""
    r = _steps(arch, seq, cfg_kw)
    out = {}
    for policy in ("full", remat):
        sess = _session(arch, seq, cfg_kw, ParallelismConfig(gas=GAS, remat_policy=policy))
        sess.state = state_from_numpy(r.initial)
        out[policy] = ({k: float(v) for k, v in sess.step(sess.batches(0)).items()},
                       state_to_numpy(sess.state))
    for k in ("loss", "grad_norm"):
        np.testing.assert_allclose(out[remat][0][k], out["full"][0][k], rtol=1e-6, err_msg=k)
    for k, v in out["full"][1].items():
        np.testing.assert_allclose(out[remat][1][k], v, atol=1e-6, rtol=1e-6, err_msg=k)


def check_eval(arch, seq, cfg_kw=()):
    r = _steps(arch, seq, cfg_kw)
    sess = _session(arch, seq, cfg_kw)
    sess.state = state_from_numpy(r.states[-1])
    mr = r.ref.evaluate(r.ref.batches(7))
    np.testing.assert_allclose(float(sess.evaluate(sess.batches(7))["xent"]),
                               float(mr["xent"]), rtol=1e-5)
    want = RefEval(r.ref.cfg, params=r.ref.state["params"]).perplexity(
        r.ref.batches(i) for i in (8, 9))
    got = EvalSession.from_train_session(sess).perplexity(sess.batches(i) for i in (8, 9))
    assert got["n_tokens"] == want["n_tokens"]
    np.testing.assert_allclose(got["perplexity"], want["perplexity"], rtol=1e-5)


def check_cli(arch, tmp_path, seq):
    from repro_torch.checkpoint import store
    from repro_torch.launch import train as launch_train
    args = ["--arch", arch, "--reduced", "--steps", "4", "--seq", str(seq), "--batch", "2",
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


SEQ = 300


def test_three_steps_match_reference():
    """At S 300; the unstacked layers' 1-D leaves (norms, gate biases)
    take no weight decay, as in the reference, where every xLSTM layer is
    unstacked: with a zero gradient such a leaf would not move at all."""
    sess = check_three_steps(ARCH, SEQ)
    p = sess.state["params"]["pre_blocks"]
    for path, leaf, rank in ((("pre_blocks", 0, "b_igate"), p[0]["b_igate"], 1),
                             (("pre_blocks", 1, "bf"), p[1]["bf"], 1),
                             (("pre_blocks", 0, "conv"), p[0]["conv"], 2),
                             (("pre_blocks", 1, "ro"), p[1]["ro"], 3)):
        assert adamw.reference_rank(path, leaf) == rank, path


@pytest.mark.parametrize("remat", ["dots", "stage"])
def test_remat_policies_take_the_full_policys_step(remat):
    check_remat_policy(ARCH, SEQ, remat)


def test_evaluate_and_perplexity_match_reference():
    check_eval(ARCH, SEQ)


def test_train_cli_crash_then_resume_on_cpu(tmp_path):
    check_cli(ARCH, tmp_path, 40)
