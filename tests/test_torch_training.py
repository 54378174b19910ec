"""The port's training slice against the JAX reference, on the CPU.

Reduced configs in f32 (``granite_3_2b``: GQA, RMSNorm, SwiGLU;
``gpt_36b``: MHA, LayerNorm, GELU, tied embeddings).  The reference's
parameters and whole train states cross over by path
(``checkpoint/bridge.py``).  Held to the reference: ``lm_loss`` and its
gradients (on the reference's einsum path and its Pallas path in interpret
mode, with and without packed segments, under both remat policies), three
``TrainSession.step`` calls (loss traces, metrics and params, for gas 1 and
2, without compression and with int8 error feedback), the traps of the
port (weight decay by the reference's stacked rank, a NaN micro-batch, an
all-NaN step), the data pipeline, and the hand-off to serving.  Tolerances:
loss 1e-5 relative, gradients 5e-4, params after three steps 1e-5.
"""

import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.checkpoint import store
from repro.configs import get_config as jget_config
from repro.core import stepfn as jstepfn
from repro.core.recipe import ParallelismConfig as JPlan
from repro.data import DataConfig as JDataConfig
from repro.data import make_dataset as jmake_dataset
from repro.data.pipeline import batch_fingerprint as jfingerprint
from repro.models import transformer as jtf
from repro.optim.adamw import AdamWConfig as JAdamW
from repro.runtime import flags
from repro.session.train import TrainSession as RefTrainSession
from repro_torch.checkpoint.bridge import params_from_numpy, state_from_numpy
from repro_torch.configs import get_config
from repro_torch.core import stepfn
from repro_torch.core.recipe import ParallelismConfig
from repro_torch.core.tree import tree_leaves, tree_map
from repro_torch.data import DataConfig, make_dataset
from repro_torch.data.pipeline import batch_fingerprint
from repro_torch.kernels import build
from repro_torch.models import transformer as ttf
from repro_torch.optim import adamw
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.session import TrainSession

ROOT = Path(__file__).resolve().parents[1]
ARCHS = ["granite_3_2b", "gpt_36b"]
SEQ, BATCH = 64, 4


def _flat(tree):
    return {k: np.asarray(v) for k, v in store._flatten(tree)}


def _close_trees(port_tree, ref_flat, tol, prefix="params/"):
    """Every leaf of the port's tree against the reference's subtree under
    ``prefix``, bridged."""
    want = params_from_numpy({k[len(prefix):]: v for k, v in ref_flat.items()
                              if k.startswith(prefix)})
    got, exp = tree_leaves(port_tree), tree_leaves(want)
    assert [p for p, _ in got] == [p for p, _ in exp]
    for (path, g), (_, w) in zip(got, exp):
        np.testing.assert_allclose(g.detach().float().numpy(), w.float().numpy(),
                                   atol=tol, rtol=tol, err_msg=str(path))


def _data(pack=False, seed=1234):
    return JDataConfig(seq_len=SEQ, global_batch=BATCH, pack_documents=pack, seed=seed), \
        DataConfig(seq_len=SEQ, global_batch=BATCH, pack_documents=pack, seed=seed)


def _path_ctx(path):
    if path == "pallas":
        return flags.flag_ctx(flash_attention=True, pallas_interpret="1")
    return flags.flag_ctx(flash_attention=False)


# ---------------------------------------------------------------------------
# loss and gradients
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("path", ["default", "pallas"])
@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("remat", ["none", "full"])
def test_lm_loss_and_grads_match_reference(arch, path, packed, remat):
    cfg = get_config(arch).reduced()
    jcfg = jget_config(arch).reduced()
    params = jtf.lm_init(jax.random.PRNGKey(3), jcfg)
    jdc, _ = _data(pack=packed)
    batch = jmake_dataset(jdc, jcfg).batch(0)
    assert ("segment_ids" in batch) == packed
    with _path_ctx(path):
        (loss, metrics), grads = jax.jit(jax.value_and_grad(
            lambda p, b: jtf.lm_loss(jcfg, p, b, remat_policy=remat), has_aux=True))(
                params, batch)

    tparams = params_from_numpy(_flat(params))
    leaves = [p.requires_grad_() for _, p in tree_leaves(tparams)]
    tbatch = {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}
    tloss, tmetrics = ttf.lm_loss(cfg, tparams, tbatch, remat_policy=remat)
    tgrads = torch.autograd.grad(tloss, leaves)
    np.testing.assert_allclose(float(tloss.detach()), float(loss), rtol=1e-5)
    assert set(tmetrics) == set(metrics) == {"xent", "aux"}
    assert float(tmetrics["aux"]) == float(metrics["aux"]) == 0.0
    want = tree_leaves(params_from_numpy(_flat(grads)))
    assert len(want) == len(tgrads)
    for (p, w), g in zip(want, tgrads):
        np.testing.assert_allclose(g.numpy(), w.numpy(), atol=5e-4, rtol=5e-4,
                                   err_msg=str(p))


def test_unported_remat_policies_and_plans_raise():
    """Remat "dots"/"stage", tp and pp still raise; dp (and pods) and the
    simulated-replica consensus are accepted without a mesh, as the
    reference accepts them."""
    cfg = get_config("granite_3_2b").reduced()
    sess = TrainSession(cfg, device="cpu", data_cfg=_data()[1])
    for policy in ("dots", "stage"):
        with pytest.raises(NotImplementedError, match="remat_policy"):
            ttf.lm_loss(cfg, sess.state["params"], sess._to_device(sess.batches(0)),
                        remat_policy=policy)
    for plan in (ParallelismConfig(tp=2), ParallelismConfig(pp=2)):
        with pytest.raises(NotImplementedError, match="one device"):
            TrainSession(cfg, plan=plan, device="cpu")
    from repro_torch.runtime.resilience import ResilienceConfig
    tcfg = stepfn.TrainConfig(resilience=ResilienceConfig(consensus_replicas=2))
    for plan in (ParallelismConfig(dp=2), ParallelismConfig(pods=2)):
        s = TrainSession(cfg, plan=plan, train_cfg=tcfg, device="cpu", data_cfg=_data()[1])
        assert float(s.step()["n_replicas"]) == 2.0
    stepfn.make_train_step(cfg, ParallelismConfig(), tcfg)


# ---------------------------------------------------------------------------
# train steps
# ---------------------------------------------------------------------------

def _sessions(arch="granite_3_2b", *, gas=1, compression=None, weight_decay=0.1,
              peak_lr=1e-4, pack=False):
    """(reference session, port session on the CPU holding the reference's
    train state), the same recipe on both sides."""
    jdc, dc = _data(pack=pack)
    ref = RefTrainSession.from_recipe(
        arch, reduced=True, plan=JPlan(gas=gas), data_cfg=jdc, seed=5,
        train_cfg=jstepfn.TrainConfig(peak_lr=peak_lr, warmup=2, total_steps=10,
                                      compression=compression,
                                      adam=JAdamW(weight_decay=weight_decay)))
    port = TrainSession.from_recipe(
        arch, reduced=True, plan=ParallelismConfig(gas=gas), data_cfg=dc, device="cpu",
        train_cfg=stepfn.TrainConfig(peak_lr=peak_lr, warmup=2, total_steps=10,
                                     compression=compression,
                                     adam=AdamWConfig(weight_decay=weight_decay)))
    port.state = state_from_numpy(_flat(ref.state))
    return ref, port


def _step_both(ref, port, n, batch_fn=None):
    out = []
    for i in range(n):
        batch = None if batch_fn is None else batch_fn(i)
        mr, mp = ref.step(batch), port.step(batch)
        out.append(({k: float(v) for k, v in mr.items()}, {k: float(v) for k, v in mp.items()}))
    return out


def _leaf_diffs(port_tree, ref_flat, prefix):
    want = params_from_numpy({k[len(prefix):]: v for k, v in ref_flat.items()
                              if k.startswith(prefix)})
    return [(path, (g.detach().float() - w.float()).abs())
            for (path, g), (_, w) in zip(tree_leaves(port_tree), tree_leaves(want))]


@pytest.mark.parametrize("gas", [1, 2])
@pytest.mark.parametrize("compression", [None, "int8_ef"])
def test_three_steps_match_reference(gas, compression):
    """Loss traces, metrics and params after three steps.  At peak_lr 1e-4:
    Adam turns the f32-level differences of a near-zero gradient entry into
    an update difference of the order of the LR (at 1e-3 single entries
    exceed 1e-5).  With int8 error feedback a gradient entry that sits on
    a rounding tie can round the other way (the gradients agree to f32
    noise, not bitwise); such an entry shows as a whole quantization step in
    ``ef``.  Params and ``ef`` agree within 1e-5 everywhere else, and ties
    must stay rare."""
    ref, port = _sessions(gas=gas, compression=compression)
    build.launch_counts.clear()
    for mr, mp in _step_both(ref, port, 3):
        assert set(mp) == set(mr)
        np.testing.assert_allclose(mp["loss"], mr["loss"], rtol=1e-5)
        for k in ("xent", "grad_norm", "lr", "skipped", "all_finite", "nonfinite_micros",
                  "bad_micro_bits", "n_replicas", "bad_replicas", "gnorm_z"):
            np.testing.assert_allclose(mp[k], mr[k], rtol=1e-5, atol=1e-6, err_msg=k)
        assert mp["skipped"] == 0.0
    assert sum(build.launch_counts.values()) == 0     # the CPU takes the plain versions
    want = _flat(ref.state)
    assert int(port.state["step"]) == int(port.state["opt"]["step"]) == 3
    params = _leaf_diffs(port.state["params"], want, "params/")
    if compression is None:
        _close_trees(port.state["params"], want, 1e-5)
        return
    ef = _leaf_diffs(port.state["ef"], want, "ef/")
    ties = [d > 1e-5 for _, d in ef]
    n_ties, n = sum(int(t.sum()) for t in ties), sum(t.numel() for t in ties)
    assert n_ties <= 1e-4 * n, (n_ties, n)
    for (path, d), tie in zip(params, ties):
        assert float(torch.where(tie, 0.0, d).max()) <= 1e-5, path


@pytest.mark.parametrize("remat,fwd_per_layer", [("full", 2), ("none", 1)])
def test_remat_recomputes_the_flash_forward_once_per_block(monkeypatch, remat, fwd_per_layer):
    """Trap (d): per step with gas G and L layers the flash forward runs
    2·L·G times under remat "full" (forward, then again in the backward) and
    L·G under "none"; the backward L·G times either way."""
    from repro_torch.kernels import flash_attention as fa
    calls = {"fwd": 0, "dq": 0}

    def counted(name, fn):
        def wrapper(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return wrapper

    monkeypatch.setattr(fa, "flash_fwd_plain", counted("fwd", fa.flash_fwd_plain))
    monkeypatch.setattr(fa, "flash_dq_plain", counted("dq", fa.flash_dq_plain))
    sess = TrainSession.from_recipe(
        "granite_3_2b", reduced=True, device="cpu",
        plan=ParallelismConfig(gas=2, remat_policy=remat),
        data_cfg=DataConfig(seq_len=16, global_batch=4))
    sess.step()
    L, G = sess.cfg.n_layers, 2
    assert calls == {"fwd": fwd_per_layer * L * G, "dq": L * G}


def test_compression_matches_reference_on_equal_gradients():
    """The same stacked gradients and error feedback through the reference's
    ``apply_compression`` and the port's (one int8 scale per stacked leaf)."""
    from repro.optim.compress import apply_compression as japply
    from repro_torch.optim.compress import apply_compression
    ref, _ = _sessions(compression="int8_ef")
    rs = np.random.RandomState(21)
    grads = jax.tree_util.tree_map(
        lambda p: rs.standard_normal(p.shape).astype(np.float32) * 1e-2, ref.state["params"])
    ef = jax.tree_util.tree_map(
        lambda p: rs.standard_normal(p.shape).astype(np.float32) * 1e-4, ref.state["params"])
    tgrads = [g for _, g in tree_leaves(params_from_numpy(_flat(grads)))]
    for kind in ("bf16", "int8_ef"):
        tef = params_from_numpy(_flat(ef))
        want_g, want_ef = japply(grads, kind, ef)
        got = apply_compression(tgrads, kind, tef)
        for g, (_, w) in zip(got, tree_leaves(params_from_numpy(_flat(want_g)))):
            np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-6, atol=0)
        if kind == "int8_ef":
            _close_trees(tef, {f"ef/{k}": v for k, v in _flat(want_ef).items()}, 1e-7,
                         prefix="ef/")


def test_gpt_steps_match_reference_with_packed_documents():
    ref, port = _sessions("gpt_36b", gas=2, pack=True)
    assert "segment_ids" in port.batches(0)
    for mr, mp in _step_both(ref, port, 3):
        np.testing.assert_allclose(mp["loss"], mr["loss"], rtol=1e-5)
    _close_trees(port.state["params"], _flat(ref.state), 1e-5)


def test_weight_decay_follows_the_reference_stacked_rank(monkeypatch):
    """Trap (a): the reference decays every stacked ``blocks`` leaf (its norm
    scales are (L, d)) but not ``final_norm``; the port's per-layer leaves are
    one rank lower.  With a strong decay the port matches the reference, and
    deciding by the port's own rank would not."""
    ref, port = _sessions(weight_decay=0.5)
    flat0 = _flat(ref.state)
    _step_both(ref, port, 2)
    want = _flat(ref.state)
    _close_trees(port.state["params"], want, 1e-5)
    norm = port.state["params"]["blocks"][0]["norm1"]["scale"]
    assert adamw.reference_rank(("blocks", 0, "norm1", "scale"), norm) == 2
    assert adamw.reference_rank(("final_norm", "scale"),
                                port.state["params"]["final_norm"]["scale"]) == 1

    _, naive = _sessions(weight_decay=0.5)
    naive.state = state_from_numpy(flat0)
    monkeypatch.setattr(adamw, "reference_rank", lambda path, p: p.dim())
    for _ in range(2):
        naive.step()
    got = naive.state["params"]["blocks"][0]["norm1"]["scale"].detach().numpy()
    assert np.abs(got - want["params/blocks/norm1/scale"][0]).max() > 3e-5


def test_nan_micro_batch_is_masked_out_as_in_the_reference():
    """gas 2, the second micro-batch's gradients scaled by NaN
    (``_chaos_grad_scale``): dropped from the accumulation, the step taken."""
    ref, port = _sessions(gas=2)

    def batch(i):
        return dict(port.batches(i), _chaos_grad_scale=np.array([1.0, np.nan], np.float32))

    (mr, mp), = _step_both(ref, port, 1, batch)
    assert mp["skipped"] == mr["skipped"] == 0.0
    assert mp["nonfinite_micros"] == mr["nonfinite_micros"] == 1.0
    assert mp["bad_micro_bits"] == mr["bad_micro_bits"] == 2.0
    np.testing.assert_allclose(mp["loss"], mr["loss"], rtol=1e-5)
    _close_trees(port.state["params"], _flat(ref.state), 1e-5)


def test_all_nan_step_is_skipped_and_leaves_params_and_opt_unchanged():
    ref, port = _sessions(gas=2)
    _step_both(ref, port, 1)
    before = {"params": tree_map(torch.clone, port.state["params"]),
              "m": tree_map(torch.clone, port.state["opt"]["m"]),
              "v": tree_map(torch.clone, port.state["opt"]["v"]),
              "opt_step": int(port.state["opt"]["step"]), "step": int(port.state["step"])}

    def batch(i):
        return dict(port.batches(i), _chaos_grad_scale=np.array([np.nan, np.nan], np.float32))

    (mr, mp), = _step_both(ref, port, 1, batch)
    assert mp["skipped"] == mr["skipped"] == 1.0
    assert mp["all_finite"] == mr["all_finite"] == 0.0
    assert mp["nonfinite_micros"] == mr["nonfinite_micros"] == 2.0
    assert np.isnan(mp["loss"]) and np.isnan(mr["loss"])
    for name, tree in (("params", port.state["params"]), ("m", port.state["opt"]["m"]),
                       ("v", port.state["opt"]["v"])):
        for (path, a), (_, b) in zip(tree_leaves(tree), tree_leaves(before[name])):
            assert torch.equal(a, b), (name, path)
    assert int(port.state["opt"]["step"]) == before["opt_step"] == 1
    assert int(port.state["step"]) == before["step"] + 1 == int(ref.state["step"])
    # and the step after it trains on as the reference does
    (mr, mp), = _step_both(ref, port, 1)
    np.testing.assert_allclose(mp["loss"], mr["loss"], rtol=1e-5)
    _close_trees(port.state["params"], _flat(ref.state), 1e-5)


def test_evaluate_and_handoff_to_serving_match_reference():
    ref, port = _sessions()
    _step_both(ref, port, 2)
    batch = port.batches(7)
    mr, mp = ref.evaluate(batch), port.evaluate(batch)
    assert set(mp) == set(mr)
    np.testing.assert_allclose(float(mp["xent"]), float(mr["xent"]), rtol=1e-5)
    prompts = np.random.RandomState(9).randint(0, port.cfg.vocab_size, (2, 12)).astype(np.int32)
    np.testing.assert_array_equal(port.to_inference().generate(prompts, 8).numpy(),
                                  np.asarray(ref.to_inference().generate(prompts, 8)))
    assert port.n_params == ref.n_params


@pytest.mark.parametrize("pack", [False, True])
def test_batches_and_fingerprints_equal_per_seed_and_step(pack):
    jdc, dc = _data(pack=pack, seed=77)
    cfg = get_config("granite_3_2b").reduced()
    ref_ds, port_ds = jmake_dataset(jdc, jget_config("granite_3_2b").reduced()), \
        make_dataset(dc, cfg)
    for step in (0, 1, 5):
        a, b = ref_ds.batch(step), port_ds.batch(step)
        assert set(a) == set(b)
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])
        assert batch_fingerprint(b) == jfingerprint(a)
    assert batch_fingerprint(port_ds.batch(0)) != batch_fingerprint(port_ds.batch(1))


def test_state_from_numpy_splits_every_stacked_subtree():
    ref, _ = _sessions(compression="int8_ef")
    flat = _flat(ref.state)
    state = state_from_numpy(flat)
    L = ref.cfg.n_layers
    for tree in (state["params"], state["opt"]["m"], state["opt"]["v"], state["ef"]):
        assert isinstance(tree["blocks"], list) and len(tree["blocks"]) == L
    np.testing.assert_array_equal(state["opt"]["m"]["blocks"][1]["attn"]["wq"].numpy(),
                                  flat["opt/m/blocks/attn/wq"][1])
    assert state["step"].dtype == torch.int32 and state["step"].dim() == 0
    assert set(state["rstat"]) == {"ema", "var", "n", "rewarm"}
    with pytest.raises(ValueError, match="train state"):
        state_from_numpy({k: v for k, v in flat.items() if k.startswith("params/")})


# ---------------------------------------------------------------------------
# the port stands alone, on the card unless asked
# ---------------------------------------------------------------------------

def test_train_session_needs_cuda_unless_cpu_is_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        TrainSession.from_recipe("granite_3_2b", reduced=True)
    sess = TrainSession.from_recipe("granite_3_2b", reduced=True, device="cpu",
                                    data_cfg=DataConfig(seq_len=16, global_batch=2))
    assert all(p.device.type == "cpu" for _, p in tree_leaves(sess.state))


def test_training_runs_without_jax_or_reference():
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['repro'] = None\n"
        "import math\n"
        "import repro_torch.checkpoint.bridge, repro_torch.runtime.resilience\n"
        "import repro_torch.optim.compress, repro_torch.optim.schedule\n"
        "from repro_torch.core.recipe import ParallelismConfig\n"
        "from repro_torch.data import DataConfig\n"
        "from repro_torch.session import TrainSession\n"
        "s = TrainSession.from_recipe('granite_3_2b', reduced=True, device='cpu',\n"
        "                             plan=ParallelismConfig(gas=2),\n"
        "                             data_cfg=DataConfig(seq_len=16, global_batch=4))\n"
        "losses = [float(s.step()['loss']) for _ in range(2)]\n"
        "assert all(math.isfinite(x) for x in losses), losses\n"
        "assert float(s.evaluate(s.batches(3))['xent']) > 0\n"
        "assert not [m for m, v in sys.modules.items()\n"
        "            if v is not None and (m == 'jax' or m.startswith('jax.'))]\n"
        "print('ok')\n")
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    r = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                       text=True, timeout=300)
    assert r.returncode == 0 and r.stdout.strip() == "ok", r.stderr[-2000:]
