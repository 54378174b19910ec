"""The port's MoE family against the JAX reference, on the CPU.

Reduced ``olmoe_1b_7b`` (4 experts, top 2, no shared experts) and
``deepseek_moe_16b`` (4 routed + 1 shared expert, top 2, a dense first
layer) in f32; the same numpy-seeded weights reach both packages through
the bridge.  Held to the reference:

* **the layer**: ``moe_apply`` against both of the reference's dispatches
  (einsum and sort) at 1 and 2 routing groups with drops present, and with
  every router probability tied: out and aux 1e-5 (bf16: 2e-2);
* **decode against forward** with ``capacity_factor=100`` (5e-5), as
  ``tests/test_decode_consistency.py`` holds the reference;
* **loss and gradients**: ``lm_loss`` and its gradients (loss 1e-5
  relative, gradients 5e-4) under remat "none", "full" and "dots", the
  dense first layer's 1-D leaves undecayed;
* **the rules**: the parameter and optimizer specs ``==`` the reference's
  at tp 1-16 and ZeRO 0-3, for both configs full and reduced;
* **refusals**: pp 2 with a MoE config raises, citing its ROADMAP item.

Serving is held in ``test_torch_moe_serving.py``, three training steps in
``test_torch_moe_train.py``, tp, dp and pp over gloo in
``test_torch_moe_mesh.py``.
"""

import dataclasses
import functools
from pathlib import Path
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import store
from repro.configs import get_config as jget_config
from repro.core import stepfn as jstepfn
from repro.core import zero as jzero
from repro.core.recipe import ParallelismConfig as JPlan
from repro.data import DataConfig as JDataConfig
from repro.models import init_params as jinit_params
from repro.models import moe as jmoe
from repro.models import transformer as jtf
from repro.optim.adamw import AdamWConfig as JAdamW
from repro.runtime.resilience import ResilienceConfig as JResilience
from repro.session.train import TrainSession as RefTrainSession
from repro_torch.checkpoint.bridge import params_from_numpy
from repro_torch.configs import get_config
from repro_torch.core import stepfn, zero
from repro_torch.core.recipe import ParallelismConfig
from repro_torch.core.tree import tree_leaves
from repro_torch.models import api as tapi
from repro_torch.models import moe
from repro_torch.models import transformer as ttf
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.runtime.resilience import ResilienceConfig
from repro_torch.session import TrainSession

ROOT = Path(__file__).resolve().parents[1]
ARCHS = ["olmoe_1b_7b", "deepseek_moe_16b"]
SEQ, BATCH, GAS, LR = 32, 4, 2, 1e-4


def _flat(tree):
    return {k: np.asarray(v) for k, v in store._flatten(tree)}


def _cfgs(arch, **kw):
    """(reference config, port config), reduced, with ``kw`` replaced."""
    return (dataclasses.replace(jget_config(arch).reduced(), **kw),
            dataclasses.replace(get_config(arch).reduced(), **kw))


# ===========================================================================
# the layer
# ===========================================================================

def _layer_inputs(arch, seed, *, router_scale, tied=False):
    jcfg, cfg = _cfgs(arch)
    jp = jmoe.moe_init(jax.random.PRNGKey(seed), jcfg)
    flat = {k: np.asarray(v) for k, v in store._flatten(jp)}
    flat["router"] = np.zeros_like(flat["router"]) if tied else flat["router"] * router_scale
    # a shared offset skews the routing toward a few experts: they overflow
    x = (np.random.RandomState(seed).standard_normal((4, 8, cfg.d_model)) + 0.5).astype(np.float32)
    return jcfg, cfg, flat, x


def _drops(cfg, p, x, G):
    """How many (token, slot)s the port drops on ``x`` in ``G`` groups."""
    xf = torch.from_numpy(x).reshape(-1, cfg.d_model)
    _, idx, _ = moe.route(cfg, p["router"], xf)
    _, lands = moe._slots(cfg, idx, G, moe.capacity(cfg, xf.shape[0] // G), 0,
                          cfg.n_experts)
    return int((~lands).sum())


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("impl", ["einsum", "sort"])
@pytest.mark.parametrize("dtype,groups", [("float32", 1), ("float32", 2), ("bfloat16", 2)])
def test_moe_apply_matches_both_reference_dispatches(arch, groups, impl, dtype):
    """Out and aux against the reference's einsum and sort dispatch, with
    (token, slot)s dropped: 1e-5 in f32, 2e-2 in bf16 (the einsum path
    rounds the combine weights to bf16, the sort path multiplies and adds
    in bf16)."""
    jcfg, cfg, flat, x = _layer_inputs(arch, 3, router_scale=40.0)
    p = params_from_numpy(flat)
    assert _drops(cfg, p, x, groups) > 0
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jp = jax.tree_util.tree_map(jnp.asarray, store_unflatten(flat))
    with jmoe.moe_groups(groups), jmoe.moe_impl(impl):
        want, want_aux = jmoe.moe_apply(jcfg, jp, jnp.asarray(x).astype(jdt))
    with moe.moe_groups(groups):
        got, aux = moe.moe_apply(cfg, p, torch.from_numpy(x).to(tdt))
    tol = 1e-5 if dtype == "float32" else 2e-2
    assert got.dtype == tdt and got.shape == x.shape
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want.astype(jnp.float32)),
                               atol=tol, rtol=tol)
    np.testing.assert_allclose(float(aux), float(want_aux), rtol=1e-5)


def store_unflatten(flat):
    """``{"a/b": x}`` → ``{"a": {"b": x}}``."""
    out = {}
    for k, v in flat.items():
        node = out
        parts = k.split("/")
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = v
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_top_k_ties_go_to_the_lower_expert(arch):
    """A zero router ties every expert: both packages take experts 0..k-1
    for every token (``lax.top_k``'s order, made explicit by a stable
    sort), so the first experts overflow and the same slots drop."""
    jcfg, cfg, flat, x = _layer_inputs(arch, 4, router_scale=1.0, tied=True)
    p = params_from_numpy(flat)
    _, idx, gate_w = moe.route(cfg, p["router"], torch.from_numpy(x).reshape(-1, cfg.d_model))
    assert (idx == torch.arange(cfg.top_k)).all()
    assert torch.allclose(gate_w, torch.full_like(gate_w, 1.0 / cfg.top_k))
    assert _drops(cfg, p, x, 1) > 0
    jp = jax.tree_util.tree_map(jnp.asarray, store_unflatten(flat))
    for impl in ("einsum", "sort"):
        with jmoe.moe_impl(impl):
            want, want_aux = jmoe.moe_apply(jcfg, jp, jnp.asarray(x))
        got, aux = moe.moe_apply(cfg, p, torch.from_numpy(x))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)
        np.testing.assert_allclose(float(aux), float(want_aux), rtol=1e-6)


def test_dispatch_backward_sums_each_token_in_slot_order():
    """The dispatch's backward (a gather over each token's k rows) is the
    gather's autograd gradient; a step's input gradient matches it."""
    jcfg, cfg, flat, x = _layer_inputs("olmoe_1b_7b", 3, router_scale=40.0)
    p = params_from_numpy(flat)
    xf = torch.from_numpy(x).reshape(-1, cfg.d_model)
    _, idx, _ = moe.route(cfg, p["router"], xf)
    C = moe.capacity(cfg, xf.shape[0])
    row, lands = moe._slots(cfg, idx, 1, C, 0, cfg.n_experts)
    src = torch.zeros(cfg.n_experts * C + 1, dtype=torch.long).scatter_(
        0, torch.where(lands, row, cfg.n_experts * C),
        torch.arange(lands.numel()) // cfg.top_k)[:-1]
    dxe = torch.randn(cfg.n_experts * C, cfg.d_model, generator=torch.Generator().manual_seed(0))
    dxe[~torch.isin(torch.arange(dxe.shape[0]), row[lands])] = 0.0   # empty rows: 0
    a = xf.clone().requires_grad_()
    moe._Dispatch.apply(a, src, row, lands, cfg.top_k).backward(dxe)
    b = xf.clone().requires_grad_()
    b.index_select(0, src).backward(dxe)
    np.testing.assert_allclose(a.grad.numpy(), b.grad.numpy(), atol=1e-6, rtol=1e-6)
    assert int((~lands).sum()) > 0


def test_capacity_rounds_half_to_even():
    """``round`` of Python: Tg·k/E·1.25 = 2.5 gives 2 (then k), 7.5 gives 8."""
    cfg = get_config("olmoe_1b_7b").reduced()       # E 4, k 2
    assert moe.capacity(cfg, 4) == 2                # round(2.5) = 2
    assert moe.capacity(cfg, 12) == 8               # round(7.5) = 8
    assert moe.capacity(cfg, 1) == 1                # at most Tg
    full = get_config("deepseek_moe_16b")
    assert moe.capacity(full, 8) == 6 and moe.capacity(full, 4096) == 480


# ===========================================================================
# decode against forward, loss and gradients, train steps
# ===========================================================================

@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_forward_without_drops(arch):
    """The mirror of ``test_moe_decode_matches_forward_nodrop``: with
    ``capacity_factor=100`` nothing drops, so one position at a time gives
    the forward's logits (5e-5)."""
    cfg = dataclasses.replace(get_config(arch).reduced(), capacity_factor=100.0)
    params = tapi.init_params(cfg, torch.Generator().manual_seed(0))
    B, S = 2, 16
    toks = torch.from_numpy(np.random.RandomState(1).randint(0, cfg.vocab_size, (B, S)))
    with torch.no_grad():
        full = tapi.forward(cfg, params, {"tokens": toks})
        caches = tapi.init_cache(cfg, params, B, S)
        assert len(caches.get("pre", [])) == cfg.first_k_dense
        worst = 0.0
        for t in range(S):
            logits, caches = tapi.decode_step(cfg, params, toks[:, t], t, caches)
            worst = max(worst, float((logits - full[:, t]).abs().max()))
    assert worst < 5e-5


def _ref_batch(jcfg, seed=7):
    from repro.data import make_dataset
    return make_dataset(JDataConfig(seq_len=SEQ, global_batch=BATCH, seed=seed), jcfg).batch(0)


@functools.lru_cache(maxsize=None)
def _ref_loss_and_grads(arch):
    """The reference's weights, batch, loss, metrics and gradients (its
    remat policy changes none of them)."""
    jcfg, _ = _cfgs(arch)
    params = jtf.lm_init(jax.random.PRNGKey(3), jcfg)
    batch = _ref_batch(jcfg)
    (loss, metrics), grads = jax.jit(jax.value_and_grad(
        lambda p, b: jtf.lm_loss(jcfg, p, b, remat_policy="full"), has_aux=True))(
            params, batch)
    return params, batch, loss, metrics, grads


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("remat", ["none", "full", "dots"])
def test_lm_loss_and_grads_match_reference(arch, remat):
    """xent, aux, the loss ``xent + 0.01·aux`` (1e-5 relative) and every
    gradient (5e-4), the router's and the experts' included."""
    _, cfg = _cfgs(arch)
    params, batch, loss, metrics, grads = _ref_loss_and_grads(arch)
    tparams = params_from_numpy(_flat(params))
    if cfg.first_k_dense:
        assert isinstance(tparams["pre_blocks"], list) and "mlp" in tparams["pre_blocks"][0]
    leaves = [p.requires_grad_() for _, p in tree_leaves(tparams)]
    tbatch = {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}
    tloss, tmetrics = ttf.lm_loss(cfg, tparams, tbatch, remat_policy=remat)
    tgrads = torch.autograd.grad(tloss, leaves)
    np.testing.assert_allclose(float(tloss.detach()), float(loss), rtol=1e-5)
    for k in ("xent", "aux"):
        np.testing.assert_allclose(float(tmetrics[k].detach()), float(metrics[k]), rtol=1e-5)
    assert float(tmetrics["aux"].detach()) > 0
    want = tree_leaves(params_from_numpy(_flat(grads)))
    assert [p for p, _ in want] == [p for p, _ in tree_leaves(tparams)]
    for (p, w), g in zip(want, tgrads):
        np.testing.assert_allclose(g.numpy(), w.numpy(), atol=5e-4, rtol=5e-4,
                                   err_msg=str(p))


def _train_cfgs(**res):
    kw = dict(peak_lr=LR, warmup=2, total_steps=10)
    return (jstepfn.TrainConfig(adam=JAdamW(), resilience=JResilience(**res), **kw),
            stepfn.TrainConfig(adam=AdamWConfig(), resilience=ResilienceConfig(**res), **kw))


def _ref_session(jcfg, **res):
    return RefTrainSession(jcfg, plan=JPlan(gas=GAS), seed=5,
                           data_cfg=JDataConfig(seq_len=SEQ, global_batch=BATCH, seed=7),
                           train_cfg=_train_cfgs(**res)[0])


@functools.lru_cache(maxsize=None)
def _ref_steps(arch, n_steps=3):
    """The reference's initial parameters and state, its first batch, its
    ``n_steps`` steps' metrics and its states after the first and the last
    (the three-step test takes three, the gloo world's tp cases one)."""
    ref = _ref_session(_cfgs(arch)[0])
    params = jax.tree_util.tree_map(lambda x: jnp.array(x, copy=True), ref.state["params"])
    out = SimpleNamespace(params=params, initial=_flat(ref.state), batch=ref.batches(0),
                          metrics=[])
    for i in range(n_steps):
        out.metrics.append({k: float(v) for k, v in ref.step().items()})
        if i == 0:
            out.after1 = _flat(ref.state)
    out.after = _flat(ref.state)
    return out

def test_weight_decay_follows_the_reference_rank_of_pre_blocks():
    """deepseek's dense first layer is unstacked in the reference: its 1-D
    norm scales get no weight decay, while every leaf under ``blocks`` (a
    stacked rank of at least 2) does."""
    from repro_torch.optim import adamw
    cfg = get_config("deepseek_moe_16b").reduced()
    params = tapi.init_params(cfg, torch.Generator().manual_seed(0))
    ranks = {path: adamw.reference_rank(path, x) for path, x in tree_leaves(params)}
    assert ranks[("pre_blocks", 0, "norm1", "scale")] == 1
    assert ranks[("blocks", 0, "norm1", "scale")] == 2
    assert ranks[("blocks", 0, "moe", "w_gate")] == 4


def test_full_configs_load_and_count_the_reference_params():
    for arch, n in (("olmoe_1b_7b", 6_816_000_000), ("deepseek_moe_16b", 16_376_000_000)):
        cfg = get_config(arch)
        assert cfg.family == "moe" and cfg.hd == 128
        assert cfg.n_params() == jget_config(arch).n_params()
        assert abs(cfg.n_params() - n) < 1e6


# ===========================================================================
# the rules
# ===========================================================================

@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("reduced", [False, True], ids=["full", "reduced"])
@pytest.mark.parametrize("zero_stage", [0, 1, 2, 3])
def test_rules_equal_reference(arch, reduced, zero_stage):
    """Every leaf's parameter and optimizer-state spec ``==`` the
    reference's (``zero.param_shardings``/``opt_shardings`` with the
    family's hints) at tp 1, 2, 4, 8 and 16 over dp 2; the reference's
    stacked leaves without their layer axis.  At reduced size tp 8 and 16
    do not divide the 4 experts, which stay whole."""
    jcfg = jget_config(arch).reduced() if reduced else jget_config(arch)
    params = jax.eval_shape(lambda k: jinit_params(jcfg, k), jax.random.PRNGKey(0))
    shapes = {"/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path): leaf
              for path, leaf in jax.tree_util.tree_flatten_with_path(params)[0]}
    port_shapes = [(tuple(int(x) if x.isdigit() else x for x in
                          (p.replace("blocks/", "blocks/0/", 1) if p.startswith("blocks/")
                           else p).split("/")),
                    s.shape[1:] if p.startswith("blocks/") else s.shape)
                   for p, s in shapes.items()]
    n_stacked = shapes["blocks/attn/wq"].shape[0]
    assert n_stacked == zero.n_stacked(get_config(arch).reduced() if reduced
                                       else get_config(arch))
    names = ("pod", "data", "pp", "tp")
    hints = zero.family_hints(get_config(arch))
    for tp_size in (1, 2, 4, 8, 16):
        sizes = (1, 2, 1, tp_size)
        jmesh = jax.sharding.AbstractMesh(sizes, names)
        jplan = JPlan(dp=2, tp=tp_size, zero_stage=zero_stage)
        jp = jzero.param_shardings(jcfg, params, jmesh, jplan)
        jo = jzero.opt_shardings(jp, params, jmesh, jplan)
        jp = {k: v for k, v in store._flatten(jp)}
        jo = {k: v for k, v in store._flatten(jo)}
        mesh = SimpleNamespace(shape=dict(zip(names, sizes)), axis_names=names)
        plan = ParallelismConfig(dp=2, tp=tp_size, zero_stage=zero_stage)
        pp_ = zero.param_shardings(port_shapes, mesh, plan, hints=hints)
        po = zero.opt_shardings(pp_, port_shapes, mesh, plan, n_stacked)
        for (path, leaf), (ppath, shape) in zip(shapes.items(), port_shapes):
            k = 1 if path.startswith("blocks/") else 0
            n = len(leaf.shape)
            want_p = tuple(jp[path].spec) + (None,) * (n - len(jp[path].spec))
            want_o = tuple(jo[path].spec) + (None,) * (n - len(jo[path].spec))
            assert tuple(pp_[ppath]) + (None,) * (len(shape) - len(pp_[ppath])) == \
                want_p[k:], (tp_size, path)
            assert want_o[:k] == (None,) * k, (tp_size, path)
            assert tuple(po[ppath]) + (None,) * (len(shape) - len(po[ppath])) == \
                want_o[k:], (tp_size, path, "opt")
        expert = pp_[("blocks", 0, "moe", "w_gate")]
        E = shapes["blocks/moe/w_gate"].shape[1]
        assert expert[0] == ("tp" if E % tp_size == 0 else None)
        assert pp_[("blocks", 0, "moe", "router")][1] is None


def test_family_hints_equal_reference():
    for arch in ARCHS:
        assert zero.family_hints(get_config(arch)) == jzero.family_hints(jget_config(arch))
    assert zero.family_hints(get_config("granite_3_2b")) == ()


# ===========================================================================
# refusals
# ===========================================================================

def test_pp_refuses_an_unsplittable_moe_stack_and_builds_olmoe():
    """deepseek-moe's stacked blocks (its layers after the dense first one)
    divide by no pp·vpp > 1: the port raises a ``ValueError`` naming the
    stack where the reference asserts in ``stack_for_pipeline``, at its own
    depth and at its reduced one.  olmoe at pp 2 builds its train state."""
    full = get_config("deepseek_moe_16b")
    for pp, vpp, gas in ((2, 1, 2), (4, 1, 4), (2, 2, 2), (7, 1, 7)):
        with pytest.raises(ValueError, match="divisible by|does not divide"):
            stepfn.check_plan(ParallelismConfig(pp=pp, vpp=vpp, gas=gas), None, full)
    red = get_config("deepseek_moe_16b").reduced()
    with pytest.raises(ValueError, match="stacked blocks, 1 layers after 1 unstacked"):
        TrainSession(red, plan=ParallelismConfig(pp=2, gas=2), device="cpu")
    with pytest.raises(AssertionError, match="layers 1 not divisible by pp"):
        jstepfn.init_state(jget_config("deepseek_moe_16b").reduced(), JPlan(pp=2, gas=2),
                           jax.random.PRNGKey(0))
    cfg = dataclasses.replace(get_config("olmoe_1b_7b").reduced(), n_layers=4)
    sess = TrainSession(cfg, plan=ParallelismConfig(pp=2, gas=2), device="cpu")
    assert len(sess.state["params"]["blocks"]) == 4
    assert not hasattr(stepfn, "MOE_PP")


def test_other_families_still_raise():
    """Every architecture of the reference builds now (the xLSTM and the
    encoder-decoder were the last); what those two still refuse is a mesh
    or a pipeline (ROADMAP Queue 1, item 3.8), where the MoE family runs,
    and a family the reference does not have raises as its registry does."""
    from repro_torch.models import registry
    for arch in ("xlstm_125m", "whisper_base"):
        cfg = get_config(arch).reduced()
        with pytest.raises(NotImplementedError, match="Queue 1, item 3"):
            stepfn.check_plan(ParallelismConfig(pp=2, gas=2), None, cfg)
    stepfn.check_plan(ParallelismConfig(pp=2, gas=2), None,
                      dataclasses.replace(get_config("olmoe_1b_7b").reduced(), n_layers=4))
    with pytest.raises(KeyError, match="unknown model family"):
        registry.family_of(dataclasses.replace(get_config("olmoe_1b_7b"), family="rwkv"))
