"""The port's xLSTM family (``xlstm_125m``, ``models/xlstm.py``) against the
JAX reference, on the CPU, in f32: the mLSTM's chunk scan against the
naive recurrence, both blocks and their decode steps, the whole model's
logits, loss and gradients, the parameter count and the planning models,
the bridge's unstacked leaves of two kinds, weight decay, and the
refusals.

The cut is ``reduced()`` (4 layers, sLSTM at {1, 3}, d 64, 4 heads, an
mLSTM inner width of 128).  Its own sequences (the reference's decode test
runs 48 positions) never pass the mLSTM's chunk of 128; here S is 300:
three chunks, the last one ragged, so the chunk carry, the -1e30 padding
of the log input gate and their gradients all take part.  The weights are
the reference's, bridged from its numpy leaves; the inputs are drawn with
numpy from a seed.  Tolerances: outputs and loss 1e-5, gradients 5e-4
(``tests/test_flash_vjp.py``'s).
"""

import dataclasses
import functools
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.core import cost_model as ref_cost
from repro.core import memory as ref_memory
from repro.core import stepfn as jstepfn
from repro.core.recipe import ParallelismConfig as JPlan
from repro.models import api as japi
from repro.models import init_params as jinit_params
from repro.models import transformer as jT
from repro.models import xlstm as jx
from repro_torch.checkpoint.bridge import params_from_numpy, state_to_numpy
from repro_torch.configs import get_config
from repro_torch.core import cost_model, memory, stepfn, zero
from repro_torch.core.recipe import ParallelismConfig
from repro_torch.core.tree import tree_leaves, tree_map
from repro_torch.models import api as tapi
from repro_torch.models import ssm, xlstm
from repro_torch.models import transformer as T
from repro_torch.optim import adamw
from test_torch_hybrid import _one_thread  # noqa: F401 (autouse)
from test_torch_moe import _flat

ARCH = "xlstm_125m"
S = 300                     # three chunks of 128, the last one ragged


@functools.lru_cache(maxsize=None)
def _params():
    jcfg, cfg = jget_config(ARCH).reduced(), get_config(ARCH).reduced()
    jparams = jinit_params(jcfg, jax.random.PRNGKey(0))
    return jcfg, cfg, jparams, _flat(jparams)


def _layer(i):
    """Layer i, the reference's (jnp) and the port's (torch)."""
    _, _, jp, flat = _params()
    return jp["pre_blocks"][i], params_from_numpy(flat)["pre_blocks"][i]


def _x(seed, B, S_, d=64):
    return np.random.default_rng(seed).standard_normal((B, S_, d)).astype(np.float32)


def _batch(seed, B=2, S_=S, vocab=256):
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, vocab, (B, S_)).astype(np.int32),
            "labels": rng.integers(0, vocab, (B, S_)).astype(np.int32)}


def _close(got, want, tol=1e-5, msg=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=tol, rtol=tol,
                               err_msg=msg)


def _named(leaves):
    return {"/".join(map(str, path)): x for path, x in leaves}


# ===========================================================================
# the config and the mLSTM's chunk scan
# ===========================================================================

def test_config_and_param_count_equal_reference():
    """The full config field for field, 160,356,176 parameters, and the
    cut's; the plan (every layer unstacked, sLSTM at {1, 3})."""
    cfg, jcfg = get_config(ARCH), jget_config(ARCH)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert cfg.n_params() == jcfg.n_params() == 160_356_176
    assert cfg.reduced().n_params() == jcfg.reduced().n_params()
    assert xlstm.xlstm_param_count(cfg) == jx.xlstm_param_count(jcfg)
    kinds = ["mlstm", "slstm", "mlstm", "slstm"] + ["mlstm"] * 8
    assert T.layer_plan(cfg) == jT.layer_plan(jcfg) == (None, 0, list(enumerate(kinds)))


def _naive(q, k, v, li, lf):
    """The mLSTM recurrence one position at a time, in f64: the stabilized
    (C, n, m) update of the paper."""
    q, k, v, li, lf = (torch.from_numpy(a).double() for a in (q, k, v, li, lf))
    B, S_, H, D = q.shape
    C = torch.zeros((B, H, D, D), dtype=torch.float64)
    n = torch.zeros((B, H, D), dtype=torch.float64)
    m = torch.full((B, H), float("-inf"), dtype=torch.float64)
    hs = []
    for t in range(S_):
        m_new = torch.maximum(lf[:, t] + m, li[:, t])
        fg, ig = torch.exp(lf[:, t] + m - m_new), torch.exp(li[:, t] - m_new)
        C = fg[..., None, None] * C + ig[..., None, None] * k[:, t, :, :, None] \
            * v[:, t, :, None, :]
        n = fg[..., None] * n + ig[..., None] * k[:, t]
        qs = q[:, t] * D ** -0.5
        num = torch.einsum("bhd,bhde->bhe", qs, C)
        den = torch.einsum("bhd,bhd->bh", qs, n)
        hs.append(num / torch.maximum(den.abs(), torch.exp(-m_new))[..., None])
        m = m_new
    return torch.stack(hs, 1), (C, n, m)


def _gates(seed, B=2, S_=S, H=4, D=32):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((B, S_, H, D)).astype(np.float32) for _ in range(3))
    li = (rng.standard_normal((B, S_, H)) * 2 - 3).astype(np.float32)
    lf = np.log(1 / (1 + np.exp(-(rng.standard_normal((B, S_, H)) + 3)))).astype(np.float32)
    return q, k, v, li, lf


@pytest.mark.parametrize("S_", [40, S], ids=["one-chunk", "three-chunks"])
def test_mlstm_chunk_scan_equals_naive_recurrence_and_reference(S_):
    """The chunkwise-parallel form over S positions (padded to a multiple
    of 128) against the position-by-position recurrence in f64 and against
    the reference's ``mlstm_seq``: outputs and the final (C, n) state
    (1e-5, the state relative to its scale ``exp(m)``)."""
    _, cfg, _, _ = _params()
    g = _gates(S_, S_=S_)
    h, (C, n, m) = xlstm.mlstm_seq(cfg, *map(torch.from_numpy, g))
    want_h, (wC, wn, wm) = _naive(*g)
    _close(h, want_h.float(), msg="h")
    # the carried state is stabilized by its own m: compare C e^m, n e^m
    _close(C * torch.exp(m)[..., None, None], (wC * torch.exp(wm)[..., None, None]).float(),
           1e-4, "C")
    _close(n * torch.exp(m)[..., None], (wn * torch.exp(wm)[..., None]).float(), 1e-4, "n")
    jh, (jC, jn, jm) = jx.mlstm_seq(None, *map(jnp.asarray, g))
    _close(h, jh, msg="reference h")
    _close(m, jm, 1e-6, "reference m")
    _close(C, jC, msg="reference C")


# ===========================================================================
# the blocks
# ===========================================================================

@pytest.mark.parametrize("layer", [0, 1], ids=["mlstm", "slstm"])
def test_block_matches_reference(layer):
    """The block at S 300: ``mean(out · r)`` for a random r (1e-5
    relative) and every parameter's gradient of it (5e-4), no NaN from the
    padded tail."""
    jcfg, cfg, _, _ = _params()
    jb, lp = _layer(layer)
    x, r = _x(5, 2, S), _x(6, 2, S)
    japply = jx.mlstm_block_apply if layer == 0 else jx.slstm_block_apply
    apply = xlstm.mlstm_block_apply if layer == 0 else xlstm.slstm_block_apply
    want, jg = jax.value_and_grad(lambda p: jnp.mean(japply(jcfg, p, jnp.asarray(x)) * r))(jb)
    params = tree_map(lambda t: t.clone().requires_grad_(), lp)
    got = torch.mean(apply(cfg, params, torch.from_numpy(x)) * torch.from_numpy(r))
    leaves = tree_leaves(params)
    grads = torch.autograd.grad(got, [p for _, p in leaves])
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-5)
    want_g = _flat(jg)
    assert len(want_g) == len(leaves)
    for (path, _), g in zip(leaves, grads):
        assert bool(torch.isfinite(g).all()), path
        _close(g, want_g["/".join(path)], 5e-4, str(path))


@pytest.mark.parametrize("layer", [0, 1], ids=["mlstm", "slstm"])
def test_block_decode_matches_reference(layer):
    """One recurrent step from a random state (the mLSTM's conv buffer
    too): the output and every leaf of the new state."""
    jcfg, cfg, _, _ = _params()
    jb, lp = _layer(layer)
    rng = np.random.default_rng(layer)
    x = rng.standard_normal((3, 1, 64)).astype(np.float32)
    init = (xlstm.mlstm_state_init if layer == 0 else xlstm.slstm_state_init)(cfg, 3, "cpu")
    state = {k: torch.from_numpy(rng.standard_normal(v.shape).astype(np.float32))
             for k, v in init.items()}
    jstep = jx.mlstm_block_decode if layer == 0 else jx.slstm_block_decode
    step = xlstm.mlstm_block_decode if layer == 0 else xlstm.slstm_block_decode
    want, wst = jstep(jcfg, jb, jnp.asarray(x), {k: jnp.asarray(v.numpy())
                                                  for k, v in state.items()})
    got, st = step(cfg, lp, torch.from_numpy(x), state)
    _close(got, want, msg="out")
    assert set(st) == set(wst)
    for k in st:
        _close(st[k], wst[k], msg=k)


def test_block_apply_equals_decode_run_s_times():
    """The port's chunk scan over 300 positions and its decode step run 300
    times from the fresh state give the same outputs (5e-5), for each
    kind."""
    _, cfg, _, _ = _params()
    x = torch.from_numpy(_x(11, 2, S))
    for i, (apply, step, init) in enumerate((
            (xlstm.mlstm_block_apply, xlstm.mlstm_block_decode, xlstm.mlstm_state_init),
            (xlstm.slstm_block_apply, xlstm.slstm_block_decode, xlstm.slstm_state_init))):
        lp = _layer(i)[1]
        full = apply(cfg, lp, x)
        st, outs = init(cfg, 2, "cpu"), []
        for t in range(S):
            o, st = step(cfg, lp, x[:, t:t + 1], st)
            outs.append(o)
        _close(torch.cat(outs, 1), full, 5e-5, f"layer {i}")


# ===========================================================================
# the model
# ===========================================================================

@pytest.mark.parametrize("S_", [48, S])
def test_lm_forward_logits_match_reference(S_):
    jcfg, cfg, jp, flat = _params()
    b = _batch(S_, S_=S_)
    want = np.asarray(japi.forward(jcfg, jp, {"tokens": jnp.asarray(b["tokens"])}))
    got = tapi.forward(cfg, params_from_numpy(flat), {"tokens": torch.from_numpy(b["tokens"])})
    _close(got, want)
    last = tapi.forward(cfg, params_from_numpy(flat), {"tokens": torch.from_numpy(b["tokens"])},
                        last_only=True)
    _close(last, want[:, -1:])


@functools.lru_cache(maxsize=None)
def _ref_loss_and_grads():
    jcfg, _, jp, _ = _params()
    jb = {k: jnp.asarray(v) for k, v in _batch(1).items()}
    (jl, _), jg = jax.value_and_grad(lambda p: japi.loss_fn(jcfg, p, jb), has_aux=True)(jp)
    return float(jl), _flat(jg)


@pytest.mark.parametrize("remat", ["full", "dots", "none"])
def test_loss_and_grads_match_reference(remat):
    """``lm_loss`` at S 300 (1e-5 relative) and every leaf's gradient
    (5e-4), finite everywhere, under each remat policy."""
    _, cfg, _, flat = _params()
    jl, want = _ref_loss_and_grads()
    params = tree_map(lambda x: x.clone().requires_grad_(), params_from_numpy(flat))
    loss, m = tapi.loss_fn(cfg, params, {k: torch.from_numpy(v) for k, v in _batch(1).items()},
                           remat_policy=remat)
    leaves = tree_leaves(params)
    grads = torch.autograd.grad(loss, [p for _, p in leaves])
    np.testing.assert_allclose(float(loss.detach()), jl, rtol=1e-5)
    assert float(m["aux"]) == 0.0
    got = _named(zip((p for p, _ in leaves), grads))
    assert set(got) == set(want)
    for k, g in got.items():
        assert bool(torch.isfinite(g).all()), k
        _close(g, want[k], 5e-4, k)
    assert {"pre_blocks/0/b_igate", "pre_blocks/0/conv", "pre_blocks/1/ri",
            "pre_blocks/3/mlp/w_gate"} <= set(got)


def test_bridge_carries_the_unstacked_blocks_of_two_kinds():
    """The reference's ``pre_blocks/<i>`` leaves (mLSTM and sLSTM dicts, no
    ``blocks`` entry) become the port's list and go back under the same
    paths, bit for bit; the port's own init has the same tree."""
    _, cfg, _, flat = _params()
    params = params_from_numpy(flat)
    assert "blocks" not in params and len(params["pre_blocks"]) == 4
    assert set(params["pre_blocks"][0]) == set(_layer(2)[1]) != set(params["pre_blocks"][1])
    back = state_to_numpy({"params": params})
    assert set(back) == {f"params/{k}" for k in flat}
    for k, v in flat.items():
        np.testing.assert_array_equal(back[f"params/{k}"], v, err_msg=k)
    gen = torch.Generator()
    gen.manual_seed(0)
    mine = tapi.init_params(cfg, gen)
    assert {k: tuple(v.shape) for k, v in _named(tree_leaves(mine)).items()} == \
        {k: v.shape for k, v in flat.items()}


def test_adamw_decays_as_the_reference():
    """The reference keeps every xLSTM layer unstacked, so its 1-D leaves
    (norms, gate biases, ``b_fgate``) take no decay and its 2-D ones
    (``conv``, the projections, ``r*`` (H, dh, dh)) do; one update equals
    the reference's."""
    from repro.optim import adamw as jadamw
    _, _, jp, flat = _params()
    rng = np.random.default_rng(4)
    jgrads = jax.tree_util.tree_map(
        lambda a: jnp.asarray(rng.standard_normal(a.shape).astype(np.float32)), jp)
    jnew, _, _ = jadamw.adamw_update(jgrads, jadamw.init_opt_state(jp), jp,
                                     jnp.float32(1e-2), jadamw.AdamWConfig())
    params = params_from_numpy(flat)
    opt = adamw.init_opt_state(params)
    grads = [t for _, t in tree_leaves(params_from_numpy(_flat(jgrads)))]
    adamw.adamw_update(grads, opt, params, torch.tensor(1e-2), adamw.global_norm(grads),
                       adamw.AdamWConfig())
    lp = params["pre_blocks"]
    assert adamw.reference_rank(("pre_blocks", 0, "b_igate"), lp[0]["b_igate"]) == 1
    assert adamw.reference_rank(("pre_blocks", 1, "rz"), lp[1]["rz"]) == 3
    want = _named(tree_leaves(params_from_numpy(_flat(jnew))))
    for k, p in _named(tree_leaves(params)).items():
        _close(p, want[k], 1e-6, k)


def test_planning_models_equal_reference_at_full_size():
    from test_torch_planning import SYSTEM_PAIRS
    cfg, jcfg = get_config(ARCH), jget_config(ARCH)
    for system, ref_system in SYSTEM_PAIRS.values():
        for kw in (dict(), dict(dp=8, zero_stage=3, gas=4), dict(remat_policy="dots", mbs=2)):
            got = cost_model.estimate_step(cfg, ParallelismConfig(**kw), system=system,
                                           seq=4096)
            want = ref_cost.estimate_step(jcfg, JPlan(**kw), system=ref_system, seq=4096)
            assert got.as_dict() == want.as_dict(), kw
    for kw in (dict(dp=1, tp=1, pp=1), dict(dp=8, tp=1, pp=1, zero_stage=3, mbs=2,
                                              seq=4096, remat="dots")):
        assert memory.per_device_bytes(cfg, **kw) == ref_memory.per_device_bytes(jcfg, **kw)
    assert cost_model.active_params(cfg) == ref_cost.active_params(jcfg) == cfg.n_params()


def test_sharding_hints_are_the_references():
    from repro.core import zero as jzero
    assert zero.family_hints(get_config(ARCH)) == jzero.family_hints(jget_config(ARCH)) \
        == ssm.SHARDING_HINTS


# ===========================================================================
# refusals
# ===========================================================================

def _mesh(**shape):
    return SimpleNamespace(shape=dict(dict(tp=1, pp=1, data=1, pod=1), **shape))


def test_refusals():
    """pp > 1, on a mesh or not (the reference cannot pipeline the family:
    its ``init_state`` stacks only a ``blocks`` entry, which the xLSTM does
    not have, and its step then fails); a tp that splits a head; packed
    sequences; the paged pool.  tp, dp and tp x dp meshes pass (the
    mesh's runs are ``tests/test_torch_xlstm_mesh.py``)."""
    _, cfg, _, flat = _params()
    for plan, shape in ((dict(tp=2), dict(tp=2)), (dict(dp=2, zero_stage=3), dict(data=2)),
                        (dict(tp=2, dp=2), dict(tp=2, data=2))):
        stepfn.check_plan(ParallelismConfig(**plan), _mesh(**shape), cfg)
    with pytest.raises(ValueError, match="tp=3 does not divide n_heads=4"):
        stepfn.check_plan(ParallelismConfig(tp=3), _mesh(tp=3), cfg)
    for mesh in (_mesh(pp=2), None):
        with pytest.raises(NotImplementedError, match="Queue 1, item 3"):
            stepfn.check_plan(ParallelismConfig(pp=2, gas=2), mesh, cfg)
    jcfg = jget_config(ARCH).reduced()
    jstate = jstepfn.init_state(jcfg, JPlan(pp=2, gas=2), jax.random.PRNGKey(0))
    assert "blocks" not in jstate["params"]
    with pytest.raises(AssertionError, match="pipeline needs a scanned stack"):
        jstepfn.make_train_step(jcfg, JPlan(pp=2, gas=2))(
            jstate, {k: jnp.asarray(v) for k, v in _batch(3, B=4, S_=16).items()})
    stepfn.check_plan(ParallelismConfig(tp=2, dp=2), None, cfg)   # one device computes them
    b = _batch(2, S_=16)
    with pytest.raises(NotImplementedError, match="segment_ids"):
        tapi.loss_fn(cfg, params_from_numpy(flat), {
            "tokens": torch.from_numpy(b["tokens"]), "labels": torch.from_numpy(b["labels"]),
            "segment_ids": torch.ones((2, 16), dtype=torch.int32)})
    assert not tapi.supports_paged_cache(cfg)
    with pytest.raises(NotImplementedError, match="paged KV pool requires a pure dense"):
        tapi.init_paged_pool(cfg, params_from_numpy(flat), 4, 8)
