"""The port's hybrid family (``hymba_15b``, ``models/ssm.py``) against the
JAX reference, on the CPU, in f32: the SSD pieces and the Hymba block, the
whole model's logits, loss and gradients, the parameter count and the
planning models, the bridge's SSM leaves, and the refusals.

The cut is ``reduced()`` with 5 layers (d 64, 4/2 heads of 16, 2 SSM heads
of 64 channels, state 8): its global layers are {0, 2, 4} and layers 1 and
3 attend through a window of 32, so a sequence of 300 positions (past the
window, past the SSD's chunk of 256 and not a multiple of it) exercises the
window, the chunk carry and the padding, all of which ``reduced()`` alone
(2 layers, both global, S 32) would hide.  The weights are the reference's,
bridged from its numpy leaves; the inputs are drawn with numpy from a seed.
Tolerances: outputs 2e-5, gradients 5e-4 (``tests/test_flash_vjp.py``'s).
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
from repro.core.recipe import ParallelismConfig as JPlan
from repro.models import api as japi
from repro.models import init_params as jinit_params
from repro.models import ssm as jssm
from repro.models import transformer as jT
from repro_torch.checkpoint.bridge import params_from_numpy, state_to_numpy
from repro_torch.configs import get_config
from repro_torch.core import cost_model, memory, stepfn, zero
from repro_torch.core.recipe import ParallelismConfig
from repro_torch.core.tree import tree_leaves, tree_map
from repro_torch.models import api as tapi
from repro_torch.models import ssm
from repro_torch.models import transformer as T
from repro_torch.optim import adamw
from test_torch_moe import _flat

ARCH = "hymba_15b"
N_LAYERS = 5
SEQS = (40, 300)            # inside one chunk; past the window and one chunk, ragged


@pytest.fixture(autouse=True)
def _one_thread():
    """Each test's torch ops on one thread (the hybrid files import this):
    the suite runs six workers on the machine's cores, and these tests'
    many small ops only lose from more threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(**kw):
    kw = dict(n_layers=N_LAYERS, **kw)
    return (dataclasses.replace(jget_config(ARCH).reduced(), **kw),
            dataclasses.replace(get_config(ARCH).reduced(), **kw))


@functools.lru_cache(maxsize=None)
def _params():
    jcfg, cfg = _cfgs()
    jparams = jinit_params(jcfg, jax.random.PRNGKey(0))
    return jcfg, cfg, jparams, _flat(jparams)


def _layer(i, jparams=None):
    """Layer i of the reference's stacked blocks (jnp) and the port's (torch)."""
    jcfg, cfg, jp, flat = _params()
    jb = jax.tree_util.tree_map(lambda a: a[i], jp["blocks"])
    return jb, params_from_numpy(flat)["blocks"][i]


def _x(seed, B, S, d=64):
    return np.random.default_rng(seed).standard_normal((B, S, d)).astype(np.float32)


def _batch(seed, B=2, S=300, vocab=256):
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, vocab, (B, S)).astype(np.int32),
            "labels": rng.integers(0, vocab, (B, S)).astype(np.int32)}


def _close(got, want, tol=2e-5, msg=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=tol, rtol=tol,
                               err_msg=msg)


# ===========================================================================
# the SSD pieces and the block
# ===========================================================================

def test_config_and_param_count_equal_reference():
    """The full config field for field, 1,588,383,200 parameters, and the
    SSM dims of the full and the cut config."""
    cfg, jcfg = get_config(ARCH), jget_config(ARCH)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert cfg.n_params() == jcfg.n_params() == 1_588_383_200
    assert ssm.ssm_dims(cfg) == jssm.ssm_dims(jcfg) == (25, 128, 16)
    j5, p5 = _cfgs()
    assert p5.n_params() == j5.n_params() and ssm.ssm_dims(p5) == jssm.ssm_dims(j5)


def test_causal_conv_matches_reference():
    _, lp = _layer(1)
    x = _x(0, 2, 37, 128)
    want = jssm._causal_conv(jnp.asarray(x), jnp.asarray(lp["ssm"]["conv"].numpy()))
    _close(ssm._causal_conv(torch.from_numpy(x), lp["ssm"]["conv"]), want)


@pytest.mark.parametrize("with_h0", [False, True], ids=["h0-none", "h0"])
@pytest.mark.parametrize("S", SEQS)
def test_ssd_apply_matches_reference(S, with_h0):
    """Output and final state, from zeros or a given state, at S inside one
    chunk and at 300 (two chunks, the second padded)."""
    jcfg, cfg, _, _ = _params()
    jb, lp = _layer(3)
    x = _x(S, 2, S)
    H, P, N = ssm.ssm_dims(cfg)
    h0 = (np.random.default_rng(9).standard_normal((2, H, N, P)).astype(np.float32)
          if with_h0 else None)
    want, wh = jssm.ssd_apply(jcfg, jb["ssm"], jnp.asarray(x),
                              None if h0 is None else jnp.asarray(h0))
    got, gh = ssm.ssd_apply(cfg, lp["ssm"], torch.from_numpy(x),
                            None if h0 is None else torch.from_numpy(h0))
    _close(got, want, msg="out")
    _close(gh, wh, msg="state")


def test_ssd_decode_matches_reference():
    """One recurrent step from a random state and conv buffer."""
    jcfg, cfg, _, _ = _params()
    jb, lp = _layer(2)
    H, P, N = ssm.ssm_dims(cfg)
    rng = np.random.default_rng(3)
    x = rng.standard_normal((3, 1, 64)).astype(np.float32)
    h = rng.standard_normal((3, H, N, P)).astype(np.float32)
    buf = rng.standard_normal((3, 3, H * P)).astype(np.float32)
    want = jssm.ssd_decode(jcfg, jb["ssm"], jnp.asarray(x), jnp.asarray(h), jnp.asarray(buf))
    got = ssm.ssd_decode(cfg, lp["ssm"], *map(torch.from_numpy, (x, h, buf)))
    for g, w, what in zip(got, want, ("out", "state", "conv buffer")):
        _close(g, w, msg=what)


def test_ssd_apply_equals_decode_run_s_times():
    """The chunked scan over 300 positions and the recurrent step run 300
    times give the same outputs and final state, in the port and in the
    reference."""
    jcfg, cfg, _, _ = _params()
    jb, lp = _layer(1)
    S = 300
    x = torch.from_numpy(_x(11, 2, S))
    H, P, N = ssm.ssm_dims(cfg)
    full, h_full = ssm.ssd_apply(cfg, lp["ssm"], x)
    h = torch.zeros((2, H, N, P))
    buf = torch.zeros((2, 3, H * P))
    outs = []
    for t in range(S):
        o, h, buf = ssm.ssd_decode(cfg, lp["ssm"], x[:, t:t + 1], h, buf)
        outs.append(o)
    _close(torch.cat(outs, 1), full, 1e-4, "outputs")
    _close(h, h_full, 1e-4, "state")
    want, wh = jssm.ssd_apply(jcfg, jb["ssm"], jnp.asarray(x.numpy()))
    _close(h_full, wh, msg="reference state")


@pytest.mark.parametrize("layer", [0, 1], ids=["global", "swa-32"])
def test_hymba_block_matches_reference(layer):
    """The block at S 300 with its layer's window (None on a global layer;
    the reference's ``BIG_WINDOW`` there): ``mean(out · r)`` for a random r
    (1e-5 relative) and every parameter's gradient of it (5e-4)."""
    jcfg, cfg, _, _ = _params()
    jb, lp = _layer(layer)
    w = T.layer_windows(cfg)[layer]
    assert w == (None if layer == 0 else 32)
    x, r = _x(5, 2, 300), _x(6, 2, 300)
    pos = np.broadcast_to(np.arange(300, dtype=np.int32)[None], (2, 300))
    jw = jT.layer_windows(jcfg)[layer]
    assert int(jw) == (jT.BIG_WINDOW if w is None else w)

    def jf(p):
        return jnp.mean(jssm.hymba_block_apply(jcfg, p, jnp.asarray(x), jnp.asarray(pos),
                                               window=jw) * r)
    want, jg = jax.value_and_grad(jf)(jb)
    params = tree_map(lambda t: t.clone().requires_grad_(), lp)
    out = ssm.hymba_block_apply(cfg, params, torch.from_numpy(x),
                                torch.from_numpy(pos.copy()), window=w)
    got = torch.mean(out * torch.from_numpy(r))
    leaves = [p for _, p in tree_leaves(params)]
    grads = torch.autograd.grad(got, leaves)
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-5)
    want_g = dict(tree_leaves(params_from_numpy(_flat({"blocks": jax.tree_util.tree_map(
        lambda a: a[None], jg)}))["blocks"][0]))
    for (path, _), g in zip(tree_leaves(params), grads):
        np.testing.assert_allclose(g.numpy(), want_g[path].numpy(), atol=5e-4, rtol=5e-4,
                                   err_msg=str(path))


def test_global_window_none_computes_the_big_window():
    """A global layer's window None gives the bits of the reference's
    sentinel window 1 << 30, and a window of 32 differs at S 300."""
    _, cfg, _, _ = _params()
    _, lp = _layer(0)
    x = torch.from_numpy(_x(8, 2, 300))
    pos = T.positions(torch.zeros((2, 300), dtype=torch.int32))
    none = ssm.hymba_block_apply(cfg, lp, x, pos, window=None)
    big = ssm.hymba_block_apply(cfg, lp, x, pos, window=jT.BIG_WINDOW)
    torch.testing.assert_close(none, big, rtol=0, atol=0)
    swa = ssm.hymba_block_apply(cfg, lp, x, pos, window=32)
    assert float((swa - none).abs().max()) > 1e-3
    assert T.hymba_global_layers(cfg) == jT.hymba_global_layers(cfg) == {0, 2, 4}


# ===========================================================================
# the model
# ===========================================================================

def _f32_floor(jcfg, jp, tokens):
    """The reference's own f32 floor on these logits: the most they move
    when its embedding table is scaled by 1 ± 2^-23 (one rounding of f32)."""
    fwd = jax.jit(lambda p: japi.forward(jcfg, p, {"tokens": jnp.asarray(tokens)}))
    base = np.asarray(fwd(jp))
    return max(float(np.abs(np.asarray(fwd(dict(jp, embed=jp["embed"] * (1 + e)))) - base)
                     .max()) for e in (2.0 ** -23, -2.0 ** -23))


@pytest.mark.parametrize("S", SEQS)
def test_lm_forward_logits_match_reference(S):
    """Every position's logits: within 2e-5 at S 40; at S 300 within 2e-5
    plus twice the reference's f32 floor.  Past ~100 positions the SSD's
    chunk sums L_t reach thousands (-A·dt ≈ -11 a position on the head with
    A = 16), so one rounding in dt moves the decay exp(L_t - L_s) by
    ulp(L) ~ 2e-4 relative: a one-ulp change of the reference's own
    embedding moves its logits by ~3e-5 there."""
    jcfg, cfg, jp, flat = _params()
    b = _batch(S, S=S)
    want = np.asarray(japi.forward(jcfg, jp, {"tokens": jnp.asarray(b["tokens"])}))
    got = tapi.forward(cfg, params_from_numpy(flat), {"tokens": torch.from_numpy(b["tokens"])})
    floor = _f32_floor(jcfg, jp, b["tokens"]) if S > 256 else 0.0
    err = float(np.abs(got.numpy() - want).max())
    assert err <= 2e-5 + 2 * floor, (err, floor)


@functools.lru_cache(maxsize=None)
def _ref_loss_and_grads():
    """The reference's loss at S 300 and its gradients, as the port's
    per-layer leaves."""
    jcfg, _, jp, _ = _params()
    jb = {k: jnp.asarray(v) for k, v in _batch(1).items()}
    (jl, _), jg = jax.value_and_grad(lambda p: japi.loss_fn(jcfg, p, jb), has_aux=True)(jp)
    return float(jl), params_from_numpy(_flat(jg))


@pytest.mark.parametrize("remat", ["full", "dots", "none"])
def test_loss_and_grads_match_reference(remat):
    """``lm_loss`` at S 300 and its gradient for every leaf, the SSM's
    ``conv``, ``A_log``, ``D`` and ``dt_bias`` among them (loss 1e-5
    relative, gradients 5e-4), under each remat policy."""
    _, cfg, _, flat = _params()
    b = _batch(1)
    jl, want = _ref_loss_and_grads()
    params = tree_map(lambda x: x.clone().requires_grad_(), params_from_numpy(flat))
    loss, m = tapi.loss_fn(cfg, params, {k: torch.from_numpy(v) for k, v in b.items()},
                           remat_policy=remat)
    grads = torch.autograd.grad(loss, [p for _, p in tree_leaves(params)])
    np.testing.assert_allclose(float(loss.detach()), jl, rtol=1e-5)
    assert float(m["aux"]) == 0.0
    seen = set()
    for (path, w), g in zip(tree_leaves(want), grads):
        np.testing.assert_allclose(g.numpy(), w.numpy(), atol=5e-4, rtol=5e-4,
                                   err_msg=str(path))
        seen.add(path[-1])
    assert {"conv", "A_log", "D", "dt_bias", "in_proj", "bc_proj", "out_proj"} <= seen


def test_adamw_decays_the_ssm_vectors_as_the_reference():
    """The reference's stacked ``(L, H)`` SSM vectors have rank 2 and take
    weight decay; the port's per-layer ``(H,)`` leaves count as rank 2 as
    well (``reference_rank``), so one update equals the reference's."""
    from repro.optim import adamw as jadamw
    jcfg, cfg, jp, flat = _params()
    rng = np.random.default_rng(4)
    jgrads = jax.tree_util.tree_map(
        lambda a: jnp.asarray(rng.standard_normal(a.shape).astype(np.float32)), jp)
    jnew, _, jm = jadamw.adamw_update(jgrads, jadamw.init_opt_state(jp), jp,
                                      jnp.float32(1e-2), jadamw.AdamWConfig())
    params = params_from_numpy(flat)
    opt = adamw.init_opt_state(params)
    grads = [t for _, t in tree_leaves(params_from_numpy(_flat(jgrads)))]
    adamw.adamw_update(grads, opt, params, torch.tensor(1e-2),
                       adamw.global_norm(grads), adamw.AdamWConfig())
    assert adamw.reference_rank(("blocks", 0, "ssm", "A_log"), params["blocks"][0]["ssm"]
                                ["A_log"]) == 2
    want = params_from_numpy(_flat(jnew))
    for (path, w), (_, p) in zip(tree_leaves(want), tree_leaves(params)):
        np.testing.assert_allclose(p.numpy(), w.numpy(), atol=1e-6, rtol=1e-6,
                                   err_msg=str(path))
    moved = params["blocks"][2]["ssm"]["D"] - 1.0
    assert float(moved.abs().min()) > 0.0


def test_bridge_carries_the_stacked_ssm_leaves():
    """The reference's stacked ``blocks/ssm/*`` leaves ((L, 4, inner) conv,
    (L, H) vectors, ...) become the port's per-layer dicts and go back to
    the same (L, ...) arrays under the same paths, bit for bit."""
    _, cfg, _, flat = _params()
    params = params_from_numpy(flat)
    assert len(params["blocks"]) == N_LAYERS
    H, P, _ = ssm.ssm_dims(cfg)
    assert tuple(params["blocks"][4]["ssm"]["conv"].shape) == (4, H * P)
    assert tuple(params["blocks"][4]["ssm"]["A_log"].shape) == (H,)
    assert flat["blocks/ssm/conv"].shape == (N_LAYERS, 4, H * P)
    back = state_to_numpy({"params": params})
    assert set(back) == {f"params/{k}" for k in flat}
    for k, v in flat.items():
        np.testing.assert_array_equal(back[f"params/{k}"], v, err_msg=k)


def test_planning_models_equal_reference_at_full_size():
    """``estimate_step`` and ``per_device_bytes`` with ``==`` at full size
    (1.59 B parameters), over plans of one card and of a pipeline."""
    from test_torch_planning import SYSTEM_PAIRS
    cfg, jcfg = get_config(ARCH), jget_config(ARCH)
    for system, ref_system in SYSTEM_PAIRS.values():
        for kw in (dict(), dict(pp=4, gas=8), dict(dp=8, zero_stage=3, gas=4),
                   dict(remat_policy="dots", mbs=2)):
            got = cost_model.estimate_step(cfg, ParallelismConfig(**kw), system=system,
                                           seq=4096)
            want = ref_cost.estimate_step(jcfg, JPlan(**kw), system=ref_system, seq=4096)
            assert got.as_dict() == want.as_dict(), kw
    for kw in (dict(dp=1, tp=1, pp=1), dict(dp=1, tp=1, pp=4, gas=8),
               dict(dp=8, tp=1, pp=1, zero_stage=3, mbs=2, seq=4096, remat="dots")):
        assert memory.per_device_bytes(cfg, **kw) == ref_memory.per_device_bytes(jcfg, **kw)
    assert cost_model.active_params(cfg) == ref_cost.active_params(jcfg) == cfg.n_params()


def test_sharding_hints_are_the_references():
    from repro.core import zero as jzero
    assert zero.family_hints(get_config(ARCH)) == jzero.family_hints(jget_config(ARCH)) \
        == ssm.SHARDING_HINTS


# ===========================================================================
# refusals
# ===========================================================================

def test_refusals():
    """A tp that splits a head (full width has 25/5 attention heads and 25
    SSM heads: only tp 5 passes), packed sequences (the recurrent state
    spans documents, as the reference says), and the paged pool.  tp 2 on
    a mesh passes for the reduced config (its runs are
    ``tests/test_torch_hybrid_tp.py``), and so does tp 5 (x dp 2) at full
    width, whose d_ff of 5504 tp leaves whole."""
    _, cfg, _, flat = _params()

    def mesh(**shape):
        return SimpleNamespace(shape=dict(dict(tp=1, pp=1, data=1, pod=1), **shape))

    for m in (mesh(tp=2), None):
        stepfn.check_plan(ParallelismConfig(tp=2), m, cfg)
    full = get_config(ARCH)
    with pytest.raises(ValueError, match="tp=2 does not divide n_heads=25"):
        stepfn.check_plan(ParallelismConfig(tp=2), mesh(tp=2), full)
    stepfn.check_plan(ParallelismConfig(tp=5), mesh(tp=5), full)
    stepfn.check_plan(ParallelismConfig(tp=5, dp=2, zero_stage=3), mesh(tp=5, data=2), full)
    stepfn.check_plan(ParallelismConfig(dp=2, zero_stage=3), None, cfg)
    b = _batch(2, S=16)
    seg = np.ones((2, 16), np.int32)
    with pytest.raises(NotImplementedError, match="segment_ids"):
        tapi.loss_fn(cfg, params_from_numpy(flat), {
            "tokens": torch.from_numpy(b["tokens"]), "labels": torch.from_numpy(b["labels"]),
            "segment_ids": torch.from_numpy(seg)})
    assert not tapi.supports_paged_cache(cfg)
    with pytest.raises(NotImplementedError, match="paged KV pool requires a pure dense"):
        tapi.init_paged_pool(cfg, params_from_numpy(flat), 4, 8)
