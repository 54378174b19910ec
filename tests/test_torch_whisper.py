"""The port's encoder-decoder family (``whisper_base``, ``models/encdec.py``)
against the JAX reference, on the CPU, in f32: the encoder, the decoder's
training forward, cross-attention (K1's plain version, non-causal, over
queries and keys of two lengths) and its decode step (the masked einsum),
the loss and gradients, the parameter count and the planning models, the
bridge's two stacks, weight decay, and the refusals.

The cut is ``reduced()`` with ``enc_frames`` 50 (2 + 2 layers, d 64, 4
heads of 16): 50 frames are not a multiple of 64 (a tile of K1) and differ
from every decoder length here (37, 20), where ``reduced()``'s 32 frames
would hide a swapped Sq and Sk.  The weights are the reference's, bridged
from its numpy leaves; the inputs are drawn with numpy from a seed.
Tolerances: outputs and loss 1e-5, gradients 5e-4.
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
from repro.models import attention as jattn
from repro.models import encdec as jed
from repro.models import init_params as jinit_params
from repro_torch.checkpoint.bridge import params_from_numpy, state_to_numpy
from repro_torch.configs import get_config
from repro_torch.core import cost_model, memory, stepfn, zero
from repro_torch.core.recipe import ParallelismConfig
from repro_torch.core.tree import tree_leaves, tree_map
from repro_torch.models import api as tapi
from repro_torch.models import attention, encdec
from repro_torch.optim import adamw
from test_torch_hybrid import _one_thread  # noqa: F401 (autouse)
from test_torch_moe import _flat

ARCH = "whisper_base"
FRAMES, S = 50, 37


def _cfgs(**kw):
    kw = dict(enc_frames=FRAMES, **kw)
    return (dataclasses.replace(jget_config(ARCH).reduced(), **kw),
            dataclasses.replace(get_config(ARCH).reduced(), **kw))


@functools.lru_cache(maxsize=None)
def _params():
    jcfg, cfg = _cfgs()
    jparams = jinit_params(jcfg, jax.random.PRNGKey(0))
    return jcfg, cfg, jparams, _flat(jparams)


def _x(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _batch(seed, B=2, S_=S, vocab=256):
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, vocab, (B, S_)).astype(np.int32),
            "labels": rng.integers(0, vocab, (B, S_)).astype(np.int32),
            "frames": rng.standard_normal((B, FRAMES, 64)).astype(np.float32)}


def _t(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _j(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _close(got, want, tol=1e-5, msg=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=tol, rtol=tol,
                               err_msg=msg)


def _named(leaves):
    return {"/".join(map(str, path)): x for path, x in leaves}


# ===========================================================================
# the config and the pieces
# ===========================================================================

def test_config_and_param_count_equal_reference():
    cfg, jcfg = get_config(ARCH), jget_config(ARCH)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert cfg.n_params() == jcfg.n_params() == 88_156_160
    j, p = _cfgs()
    assert p.n_params() == j.n_params()


def test_encode_matches_reference():
    """The encoder over 50 frames (K1's plain version non-causal)."""
    jcfg, cfg, jp, flat = _params()
    fr = _x(1, 2, FRAMES, 64)
    want = jed.encode(jcfg, jp, jnp.asarray(fr), remat_policy="none")
    got = encdec.encode(cfg, params_from_numpy(flat), torch.from_numpy(fr), remat_policy="none")
    _close(got, want)


@pytest.mark.parametrize("S_", [S, 20])
def test_decode_train_matches_reference(S_):
    """The decoder's every-position logits over a given encoder output."""
    jcfg, cfg, jp, flat = _params()
    enc = _x(2, 2, FRAMES, 64)
    tok = _batch(3, S_=S_)["tokens"]
    want = jed.decode_train(jcfg, jp, jnp.asarray(enc), jnp.asarray(tok), remat_policy="none")
    got = encdec.decode_train(cfg, params_from_numpy(flat), torch.from_numpy(enc),
                              torch.from_numpy(tok), remat_policy="none")
    _close(got, want)


def test_cross_attention_and_its_decode_step_match_reference():
    """A decoder layer's ``xattn`` over 50 frames: the full-sequence form
    (37 queries, K1's plain version non-causal, Sq != Sk) and the decode
    step's masked einsum over precomputed K/V with two invalid keys."""
    jcfg, cfg, jp, flat = _params()
    jxa = jax.tree_util.tree_map(lambda a: a[1], jp["dec_blocks"])["xattn"]
    xa = params_from_numpy(flat)["dec_blocks"][1]["xattn"]
    x, src = _x(4, 2, S, 64), _x(5, 2, FRAMES, 64)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32)[None], (2, S))
    kpos = np.broadcast_to(np.arange(FRAMES, dtype=np.int32)[None], (2, FRAMES))
    want = jattn.attention_apply(jcfg, jxa, jnp.asarray(x), jnp.asarray(pos), causal=False,
                                 kv_source=jnp.asarray(src), kv_positions=jnp.asarray(kpos))
    got = attention.attention_apply(cfg, xa, torch.from_numpy(x), torch.from_numpy(pos.copy()),
                                    causal=False, kv_source=torch.from_numpy(src))
    _close(got, want)
    k, v = _x(6, 2, FRAMES, 4, 16), _x(7, 2, FRAMES, 4, 16)
    kp = kpos.copy()
    kp[1, [3, 40]] = -1
    cache = {"k": k, "v": v, "pos": kp}
    xd = x[:, :1]
    want, _ = jattn.attention_decode(jcfg, jxa, jnp.asarray(xd), jnp.int32(5),
                                     {n: jnp.asarray(a) for n, a in cache.items()}, cross=True)
    tc = {n: torch.from_numpy(a) for n, a in cache.items()}
    for t in (5, torch.tensor([5, 60], dtype=torch.int32)):
        got, back = attention.attention_decode(cfg, xa, torch.from_numpy(xd), t, tc, cross=True)
        _close(got, want)
        assert back is tc and bool((tc["pos"] == torch.from_numpy(kp)).all())


# ===========================================================================
# the model
# ===========================================================================

def test_forward_logits_match_reference():
    jcfg, cfg, jp, flat = _params()
    b = _batch(8)
    want = np.asarray(japi.forward(jcfg, jp, _j(b)))
    got = tapi.forward(cfg, params_from_numpy(flat), _t(b))
    _close(got, want)
    _close(tapi.forward(cfg, params_from_numpy(flat), _t(b), last_only=True), want[:, -1:])


@functools.lru_cache(maxsize=None)
def _ref_loss_and_grads():
    jcfg, _, jp, _ = _params()
    (jl, _), jg = jax.value_and_grad(lambda p: japi.loss_fn(jcfg, p, _j(_batch(1))),
                                     has_aux=True)(jp)
    return float(jl), _flat(jg)


@pytest.mark.parametrize("remat", ["full", "none"])
def test_loss_and_grads_match_reference(remat):
    """The loss (1e-5 relative) and every leaf's gradient (5e-4), the
    cross-attention's, both position tables' and the encoder's among them,
    through K1-K4's plain versions (the custom autograd function)."""
    _, cfg, _, flat = _params()
    jl, want = _ref_loss_and_grads()
    params = tree_map(lambda x: x.clone().requires_grad_(), params_from_numpy(flat))
    loss, m = tapi.loss_fn(cfg, params, _t(_batch(1)), remat_policy=remat)
    leaves = tree_leaves(params)
    grads = torch.autograd.grad(loss, [p for _, p in leaves])
    np.testing.assert_allclose(float(loss.detach()), jl, rtol=1e-5)
    assert float(m["aux"]) == 0.0
    for (path, _), g in zip(leaves, grads):
        key = "/".join(str(p) for p in path if not isinstance(p, int))
        layer = next((p for p in path if isinstance(p, int)), None)
        w = want[key] if layer is None else want[key][layer]
        _close(g, w, 5e-4, key)
    assert float(grads[[p for p, _ in leaves].index(("enc_pos",))].abs().max()) > 0


def test_bridge_carries_both_stacks():
    """``enc_blocks/*`` and ``dec_blocks/*`` (L, ...) leaves become the
    port's per-layer lists and go back bit for bit; the port's own init has
    the same leaves."""
    _, cfg, _, flat = _params()
    params = params_from_numpy(flat)
    assert len(params["enc_blocks"]) == 2 and len(params["dec_blocks"]) == 2
    assert tuple(params["dec_blocks"][1]["xattn"]["wk"].shape) == (64, 64)
    assert "bq" not in params["dec_blocks"][0]["xattn"]
    back = state_to_numpy({"params": params})
    assert set(back) == {f"params/{k}" for k in flat}
    for k, v in flat.items():
        np.testing.assert_array_equal(back[f"params/{k}"], v, err_msg=k)
    gen = torch.Generator()
    gen.manual_seed(0)
    mine = state_to_numpy({"params": tapi.init_params(cfg, gen)})
    assert {k: v.shape for k, v in mine.items()} == \
        {f"params/{k}": v.shape for k, v in flat.items()}


def test_adamw_decays_the_stacked_norms_as_the_reference():
    """The reference stacks ``enc_blocks``/``dec_blocks`` (L, ...), so their
    norm scales and biases have rank 2 and take weight decay; the port's
    per-layer (d,) leaves count as rank 2 as well, so one update equals the
    reference's, while ``enc_norm``/``final_norm`` stay undecayed."""
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
    blk = params["dec_blocks"][0]
    assert adamw.reference_rank(("dec_blocks", 0, "normx", "bias"), blk["normx"]["bias"]) == 2
    assert adamw.reference_rank(("enc_norm", "scale"), params["enc_norm"]["scale"]) == 1
    want = state_to_numpy({"params": params_from_numpy(_flat(jnew))})
    for k, p in state_to_numpy({"params": params}).items():
        _close(p, want[k], 1e-6, k)


def test_planning_models_equal_reference_at_full_size():
    from test_torch_planning import SYSTEM_PAIRS
    cfg, jcfg = get_config(ARCH), jget_config(ARCH)
    for system, ref_system in SYSTEM_PAIRS.values():
        for kw in (dict(), dict(dp=8, zero_stage=3, gas=4), dict(remat_policy="dots", mbs=2)):
            got = cost_model.estimate_step(cfg, ParallelismConfig(**kw), system=system,
                                           seq=448)
            want = ref_cost.estimate_step(jcfg, JPlan(**kw), system=ref_system, seq=448)
            assert got.as_dict() == want.as_dict(), kw
    for kw in (dict(dp=1, tp=1, pp=1), dict(dp=8, tp=1, pp=1, zero_stage=3, mbs=2,
                                              seq=448, remat="full")):
        assert memory.per_device_bytes(cfg, **kw) == ref_memory.per_device_bytes(jcfg, **kw)
    from repro.core import zero as jzero
    assert zero.family_hints(cfg) == jzero.family_hints(jcfg) == ()


# ===========================================================================
# refusals
# ===========================================================================

def test_refusals():
    """pp > 1, on a mesh or not, raises (the reference's pipeline stacks
    only ``blocks`` and never runs an encoder: its step fails on this
    family, looking up a decoder-only position table), and so does a tp
    that splits a head; the paged pool; a cache init without frames.  tp,
    dp and tp x dp meshes pass (their runs are
    ``tests/test_torch_whisper_mesh.py``)."""
    jcfg, cfg, jp, flat = _params()

    def mesh(**shape):
        return SimpleNamespace(shape=dict(dict(tp=1, pp=1, data=1, pod=1), **shape))

    for plan, shape in ((dict(tp=2), dict(tp=2)), (dict(dp=2, zero_stage=3), dict(data=2)),
                        (dict(tp=2, dp=2), dict(tp=2, data=2))):
        stepfn.check_plan(ParallelismConfig(**plan), mesh(**shape), cfg)
    with pytest.raises(ValueError, match="tp=3 does not divide n_heads=4"):
        stepfn.check_plan(ParallelismConfig(tp=3), mesh(tp=3), cfg)
    for m in (mesh(pp=2), None):
        with pytest.raises(NotImplementedError, match="Queue 1, item 3"):
            stepfn.check_plan(ParallelismConfig(pp=2, gas=2), m, cfg)
    jstate = jstepfn.init_state(jcfg, JPlan(pp=2, gas=2), jax.random.PRNGKey(0))
    assert "blocks" not in jstate["params"]
    with pytest.raises(KeyError, match="pos_embed"):
        jstepfn.make_train_step(jcfg, JPlan(pp=2, gas=2))(jstate, _j(_batch(3, B=4, S_=16)))
    assert not tapi.supports_paged_cache(cfg)
    with pytest.raises(NotImplementedError, match="paged KV pool unsupported"):
        tapi.init_paged_pool(cfg, params_from_numpy(flat), 4, 8)
    with pytest.raises(ValueError, match="frames"):
        tapi.family_of(cfg).init_cache(cfg, params_from_numpy(flat), 2, 8)
    assert tapi.family_of(cfg).extra_input_specs(cfg, 3) == {
        "frames": ((3, FRAMES, 64), torch.float32)}
