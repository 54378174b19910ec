"""Parity of the PyTorch port's layers and configs with the JAX reference
(``repro.models.layers``, ``repro.configs``), in f32 on the CPU at 1e-6.

Inputs are made with numpy from a seed and fed to both packages."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.models import layers as jl
from repro_torch.configs import ALIASES, ARCH_IDS, PORTED, get_config
from repro_torch.models import layers as tl

TOL = 1e-6


def rand(*shape, seed=0, scale=1.0):
    return (np.random.RandomState(seed).standard_normal(shape) * scale).astype(np.float32)


def close(got: torch.Tensor, want, tol=TOL):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


@pytest.mark.parametrize("kind", ["rmsnorm", "layernorm"])
def test_norms_match_reference(kind):
    x = rand(3, 7, 64, seed=1, scale=3.0)
    p = {"scale": rand(64, seed=2), "bias": rand(64, seed=3)}
    if kind == "rmsnorm":
        p.pop("bias")
    got = tl.norm_apply(kind, {k: torch.from_numpy(v) for k, v in p.items()},
                        torch.from_numpy(x))
    want = jl.norm_apply(kind, {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x))
    close(got, want)


def test_norms_upcast_bf16_inputs():
    """bf16 activations and scales are normalised in f32, then rounded."""
    x = rand(4, 64, seed=4)
    s = rand(64, seed=5)
    got = tl.rmsnorm({"scale": torch.from_numpy(s).bfloat16()},
                     torch.from_numpy(x).bfloat16())
    want = jl.rmsnorm({"scale": jnp.asarray(s, jnp.bfloat16)}, jnp.asarray(x, jnp.bfloat16))
    assert got.dtype == torch.bfloat16
    close(got, np.asarray(want, np.float32), tol=1e-2)


@pytest.mark.parametrize("D,theta", [(16, 1e4), (64, 1e4), (96, 1e6)])
def test_rope_matches_reference(D, theta):
    """Split halves (not interleaved pairs), angles in f32, any position."""
    x = rand(2, 11, 3, D, seed=6)
    pos = np.random.RandomState(7).randint(0, 5000, size=(2, 11)).astype(np.int32)
    got = tl.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), theta)
    want = jl.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta)
    close(got, want)
    close(tl.rope_freqs(D, theta), jl.rope_freqs(D, theta))


def test_rope_rotates_split_halves():
    x = torch.tensor([[[[1.0, 2.0, 3.0, 4.0]]]])          # (B, S, H, D=4)
    out = tl.apply_rope(x, torch.tensor([[1]]), 10000.0)
    f = tl.rope_freqs(4)                                   # pairs (x0, x2), (x1, x3)
    c, s = torch.cos(f), torch.sin(f)
    want = torch.tensor([1 * c[0] - 3 * s[0], 2 * c[1] - 4 * s[1],
                         3 * c[0] + 1 * s[0], 4 * c[1] + 2 * s[1]])
    close(out[0, 0, 0], want.numpy())


@pytest.mark.parametrize("gated,act", [(True, "silu"), (False, "gelu"), (False, "silu")])
def test_mlp_matches_reference(gated, act):
    d, ff = 32, 80
    names = ("w_gate", "w_up") if gated else ("w_in",)
    p = {n: rand(d, ff, seed=10 + i, scale=0.2) for i, n in enumerate(names)}
    p["w_out"] = rand(ff, d, seed=20, scale=0.2)
    x = rand(2, 5, d, seed=21)
    got = tl.mlp_apply({k: torch.from_numpy(v) for k, v in p.items()}, torch.from_numpy(x),
                       d_ff=ff, gated=gated, act=act)
    want = jl.mlp_apply({k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x),
                        gated=gated, act=act)
    close(got, want)


def test_gelu_is_the_tanh_approximation():
    """jax.nn.gelu defaults to tanh; the exact erf GELU differs by ~1e-3."""
    p = {"w_in": np.eye(8, dtype=np.float32) * 3, "w_out": np.eye(8, dtype=np.float32)}
    x = np.linspace(-2, 2, 8, dtype=np.float32)[None]
    got = tl.mlp_apply({k: torch.from_numpy(v) for k, v in p.items()}, torch.from_numpy(x),
                       d_ff=8, gated=False, act="gelu")
    exact = torch.nn.functional.gelu(torch.from_numpy(3 * x))
    assert float((got - exact).abs().max()) > 1e-4
    want = jl.mlp_apply({k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x),
                        gated=False, act="gelu")
    close(got, want)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_embed_and_unembed_match_reference(dtype):
    table = rand(50, 16, seed=30)
    ids = np.random.RandomState(31).randint(0, 50, size=(3, 9)).astype(np.int32)
    tdt = getattr(torch, dtype)
    emb = tl.embed_lookup(torch.from_numpy(table), torch.from_numpy(ids), tdt)
    jemb = jl.embed_lookup(jnp.asarray(table), jnp.asarray(ids), jnp.dtype(dtype))
    assert emb.dtype == tdt
    close(emb, np.asarray(jemb, np.float32), tol=0)
    # the unembed upcasts a (possibly bf16) table and x and multiplies in f32
    tt = torch.from_numpy(table).to(tdt)
    logits = tl.unembed(tt, emb)
    want = jl.unembed(jnp.asarray(table, jnp.dtype(dtype)), jemb)
    assert logits.dtype == torch.float32
    close(logits, want)


def test_dense_init_orientation_and_range():
    gen = torch.Generator().manual_seed(0)
    w = tl.dense_init(gen, 64, 32)
    assert w.shape == (64, 32) and w.dtype == torch.float32
    std = 1 / 8
    assert float(w.abs().max()) <= 3 * std + 1e-6
    assert abs(float(w.std()) - std * 0.986) < 0.006   # ±3σ truncation keeps 0.986σ
    e = tl.embed_init(gen, 100, 16)
    assert e.shape == (100, 16) and abs(float(e.std()) - 0.02) < 0.003


@pytest.mark.parametrize("arch", PORTED)
@pytest.mark.parametrize("reduced", [False, True])
def test_config_matches_reference(arch, reduced):
    ours, ref = get_config(arch), ref_get_config(arch)
    if reduced:
        ours, ref = ours.reduced(), ref.reduced()
    assert dataclasses.asdict(ours) == dataclasses.asdict(ref)
    assert ours.hd == ref.hd
    assert ours.n_params() == ref.n_params()
    assert ours.compute_dtype == getattr(torch, ref.dtype)


def test_registry_names_match_reference_and_unported_raise():
    """Every architecture is ported: ``PORTED`` is ``ARCH_IDS``, each name
    gives the reference's config; an unknown name, and a config of a family
    that no module registers, raise as the reference's do."""
    from repro import configs as ref_configs
    from repro.models import registry as ref_registry
    from repro_torch.models import api
    assert ARCH_IDS == ref_configs.ARCH_IDS and ALIASES == ref_configs.ALIASES
    assert PORTED == ARCH_IDS
    assert get_config("granite-3-2b") is get_config("granite_3_2b")
    assert get_config("whisper-base") is get_config("whisper_base")
    for arch in ARCH_IDS:
        assert dataclasses.asdict(get_config(arch)) == \
            dataclasses.asdict(ref_configs.get_config(arch))
    with pytest.raises(KeyError):
        get_config("no_such_model")
    odd = dataclasses.replace(get_config("granite_3_2b"), family="rwkv")
    with pytest.raises(KeyError, match="unknown model family 'rwkv'"):
        api.family_of(odd)
    with pytest.raises(KeyError, match="unknown model family 'rwkv'"):
        ref_registry.family_of(odd)
    xlstm = dataclasses.replace(get_config("granite_3_2b"), family="ssm")
    assert xlstm.n_params() == dataclasses.replace(ref_get_config("granite_3_2b"),
                                                   family="ssm").n_params()
