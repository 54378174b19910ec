"""Parity of the port's kernel modules with the reference on the CPU.

The plain versions of K1 (flash forward: O and lse) and K5 (decode
attention) are held against the Pallas kernels run in interpret mode, with
the sweeps of ``tests/test_kernels.py`` (2e-5 in f32, 2e-2 in bf16); ragged
lengths, which the Pallas kernels do not tile, against ``repro.kernels.ref``.
The plain versions of K2-K4 (the flash backward) are held against the
reference's ``_backward`` in interpret mode over the cases of
``tests/test_flash_vjp.py`` (5e-4 in f32, 5e-2 in bf16), and on ragged
lengths against ``jax.grad`` of the oracle.
The plain version of K7 (fused RMSNorm) is held against the Pallas kernel in
interpret mode and the reference's oracle at ``tests/test_kernels.py``'s
shapes and tolerances (1e-5 in f32, 2e-2 in bf16), plus a ragged ``d``, a
prime row count and a 1-D x; ``ops.rmsnorm`` follows the ``fused_rmsnorm``
flag as the reference's does.
The CUDA kernels themselves run only on the card (``chip_smoke.py``); here
their wrappers must refuse CPU tensors and the dispatch must take the plain
versions without counting a launch.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.decode_attention import decode_attention as pallas_decode
from repro.kernels.flash_attention import _backward as pallas_flash_backward
from repro.kernels.flash_attention import _forward as pallas_flash_forward
from repro.kernels.rmsnorm import rmsnorm as pallas_rmsnorm
from repro.runtime import flags as jflags
from repro_torch.kernels import build, ops, ref
from repro_torch.kernels import decode_attention as da
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import rmsnorm as rn
from repro_torch.runtime import flags

TOL = {"float32": 2e-5, "bfloat16": 2e-2}


def _qkv(B, Sq, Sk, Hq, Hkv, D, seed=0):
    rs = np.random.RandomState(seed)
    return (rs.standard_normal((B, Sq, Hq, D)).astype(np.float32),
            rs.standard_normal((B, Sk, Hkv, D)).astype(np.float32),
            rs.standard_normal((B, Sk, Hkv, D)).astype(np.float32))


def _pair(arrs, dtype):
    """The same numpy inputs as torch and jax arrays of ``dtype``."""
    t = [torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrs]
    j = [jnp.asarray(a, jnp.dtype(dtype)) for a in arrs]
    return t, j


def close(got, want, tol):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


@functools.partial(jax.jit, static_argnames=("causal", "window"))
def _pallas_fwd(q, k, v, seg, *, causal, window):
    return pallas_flash_forward(q, k, v, seg, causal, window, 64, 64, True)


def _segments(B, S):
    """Two documents, then a -1 pad tail (batched admission)."""
    seg = np.full((B, S), -1, np.int32)
    seg[:, : 2 * S // 5] = 0
    seg[:, 2 * S // 5: 4 * S // 5] = 1
    return seg


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("Hq,Hkv", [(4, 4), (8, 2), (4, 1)])
@pytest.mark.parametrize("mask", ["causal", "window", "none", "segments"])
def test_flash_plain_matches_pallas_kernel(dtype, Hq, Hkv, mask):
    B, S, D = 1, 128, 64
    (q, k, v), (jq, jk, jv) = _pair(_qkv(B, S, S, Hq, Hkv, D), dtype)
    kw = dict(causal=mask != "none", window=64 if mask == "window" else None)
    seg = _segments(B, S) if mask == "segments" else None
    o, lse = fa.flash_fwd_plain(q, k, v, segment_ids=None if seg is None
                                else torch.from_numpy(seg), **kw)
    jo, jlse = _pallas_fwd(jq, jk, jv, None if seg is None else jnp.asarray(seg), **kw)
    assert o.dtype == q.dtype and lse.dtype == torch.float32
    assert lse.shape == (B, Hq, S)
    close(o, jo, TOL[dtype])
    close(lse, jlse, TOL[dtype])


def test_flash_plain_fully_masked_rows_match_pallas_kernel():
    """8 query rows over 4 keys with window 2: rows 5-7 see no key.  The
    kernel's max(l, 1e-30) gives them O = 0 and lse = -1e30 + log(1e-30)
    (a softmax would average V instead)."""
    (q, k, v), (jq, jk, jv) = _pair(_qkv(1, 8, 4, 2, 2, 16, seed=2), "float32")
    o, lse = fa.flash_fwd_plain(q, k, v, causal=True, window=2)
    jo, jlse = _pallas_fwd(jq, jk, jv, None, causal=True, window=2)
    close(o, jo, 2e-5)
    close(lse, jlse, 2e-5)
    assert float(o[0, 5:].abs().max()) == 0.0
    assert torch.all(lse[0, :, 5:] == np.float32(-1e30 + np.log(1e-30)))


@pytest.mark.parametrize("S", [200])
@pytest.mark.parametrize("mask", ["causal", "window", "none", "segments"])
def test_flash_plain_ragged_lengths_match_oracle(S, mask):
    """Lengths the Pallas kernel does not tile, against ``repro.kernels.ref``."""
    (q, k, v), (jq, jk, jv) = _pair(_qkv(2, S, S, 8, 2, 16, seed=3), "float32")
    kw = dict(causal=mask != "none", window=64 if mask == "window" else None)
    seg = _segments(2, S) if mask == "segments" else None
    o, _ = fa.flash_fwd_plain(q, k, v, segment_ids=None if seg is None
                              else torch.from_numpy(seg), **kw)
    want = jref.mha_reference(jq, jk, jv, segment_ids=None if seg is None
                              else jnp.asarray(seg), **kw)
    close(o, want, 2e-5)
    close(ref.mha_reference(q, k, v, segment_ids=None if seg is None
                            else torch.from_numpy(seg), **kw), want, 2e-5)


def _ring(B, S, fill=None, t_wrap=None):
    slots = np.arange(S, dtype=np.int32)
    if t_wrap is None:
        kpos, t = np.where(slots <= fill, slots, -1), fill
    else:
        kpos = (t_wrap // S) * S + slots
        kpos, t = np.where(kpos > t_wrap, kpos - S, kpos), t_wrap
    return np.broadcast_to(kpos.astype(np.int32), (B, S)).copy(), t


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("fill", [0, 300, 511])
@pytest.mark.parametrize("window", [None, 128])
def test_decode_plain_matches_pallas_kernel(dtype, fill, window):
    B, S, Hq, Hkv, D = 2, 512, 4, 2, 64
    (q, k, v), (jq, jk, jv) = _pair(_qkv(B, 1, S, Hq, Hkv, D, seed=5), dtype)
    kpos, t = _ring(B, S, fill=fill)
    o = da.decode_attention_plain(q, k, v, torch.from_numpy(kpos), t=t, window=window)
    jo = pallas_decode(jq, jk, jv, jnp.asarray(kpos), t=jnp.int32(t), window=window,
                       bk=128, interpret=True)
    close(o, jo, TOL[dtype])


@pytest.mark.parametrize("Hq,Hkv", [(4, 4), (8, 2), (4, 1)])
def test_decode_plain_wrapped_ring_matches_pallas_kernel(Hq, Hkv):
    B, S, D = 1, 256, 64
    (q, k, v), (jq, jk, jv) = _pair(_qkv(B, 1, S, Hq, Hkv, D, seed=6), "float32")
    kpos, t = _ring(B, S, t_wrap=900)
    o = da.decode_attention_plain(q, k, v, torch.from_numpy(kpos), t=t, window=128)
    jo = pallas_decode(jq, jk, jv, jnp.asarray(kpos), t=jnp.int32(t), window=128,
                       bk=64, interpret=True)
    close(o, jo, 2e-5)


@pytest.mark.parametrize("case", [dict(fill=0), dict(fill=300), dict(fill=543),
                                  dict(t_wrap=2000)])
@pytest.mark.parametrize("window", [None, 128])
def test_decode_plain_ragged_cache_matches_oracle(case, window):
    """S = 544 is no multiple of 128: the reference's dispatch would not even
    launch its kernel there."""
    B, S, Hq, Hkv, D = 2, 544, 8, 2, 16
    (q, k, v), (jq, jk, jv) = _pair(_qkv(B, 1, S, Hq, Hkv, D, seed=7), "float32")
    kpos, t = _ring(B, S, **case)
    o = da.decode_attention_plain(q, k, v, torch.from_numpy(kpos), t=t, window=window)
    want = jref.decode_attention_reference(jq, jk, jv, jnp.asarray(kpos), t=t, window=window)
    close(o, want, 2e-5)
    close(ref.decode_attention_reference(q, k, v, torch.from_numpy(kpos), t=t, window=window),
          want, 2e-5)


def test_dispatch_takes_plain_versions_on_cpu_without_counting():
    (q, k, v), _ = _pair(_qkv(1, 64, 64, 4, 2, 16), "float32")
    build.launch_counts.clear()
    out = ops.flash_attention(q, k, v, causal=True)
    close(out, fa.flash_fwd_plain(q, k, v, causal=True)[0].numpy(), 0)
    kpos = torch.arange(64, dtype=torch.int32)[None]
    dec = ops.decode_attention(q[:, :1], k, v, kpos, t=63)
    close(dec, da.decode_attention_plain(q[:, :1], k, v, kpos, t=63).numpy(), 0)
    ops.flash_attention(q, k, v, causal=False, window=16)
    assert sum(build.launch_counts.values()) == 0


# ---------------------------------------------------------------------------
# K2-K4: the backward
# ---------------------------------------------------------------------------

GRAD_TOL = {"float32": 5e-4, "bfloat16": 5e-2}


@functools.partial(jax.jit, static_argnames=("causal", "window"))
def _pallas_bwd(q, k, v, seg, o, lse, do, *, causal, window):
    return pallas_flash_backward(q, k, v, seg, o, lse, do, causal, window, 64, 64, True)


def _plain_backward(q, k, v, seg, o, lse, do, **kw):
    delta = fa.flash_delta_plain(o, do)
    dq = fa.flash_dq_plain(q, k, v, do, lse, delta, segment_ids=seg, **kw)
    return (dq, *fa.flash_dkv_plain(q, k, v, do, lse, delta, segment_ids=seg, **kw))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal,window,Hq,Hkv,D,segments", [
    (True, None, 4, 4, 64, False),     # the cases of tests/test_flash_vjp.py
    (True, 64, 8, 2, 64, False),
    (True, 32, 4, 2, 96, False),
    (False, None, 4, 1, 64, False),
    (True, None, 4, 4, 120, False),
    (True, None, 8, 2, 64, True),      # packed segments with a -1 pad tail
    (False, None, 4, 2, 16, True),
])
def test_flash_backward_plain_matches_pallas_kernels(dtype, causal, window, Hq, Hkv, D,
                                                     segments):
    """Plain K2/K3/K4 on the residuals of the Pallas forward vs the Pallas
    backward (``_delta_kernel``, ``_dq_kernel``, ``_dkv_kernel`` and the
    reference's GQA group sum), on the same inputs."""
    B, S = 2, 128
    arrs = _qkv(B, S, S, Hq, Hkv, D, seed=11)
    do_np = np.random.RandomState(12).standard_normal((B, S, Hq, D)).astype(np.float32)
    (q, k, v, do), (jq, jk, jv, jdo) = _pair((*arrs, do_np), dtype)
    seg = _segments(B, S) if segments else None
    jseg = None if seg is None else jnp.asarray(seg)
    kw = dict(causal=causal, window=window)
    jo, jlse = _pallas_fwd(jq, jk, jv, jseg, **kw)
    want = _pallas_bwd(jq, jk, jv, jseg, jo, jlse, jdo, **kw)
    o = torch.from_numpy(np.array(jo.astype(jnp.float32))).to(q.dtype)
    lse = torch.from_numpy(np.array(jlse))
    got = _plain_backward(q, k, v, None if seg is None else torch.from_numpy(seg), o, lse,
                          do, **kw)
    for name, g, w in zip(("dQ", "dK", "dV"), got, want):
        assert g.dtype == q.dtype and tuple(g.shape) == tuple(w.shape), name
        close(g, w.astype(jnp.float32), GRAD_TOL[dtype])
    delta = fa.flash_delta_plain(o, do)
    assert delta.dtype == torch.float32 and tuple(delta.shape) == (B, Hq, S)
    close(delta, jnp.sum(jo.astype(jnp.float32) * jdo.astype(jnp.float32), -1)
          .transpose(0, 2, 1), 1e-5)


@pytest.mark.parametrize("mask", ["causal", "window", "none", "segments"])
def test_flash_backward_plain_ragged_lengths_match_oracle_autodiff(mask):
    """S = 200, which the Pallas kernels do not tile: the plain backward
    against ``jax.grad`` of ``repro.kernels.ref.mha_reference``."""
    B, S, Hq, Hkv, D = 2, 200, 8, 2, 16
    arrs = _qkv(B, S, S, Hq, Hkv, D, seed=13)
    do_np = np.random.RandomState(14).standard_normal((B, S, Hq, D)).astype(np.float32)
    (q, k, v, do), (jq, jk, jv, jdo) = _pair((*arrs, do_np), "float32")
    kw = dict(causal=mask != "none", window=64 if mask == "window" else None)
    seg = _segments(B, S) if mask == "segments" else None
    tseg = None if seg is None else torch.from_numpy(seg)
    o, lse = fa.flash_fwd_plain(q, k, v, segment_ids=tseg, **kw)
    got = _plain_backward(q, k, v, tseg, o, lse, do, **kw)
    want = jax.grad(lambda q, k, v: jnp.sum(jref.mha_reference(
        q, k, v, segment_ids=None if seg is None else jnp.asarray(seg), **kw) * jdo),
        argnums=(0, 1, 2))(jq, jk, jv)
    for g, w in zip(got, want):
        close(g, w, GRAD_TOL["float32"])


@pytest.mark.parametrize("mask", ["causal", "window", "none", "segments"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_grads_on_cpu_equal_autograd_of_plain_forward(mask, dtype):
    """``ops.flash_attention`` with gradients goes through ``FlashAttention``
    (saved residuals, plain K2-K4 on the CPU) and equals autograd through
    ``flash_fwd_plain``; no launch is counted."""
    B, S, Hq, Hkv, D = 2, 100, 4, 2, 16
    arrs = _qkv(B, S, S, Hq, Hkv, D, seed=15)
    cot = torch.from_numpy(np.random.RandomState(16).standard_normal((B, S, Hq, D))
                           .astype(np.float32)).to(getattr(torch, dtype))
    kw = dict(causal=mask != "none", window=32 if mask == "window" else None,
              segment_ids=torch.from_numpy(_segments(B, S)) if mask == "segments" else None)
    build.launch_counts.clear()
    grads = []
    for fn in (ops.flash_attention, lambda *a, **k: fa.flash_fwd_plain(*a, **k)[0]):
        q, k, v = (torch.from_numpy(a).to(getattr(torch, dtype)).requires_grad_()
                   for a in arrs)
        out = fn(q, k, v, **kw)
        grads.append(torch.autograd.grad(out, (q, k, v), cot))
    assert isinstance(out, torch.Tensor) and sum(build.launch_counts.values()) == 0
    for g, w in zip(*grads):
        close(g, w.float().numpy(), 1e-6 if dtype == "float32" else 1e-2)


def test_serving_attention_saves_nothing():
    """Without gradients the dispatch runs the forward alone: no autograd
    node, so no residuals are kept."""
    (q, k, v), _ = _pair(_qkv(1, 64, 64, 4, 2, 16), "float32")
    q.requires_grad_()
    with torch.inference_mode():
        out = ops.flash_attention(q, k, v)
    assert out.grad_fn is None
    assert ops.flash_attention(q, k, v).grad_fn is not None


def test_backward_wrappers_refuse_cpu_tensors_and_count_nothing():
    (q, k, v), _ = _pair(_qkv(1, 64, 64, 4, 2, 16), "float32")
    o, lse = fa.flash_fwd_plain(q, k, v)
    do = torch.ones_like(q)
    delta = fa.flash_delta_plain(o, do)
    build.launch_counts.clear()
    with pytest.raises(ValueError, match="CUDA"):
        fa.flash_delta(o, do)
    with pytest.raises(ValueError, match="CUDA"):
        fa.flash_dq(q, k, v, do, lse, delta)
    with pytest.raises(ValueError, match="CUDA"):
        fa.flash_dkv(q, k, v, do, lse, delta)
    with pytest.raises(ValueError, match="lse"):
        fa.flash_dq_plain(q, k, v, do, lse[:, :, :3], delta)
    with pytest.raises(ValueError, match="dO"):
        fa.flash_dkv_plain(q, k, v, do[:, :3], lse, delta)
    assert sum(build.launch_counts.values()) == 0


def test_kernel_wrappers_refuse_cpu_tensors_and_bad_shapes():
    (q, k, v), _ = _pair(_qkv(1, 64, 64, 4, 2, 16), "float32")
    with pytest.raises(ValueError, match="CUDA"):
        fa.flash_fwd(q, k, v)
    with pytest.raises(ValueError, match="CUDA"):
        da.decode_attention(q[:, :1], k, v, torch.zeros((1, 64), dtype=torch.int32), t=3)
    with pytest.raises(ValueError, match="window"):
        fa.flash_fwd_plain(q, k, v, window=0)
    with pytest.raises(ValueError, match="segment_ids"):
        fa.flash_fwd_plain(q, k, v, segment_ids=torch.zeros((1, 3), dtype=torch.int32))
    with pytest.raises(ValueError, match="Hq"):
        da.decode_attention(torch.zeros((1, 1, 36, 16)), torch.zeros((1, 8, 4, 16)),
                            torch.zeros((1, 8, 4, 16)), torch.zeros((1, 8), dtype=torch.int32),
                            t=0)
    assert sum(build.launch_counts.values()) == 0


def test_build_names_libraries_by_source_hash(tmp_path, monkeypatch):
    for n in build.KERNELS:
        assert (build.CSRC / f"{n}.cu").is_file()
        assert build.library_path(n).parent == build.BUILD_DIR
    monkeypatch.setattr(build, "CSRC", tmp_path)
    (tmp_path / "flash_fwd.cu").write_text("// a")
    first = build.library_path("flash_fwd")
    (tmp_path / "flash_fwd.cu").write_text("// b")
    assert build.library_path("flash_fwd") != first
    (tmp_path / "x.cuh").write_text("// shared header")
    assert build.library_path("flash_fwd").name != first.name
    with pytest.raises(RuntimeError, match="error 700"):
        build.check(700, "k")
    build.check(0, "k")


def test_build_refuses_an_install_without_sources(tmp_path, monkeypatch):
    monkeypatch.setattr(build, "CSRC", tmp_path)
    with pytest.raises(RuntimeError, match="editable install"):
        build.build_all()


# ---------------------------------------------------------------------------
# K7: fused RMSNorm
# ---------------------------------------------------------------------------

RMS_TOL = {"float32": 1e-5, "bfloat16": 2e-2}


def _rms_inputs(shape, dtype, seed=0):
    rs = np.random.RandomState(seed)
    x = rs.standard_normal(shape).astype(np.float32)
    scale = (1.0 + 0.5 * rs.standard_normal(shape[-1])).astype(np.float32)
    return (torch.from_numpy(x).to(getattr(torch, dtype)), torch.from_numpy(scale),
            jnp.asarray(x, jnp.dtype(dtype)), jnp.asarray(scale))


@pytest.mark.parametrize("shape", [(8, 128), (3, 7, 256), (64, 512)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("eps", [1e-6, 1e-5])
def test_rmsnorm_plain_matches_pallas_kernel_and_oracle(shape, dtype, eps):
    x, scale, jx, jscale = _rms_inputs(shape, dtype)
    got = rn.rmsnorm_plain(x, scale, eps=eps)
    assert got.dtype == x.dtype and got.shape == x.shape
    close(got, pallas_rmsnorm(jx, jscale, eps=eps, interpret=True), RMS_TOL[dtype])
    close(got, jref.rmsnorm_reference(jx, jscale, eps=eps), RMS_TOL[dtype])
    close(ref.rmsnorm_reference(x, scale, eps=eps), jref.rmsnorm_reference(jx, jscale, eps=eps),
          RMS_TOL[dtype])


@pytest.mark.parametrize("shape", [(7, 2047), (13, 96), (1, 2048), (2048,), (5, 3, 8192)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm_plain_ragged_d_and_prime_rows_match_oracle(shape, dtype):
    """Shapes the Pallas kernel's (8, 128) tiling does not take: held to the
    reference's oracle (a 1-D x is one row)."""
    x, scale, jx, jscale = _rms_inputs(shape, dtype, seed=1)
    close(rn.rmsnorm_plain(x, scale), jref.rmsnorm_reference(jx, jscale), RMS_TOL[dtype])
    # a bf16 scale is cast to f32 inside, as the reference casts it
    close(rn.rmsnorm_plain(x, scale.to(torch.bfloat16)),
          jref.rmsnorm_reference(jx, jscale.astype(jnp.bfloat16)), RMS_TOL[dtype])


def test_ops_rmsnorm_follows_the_flag_and_counts_no_launch_on_cpu(monkeypatch):
    x, scale, jx, jscale = _rms_inputs((6, 256), "float32", seed=2)
    calls = []
    monkeypatch.setattr(rn, "rmsnorm_plain",
                        lambda *a, **k: calls.append(1) or ref.rmsnorm_reference(*a, **k))
    build.launch_counts.clear()
    for on in (False, True):
        with flags.flag_ctx(fused_rmsnorm=on), jflags.flag_ctx(fused_rmsnorm=on,
                                                               pallas_interpret="1"):
            from repro.kernels import ops as jops
            close(ops.rmsnorm(x, scale, eps=1e-5), jops.rmsnorm(jx, jscale, eps=1e-5), 1e-5)
        assert len(calls) == int(on)           # the plain version only with the flag on
    assert sum(build.launch_counts.values()) == 0
    assert not flags.use_fused_rmsnorm()
    with pytest.raises(KeyError):
        flags.set_flag("flash_attention", True)
    with pytest.raises(ValueError, match="CUDA"):
        rn.rmsnorm(x, scale)
    with pytest.raises(ValueError, match="scale"):
        rn.rmsnorm(x, scale[:5])
    assert sum(build.launch_counts.values()) == 0
