"""Parity of the port's kernel modules with the reference on the CPU.

The plain versions of K1 (flash forward: O and lse) and K5 (decode
attention) are held against the Pallas kernels run in interpret mode, with
the sweeps of ``tests/test_kernels.py`` (2e-5 in f32, 2e-2 in bf16); ragged
lengths, which the Pallas kernels do not tile, against ``repro.kernels.ref``.
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
from repro.kernels.flash_attention import _forward as pallas_flash_forward
from repro_torch.kernels import build, ops, ref
from repro_torch.kernels import decode_attention as da
from repro_torch.kernels import flash_attention as fa

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
