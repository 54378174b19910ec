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
At D = 120 (h2o-danube-3-4b's head dim), with GQA 4:1 and a window, the
plain versions of K1-K6 are held against the Pallas kernels in interpret
mode at the same tolerances.  ``build.supported_head_dim`` admits every
attention config's head dim, and the wrappers refuse any other D.
K2's plain version alone is held against the reference's ``_delta_kernel``
in interpret mode at D = 120 and 128, and K2's split of the positions
(``delta_split``) deals them out in equal runs to a grid the card holds at
once.
The CUDA kernels themselves run only on the card (``chip_smoke.py``); here
their wrappers must refuse CPU tensors (and bf16 inputs that TMA cannot
read, and inputs K2 cannot read in 16-byte vectors) and the dispatch must
take the plain versions without counting a launch; the flash backward's
and the decode kernels' sources must use no atomics.  The decode wrappers' split of the keys (``split_plan``) is a pure
function of B, Hkv and S: it covers the keys in whole 32-key chunks, fills
the SMs at the slice's shapes, and splits a ring and a pool of one length at
the same keys; the split-then-combine arithmetic equals the plain version
where whole splits are empty.
"""

import functools
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.configs import ARCH_IDS
from repro.configs import get_config as jget_config
from repro.kernels.decode_attention import decode_attention as pallas_decode
from repro.kernels.decode_attention import paged_decode_attention as pallas_paged
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
# K5/K6: the split of the keys across blocks (flash-decoding), on the host
# ---------------------------------------------------------------------------

# (B, Hkv, S): the slice's decode shapes (generate, the stream's 496-slot
# rings and 31-page tables of 16, a 4096-token cache) and edges
_PLAN_SHAPES = [(4, 8, 532), (8, 8, 496), (1, 8, 4096), (1, 8, 4100), (4, 8, 4096),
                (2, 2, 532), (2, 2, 544), (1, 1, 1), (1, 8, 31), (3, 5, 33), (64, 8, 100_000),
                (512, 8, 2048), (1, 32, 131_072)]


@pytest.mark.parametrize("B,Hkv,S", _PLAN_SHAPES)
def test_split_plan_covers_the_keys_in_whole_chunks(B, Hkv, S):
    split_len, n = da.split_plan(B, Hkv, S)
    assert split_len > 0 and split_len % da.CHUNK == 0
    assert (n - 1) * split_len < S <= n * split_len    # covers [0, S), no split past its end
    assert 1 <= n <= -(-S // da.CHUNK)                 # never more splits than 32-key chunks
    assert da.split_plan(B, Hkv, S) == (split_len, n)  # a function of B, Hkv and S alone


@pytest.mark.parametrize("B,Hkv,S", [(4, 8, 532), (8, 8, 496), (1, 8, 4096), (1, 8, 4100)])
def test_split_plan_fills_the_sms_at_the_slice_shapes(B, Hkv, S):
    _, n = da.split_plan(B, Hkv, S)
    assert da.SMS <= n * B * Hkv <= 2 * da.BLOCKS_PER_SM * da.SMS


class _Launch:
    """Stands in for a decode kernel's C entry: records its arguments."""

    def __init__(self):
        self.args = []

    def __call__(self, *args):
        self.args.append(args)
        return 0


@pytest.mark.parametrize("ps,n_max", [(16, 256), (64, 64), (128, 32), (16, 31)])
def test_ring_and_pool_of_one_length_split_at_the_same_keys(monkeypatch, ps, n_max):
    """K5 over a ring of S slots and K6 over a table of n_max pages of ps
    (n_max·ps = S) hand their kernels the same split plan, and a workspace
    of B·Hq·n_splits·(D + 2) floats: so the two sum in the same order."""
    B, Hq, Hkv, D, S = 1, 32, 8, 64, n_max * ps
    entry = _Launch()
    monkeypatch.setattr(da, "_entry", lambda lib, fn: entry)
    monkeypatch.setattr(da, "_check_common", lambda *a: None)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev=None: type("Stream", (), {"cuda_stream": 0})())
    sizes = []
    workspace = da._workspace
    monkeypatch.setattr(da, "_workspace", lambda q, n: sizes.append(n) or workspace(q, n))
    q = torch.zeros((B, 1, Hq, D))
    k = torch.zeros((B, S, Hkv, D))
    pool = torch.zeros((1 + n_max, ps, Hkv, D))
    table = torch.arange(1, n_max + 1, dtype=torch.int32)[None]
    ts = torch.tensor([S - 1], dtype=torch.int32)
    build.launch_counts.clear()
    da.decode_attention(q, k, k, torch.zeros((B, S), dtype=torch.int32), t=ts)
    da.paged_decode_attention(q, pool, pool, table, ts=ts)
    build.launch_counts.clear()
    (ring_args, pool_args), plan = entry.args, da.split_plan(B, Hkv, S)
    assert ring_args[-4:-2] == pool_args[-4:-2] == plan       # (split_len, n_splits)
    assert sizes == [plan[1], plan[1]]


def _split_then_combine(q, k, v, valid, split_len):
    """The decode kernels' arithmetic, in plain PyTorch: each split's
    (m, l, acc) over its valid keys, (-1e30, 0) where it has none; then the
    splits combined in order, skipping those with l = 0."""
    B, _, Hq, D = q.shape
    Hkv = k.shape[2]
    s = torch.einsum("bhgd,bkhd->bhgk", q.reshape(B, Hkv, Hq // Hkv, D) * D ** -0.5, k)
    s = torch.where(valid[:, None, None, :], s, da.NEG_INF)
    M = torch.full(s.shape[:3], da.NEG_INF)
    parts = []
    for s0 in range(0, k.shape[1], split_len):
        ss, vs = s[..., s0:s0 + split_len], valid[:, None, None, s0:s0 + split_len]
        m = ss.amax(-1)
        p = torch.exp(ss - m[..., None]) * vs
        l = p.sum(-1)
        m = torch.where(l > 0, m, da.NEG_INF)
        parts.append((m, l, torch.einsum("bhgk,bkhd->bhgd", p, v[:, s0:s0 + split_len])))
        M = torch.maximum(M, m)
    L, O = torch.zeros_like(M), torch.zeros(M.shape + (D,))
    for m, l, acc in parts:
        sc = torch.where(l > 0, torch.exp(m - M), 0.0)
        L, O = L + l * sc, O + acc * sc[..., None]
    return (O / L.clamp_min(1e-30)[..., None]).reshape(B, 1, Hq, D)


@pytest.mark.parametrize("case", [dict(fill=4095), dict(fill=300), dict(fill=0),
                                  dict(t_wrap=9000), dict(fill=4095, window=1000)])
def test_split_decode_equals_plain_version_with_empty_splits(case):
    """The split-then-combine arithmetic over ``split_plan``'s splits gives
    K5's plain version, where whole splits are empty (a ring not full, a
    window), and O = 0 for a row whose keys are all invalid."""
    B, S, Hq, Hkv, D = 2, 4096, 8, 2, 16
    case = dict(case)
    window = case.pop("window", None)
    (q, k, v), _ = _pair(_qkv(B, 1, S, Hq, Hkv, D, seed=9), "float32")
    kpos, t = _ring(B, S, **case)
    kpos[1] = -1                                      # row 1: no valid key
    kpos = torch.from_numpy(kpos)
    valid = (kpos >= 0) & (kpos <= t)
    if window is not None:
        valid &= kpos > t - window
    split_len, n = da.split_plan(B, Hkv, S)
    assert n > 1
    got = _split_then_combine(q, k, v, valid, split_len)
    want = da.decode_attention_plain(q, k, v, kpos, t=t, window=window)
    close(got, want.numpy(), 2e-5)
    assert float(got[1].abs().max()) == 0.0


def test_decode_dispatch_on_cpu_takes_plain_versions_and_counts_no_launch():
    """The decode wrappers now take a split plan and a workspace; on CPU
    tensors ``ops`` still takes the plain versions and counts nothing, and
    the kernel wrappers refuse the CPU tensors before planning."""
    B, S, Hq, Hkv, D, ps = 2, 96, 8, 2, 16, 16
    (q, k, v), _ = _pair(_qkv(B, 1, S, Hq, Hkv, D, seed=4), "float32")
    kpos, t = _ring(B, S, fill=70)
    kpos = torch.from_numpy(kpos)
    ts = torch.tensor([70, 40], dtype=torch.int32)
    pool = k.reshape(B * S // ps, ps, Hkv, D)
    table = torch.arange(B * S // ps, dtype=torch.int32).reshape(B, S // ps)
    build.launch_counts.clear()
    close(ops.decode_attention(q, k, v, kpos, t=t, window=32),
          da.decode_attention_plain(q, k, v, kpos, t=t, window=32).numpy(), 0)
    close(ops.paged_decode_attention(q, pool, pool, table, ts=ts),
          da.paged_decode_attention_plain(q, pool, pool, table, ts=ts).numpy(), 0)
    with pytest.raises(ValueError, match="CUDA"):
        da.decode_attention(q, k, v, kpos, t=ts)
    with pytest.raises(ValueError, match="CUDA"):
        da.paged_decode_attention(q, pool, pool, table, ts=ts)
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


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("D", [120, 128])
def test_delta_plain_matches_pallas_delta_kernel(dtype, D):
    """K2's plain version alone against the reference's ``_delta_kernel`` in
    interpret mode, launched as ``_backward`` launches it (heads first, D
    padded, 64-row blocks), at h2o's and qwen's head dims."""
    from jax.experimental import pallas as pl
    from repro.kernels import flash_attention as jfa
    B, S, Hq = 2, 128, 8
    rs = np.random.RandomState(21)
    (o, do), (jo, jdo) = _pair([rs.standard_normal((B, S, Hq, D)).astype(np.float32)
                                for _ in range(2)], dtype)
    ot, dot = (jfa._pad_head_dim(x.transpose(0, 2, 1, 3)) for x in (jo, jdo))
    bq, Dp = 64, ot.shape[-1]
    want = pl.pallas_call(
        jfa._delta_kernel, grid=(B, Hq, S // bq),
        in_specs=[pl.BlockSpec((1, 1, bq, Dp), lambda b, h, iq: (b, h, iq, 0))] * 2,
        out_specs=pl.BlockSpec((1, 1, bq), lambda b, h, iq: (b, h, iq)),
        out_shape=jax.ShapeDtypeStruct((B, Hq, S), jnp.float32), interpret=True)(ot, dot)
    got = fa.flash_delta_plain(o, do)
    assert got.dtype == torch.float32 and tuple(got.shape) == (B, Hq, S)
    close(got, want, TOL[dtype])


@pytest.mark.parametrize("B,Sq,Hq,per_block,blocks", [
    (4, 1024, 32, 8, 512),        # granite's training attention
    (2, 4608, 32, 18, 512),       # h2o's
    (1, 4608, 32, 9, 512),        # h2o's micro-batch
    (4, 1000, 32, 8, 500),        # a ragged length
    (1, 1, 40, 1, 1),             # one position
    (3, 77, 5, 1, 231)])          # fewer positions than the card holds blocks
def test_delta_split_deals_positions_out_evenly(B, Sq, Hq, per_block, blocks):
    """K2's runs: equal, contiguous, covering the B·Sq positions once, in at
    most four blocks an SM; heads past what a block holds raise."""
    assert fa.delta_split(B, Sq, Hq) == per_block
    assert -(-B * Sq // per_block) == blocks <= fa.DELTA_BLOCKS_PER_SM * fa.SMS
    assert (blocks - 1) * per_block < B * Sq <= blocks * per_block
    with pytest.raises(ValueError, match="Hq=257"):
        fa.delta_split(1, 8, 257)
    with pytest.raises(ValueError, match="32 bits"):
        fa.delta_split(2 ** 16, 2 ** 15, 8)


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


# ---------------------------------------------------------------------------
# head dims: D = 120, the rule, the refusals
# ---------------------------------------------------------------------------

D120 = dict(Hq=8, Hkv=2, D=120, window=64)          # GQA 4:1, a window, h2o's head dim


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_plain_at_d120_matches_pallas_kernels(dtype):
    """K1's and K2-K4's plain versions at D = 120 against the Pallas forward
    and backward (which pad D inside), causal with a window."""
    B, S, Hq, Hkv, D, window = 2, 128, D120["Hq"], D120["Hkv"], D120["D"], D120["window"]
    arrs = _qkv(B, S, S, Hq, Hkv, D, seed=17)
    do_np = np.random.RandomState(18).standard_normal((B, S, Hq, D)).astype(np.float32)
    (q, k, v, do), (jq, jk, jv, jdo) = _pair((*arrs, do_np), dtype)
    kw = dict(causal=True, window=window)
    o, lse = fa.flash_fwd_plain(q, k, v, **kw)
    jo, jlse = _pallas_fwd(jq, jk, jv, None, **kw)
    close(o, jo, TOL[dtype])
    close(lse, jlse, TOL[dtype])
    want = _pallas_bwd(jq, jk, jv, None, jo, jlse, jdo, **kw)
    o_ref = torch.from_numpy(np.array(jo.astype(jnp.float32))).to(q.dtype)
    got = _plain_backward(q, k, v, None, o_ref, torch.from_numpy(np.array(jlse)), do, **kw)
    for g, w in zip(got, want):
        assert tuple(g.shape) == tuple(w.shape)
        close(g, w.astype(jnp.float32), GRAD_TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_plain_at_d120_matches_pallas_kernel(dtype):
    """K5's plain version at D = 120 on a wrapped ring, windowed, GQA 4:1."""
    B, S = 2, 256
    (q, k, v), (jq, jk, jv) = _pair(_qkv(B, 1, S, D120["Hq"], D120["Hkv"], D120["D"], seed=19),
                                    dtype)
    kpos, t = _ring(B, S, t_wrap=700)
    o = da.decode_attention_plain(q, k, v, torch.from_numpy(kpos), t=t, window=D120["window"])
    jo = pallas_decode(jq, jk, jv, jnp.asarray(kpos), t=jnp.int32(t), window=D120["window"],
                       bk=128, interpret=True)
    close(o, jo, TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_paged_plain_at_d120_matches_pallas_kernel(dtype):
    """K6's plain version at D = 120: shuffled pages, a hole, a position per
    row, windowed, GQA 4:1."""
    rs = np.random.RandomState(20)
    B, ps, n_max, Hkv, D = 4, 16, 4, D120["Hkv"], D120["D"]
    n_pages = 1 + B * n_max
    q = rs.standard_normal((B, 1, D120["Hq"], D)).astype(np.float32)
    kp, vp = (rs.standard_normal((n_pages, ps, Hkv, D)).astype(np.float32) for _ in range(2))
    ts = np.array([5, 2 * ps, n_max * ps - 1, n_max * ps - 1], np.int32)
    phys = rs.permutation(np.arange(1, n_pages)).astype(np.int32)
    pt = np.full((B, n_max), -1, np.int32)
    for b, t in enumerate(ts):
        pt[b, :t // ps + 1] = phys[b * n_max:b * n_max + t // ps + 1]
    pt[3, 1] = -1
    (tq, tkp, tvp), (jq, jkp, jvp) = _pair((q, kp, vp), dtype)
    o = da.paged_decode_attention_plain(tq, tkp, tvp, torch.from_numpy(pt),
                                        ts=torch.from_numpy(ts), window=D120["window"])
    jo = pallas_paged(jq, jkp, jvp, jnp.asarray(pt), ts=jnp.asarray(ts), window=D120["window"],
                      interpret=True)
    close(o, jo, TOL[dtype])


def test_supported_head_dim_admits_every_attention_config():
    """Every attention config of the reference (read through its own
    ``get_config``; all but the xLSTM, whose ``ssm`` blocks run no softmax
    attention) has a head dim the kernels take; so do the reduced ones."""
    dims = set()
    for arch in ARCH_IDS:
        cfg = jget_config(arch)
        if cfg.family != "ssm":
            dims |= {cfg.hd, cfg.reduced().hd}
    assert {16, 64, 96, 120, 128} <= dims
    assert all(build.supported_head_dim(d) for d in dims), sorted(dims)
    assert [d for d in range(1, 257) if build.supported_head_dim(d)] == list(range(16, 129, 8))


@pytest.mark.parametrize("D", [12, 20, 136])
def test_wrappers_refuse_an_unsupported_head_dim(D):
    """Every wrapper of K1-K6 (K2 too: it loads 16-byte vectors of whole
    rows) names the head dim it refuses (before it looks
    at the device: nothing falls back), and counts nothing."""
    q, k, v = (torch.zeros(s) for s in ((1, 8, 4, D), (1, 8, 2, D), (1, 8, 2, D)))
    lse = delta = torch.zeros((1, 4, 8))
    build.launch_counts.clear()
    msg = f"head dim {D} is not supported"
    with pytest.raises(ValueError, match=msg):
        fa.flash_fwd(q, k, v)
    with pytest.raises(ValueError, match=msg):
        fa.flash_dq(q, k, v, q, lse, delta)
    with pytest.raises(ValueError, match=msg):
        fa.flash_dkv(q, k, v, q, lse, delta)
    with pytest.raises(ValueError, match=msg):
        fa.flash_delta(q, q)
    with pytest.raises(ValueError, match=msg):
        da.decode_attention(q[:, :1], k, v, torch.zeros((1, 8), dtype=torch.int32), t=3)
    with pytest.raises(ValueError, match=msg):
        da.paged_decode_attention(q[:, :1], k, v, torch.zeros((1, 1), dtype=torch.int32),
                                  ts=torch.zeros((1,), dtype=torch.int32))
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


def test_tma_kernels_refuse_misaligned_bf16_inputs():
    """K1, K3 and K4 read bf16 q/k/v (and dO) through TMA tensor maps, which
    need 16-byte aligned bases and (b, s, h) strides; f32 takes plain loads."""
    shape, n = (2, 8, 4, 16), 2 * 8 * 4 * 16
    x = torch.zeros(shape, dtype=torch.bfloat16)
    fa._check_tma_aligned("flash_dq", (x, x))
    shifted = torch.zeros(n + 1, dtype=torch.bfloat16)[1:].view(shape)
    with pytest.raises(ValueError, match="flash_dq: bf16 inputs need 16-byte aligned"):
        fa._check_tma_aligned("flash_dq", (x, shifted))
    fa._check_tma_aligned("flash_dkv", (torch.zeros(n + 1)[1:].view(shape),))


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_delta_refuses_inputs_it_cannot_read_in_vectors(dtype):
    """K2 reads O and dO in 16-byte vectors in both dtypes: a base address
    or a (b, s, h) stride off 16 bytes is refused, a padded but aligned
    layout is taken."""
    shape, n = (2, 8, 4, 16), 2 * 8 * 4 * 16
    dt = getattr(torch, dtype)
    x = torch.zeros(shape, dtype=dt)
    fa._check_vector_aligned("flash_delta", (x, x))
    fa._check_vector_aligned("flash_delta", (x, torch.zeros((2, 8, 6, 16), dtype=dt)[:, :, 1:5]))
    shifted = torch.zeros(n + 1, dtype=dt)[1:].view(shape)
    odd_heads = torch.zeros((2, 8, 4, 17), dtype=dt)[..., :16]
    for bad in (shifted, odd_heads):
        with pytest.raises(ValueError, match="flash_delta: inputs need 16-byte aligned"):
            fa._check_vector_aligned("flash_delta", (x, bad))


# ---------------------------------------------------------------------------
# the flash backward's sources: no atomics
# ---------------------------------------------------------------------------

# an atomic or a memory reduction, in CUDA C++ or in inline PTX (``bar.red``,
# a barrier's reduction of a predicate, is neither)
_ATOMIC = re.compile(r"\batomic[A-Z]\w*\s*\(|atomic_ref|(?<![\w.])(?:red|atom)\.|"
                     r"cp\.reduce\.async")
# the backward's source and the headers of csrc/ it includes
_BWD_SOURCES = ("flash_bwd.cu", "common.cuh", "hopper.cuh")


def _code(name):
    """A CUDA source of ``csrc/`` without its ``//`` comments."""
    return "\n".join(ln.split("//")[0] for ln in (build.CSRC / name).read_text().splitlines())


# the decode kernels' sources (K5, K6 and their shared body) and the
# headers of csrc/ they include
_DECODE_SOURCES = ("decode_attention.cu", "paged_decode_attention.cu", "decode_attention.cuh",
                   "common.cuh")


@pytest.mark.parametrize("source", _DECODE_SOURCES)
def test_decode_sources_use_no_atomics(source):
    """K5 and K6 combine their splits in one fixed order in a second kernel,
    so equal inputs give equal bits and K6 over a pool equals K5 over the
    same K/V bit for bit.  No source of the decode libraries may use an
    atomic."""
    includes = set()
    for name in _DECODE_SOURCES:
        includes |= set(re.findall(r'#include "([^"]+)"', _code(name)))
    assert includes <= set(_DECODE_SOURCES)
    assert not _ATOMIC.findall(_code(source)), source


@pytest.mark.parametrize("source", _BWD_SOURCES)
def test_flash_backward_sources_use_no_atomics(source):
    """K3 and K4 sum in one fixed order in their registers (K4 sums the GQA
    group inside), so equal inputs give equal bits: the bitwise crash ->
    resume on the card relies on it.  No source of the backward's library
    may use an atomic."""
    assert set(re.findall(r'#include "([^"]+)"', _code("flash_bwd.cu"))) <= set(_BWD_SOURCES)
    assert not _ATOMIC.findall(_code(source)), source


def test_atomics_pattern_catches_reductions_and_spares_barriers():
    for hit in ("atomicAdd(&x, 1.f);", "atomicCAS(p, a, b)", 'asm("red.global.add.f32 [%0], %1;")',
                'asm("atom.shared.add.u32 %0, [%1], 1;")', "cuda::atomic_ref<float> r(x);",
                'asm("cp.reduce.async.bulk.tensor.2d.global.shared::cta.add.tile")'):
        assert _ATOMIC.search(hit), hit
    for miss in ('asm("bar.red.or.pred q, %2, %3, p;")', "no atomics: a fixed order",
                 'asm("mbarrier.arrive.shared::cta.b64 _, [%0];")', "const int red = 1;"):
        assert not _ATOMIC.search(miss), miss


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
