"""K5 and K6: single-token decode attention over a ring cache
(``csrc/decode_attention.cu``) and through a block-paged pool
(``csrc/paged_decode_attention.cu``), with their wrappers and plain PyTorch
versions.  Both kernels share one body (``csrc/decode_attention.cuh``).

K5 replaces the Pallas kernel ``repro/kernels/decode_attention.py:_decode_kernel``
(launched by ``decode_attention``): one query token against a ring-buffer
cache, keys valid where ``kpos >= 0 & kpos <= t`` (& inside the window).
``t`` is one int for every row or a (B,) int32 tensor of one per row (the
continuous-batching slot step).

K6 replaces ``_paged_decode_kernel`` (launched by ``paged_decode_attention``):
the same attention, with logical page ``ik`` of row ``b`` read from physical
page ``page_table[b, ik]`` of a pool shared by all rows, positions
``ik·ps + j`` implicit, -1 = unmapped (masked, never read), and a query
position ``ts[b]`` per row.  Any page size launches the kernel (the
reference fell back to its oracle unless the page size divided 128).

Bound on the H100: the bytes of K and V read, ``2·Hkv·D·bytes`` per key the
query can see.  Both kernels split the keys across blocks (flash-decoding):
:func:`split_plan` picks the split length on the host from ``B``, ``Hkv``
and ``S`` alone, so that (split, KV head, batch row) blocks fill the card's
SMs, and a ring and a pool of the same length split at the same keys.  Each
block loads each K/V row once for all ``g`` query heads of its group and
writes its split's partial softmax state to an f32 workspace, which a second
kernel combines in split order; see the sources for the design.  Any cache
length launches K5 (the reference fell back to its oracle unless S divided
128).
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple, Union

import torch

from repro_torch.kernels import build, ref

NEG_INF = -1e30
MAX_GROUP = 8                      # query heads per KV head the kernel takes
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
CHUNK = 32                         # keys a warp takes at a time: splits are whole chunks
SMS = 132                          # streaming multiprocessors of an H100 SXM
BLOCKS_PER_SM = 6                  # split blocks the plan aims for on each


def split_plan(B: int, Hkv: int, S: int) -> Tuple[int, int]:
    """The decode kernels' split of the keys ``[0, S)``: (split_len,
    n_splits), split ``s`` holding ``[s·split_len, (s+1)·split_len)``.
    split_len is a multiple of ``CHUNK``, chosen so that
    ``n_splits·B·Hkv`` blocks come near ``BLOCKS_PER_SM·SMS`` without passing
    it (one wave) and without a split of fewer than ``CHUNK`` keys.  A
    function of ``B``, ``Hkv`` and ``S`` only (no device value, so a decode
    step stays free of host syncs), so K5 over a ring of S slots and K6 over
    a pool table of ``n_max·ps = S`` keys split at the same absolute keys and
    sum in the same order."""
    if B <= 0 or Hkv <= 0 or S <= 0:
        raise ValueError(f"split_plan: B, Hkv and S must be positive; got {B}, {Hkv}, {S}")
    chunks = -(-S // CHUNK)
    want = min(chunks, max(1, BLOCKS_PER_SM * SMS // (B * Hkv)))
    split_len = CHUNK * -(-chunks // want)
    return split_len, -(-S // split_len)


def _entry(lib: str, fn: str):
    f = getattr(build.load(lib), fn)
    if f.argtypes is None:
        P, I = ctypes.c_void_p, ctypes.c_int
        f.argtypes = [P] * 7 + [I] * 10 + [ctypes.c_float, P]
        f.restype = I
    return f


def _workspace(q: torch.Tensor, n_splits: int) -> torch.Tensor:
    """The splits' partial (m, l) and acc in f32: B·Hq·n_splits·(D + 2)
    floats from torch's allocator, on the current stream."""
    B, _, Hq, D = q.shape
    return torch.empty(B * Hq * n_splits * (D + 2), dtype=torch.float32, device=q.device)


def _check_common(name: str, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  *ints: torch.Tensor) -> None:
    """The checks K5 and K6 share: Hq a multiple of k's Hkv (at most
    ``MAX_GROUP`` times it), a head dim the kernels take
    (``build.supported_head_dim``), bf16 or f32 q/k/v of one dtype, every
    tensor contiguous on one CUDA device, k/v 16-byte aligned (vector
    loads)."""
    B, _, Hq, D = q.shape
    Hkv = k.shape[2]
    build.require_head_dim(name, D)
    if Hq % Hkv or Hq // Hkv > MAX_GROUP:
        raise ValueError(f"{name}: Hq={Hq} must be a multiple of Hkv={Hkv}, "
                         f"at most {MAX_GROUP} times it")
    if not all(x.is_cuda and x.device == q.device for x in (q, k, v, *ints)):
        raise ValueError(f"{name}: every input must be on the same CUDA device")
    if q.dtype not in _DTYPE_CODE or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"{name}: bf16 or f32 q/k/v of one dtype; got "
                         f"{q.dtype}, {k.dtype}, {v.dtype}")
    if not all(x.is_contiguous() for x in (q, k, v, *ints)):
        raise ValueError(f"{name}: every input must be contiguous")
    if k.data_ptr() % 16 or v.data_ptr() % 16:
        raise ValueError(f"{name}: k/v must be 16-byte aligned (vector loads)")
    if B > 65535:
        raise ValueError(f"{name}: unsupported B={B}")


def _check_rows(name: str, what: str, x: torch.Tensor, B: int) -> None:
    if x.dtype != torch.int32 or tuple(x.shape) != (B,):
        raise ValueError(f"{name}: {what} must be a (B,) = ({B},) int32 tensor, got "
                         f"{tuple(x.shape)} {x.dtype}")


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     kpos: torch.Tensor, *, t: Union[int, torch.Tensor],
                     window: Optional[int] = None) -> torch.Tensor:
    """Launch K5.  q: (B, 1, Hq, D); k/v: (B, S, Hkv, D), bf16 or f32,
    contiguous, on one CUDA device; kpos: (B, S) int32 (-1 = empty slot);
    t: the query's absolute position, an int for every row or a (B,) int32
    tensor on the device with one per row → (B, 1, Hq, D)."""
    B, one, Hq, D = q.shape
    if one != 1 or k.dim() != 4 or k.shape != v.shape or k.shape[0] != B \
            or k.shape[3] != D or tuple(kpos.shape) != (B, k.shape[1]):
        raise ValueError(f"decode_attention: q (B,1,Hq,D), k/v (B,S,Hkv,D), kpos (B,S) "
                         f"expected; got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}, {tuple(kpos.shape)}")
    S, Hkv = k.shape[1], k.shape[2]
    per_row = isinstance(t, torch.Tensor)
    _check_common("decode_attention", q, k, v, kpos, *((t,) if per_row else ()))
    if kpos.dtype != torch.int32:
        raise ValueError(f"decode_attention: kpos must be int32, got {kpos.dtype}")
    if per_row:
        _check_rows("decode_attention", "t", t, B)
    if S == 0:
        raise ValueError("decode_attention: empty cache (S = 0)")
    if window is not None and window <= 0:
        raise ValueError(f"decode_attention: window must be positive, got {window}")
    split_len, n_splits = split_plan(B, Hkv, S)
    o = torch.empty((B, 1, Hq, D), dtype=q.dtype, device=q.device)
    ws = _workspace(q, n_splits)
    rc = _entry("decode_attention", "repro_decode_attention")(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), kpos.data_ptr(),
        t.data_ptr() if per_row else None, o.data_ptr(), ws.data_ptr(),
        _DTYPE_CODE[q.dtype], B, S, Hq, Hkv, D, 0 if per_row else int(t), window or 0,
        split_len, n_splits, D ** -0.5, torch.cuda.current_stream(q.device).cuda_stream)
    build.check(rc, "decode_attention")
    build.launch_counts["decode_attention"] += 1
    return o


def decode_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           kpos: torch.Tensor, *, t: Union[int, torch.Tensor],
                           window: Optional[int] = None) -> torch.Tensor:
    """K5's plain version, with the kernel's semantics (O = 0 when no key is
    valid), in fp32 einsums; ``t`` an int or a (B,) tensor."""
    B, _, Hq, D = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    g = Hq // Hkv
    qf = q.float().reshape(B, Hkv, g, D) * (D ** -0.5)
    s = torch.einsum("bhgd,bkhd->bhgk", qf, k.float())
    t = ref.query_positions(t, B)
    valid = (kpos >= 0) & (kpos <= t)
    if window is not None:
        valid &= kpos > t - window
    valid = valid[:, None, None, :]
    s = torch.where(valid, s, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m) * valid
    l = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    out = torch.einsum("bhgk,bkhd->bhgd", p / l, v.float())
    return out.reshape(B, 1, Hq, D).to(q.dtype)


def paged_decode_attention(q: torch.Tensor, k_pool: torch.Tensor, v_pool: torch.Tensor,
                           page_table: torch.Tensor, *, ts: torch.Tensor,
                           window: Optional[int] = None) -> torch.Tensor:
    """Launch K6.  q: (B, 1, Hq, D); k_pool/v_pool: (n_pages, ps, Hkv, D),
    bf16 or f32 of q's dtype, any page size; page_table: (B, n_max) int32,
    -1 = unmapped; ts: (B,) int32 query positions; all contiguous on one
    CUDA device → (B, 1, Hq, D)."""
    B, one, Hq, D = q.shape
    if one != 1 or k_pool.dim() != 4 or k_pool.shape != v_pool.shape \
            or k_pool.shape[3] != D or page_table.dim() != 2 or page_table.shape[0] != B:
        raise ValueError(f"paged_decode_attention: q (B,1,Hq,D), k/v pool (P,ps,Hkv,D), "
                         f"page_table (B,n_max) expected; got {tuple(q.shape)}, "
                         f"{tuple(k_pool.shape)}, {tuple(v_pool.shape)}, "
                         f"{tuple(page_table.shape)}")
    n_pages, ps, Hkv = k_pool.shape[:3]
    n_max = page_table.shape[1]
    _check_common("paged_decode_attention", q, k_pool, v_pool, page_table, ts)
    if page_table.dtype != torch.int32:
        raise ValueError(f"paged_decode_attention: page_table must be int32, got "
                         f"{page_table.dtype}")
    _check_rows("paged_decode_attention", "ts", ts, B)
    if n_pages == 0 or ps == 0 or n_max == 0 or n_max * ps >= 2 ** 31:
        raise ValueError(f"paged_decode_attention: unsupported pool ({n_pages} pages of "
                         f"{ps}) or table width {n_max}")
    if window is not None and window <= 0:
        raise ValueError(f"paged_decode_attention: window must be positive, got {window}")
    split_len, n_splits = split_plan(B, Hkv, n_max * ps)
    o = torch.empty((B, 1, Hq, D), dtype=q.dtype, device=q.device)
    ws = _workspace(q, n_splits)
    rc = _entry("paged_decode_attention", "repro_paged_decode_attention")(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(), page_table.data_ptr(),
        ts.data_ptr(), o.data_ptr(), ws.data_ptr(), _DTYPE_CODE[q.dtype], B, n_max, ps, Hq,
        Hkv, D, window or 0, split_len, n_splits, D ** -0.5,
        torch.cuda.current_stream(q.device).cuda_stream)
    build.check(rc, "paged_decode_attention")
    build.launch_counts["paged_decode_attention"] += 1
    return o


def paged_decode_attention_plain(q: torch.Tensor, k_pool: torch.Tensor,
                                 v_pool: torch.Tensor, page_table: torch.Tensor, *,
                                 ts: torch.Tensor,
                                 window: Optional[int] = None) -> torch.Tensor:
    """K6's plain version: gather the pages through the clamped table into
    logical order (positions -1 on unmapped pages), then K5's plain version
    with a position per row."""
    k, v, kpos = ref.gather_pages(k_pool, v_pool, page_table)
    return decode_attention_plain(q, k, v, kpos, t=ts, window=window)
