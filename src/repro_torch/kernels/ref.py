"""Plain PyTorch oracles, mirroring ``repro.kernels.ref``.

Softmax attention with ``-1e30`` masking, computed in fp32.  The kernels'
own plain versions (``flash_attention.flash_fwd_plain``,
``decode_attention.decode_attention_plain``) share these semantics except on
a row whose every key is masked, where the kernels give 0 and a softmax
gives the mean of V.
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import torch

NEG_INF = -1e30


def mha_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, window: Optional[int] = None,
                  segment_ids: Optional[torch.Tensor] = None) -> torch.Tensor:
    """q: (B, Sq, Hq, D); k/v: (B, Sk, Hkv, D); GQA by head grouping.
    Positions are aligned aranges (self-attention); ``segment_ids`` (B, S)
    restricts attention to equal ids."""
    B, Sq, Hq, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    g = Hq // Hkv
    qf = (q.float() * (D ** -0.5)).reshape(B, Sq, Hkv, g, D)
    scores = torch.einsum("bqhgd,bkhd->bhgqk", qf, k.float())
    qpos = torch.arange(Sq, device=q.device)[:, None]
    kpos = torch.arange(Sk, device=q.device)[None, :]
    ok = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        ok &= kpos <= qpos
    if window is not None:
        ok &= kpos > qpos - window
    ok = ok[None]
    if segment_ids is not None:
        ok = ok & (segment_ids[:, :, None] == segment_ids[:, None, :])
    scores = torch.where(ok[:, None, None], scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", probs, v.float())
    return out.reshape(B, Sq, Hq, D).to(q.dtype)


def query_positions(t: Union[int, torch.Tensor], B: int) -> Union[int, torch.Tensor]:
    """``t`` as a comparand of (B, S) key positions: an int as it is, a (B,)
    tensor of per-row positions as (B, 1)."""
    return t.reshape(B, 1) if isinstance(t, torch.Tensor) else t


def decode_attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                               kpos: torch.Tensor, *, t: Union[int, torch.Tensor],
                               window: Optional[int] = None) -> torch.Tensor:
    """Single-token attention over a ring-buffer KV cache.

    q: (B, 1, Hq, D); k/v: (B, S, Hkv, D); kpos: (B, S) absolute positions
    (-1 = empty slot); t: the query's absolute position, one for all rows or
    a (B,) tensor of one per row."""
    B, _, Hq, D = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    g = Hq // Hkv
    qf = q.float().reshape(B, Hkv, g, D) * (D ** -0.5)
    scores = torch.einsum("bhgd,bkhd->bhgk", qf, k.float())
    t = query_positions(t, B)
    valid = (kpos >= 0) & (kpos <= t)
    if window is not None:
        valid &= kpos > t - window
    scores = torch.where(valid[:, None, None, :], scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhgk,bkhd->bhgd", probs, v.float())
    return out.reshape(B, 1, Hq, D).to(q.dtype)


def gather_pages(k_pool: torch.Tensor, v_pool: torch.Tensor, page_table: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The contiguous view of a block-paged pool: (k, v, kpos) with k/v
    (B, n_max·ps, Hkv, D) gathered through the clamped table (an unmapped
    page reads the trash page 0) and kpos (B, n_max·ps) the logical position
    of every gathered token, -1 where its page is unmapped."""
    B, n_max = page_table.shape
    ps, Hkv, D = k_pool.shape[1:]
    pages = page_table.clamp_min(0).long()
    k = k_pool[pages].reshape(B, n_max * ps, Hkv, D)
    v = v_pool[pages].reshape(B, n_max * ps, Hkv, D)
    logical = torch.arange(n_max * ps, dtype=torch.int32, device=page_table.device)[None]
    mapped = (page_table >= 0).repeat_interleave(ps, dim=1)
    kpos = torch.where(mapped, logical, torch.full_like(logical, -1))
    return k, v, kpos


def paged_decode_attention_reference(q: torch.Tensor, k_pool: torch.Tensor,
                                     v_pool: torch.Tensor, page_table: torch.Tensor, *,
                                     ts: torch.Tensor,
                                     window: Optional[int] = None) -> torch.Tensor:
    """Single-token attention against a block-paged KV pool.

    q: (B, 1, Hq, D); k_pool/v_pool: (n_pages, page_size, Hkv, D);
    page_table: (B, n_max) physical page of each logical page, -1 =
    unmapped; ts: (B,) per-request query positions.  Token j of logical
    page i sits at position i·page_size + j.  Gathering the pages into
    logical order and reusing the decode oracle keeps this equal to
    :func:`decode_attention_reference` over the equivalent contiguous cache."""
    k, v, kpos = gather_pages(k_pool, v_pool, page_table)
    return decode_attention_reference(q, k, v, kpos, t=ts, window=window)


def rmsnorm_reference(x: torch.Tensor, scale: torch.Tensor, *, eps: float = 1e-6) -> torch.Tensor:
    """x · rsqrt(mean(x²) + eps) · scale over the last axis, in f32, returned
    in x's dtype."""
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale.float()).to(x.dtype)
