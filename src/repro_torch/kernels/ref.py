"""Plain PyTorch oracles, mirroring ``repro.kernels.ref``.

Softmax attention with ``-1e30`` masking, computed in fp32.  The kernels'
own plain versions (``flash_attention.flash_fwd_plain``,
``decode_attention.decode_attention_plain``) share these semantics except on
a row whose every key is masked, where the kernels give 0 and a softmax
gives the mean of V.
"""

from __future__ import annotations

from typing import Optional

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


def decode_attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                               kpos: torch.Tensor, *, t: int,
                               window: Optional[int] = None) -> torch.Tensor:
    """Single-token attention over a ring-buffer KV cache.

    q: (B, 1, Hq, D); k/v: (B, S, Hkv, D); kpos: (B, S) absolute positions
    (-1 = empty slot); t: the query's absolute position."""
    B, _, Hq, D = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    g = Hq // Hkv
    qf = q.float().reshape(B, Hkv, g, D) * (D ** -0.5)
    scores = torch.einsum("bhgd,bkhd->bhgk", qf, k.float())
    valid = (kpos >= 0) & (kpos <= t)
    if window is not None:
        valid &= kpos > t - window
    scores = torch.where(valid[:, None, None, :], scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhgk,bkhd->bhgd", probs, v.float())
    return out.reshape(B, 1, Hq, D).to(q.dtype)
