"""Kernel dispatch: model code calls these.

A CUDA tensor launches the hand-written kernel, which raises for what it
cannot take; a CPU tensor takes the kernel's plain version.  Nothing falls
back from one to the other.  Where gradients are wanted, flash attention
goes through ``FlashAttention`` (K1 forward, K2-K4 backward); otherwise,
as in serving under ``inference_mode``, it runs the forward alone and
saves nothing.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

from repro_torch.kernels import decode_attention as da
from repro_torch.kernels import flash_attention as fa


def _kernel(x: torch.Tensor) -> bool:
    return x.device.type != "cpu"


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    segment_ids: Optional[torch.Tensor] = None) -> torch.Tensor:
    """q: (B, Sq, Hq, D); k/v: (B, Sk, Hkv, D) → (B, Sq, Hq, D)."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return fa.FlashAttention.apply(q, k, v, segment_ids, causal, window)
    fwd = fa.flash_fwd if _kernel(q) else fa.flash_fwd_plain
    out, _ = fwd(q, k, v, segment_ids=segment_ids, causal=causal, window=window)
    return out


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     kpos: torch.Tensor, *, t: Union[int, torch.Tensor],
                     window: Optional[int] = None) -> torch.Tensor:
    """q: (B, 1, Hq, D); k/v: (B, S, Hkv, D); kpos: (B, S); t: an int or a
    (B,) int32 tensor → (B, 1, Hq, D)."""
    fn = da.decode_attention if _kernel(q) else da.decode_attention_plain
    return fn(q, k, v, kpos, t=t, window=window)


def paged_decode_attention(q: torch.Tensor, k_pool: torch.Tensor, v_pool: torch.Tensor,
                           page_table: torch.Tensor, *, ts: torch.Tensor,
                           window: Optional[int] = None) -> torch.Tensor:
    """q: (B, 1, Hq, D); k/v pool: (n_pages, ps, Hkv, D); page_table:
    (B, n_max) int32; ts: (B,) int32 → (B, 1, Hq, D).  K6 takes any page
    size: unlike the reference, no page size falls back to the oracle."""
    fn = da.paged_decode_attention if _kernel(q) else da.paged_decode_attention_plain
    return fn(q, k_pool, v_pool, page_table, ts=ts, window=window)
