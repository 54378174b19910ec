"""Multi-head attention with GQA, RoPE and ring-buffer KV caches, mirroring
``repro.models.attention`` (self-attention only).

:func:`sdpa` and :func:`attention_decode` go through ``kernels.ops``: the
hand-written kernels on the card, their plain versions on the CPU.  Cross
attention, ``sdpa`` with an additive bias, ``chunked_sdpa`` and the paged
functions are not ported yet.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.kernels import ops
from repro_torch.models import layers
from repro_torch.models.config import ModelConfig

Params = Dict[str, torch.Tensor]
Cache = Dict[str, torch.Tensor]


def attention_init(gen: torch.Generator, cfg: ModelConfig) -> Params:
    d, hd = cfg.d_model, cfg.hd
    q_dim, kv_dim = cfg.n_heads * hd, cfg.n_kv_heads * hd
    p: Params = {
        "wq": layers.dense_init(gen, d, q_dim),
        "wk": layers.dense_init(gen, d, kv_dim),
        "wv": layers.dense_init(gen, d, kv_dim),
        "wo": layers.dense_init(gen, q_dim, d,
                                scale=1.0 / (q_dim ** 0.5 * (2 * cfg.n_layers) ** 0.5)),
    }
    if cfg.qkv_bias:
        for name, n in (("bq", q_dim), ("bk", kv_dim), ("bv", kv_dim)):
            p[name] = torch.zeros((n,), dtype=torch.float32, device=gen.device)
    return p


def sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool,
         window: Optional[int] = None,
         segment_ids: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Bias-free scaled dot-product attention with GQA over aligned
    positions.  q: (B, Sq, Hq, D); k/v: (B, Sk, Hkv, D)."""
    return ops.flash_attention(q, k, v, causal=causal, window=window,
                               segment_ids=segment_ids)


def _qkv(cfg: ModelConfig, p: Params, x: torch.Tensor):
    dt = x.dtype
    q = x @ p["wq"].to(dt)
    k = x @ p["wk"].to(dt)
    v = x @ p["wv"].to(dt)
    if "bq" in p:
        q, k, v = q + p["bq"].to(dt), k + p["bk"].to(dt), v + p["bv"].to(dt)
    B, S, _ = x.shape
    return (q.reshape(B, S, cfg.n_heads, cfg.hd),
            k.reshape(B, S, cfg.n_kv_heads, cfg.hd),
            v.reshape(B, S, cfg.n_kv_heads, cfg.hd))


def attention_apply(cfg: ModelConfig, p: Params, x: torch.Tensor,
                    positions: torch.Tensor, *, causal: bool = True,
                    window: Optional[int] = None,
                    segment_ids: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Full-sequence self-attention (the forward of training and prefill)."""
    B, S, _ = x.shape
    q, k, v = _qkv(cfg, p, x)
    if cfg.pos_embed == "rope":
        q = layers.apply_rope(q, positions, cfg.rope_theta)
        k = layers.apply_rope(k, positions, cfg.rope_theta)
    out = sdpa(q, k, v, causal=causal, window=window, segment_ids=segment_ids)
    return out.reshape(B, S, cfg.n_heads * cfg.hd) @ p["wo"].to(x.dtype)


def attention_prefill(cfg: ModelConfig, p: Params, x: torch.Tensor,
                      positions: torch.Tensor, cache: Cache, *,
                      window: Optional[int] = None,
                      segment_ids: Optional[torch.Tensor] = None
                      ) -> Tuple[torch.Tensor, Cache]:
    """Causal self-attention over the prompt that also writes its post-RoPE
    K/V into the ring cache at slots ``positions % size`` (only the last
    ``size`` positions, so the slots are unique).  The cache is updated in
    place, which saves copying it; it is returned as well."""
    B, S, _ = x.shape
    q, k, v = _qkv(cfg, p, x)
    if cfg.pos_embed == "rope":
        q = layers.apply_rope(q, positions, cfg.rope_theta)
        k = layers.apply_rope(k, positions, cfg.rope_theta)
    out = sdpa(q, k, v, causal=True, window=window, segment_ids=segment_ids)
    size = cache["k"].shape[1]
    keep = min(S, size)
    pos = positions[:, S - keep:]
    slots = pos % size
    bidx = torch.arange(B, device=x.device)[:, None]
    cache["k"][bidx, slots] = k[:, S - keep:].to(cache["k"].dtype)
    cache["v"][bidx, slots] = v[:, S - keep:].to(cache["v"].dtype)
    cache["pos"][bidx, slots] = pos.to(torch.int32)
    out = out.reshape(B, S, cfg.n_heads * cfg.hd)
    return out @ p["wo"].to(x.dtype), cache


def cache_init(cfg: ModelConfig, batch: int, max_len: int, *,
               window: Optional[int], device, dtype=None) -> Cache:
    """Ring-buffer KV cache; a sliding-window layer's buffer is only
    ``window`` wide."""
    size = max_len if window is None else min(window, max_len)
    dt = dtype or cfg.compute_dtype
    return {
        "k": torch.zeros((batch, size, cfg.n_kv_heads, cfg.hd), dtype=dt, device=device),
        "v": torch.zeros((batch, size, cfg.n_kv_heads, cfg.hd), dtype=dt, device=device),
        "pos": torch.full((batch, size), -1, dtype=torch.int32, device=device),
    }


def attention_decode(cfg: ModelConfig, p: Params, x: torch.Tensor, t: int,
                     cache: Cache, *, window: Optional[int] = None
                     ) -> Tuple[torch.Tensor, Cache]:
    """x: (B, 1, d); t: the token's absolute position.  Writes the new K/V to
    ring slot ``t % size`` in place and returns (out, cache)."""
    B = x.shape[0]
    q, knew, vnew = _qkv(cfg, p, x)
    if cfg.pos_embed == "rope":
        pos = torch.full((B, 1), t, dtype=torch.int32, device=x.device)
        q = layers.apply_rope(q, pos, cfg.rope_theta)
        knew = layers.apply_rope(knew, pos, cfg.rope_theta)
    slot = t % cache["k"].shape[1]
    cache["k"][:, slot] = knew[:, 0].to(cache["k"].dtype)
    cache["v"][:, slot] = vnew[:, 0].to(cache["v"].dtype)
    cache["pos"][:, slot] = t
    dt = x.dtype
    out = ops.decode_attention(q, cache["k"].to(dt), cache["v"].to(dt), cache["pos"],
                               t=t, window=window)
    out = out.reshape(B, 1, cfg.n_heads * cfg.hd)
    return out @ p["wo"].to(dt), cache
