"""Multi-head attention with GQA, RoPE, ring-buffer KV caches and the
block-paged KV pool, mirroring ``repro.models.attention``.

:func:`sdpa` without a bias, :func:`attention_decode` and
:func:`attention_decode_paged` go through ``kernels.ops``: the hand-written
kernels on the card (K1, K5, K6), their plain versions on the CPU.  ``sdpa``
with an additive bias (the paged suffix prefill, a cross-attention decode
step) is the reference's masked einsum on every device.  Cross attention
(an encoder-decoder's, ``kv_source=``) runs K1 non-causal over queries and
keys of two lengths; its decode step reads the precomputed K/V through the
masked einsum, as the reference's does (K5's mask keeps only keys at or
before the query's position).  Caches and pools are updated in place.  The
reference's ``chunked_sdpa`` (its path past 32 M score entries without the
flash kernel) has no counterpart: K1 never forms the scores.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple, Union

import torch

from repro_torch.core import tp
from repro_torch.kernels import ops, ref
from repro_torch.models import layers
from repro_torch.models.config import ModelConfig

Params = Dict[str, torch.Tensor]
Cache = Dict[str, torch.Tensor]
NEG_INF = -1e30


def attention_init(gen: torch.Generator, cfg: ModelConfig, *, cross: bool = False) -> Params:
    d, hd = cfg.d_model, cfg.hd
    q_dim, kv_dim = cfg.n_heads * hd, cfg.n_kv_heads * hd
    p: Params = {
        "wq": layers.dense_init(gen, d, q_dim),
        "wk": layers.dense_init(gen, d, kv_dim),
        "wv": layers.dense_init(gen, d, kv_dim),
        "wo": layers.dense_init(gen, q_dim, d,
                                scale=1.0 / (q_dim ** 0.5 * (2 * cfg.n_layers) ** 0.5)),
    }
    if cfg.qkv_bias and not cross:
        for name, n in (("bq", q_dim), ("bk", kv_dim), ("bv", kv_dim)):
            p[name] = torch.zeros((n,), dtype=torch.float32, device=gen.device)
    return p


def _mask_bias(q_pos: torch.Tensor, k_pos: torch.Tensor, *, causal: bool,
               window: Optional[int], k_valid: Optional[torch.Tensor] = None
               ) -> torch.Tensor:
    """(..., Sq, Sk) additive fp32 bias: 0 where the query at absolute
    position q_pos may see the key at k_pos, -1e30 elsewhere."""
    qp = q_pos[..., :, None]
    kp = k_pos[..., None, :]
    ok = torch.ones(torch.broadcast_shapes(qp.shape, kp.shape), dtype=torch.bool,
                    device=q_pos.device)
    if causal:
        ok &= kp <= qp
    if window is not None:
        ok &= kp > qp - window
    if k_valid is not None:
        ok &= k_valid[..., None, :]
    return torch.where(ok, 0.0, NEG_INF).float()


def sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
         bias: Optional[torch.Tensor] = None, *, causal: bool,
         window: Optional[int] = None,
         segment_ids: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Scaled dot-product attention with GQA.  q: (B, Sq, Hq, D); k/v:
    (B, Sk, Hkv, D).  Without a bias: the flash kernel (K1) or its plain
    version, over aligned positions.  A (B, Sq, Sk) ``bias`` composes with
    the causal / window / segment mask, as the reference's does, in a masked
    fp32 einsum; it never reaches K1."""
    if bias is None:
        return ops.flash_attention(q, k, v, causal=causal, window=window,
                                   segment_ids=segment_ids)
    B, Sq, Hq, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    g = Hq // Hkv
    qf = (q.float() * (D ** -0.5)).reshape(B, Sq, Hkv, g, D)
    scores = torch.einsum("bqhgd,bkhd->bhgqk", qf, k.float()) + bias[:, None, None]
    if causal or window is not None or segment_ids is not None:
        qpos = torch.arange(Sq, device=q.device)[:, None]
        kpos = torch.arange(Sk, device=q.device)[None, :]
        ok = kpos <= qpos if causal else torch.ones((Sq, Sk), dtype=torch.bool,
                                                      device=q.device)
        if window is not None:
            ok &= kpos > qpos - window
        ok = ok[None]
        if segment_ids is not None:
            ok = ok & (segment_ids[:, :, None] == segment_ids[:, None, :])
        scores = torch.where(ok[:, None, None], scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", probs, v.float())
    return out.reshape(B, Sq, Hq, D).to(q.dtype)


def _qkv(cfg: ModelConfig, p: Params, x: torch.Tensor):
    dt = x.dtype
    q = x @ p["wq"].to(dt)
    k = x @ p["wk"].to(dt)
    v = x @ p["wv"].to(dt)
    if "bq" in p:
        q, k, v = q + p["bq"].to(dt), k + p["bk"].to(dt), v + p["bv"].to(dt)
    B, S, _ = x.shape
    # heads by the weights' widths: all of them, or this rank's under tp
    return (q.reshape(B, S, -1, cfg.hd), k.reshape(B, S, -1, cfg.hd),
            v.reshape(B, S, -1, cfg.hd))


def attention_apply(cfg: ModelConfig, p: Params, x: torch.Tensor,
                    positions: torch.Tensor, *, causal: bool = True,
                    window: Optional[int] = None,
                    segment_ids: Optional[torch.Tensor] = None,
                    kv_source: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Full-sequence attention: self-attention (training, prefill, an
    encoder), or with ``kv_source`` (B, Sk, d) cross-attention of x's
    queries over its keys and values, every key visible (K1 non-causal,
    Sq != Sk); ``segment_ids`` apply to self-attention only.  The
    reference's ``kv_positions`` reach only RoPE on self-attention, so a
    cross call never reads them: the port takes none.  Under tp
    ``kv_source`` is whole and already inside the region (its caller enters
    it once for every layer that reads it)."""
    if kv_source is None:
        x = tp.enter(x)
        B, S, _ = x.shape
        q, k, v = _qkv(cfg, p, x)
        if cfg.pos_embed == "rope":
            q = layers.apply_rope(q, positions, cfg.rope_theta)
            k = layers.apply_rope(k, positions, cfg.rope_theta)
        out = sdpa(q, k, v, causal=causal, window=window, segment_ids=segment_ids)
        return tp.leave(out.reshape(B, S, -1) @ p["wo"].to(x.dtype))
    if segment_ids is not None:
        raise ValueError("segment_ids only apply to self-attention")
    x = tp.enter(x)
    B, S, _ = x.shape
    dt = x.dtype
    Sk = kv_source.shape[1]
    q = (x @ p["wq"].to(dt)).reshape(B, S, -1, cfg.hd)
    k = (kv_source @ p["wk"].to(dt)).reshape(B, Sk, -1, cfg.hd)
    v = (kv_source @ p["wv"].to(dt)).reshape(B, Sk, -1, cfg.hd)
    out = sdpa(q, k, v, causal=False, window=None)
    return tp.leave(out.reshape(B, S, -1) @ p["wo"].to(dt))


def attention_prefill(cfg: ModelConfig, p: Params, x: torch.Tensor,
                      positions: torch.Tensor, cache: Cache, *,
                      window: Optional[int] = None,
                      segment_ids: Optional[torch.Tensor] = None
                      ) -> Tuple[torch.Tensor, Cache]:
    """Causal self-attention over the prompt that also writes its post-RoPE
    K/V into the ring cache at slots ``positions % size`` (only the last
    ``size`` positions, so the slots are unique).  The cache is updated in
    place, which saves copying it; it is returned as well."""
    x = tp.enter(x)
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
    return tp.leave(out.reshape(B, S, -1) @ p["wo"].to(x.dtype)), cache


def cache_init(cfg: ModelConfig, batch: int, max_len: int, *,
               window: Optional[int], device, dtype=None,
               n_kv_heads: Optional[int] = None) -> Cache:
    """Ring-buffer KV cache of ``n_kv_heads`` heads (by default the
    config's; this rank's under tp); a sliding-window layer's buffer is only
    ``window`` wide."""
    size = max_len if window is None else min(window, max_len)
    dt = dtype or cfg.compute_dtype
    h = n_kv_heads or cfg.n_kv_heads
    return {
        "k": torch.zeros((batch, size, h, cfg.hd), dtype=dt, device=device),
        "v": torch.zeros((batch, size, h, cfg.hd), dtype=dt, device=device),
        "pos": torch.full((batch, size), -1, dtype=torch.int32, device=device),
    }


def attention_decode(cfg: ModelConfig, p: Params, x: torch.Tensor,
                     t: Union[int, torch.Tensor], cache: Cache, *,
                     window: Optional[int] = None, cross: bool = False
                     ) -> Tuple[torch.Tensor, Cache]:
    """x: (B, 1, d); t: the token's absolute position, an int for every row
    or a (B,) int32 tensor of one per row (the continuous-batching slot
    step).  Writes the new K/V to ring slot ``t % size`` of each row in
    place and returns (out, cache).  ``cross``: ``cache`` holds an encoder's
    precomputed K/V, read as it is through the masked einsum (every valid
    key visible) and left unchanged."""
    if cross:
        return _cross_decode(cfg, p, x, cache), cache
    x = tp.enter(x)
    B = x.shape[0]
    q, knew, vnew = _qkv(cfg, p, x)
    per_row = isinstance(t, torch.Tensor)
    if cfg.pos_embed == "rope":
        pos = t.reshape(B, 1) if per_row else torch.full((B, 1), t, dtype=torch.int32,
                                                          device=x.device)
        q = layers.apply_rope(q, pos, cfg.rope_theta)
        knew = layers.apply_rope(knew, pos, cfg.rope_theta)
    size = cache["k"].shape[1]
    rows = torch.arange(B, device=x.device) if per_row else slice(None)
    slot = (t % size).long() if per_row else t % size
    cache["k"][rows, slot] = knew[:, 0].to(cache["k"].dtype)
    cache["v"][rows, slot] = vnew[:, 0].to(cache["v"].dtype)
    cache["pos"][rows, slot] = t
    dt = x.dtype
    out = ops.decode_attention(q, cache["k"].to(dt), cache["v"].to(dt), cache["pos"],
                               t=t, window=window)
    return tp.leave(out.reshape(B, 1, -1) @ p["wo"].to(dt)), cache


def _cross_decode(cfg: ModelConfig, p: Params, x: torch.Tensor, cache: Cache) -> torch.Tensor:
    x = tp.enter(x)
    B = x.shape[0]
    dt = x.dtype
    q = (x @ p["wq"].to(dt)).reshape(B, 1, -1, cfg.hd)
    kpos = cache["pos"]
    bias = _mask_bias(torch.zeros((B, 1), dtype=torch.int32, device=x.device), kpos,
                      causal=False, window=None, k_valid=kpos >= 0)
    out = sdpa(q, cache["k"].to(dt), cache["v"].to(dt), bias, causal=False)
    return tp.leave(out.reshape(B, 1, -1) @ p["wo"].to(dt))


# ---------------------------------------------------------------------------
# block-paged KV pool (serving; see repro_torch.session.kvpool)
# ---------------------------------------------------------------------------

def attention_decode_paged(cfg: ModelConfig, p: Params, x: torch.Tensor,
                           ts: torch.Tensor, k_pool: torch.Tensor, v_pool: torch.Tensor,
                           page_table: torch.Tensor, *, window: Optional[int] = None
                           ) -> torch.Tensor:
    """One-token attention against a block-paged KV pool.

    x: (B, 1, d); ts: (B,) int32 per-request positions; k_pool/v_pool:
    (n_pages, page_size, Hkv, hd) shared across requests; page_table:
    (B, n_max) int32 physical page per logical page, -1 = unmapped.  The new
    K/V is scattered through the table in place (an inactive row whose page
    is unmapped lands on the trash page 0, which nothing reads: several such
    rows may write one slot of it in one step, and which write wins does not
    matter); the scheduler guarantees that an active row's target page is
    mapped and exclusively owned (``PagedKVManager.ensure_writable``)."""
    B = x.shape[0]
    ps = k_pool.shape[1]
    q, knew, vnew = _qkv(cfg, p, x)
    if cfg.pos_embed == "rope":
        q = layers.apply_rope(q, ts[:, None], cfg.rope_theta)
        knew = layers.apply_rope(knew, ts[:, None], cfg.rope_theta)
    tl = ts.long()
    page = page_table.gather(1, (tl // ps)[:, None])[:, 0].clamp_min(0).long()
    slot = tl % ps
    k_pool[page, slot] = knew[:, 0].to(k_pool.dtype)
    v_pool[page, slot] = vnew[:, 0].to(v_pool.dtype)
    dt = x.dtype
    out = ops.paged_decode_attention(q, k_pool.to(dt), v_pool.to(dt), page_table,
                                     ts=ts, window=window)
    return out.reshape(B, 1, cfg.n_heads * cfg.hd) @ p["wo"].to(dt)


def attention_prefill_paged(cfg: ModelConfig, p: Params, x: torch.Tensor,
                            positions: torch.Tensor, valid: torch.Tensor,
                            k_pool: torch.Tensor, v_pool: torch.Tensor,
                            page_table: torch.Tensor, *, window: Optional[int] = None
                            ) -> torch.Tensor:
    """Suffix prefill against a block-paged pool: rows are right-padded
    prompt suffixes (a prefix-cache hit skips re-ingesting shared pages).

    x: (B, S, d); positions: (B, S) absolute (history length + arange);
    valid: (B, S) marks real suffix tokens (padding is routed to the trash
    page).  The suffix K/V is scattered through the page table in place,
    then the queries attend to the whole gathered history and suffix in the
    masked einsum: the causal mask over absolute positions keeps stale bytes
    in a partly filled tail page invisible (their positions exceed every
    query's)."""
    B, S, _ = x.shape
    ps, n_max = k_pool.shape[1], page_table.shape[1]
    q, k, v = _qkv(cfg, p, x)
    if cfg.pos_embed == "rope":
        q = layers.apply_rope(q, positions, cfg.rope_theta)
        k = layers.apply_rope(k, positions, cfg.rope_theta)
    ip = (positions // ps).clamp_max(n_max - 1).long()   # pad rows may run past
    page = page_table.gather(1, ip)                      # the request's pages
    page = torch.where(valid, page.clamp_min(0), 0).long()
    slot = (positions % ps).long()
    k_pool[page, slot] = k.to(k_pool.dtype)
    v_pool[page, slot] = v.to(v_pool.dtype)
    gk, gv, kpos = ref.gather_pages(k_pool, v_pool, page_table)
    bias = _mask_bias(positions, kpos, causal=True, window=window, k_valid=kpos >= 0)
    dt = x.dtype
    out = sdpa(q, gk.to(dt), gv.to(dt), bias, causal=False, window=None)
    return out.reshape(B, S, cfg.n_heads * cfg.hd) @ p["wo"].to(dt)

