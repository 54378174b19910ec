"""Decoder-only LM, dense and MoE arms, mirroring ``repro.models.transformer``.

Parameters are a dict shaped like the reference's pytree, except that the
stacked ``blocks`` leaves (L, ...) become a list of L per-layer dicts, and
the reference's ``lax.scan`` over layers is a Python loop.  Its
``jax.checkpoint`` per layer becomes ``torch.utils.checkpoint`` per block
(``remat_policy`` "full", "stage" and "dots"; see :func:`lm_forward`).  Caches are ``{"blocks": [{"k", "v", "pos"},
...]}`` and the block-paged pool is ``{"blocks": [{"k", "v"}, ...]}``, one
(n_pages, page_size, Hkv, hd) pair per layer where the reference stacks
(L, ...); both are updated in place.  The MoE arm (``layer_plan``: MoE
blocks after ``first_k_dense`` dense ones) keeps the reference's
unstacked ``pre_blocks`` list ahead of ``blocks`` (caches ``{"pre": [...],
"blocks": [...]}``); its blocks return the load-balance loss beside x,
summed into ``lm_loss`` with ``AUX_LOSS_COEF``, and it fills its caches by
the decode scan (:func:`lm_prefill_scan`): capacity routing drops
different tokens over a whole prompt than one position at a time.  The VLM
arm is the dense stack over ``[vision_embeds; tokens]``: the batch's
``vision_embeds`` (B, nv, d), in the compute dtype, take the place of the
first nv embedded positions (:func:`embed_inputs`), and ``lm_loss``
masks those positions when the batch has no ``loss_mask``; decoding stays
token-only.  The hybrid arm (Hymba, ``models.ssm``) runs attention and SSM
heads side by side in every block; its attention window is per layer
(:func:`layer_windows`: the sliding window but on the first, middle and
last layers, which attend globally), a Python ``int`` or None that K1-K5
take as they are, where the reference scans a traced array of windows.
Its layer cache is ``{"kv": the ring, "ssm_h", "conv"}`` (a global
layer's ring ``max_len`` wide), and it fills its caches by the decode scan
too (its recurrent state would consume a padded prompt's tail).  The xLSTM
arm (``models.xlstm``) stacks nothing: its mLSTM and sLSTM blocks are all
``pre_blocks``, as in the reference, there is no ``blocks`` entry, its
caches are ``{"pre": [the layers' recurrent states]}``, and it fills them
by the decode scan as well.

Under tensor parallelism the blocks run ``core.tp``'s regions (in
``attention`` and ``layers.mlp_apply``) and the reference's
``constrain(x, "batch", "seq", None)`` after the embedding lays the
residual stream out over the sequence under sequence parallel: then it is
(B, S/tp, d) between the blocks, the norms run on the slice, and the last
hidden states are gathered before the unembed.  The logits are this rank's
slice of the vocabulary when the table is sharded (the reference's
``constrain(logits, "batch", None, "tp")``).  Under ZeRO-3 the training
forward gathers a block's leaves as the block runs (``core.zero.gathered``,
inside the remat region, so a recompute gathers again) and the leaves
outside the blocks once a forward.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import functools

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.core import sharding, tp, zero
from repro_torch.core.tree import tree_map
from repro_torch.models import layers, moe as moe_mod, ssm as ssm_mod, xlstm as xlstm_mod
from repro_torch.models.attention import (attention_apply, attention_decode,
                                          attention_decode_paged, attention_init,
                                          attention_prefill, attention_prefill_paged,
                                          cache_init)
from repro_torch.models.config import ModelConfig

Params = Dict[str, Any]

AUX_LOSS_COEF = 0.01


RECURRENT_KINDS = ("hymba", "mlstm", "slstm")


def layer_plan(cfg: ModelConfig):
    """(stacked kind, number of stacked layers, unstacked prefix [(index,
    kind)]) as in the reference: MoE blocks after ``first_k_dense`` dense
    ones, the hybrid's stack, the xLSTM's mLSTM/sLSTM blocks all unstacked
    (None, 0, ...), the dense stack otherwise."""
    if cfg.family == "moe":
        return "moe", cfg.n_layers - cfg.first_k_dense, [
            (i, "dense") for i in range(cfg.first_k_dense)]
    if cfg.family == "hybrid":
        return "hymba", cfg.n_layers, []
    if cfg.family == "ssm":
        return None, 0, [(i, "slstm" if i in cfg.slstm_at else "mlstm")
                         for i in range(cfg.n_layers)]
    return "dense", cfg.n_layers, []


def hymba_global_layers(cfg: ModelConfig):
    """The hybrid stack's global-attention layers: first, middle, last."""
    return {0, cfg.n_layers // 2, cfg.n_layers - 1}


def layer_windows(cfg: ModelConfig) -> List[Optional[int]]:
    """The attention window of each stacked layer: ``cfg.swa_window`` on
    every one, but None (no window) on a hybrid stack's global layers, where
    the reference scans ``BIG_WINDOW = 1 << 30``, a window no sequence
    reaches."""
    _, n_layers, _ = layer_plan(cfg)
    if cfg.family == "hybrid" and cfg.swa_window is not None:
        g = hymba_global_layers(cfg)
        return [None if i in g else cfg.swa_window for i in range(n_layers)]
    return [cfg.swa_window] * n_layers


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------

def block_init(gen: torch.Generator, cfg: ModelConfig, *, kind: str = "dense") -> Params:
    if kind == "hymba":
        return ssm_mod.hymba_block_init(gen, cfg)
    if kind == "mlstm":
        return xlstm_mod.mlstm_block_init(gen, cfg)
    if kind == "slstm":
        return xlstm_mod.slstm_block_init(gen, cfg)
    p = {
        "norm1": layers.norm_init(cfg.norm, cfg.d_model, gen.device),
        "attn": attention_init(gen, cfg),
        "norm2": layers.norm_init(cfg.norm, cfg.d_model, gen.device),
    }
    if kind == "moe":
        p["moe"] = moe_mod.moe_init(gen, cfg)
    else:
        p["mlp"] = layers.mlp_init(gen, cfg.d_model, cfg.d_ff, gated=cfg.gated_mlp)
    return p


def _mlp_half(cfg: ModelConfig, p: Params, x: torch.Tensor) -> torch.Tensor:
    h = layers.norm_apply(cfg.norm, p["norm2"], x)
    return x + layers.mlp_apply(p["mlp"], h, gated=cfg.gated_mlp, act=cfg.act, d_ff=cfg.d_ff)


def _moe_half(cfg: ModelConfig, p: Params, x: torch.Tensor):
    h = layers.norm_apply(cfg.norm, p["norm2"], x)
    mo, aux = moe_mod.moe_apply(cfg, p["moe"], h)
    return x + mo, aux


def block_apply(cfg: ModelConfig, p: Params, x: torch.Tensor,
                positions: torch.Tensor, *, window,
                segment_ids: Optional[torch.Tensor] = None, kind: str = "dense"):
    """→ (x, the block's load-balance loss: an f32 scalar for a MoE block,
    None for the other kinds)."""
    if kind in RECURRENT_KINDS and segment_ids is not None:
        # the recurrent state mixes across the whole row: a segment mask on
        # the attention half alone would leak documents into each other
        raise NotImplementedError(
            f"packed-sequence training (segment_ids) is attention-only; block kind "
            f"{kind!r} carries recurrent state across documents")
    p = zero.gathered(p)
    if kind == "hymba":
        return ssm_mod.hymba_block_apply(cfg, p, x, positions, window=window), None
    if kind == "mlstm":
        return xlstm_mod.mlstm_block_apply(cfg, p, x), None
    if kind == "slstm":
        return xlstm_mod.slstm_block_apply(cfg, p, x), None
    h = layers.norm_apply(cfg.norm, p["norm1"], x)
    x = x + attention_apply(cfg, p["attn"], h, positions, causal=True,
                            window=window, segment_ids=segment_ids)
    if kind == "moe":
        return _moe_half(cfg, p, x)
    return _mlp_half(cfg, p, x), None


def block_prefill(cfg: ModelConfig, p: Params, x: torch.Tensor,
                  positions: torch.Tensor, cache, *, window,
                  segment_ids: Optional[torch.Tensor] = None):
    h = layers.norm_apply(cfg.norm, p["norm1"], x)
    h, cache = attention_prefill(cfg, p["attn"], h, positions, cache,
                                 window=window, segment_ids=segment_ids)
    return _mlp_half(cfg, p, x + h), cache


def block_decode(cfg: ModelConfig, p: Params, x: torch.Tensor, t, cache, *, window,
                 kind: str = "dense"):
    """One token through a block, its cache updated in place → (x, cache)."""
    if kind == "hymba":
        return ssm_mod.hymba_block_decode(cfg, p, x, t, cache, window=window)
    if kind in ("mlstm", "slstm"):
        step = xlstm_mod.mlstm_block_decode if kind == "mlstm" else xlstm_mod.slstm_block_decode
        x, new = step(cfg, p, x, cache)
        for k, v in new.items():
            cache[k].copy_(v)
        return x, cache
    h = layers.norm_apply(cfg.norm, p["norm1"], x)
    h, cache = attention_decode(cfg, p["attn"], h, t, cache, window=window)
    if kind == "moe":
        return _moe_half(cfg, p, x + h)[0], cache
    return _mlp_half(cfg, p, x + h), cache


def block_decode_paged(cfg: ModelConfig, p: Params, x: torch.Tensor, ts: torch.Tensor,
                       pool, page_table: torch.Tensor, *, window) -> torch.Tensor:
    h = layers.norm_apply(cfg.norm, p["norm1"], x)
    h = attention_decode_paged(cfg, p["attn"], h, ts, pool["k"], pool["v"], page_table,
                               window=window)
    return _mlp_half(cfg, p, x + h)


def block_prefill_paged(cfg: ModelConfig, p: Params, x: torch.Tensor,
                        positions: torch.Tensor, valid: torch.Tensor, pool,
                        page_table: torch.Tensor, *, window) -> torch.Tensor:
    h = layers.norm_apply(cfg.norm, p["norm1"], x)
    h = attention_prefill_paged(cfg, p["attn"], h, positions, valid, pool["k"], pool["v"],
                                page_table, window=window)
    return _mlp_half(cfg, p, x + h)


# ---------------------------------------------------------------------------
# model
# ---------------------------------------------------------------------------

def lm_init(gen: torch.Generator, cfg: ModelConfig, *, finish=None) -> Params:
    """fp32 parameters on the generator's device, drawn in the order embed,
    ``pre_blocks``, ``blocks``, lm_head.  ``finish(path, part)`` (the
    session's shard-and-cast) takes each part as soon as it is drawn: the
    embedding, each block, the final norm and the head, so a model is never
    whole in f32; a block it gives None for (one that another pipeline
    stage holds) is left out of ``blocks``.  A plan that stacks nothing
    (the xLSTM's) has no ``blocks`` entry, as the reference's has none."""
    kind, n_layers, pre = layer_plan(cfg)
    if cfg.pos_embed == "learned":
        raise NotImplementedError("learned position embeddings are not ported yet")
    done = finish or (lambda path, part: part)
    p: Params = {"embed": done(("embed",),
                               layers.embed_init(gen, cfg.vocab_size, cfg.d_model))}
    if pre:
        p["pre_blocks"] = [done(("pre_blocks", i), block_init(gen, cfg, kind=k))
                           for i, k in pre]
    if n_layers:
        blocks = (done(("blocks", i), block_init(gen, cfg, kind=kind)) for i in range(n_layers))
        p["blocks"] = [b for b in blocks if b is not None]
    p["final_norm"] = done(("final_norm",),
                           layers.norm_init(cfg.norm, cfg.d_model, gen.device))
    if not cfg.tie_embeddings:
        p["lm_head"] = done(("lm_head",), layers.embed_init(gen, cfg.vocab_size, cfg.d_model))
    return p


def positions(tokens: torch.Tensor) -> torch.Tensor:
    B, S = tokens.shape
    return torch.arange(S, dtype=torch.int32, device=tokens.device)[None].expand(B, S)


def _embed(cfg: ModelConfig, params: Params, tokens: torch.Tensor) -> torch.Tensor:
    return layers.embed_lookup(params["embed"], tokens, cfg.compute_dtype, cfg.vocab_size)


def seq_layout(x: torch.Tensor) -> torch.Tensor:
    """The embedded sequence in the residual stream's layout: under
    sequence parallel this rank's S/tp positions (S % tp must be 0)."""
    if tp.sequence_parallel() and x.shape[1] % tp.size():
        raise ValueError(f"sequence parallel: S={x.shape[1]} is not divisible by "
                         f"tp={tp.size()}")
    return sharding.constrain(x, "batch", "seq", None)


def embed_inputs(cfg: ModelConfig, params: Params, batch: Dict[str, torch.Tensor]
                 ) -> torch.Tensor:
    """The embedded tokens, whole over the sequence; for a VLM batch with
    ``vision_embeds`` (B, nv, d) those, in the compute dtype, in place of
    the first nv positions (the reference's ``_embed_inputs``).  The splice
    follows the vocabulary-parallel lookup's all-reduce, so each vision row
    is counted once."""
    x = _embed(cfg, params, batch["tokens"])
    vis = batch.get("vision_embeds") if cfg.family == "vlm" else None
    if vis is not None:
        x = torch.cat([vis.to(x.dtype), x[:, vis.shape[1]:]], dim=1)
    return x


def embed_stream(cfg: ModelConfig, params: Params, batch: Dict[str, torch.Tensor]
                 ) -> torch.Tensor:
    """:func:`embed_inputs` in the residual stream's layout (the first
    stage's input): the spliced sequence is what sequence parallel
    scatters."""
    return seq_layout(embed_inputs(cfg, params, batch))


def gather_seq(x: torch.Tensor) -> torch.Tensor:
    """Whole hidden states from the residual stream (for every rank to run
    what follows whole)."""
    return tp.gather_seq(x, reduce_grad=False) if tp.sequence_parallel() else x


def head_logits(cfg: ModelConfig, params: Params, x: torch.Tensor, *,
                seq_sharded: bool = False) -> torch.Tensor:
    """Final norm and unembed; ``seq_sharded``: x is this rank's S/tp
    positions, gathered after the norm.  A sharded table gives this rank's
    slice of the vocabulary."""
    x = layers.norm_apply(cfg.norm, params["final_norm"], x)
    table = params.get("lm_head", params["embed"])
    vocab_parallel = table.shape[0] != cfg.vocab_size
    if seq_sharded:
        x = tp.gather_seq(x, reduce_grad=vocab_parallel)
    elif vocab_parallel:
        x = tp.copy_to_tp(x)
    return layers.unembed(table, x)


REMAT_POLICIES = ("none", "full", "dots", "stage")
# the ops "dots" keeps for the backward: the blocks' projection and MLP
# matmuls, which lower to these (``x @ W`` with a 3-D x folds into one mm)
_SAVED_DOTS = frozenset({torch.ops.aten.mm.default, torch.ops.aten.addmm.default})


def _save_dots(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in _SAVED_DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _remat_block(policy: str):
    """``block_apply`` wrapped for ``policy``, or None when nothing is
    recomputed (a MoE block's routing is recomputed with it)."""
    if policy == "none" or not torch.is_grad_enabled():
        return None
    if policy == "dots":
        ctx = functools.partial(create_selective_checkpoint_contexts, _save_dots)
        return functools.partial(checkpoint, block_apply, use_reentrant=False,
                                 context_fn=ctx)
    return functools.partial(checkpoint, block_apply, use_reentrant=False)


def block_fn(policy: str):
    """``block_apply`` as ``policy`` runs it (see :func:`lm_forward`)."""
    return _remat_block(policy) or block_apply


def nll_sum(cfg: ModelConfig, params: Params, x: torch.Tensor, labels: torch.Tensor,
            mask: Optional[torch.Tensor]) -> torch.Tensor:
    """The last hidden states (the residual stream's layout) → ``Σ nll·mask``
    (or ``Σ nll``), in f32: the pipeline's last chunk banks this."""
    logits = head_logits(cfg, params, x, seq_sharded=tp.sequence_parallel())
    nll = layers.token_nll(logits, labels, cfg.vocab_size)
    return torch.sum(nll) if mask is None else torch.sum(nll * mask.to(nll.dtype))


def lm_forward(cfg: ModelConfig, params: Params, batch: Dict[str, torch.Tensor], *,
               remat_policy: str = "full", last_only: bool = False) -> torch.Tensor:
    """→ fp32 logits (B, S, V), or (B, 1, V) when ``last_only`` (the hidden
    states are sliced before the unembed).

    The remat policies are the reference's on one device: ``"full"`` keeps
    only each block's input for the backward and recomputes the block there
    (``jax.checkpoint`` with ``nothing_saveable``), and so does ``"stage"``
    (the reference's policy outside a pipeline); ``"dots"`` also keeps the
    outputs of the block's matmuls and recomputes the rest, the flash
    forward included (``checkpoint_dots_with_no_batch_dims``); ``"none"``
    keeps every activation."""
    return _forward(cfg, params, batch, remat_policy=remat_policy, last_only=last_only)[0]


def _forward(cfg: ModelConfig, params: Params, batch: Dict[str, torch.Tensor], *,
             remat_policy: str, last_only: bool = False):
    """→ (logits, the load-balance loss summed over the blocks: an f32
    scalar, 0 for a dense stack)."""
    kind, _, pre = layer_plan(cfg)
    if remat_policy not in REMAT_POLICIES:
        raise ValueError(f"remat_policy {remat_policy!r} is not one of "
                         f"{', '.join(REMAT_POLICIES)}")
    block = block_fn(remat_policy)
    params = zero.gathered_top(params)
    tokens = batch["tokens"]
    x = embed_stream(cfg, params, batch)
    pos = positions(tokens)
    segment_ids = batch.get("segment_ids")
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    layers_ = ([(bp, k, cfg.swa_window)
                for bp, (_, k) in zip(params.get("pre_blocks", []), pre)]
               + [(bp, kind, w) for bp, w in zip(params.get("blocks", []), layer_windows(cfg))])
    for bp, k, w in layers_:
        x, a = block(cfg, bp, x, pos, window=w, segment_ids=segment_ids, kind=k)
        if a is not None:
            aux = aux + a
    if last_only:
        return head_logits(cfg, params, gather_seq(x)[:, -1:]), aux
    return head_logits(cfg, params, x, seq_sharded=tp.sequence_parallel()), aux


def lm_loss(cfg: ModelConfig, params: Params, batch: Dict[str, torch.Tensor], *,
            remat_policy: str = "full") -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """→ (loss, {"xent", "aux"}): the masked mean cross-entropy plus
    ``AUX_LOSS_COEF`` times the load-balance loss (0 for a dense stack: its
    loss keeps the cross-entropy's bits).  A VLM batch without a
    ``loss_mask`` bears no loss at its first ``n_vision_tokens`` positions."""
    logits, aux = _forward(cfg, params, batch, remat_policy=remat_policy)
    mask = batch.get("loss_mask")
    if cfg.family == "vlm" and mask is None:
        tokens = batch["tokens"]
        keep = torch.arange(tokens.shape[1], device=tokens.device) >= cfg.n_vision_tokens
        mask = keep.to(torch.float32)[None].expand(tokens.shape)
    xent = layers.cross_entropy(logits, batch["labels"], mask, vocab_size=cfg.vocab_size)
    return xent + AUX_LOSS_COEF * aux, {"xent": xent, "aux": aux}


def block_cache_init(cfg: ModelConfig, batch: int, max_len: int, *, kind: str, window,
                     device, ways: int = 1):
    """One layer's decode cache: a ring ``window`` wide (``max_len``
    without one), a hybrid layer's ``{"kv": ring, "ssm_h", "conv"}``, an
    xLSTM layer's recurrent state; at the heads of one of ``ways`` tp
    ranks."""
    if kind == "mlstm":
        return xlstm_mod.mlstm_state_init(cfg, batch, device, ways)
    if kind == "slstm":
        return xlstm_mod.slstm_state_init(cfg, batch, device, ways)
    if kind == "hymba":
        return ssm_mod.hymba_cache_init(cfg, batch, max_len, window=window, device=device,
                                        ways=ways)
    return cache_init(cfg, batch, max_len, window=window, device=device,
                      n_kv_heads=cfg.n_kv_heads // ways)


def tp_ways(cfg: ModelConfig, block: Params) -> int:
    """How many tp ranks split ``block``'s heads (1: whole), read off its
    leaves' widths: the attention's KV projection, the mLSTM's ``in_proj``,
    the sLSTM's ``wz``."""
    if "attn" in block:
        return cfg.n_kv_heads * cfg.hd // block["attn"]["wk"].shape[1]
    if "in_proj" in block:
        return 2 * xlstm_mod._inner(cfg) // block["in_proj"].shape[1]
    return cfg.d_model // block["wz"].shape[1]


def lm_cache_init(cfg: ModelConfig, batch: int, max_len: int, *, device,
                  ways: int = 1) -> Dict[str, List]:
    """``{"blocks": a cache a stacked layer (its window from
    ``layer_windows``), "pre": one an unstacked layer}``, each entry only
    where the plan has such layers, at the heads of one of ``ways`` tp
    ranks."""
    kind, n_layers, pre = layer_plan(cfg)
    kw = dict(device=device, ways=ways)
    caches = {}
    if n_layers:
        caches["blocks"] = [block_cache_init(cfg, batch, max_len, kind=kind, window=w, **kw)
                            for w in layer_windows(cfg)]
    if pre:
        caches["pre"] = [block_cache_init(cfg, batch, max_len, kind=k, window=cfg.swa_window,
                                          **kw) for _, k in pre]
    return caches


def _invalidate_padded_slots(caches, lengths: torch.Tensor) -> None:
    """Set ``pos = -1`` in place on every cache slot holding a padded
    position (``pos >= length`` of its row), so decode's validity mask skips
    it."""
    lim = lengths.reshape(-1, 1)
    for c in caches["blocks"]:
        c["pos"].masked_fill_(c["pos"] >= lim, -1)


def lm_prefill(cfg: ModelConfig, params: Params, batch: Dict[str, torch.Tensor],
               caches) -> Tuple[torch.Tensor, Any]:
    """``lm_forward(last_only=True)`` that also fills the decode caches with
    the prompt's K/V.  Returns (last-position logits (B, V), caches).

    ``batch["lengths"]`` (B,), when present, marks right-padded prompts (the
    scheduler's bucketed, batched admission, with ``segment_ids`` -1 on the
    pad tail): the logits come from position ``lengths - 1`` and cache slots
    holding padded positions are invalidated."""
    layer_plan(cfg)
    tokens = batch["tokens"]
    x = embed_stream(cfg, params, batch)
    pos = positions(tokens)
    for bp, c in zip(params["blocks"], caches["blocks"]):
        x, _ = block_prefill(cfg, bp, x, pos, c, window=cfg.swa_window,
                             segment_ids=batch.get("segment_ids"))
    x = gather_seq(x)
    lengths = batch.get("lengths")
    if lengths is None:
        x_last = x[:, -1:]
    else:
        x_last = x[torch.arange(x.shape[0], device=x.device), lengths.long() - 1][:, None]
        _invalidate_padded_slots(caches, lengths)
    return head_logits(cfg, params, x_last)[:, 0], caches


def lm_decode_step(cfg: ModelConfig, params: Params, token: torch.Tensor, t,
                   caches) -> Tuple[torch.Tensor, Any]:
    """token: (B,) int; t: the position being decoded, an int for every row
    or a (B,) int32 tensor of one per row → (logits (B, V), caches)."""
    kind, _, pre = layer_plan(cfg)
    x = _embed(cfg, params, token[:, None])
    for bp, (_, k), c in zip(params.get("pre_blocks", []), pre, caches.get("pre", [])):
        x, _ = block_decode(cfg, bp, x, t, c, window=cfg.swa_window, kind=k)
    for bp, c, w in zip(params.get("blocks", []), caches.get("blocks", []),
                        layer_windows(cfg)):
        x, _ = block_decode(cfg, bp, x, t, c, window=w, kind=kind)
    return head_logits(cfg, params, x)[:, 0], caches


def lm_prefill_scan(cfg: ModelConfig, params: Params, batch: Dict[str, torch.Tensor],
                    caches, *, step=None) -> Tuple[torch.Tensor, Any]:
    """The reference's decode-scan prefill (``ModelFamily.prefill_cache``):
    one decode step (``step``, :func:`lm_decode_step` by default) a prompt
    position, every row at that position, so capacity routing sees what
    decode sees and a recurrent state consumes the prompt as decode does.
    → (the last position's logits (B, V), caches)."""
    step = step or lm_decode_step
    tokens = batch["tokens"]
    logits = None
    for t in range(tokens.shape[1]):
        logits, caches = step(cfg, params, tokens[:, t], t, caches)
    return logits, caches


# ---------------------------------------------------------------------------
# block-paged KV pool (serving; see repro_torch.session.kvpool)
# ---------------------------------------------------------------------------

def _require_paged_plan(cfg: ModelConfig) -> int:
    scanned_kind, n_scanned, pre = layer_plan(cfg)
    if scanned_kind != "dense" or pre:
        raise NotImplementedError(
            f"paged KV pool requires a pure dense attention stack; "
            f"{cfg.name} has kind={scanned_kind!r} pre={pre}")
    return n_scanned


def lm_paged_pool_init(cfg: ModelConfig, n_pages: int, page_size: int, *, device,
                       dtype=None):
    """One pool of KV pages shared by all requests, per layer k/v
    (n_pages, page_size, Hkv, hd) in the compute dtype (page 0 is the trash
    page).  Sliding-window configs keep full pools (the window is applied at
    attention time)."""
    n_layers = _require_paged_plan(cfg)
    shape = (n_pages, page_size, cfg.n_kv_heads, cfg.hd)
    dt = dtype or cfg.compute_dtype
    return {"blocks": [{"k": torch.zeros(shape, dtype=dt, device=device),
                        "v": torch.zeros(shape, dtype=dt, device=device)}
                       for _ in range(n_layers)]}


def lm_paged_decode_step(cfg: ModelConfig, params: Params, token: torch.Tensor,
                         ts: torch.Tensor, pool, page_tables: torch.Tensor):
    """One decode step in which every row reads and writes K/V through its
    own page-table row at its own position.  token/ts: (B,) int32;
    page_tables: (B, n_max) int32 → (logits (B, V), pool)."""
    _require_paged_plan(cfg)
    x = layers.embed_lookup(params["embed"], token[:, None], cfg.compute_dtype)
    for bp, lp in zip(params["blocks"], pool["blocks"]):
        x = block_decode_paged(cfg, bp, x, ts, lp, page_tables, window=cfg.swa_window)
    return head_logits(cfg, params, x)[:, 0], pool


def lm_paged_prefill(cfg: ModelConfig, params: Params, batch: Dict[str, torch.Tensor],
                     pool, page_tables: torch.Tensor):
    """Suffix prefill into the paged pool.  ``batch``: ``tokens`` (B, S)
    right-padded prompt suffixes, ``hist_lens`` (B,) tokens already in the
    pool through shared prefix pages, ``lengths`` (B,) valid suffix lengths
    (>= 1).  Returns (logits at the last valid suffix position (B, V), pool)."""
    _require_paged_plan(cfg)
    tokens, hist, lengths = batch["tokens"], batch["hist_lens"], batch["lengths"]
    B, S = tokens.shape
    ar = torch.arange(S, dtype=torch.int32, device=tokens.device)[None]
    positions = hist.reshape(B, 1) + ar
    valid = ar < lengths.reshape(B, 1)
    x = layers.embed_lookup(params["embed"], tokens, cfg.compute_dtype)
    for bp, lp in zip(params["blocks"], pool["blocks"]):
        x = block_prefill_paged(cfg, bp, x, positions, valid, lp, page_tables,
                                window=cfg.swa_window)
    x_last = x[torch.arange(B, device=x.device), lengths.long() - 1][:, None]
    return head_logits(cfg, params, x_last)[:, 0], pool


class DecoderOnlyLM:
    """Token-in / logits-out decoder stack (dense backbone)."""

    def init_params(self, cfg, gen, *, finish=None):
        return lm_init(gen, cfg, finish=finish)

    def forward(self, cfg, params, batch, *, last_only=False):
        return lm_forward(cfg, params, batch, remat_policy="none", last_only=last_only)

    def loss(self, cfg, params, batch, *, remat_policy="full"):
        return lm_loss(cfg, params, batch, remat_policy=remat_policy)

    def serve_batch(self, cfg, batch_size, *, device):
        """The non-token inputs a cache init needs: none."""
        return None

    def init_cache(self, cfg, params, batch_size, max_len, batch=None):
        """Caches of the heads ``params`` hold (this rank's under tp): rings,
        a hybrid layer's SSM state beside its ring, an xLSTM layer's
        recurrent state."""
        first = (params.get("blocks") or params["pre_blocks"])[0]
        return lm_cache_init(cfg, batch_size, max_len, device=params["embed"].device,
                             ways=tp_ways(cfg, first))

    def decode_step(self, cfg, params, token, t, caches):
        return lm_decode_step(cfg, params, token, t, caches)

    def prefill_cache(self, cfg, params, batch, caches):
        return lm_prefill(cfg, params, batch, caches)

    def supports_padded_prefill(self, cfg):
        """The parallel causal-attention prefill honours ``lengths``: every
        ported (dense) stack."""
        scanned_kind, _, pre = layer_plan(cfg)
        return scanned_kind == "dense" and not pre

    def cache_slot_axes(self, cfg, caches):
        """The request-slot axis of every cache leaf: the per-layer ring
        caches are (B, ...), so 0 (the reference's stacked leaves put it at
        1, after the layers)."""
        return tree_map(lambda _: 0, caches)

    def supports_paged_cache(self, cfg):
        """Positional K/V lists only: exactly the pure-attention stacks."""
        return self.supports_padded_prefill(cfg)

    def param_sharding_hints(self, cfg):
        """Placement rules matched before ``core.sharding.PARAM_RULES``: none
        for the dense stack."""
        return ()

    def mlp_width(self, cfg):
        """The hidden width of every block's ``mlp`` (``core.sharding``
        leaves such an MLP whole where tp does not divide it)."""
        return cfg.d_ff

    def extra_input_specs(self, cfg, batch_size):
        """The family's non-token prefill inputs, {name: (shape, dtype)}:
        none for a token-only stack."""
        return {}

    def init_paged_pool(self, cfg, params, n_pages, page_size):
        return lm_paged_pool_init(cfg, n_pages, page_size, device=params["embed"].device)

    def paged_decode_step(self, cfg, params, token, ts, pool, page_tables):
        return lm_paged_decode_step(cfg, params, token, ts, pool, page_tables)

    def paged_prefill(self, cfg, params, batch, pool, page_tables):
        return lm_paged_prefill(cfg, params, batch, pool, page_tables)


class MoELM(DecoderOnlyLM):
    """Routed-FFN variant (``models.moe`` blocks after ``first_k_dense``
    dense ones): no padded prefill and no paged pool, as the reference's,
    and the prompt goes into the caches through the decode scan."""

    def prefill_cache(self, cfg, params, batch, caches):
        return lm_prefill_scan(cfg, params, batch, caches)

    def supports_padded_prefill(self, cfg):
        return False

    def param_sharding_hints(self, cfg):
        return moe_mod.SHARDING_HINTS


class HybridLM(DecoderOnlyLM):
    """Hymba's attention + SSM stack (``models.ssm`` blocks): no padded
    prefill, so no paged pool either, as the reference's (a recurrent state
    would consume a padded prompt's tail, and it is not a list of positions
    a page table could index; ``init_paged_pool`` raises in
    ``_require_paged_plan``); the prompt goes into the caches through the
    decode scan."""

    def prefill_cache(self, cfg, params, batch, caches):
        return lm_prefill_scan(cfg, params, batch, caches)

    def supports_padded_prefill(self, cfg):
        return False

    def param_sharding_hints(self, cfg):
        return ssm_mod.SHARDING_HINTS


class SSMLM(DecoderOnlyLM):
    """The xLSTM stack (``models.xlstm``: mLSTM and sLSTM blocks, all
    unstacked): no attention, so no padded prefill and no paged pool, as
    the reference's (``init_paged_pool`` raises in
    ``_require_paged_plan``); the prompt goes into the recurrent states
    through the decode scan.  The placement hints are the hybrid's
    (``_SSM_SCAN_HINTS`` in the reference)."""

    def mlp_width(self, cfg):
        """Only the sLSTM blocks have an ``mlp``: their GeGLU FFN."""
        return xlstm_mod.slstm_ff(cfg)

    def prefill_cache(self, cfg, params, batch, caches):
        return lm_prefill_scan(cfg, params, batch, caches)

    def supports_padded_prefill(self, cfg):
        return False

    def param_sharding_hints(self, cfg):
        return ssm_mod.SHARDING_HINTS


class VLM(DecoderOnlyLM):
    """The dense backbone over ``[vision_embeds; tokens]`` (see
    :func:`embed_inputs`).  No paged pool: the paged suffix prefill is
    token-only, and the vision rows at the leading positions would be
    embedded as tokens; its hook raises as the reference's family hook."""

    def supports_paged_cache(self, cfg):
        return False

    def init_paged_pool(self, cfg, params, n_pages, page_size):
        raise NotImplementedError(
            "vlm: paged KV pool unsupported (supports_paged_cache is False)")

    def extra_input_specs(self, cfg, batch_size):
        """The non-token prefill inputs: {name: (shape, dtype)}."""
        return {"vision_embeds": ((batch_size, cfg.n_vision_tokens, cfg.d_model),
                                  torch.float32)}
