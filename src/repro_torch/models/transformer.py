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
different tokens over a whole prompt than one position at a time.  The
hybrid, xLSTM and VLM arms are not ported yet.

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
from repro_torch.models import layers, moe as moe_mod
from repro_torch.models.attention import (attention_apply, attention_decode,
                                          attention_decode_paged, attention_init,
                                          attention_prefill, attention_prefill_paged,
                                          cache_init)
from repro_torch.models.config import ModelConfig

Params = Dict[str, Any]

AUX_LOSS_COEF = 0.01


def layer_plan(cfg: ModelConfig):
    """(scanned kind, number of layers, unstacked prefix) as in the
    reference; the dense and MoE plans are ported."""
    if cfg.family == "moe":
        return "moe", cfg.n_layers - cfg.first_k_dense, [
            (i, "dense") for i in range(cfg.first_k_dense)]
    if cfg.family != "dense":
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported yet (ROADMAP Queue 1, item 4: other families)")
    return "dense", cfg.n_layers, []


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------

def block_init(gen: torch.Generator, cfg: ModelConfig, *, kind: str = "dense") -> Params:
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
    return x + layers.mlp_apply(p["mlp"], h, gated=cfg.gated_mlp, act=cfg.act)


def _moe_half(cfg: ModelConfig, p: Params, x: torch.Tensor):
    h = layers.norm_apply(cfg.norm, p["norm2"], x)
    mo, aux = moe_mod.moe_apply(cfg, p["moe"], h)
    return x + mo, aux


def block_apply(cfg: ModelConfig, p: Params, x: torch.Tensor,
                positions: torch.Tensor, *, window,
                segment_ids: Optional[torch.Tensor] = None, kind: str = "dense"):
    """→ (x, the block's load-balance loss: an f32 scalar for a MoE block,
    None for a dense one)."""
    p = zero.gathered(p)
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
    stage holds) is left out of ``blocks``."""
    kind, n_layers, pre = layer_plan(cfg)
    if cfg.pos_embed == "learned":
        raise NotImplementedError("learned position embeddings are not ported yet")
    done = finish or (lambda path, part: part)
    p: Params = {"embed": done(("embed",),
                               layers.embed_init(gen, cfg.vocab_size, cfg.d_model))}
    if pre:
        p["pre_blocks"] = [done(("pre_blocks", i), block_init(gen, cfg, kind=k))
                           for i, k in pre]
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


def _seq_layout(x: torch.Tensor) -> torch.Tensor:
    """The embedded sequence in the residual stream's layout: under
    sequence parallel this rank's S/tp positions (S % tp must be 0)."""
    if tp.sequence_parallel() and x.shape[1] % tp.size():
        raise ValueError(f"sequence parallel: S={x.shape[1]} is not divisible by "
                         f"tp={tp.size()}")
    return sharding.constrain(x, "batch", "seq", None)


def embed_stream(cfg: ModelConfig, params: Params, tokens: torch.Tensor) -> torch.Tensor:
    """The embedded tokens in the residual stream's layout (the first
    stage's input)."""
    return _seq_layout(_embed(cfg, params, tokens))


def _gather_seq(x: torch.Tensor) -> torch.Tensor:
    """Whole hidden states from the residual stream (for every rank to run
    what follows whole)."""
    return tp.gather_seq(x, reduce_grad=False) if tp.sequence_parallel() else x


def _logits(cfg: ModelConfig, params: Params, x: torch.Tensor, *,
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
    logits = _logits(cfg, params, x, seq_sharded=tp.sequence_parallel())
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
    x = embed_stream(cfg, params, tokens)
    pos = positions(tokens)
    segment_ids = batch.get("segment_ids")
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    layers_ = ([(bp, k) for bp, (_, k) in zip(params.get("pre_blocks", []), pre)]
               + [(bp, kind) for bp in params["blocks"]])
    for bp, k in layers_:
        x, a = block(cfg, bp, x, pos, window=cfg.swa_window, segment_ids=segment_ids,
                     kind=k)
        if a is not None:
            aux = aux + a
    if last_only:
        return _logits(cfg, params, _gather_seq(x)[:, -1:]), aux
    return _logits(cfg, params, x, seq_sharded=tp.sequence_parallel()), aux


def lm_loss(cfg: ModelConfig, params: Params, batch: Dict[str, torch.Tensor], *,
            remat_policy: str = "full") -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """→ (loss, {"xent", "aux"}): the masked mean cross-entropy plus
    ``AUX_LOSS_COEF`` times the load-balance loss (0 for a dense stack: its
    loss keeps the cross-entropy's bits)."""
    logits, aux = _forward(cfg, params, batch, remat_policy=remat_policy)
    xent = layers.cross_entropy(logits, batch["labels"], batch.get("loss_mask"),
                                vocab_size=cfg.vocab_size)
    return xent + AUX_LOSS_COEF * aux, {"xent": xent, "aux": aux}


def lm_cache_init(cfg: ModelConfig, batch: int, max_len: int, *, device,
                  n_kv_heads: Optional[int] = None) -> Dict[str, List]:
    _, n_layers, pre = layer_plan(cfg)

    def one():
        return cache_init(cfg, batch, max_len, window=cfg.swa_window, device=device,
                          n_kv_heads=n_kv_heads)

    caches = {"blocks": [one() for _ in range(n_layers)]}
    if pre:
        caches["pre"] = [one() for _ in pre]
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
    x = _seq_layout(_embed(cfg, params, tokens))
    pos = positions(tokens)
    for bp, c in zip(params["blocks"], caches["blocks"]):
        x, _ = block_prefill(cfg, bp, x, pos, c, window=cfg.swa_window,
                             segment_ids=batch.get("segment_ids"))
    x = _gather_seq(x)
    lengths = batch.get("lengths")
    if lengths is None:
        x_last = x[:, -1:]
    else:
        x_last = x[torch.arange(x.shape[0], device=x.device), lengths.long() - 1][:, None]
        _invalidate_padded_slots(caches, lengths)
    return _logits(cfg, params, x_last)[:, 0], caches


def lm_decode_step(cfg: ModelConfig, params: Params, token: torch.Tensor, t,
                   caches) -> Tuple[torch.Tensor, Any]:
    """token: (B,) int; t: the position being decoded, an int for every row
    or a (B,) int32 tensor of one per row → (logits (B, V), caches)."""
    kind, _, pre = layer_plan(cfg)
    x = _embed(cfg, params, token[:, None])
    for bp, (_, k), c in zip(params.get("pre_blocks", []), pre, caches.get("pre", [])):
        x, _ = block_decode(cfg, bp, x, t, c, window=cfg.swa_window, kind=k)
    for bp, c in zip(params["blocks"], caches["blocks"]):
        x, _ = block_decode(cfg, bp, x, t, c, window=cfg.swa_window, kind=kind)
    return _logits(cfg, params, x)[:, 0], caches


def lm_prefill_scan(cfg: ModelConfig, params: Params, batch: Dict[str, torch.Tensor],
                    caches) -> Tuple[torch.Tensor, Any]:
    """The reference's decode-scan prefill (``ModelFamily.prefill_cache``):
    one :func:`lm_decode_step` a prompt position, every row at that
    position, so capacity routing sees what decode sees.  → (the last
    position's logits (B, V), caches)."""
    tokens = batch["tokens"]
    logits = None
    for t in range(tokens.shape[1]):
        logits, caches = lm_decode_step(cfg, params, tokens[:, t], t, caches)
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
    return _logits(cfg, params, x)[:, 0], pool


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
    return _logits(cfg, params, x_last)[:, 0], pool


class DecoderOnlyLM:
    """Token-in / logits-out decoder stack (dense backbone)."""

    def init_params(self, cfg, gen, *, finish=None):
        return lm_init(gen, cfg, finish=finish)

    def forward(self, cfg, params, batch, *, last_only=False):
        return lm_forward(cfg, params, batch, remat_policy="none", last_only=last_only)

    def loss(self, cfg, params, batch, *, remat_policy="full"):
        return lm_loss(cfg, params, batch, remat_policy=remat_policy)

    def init_cache(self, cfg, params, batch_size, max_len):
        """Ring caches of the KV heads ``params`` hold (this rank's under tp)."""
        kv_heads = params["blocks"][0]["attn"]["wk"].shape[1] // cfg.hd
        return lm_cache_init(cfg, batch_size, max_len, device=params["embed"].device,
                             n_kv_heads=kv_heads)

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
