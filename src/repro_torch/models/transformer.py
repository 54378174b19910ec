"""Decoder-only LM, dense arm, mirroring ``repro.models.transformer``.

Parameters are a dict shaped like the reference's pytree, except that the
stacked ``blocks`` leaves (L, ...) become a list of L per-layer dicts, and
the reference's ``lax.scan`` over layers is a Python loop.  Its
``jax.checkpoint`` per layer becomes ``torch.utils.checkpoint`` per block
(``remat_policy`` "full", "stage" and "dots"; see :func:`lm_forward`).  Caches are ``{"blocks": [{"k", "v", "pos"},
...]}`` and the block-paged pool is ``{"blocks": [{"k", "v"}, ...]}``, one
(n_pages, page_size, Hkv, hd) pair per layer where the reference stacks
(L, ...); both are updated in place.  The MoE, hybrid, xLSTM and VLM arms
are not ported yet.

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
from repro_torch.models import layers
from repro_torch.models.attention import (attention_apply, attention_decode,
                                          attention_decode_paged, attention_init,
                                          attention_prefill, attention_prefill_paged,
                                          cache_init)
from repro_torch.models.config import ModelConfig

Params = Dict[str, Any]


def layer_plan(cfg: ModelConfig):
    """(scanned kind, number of layers, unstacked prefix) as in the
    reference; only the dense plan is ported."""
    if cfg.family != "dense":
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported yet (ROADMAP Queue 1, item 4: other families)")
    return "dense", cfg.n_layers, []


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------

def block_init(gen: torch.Generator, cfg: ModelConfig) -> Params:
    return {
        "norm1": layers.norm_init(cfg.norm, cfg.d_model, gen.device),
        "attn": attention_init(gen, cfg),
        "norm2": layers.norm_init(cfg.norm, cfg.d_model, gen.device),
        "mlp": layers.mlp_init(gen, cfg.d_model, cfg.d_ff, gated=cfg.gated_mlp),
    }


def _mlp_half(cfg: ModelConfig, p: Params, x: torch.Tensor) -> torch.Tensor:
    h = layers.norm_apply(cfg.norm, p["norm2"], x)
    return x + layers.mlp_apply(p["mlp"], h, gated=cfg.gated_mlp, act=cfg.act)


def block_apply(cfg: ModelConfig, p: Params, x: torch.Tensor,
                positions: torch.Tensor, *, window,
                segment_ids: Optional[torch.Tensor] = None) -> torch.Tensor:
    p = zero.gathered(p)
    h = layers.norm_apply(cfg.norm, p["norm1"], x)
    x = x + attention_apply(cfg, p["attn"], h, positions, causal=True,
                            window=window, segment_ids=segment_ids)
    return _mlp_half(cfg, p, x)


def block_prefill(cfg: ModelConfig, p: Params, x: torch.Tensor,
                  positions: torch.Tensor, cache, *, window,
                  segment_ids: Optional[torch.Tensor] = None):
    h = layers.norm_apply(cfg.norm, p["norm1"], x)
    h, cache = attention_prefill(cfg, p["attn"], h, positions, cache,
                                 window=window, segment_ids=segment_ids)
    return _mlp_half(cfg, p, x + h), cache


def block_decode(cfg: ModelConfig, p: Params, x: torch.Tensor, t, cache, *, window):
    h = layers.norm_apply(cfg.norm, p["norm1"], x)
    h, cache = attention_decode(cfg, p["attn"], h, t, cache, window=window)
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

def lm_init(gen: torch.Generator, cfg: ModelConfig) -> Params:
    """fp32 parameters on the generator's device."""
    _, n_layers, _ = layer_plan(cfg)
    if cfg.pos_embed == "learned":
        raise NotImplementedError("learned position embeddings are not ported yet")
    p: Params = {"embed": layers.embed_init(gen, cfg.vocab_size, cfg.d_model)}
    p["blocks"] = [block_init(gen, cfg) for _ in range(n_layers)]
    p["final_norm"] = layers.norm_init(cfg.norm, cfg.d_model, gen.device)
    if not cfg.tie_embeddings:
        p["lm_head"] = layers.embed_init(gen, cfg.vocab_size, cfg.d_model)
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
    recomputed."""
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
    layer_plan(cfg)
    if remat_policy not in REMAT_POLICIES:
        raise ValueError(f"remat_policy {remat_policy!r} is not one of "
                         f"{', '.join(REMAT_POLICIES)}")
    block = block_fn(remat_policy)
    params = zero.gathered_top(params)
    tokens = batch["tokens"]
    x = embed_stream(cfg, params, tokens)
    pos = positions(tokens)
    segment_ids = batch.get("segment_ids")
    for bp in params["blocks"]:
        x = block(cfg, bp, x, pos, window=cfg.swa_window, segment_ids=segment_ids)
    if last_only:
        return _logits(cfg, params, _gather_seq(x)[:, -1:])
    return _logits(cfg, params, x, seq_sharded=tp.sequence_parallel())


def lm_loss(cfg: ModelConfig, params: Params, batch: Dict[str, torch.Tensor], *,
            remat_policy: str = "full") -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """→ (loss, {"xent", "aux"}); the dense arm has no auxiliary loss, so
    ``aux`` is 0 and the loss is the masked mean cross-entropy."""
    logits = lm_forward(cfg, params, batch, remat_policy=remat_policy)
    xent = layers.cross_entropy(logits, batch["labels"], batch.get("loss_mask"),
                                vocab_size=cfg.vocab_size)
    aux = torch.zeros((), dtype=torch.float32, device=xent.device)
    return xent, {"xent": xent, "aux": aux}


def lm_cache_init(cfg: ModelConfig, batch: int, max_len: int, *, device,
                  n_kv_heads: Optional[int] = None) -> Dict[str, List]:
    _, n_layers, _ = layer_plan(cfg)
    return {"blocks": [cache_init(cfg, batch, max_len, window=cfg.swa_window,
                                  device=device, n_kv_heads=n_kv_heads)
                       for _ in range(n_layers)]}


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
    layer_plan(cfg)
    x = _embed(cfg, params, token[:, None])
    for bp, c in zip(params["blocks"], caches["blocks"]):
        x, _ = block_decode(cfg, bp, x, t, c, window=cfg.swa_window)
    return _logits(cfg, params, x)[:, 0], caches


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

    def init_params(self, cfg, gen):
        return lm_init(gen, cfg)

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

    def init_paged_pool(self, cfg, params, n_pages, page_size):
        return lm_paged_pool_init(cfg, n_pages, page_size, device=params["embed"].device)

    def paged_decode_step(self, cfg, params, token, ts, pool, page_tables):
        return lm_paged_decode_step(cfg, params, token, ts, pool, page_tables)

    def paged_prefill(self, cfg, params, batch, pool, page_tables):
        return lm_paged_prefill(cfg, params, batch, pool, page_tables)
