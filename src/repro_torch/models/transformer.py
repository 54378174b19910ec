"""Decoder-only LM, dense arm, mirroring ``repro.models.transformer``.

Parameters are a dict shaped like the reference's pytree, except that the
stacked ``blocks`` leaves (L, ...) become a list of L per-layer dicts, and
the reference's ``lax.scan`` over layers is a Python loop.  Its
``jax.checkpoint`` per layer becomes ``torch.utils.checkpoint`` per block
(``remat_policy="full"``).  Caches are ``{"blocks": [{"k", "v", "pos"},
...]}`` and are updated in place.  The MoE, hybrid, xLSTM and VLM arms are
not ported yet.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.models import layers
from repro_torch.models.attention import (attention_apply, attention_decode,
                                          attention_init, attention_prefill,
                                          cache_init)
from repro_torch.models.config import ModelConfig

Params = Dict[str, Any]


def layer_plan(cfg: ModelConfig):
    """(scanned kind, number of layers, unstacked prefix) as in the
    reference; only the dense plan is ported."""
    if cfg.family != "dense":
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported yet (ROADMAP queue 1, item 8)")
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


def block_decode(cfg: ModelConfig, p: Params, x: torch.Tensor, t: int, cache, *,
                 window):
    h = layers.norm_apply(cfg.norm, p["norm1"], x)
    h, cache = attention_decode(cfg, p["attn"], h, t, cache, window=window)
    return _mlp_half(cfg, p, x + h), cache


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


def _positions(tokens: torch.Tensor) -> torch.Tensor:
    B, S = tokens.shape
    return torch.arange(S, dtype=torch.int32, device=tokens.device)[None].expand(B, S)


def _logits(cfg: ModelConfig, params: Params, x: torch.Tensor) -> torch.Tensor:
    x = layers.norm_apply(cfg.norm, params["final_norm"], x)
    return layers.unembed(params.get("lm_head", params["embed"]), x)


REMAT_POLICIES = ("none", "full")


def lm_forward(cfg: ModelConfig, params: Params, batch: Dict[str, torch.Tensor], *,
               remat_policy: str = "full", last_only: bool = False) -> torch.Tensor:
    """→ fp32 logits (B, S, V), or (B, 1, V) when ``last_only`` (the hidden
    states are sliced before the unembed).

    ``remat_policy="full"`` keeps only each block's input for the backward
    and recomputes the block there (``jax.checkpoint`` with
    ``nothing_saveable`` in the reference); ``"none"`` keeps every
    activation.  ``"dots"`` and ``"stage"`` are not ported yet."""
    layer_plan(cfg)
    if remat_policy not in REMAT_POLICIES:
        raise NotImplementedError(f"remat_policy {remat_policy!r} is not ported yet "
                                  f"(ported: {', '.join(REMAT_POLICIES)})")
    remat = remat_policy == "full" and torch.is_grad_enabled()
    tokens = batch["tokens"]
    x = layers.embed_lookup(params["embed"], tokens, cfg.compute_dtype)
    positions = _positions(tokens)
    segment_ids = batch.get("segment_ids")
    for bp in params["blocks"]:
        kw = dict(window=cfg.swa_window, segment_ids=segment_ids)
        if remat:
            x = checkpoint(block_apply, cfg, bp, x, positions, use_reentrant=False, **kw)
        else:
            x = block_apply(cfg, bp, x, positions, **kw)
    if last_only:
        x = x[:, -1:]
    return _logits(cfg, params, x)


def lm_loss(cfg: ModelConfig, params: Params, batch: Dict[str, torch.Tensor], *,
            remat_policy: str = "full") -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """→ (loss, {"xent", "aux"}); the dense arm has no auxiliary loss, so
    ``aux`` is 0 and the loss is the masked mean cross-entropy."""
    logits = lm_forward(cfg, params, batch, remat_policy=remat_policy)
    xent = layers.cross_entropy(logits, batch["labels"], batch.get("loss_mask"))
    aux = torch.zeros((), dtype=torch.float32, device=xent.device)
    return xent, {"xent": xent, "aux": aux}


def lm_cache_init(cfg: ModelConfig, batch: int, max_len: int, *, device) -> Dict[str, List]:
    _, n_layers, _ = layer_plan(cfg)
    return {"blocks": [cache_init(cfg, batch, max_len, window=cfg.swa_window,
                                  device=device) for _ in range(n_layers)]}


def lm_prefill(cfg: ModelConfig, params: Params, batch: Dict[str, torch.Tensor],
               caches) -> Tuple[torch.Tensor, Any]:
    """``lm_forward(last_only=True)`` that also fills the decode caches with
    the prompt's K/V.  Returns (last-position logits (B, V), caches).
    Right-padded prompts (``batch["lengths"]``) come with the scheduler."""
    layer_plan(cfg)
    if "lengths" in batch:
        raise NotImplementedError("padded prefill (lengths) comes with the "
                                  "continuous-batching scheduler's port")
    tokens = batch["tokens"]
    x = layers.embed_lookup(params["embed"], tokens, cfg.compute_dtype)
    positions = _positions(tokens)
    for bp, c in zip(params["blocks"], caches["blocks"]):
        x, _ = block_prefill(cfg, bp, x, positions, c, window=cfg.swa_window,
                             segment_ids=batch.get("segment_ids"))
    return _logits(cfg, params, x[:, -1:])[:, 0], caches


def lm_decode_step(cfg: ModelConfig, params: Params, token: torch.Tensor, t: int,
                   caches) -> Tuple[torch.Tensor, Any]:
    """token: (B,) int; t: the position being decoded → (logits (B, V), caches)."""
    layer_plan(cfg)
    x = layers.embed_lookup(params["embed"], token[:, None], cfg.compute_dtype)
    for bp, c in zip(params["blocks"], caches["blocks"]):
        x, _ = block_decode(cfg, bp, x, t, c, window=cfg.swa_window)
    return _logits(cfg, params, x)[:, 0], caches


class DecoderOnlyLM:
    """Token-in / logits-out decoder stack (dense backbone)."""

    def init_params(self, cfg, gen):
        return lm_init(gen, cfg)

    def forward(self, cfg, params, batch, *, last_only=False):
        return lm_forward(cfg, params, batch, remat_policy="none", last_only=last_only)

    def loss(self, cfg, params, batch, *, remat_policy="full"):
        return lm_loss(cfg, params, batch, remat_policy=remat_policy)

    def init_cache(self, cfg, params, batch_size, max_len):
        return lm_cache_init(cfg, batch_size, max_len,
                             device=params["embed"].device)

    def decode_step(self, cfg, params, token, t, caches):
        return lm_decode_step(cfg, params, token, t, caches)

    def prefill_cache(self, cfg, params, batch, caches):
        return lm_prefill(cfg, params, batch, caches)
