"""Model API: one entry point per lifecycle stage, dispatched on the family,
mirroring ``repro.models.api`` (the loss, ``forward`` and the serving
stages: ring caches, recurrent states and cross K/V, slot axes and the
block-paged pool).  Every family of the reference is registered: the dense
decoder, MoE, VLM, hybrid, xLSTM (``ssm``) and encoder-decoder
(``encdec``)."""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from repro_torch.models import encdec, transformer
from repro_torch.models.config import ModelConfig
from repro_torch.models.registry import family_of, register_family

register_family("dense", transformer.DecoderOnlyLM())
register_family("moe", transformer.MoELM())
register_family("vlm", transformer.VLM())
register_family("hybrid", transformer.HybridLM())
register_family("ssm", transformer.SSMLM())
register_family("encdec", encdec.EncDecFamily())


def init_params(cfg: ModelConfig, gen: torch.Generator, *, finish=None) -> Any:
    """fp32 parameters on ``gen``'s device; ``finish(path, part)`` takes
    each part (a block, the embedding, ...) as it is drawn (see
    ``transformer.lm_init``)."""
    return family_of(cfg).init_params(cfg, gen, finish=finish)


def loss_fn(cfg: ModelConfig, params, batch: Dict[str, torch.Tensor], *,
            remat_policy: str = "full"):
    """→ (scalar loss, {"xent", "aux"})."""
    return family_of(cfg).loss(cfg, params, batch, remat_policy=remat_policy)


def forward(cfg: ModelConfig, params, batch: Dict[str, torch.Tensor], *,
            last_only: bool = False):
    return family_of(cfg).forward(cfg, params, batch, last_only=last_only)


def init_cache(cfg: ModelConfig, params, batch_size: int, max_len: int,
               batch: Optional[Dict[str, torch.Tensor]] = None):
    """Decode caches; ``batch`` holds the family's non-token inputs (an
    encoder-decoder's ``frames``), stubbed by its ``serve_batch`` when
    absent, as the reference's."""
    fam = family_of(cfg)
    if batch is None:
        batch = fam.serve_batch(cfg, batch_size, device=params["embed"].device)
    return fam.init_cache(cfg, params, batch_size, max_len, batch)


def decode_step(cfg: ModelConfig, params, token: torch.Tensor, t, caches):
    """One token per row against the caches; ``t`` an int or a (B,) int32
    tensor of one position per row → (logits (B, V), caches)."""
    return family_of(cfg).decode_step(cfg, params, token, t, caches)


def prefill_cache(cfg: ModelConfig, params, batch: Dict[str, torch.Tensor], caches):
    """Ingest a prompt into the decode caches → (last-position logits, caches)."""
    return family_of(cfg).prefill_cache(cfg, params, batch, caches)


def cache_slot_axes(cfg: ModelConfig, caches):
    """The request-slot axis of every cache leaf (a tree shaped like
    ``caches``)."""
    return family_of(cfg).cache_slot_axes(cfg, caches)


def supports_paged_cache(cfg: ModelConfig) -> bool:
    """Whether the family's caches can live in the block-paged KV pool."""
    return family_of(cfg).supports_paged_cache(cfg)


def init_paged_pool(cfg: ModelConfig, params, n_pages: int, page_size: int):
    return family_of(cfg).init_paged_pool(cfg, params, n_pages, page_size)


def paged_decode_step(cfg: ModelConfig, params, token: torch.Tensor, ts: torch.Tensor,
                      pool, page_tables: torch.Tensor):
    return family_of(cfg).paged_decode_step(cfg, params, token, ts, pool, page_tables)


def paged_prefill(cfg: ModelConfig, params, batch: Dict[str, torch.Tensor], pool,
                  page_tables: torch.Tensor):
    return family_of(cfg).paged_prefill(cfg, params, batch, pool, page_tables)
