"""Model API: one entry point per lifecycle stage, dispatched on the family,
mirroring ``repro.models.api`` (the loss, ``forward`` and the serving
stages)."""

from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.models import transformer
from repro_torch.models.config import ModelConfig
from repro_torch.models.registry import family_of, register_family

register_family("dense", transformer.DecoderOnlyLM())


def init_params(cfg: ModelConfig, gen: torch.Generator) -> Any:
    """fp32 parameters on ``gen``'s device."""
    return family_of(cfg).init_params(cfg, gen)


def loss_fn(cfg: ModelConfig, params, batch: Dict[str, torch.Tensor], *,
            remat_policy: str = "full"):
    """→ (scalar loss, {"xent", "aux"})."""
    return family_of(cfg).loss(cfg, params, batch, remat_policy=remat_policy)


def forward(cfg: ModelConfig, params, batch: Dict[str, torch.Tensor], *,
            last_only: bool = False):
    return family_of(cfg).forward(cfg, params, batch, last_only=last_only)


def init_cache(cfg: ModelConfig, params, batch_size: int, max_len: int):
    return family_of(cfg).init_cache(cfg, params, batch_size, max_len)


def decode_step(cfg: ModelConfig, params, token: torch.Tensor, t: int, caches):
    return family_of(cfg).decode_step(cfg, params, token, t, caches)


def prefill_cache(cfg: ModelConfig, params, batch: Dict[str, torch.Tensor], caches):
    """Ingest a prompt into the decode caches → (last-position logits, caches)."""
    return family_of(cfg).prefill_cache(cfg, params, batch, caches)
