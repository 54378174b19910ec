"""Serving step functions, mirroring the single-device case of
``repro.core.stepfn`` (no mesh, no jit: PyTorch runs eagerly)."""

from __future__ import annotations

import torch

from repro_torch.models import api as model_api
from repro_torch.models.config import ModelConfig


def make_serve_step(cfg: ModelConfig):
    """One greedy decode step: (params, token (B,), t, caches) →
    (next token (B,) int32, caches).  ``torch.argmax`` takes the first
    maximum, as ``jnp.argmax`` does."""

    def serve_step(params, token, t: int, caches):
        logits, caches = model_api.decode_step(cfg, params, token, t, caches)
        return logits.argmax(dim=-1).to(torch.int32), caches

    return serve_step


def make_prefill_cache(cfg: ModelConfig):
    """Prompt ingestion: (params, batch, caches) → (last-position logits
    (B, V), caches), the caches filled with the prompt's K/V."""

    def prefill_cache(params, batch, caches):
        return model_api.prefill_cache(cfg, params, batch, caches)

    return prefill_cache
