"""Model-family registry, mirroring ``repro.models.registry``: ``api``
dispatches on ``cfg.family`` through it.  Only the dense decoder is
registered so far."""

from __future__ import annotations

from typing import Any, Dict

from repro_torch.models.config import ModelConfig

_REGISTRY: Dict[str, Any] = {}


def register_family(name: str, family) -> None:
    _REGISTRY[name] = family


def family_of(cfg: ModelConfig):
    try:
        return _REGISTRY[cfg.family]
    except KeyError:
        raise NotImplementedError(
            f"model family {cfg.family!r} is not ported yet (registered: "
            f"{', '.join(sorted(_REGISTRY))}; ROADMAP queue 1, item 8)") from None
