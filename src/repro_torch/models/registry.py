"""Model-family registry, mirroring ``repro.models.registry``: ``api``
dispatches on ``cfg.family`` through it, and ``models.api`` registers
every family of the reference."""

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
        raise KeyError(f"unknown model family {cfg.family!r}; registered: "
                       f"{', '.join(sorted(_REGISTRY))}") from None
