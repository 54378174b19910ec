"""LR schedules, mirroring ``repro.optim.schedule``: linear warmup + cosine
decay, and the post-rollback re-warm factor.  Both stay on the device in
f32, so the step reads no value back to the host."""

from __future__ import annotations

import math

import torch


def lr_schedule(step: torch.Tensor, *, peak: float = 3e-4, warmup: int = 200,
                total: int = 10000, floor_frac: float = 0.1) -> torch.Tensor:
    s = torch.as_tensor(step).to(torch.float32)
    warm = peak * torch.clamp_max((s + 1.0) / max(1, warmup), 1.0)
    t = torch.clamp((s - warmup) / max(1, total - warmup), 0.0, 1.0)
    cos = peak * (floor_frac + (1 - floor_frac) * 0.5 * (1 + torch.cos(math.pi * t)))
    return torch.where(s < warmup, warm, cos)


def rewarm_factor(steps_left: torch.Tensor, total: int):
    """Linear LR re-warm over ``total`` steps after a rollback: with R steps
    left, clip((total - R + 1) / total, 1 / total, 1).  ``total <= 0``
    disables it (a plain 1.0)."""
    if total <= 0:
        return 1.0
    r = torch.as_tensor(steps_left).to(torch.float32)
    return torch.clamp((total - r + 1.0) / total, 1.0 / total, 1.0)
