"""Gradient compression, mirroring ``repro.optim.compress``: ``bf16`` rounds
each gradient through bf16; ``int8_ef`` quantizes each leaf to int8 with
its own scale and carries the residual in the ``ef`` state (error feedback),
which is updated in place.  On one device nothing is sent, so compression
changes the numbers only, exactly as the reference's does.

The int8 scale follows the reference's leaves: its ``blocks`` leaves are
stacked (L, ...), so one scale (max |g| over every layer) serves a leaf of
all L blocks.  The port's per-layer leaves are grouped by their path without
the layer index to take the same max."""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch

from repro_torch.core.tree import tree_leaves, tree_map


def init_error_feedback(params):
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device),
                    params)


def _reference_leaf(path: Tuple) -> Tuple:
    """The reference's leaf a port leaf belongs to: its path without the
    layer index of a stacked block."""
    return tuple(p for i, p in enumerate(path) if not (i and path[i - 1] == "blocks"))


def _int8_ef(grads: List[torch.Tensor], ef_state, skip) -> List[torch.Tensor]:
    leaves = tree_leaves(ef_state)
    # one scale per reference leaf; g + e is formed again in the second pass
    # rather than kept, so only one leaf's temporaries live at a time
    amax = {}
    for g, (path, e) in zip(grads, leaves):
        m = torch.max(torch.abs(g.to(torch.float32) + e))
        key = _reference_leaf(path)
        amax[key] = m if key not in amax else torch.maximum(amax[key], m)
    out = []
    for g, (path, e) in zip(grads, leaves):
        g = g.to(torch.float32) + e
        scale = torch.clamp_min(amax[_reference_leaf(path)], 1e-12) / 127.0
        q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
        deq = q.to(torch.float32) * scale
        e.copy_(g - deq if skip is None else torch.where(skip, e, g - deq))
        out.append(deq)
    return out


def apply_compression(grads: List[torch.Tensor], kind: Optional[str], ef_state=None,
                      skip: Optional[torch.Tensor] = None) -> List[torch.Tensor]:
    """→ the (de)compressed gradient list.  With ``int8_ef`` the ``ef`` leaves
    take their new residuals in place, unless ``skip`` (a 0-d bool) is set."""
    if kind is None or kind == "none":
        return grads
    if kind == "bf16":
        return [g.to(torch.bfloat16).to(torch.float32) for g in grads]
    if kind == "int8_ef":
        if ef_state is None:
            raise ValueError("int8_ef compression needs the ef state")
        with torch.no_grad():
            return _int8_ef(grads, ef_state, skip)
    raise ValueError(f"unknown compression {kind!r}")
