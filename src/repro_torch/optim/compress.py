"""Gradient compression, mirroring ``repro.optim.compress``: ``bf16`` rounds
each gradient through bf16; ``int8_ef`` quantizes each leaf to int8 with
its own scale and carries the residual in the ``ef`` state (error feedback),
which is updated in place.  On one device nothing is sent, so compression
changes the numbers only, exactly as the reference's does.

The int8 scale follows the reference's leaves: its ``blocks`` leaves are
stacked (L, ...), so one scale (max |g| over every layer) serves a leaf of
all L blocks.  The port's per-layer leaves are grouped by their path without
the layer index to take the same max, and under tensor parallelism the max
of a tp-sharded leaf is taken over the tp group too (one all-reduce for
every such leaf together).  Under ZeRO the gradients and ``ef`` are this
rank's shards (``ef`` is laid out like ``m``), and one more all-reduce
takes every max over the ``(pod, data)`` plane; on a pipeline's mesh, where
a rank holds one stage's layers, one more over the ``pp`` line."""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch

from repro_torch.core import tp
from repro_torch.core.tree import tree_leaves, tree_map


def init_error_feedback(params):
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device),
                    params)


def _reference_leaf(path: Tuple) -> Tuple:
    """The reference's leaf a port leaf belongs to: its path without the
    layer index of a stacked block."""
    return tuple(p for i, p in enumerate(path) if not (i and path[i - 1] == "blocks"))


def _int8_ef(grads: List[torch.Tensor], ef_state, skip,
             sharded: Optional[Sequence[bool]], plane, line) -> List[torch.Tensor]:
    leaves = tree_leaves(ef_state)
    # one scale per reference leaf; g + e is formed again in the second pass
    # rather than kept, so only one leaf's temporaries live at a time
    amax = {}
    for g, (path, e) in zip(grads, leaves):
        m = torch.max(torch.abs(g.to(torch.float32) + e))
        key = _reference_leaf(path)
        amax[key] = m if key not in amax else torch.maximum(amax[key], m)
    if sharded is not None and tp.size() > 1:
        keys = list(dict.fromkeys(_reference_leaf(path) for (path, _), s
                                  in zip(leaves, sharded) if s))
        if keys:
            whole = tp.all_reduce(torch.stack([amax[k] for k in keys]), op="max")
            amax.update(zip(keys, whole.unbind(0)))
    for group in (plane, line):
        if group is not None:
            keys = list(amax)
            whole = tp.collective("all_reduce_max", torch.stack([amax[k] for k in keys]),
                                  group)
            amax.update(zip(keys, whole.unbind(0)))
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
                      skip: Optional[torch.Tensor] = None,
                      sharded: Optional[Sequence[bool]] = None,
                      plane=None, line=None) -> List[torch.Tensor]:
    """→ the (de)compressed gradient list.  With ``int8_ef`` the ``ef`` leaves
    take their new residuals in place, unless ``skip`` (a 0-d bool) is set;
    ``sharded[i]``: leaf i is this rank's slice of a tp-sharded leaf;
    ``plane``: the process group over which the gradients are ZeRO
    shards; ``line``: the ``pp`` line over which the blocks are spread."""
    if kind is None or kind == "none":
        return grads
    if kind == "bf16":
        return [g.to(torch.bfloat16).to(torch.float32) for g in grads]
    if kind == "int8_ef":
        if ef_state is None:
            raise ValueError("int8_ef compression needs the ef state")
        with torch.no_grad():
            return _int8_ef(grads, ef_state, skip, sharded, plane, line)
    raise ValueError(f"unknown compression {kind!r}")
