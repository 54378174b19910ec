"""AdamW with fp32 master weights, mirroring ``repro.optim.adamw``.

Parameters, ``m`` and ``v`` are nests of dicts and lists of tensors (the
port's parameter layout).  :func:`adamw_update` updates them in place, one
leaf at a time, so at 2.5 B parameters no second copy of the state is ever
held; a skipped step (``skip``, a 0-d bool on the device) leaves params,
``m``, ``v`` and the step count as they were without a host sync.

Weight decay follows the reference's leaf rank.  The reference decays leaves
with ``ndim >= 2``, and its ``blocks/*`` leaves are stacked (L, ...), so
every block leaf is decayed there, norm scales and biases included (its
comment says "no decay on norms/biases"; the stacking defeats it), and so
is every leaf of an encoder-decoder's ``enc_blocks`` and ``dec_blocks``.
Only unstacked 1-D leaves such as ``final_norm`` and those of
``pre_blocks`` escape.  The port's stacked leaves are per layer, one rank
lower, so the rank is taken +1 inside those three lists.

Under tensor parallelism and ZeRO (``core.zero``) the gradient norm (the
clip's and the skip gate's) is the whole model's: :func:`mesh_norm` sums
each distinct piece of the gradient once over the ranks it is spread
across, and the update runs on this rank's shard of ``m``, ``v`` and the
master weight (``views``).  There squares accumulate in f64 and the norm
is rounded to f32 once, so a norm summed from a shard's pieces gives the
bits of one summed from whole leaves (the two f64 sums part in their last
bits only); :func:`global_norm` takes f32 on one device, as the reference
does, and f64 where it must give a mesh's bits.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import torch

from repro_torch.core.tree import tree_leaves, tree_map


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0


def init_opt_state(params) -> Dict[str, Any]:
    zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    device = tree_leaves(params)[0][1].device
    return {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
            "step": torch.zeros((), dtype=torch.int32, device=device)}


def _sq_sum(leaves, dtype: torch.dtype, owned: Optional[Sequence[bool]] = None
            ) -> torch.Tensor:
    zero = torch.zeros((), dtype=dtype, device=leaves[0].device)
    return sum((torch.sum(torch.square(x.float()), dtype=dtype)
                for i, x in enumerate(leaves) if owned is None or owned[i]), zero)


def global_norm(leaves, dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """sqrt of the sum of squares of every tensor in ``leaves`` (a list),
    accumulated in ``dtype``, as f32."""
    return torch.sqrt(_sq_sum(leaves, dtype)).float()


def mesh_norm(leaves, owned: Sequence[bool], reduce: Callable[[torch.Tensor], torch.Tensor]
              ) -> torch.Tensor:
    """The norm of a gradient spread over ranks: each rank sums, in f64, the
    squares of the leaves it counts (``owned[i]``: one rank of those that
    hold the same values), and ``reduce`` (an all-reduce) sums the ranks."""
    return torch.sqrt(reduce(_sq_sum(leaves, torch.float64, owned))).float()


STACKED = ("blocks", "enc_blocks", "dec_blocks")


def reference_rank(path: Tuple, p: torch.Tensor) -> int:
    """The rank the reference's leaf has: +1 for a leaf of a stacked block."""
    return p.dim() + (1 if any(s in path for s in STACKED) else 0)


def adamw_update(grads, opt_state, params, lr: torch.Tensor, gnorm: torch.Tensor,
                 cfg: AdamWConfig = AdamWConfig(),
                 skip: torch.Tensor = None, *,
                 views: Optional[Sequence[torch.Tensor]] = None) -> Dict[str, torch.Tensor]:
    """One AdamW step over the leaves, in place, clipped by ``gnorm`` (the
    norm of ``grads``).  ``grads`` is a list in the order of
    ``tree_leaves(params)``; ``views[i]``: the part of leaf i to update (its
    ZeRO shard, laid out like ``m``, ``v`` and the gradient), the whole leaf
    by default.  Returns the metrics {grad_norm, lr}."""
    step = opt_state["step"] + 1
    scale = torch.clamp_max(cfg.grad_clip / (gnorm + 1e-9), 1.0)
    b1c = 1.0 - cfg.b1 ** step.to(torch.float32)
    b2c = 1.0 - cfg.b2 ** step.to(torch.float32)
    ms, vs = tree_leaves(opt_state["m"]), tree_leaves(opt_state["v"])
    with torch.no_grad():
        for i, ((path, p), (_, m), (_, v), g) in enumerate(zip(tree_leaves(params), ms, vs,
                                                                grads)):
            if views is not None:
                p = views[i]
            g = g.to(torch.float32) * scale
            m_new = cfg.b1 * m + (1 - cfg.b1) * g
            v_new = cfg.b2 * v + (1 - cfg.b2) * torch.square(g)
            delta = (m_new / b1c) / (torch.sqrt(v_new / b2c) + cfg.eps)
            if reference_rank(path, p) >= 2:
                delta = delta + cfg.weight_decay * p
            p_new = p - lr * delta
            if skip is None:
                p.copy_(p_new), m.copy_(m_new), v.copy_(v_new)
            else:
                p.copy_(torch.where(skip, p, p_new))
                m.copy_(torch.where(skip, m, m_new))
                v.copy_(torch.where(skip, v, v_new))
        opt_state["step"] = step if skip is None else torch.where(skip, opt_state["step"], step)
    return {"grad_norm": gnorm, "lr": lr}
