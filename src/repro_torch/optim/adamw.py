"""AdamW with fp32 master weights, mirroring ``repro.optim.adamw``.

Parameters, ``m`` and ``v`` are nests of dicts and lists of tensors (the
port's parameter layout).  :func:`adamw_update` updates them in place, one
leaf at a time, so at 2.5 B parameters no second copy of the state is ever
held; a skipped step (``skip``, a 0-d bool on the device) leaves params,
``m``, ``v`` and the step count as they were without a host sync.

Weight decay follows the reference's leaf rank.  The reference decays leaves
with ``ndim >= 2``, and its ``blocks/*`` leaves are stacked (L, ...), so
every block leaf is decayed there, norm scales and biases included (its
comment says "no decay on norms/biases"; the stacking defeats it).  Only
unstacked 1-D leaves such as ``final_norm`` escape.  The port's block leaves
are per layer, one rank lower, so the rank is taken +1 inside ``blocks``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple

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


def global_norm(leaves) -> torch.Tensor:
    """sqrt of the sum of squares of every tensor in ``leaves`` (a list), in f32."""
    return torch.sqrt(sum(torch.sum(torch.square(x.float())) for x in leaves))


def reference_rank(path: Tuple, p: torch.Tensor) -> int:
    """The rank the reference's leaf has: +1 for a leaf of a stacked block."""
    return p.dim() + (1 if "blocks" in path else 0)


def adamw_update(grads, opt_state, params, lr: torch.Tensor,
                 cfg: AdamWConfig = AdamWConfig(),
                 skip: torch.Tensor = None) -> Dict[str, torch.Tensor]:
    """One AdamW step over the leaves, in place.  ``grads`` is a list in the
    order of ``tree_leaves(params)``.  Returns the metrics {grad_norm, lr}."""
    step = opt_state["step"] + 1
    gnorm = global_norm(grads)
    scale = torch.clamp_max(cfg.grad_clip / (gnorm + 1e-9), 1.0)
    b1c = 1.0 - cfg.b1 ** step.to(torch.float32)
    b2c = 1.0 - cfg.b2 ** step.to(torch.float32)
    ms, vs = tree_leaves(opt_state["m"]), tree_leaves(opt_state["v"])
    with torch.no_grad():
        for (path, p), (_, m), (_, v), g in zip(tree_leaves(params), ms, vs, grads):
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
