"""Weak/strong scaling harness (paper §6, Fig 5), a copy of
``repro.core.scaling``.

Given a base plan, produce the scaled plans and efficiency curves under the
cost model — or, on real hardware, drive the same sweep with measured step
times (the harness only needs a ``measure(plan) → seconds`` callable).

Efficiency is per-device TOKEN throughput relative to the base factor, with
tokens/sec derived from the (estimated or measured) step *time*, so the
bubble, TP/PP communication and ZeRO sync terms all move the curve the way
they move a real run.  The default system is the port's card, ``H100_SXM``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional

from repro_torch.core.cost_model import estimate_step
from repro_torch.core.recipe import ParallelismConfig
from repro_torch.core.systems import H100_SXM, System
from repro_torch.models.config import ModelConfig


def weak_plan(base: ParallelismConfig, factor: int) -> ParallelismConfig:
    """Grow DP with the device count; per-replica work constant."""
    return dataclasses.replace(base, dp=base.dp * factor)


def strong_plan(base: ParallelismConfig, factor: int) -> ParallelismConfig:
    """Fixed global batch: DP grows, per-replica work shrinks.  Shrink the
    micro-batch SIZE before the micro-batch COUNT — dividing GAS first blows
    up the pipeline bubble (the paper's Fig 2 in reverse).

    Refuses factors that would drop GAS below PP: such a plan cannot even
    fill the pipeline once, so "scaling" it would silently train a different
    (bubble-dominated) schedule rather than the same batch faster."""
    shrink_mbs = min(factor, base.mbs)
    mbs = base.mbs // shrink_mbs
    gas = int(round(base.gas / (factor / shrink_mbs)))
    if gas < base.pp:
        raise ValueError(
            f"strong-scaling factor {factor} would need gas={gas} < pp="
            f"{base.pp}: the pipeline cannot fill — shard the model further "
            f"(TP/PP) instead of stretching DP")
    if base.vpp > 1 and gas % base.pp:
        # keep the interleaved schedule's rounds-of-PP invariant
        gas -= gas % base.pp
    return dataclasses.replace(base, dp=base.dp * factor, mbs=mbs, gas=gas)


def tokens_per_step(plan: ParallelismConfig, seq: int) -> int:
    """Global tokens consumed by one optimizer step."""
    return plan.global_batch * seq


def scaling_curve(cfg: ModelConfig, base: ParallelismConfig, *,
                  kind: str, factors=(1, 2, 4, 8),
                  system: System = H100_SXM, seq: int = 2048,
                  measure: Optional[Callable[[ParallelismConfig], float]] = None,
                  ) -> List[Dict[str, float]]:
    """Efficiency = per-device tokens/sec at factor f / at factor 1.

    Without ``measure``, step time comes from the analytic cost model
    (``estimate_step``), so the curve reflects the modeled bubble, TP/PP and
    ZeRO terms; with it, from real hardware."""
    mk = weak_plan if kind == "weak" else strong_plan
    rows = []
    base_tput = None
    for f in factors:
        plan = mk(base, f)
        tokens = tokens_per_step(plan, seq)
        if measure is not None:
            t = measure(plan)
            cost = None
        else:
            cost = estimate_step(cfg, plan, system=system, seq=seq)
            t = cost.t_step
        tput = tokens / t / plan.world
        if base_tput is None:
            base_tput = tput
        row = {"factor": f, "devices": plan.world,
               "tokens_per_step": tokens, "step_time_s": t,
               "per_device_throughput": tput,
               "efficiency": tput / base_tput}
        if cost is not None:
            row.update(bubble=cost.bubble,
                       model_tflops_per_device=cost.model_tflops_per_device,
                       t_overlap=cost.t_overlap)
        rows.append(row)
    return rows
