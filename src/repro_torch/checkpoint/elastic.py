"""Elastic re-scaling: a train state between parallelism plans, mirroring
``repro.checkpoint.elastic``.

Checkpoints are mesh-independent: the port's state is always canonical (a
list of per-layer blocks, restacked to the reference's (L, ...) leaves only
in the files), so for ``pp == 1`` every conversion is the identity and a dp
re-plan needs none.  Pipeline stacking (``pp > 1``) comes with the parallel
recipe (ROADMAP Queue 1, item 3: the parallel recipe over torch.distributed).
"""

from __future__ import annotations

from typing import Any, Dict

from repro_torch.core.recipe import ParallelismConfig


def _no_pipeline(plan: ParallelismConfig) -> None:
    if plan.pp > 1:
        raise NotImplementedError(
            f"pp={plan.pp}: pipeline-stacked states come with the parallel recipe "
            "(ROADMAP Queue 1, item 3: the parallel recipe over torch.distributed)")


def canonicalize_state(state: Dict[str, Any], plan: ParallelismConfig) -> Dict[str, Any]:
    """Remove plan-specific layout before saving (none for pp == 1)."""
    _no_pipeline(plan)
    return state


def reshard_state(state: Dict[str, Any], new_plan: ParallelismConfig) -> Dict[str, Any]:
    """Canonical state → layout for ``new_plan`` (inverse of canonicalize)."""
    _no_pipeline(new_plan)
    return state


def replan_state(state: Dict[str, Any], old_plan: ParallelismConfig,
                 new_plan: ParallelismConfig) -> Dict[str, Any]:
    """Convert a live train state between plans in one hop."""
    return reshard_state(canonicalize_state(state, old_plan), new_plan)
