"""Elastic re-scaling: a train state between parallelism plans, mirroring
``repro.checkpoint.elastic``.

Checkpoints are mesh-independent: the files hold the canonical state (a
list of per-layer blocks, restacked to the reference's (L, ...) leaves, every
leaf whole).  On one device the port's state is canonical already, so for
``pp == 1`` every conversion is the identity.  On a mesh
(``launch.mesh.RecipeMesh``) a rank holds shards (tp, and ZeRO's: the
parameters' data-axis shard under ZeRO-3, ``m``, ``v`` and ``ef`` under
``core.zero.opt_shardings``): :func:`host_snapshot` gathers them leaf by
leaf, collectively, into host arrays on the ranks that keep them (the
writer), and :func:`reshard_state` keeps this rank's shards of a whole
state read on the host, moving only those to the device.  No device holds
the whole state.  So a dp re-plan is the identity on the canonical state: a
checkpoint written at dp = 2 under ZeRO-3 restores at dp = 1, into the
reference, or at any other dp, stage or tp.

At ``pp > 1`` the one-device state keeps the flat per-layer block list (the
pipeline indexes its chunks in place, ``core.pipeline``), so a pp or vpp
re-plan without a mesh is the identity too, where the reference restacks
its ``(PP, L/PP, ...)`` leaves.  On a mesh a rank holds its stage's layers:
:func:`host_snapshot` gathers each stage's layers to the writer leaf by leaf
over the ``pp`` line, and :func:`reshard_state` keeps this stage's layers of
a whole state.  A checkpoint written at pp = 2 restores at pp = 1, at pp =
4, and into the reference's store.  Re-planning a live state onto another
mesh waits for the fleet (ROADMAP Queue 1, item 3: the parallel recipe over
torch.distributed; its item 3.4).
"""

from __future__ import annotations

from typing import Any, Dict, List, Tuple

import numpy as np
import torch

from repro_torch.checkpoint.bridge import state_leaves, to_host
from repro_torch.core import pipeline, sharding, tp
from repro_torch.core.tree import tree_map
from repro_torch.core.recipe import ParallelismConfig


def canonicalize_state(state: Dict[str, Any], plan: ParallelismConfig) -> Dict[str, Any]:
    """Remove plan-specific layout before saving: none on one device, at
    any pp (a mesh's state goes through :func:`host_snapshot`)."""
    return state


def _reference_leaf(path: Tuple) -> str:
    """A port leaf's reference path (the layer index of a block dropped)."""
    return "/".join(str(p) for i, p in enumerate(path) if not (i and path[i - 1] == "blocks"))


def host_snapshot(state: Dict[str, Any], plan: ParallelismConfig, *, mesh, cfg,
                  keep: bool = True) -> List[Tuple[str, np.ndarray]]:
    """The whole canonical state of a mesh's sharded ``state`` as host
    arrays, ``[(reference path, array)]`` in the reference's leaf order
    (``bridge.state_to_numpy``'s items; what ``store.save_checkpoint``
    writes).  Every rank takes part in each leaf's gathers in turn; a rank
    that ``keep``s copies the whole leaf to the host, the others drop it at
    once, so no device holds more than one whole leaf beyond its shards.
    ``cfg`` (the model config) gives the whole shapes.  ``[]`` where not
    ``keep``."""
    from repro_torch.core import zero
    hints = zero.family_hints(cfg)
    shapes = sharding.whole_shapes(state["params"], mesh, plan, cfg.vocab_size, cfg.d_model,
                                   hints=hints)
    p_specs = zero.param_shardings(shapes, mesh, plan, hints=hints)
    o_specs = zero.opt_shardings(p_specs, shapes, mesh, plan, zero.n_stacked(cfg))
    stages = pipeline.split_stages(mesh, plan)
    rows = None
    if stages:
        per = [pipeline.stage_layers(cfg.n_layers, plan, p) for p in range(plan.pp)]
        rows = [[per[p][i] for p in range(plan.pp)] for i in range(len(per[0]))]
    specs = {}
    for path, _ in shapes:
        key = _reference_leaf(path)
        specs["params/" + key] = p_specs[path]
        for tree in ("opt/m/", "opt/v/", "ef/"):
            specs[tree + key] = o_specs[path]
    out = []
    with torch.no_grad():
        for key, leaf in state_leaves(state):
            spec = specs.get(key)
            fetch = torch.Tensor.detach if spec is None else (
                lambda x, spec=spec: zero.gather(x.detach(), spec, mesh))
            split = stages and isinstance(leaf, list)
            if split:
                # this stage's i-th layer beside every other stage's
                fetch = (lambda x, f=fetch:
                         tp.collective("all_gather", f(x)[None], mesh.groups["pp"]))
            if keep:
                out.append((key, to_host(leaf, fetch, rows if split else None)))
            else:
                for x in (leaf if isinstance(leaf, list) else [leaf]):
                    fetch(x)
    return out


def reshard_state(state: Dict[str, Any], new_plan: ParallelismConfig, *,
                  mesh=None, device=None, cfg=None) -> Dict[str, Any]:
    """Canonical state → layout for ``new_plan`` (inverse of canonicalize):
    on a mesh, this rank's shards, each moved to ``device`` (the state's
    own by default) as a copy: a whole state read on the host reaches the
    device as shards only.  ``cfg`` (the model config) gives its family's
    placement hints (none without it: the dense stack's)."""
    if mesh is None:
        return state
    from repro_torch.core import zero
    hints = () if cfg is None else zero.family_hints(cfg)
    out = tree_map(lambda x: x if device is None else x.to(device),
                   {k: v for k, v in state.items() if k not in ("params", "opt", "ef")})
    out["opt"] = {k: v if device is None else v.to(device)
                  for k, v in state["opt"].items() if k not in ("m", "v")}
    for key in ("m", "v"):
        out["opt"][key] = sharding.shard_state(state["opt"][key], mesh, new_plan, device,
                                               hints=hints)
    if "ef" in state:
        out["ef"] = sharding.shard_state(state["ef"], mesh, new_plan, device, hints=hints)
    out["params"] = sharding.shard_params(state["params"], mesh, new_plan, device, hints=hints)
    return out


def replan_state(state: Dict[str, Any], old_plan: ParallelismConfig,
                 new_plan: ParallelismConfig) -> Dict[str, Any]:
    """Convert a live (one-device) train state between plans in one hop (at
    any pp and vpp the identity: the state keeps the flat block list)."""
    return reshard_state(canonicalize_state(state, old_plan), new_plan)
