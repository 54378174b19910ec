"""The recipe mesh over ``torch.distributed``, mirroring
``repro.launch.mesh``.

The reference lays its devices out as a ``jax.sharding.Mesh``; the port lays
the ranks of the initialized default process group out as a
:class:`RecipeMesh`: the same ``(pod, data, pp, tp)`` grid with TP innermost
(consecutive ranks share a TP group), the same ``.devices``, ``.shape`` and
``.axis_names`` fields (so ``core.sharding``'s rules read it as the
reference's read a ``Mesh``), and one process group per line of each axis
that is wider than one rank, in the default group's backend.  Several ranks
may share one card: the grid is of ranks, not of devices.

Typical use, in every rank after ``torch.distributed.init_process_group``::

    mesh = make_recipe_mesh(tp=2, device_type="cuda")
    plan = ParallelismConfig(tp=2)
    sess = InferenceSession.from_recipe("granite_3_2b", plan=plan, mesh=mesh,
                                        device="cuda")
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch.distributed as dist

from repro_torch.core.recipe import ParallelismConfig, factorize_production_mesh

AXES = ("pod", "data", "pp", "tp")


class RecipeMesh:
    """A ``(pod, data, pp, tp)`` grid of process ranks and this rank's
    place in it.  ``groups[axis]`` is the process group of this rank's line
    along ``axis`` (None where the axis is one rank wide); ``coords[axis]``
    is this rank's index along it."""

    axis_names = AXES

    def __init__(self, devices: np.ndarray, *, device_type: str):
        if devices.ndim != len(AXES):
            raise ValueError(f"a recipe mesh is {AXES}, got a grid of shape {devices.shape}")
        self.devices = devices
        self.shape: Dict[str, int] = dict(zip(AXES, devices.shape))
        self.device_type = device_type
        self.rank = dist.get_rank()
        where = np.argwhere(devices == self.rank)
        if len(where) != 1:
            raise ValueError(f"rank {self.rank} is not once in the grid {devices.tolist()}")
        self.coords: Dict[str, int] = dict(zip(AXES, (int(c) for c in where[0])))
        self.groups: Dict[str, Optional[dist.ProcessGroup]] = {}
        for i, axis in enumerate(AXES):
            self.groups[axis] = None
            if devices.shape[i] == 1:
                continue
            # every rank creates every line's group, in one order
            lines = np.moveaxis(devices, i, -1).reshape(-1, devices.shape[i])
            for line in lines:
                group = dist.new_group([int(r) for r in line])
                if self.rank in line:
                    self.groups[axis] = group

    @property
    def size(self) -> int:
        return int(self.devices.size)


def make_recipe_mesh(*, pp: int = 1, tp: int = 1, device_type: str = "cuda") -> RecipeMesh:
    """The default process group's ranks → the logical (pod, data, pp, tp)
    recipe mesh.

    TP innermost (consecutive ranks, the paper's "TP inside the node"), PP
    next; the ranks left over fold into the data axis."""
    world = dist.get_world_size()
    if world % (pp * tp):
        raise ValueError(f"world size {world} not divisible by pp*tp={pp * tp}")
    plan = ParallelismConfig(tp=tp, pp=pp, dp=world // (pp * tp))
    grid = factorize_production_mesh(np.arange(world).reshape(plan.dp, pp * tp), plan)
    return RecipeMesh(grid, device_type=device_type)


def describe(mesh: RecipeMesh) -> str:
    return f"mesh{dict(mesh.shape)} over {mesh.size} ranks ({mesh.device_type})"
