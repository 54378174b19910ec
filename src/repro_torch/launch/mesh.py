"""The recipe mesh over ``torch.distributed``, mirroring
``repro.launch.mesh``.

The reference lays its devices out as a ``jax.sharding.Mesh``; the port lays
the ranks of the initialized default process group out as a
:class:`RecipeMesh`: the same ``(pod, data, pp, tp)`` grid with TP innermost
(consecutive ranks share a TP group), the same ``.devices``, ``.shape`` and
``.axis_names`` fields (so ``core.sharding``'s rules read it as the
reference's read a ``Mesh``), and one process group per line of each axis
that is wider than one rank, in the default group's backend, and one group
for this rank's ``(pod, data)`` plane (``groups[PLANE]``: the ranks that share
its ``pp`` and ``tp`` coordinates, where ZeRO shards its states, the
gradients are reduced and the replicas vote).  Several ranks may share one
card: the grid is of ranks, not of devices.

Typical use, in every rank after ``torch.distributed.init_process_group``::

    mesh = make_recipe_mesh(tp=2, device_type="cuda")   # the rest is data parallel
    plan = ParallelismConfig(tp=2, dp=dist.get_world_size() // 2)
    sess = InferenceSession.from_recipe("granite_3_2b", plan=plan, mesh=mesh,
                                        device="cuda")
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch.distributed as dist

from repro_torch.core import tp as tp_mod
from repro_torch.core.recipe import ParallelismConfig, factorize_production_mesh

AXES = ("pod", "data", "pp", "tp")
PLANE = ("pod", "data")


class RecipeMesh:
    """A ``(pod, data, pp, tp)`` grid of process ranks and this rank's
    place in it.  ``groups[axis]`` is the process group of this rank's line
    along ``axis`` (None where the axis is one rank wide), ``groups[PLANE]``
    that of its ``(pod, data)`` plane (None where the plane is one rank), in
    which a rank's index is ``pod * data + data``, the order of the
    reference's shards over ``("pod", "data")``; ``coords[axis]`` is this
    rank's index along an axis."""

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
                tp_mod.name_group(group, axis)
                if self.rank in line:
                    self.groups[axis] = group
        self.groups[PLANE] = None
        if self.plane_size > 1:
            planes = np.moveaxis(devices, (2, 3), (0, 1)).reshape(-1, self.plane_size)
            for plane in planes:
                group = dist.new_group([int(r) for r in plane])
                tp_mod.name_group(group, "pod,data")
                if self.rank in plane:
                    self.groups[PLANE] = group

    @property
    def plane_size(self) -> int:
        """Ranks in a ``(pod, data)`` plane: the data-parallel replicas."""
        return self.shape["pod"] * self.shape["data"]

    @property
    def plane_index(self) -> int:
        """This rank's replica: ``pod * data + data``."""
        return self.coords["pod"] * self.shape["data"] + self.coords["data"]

    @property
    def size(self) -> int:
        return int(self.devices.size)


def make_recipe_mesh(*, pods: int = 1, pp: int = 1, tp: int = 1,
                     device_type: str = "cuda") -> RecipeMesh:
    """The default process group's ranks → the logical (pod, data, pp, tp)
    recipe mesh, as the reference's ``make_recipe_mesh`` lays out devices.

    TP innermost (consecutive ranks, the paper's "TP inside the node"), PP
    next, the pod axis outermost; the ranks left over fold into the data
    axis."""
    world = dist.get_world_size()
    if world % (pods * pp * tp):
        raise ValueError(f"world size {world} not divisible by pods*pp*tp={pods * pp * tp}")
    plan = ParallelismConfig(tp=tp, pp=pp, pods=pods, dp=world // (pods * pp * tp))
    ranks = np.arange(world).reshape((pods,) * (pods > 1) + (plan.dp, pp * tp))
    grid = factorize_production_mesh(ranks, plan)
    return RecipeMesh(grid, device_type=device_type)


def describe(mesh: RecipeMesh) -> str:
    return f"mesh{dict(mesh.shape)} over {mesh.size} ranks ({mesh.device_type})"
