"""ZeRO sharded data parallelism over ``torch.distributed``, mirroring
``repro.core.zero``.

The reference maps DeepSpeed's stages to XLA shardings:

  stage 1 — optimizer states sharded over the DP axes; params/grads replicated;
  stage 2 — as 1, plus gradient buffers sharded;
  stage 3 — params themselves sharded over the intra-pod data axis (FSDP).

The rules (``_zero_axes``, ``zero_shard``, ``param_shardings``,
``opt_shardings``, ``grad_constraint``) are the reference's, resolved to
plain tuples over a ``launch.mesh.RecipeMesh`` as ``core.sharding`` resolves
tp's: a spec has one entry per dim of a leaf, ``None``, an axis name or a
tuple of them.  The reference applies ``zero_shard`` to a stacked block
leaf: ``(L, *leaf)``, at pp > 1 ``(PP, L/PP, *leaf)`` or ``(VPP, PP,
L/(PP·VPP), *leaf)`` with the stage axis on ``pp``
(``core.pipeline.stack_shape``); the port's block leaves are per layer, so
the rule sees the stacked shape and the dim it picks maps back to the leaf.
Where it picks a stacking axis (a 1-D leaf whose one dim carries the tp
axis, even one rank wide: qwen1.5's ``bq``/``bk``/``bv``) the reference
spreads whole layers of the state over the plane; the port keeps such a
leaf's state whole on every rank instead (120 KB a layer at qwen1.5's full
width).

The port places the shards itself (:class:`Layout`, one record a leaf):

* stage 1: ``m``, ``v`` and ``ef`` hold this rank's shard along the dim
  ``opt_shardings`` adds; the gradient is all-reduced over the rank's
  ``(pod, data)`` plane, the update runs on the shard of the master weight,
  and the new shard is all-gathered over the plane;
* stage 2: the same, the gradient reduce-scattered to the shard;
* stage 3: a parameter whose ``embed`` dim the data axis divides holds
  only this rank's slice of it.  The blocks gather such a leaf through
  :func:`gathered` when they run (an all-gather a leaf a layer a forward,
  again in a remat recompute, a reduce-scatter of its gradient in the
  backward); the embedding, the unembed and the final norm are gathered
  once a forward (a tied table's two reads share one gather, so its two
  gradients meet before the reduce-scatter as on one device).  The update
  keeps only the shard.

Every collective goes through ``core.tp.collective``.
"""

from __future__ import annotations

import math
from contextlib import contextmanager
from types import SimpleNamespace
from typing import Dict, List, Tuple, Union

import torch

from repro_torch.core import pipeline, sharding, tp
from repro_torch.core.recipe import ParallelismConfig, axis_mapping
from repro_torch.core.tree import tree_leaves

PLANE = ("pod", "data")

Spec = Tuple


# ---------------------------------------------------------------------------
# the reference's rules
# ---------------------------------------------------------------------------

def _zero_axes(mesh, plan: ParallelismConfig) -> Tuple[str, ...]:
    return tuple(a for a in PLANE if a in mesh.axis_names and mesh.shape[a] > 1)


def zero_shard(spec: Spec, shape: Tuple[int, ...], mesh, axes: Tuple[str, ...]) -> Spec:
    """Add the ZeRO axes to the largest divisible unsharded dim of a leaf."""
    if not axes or not shape:
        return spec
    ways = math.prod(mesh.shape[a] for a in axes)
    parts = list(spec) + [None] * (len(shape) - len(spec))
    used = set()
    for p in parts:
        if p is None:
            continue
        used.update(p if isinstance(p, tuple) else (p,))
    if any(a in used for a in axes):
        return spec
    order = sorted(range(len(shape)), key=lambda i: -shape[i])
    for i in order:
        if parts[i] is None and shape[i] % ways == 0 and shape[i] >= ways:
            parts[i] = axes if len(axes) > 1 else axes[0]
            return tuple(parts)
    return spec


def _stacked(path: Tuple, stacks=("blocks",)) -> bool:
    return len(path) > 1 and path[0] in stacks


def family_hints(cfg) -> Tuple:
    """``param_sharding_hints`` of ``cfg``'s family (the reference's
    ``zero.family_hints``)."""
    from repro_torch.models import api
    return tuple(api.family_of(cfg).param_sharding_hints(cfg))


def stacks(cfg) -> Dict[str, int]:
    """{stack: its layers} of the reference's stacked layer lists: the
    ``blocks`` of :func:`n_stacked` layers, an encoder-decoder's
    ``enc_blocks`` and ``dec_blocks``; none for the xLSTM."""
    if cfg.family == "encdec":
        return {"enc_blocks": cfg.enc_layers, "dec_blocks": cfg.n_layers}
    return {"blocks": n_stacked(cfg)} if n_stacked(cfg) else {}


def n_stacked(cfg) -> int:
    """The layers of the reference's stacked ``blocks`` (its unstacked
    ``pre_blocks`` apart; the xLSTM stacks none)."""
    return 0 if cfg.family == "ssm" else cfg.n_layers - cfg.first_k_dense


def param_shardings(shapes, mesh, plan: ParallelismConfig, *, hints: Tuple = ()
                    ) -> Dict[Tuple, Spec]:
    """{leaf path: spec} from ``[(path, whole shape)]``: the recipe's logical
    axes, the family's ``hints`` (:func:`family_hints`) matched first,
    resolved and sanitized (under ZeRO-3 ``embed`` resolves to the data
    axis)."""
    rules = sharding.AxisRules(mesh, axis_mapping(plan))
    return {path: sharding.sanitize(
                rules.resolve(sharding.spec_for_path("/".join(map(str, path)), shape,
                                                     extra_rules=hints)),
                shape, mesh)
            for path, shape in shapes}


def opt_shardings(p_specs: Dict[Tuple, Spec], shapes, mesh, plan: ParallelismConfig,
                  n_layers: Union[int, Dict[str, int]]) -> Dict[Tuple, Spec]:
    """Optimizer-state specs: the parameters' plus the ZeRO axes (stage ≥ 1),
    chosen on the reference's stacked shape for a block leaf (``(n_layers,
    *leaf)``, or pp-stacked under ``plan``).  Where the rule picks a
    stacking axis the leaf keeps the parameter's spec.  ``n_layers``: the
    ``blocks`` stack's layers, or {stack: layers} for an encoder-decoder's
    ``enc_blocks`` and ``dec_blocks`` (never pipelined)."""
    if plan.zero_stage < 1:
        return dict(p_specs)
    axes = _zero_axes(mesh, plan)
    stacks = n_layers if isinstance(n_layers, dict) else {"blocks": n_layers}
    leads = {}
    for name, n in stacks.items():
        lead = pipeline.stack_shape(n, plan) if name == "blocks" else (n,)
        axes_ = pipeline.stack_axes(plan) if name == "blocks" else ("layers",)
        leads[name] = (lead, sharding.sanitize(sharding.AxisRules(
            mesh, axis_mapping(plan)).resolve(axes_), lead, mesh))
    out = {}
    for path, shape in shapes:
        spec = tuple(p_specs[path]) + (None,) * (len(shape) - len(p_specs[path]))
        if _stacked(path, tuple(leads)):
            lead, lead_spec = leads[path[0]]
            got = zero_shard(lead_spec + spec, lead + tuple(shape), mesh, axes)
            if tuple(got[:len(lead)]) != lead_spec:
                out[path] = spec
                continue
            got = tuple(got[len(lead):])
        else:
            got = tuple(zero_shard(spec, tuple(shape), mesh, axes))
        out[path] = got + (None,) * (len(shape) - len(got))
    return out


def grad_constraint(p_specs: Dict[Tuple, Spec], o_specs: Dict[Tuple, Spec],
                    plan: ParallelismConfig) -> Dict[Tuple, Spec]:
    """The specs the reduced gradients take: the optimizer state's from ZeRO-2
    on (a reduce-scatter), the parameters' below (an all-reduce)."""
    return dict(o_specs) if plan.zero_stage >= 2 else dict(p_specs)


# ---------------------------------------------------------------------------
# placing a spec on the mesh
# ---------------------------------------------------------------------------

def _axes(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, tuple) else (entry,)


def live_axes(mesh, entry) -> Tuple[str, ...]:
    """The axes of a spec entry that are wider than one rank."""
    return tuple(a for a in _axes(entry) if mesh.shape[a] > 1)


def group_of(mesh, axes: Tuple[str, ...]):
    """The process group of this rank's line (or plane) over ``axes``."""
    axes = tuple(a for a in axes if mesh.shape[a] > 1)
    if not axes:
        return None
    if len(axes) == 1:
        return mesh.groups[axes[0]]
    if set(axes) == set(PLANE):
        return mesh.groups[PLANE]
    raise ValueError(f"no process group spans the axes {axes}")


def _index(mesh, axes: Tuple[str, ...]) -> int:
    i = 0
    for a in axes:
        i = i * mesh.shape[a] + mesh.coords[a]
    return i


def _entries(spec: Spec, mesh):
    """(dim, live axes) of every entry of ``spec`` that is sharded."""
    for d, e in enumerate(spec):
        axes = live_axes(mesh, e)
        if axes:
            yield d, axes


def local(x: torch.Tensor, spec: Spec, mesh) -> torch.Tensor:
    """This rank's block (a view) of ``x`` laid out as ``spec``."""
    for d, axes in _entries(spec, mesh):
        w = x.shape[d] // math.prod(mesh.shape[a] for a in axes)
        x = x.narrow(d, _index(mesh, axes) * w, w)
    return x


def gather(x: torch.Tensor, spec: Spec, mesh) -> torch.Tensor:
    """The inverse of :func:`local`: all-gathers along every sharded dim."""
    for d, axes in _entries(spec, mesh):
        x = tp.all_gather(x, d, group_of(mesh, axes))
    return x


# ---------------------------------------------------------------------------
# the step's view of the leaves
# ---------------------------------------------------------------------------

class Layout:
    """Per leaf of this rank's parameters (``tree_leaves`` order): its whole
    shape and specs, and where ZeRO puts it.

    ``fsdp_dim``: the dim ZeRO-3 cuts over the data axis (None if the leaf
    is whole over it); ``z_dim``/``z_axes``: the dim and plane axes the
    optimizer shard adds to the parameter's layout (None if the state is
    laid out like the parameter); ``scatter``: the reduced gradient takes
    the optimizer shard's layout (``grad_constraint``: a reduce-scatter);
    ``tp_sharded``: cut over tp."""

    def __init__(self, cfg, plan: ParallelismConfig, mesh, params):
        self.plan, self.mesh = plan, mesh
        hints = family_hints(cfg)
        shapes = sharding.whole_shapes(params, mesh, plan, cfg)
        p_specs = param_shardings(shapes, mesh, plan, hints=hints)
        o_specs = opt_shardings(p_specs, shapes, mesh, plan, stacks(cfg))
        g_specs = grad_constraint(p_specs, o_specs, plan)
        self.shapes = shapes
        self.leaves: List[SimpleNamespace] = []
        for path, shape in shapes:
            p, o = p_specs[path], o_specs[path]
            leaf = SimpleNamespace(path=path, shape=shape, p_spec=p, o_spec=o,
                                   tp_sharded=any("tp" in live_axes(mesh, e) for e in p),
                                   fsdp_dim=None, z_dim=None, z_axes=(),
                                   scatter=g_specs[path] != p)
            for d, e in enumerate(p):
                if "data" in live_axes(mesh, e):
                    leaf.fsdp_dim = d
            for d, e in enumerate(o):
                extra = tuple(a for a in live_axes(mesh, e) if a not in live_axes(mesh, p[d]))
                if extra:
                    leaf.z_dim, leaf.z_axes = d, extra
            self.leaves.append(leaf)
        self.plane = group_of(mesh, PLANE)
        self.n_plane = mesh.plane_size

    def fsdp_ids(self, params) -> Dict[int, int]:
        """{id(leaf): dim} of ``params``' leaves that ZeRO-3 cut (for
        :func:`fsdp`)."""
        return {id(x): lf.fsdp_dim for (_, x), lf in zip(tree_leaves(params), self.leaves)
                if lf.fsdp_dim is not None}

    def gather_all(self, params, dtype=None):
        """Whole-over-data copies of ``params``' leaves (cast to ``dtype``
        first), without autograd: the gather-once paths."""
        out = []
        with torch.no_grad():
            for (_, x), lf in zip(tree_leaves(params), self.leaves):
                if dtype is not None and x.dtype == torch.float32:
                    x = x.to(dtype)
                if lf.fsdp_dim is not None:
                    x = tp.all_gather(x, lf.fsdp_dim, self.mesh.groups["data"])
                out.append(x)
        return out

    def reduce(self, g: torch.Tensor, i: int, *, data_reduced: bool) -> torch.Tensor:
        """This rank's local gradient of leaf ``i`` → the sum over the plane
        in the optimizer state's layout.  ``data_reduced``: a ZeRO-3 leaf's
        gradient already summed over the data axis (the gather region's
        reduce-scatter)."""
        lf, mesh = self.leaves[i], self.mesh
        if lf.fsdp_dim is not None:
            if not data_reduced:
                g = tp.collective("reduce_scatter", g, mesh.groups["data"], dim=lf.fsdp_dim)
            if mesh.shape["pod"] > 1:
                g = tp.collective("all_reduce", g, mesh.groups["pod"])
            return g
        if lf.scatter:
            return tp.collective("reduce_scatter", g, self.plane, dim=lf.z_dim)
        g = tp.collective("all_reduce", g, self.plane)
        return self.view(g, i)

    def view(self, x: torch.Tensor, i: int) -> torch.Tensor:
        """This rank's optimizer shard (a view) of a tensor in the
        parameter's layout."""
        lf = self.leaves[i]
        if lf.z_dim is None:
            return x
        w = x.shape[lf.z_dim] // math.prod(self.mesh.shape[a] for a in lf.z_axes)
        return x.narrow(lf.z_dim, _index(self.mesh, lf.z_axes) * w, w)

    def unshard_(self, p: torch.Tensor, i: int) -> None:
        """After the update of its shard: ``p`` whole over the plane again,
        in place (stages 1–2, and a ZeRO-3 leaf the data axis left whole)."""
        lf = self.leaves[i]
        if lf.z_dim is not None:
            with torch.no_grad():
                p.copy_(tp.all_gather(self.view(p, i), lf.z_dim, group_of(self.mesh, lf.z_axes)))

    def owned(self, i: int) -> bool:
        """Whether this rank counts leaf ``i``'s reduced gradient in a norm:
        one rank of those holding the same values (the plane axes its layout
        does not cut, tp unless cut, and the first stage for a leaf every
        stage holds)."""
        lf, mesh = self.leaves[i], self.mesh
        cut = {a for e in lf.o_spec for a in live_axes(mesh, e)}
        if lf.path[0] != "blocks":
            cut.discard("pp")
        else:
            cut.add("pp")
        return all(mesh.coords[a] == 0 for a in PLANE + ("tp", "pp")
                   if mesh.shape[a] > 1 and a not in cut)


# ---------------------------------------------------------------------------
# ZeRO-3's gather region
# ---------------------------------------------------------------------------

_fsdp = SimpleNamespace(dims={}, group=None)


@contextmanager
def fsdp(dims: Dict[int, int], group):
    """Install ``{id(leaf): dim}`` for :func:`gathered` (process-wide, as
    ``core.sharding``'s rules: autograd's device threads run the recompute)."""
    old = (_fsdp.dims, _fsdp.group)
    _fsdp.dims, _fsdp.group = dims, group
    try:
        yield
    finally:
        _fsdp.dims, _fsdp.group = old


def gathered(tree):
    """``tree`` with every leaf that ZeRO-3 cut gathered whole over the data
    axis (the backward reduce-scatters its gradient); ``tree`` itself when
    nothing is installed."""
    if not _fsdp.dims:
        return tree
    if isinstance(tree, dict):
        return {k: gathered(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [gathered(v) for v in tree]
    d = _fsdp.dims.get(id(tree))
    return tree if d is None else tp.gather_dim(tree, d, _fsdp.group)


def gathered_top(params):
    """The parameters outside the stacked blocks gathered (once a forward):
    a stack's blocks are gathered as each runs."""
    if not _fsdp.dims:
        return params
    return {k: v if k in sharding.STACKS else gathered(v) for k, v in params.items()}
