"""Logical-axis sharding: the recipe's placement rules in one place,
mirroring ``repro.core.sharding``.

The rules (``PARAM_RULES``, ``spec_for_path``, ``AxisRules`` and
``sanitize``) are the reference's, line for line, over a
``launch.mesh.RecipeMesh`` where the reference reads a ``jax.sharding.Mesh``;
a resolved spec is a plain tuple where the reference builds a
``PartitionSpec``.  The port's parameter paths are ``blocks/<i>/...`` (one
dict per layer, no stacked axis), so ``stacked_axes`` is 0 for every leaf.

GSPMD places the reference's arrays from these specs.  The port places them
itself: :func:`shard_params` keeps, of every leaf, this rank's block along
the dims the resolved and sanitized spec shards (the ``tp`` axis, and under
ZeRO-3 the data axis), :func:`shard_state` does the same for an optimizer
state under ZeRO's specs (``core.zero``), and :func:`gather_params` is the
first's inverse (``checkpoint.elastic.host_snapshot`` gathers a whole
state to the host leaf by leaf; at pp > 1 a rank keeps its stage's blocks
only, ``core.pipeline.keep_stage``, and :func:`gather_params` gathers the
stages' blocks over the ``pp`` line too).  The model code asks the rules that
:func:`axis_rules` installs for the tp group (``core.tp``) and does the
collectives GSPMD would insert.  Everything no-ops when no rules are
installed: the single-device paths do not change by a bit.
"""

from __future__ import annotations

import re
from contextlib import contextmanager
from types import SimpleNamespace
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.core.recipe import ParallelismConfig, axis_mapping
from repro_torch.core.tree import tree_leaves

# the installed rules, for the whole process: the reference keeps them per
# thread, but autograd runs a CUDA backward (and the blocks' recompute under
# remat) on its own device threads, which must see the rules the step
# installed
_state = SimpleNamespace(rules=None)


def installed() -> Optional["AxisRules"]:
    """The rules :func:`axis_rules` installed, or None."""
    return _state.rules


class AxisRules:
    """Maps logical axis names → physical mesh axis names (or None).

    Mesh-resilient: axes absent from the mesh are dropped, and the recipe's
    "tp" resolves to the raw production mesh's "model" axis when the logical
    (pod, data, pp, tp) factorization has not been applied."""

    ALIASES = {"tp": "model"}

    def __init__(self, mesh, mapping: Dict[str, Any]):
        self.mesh = mesh
        self.mapping = dict(mapping)

    def _present(self, ax):
        """Filter/alias one mesh-axis name (or tuple) against the mesh."""
        if ax is None:
            return None
        if isinstance(ax, (tuple, list)):
            out = tuple(a for a in (self._present(x) for x in ax) if a is not None)
            return out if out else None
        if ax in self.mesh.axis_names:
            return ax
        alias = self.ALIASES.get(ax)
        if alias and alias in self.mesh.axis_names:
            return alias
        return None

    def resolve(self, logical: Tuple[Optional[str], ...]) -> Tuple:
        phys = []
        used = set()
        for name in logical:
            if name is None:
                phys.append(None)
                continue
            ax = self._present(self.mapping.get(name))
            if ax is None:
                phys.append(None)
            elif isinstance(ax, (tuple, list)):
                ax = tuple(a for a in ax if a not in used)
                used.update(ax)
                phys.append(ax if len(ax) > 1 else (ax[0] if ax else None))
            else:
                if ax in used:
                    phys.append(None)
                else:
                    used.add(ax)
                    phys.append(ax)
        return tuple(phys)


@contextmanager
def axis_rules(mesh, mapping: Dict[str, Any]):
    old = _state.rules
    _state.rules = AxisRules(mesh, mapping)
    try:
        yield _state.rules
    finally:
        _state.rules = old


def constrain(x: torch.Tensor, *names: Optional[str]) -> torch.Tensor:
    """Lay a tensor that every tp rank holds whole out as ``names`` resolve:
    along a dim that resolves to the tp axis keep this rank's slice (the
    backward all-gathers it).  A no-op without rules or where no dim
    resolves to tp.  GSPMD's constraint also turns partial sums into the
    named layout; here the layers' row-parallel exits do that
    (``core.tp.reduce_from_tp``, ``reduce_scatter_to_seq``), so this is
    called on whole tensors only."""
    from repro_torch.core import tp
    r = installed()
    if r is None or tp.size() == 1:
        return x
    for dim, ax in enumerate(r.resolve(tuple(names))):
        if ax == tp.axis_name(r.mesh):
            return tp.split(x, dim)
    return x


# ---------------------------------------------------------------------------
# parameter partition rules (path-regex → logical axes)
# ---------------------------------------------------------------------------

# Order matters: first match wins.  Axis names:
#   "tp"    — tensor-parallel (fast domain; paper's TP ≤ node rule)
#   "fsdp"  — ZeRO-3 parameter sharding axis (the data axis)
#   "stage" — pipeline stage axis (leading axis of stacked block params)
#   "layers"— scanned layer axis (never sharded)
PARAM_RULES = [
    (r"\bembed\b$", ("tp", "embed")),                       # (V, d) vocab-sharded
    (r"\blm_head\b$", ("tp", "embed")),
    (r"\bpos_embed\b$", (None, "embed")),
    (r"\bwq\b$|\bwk\b$|\bwv\b$", ("embed", "tp")),
    (r"\bwo\b$", ("tp", "embed")),
    (r"\bbq\b$|\bbk\b$|\bbv\b$", ("tp",)),
    (r"\bw_gate\b$|\bw_up\b$|\bw_in\b$", ("embed", "tp")),  # MLP in-proj: d_ff sharded
    (r"\bw_out\b$", ("tp", "embed")),                       # MLP out-proj
    (r"\bb_in\b$", ("tp",)),
    (r"\bb_out\b$", ("embed",)),
    (r"\bin_proj\b$", ("embed", "tp")),                     # SSM / xLSTM
    (r"\bbc_proj\b$", ("embed", None)),
    (r"\bout_proj\b$", ("tp", "embed")),
    (r"\bconv\b$", (None, "tp")),
    (r"\b(A_log|D|dt_bias|b_igate|b_fgate)\b$", (None,)),
    (r"\bw_igate\b$|\bw_fgate\b$", ("embed", None)),
    (r"\b(rz|ri|rf|ro)\b$", (None, None, None)),            # sLSTM recurrent (block-diag)
    (r"\b(wz|wi|wf|wo_s)\b$", ("embed", "tp")),
    (r"\b(bz|bi|bf|bo)\b$", (None,)),
    (r"\bscale\b$|\bbias\b$", (None,)),                     # norms
]


def spec_for_path(path: str, shape: Tuple[int, ...], *, stacked_axes: int = 0,
                  extra_rules: Tuple = ()) -> Tuple[Optional[str], ...]:
    """Logical axes for a parameter; ``stacked_axes`` leading axes are
    (layers) / (stage, layers) / (chunks, stage, layers) from scan, pipeline,
    and interleaved virtual-stage stacking respectively (0 for every leaf
    of the port's per-layer blocks).  ``extra_rules`` are matched before
    ``PARAM_RULES``."""
    prefix: Tuple[Optional[str], ...] = ()
    if stacked_axes == 1:
        prefix = ("layers",)
    elif stacked_axes == 2:
        prefix = ("stage", "layers")
    elif stacked_axes == 3:
        prefix = ("chunks", "stage", "layers")
    for pat, axes in tuple(extra_rules) + tuple(PARAM_RULES):
        if re.search(pat, path):
            axes = tuple(axes)
            if len(axes) + len(prefix) < len(shape):  # e.g. (E,d,ff) expert leaves
                axes = (None,) * (len(shape) - len(prefix) - len(axes)) + axes
            return prefix + axes[: len(shape) - len(prefix)]
    return prefix + (None,) * (len(shape) - len(prefix))


def sanitize(spec: Tuple, shape: Tuple[int, ...], mesh) -> Tuple:
    """Drop partitioning on dims the mesh axes do not divide (odd vocab sizes,
    head counts like 14/25/40 vs a 16-wide tp axis, ...)."""
    parts = list(spec) + [None] * (len(shape) - len(spec))
    fixed = []
    for dim, p in zip(shape, parts):
        if p is None:
            fixed.append(None)
            continue
        axes = p if isinstance(p, tuple) else (p,)
        ways = 1
        for a in axes:
            ways *= mesh.shape[a]
        fixed.append(p if cuts(dim, ways) else None)
    return tuple(fixed)


def cuts(width: int, ways: int) -> bool:
    """:func:`sanitize`'s rule: whether ``ways`` shards cut a dim ``width``
    long (it stays whole otherwise)."""
    return width % ways == 0 and width >= ways


# ---------------------------------------------------------------------------
# the port's placement: this rank's slices of the parameters
# ---------------------------------------------------------------------------

def _map_with_path(fn, tree, path=()):
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map_with_path(fn, v, path + (i,)) for i, v in enumerate(tree)]
    return fn(path, tree)


# leaves whose tp-cut dim is two halves side by side (x and the gate z of
# the SSD's and the mLSTM's ``in_proj``): a rank holds its heads' columns of
# each half, where a contiguous cut would give it whole halves
HALVES = re.compile(r"\bin_proj\b$")
# the reference's stacked layer lists (per-layer lists in the port)
STACKS = ("blocks", "enc_blocks", "dec_blocks")


def _halves(path: Tuple, spec: Tuple, mesh) -> Optional[int]:
    """The dim of a halves leaf that tp cuts, or None."""
    if not HALVES.search("/".join(map(str, path))):
        return None
    from repro_torch.core import zero
    for d, e in enumerate(spec):
        if "tp" in zero.live_axes(mesh, e):
            return d
    return None


def _swap_halves(x: torch.Tensor, d: int, n: int, inverse: bool = False) -> torch.Tensor:
    """Along dim ``d``: the reference's [x | z], each of n blocks, ↔ the
    order [x_0 z_0 | x_1 z_1 | ...] whose contiguous cut gives rank r its
    blocks of both halves."""
    w = x.shape[d] // (2 * n)
    lead, tail = x.shape[:d], x.shape[d + 1:]
    y = x.reshape(lead + ((n, 2) if inverse else (2, n)) + (w,) + tail)
    return y.transpose(d, d + 1).reshape(x.shape)


def local_leaf(path: Tuple, x: torch.Tensor, spec: Tuple, mesh) -> torch.Tensor:
    """This rank's block of leaf ``path`` laid out as ``spec``
    (``zero.local``; a halves leaf takes its heads' columns of each half)."""
    from repro_torch.core import zero
    d = _halves(path, spec, mesh)
    if d is not None:
        x = _swap_halves(x, d, mesh.shape["tp"])
    return zero.local(x, spec, mesh)


def gather_leaf(path: Tuple, x: torch.Tensor, spec: Tuple, mesh) -> torch.Tensor:
    """The inverse of :func:`local_leaf`."""
    from repro_torch.core import zero
    x = zero.gather(x, spec, mesh)
    d = _halves(path, spec, mesh)
    return x if d is None else _swap_halves(x, d, mesh.shape["tp"], inverse=True)


def shard_params(params, mesh, plan: ParallelismConfig, device=None, *, prefix: Tuple = (),
                 hints: Tuple = ()):
    """Whole parameters (every rank holds the same) → this rank's: each leaf
    keeps this rank's block along the dims its resolved and sanitized spec
    shards (tp, and under ZeRO-3 the data axis on its ``embed`` dim), as a
    contiguous copy; a leaf whose dims the mesh does not divide stays
    whole.  ``device``: where the blocks go (the leaves' own by default).
    ``prefix``: ``params`` is the part of a tree at that path (one block,
    say: ``("blocks", 3)``), which no pipeline stage splits.  ``hints``:
    the model family's placement rules (``zero.family_hints``)."""
    from repro_torch.core import pipeline, zero
    specs = zero.param_shardings([(prefix + p, tuple(x.shape))
                                  for p, x in tree_leaves(params)], mesh, plan, hints=hints)
    tree = params if prefix else pipeline.keep_stage(params, plan, mesh)
    return _map_with_path(
        lambda path, x: _own(local_leaf(prefix + path, x, specs[prefix + path], mesh), x,
                             device), tree)


def _own(part: torch.Tensor, whole: torch.Tensor, device=None) -> torch.Tensor:
    if device is not None:
        return part.to(device, memory_format=torch.contiguous_format, copy=True)
    return whole if part is whole else part.clone(memory_format=torch.contiguous_format)


def shard_state(tree, mesh, plan: ParallelismConfig, device=None, *, hints: Tuple = ()):
    """A whole optimizer-state tree (``m``, ``v`` or ``ef``, shaped like the
    parameters) → this rank's shards under ``zero.opt_shardings``, on
    ``device`` and with ``hints`` as for :func:`shard_params`."""
    from repro_torch.core import pipeline, zero
    shapes = [(p, tuple(x.shape)) for p, x in tree_leaves(tree)]
    specs = zero.opt_shardings(zero.param_shardings(shapes, mesh, plan, hints=hints), shapes,
                               mesh, plan, {k: len(tree[k]) for k in STACKS if k in tree})
    return _map_with_path(
        lambda path, x: _own(local_leaf(path, x, specs[path], mesh), x, device),
        pipeline.keep_stage(tree, plan, mesh))


def whole_shapes(local, mesh, plan: ParallelismConfig, cfg):
    """[(leaf path, the shape the leaf has whole)] for this rank's parameter
    leaves of model ``cfg``: a dim its rule cuts is ways times as long
    whole, unless :func:`sanitize` left it whole, which its rule
    (:func:`cuts`) decides on the dim's whole width.  Under tp that width is
    the config's for the three dims tp may leave whole: a vocabulary
    table's ``vocab_size``, a MoE block's expert count (its replicated
    router's columns) and an MLP's hidden width (the family's
    ``mlp_width``); ``core.stepfn.check_plan`` has tp divide every head
    count, so every other tp dim is cut.  Over the data axis (ZeRO-3's
    ``embed`` dim) the width is ``d_model``.  The family's placement hints
    (``zero.family_hints``) apply."""
    from repro_torch.core import zero
    from repro_torch.models import api
    hints = zero.family_hints(cfg)
    rules = AxisRules(mesh, axis_mapping(plan))
    tp_axis = rules._present("tp")
    n, dp = mesh.shape[tp_axis], mesh.shape["data"]
    mlp_width = api.family_of(cfg).mlp_width(cfg)
    leaves = tree_leaves(local)
    routers = {path[:-1]: x.shape[-1] for path, x in leaves if path[-1] == "router"}
    out = []
    for path, x in leaves:
        shape = tuple(x.shape)
        logical = spec_for_path("/".join(map(str, path)), shape, extra_rules=hints)
        spec = rules.resolve(logical)
        for d, ax in enumerate(spec):
            if ax == tp_axis and n > 1:
                if path[-1] in ("embed", "lm_head"):
                    whole = not cuts(cfg.vocab_size, n)
                elif logical[d] == "expert":
                    whole = shape[d] == routers.get(path[:-1])
                else:
                    whole = path[-2:-1] == ("mlp",) and not cuts(mlp_width, n)
            elif ax == "data" and dp > 1:
                whole = shape[d] == cfg.d_model and not cuts(cfg.d_model, dp)
            else:
                continue
            if not whole:
                shape = shape[:d] + (shape[d] * (n if ax == tp_axis else dp),) + shape[d + 1:]
        out.append((path, shape))
    return out


def gather_params(local, mesh, plan: ParallelismConfig, cfg):
    """The inverse of :func:`shard_params`: this rank's leaves of model
    ``cfg`` → the whole parameters in the reference layout, on every rank
    (an all-gather per sharded dim of a leaf, over the tp group or the data
    line, and at pp > 1 one over the ``pp`` line per layer of a stage and
    leaf)."""
    from repro_torch.core import pipeline, zero
    hints = zero.family_hints(cfg)
    specs = zero.param_shardings(whole_shapes(local, mesh, plan, cfg), mesh, plan, hints=hints)
    with torch.no_grad():
        whole = _map_with_path(lambda path, x: gather_leaf(path, x.detach(), specs[path], mesh),
                               local)
        if pipeline.split_stages(mesh, plan):
            whole["blocks"] = pipeline.gather_stages(whole["blocks"], plan, mesh)
        return whole

