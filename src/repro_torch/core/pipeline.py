"""Pipeline parallelism over ``torch.distributed``: the (interleaved) 1F1B
schedule, the counterpart of ``repro.core.pipeline``.

**Layout.**  The reference stacks the ``(L, ...)`` block leaves to ``(PP,
L/PP, ...)`` for ``vpp = 1`` and ``(VPP, PP, L/(PP·VPP), ...)`` for ``vpp >
1``: chunk ``c = v·PP + p`` (layers ``[c·Lc, (c+1)·Lc)``) sits at ``[v,
p]``.  :func:`stack_for_pipeline` nests the port's per-layer block list the
same way (``[p][l]`` or ``[v][p][l]``, the same dicts, no copies) and
:func:`unstack_from_pipeline` inverts it.  The train state keeps the flat
per-layer list: without a mesh all L layers, which the stages index chunk
by chunk; on a mesh the layers of this rank's stage, in the order of its
chunks (:func:`stage_layers`).  That flat list is the canonical state that
checkpoints and ``to_inference`` read.

**The schedule.**  :class:`Schedule` gives every stage its list of actions,
``("F" | "B", micro-batch m, chunk row v)``: Megatron-LM's 1F1B for ``vpp
= 1`` (stage p runs ``pp - p - 1`` warm-up forwards, then one forward and
one backward in turn, then the cool-down backwards) and its interleaved
1F1B for ``vpp > 1`` (Narayanan et al., arXiv 2104.04473: micro-batches in
rounds of PP, a micro-batch looping the stage ring VPP times, chunk c → c+1
always one hop to the next stage, wrapping PP-1 → 0).  Two transports run
the same lists:

* in-process (no mesh): every stage runs in this process; a stage runs its
  next action as soon as its input is in the mailbox, so the stages advance
  in an order the schedule allows, and an order that could deadlock raises;
* P2P over the mesh's ``pp`` line: each rank runs its own stage, receives
  the activation (forward) or its gradient (backward) from its neighbour,
  runs the chunk and sends on (``core.tp.send``/``recv``, counted).  A send
  never blocks: it is posted before the receive that follows it and waited
  when the pass ends, so no two stages can both wait on a send.

Each stage keeps, for every micro-batch in flight, the chunk's output and
its received input (a leaf that requires grad), runs
``torch.autograd.backward(output, received gradient)`` and sends
``input.grad`` back.  The last chunk banks ``Σ nll·mask`` of its
micro-batch, and its backward is seeded with ``1 / Σ mask`` of the whole
batch, so the gradients are those of the reference's loss, ``Σ nll / Σ
mask`` over every micro-batch, accumulated in the parameters' own dtype
(the masters' f32).  Remat ``"stage"`` recomputes a chunk from its kept
input in the backward, with per-layer checkpoints inside (the reference's
nested ``jax.checkpoint``).

**Per-layer windows.**  A hybrid stack's attention window differs by layer
(``transformer.layer_windows``): a chunk's block runs with the window of
its layer's index in the whole stack, whatever stage holds it.

**The MoE family.**  The pipeline runs the stacked ``blocks`` (``n_layers
- first_k_dense`` of them: a chunk is that count over pp·vpp); stage 0
runs the unstacked ``pre_blocks`` after the embedding, as the reference's
``embed_mb``, dropping their load-balance loss (zero for a dense block).
Every stage holds the ``pre_blocks``, as every leaf outside ``blocks``.  A
chunk returns its blocks' load-balance loss beside its output; the stage
banks it per micro-batch, and the chunk's backward is seeded with
``AUX_LOSS_COEF / gas`` for it (over the data-parallel replicas, each
replica's share), so the routers of every stage take the gradient of the
reference's ``xent + AUX_LOSS_COEF · Σ aux / gas``.
"""

from __future__ import annotations

import contextlib
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch
from torch.utils.checkpoint import checkpoint, set_checkpoint_early_stop

from repro_torch.core import tp, zero
from repro_torch.core.recipe import ParallelismConfig

Action = Tuple[str, int, int]


# ---------------------------------------------------------------------------
# layout
# ---------------------------------------------------------------------------

def chunk_layers(n_layers: int, plan: ParallelismConfig, c: int) -> range:
    """The layers of chunk ``c``."""
    lc = n_layers // (plan.pp * plan.vpp)
    return range(c * lc, (c + 1) * lc)


def stage_layers(n_layers: int, plan: ParallelismConfig, stage: int) -> List[int]:
    """The layers stage ``stage`` holds, in the order of its chunks
    ``c = v·PP + stage``."""
    return [l for v in range(plan.vpp) for l in chunk_layers(n_layers, plan, v * plan.pp + stage)]


def stack_for_pipeline(blocks: Sequence, pp: int, vpp: int = 1) -> List:
    """The per-layer block list → ``[p][l]`` (vpp = 1) or ``[v][p][l]``
    (vpp > 1): chunk ``c = v·PP + p`` at ``[v][p]``, as the reference's
    row-major reshape places it."""
    n = len(blocks)
    if n % (pp * vpp):
        raise ValueError(f"layers {n} not divisible by pp*vpp={pp}*{vpp}")
    lc = n // (pp * vpp)
    chunks = [list(blocks[c * lc:(c + 1) * lc]) for c in range(pp * vpp)]
    if vpp == 1:
        return chunks
    return [chunks[v * pp:(v + 1) * pp] for v in range(vpp)]


def unstack_from_pipeline(stacked: Sequence, vpp: int = 1) -> List:
    """The inverse of :func:`stack_for_pipeline`."""
    rows = [c for row in stacked for c in row] if vpp > 1 else list(stacked)
    return [b for chunk in rows for b in chunk]


def stack_shape(n_layers: int, plan: ParallelismConfig) -> Tuple[int, ...]:
    """The leading axes of the reference's block leaves under ``plan``."""
    if plan.pp == 1:
        return (n_layers,)
    if plan.vpp == 1:
        return (plan.pp, n_layers // plan.pp)
    return (plan.vpp, plan.pp, n_layers // (plan.pp * plan.vpp))


def stack_axes(plan: ParallelismConfig) -> Tuple[str, ...]:
    """Their logical names (the reference's ``stacked_axes_fn`` prefixes)."""
    if plan.pp == 1:
        return ("layers",)
    return ("stage", "layers") if plan.vpp == 1 else ("chunks", "stage", "layers")


def gather_stages(blocks: List, plan: ParallelismConfig, mesh) -> List:
    """This rank's stage's blocks (each leaf whole over tp and data) → all
    L layers, on every rank of its ``pp`` line: an all-gather over the line
    per layer of a stage and leaf."""
    from repro_torch.core.tree import tree_map
    n = len(blocks) * plan.pp
    rows = [stage_layers(n, plan, p) for p in range(plan.pp)]
    out: List = [None] * n
    for i, layer in enumerate(blocks):
        got = tree_map(lambda x: tp.collective("all_gather", x[None], mesh.groups["pp"]), layer)
        for p in range(plan.pp):
            out[rows[p][i]] = tree_map(lambda x, p=p: x[p], got)
    return out


def split_stages(mesh, plan: ParallelismConfig) -> bool:
    """Whether a rank of ``mesh`` holds one stage's layers only."""
    return mesh is not None and plan.pp > 1


def holds_layer(layer: int, n_layers: int, plan: ParallelismConfig, mesh) -> bool:
    """Whether this rank of ``mesh`` holds block ``layer`` of ``n_layers``."""
    return not split_stages(mesh, plan) or layer in stage_layers(n_layers, plan,
                                                                 mesh.coords["pp"])


def keep_stage(tree: Dict[str, Any], plan: ParallelismConfig, mesh) -> Dict[str, Any]:
    """A whole tree (params, ``m``, ``v`` or ``ef``) → the one this rank of
    ``mesh`` holds: its stage's blocks in chunk order, every other leaf
    (held by every stage)."""
    if not split_stages(mesh, plan):
        return tree
    layers = stage_layers(len(tree["blocks"]), plan, mesh.coords["pp"])
    return dict(tree, blocks=[tree["blocks"][l] for l in layers])


# ---------------------------------------------------------------------------
# the schedule
# ---------------------------------------------------------------------------

class Schedule:
    """The (interleaved) 1F1B order of every stage's forwards and
    backwards: ``gas·vpp`` of each on every stage.

    Virtual micro-batch ``k`` runs micro-batch ``m = (k // (PP·VPP))·PP +
    k % PP``; its forward runs chunk row ``v = (k % (PP·VPP)) // PP`` and its
    backward row ``VPP - 1 - v`` (Megatron-LM's ``get_model_chunk_id``).
    Stage p runs :meth:`warmup` forwards, then a forward and a backward in
    turn, then the remaining backwards."""

    def __init__(self, pp: int, vpp: int, gas: int):
        if vpp > 1 and gas % pp:
            raise ValueError(f"interleaved schedule needs gas % pp == 0 (gas={gas}, pp={pp})")
        self.pp, self.vpp, self.gas = pp, vpp, gas
        self.total = gas * vpp
        self.last = pp * vpp - 1

    def chunk(self, stage: int, v: int) -> int:
        return v * self.pp + stage

    def _mv(self, k: int, forward: bool) -> Tuple[int, int]:
        group, i = divmod(k, self.pp * self.vpp)
        v = i // self.pp
        return group * self.pp + i % self.pp, (v if forward else self.vpp - 1 - v)

    def warmup(self, stage: int) -> int:
        """Forwards stage ``stage`` runs before its first backward."""
        if self.vpp == 1:
            return min(self.pp - stage - 1, self.total)
        if self.gas == self.pp:
            return self.total
        return min(self.total, (self.pp - stage - 1) * 2 + (self.vpp - 1) * self.pp)

    def actions(self, stage: int, *, forward_only: bool = False) -> List[Action]:
        fwd = [("F",) + self._mv(k, True) for k in range(self.total)]
        if forward_only:
            return fwd
        bwd = [("B",) + self._mv(k, False) for k in range(self.total)]
        w = self.warmup(stage)
        steady = [a for i in range(self.total - w) for a in (fwd[w + i], bwd[i])]
        return fwd[:w] + steady + bwd[self.total - w:]

    def in_flight(self, stage: int) -> int:
        """The most (micro-batch, chunk) activations stage ``stage`` keeps
        for the backward at once, counted along its actions."""
        held = top = 0
        for kind, _, _ in self.actions(stage):
            held += 1 if kind == "F" else -1
            top = max(top, held)
        return top

    def in_flight_formula(self, stage: int) -> int:
        """:meth:`in_flight` in closed form: ``min(gas, pp - stage)`` for
        1F1B; for the interleaved schedule ``min(gas·vpp, warmup + 1)``,
        warmup ``2(pp - stage - 1) + (vpp - 1)·pp`` (all ``gas·vpp`` when
        ``gas == pp``)."""
        if self.vpp == 1:
            return min(self.gas, self.pp - stage)
        return min(self.total, self.warmup(stage) + 1)


# ---------------------------------------------------------------------------
# one stage's work
# ---------------------------------------------------------------------------

class _Stage:
    """The forwards and backwards of one stage: ``embed(m)`` (chunk 0's
    input), ``chunk(c, m, x)``, ``head(m, x)`` (the last chunk's ``Σ
    nll·mask``); what each forward keeps for its backward."""

    def __init__(self, sched: Schedule, stage: int, fns, seed: Optional[torch.Tensor],
                 aux_seed: float = 0.0):
        self.sched, self.stage, self.fns, self.seed = sched, stage, fns, seed
        self.aux_seed = aux_seed
        self.kept: Dict[Tuple[int, int], Tuple[Optional[torch.Tensor], torch.Tensor,
                                               Optional[torch.Tensor]]] = {}
        self.sums: Dict[int, torch.Tensor] = {}
        # the load-balance loss of each (micro-batch, chunk row) run here
        self.auxes: Dict[Tuple[int, int], torch.Tensor] = {}
        self.peak = 0

    def forward(self, m: int, v: int, x: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
        c = self.sched.chunk(self.stage, v)
        train = self.seed is not None
        if c == 0:
            x = self.fns.embed(m)
        elif train:
            x = x.detach().requires_grad_()
        y, aux = self.fns.chunk(c, m, x)
        if aux is not None:
            self.auxes[(m, v)] = aux.detach()
        if c == self.sched.last:
            y = self.fns.head(m, y)
            self.sums[m] = y.detach()
        if train:
            self.kept[(m, v)] = (x if c else None, y, aux)
            self.peak = max(self.peak, len(self.kept))
        return None if c == self.sched.last else y.detach()

    def backward(self, m: int, v: int, dy: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
        x, y, aux = self.kept.pop((m, v))
        outs = [y]
        seeds = [self.seed.to(y.dtype) if dy is None else dy]
        if aux is not None and aux.requires_grad:
            outs.append(aux)
            seeds.append(torch.full((), self.aux_seed, dtype=aux.dtype, device=aux.device))
        torch.autograd.backward(outs, seeds)
        return None if x is None else x.grad

    def aux_sum(self, device) -> torch.Tensor:
        """Σ of the load-balance losses banked here, in (micro-batch, chunk
        row) order."""
        total = torch.zeros((), dtype=torch.float32, device=device)
        for key in sorted(self.auxes):
            total = total + self.auxes[key]
        return total


def _key(kind: str, m: int, c: int, sched: Schedule) -> int:
    """A message's tag: unique in a pass."""
    return ((0 if kind == "F" else 1) * (sched.last + 1) + c) * sched.gas + m


def _run_in_process(sched: Schedule, stages: List[_Stage], forward_only: bool) -> None:
    acts = [sched.actions(p, forward_only=forward_only) for p in range(sched.pp)]
    idx = [0] * sched.pp
    box: Dict[Tuple[str, int, int], torch.Tensor] = {}
    while any(i < len(a) for i, a in zip(idx, acts)):
        moved = False
        for p, st in enumerate(stages):
            while idx[p] < len(acts[p]):
                kind, m, v = acts[p][idx[p]]
                c = sched.chunk(p, v)
                need = c > 0 if kind == "F" else c < sched.last
                if need and (kind, m, c) not in box:
                    break
                got = box.pop((kind, m, c)) if need else None
                if kind == "F":
                    out = st.forward(m, v, got)
                    if out is not None:
                        box[("F", m, c + 1)] = out
                else:
                    out = st.backward(m, v, got)
                    if out is not None:
                        box[("B", m, c - 1)] = out
                idx[p] += 1
                moved = True
        if not moved:
            raise RuntimeError(f"pipeline schedule deadlocked at actions {idx}")


def _run_p2p(sched: Schedule, st: _Stage, forward_only: bool, mesh,
             act: Tuple[Tuple[int, ...], torch.dtype, torch.device]) -> None:
    p, pp = st.stage, sched.pp
    group = mesh.groups["pp"]
    peer = {d: int(mesh.devices[mesh.coords["pod"], mesh.coords["data"], (p + d) % pp,
                                mesh.coords["tp"]]) for d in (-1, 1)}
    shape, dtype, device = act
    try:
        for kind, m, v in sched.actions(p, forward_only=forward_only):
            c = sched.chunk(p, v)
            if kind == "F":
                x = (tp.recv(shape, dtype, device, peer[-1], group, _key("F", m, c, sched))
                     if c > 0 else None)
                out = st.forward(m, v, x)
                if out is not None:
                    tp.send(out, peer[1], group, _key("F", m, c + 1, sched))
            else:
                dy = (tp.recv(shape, dtype, device, peer[1], group, _key("B", m, c, sched))
                      if c < sched.last else None)
                out = st.backward(m, v, dy)
                if out is not None:
                    tp.send(out, peer[-1], group, _key("B", m, c - 1, sched))
    finally:
        tp.wait_sends()


# ---------------------------------------------------------------------------
# the model's pieces on a stage
# ---------------------------------------------------------------------------

def _stage_fns(cfg, plan: ParallelismConfig, params, micros: List[Dict[str, torch.Tensor]],
               mesh):
    """embed / chunk / head over ``params`` (this rank's) for the
    micro-batches; ``chunk`` → (x, the chunk's load-balance loss or None)."""
    from types import SimpleNamespace
    from repro_torch.models import transformer as T
    grad = torch.is_grad_enabled()
    inner = T.block_fn("full" if plan.remat_policy == "stage" else plan.remat_policy)
    local = split_stages(mesh, plan)
    kind, n_stacked, pre = T.layer_plan(cfg)
    lc = n_stacked // (plan.pp * plan.vpp)
    blocks = params["blocks"]
    windows = T.layer_windows(cfg)
    pos = [T.positions(mb["tokens"]) for mb in micros]

    def layers_of(c: int):
        i = (c // plan.pp) * lc if local else c * lc
        return blocks[i:i + lc]

    def run(c: int, m: int, x: torch.Tensor):
        seg = micros[m].get("segment_ids")
        aux = None
        # chunk c holds the stacked layers [c·lc, (c+1)·lc): each block
        # attends with the window of its layer in the whole stack (the
        # reference's windows.reshape(vpp, pp, -1) row of the chunk)
        for j, bp in enumerate(layers_of(c)):
            x, a = inner(cfg, bp, x, pos[m], window=windows[c * lc + j], segment_ids=seg,
                         kind=kind)
            if a is not None:
                aux = a if aux is None else aux + a
        return x, aux

    def chunk(c: int, m: int, x: torch.Tensor):
        if plan.remat_policy == "stage" and grad:
            # the chunk recomputed whole from its input in the backward, its
            # per-layer checkpoints recomputing again inside (the reference's
            # nested remat)
            with set_checkpoint_early_stop(False):
                return checkpoint(run, c, m, x, use_reentrant=False)
        return run(c, m, x)

    def embed(m: int) -> torch.Tensor:
        x = T.embed_stream(cfg, {"embed": zero.gathered(params["embed"])}, micros[m])
        for bp, (_, k) in zip(params.get("pre_blocks", []), pre):
            x, _ = inner(cfg, bp, x, pos[m], window=cfg.swa_window,
                         segment_ids=micros[m].get("segment_ids"), kind=k)
        return x

    def head(m: int, x: torch.Tensor) -> torch.Tensor:
        top = zero.gathered({k: v for k, v in params.items()
                             if k not in ("blocks", "pre_blocks")})
        return T.nll_sum(cfg, top, x, micros[m]["labels"], micros[m].get("loss_mask"))

    return SimpleNamespace(embed=embed, chunk=chunk, head=head)


def run_pipeline(cfg, plan: ParallelismConfig, params, micros: List[Dict[str, torch.Tensor]],
                 *, seed: Optional[torch.Tensor] = None, aux_seed: float = 0.0,
                 mesh=None) -> Dict[str, Any]:
    """Every micro-batch of ``micros`` through the schedule: forwards only
    when ``seed`` is None, else 1F1B with each backward seeded with ``seed``
    (``1 / Σ mask`` of the whole batch) and the chunk's load-balance loss
    with ``aux_seed``, the gradients accumulating in the leaves' ``.grad``.
    → {"sum": Σ over the micro-batches of ``Σ nll·mask`` in micro-batch
    order (0 on a rank without the last chunk), "aux": Σ of the local
    stages' load-balance losses (0 for a dense stack), "in_flight": [the
    most activations each local stage kept]}."""
    sched = Schedule(plan.pp, plan.vpp, plan.gas)
    forward_only = seed is None
    ctx = torch.no_grad() if forward_only else contextlib.nullcontext()
    device = micros[0]["tokens"].device
    with ctx:
        fns = _stage_fns(cfg, plan, params, micros, mesh)
        if split_stages(mesh, plan):
            stages = [_Stage(sched, mesh.coords["pp"], fns, seed, aux_seed)]
            mbs, s = micros[0]["tokens"].shape
            shape = (mbs, s // tp.size() if tp.sequence_parallel() else s, cfg.d_model)
            _run_p2p(sched, stages[0], forward_only, mesh, (shape, cfg.compute_dtype, device))
        else:
            stages = [_Stage(sched, p, fns, seed, aux_seed) for p in range(plan.pp)]
            _run_in_process(sched, stages, forward_only)
    total = torch.zeros((), dtype=torch.float32, device=device)
    aux = torch.zeros((), dtype=torch.float32, device=device)
    for st in stages:
        for m in sorted(st.sums):
            total = total + st.sums[m]
        aux = aux + st.aux_sum(device)
    return {"sum": total, "aux": aux, "in_flight": [st.peak for st in stages]}


def denominator(batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    """The loss's denominator over the whole batch: ``Σ mask``, or the
    token count, at least 1."""
    mask = batch.get("loss_mask")
    if mask is None:
        return torch.tensor(float(batch["labels"].numel()), dtype=torch.float32,
                            device=batch["labels"].device)
    return torch.clamp_min(torch.sum(mask.to(torch.float32)), 1.0)


def check_layers(cfg, plan: ParallelismConfig) -> None:
    """``plan.validate`` on ``cfg``'s layers, and pp·vpp dividing the
    stacked ``blocks`` too (the reference asserts that in its
    ``stack_for_pipeline``): a stack that no pp·vpp > 1 divides raises."""
    from repro_torch.models import transformer as T
    plan.validate(cfg.n_layers)
    _, n_stacked, pre = T.layer_plan(cfg)
    if n_stacked % (plan.pp * plan.vpp):
        raise ValueError(f"{cfg.name}: the stacked blocks, {n_stacked} layers after "
                         f"{len(pre)} unstacked pre_blocks, are not divisible by "
                         f"pp*vpp={plan.pp}*{plan.vpp}")


def pipeline_loss(cfg, params, batch: Dict[str, torch.Tensor], plan: ParallelismConfig, *,
                  mesh=None) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The reference's ``pipeline_loss``: the batch through the pipeline's
    forwards, ``xent = Σ nll·mask / Σ mask`` over every micro-batch and
    ``aux = Σ load-balance loss / gas`` over every micro-batch and stage.
    → (``xent + AUX_LOSS_COEF·aux``, {"xent", "aux"}).  On a mesh every
    rank takes its rows, the sums over the mesh; a MoE batch is taken whole
    on every rank of the ``(pod, data)`` plane, since the reference's eval
    routes each micro-batch as one group."""
    from repro_torch.models import transformer as T
    check_layers(cfg, plan)
    whole = mesh is not None and cfg.family == "moe"
    rows = None if whole else mesh
    micros = [{k: x[i] for k, x in split_micros(batch, plan.gas, rows).items()}
              for i in range(plan.gas)]
    out = run_pipeline(cfg, plan, params, micros, mesh=mesh)
    xent = reduce_sum(out["sum"], mesh, plane=not whole) / denominator(batch)
    aux = reduce_aux(cfg, out["aux"], mesh) / plan.gas
    return xent + T.AUX_LOSS_COEF * aux, {"xent": xent, "aux": aux}


def reduce_aux(cfg, aux: torch.Tensor, mesh) -> torch.Tensor:
    """The stages' load-balance losses summed over the ``pp`` line (every
    replica of the ``(pod, data)`` plane holds the same); a dense stack's is
    0 on every stage and takes no collective."""
    return reduce_sum(aux, mesh, plane=False) if cfg.family == "moe" else aux


def split_micros(batch: Dict[str, torch.Tensor], gas: int, mesh=None
                 ) -> Dict[str, torch.Tensor]:
    """(B, ...) → (gas, B/gas, ...); on a mesh this rank's rows of each
    micro-batch (the reference shards the micro-batch dim over ``(pod,
    data)``)."""
    out = {}
    n = 1 if mesh is None else mesh.plane_size
    i = 0 if mesh is None else mesh.plane_index
    for k, x in batch.items():
        if x.shape[0] % gas:
            raise ValueError(f"batch dim {x.shape[0]} not divisible by gas={gas}")
        m = x.reshape(gas, x.shape[0] // gas, *x.shape[1:])
        if m.shape[1] % n:
            raise ValueError(f"micro-batch of {m.shape[1]} rows not divisible by the "
                             f"{n} data-parallel replicas")
        w = m.shape[1] // n
        out[k] = m[:, i * w:(i + 1) * w]
    return out


def reduce_sum(x: torch.Tensor, mesh, *, plane: bool = True) -> torch.Tensor:
    """``x`` summed over the ``pp`` line (one stage holds the loss) and,
    with ``plane``, the ``(pod, data)`` plane (each replica its rows)."""
    if mesh is None:
        return x
    for g in (mesh.groups["pp"], mesh.groups[("pod", "data")] if plane else None):
        if g is not None:
            x = tp.collective("all_reduce", x, g)
    return x
