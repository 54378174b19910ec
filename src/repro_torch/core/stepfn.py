"""Step functions, mirroring the single-device case of ``repro.core.stepfn``
(no mesh, no jit: PyTorch runs eagerly).

``make_train_step`` is the reference's pp=1 step: gradients of ``loss_fn``
(one micro-batch, or ``plan.gas`` of them accumulated token-weighted in the
compute dtype, a non-finite micro-batch masked out), the in-step finite /
z-score skip gate on ``rstat``, gradient compression, the LR schedule with
its re-warm factor, and AdamW with the zero-update on a skipped step.  With
``consensus_replicas = R > 1`` the batch splits into R simulated replicas
that each accumulate and judge their own gradients, and a minority of bad
replicas is masked out (the reference's ``consensus_grads``).  The
train state is updated in place (params, ``m``, ``v`` and ``ef`` leaf by
leaf), the metrics are 0-d tensors on the device under the reference's
names, and the step reads nothing back to the host.

The serving steps (``make_serve_step``, ``make_prefill_cache``, the slot
steps and the paged steps) and the slot and page operations update their
caches and pools in place, where the reference donates them;
``make_prefill`` keeps no cache.

``mesh`` (a ``launch.mesh.RecipeMesh``, as the reference's ``mesh=``) runs
a step over ``torch.distributed``: each step installs the recipe's axis
rules (``core.sharding.axis_rules``) around its body.  Under tp the state
holds this rank's slices (``core.sharding.shard_params``), the int8 scale
is taken over the tp group, and under sequence parallel the replicated
norms' gradients (partial sums over this rank's positions) are all-reduced
before anything reads them.  Over the ``(pod, data)`` plane each rank is a
data-parallel replica: it takes the reference's rows of the global batch,
its gradients are summed over the plane into ZeRO's layout
(``core.zero.Layout``: all-reduced to stage 1, reduce-scattered from stage
2, per micro-batch under ``overlap_zero``), and AdamW updates this rank's
shard; the consensus vote runs over the real replicas.  The gradient norm
sums every distinct piece once over the mesh.  The serving steps gather the
vocabulary-sharded logits before the argmax.  A MoE config routes as the
reference's steps route: under ``moe_groups(dp·pods)`` on a mesh
(``_routing``), the eval step in one group.  :func:`check_plan` says which
plans wait for later parts of the recipe.

At ``pp > 1`` the gradients come from the pipeline (``core.pipeline``: the
stages in this process without a mesh, one stage a rank over the mesh's
``pp`` line), as the reference's step takes them from ``pipeline_loss``:
one global verdict (no vote, ``consensus_replicas`` ignored; the chaos
scale is the product over the micro-batches, applied to the whole
gradient; ``usable`` is a finite norm), the gradients accumulated in the
parameters' dtype (the f32 masters; the gathered bf16 copies under
``gather_params_once``) with each micro-batch's backward seeded with ``1 /
Σ mask`` of the whole batch, and the metrics ``{"xent", "aux"}``.  On a
mesh a rank holds its stage's layers and every leaf outside the blocks;
those leaves' gradients are summed over the ``pp`` line, so every stage
keeps the same bits.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Dict, List, Optional

import torch

from repro_torch.core import pipeline, sharding, tp, zero
from repro_torch.core.recipe import ParallelismConfig, axis_mapping
from repro_torch.core.tree import tree_leaves
from repro_torch.models import api as model_api
from repro_torch.models import moe
from repro_torch.models.config import ModelConfig
from repro_torch.optim import adamw, schedule
from repro_torch.optim.compress import apply_compression, init_error_feedback
from repro_torch.runtime.resilience import ResilienceConfig


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    peak_lr: float = 3e-4
    warmup: int = 200
    total_steps: int = 10000
    adam: adamw.AdamWConfig = dataclasses.field(default_factory=adamw.AdamWConfig)
    compression: Optional[str] = None      # None | bf16 | int8_ef
    resilience: ResilienceConfig = dataclasses.field(default_factory=ResilienceConfig)


PARALLEL = "(ROADMAP Queue 1, item 3: the parallel recipe over torch.distributed)"
MOE_PP = "(ROADMAP Queue 1, item 3.6: MoE under pp)"


def check_plan(plan: ParallelismConfig, mesh=None, cfg: Optional[ModelConfig] = None) -> None:
    """The plan against the mesh.  Without a mesh tp, dp and pods compute as
    one device, as the reference computes them, and pp runs every stage in
    this process.  At pp > 1 ``plan.validate`` holds for ``cfg``'s layers
    (pp·vpp divides them; gas % pp == 0 when vpp > 1).  On a mesh its tp,
    pp, data and pod axes must be the plan's tp, pp, dp and pods, and tp
    must divide ``cfg``'s heads, KV heads and d_ff, and a MoE config's
    ``moe_d_ff`` (the port shards whole heads and whole columns).  A MoE
    config at pp > 1 waits for a later PR (the load-balance loss through
    the schedule)."""
    if plan.pp > 1 and cfg is not None:
        if cfg.family == "moe":
            raise NotImplementedError(f"{cfg.name} at pp={plan.pp}: the MoE family under "
                                      f"pipeline parallelism is not ported yet {MOE_PP}")
        plan.validate(cfg.n_layers)
    if mesh is None:
        return
    for name, axis in (("tp", "tp"), ("pp", "pp"), ("dp", "data"), ("pods", "pod")):
        if mesh.shape[axis] != getattr(plan, name):
            raise ValueError(f"plan {name}={getattr(plan, name)} but the mesh's {axis} axis "
                             f"is {mesh.shape[axis]} ranks wide")
    if cfg is not None:
        for what in ("n_heads", "n_kv_heads", "d_ff") + (
                ("moe_d_ff",) if cfg.family == "moe" else ()):
            if getattr(cfg, what) % plan.tp:
                raise ValueError(f"{cfg.name}: tp={plan.tp} does not divide {what}="
                                 f"{getattr(cfg, what)} (the port shards whole heads and "
                                 "d_ff columns)")


def _rules(plan: ParallelismConfig, mesh, **override):
    """The recipe's axis rules on ``mesh`` (``override`` replacing entries of
    the mapping), or nothing without a mesh."""
    if mesh is None:
        return contextlib.nullcontext()
    return sharding.axis_rules(mesh, dict(axis_mapping(plan), **override))


def _routing(mesh, *, own_rows: bool = False, groups: Optional[int] = None):
    """The MoE routing groups of a step, as the reference's ``moe_groups(dp
    ·pods)``: without a mesh one group (or ``groups``); on a mesh a step
    that holds the whole batch on every rank routes it in dp·pods groups,
    and one that holds this rank's rows (``own_rows``: the training step's
    GAS path) routes them as its one group, its load-balance statistics
    averaged over the ``(pod, data)`` plane."""
    stack = contextlib.ExitStack()
    if own_rows and mesh is not None:
        stack.enter_context(moe.moe_groups(1))
        stack.enter_context(moe.routing_plane(zero.group_of(mesh, zero.PLANE),
                                              mesh.plane_size))
    else:
        stack.enter_context(moe.moe_groups(
            groups if groups is not None else (1 if mesh is None else mesh.plane_size)))
    return stack


def _whole_logits(cfg: ModelConfig, logits: torch.Tensor) -> torch.Tensor:
    """Logits over the whole vocabulary (a sampler's, a caller's)."""
    return tp.gather_vocab(logits) if logits.shape[-1] != cfg.vocab_size else logits


def _micro_bits(bad: torch.Tensor) -> torch.Tensor:
    """(n,) bool → float bitmask of the bad micro-batches (exact in f32 for
    n ≤ 24, else 0)."""
    n = bad.shape[0]
    if n > 24:
        return torch.zeros((), dtype=torch.float32, device=bad.device)
    powers = 2.0 ** torch.arange(n, dtype=torch.float32, device=bad.device)
    return torch.sum(bad.to(torch.float32) * powers)


def init_rstat(device) -> Dict[str, torch.Tensor]:
    """Resilience stats carried in the train state: EMA / variance of the
    accepted gradient norms, the accepted-step count, the re-warm countdown."""
    return {"ema": torch.zeros((), dtype=torch.float32, device=device),
            "var": torch.zeros((), dtype=torch.float32, device=device),
            "n": torch.zeros((), dtype=torch.int32, device=device),
            "rewarm": torch.zeros((), dtype=torch.int32, device=device)}


def init_state(cfg: ModelConfig, plan: ParallelismConfig, gen: torch.Generator,
               train_cfg: TrainConfig = TrainConfig(), mesh=None) -> Dict[str, Any]:
    """fp32 parameters from ``gen`` on its device, AdamW moments, step 0.  On
    a mesh every rank draws the whole model from ``gen`` and keeps its
    shards (the parameters' under tp and ZeRO-3, ``m``, ``v`` and ``ef``
    under ZeRO's optimizer specs), so any mesh starts from the bits of one
    device."""
    check_plan(plan, mesh, cfg)
    params = model_api.init_params(cfg, gen)
    # m, v and ef are laid out like the parameters: on a mesh ZeRO's shards
    hints = zero.family_hints(cfg)
    like = params if mesh is None else sharding.shard_state(params, mesh, plan, hints=hints)
    if mesh is not None:
        params = sharding.shard_params(params, mesh, plan, hints=hints)
    state = {"params": params, "opt": adamw.init_opt_state(like),
             "step": torch.zeros((), dtype=torch.int32, device=gen.device),
             "rstat": init_rstat(gen.device)}
    if train_cfg.compression == "int8_ef":
        state["ef"] = init_error_feedback(like)
    return state


def _scale_(grads: List[torch.Tensor], s: torch.Tensor) -> None:
    """grads *= s (a 0-d f32 tensor), in place: no second copy of the grads."""
    with torch.no_grad():
        for g in grads:
            g.mul_(s)


def make_train_step(cfg: ModelConfig, plan: ParallelismConfig,
                    train_cfg: TrainConfig = TrainConfig(), mesh=None):
    """Returns train_step(state, batch) → (state, metrics); ``batch`` holds
    tensors on the state's device, optionally ``_chaos_grad_scale`` (the
    fault-injection harness' gradient multiplier, per micro-batch).  On a
    mesh every rank takes the whole global batch and keeps the reference's
    rows for its replica: of every micro-batch its slice (the GAS path), or
    its replica's contiguous block (the vote)."""
    check_plan(plan, mesh, cfg)
    rs = train_cfg.resilience
    n_plane = 1 if mesh is None else mesh.plane_size
    if (mesh is not None and plan.pp == 1 and rs.consensus_replicas
            and rs.consensus_replicas != n_plane):
        raise ValueError(
            f"consensus_replicas={rs.consensus_replicas} on a mesh: the replicas are the "
            f"mesh's, so it must be 0 or dp*pods={n_plane}")
    # replica groups that vote on a skip: the mesh's (pod, data) plane, or
    # without a mesh a simulated fleet (``consensus_replicas``); the
    # pipeline keeps one global verdict
    n_rep = (rs.consensus_replicas or n_plane) if (rs.enabled and rs.consensus
                                                   and plan.pp == 1) else 1
    dp = n_plane > 1
    # filled on a mesh's first step (under its rules): the ZeRO layout, per
    # leaf (``tree_leaves`` order) tp-sharded, counted by this rank in the
    # step's norm (``owned``) and in its replica's (``tp_owned``), and under
    # sequence parallel the replicated norm leaves whose gradient is a
    # partial sum
    layout: Dict[str, Any] = {}
    # at pp > 1: the most activations each local stage kept in the last step
    in_flight: List[int] = []

    def leaf_layout(params):
        if mesh is None or layout:
            return
        zl = zero.Layout(cfg, plan, mesh, params)
        layout["zero"] = zl
        layout["sharded"] = [lf.tp_sharded for lf in zl.leaves]
        layout["owned"] = [zl.owned(i) for i in range(len(zl.leaves))]
        layout["tp_owned"] = [lf.tp_sharded or mesh.coords["tp"] == 0 for lf in zl.leaves]
        layout["sp_partial"] = [i for i, lf in enumerate(zl.leaves)
                                if tp.sequence_parallel() and not lf.tp_sharded
                                and any("norm" in str(k) for k in lf.path[:-1])]
        layout["fsdp"] = any(lf.fsdp_dim is not None for lf in zl.leaves)
        # the leaves every stage holds (outside the blocks)
        layout["shared"] = [i for i, lf in enumerate(zl.leaves)
                            if pipeline.split_stages(mesh, plan) and lf.path[0] != "blocks"]

    # squares accumulate in f64 wherever a norm must give the same bits
    # however the gradient is spread: on a mesh, and in the simulated fleet
    # that stands for one; one device's plain step keeps the reference's f32
    wide = torch.float64 if mesh is not None or n_rep > 1 else torch.float32

    def norm(grads):
        """The norm of the step's gradients (on a mesh: reduced, each
        distinct piece counted once over the mesh)."""
        if mesh is None or mesh.size == 1:
            return adamw.global_norm(grads, wide)
        return adamw.mesh_norm(grads, layout["owned"],
                               lambda x: tp.collective("all_reduce", x, None))

    def replica_norm(grads):
        """The norm of one replica's gradient (on a mesh: over its tp
        group, each replicated leaf counted on tp rank 0)."""
        if mesh is None:
            return adamw.global_norm(grads, wide)
        return adamw.mesh_norm(grads, layout["tp_owned"], tp.all_reduce)

    def finite(grads, *, replica: bool = False) -> torch.Tensor:
        """Whether a micro-batch's gradient is finite everywhere it is
        spread: over the mesh, or (``replica``) over this replica's tp
        group (an f32 sum of squares: only its finiteness is read)."""
        s = sum(torch.sum(torch.square(g.float())) for g in grads)
        if mesh is not None and (replica or not dp):
            s = tp.all_reduce(s)
        elif mesh is not None and mesh.size > 1:
            s = tp.collective("all_reduce", s, None)
        return torch.isfinite(s)

    def rows(x: torch.Tensor, n: int) -> torch.Tensor:
        """(B, ...) → (n, B/n, ...) micro-batches; on a dp mesh this rank's
        slice of each (the reference shards the micro-batch dim over
        ``(pod, data)``)."""
        if x.shape[0] % n:
            raise ValueError(f"batch dim {x.shape[0]} not divisible by gas={n}")
        m = x.reshape(n, x.shape[0] // n, *x.shape[1:])
        if not dp:
            return m
        if m.shape[1] % n_plane:
            raise ValueError(f"micro-batch of {m.shape[1]} rows not divisible by the "
                             f"{n_plane} data-parallel replicas")
        w = m.shape[1] // n_plane
        return m[:, mesh.plane_index * w:(mesh.plane_index + 1) * w]

    def fractions(batch, n: int) -> Optional[torch.Tensor]:
        """(n,) this rank's share of each micro-batch's masked-mean loss (its
        live tokens over the micro-batch's), or None off a dp mesh."""
        if not dp:
            return None
        mask = batch.get("loss_mask")
        if mask is None:
            return torch.full((n,), 1.0 / n_plane, dtype=torch.float32,
                              device=batch["labels"].device)
        mine = rows(mask, n).to(torch.float32).reshape(n, -1).sum(1)
        whole = mask.to(torch.float32).reshape(n, -1).sum(1)
        return torch.clamp_min(mine, 1.0) / torch.clamp_min(whole, 1.0)

    def model_params(params):
        """(the tree the model runs on, its leaves that take gradients,
        whether a ZeRO-3 leaf's gradient comes reduced over the data axis).
        ``gather_params_once`` casts the masters to the compute dtype and
        gathers them once a step; so does the vote under ZeRO-3, whose
        verdict needs each replica's whole gradient before any collective.
        Otherwise ZeRO-3's leaves are gathered as the blocks run."""
        once = mesh is not None and (plan.gather_params_once
                                     or (n_rep > 1 and layout["fsdp"]))
        if not once:
            return params, [p.requires_grad_() for _, p in tree_leaves(params)], True
        dtype = cfg.compute_dtype if plan.gather_params_once else None
        flat = [x.requires_grad_() for x in layout["zero"].gather_all(params, dtype)]
        return _with_leaves(params, flat), flat, False

    def reduce(grads, data_reduced: bool):
        """Sum this rank's gradients over the plane into the optimizer
        state's layout, in place in the list: each local gradient is freed
        once it is reduced."""
        if not dp:
            return grads
        for i in range(len(grads)):
            grads[i] = layout["zero"].reduce(grads[i], i, data_reduced=data_reduced)
        return grads

    def all_reduce_plane(x: torch.Tensor) -> torch.Tensor:
        return tp.collective("all_reduce", x, layout["zero"].plane) if dp else x

    def summed(grads, which, reduce_):
        """``grads[i]`` for i in ``which`` replaced by ``reduce_`` of them
        (one collective for all)."""
        if which:
            flat = reduce_(torch.cat([grads[i].reshape(-1) for i in which]))
            for i, g in zip(which, flat.split([grads[i].numel() for i in which])):
                grads[i] = g.view_as(grads[i])
        return grads

    def value_and_grad(leaves, params, batch, frac=None):
        loss, metrics = model_api.loss_fn(cfg, params, batch,
                                          remat_policy=plan.remat_policy)
        if frac is not None:
            loss = loss * frac
            metrics = {k: v * frac for k, v in metrics.items()}
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g for p, g in zip(leaves, grads)]
        # one all-reduce for every norm's partial sums over the positions
        grads = summed(grads, layout.get("sp_partial"), tp.all_reduce)
        return loss.detach(), {k: v.detach() for k, v in metrics.items()}, grads

    def token_weights(batch, n: int) -> torch.Tensor:
        """(n,) live-token counts of the n micro-batches, normalized to mean 1."""
        if batch.get("loss_mask") is not None:
            w = torch.sum(batch["loss_mask"].to(torch.float32).reshape(n, -1), dim=1)
        else:
            w = torch.full((n,), batch["labels"].reshape(n, -1).shape[1],
                           dtype=torch.float32, device=batch["labels"].device)
        return w * (n / torch.clamp_min(torch.sum(w), 1.0))

    def accumulate(leaves, params, micros, wn, scale, *, fracs=None, replica=False,
                   overlap=None):
        """Gradients of the micro-batches ``micros`` accumulated in the
        compute dtype, each scaled by ``scale[i]`` and weighted by ``wn[i]``,
        a non-finite one dropped.  ``overlap``: reduce-scatter each
        micro-batch's gradient into a sharded accumulator (``overlap_zero``;
        the flag holds whether ZeRO-3's leaves come reduced).  Leaf by leaf:
        each autograd gradient is freed once it is added.
        → (acc, losses, metricses, fins (n,))."""
        if overlap is None:
            acc = [torch.zeros(p.shape, dtype=cfg.compute_dtype, device=p.device)
                   for p in leaves]
        else:
            acc = [None] * len(leaves)
        zero_ = torch.zeros((), dtype=cfg.compute_dtype, device=wn.device)
        losses, metricses, fins = [], [], []
        for i, mb in enumerate(micros):
            loss, metrics, g = value_and_grad(leaves, params, mb,
                                              None if fracs is None else fracs[i])
            if scale is not None:
                _scale_(g, scale[i])
            fin = finite(g, replica=replica)
            with torch.no_grad():
                for j in range(len(g)):
                    w = torch.where(fin, (g[j] * wn[i]).to(cfg.compute_dtype), zero_)
                    g[j] = None
                    if overlap is not None:
                        w = layout["zero"].reduce(w, j, data_reduced=overlap)
                    if acc[j] is None:
                        acc[j] = w
                    else:
                        acc[j].add_(w)
            del g
            losses.append(loss)
            metricses.append(metrics)
            fins.append(fin)
        return acc, losses, metricses, torch.stack(fins)

    def grads_and_metrics(params, batch, chaos_scale, rstat):
        """(loss, metrics, grads in leaf order, anomaly aux), honouring
        ``plan.gas``: with gas > 1 the micro-batches' gradients accumulate in
        the compute dtype, each weighted by its live-token count, and a
        non-finite micro-batch is dropped with the weights renormalized.
        With ``n_rep > 1`` the consensus path takes over.  On a dp mesh the
        gradients come back summed over the plane, in ZeRO's layout."""
        tree, leaves, region = model_params(params)
        if plan.pp > 1:
            return pipeline_grads(leaves, tree, region, batch, chaos_scale)
        if n_rep > 1:
            return consensus_grads(leaves, tree, batch, chaos_scale, rstat)
        if plan.gas <= 1:
            frac = fractions(batch, 1)
            mine = {k: rows(x, 1)[0] for k, x in batch.items()}
            loss, metrics, grads = value_and_grad(leaves, tree, mine,
                                                  None if frac is None else frac[0])
            if chaos_scale is not None:
                _scale_(grads, torch.prod(chaos_scale.to(torch.float32)))
            if dp:
                grads = reduce(grads, region)
                vec = all_reduce_plane(torch.stack([loss] + list(metrics.values())))
                loss, metrics = vec[0], dict(zip(metrics, vec[1:]))
            usable = torch.isfinite(norm(grads))
            aux = {"usable": usable,
                   "nonfinite_micros": (~usable).to(torch.int32),
                   "bad_replicas": torch.zeros((), dtype=torch.int32, device=usable.device),
                   "bad_micro_bits": (~usable).to(torch.float32)}
            return loss, metrics, grads, aux
        gas = plan.gas
        micro = {k: rows(x, gas) for k, x in batch.items()}
        device = batch["labels"].device
        wn = token_weights(batch, gas)
        if chaos_scale is not None:
            chaos_scale = torch.broadcast_to(chaos_scale.to(torch.float32), (gas,))
        overlap = region if dp and plan.overlap_zero and plan.zero_stage >= 2 else None
        acc, losses, metricses, fins = accumulate(
            leaves, tree, [{k: x[i] for k, x in micro.items()} for i in range(gas)], wn,
            chaos_scale, fracs=fractions(batch, gas), overlap=overlap)
        if overlap is None:
            acc = reduce(acc, region)
        wn_live = wn * fins.to(torch.float32)
        # exactly gas when every micro-batch is finite (sum(wn) == gas)
        denom = torch.where(torch.all(fins), torch.tensor(float(gas), device=device),
                            torch.clamp_min(torch.sum(wn_live), 1e-6))
        with torch.no_grad():
            for a in acc:
                a.copy_((a.to(torch.float32) / denom).to(a.dtype))

        def wsum(xs):
            x = torch.stack(xs)
            return torch.sum(torch.where(fins, x * wn.to(x.dtype), 0.0))

        sums = [wsum(losses)] + [wsum([m[k] for m in metricses]) for k in metricses[0]]
        if dp:
            sums = list(all_reduce_plane(torch.stack(sums)))
        metrics = {k: s / denom.to(s.dtype) for k, s in zip(metricses[0], sums[1:])}
        usable = torch.any(fins)
        loss = torch.where(usable, sums[0] / denom, torch.tensor(float("nan"), device=device))
        aux = {"usable": usable,
               "nonfinite_micros": torch.sum((~fins).to(torch.int32)),
               "bad_replicas": torch.zeros((), dtype=torch.int32, device=device),
               "bad_micro_bits": _micro_bits(~fins)}
        return loss, metrics, acc, aux

    def pipeline_grads(leaves, params, region, batch, chaos_scale):
        """The gradients of ``Σ nll·mask / Σ mask`` over the whole batch
        through the pipeline's schedule (this rank's rows of each
        micro-batch on a dp mesh), the reference's one global verdict."""
        micro = pipeline.split_micros(batch, plan.gas, mesh)
        denom = pipeline.denominator(batch)
        for p in leaves:
            p.grad = None
        out = pipeline.run_pipeline(cfg, plan, params,
                                    [{k: x[i] for k, x in micro.items()}
                                     for i in range(plan.gas)],
                                    seed=1.0 / denom, mesh=mesh)
        grads = [torch.zeros_like(p) if p.grad is None else p.grad for p in leaves]
        for p in leaves:
            p.grad = None
        grads = summed(grads, layout.get("sp_partial"), tp.all_reduce)
        grads = reduce(grads, region)
        grads = summed(grads, layout.get("shared"),
                       lambda x: tp.collective("all_reduce", x, mesh.groups["pp"]))
        if chaos_scale is not None:
            _scale_(grads, torch.prod(chaos_scale.to(torch.float32)))
        loss = pipeline.reduce_sum(out["sum"], mesh) / denom
        usable = torch.isfinite(norm(grads))
        aux = {"usable": usable,
               "nonfinite_micros": (~usable).to(torch.int32),
               "bad_replicas": torch.zeros((), dtype=torch.int32, device=usable.device),
               "bad_micro_bits": (~usable).to(torch.float32)}
        in_flight[:] = out["in_flight"]
        return loss, {"xent": loss, "aux": torch.zeros_like(loss)}, grads, aux

    def consensus_grads(leaves, params, batch, chaos_scale, rstat):
        """The fleet-voted verdict, the reference's ``consensus_grads``: the
        batch rows split into ``n_rep`` replica shards of ``gas``
        micro-batches; each replica accumulates its own gradients
        (per-micro finite masking inside) and judges them against the shared
        ``rstat`` baseline (every micro non-finite, a non-finite norm, or a
        z-score and multiplicative spike).  A bad replica's contribution is
        masked before the sum over replicas, with the weights renormalized
        over the survivors.

        Without a mesh the replicas run one after another on this device
        (two gradient-sized buffers live: the replica's and the running
        sum).  On a mesh each rank is the replica of its plane index: it
        masks its own gradient before any collective, then one all-reduce
        carries the vote (its bad flag), its live weight, weighted loss and
        metrics and its micro-batches' finite flags, and one more (a
        reduce-scatter from ZeRO-2 on) the gradient sum, so every rank
        reaches the same verdict."""
        R, gas = n_rep, max(plan.gas, 1)
        for k, x in batch.items():
            if x.shape[0] % (R * gas):
                raise ValueError(f"batch dim {x.shape[0]} of {k!r} not divisible by "
                                 f"replicas*gas={R}*{gas}")
        micro = {k: x.reshape(R, gas, x.shape[0] // (R * gas), *x.shape[1:])
                 for k, x in batch.items()}
        device = batch["labels"].device
        wn = token_weights(batch, R * gas).reshape(R, gas)
        if chaos_scale is not None:
            s = chaos_scale.to(torch.float32).reshape(-1)
            if s.numel() == R * gas:
                scale = s.reshape(R, gas)
            elif s.numel() == gas:
                scale = torch.broadcast_to(s[None, :], (R, gas))
            else:
                scale = torch.broadcast_to(torch.prod(s), (R, gas))
        else:
            scale = None
        armed = rstat["n"] >= rs.warmup_steps
        std = torch.sqrt(torch.clamp_min(rstat["var"], 1e-12))
        zero_ = torch.zeros((), dtype=cfg.compute_dtype, device=device)

        total = None
        wlosses, wmets, fins_r, bad_r, live_ws = [], [], [], [], []
        for r in ([mesh.plane_index] if dp else range(R)):
            g_r, ls, mets, fins = accumulate(
                leaves, params, [{k: x[r, i] for k, x in micro.items()} for i in range(gas)],
                wn[r], None if scale is None else scale[r], replica=True)
            # local verdict on this replica's per-micro-average gradient
            live_w = torch.sum(wn[r] * fins.to(torch.float32))
            norm_r = replica_norm(g_r) / torch.clamp_min(live_w, 1e-6)
            z_r = (norm_r - rstat["ema"]) / std
            spike_r = armed & (z_r > rs.zscore_threshold) & (norm_r > rs.spike_factor * rstat["ema"])
            bad = (~torch.any(fins)) | (~torch.isfinite(norm_r)) | spike_r
            with torch.no_grad():
                # mask a bad replica before the reduce: its poison never enters
                if total is None:
                    total = [torch.where(bad, zero_, a) for a in g_r]
                else:
                    for t, a in zip(total, g_r):
                        t.add_(torch.where(bad, zero_, a))
            del g_r

            def wsum(xs):
                x = torch.stack(xs)
                return torch.sum(torch.where(fins, x * wn[r].to(x.dtype), 0.0))

            wlosses.append(wsum(ls))
            wmets.append({k: wsum([m[k] for m in mets]) for k in mets[0]})
            fins_r.append(fins)
            bad_r.append(bad)
            live_ws.append(live_w)
        keys = list(wmets[0])
        if dp:
            # the fleet vote and what it weighs, for every replica at once
            good = ~bad_r[0]
            onehot = torch.zeros((R, gas), dtype=torch.float32, device=device)
            onehot[mesh.plane_index] = (~fins_r[0]).to(torch.float32)
            vec = all_reduce_plane(torch.cat([
                torch.stack([bad_r[0].to(torch.float32),
                             torch.where(good, live_ws[0], 0.0),
                             torch.where(good, wlosses[0], 0.0)]
                            + [torch.where(good, wmets[0][k], 0.0) for k in keys]),
                onehot.reshape(-1)]))
            total = reduce(total, False)
            n_bad = vec[0].to(torch.int32)
            live_w, wloss = vec[1], vec[2]
            sums = dict(zip(keys, vec[3:3 + len(keys)]))
            fins = vec[3 + len(keys):].reshape(R, gas) == 0
        else:
            fins, bad_r, live_ws = torch.stack(fins_r), torch.stack(bad_r), torch.stack(live_ws)
            good_r = ~bad_r
            n_bad = torch.sum(bad_r.to(torch.int32))              # the fleet vote
            live_w = torch.sum(torch.where(good_r, live_ws, 0.0))

            def vote(xs):
                x = torch.stack(xs)
                return torch.sum(torch.where(good_r, x, 0.0))

            wloss = vote(wlosses)
            sums = {k: vote([m[k] for m in wmets]) for k in keys}
        all_clean = torch.all(fins) & (n_bad == 0)
        denom = torch.where(all_clean, torch.tensor(float(R * gas), device=device),
                            torch.clamp_min(live_w, 1e-6))
        with torch.no_grad():
            for t in total:
                t.copy_((t.to(torch.float32) / denom).to(t.dtype))
        metrics = {k: s / denom.to(s.dtype) for k, s in sums.items()}
        usable = live_w > 0
        loss = torch.where(usable, wloss / denom, torch.tensor(float("nan"), device=device))
        aux = {"usable": usable,
               "nonfinite_micros": torch.sum((~fins).to(torch.int32)),
               "bad_replicas": n_bad,
               "bad_micro_bits": _micro_bits(torch.any(~fins, dim=0))}
        return loss, metrics, total, aux

    def train_step(state, batch):
        # the vote's replica holds its micro-batches whole (the reference
        # routes them in dp·pods groups); the GAS path this rank's rows
        with _rules(plan, mesh), _routing(mesh, own_rows=n_rep == 1):
            leaf_layout(state["params"])
            zl = layout.get("zero")
            if zl is None or not layout["fsdp"]:
                return _train_step(state, batch)
            with zero.fsdp(zl.fsdp_ids(state["params"]), mesh.groups["data"]):
                return _train_step(state, batch)

    def _train_step(state, batch):
        batch = dict(batch)
        chaos_scale = batch.pop("_chaos_grad_scale", None)
        rstat = state["rstat"]
        loss, metrics, grads, aux = grads_and_metrics(state["params"], batch, chaos_scale,
                                                      rstat)
        device = loss.device

        # in-step anomaly signals, all on the device
        gnorm = norm(grads)
        finite_ = aux["usable"] & torch.isfinite(gnorm)
        armed = rstat["n"] >= rs.warmup_steps
        std = torch.sqrt(torch.clamp_min(rstat["var"], 1e-12))
        z = torch.where(finite_, (gnorm - rstat["ema"]) / std,
                        torch.tensor(float("inf"), device=device))
        spike = armed & (z > rs.zscore_threshold) & (gnorm > rs.spike_factor * rstat["ema"])
        if rs.enabled:
            skip = (~finite_) | spike
            if n_rep > 1 and not rs.mask_divergent_replicas:
                skip = skip | (aux["bad_replicas"] > 0)   # one bad replica vetoes
        else:
            skip = torch.zeros((), dtype=torch.bool, device=device)

        # EMA / variance track accepted steps only; the re-warm counts down
        first = rstat["n"] == 0
        d = torch.tensor(rs.ema_decay, dtype=torch.float32, device=device)
        ema_new = torch.where(first, gnorm, d * rstat["ema"] + (1 - d) * gnorm)
        var_new = torch.where(first, rstat["var"],
                              d * rstat["var"] + (1 - d) * torch.square(gnorm - rstat["ema"]))
        accept = (~skip) & finite_
        new_rstat = {
            "ema": torch.where(accept, ema_new, rstat["ema"]),
            "var": torch.where(accept, var_new, rstat["var"]),
            "n": rstat["n"] + accept.to(torch.int32),
            "rewarm": torch.clamp_min(rstat["rewarm"] - 1, 0),
        }

        # skip → zero-update: params, m, v, Adam's step and ef stay as they
        # were (applied leaf by leaf, in place); the step count advances.
        # Under ZeRO the update runs on this rank's shard, which is then
        # gathered back over the plane
        keep = skip if rs.enabled else None
        sharded = layout.get("sharded")
        zl = layout.get("zero")
        plane = zl.plane if dp and plan.zero_stage >= 1 else None
        line = mesh.groups["pp"] if pipeline.split_stages(mesh, plan) else None
        grads = apply_compression(grads, train_cfg.compression, state.get("ef"), skip=keep,
                                  sharded=sharded, plane=plane, line=line)
        lr = schedule.lr_schedule(state["step"], peak=train_cfg.peak_lr,
                                  warmup=train_cfg.warmup, total=train_cfg.total_steps)
        lr = lr * schedule.rewarm_factor(rstat["rewarm"], rs.rewarm_steps)
        leaves = [p for _, p in tree_leaves(state["params"])]
        views = [zl.view(p, i) for i, p in enumerate(leaves)] if dp else None
        # without compression AdamW clips by the norm the gate just took
        clip = gnorm if train_cfg.compression in (None, "none") else norm(grads)
        om = adamw.adamw_update(grads, state["opt"], state["params"], lr, clip, train_cfg.adam,
                                skip=keep, views=views)
        del grads
        if dp:
            for i, p in enumerate(leaves):
                zl.unshard_(p, i)
        new_state = dict(state, step=state["step"] + 1, rstat=new_rstat)
        metrics = dict(metrics, loss=loss, **om)
        metrics.update(
            grad_norm=gnorm,
            all_finite=finite_.to(torch.float32),
            skipped=skip.to(torch.float32),
            gnorm_z=torch.where(armed & finite_, z, 0.0),
            nonfinite_micros=aux["nonfinite_micros"].to(torch.float32),
            bad_replicas=aux["bad_replicas"].to(torch.float32),
            n_replicas=torch.full((), float(n_rep), dtype=torch.float32, device=device),
            bad_micro_bits=aux["bad_micro_bits"],
            lr=lr)
        return new_state, metrics

    train_step.in_flight = in_flight
    return train_step


def _with_leaves(tree, leaves):
    """``tree`` with its leaves (in ``tree_leaves`` order) replaced."""
    new = dict(zip((p for p, _ in tree_leaves(tree)), leaves))

    def go(t, path):
        if isinstance(t, dict):
            return {k: go(v, path + (k,)) for k, v in t.items()}
        if isinstance(t, list):
            return [go(v, path + (i,)) for i, v in enumerate(t)]
        return new[path]

    return go(tree, ())


def make_eval_step(cfg: ModelConfig, plan: ParallelismConfig, mesh=None):
    """(params, batch) → the loss metrics {"xent", "aux"}, without gradients;
    on a mesh every rank evaluates the whole batch (ZeRO-3's leaves
    gathered as the blocks run).  At pp > 1 the batch goes through the
    pipeline's forwards (``core.pipeline.pipeline_loss``; on a mesh each
    replica its rows, the loss summed over the mesh).  A MoE batch routes
    as one group on a mesh too: the reference's eval step sets no groups."""
    check_plan(plan, mesh, cfg)
    layout: Dict[str, Any] = {}

    def eval_step(params, batch):
        with torch.no_grad(), _rules(plan, mesh), _routing(None):
            ids = {}
            if mesh is not None and plan.zero_stage >= 3 and mesh.shape["data"] > 1:
                if "zero" not in layout:
                    layout["zero"] = zero.Layout(cfg, plan, mesh, params)
                ids = layout["zero"].fsdp_ids(params)
            with zero.fsdp(ids, None if mesh is None else mesh.groups["data"]):
                if plan.pp > 1:
                    _, metrics = pipeline.pipeline_loss(cfg, params, batch, plan, mesh=mesh)
                else:
                    _, metrics = model_api.loss_fn(cfg, params, batch, remat_policy="none")
        return metrics

    return eval_step


def make_serve_step(cfg: ModelConfig, plan: Optional[ParallelismConfig] = None, mesh=None, *,
                    per_row: bool = False):
    """One greedy decode step: (params, token (B,), t, caches) →
    (next token (B,) int32, caches); ``t`` is an int, or a (B,) int32
    tensor of one position per row.  ``torch.argmax`` takes the first
    maximum, as ``jnp.argmax`` does; on a mesh over the gathered logits.
    One position a row: no sequence parallel.  A MoE config routes the
    batch as one group (dp·pods on a mesh), or with ``per_row`` each row
    alone."""
    plan = plan or ParallelismConfig()
    check_plan(plan, mesh, cfg)
    no_pipeline_mesh("the serve step", mesh)

    def serve_step(params, token, t, caches):
        with _rules(plan, mesh, seq=None), _routing(
                mesh, groups=token.shape[0] if per_row else None):
            logits, caches = model_api.decode_step(cfg, params, token, t, caches)
            return _whole_logits(cfg, logits).argmax(dim=-1).to(torch.int32), caches

    return serve_step


def make_prefill(cfg: ModelConfig, plan: Optional[ParallelismConfig] = None, mesh=None, *,
                 last_only: bool = False):
    """Teacher-forced full-sequence forward, the prefill phase without a
    cache: (params, batch) → fp32 logits (B, S, V), or (B, 1, V) for the
    last position alone when ``last_only`` (the hidden states are sliced
    before the unembed, so the (S, V) product is never formed).  No remat
    (``model_api.forward`` runs with ``remat_policy="none"``) and no
    autograd graph, as the reference's ``make_prefill``."""
    plan = plan or ParallelismConfig()
    check_plan(plan, mesh, cfg)
    no_pipeline_mesh("the prefill", mesh)

    def prefill(params, batch):
        with torch.no_grad(), _rules(plan, mesh), _routing(mesh):
            return _whole_logits(cfg, model_api.forward(cfg, params, batch,
                                                        last_only=last_only))

    return prefill


def make_prefill_cache(cfg: ModelConfig, plan: Optional[ParallelismConfig] = None, mesh=None):
    """Prompt ingestion: (params, batch, caches) → (last-position logits
    (B, V), caches), the caches filled with the prompt's K/V."""
    plan = plan or ParallelismConfig()
    check_plan(plan, mesh, cfg)
    no_pipeline_mesh("the prefill", mesh)

    # a family without the parallel prefill ingests the prompt through the
    # decode scan: one position a row, no sequence parallel
    scan = {} if model_api.family_of(cfg).supports_padded_prefill(cfg) else {"seq": None}

    def prefill_cache(params, batch, caches):
        with _rules(plan, mesh, **scan), _routing(mesh):
            logits, caches = model_api.prefill_cache(cfg, params, batch, caches)
            return _whole_logits(cfg, logits), caches

    return prefill_cache


def one_device(what: str, mesh) -> None:
    """Raise for ``what`` on a mesh: it runs on one device only."""
    if mesh is not None:
        raise NotImplementedError(f"{what} on a mesh: the continuous-batching steps under "
                                  f"tensor parallelism are not ported yet {PARALLEL}")


def no_pipeline_mesh(what: str, mesh) -> None:
    """Serving runs on one device or over tp: a mesh with a ``pp`` axis
    goes to :func:`one_device`'s refusal."""
    if mesh is not None and mesh.shape["pp"] > 1:
        one_device(f"{what} over pipeline stages", mesh)


def make_slot_serve_step(cfg: ModelConfig, plan: Optional[ParallelismConfig] = None,
                         mesh=None):
    """Continuous-batching decode: like ``make_serve_step``, but every slot
    (batch row) carries its own position ``ts[i]``, so requests at
    different depths decode together in one full-width step.  The reference
    vmaps its single-request decode over the slots; the port's decode takes
    the (B,) int32 positions as they are (one launch per layer, no loop over
    slots, no host sync), so this is ``make_serve_step`` called with a
    tensor for ``t``: (params, tokens (B,), ts (B,), caches) → (next (B,)
    int32, caches).  As in the vmap, a MoE config routes each slot's token
    alone (one token a group: capacity 1, nothing dropped).  One device
    only."""
    one_device("the slot step", mesh)
    return make_serve_step(cfg, per_row=True)


def make_paged_serve_step(cfg: ModelConfig, plan: Optional[ParallelismConfig] = None,
                          mesh=None):
    """Continuous-batching decode against the block-paged KV pool: every row
    has its own position and its own page-table row.  (params, tokens (B,),
    ts (B,), pool, page_tables (B, n_max)) → (next (B,) int32, pool).  One
    device only."""
    one_device("the paged step", mesh)

    def paged_serve_step(params, tokens, ts, pool, page_tables):
        logits, pool = model_api.paged_decode_step(cfg, params, tokens, ts, pool,
                                                   page_tables)
        return logits.argmax(dim=-1).to(torch.int32), pool

    return paged_serve_step


def make_paged_prefill(cfg: ModelConfig, plan: Optional[ParallelismConfig] = None,
                       mesh=None):
    """Admission prefill into the paged pool: right-padded prompt suffixes
    with per-row ``hist_lens`` and ``lengths``.  (params, batch, pool,
    page_tables) → (logits (B, V), pool).  One device only."""
    one_device("the paged prefill", mesh)

    def paged_prefill(params, batch, pool, page_tables):
        return model_api.paged_prefill(cfg, params, batch, pool, page_tables)

    return paged_prefill


def pool_copy_page(cfg: ModelConfig, pool, src: int, dst: int):
    """The copy half of copy-on-write: physical page ``src`` over ``dst`` in
    every layer's k and v, in place."""
    for _, x in tree_leaves(pool):
        x[dst] = x[src]
    return pool


def _slot_leaves(cfg: ModelConfig, caches):
    """[(path, leaf, slot axis)] of batched decode caches."""
    axes = dict(tree_leaves(model_api.cache_slot_axes(cfg, caches)))
    return [(path, x, axes[path]) for path, x in tree_leaves(caches)]


def cache_zero_slot(cfg: ModelConfig, caches, i: int):
    """Reset request slot ``i`` of batched decode caches in place: ``pos``
    leaves to -1 (no valid entries), everything else to zeros.  The
    scheduler runs this on retire, so a freed slot never leaks stale K/V
    into the next admission."""
    for path, x, a in _slot_leaves(cfg, caches):
        x.narrow(a, i, 1).fill_(-1 if path[-1] == "pos" else 0)
    return caches


def _map_slots(fn, caches, axes):
    """``fn(leaf, slot axis)`` over batched decode caches, keeping their
    structure."""
    if isinstance(caches, dict):
        return {k: _map_slots(fn, v, axes[k]) for k, v in caches.items()}
    if isinstance(caches, list):
        return [_map_slots(fn, v, a) for v, a in zip(caches, axes)]
    return fn(caches, axes)


def cache_take_slot(cfg: ModelConfig, caches, i: int):
    """Request slot ``i`` of batched decode caches, as slot-width-1 views
    (``cache_insert_slot`` copies them)."""
    return _map_slots(lambda x, a: x.narrow(a, i, 1), caches,
                      model_api.cache_slot_axes(cfg, caches))


def cache_slice_slots(cfg: ModelConfig, caches, start: int, width: int):
    """A copy of ``width`` consecutive request slots of batched decode
    caches (the scheduler derives its admission-prefill templates from one
    full-width template, which the prefill, updating in place, must not
    touch)."""
    return _map_slots(lambda x, a: x.narrow(a, start, width).clone(), caches,
                      model_api.cache_slot_axes(cfg, caches))


def cache_insert_slot(cfg: ModelConfig, caches, slot_caches, i: int):
    """Write slot-width-1 ``slot_caches`` (a fresh prefill) into slot ``i``
    of batched caches, in place."""
    src = dict(tree_leaves(slot_caches))
    for path, x, a in _slot_leaves(cfg, caches):
        x.narrow(a, i, 1).copy_(src[path])
    return caches
