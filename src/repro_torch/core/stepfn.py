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
a step tensor-parallel: each step installs the recipe's axis rules
(``core.sharding.axis_rules``) around its body, the state holds this
rank's slices (``core.sharding.shard_params``), the gradient norm and the
int8 scale are taken over the tp group, and under sequence parallel the
replicated norms' gradients (partial sums over this rank's positions) are
all-reduced before anything reads them.  The serving steps gather the
vocabulary-sharded logits before the argmax.  :func:`check_plan` says
which plans wait for later parts of the recipe.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Dict, List, Optional

import torch

from repro_torch.core import sharding, tp
from repro_torch.core.recipe import ParallelismConfig, axis_mapping
from repro_torch.core.tree import tree_leaves
from repro_torch.models import api as model_api
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


def check_plan(plan: ParallelismConfig, mesh=None, cfg: Optional[ModelConfig] = None) -> None:
    """The plan against the mesh.  Without a mesh tp, dp and pods compute as
    one device, as the reference computes them; pp needs the pipeline.  On
    a mesh tp runs over it, and what needs ZeRO's sharded states or real
    replicas raises; tp must divide ``cfg``'s heads, KV heads and d_ff (the
    port shards whole heads)."""
    if plan.pp > 1:
        raise NotImplementedError(f"pp={plan.pp}: the pipeline is not ported yet {PARALLEL}")
    if mesh is None:
        return
    waiting = {"dp": plan.dp > 1, "pods": plan.pods > 1,
               "zero_stage": plan.zero_stage >= 2, "overlap_zero": plan.overlap_zero,
               "gather_params_once": plan.gather_params_once}
    for name, on in waiting.items():
        if on:
            raise NotImplementedError(
                f"{name}={getattr(plan, name)} on a mesh: data parallelism and ZeRO's "
                f"sharded states are not ported yet {PARALLEL}")
    if mesh.shape["tp"] != plan.tp:
        raise ValueError(f"plan tp={plan.tp} but the mesh's tp axis is {mesh.shape['tp']} "
                         "ranks wide")
    if cfg is not None:
        for what in ("n_heads", "n_kv_heads", "d_ff"):
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
    slices, so tp = k starts from the bits of tp = 1."""
    check_plan(plan, mesh, cfg)
    params = model_api.init_params(cfg, gen)
    if mesh is not None:
        params = sharding.shard_params(params, mesh, plan)
    state = {"params": params, "opt": adamw.init_opt_state(params),
             "step": torch.zeros((), dtype=torch.int32, device=gen.device),
             "rstat": init_rstat(gen.device)}
    if train_cfg.compression == "int8_ef":
        state["ef"] = init_error_feedback(params)
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
    mesh every tp rank takes the whole batch."""
    check_plan(plan, mesh, cfg)
    rs = train_cfg.resilience
    if mesh is not None and (rs.consensus_replicas or 1) > 1:
        raise NotImplementedError(
            f"consensus_replicas={rs.consensus_replicas} on a mesh: the consensus vote "
            f"over real replicas is not ported yet {PARALLEL}")
    # replica groups that vote on a skip: without a mesh only a simulated
    # fleet (``consensus_replicas``) has more than one
    n_rep = (rs.consensus_replicas or 1) if rs.enabled and rs.consensus else 1
    # per leaf (in ``tree_leaves`` order): tp-sharded; under sequence
    # parallel, a replicated norm leaf whose gradient is a partial sum
    layout: Dict[str, list] = {}

    def leaf_layout(params):
        """Fill ``layout`` on a mesh's first step (under its rules)."""
        if mesh is None or layout:
            return
        paths = [p for p, _ in tree_leaves(params)]
        dims = sharding.tp_dims(sharding.whole_shapes(params, mesh, plan, cfg.vocab_size),
                                mesh, plan)
        layout["sharded"] = [dims[p] is not None for p in paths]
        layout["sp_partial"] = [i for i, p in enumerate(paths)
                                if tp.sequence_parallel() and dims[p] is None
                                and any("norm" in str(k) for k in p[:-1])]

    def norm(grads):
        return adamw.global_norm(grads, layout.get("sharded"))

    def value_and_grad(leaves, params, batch):
        loss, metrics = model_api.loss_fn(cfg, params, batch,
                                          remat_policy=plan.remat_policy)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g for p, g in zip(leaves, grads)]
        sp_partial = layout.get("sp_partial")
        if sp_partial:
            # one all-reduce for every norm's partial sums over the positions
            flat = tp.all_reduce(torch.cat([grads[i].reshape(-1) for i in sp_partial]))
            for i, g in zip(sp_partial, flat.split([grads[i].numel() for i in sp_partial])):
                grads[i] = g.view_as(grads[i])
        return loss.detach(), {k: v.detach() for k, v in metrics.items()}, grads

    def token_weights(batch, n: int) -> torch.Tensor:
        """(n,) live-token counts of the n micro-batches, normalized to mean 1."""
        if batch.get("loss_mask") is not None:
            w = torch.sum(batch["loss_mask"].to(torch.float32).reshape(n, -1), dim=1)
        else:
            w = torch.full((n,), batch["labels"].reshape(n, -1).shape[1],
                           dtype=torch.float32, device=batch["labels"].device)
        return w * (n / torch.clamp_min(torch.sum(w), 1.0))

    def accumulate(leaves, params, micros, wn, scale):
        """Gradients of the micro-batches ``micros`` accumulated in the
        compute dtype, each scaled by ``scale[i]`` and weighted by ``wn[i]``,
        a non-finite one dropped.  → (acc, losses, metricses, fins (n,))."""
        acc = [torch.zeros(p.shape, dtype=cfg.compute_dtype, device=p.device) for p in leaves]
        zero = torch.zeros((), dtype=cfg.compute_dtype, device=wn.device)
        losses, metricses, fins = [], [], []
        for i, mb in enumerate(micros):
            loss, metrics, g = value_and_grad(leaves, params, mb)
            if scale is not None:
                _scale_(g, scale[i])
            fin = torch.isfinite(norm(g))
            with torch.no_grad():
                for a, gi in zip(acc, g):
                    a.add_(torch.where(fin, (gi * wn[i]).to(a.dtype), zero))
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
        With ``n_rep > 1`` the consensus path takes over."""
        leaves = [p.requires_grad_() for _, p in tree_leaves(params)]
        if n_rep > 1:
            return consensus_grads(leaves, params, batch, chaos_scale, rstat)
        if plan.gas <= 1:
            loss, metrics, grads = value_and_grad(leaves, params, batch)
            if chaos_scale is not None:
                _scale_(grads, torch.prod(chaos_scale.to(torch.float32)))
            usable = torch.isfinite(norm(grads))
            aux = {"usable": usable,
                   "nonfinite_micros": (~usable).to(torch.int32),
                   "bad_replicas": torch.zeros((), dtype=torch.int32, device=usable.device),
                   "bad_micro_bits": (~usable).to(torch.float32)}
            return loss, metrics, grads, aux
        gas = plan.gas
        for k, x in batch.items():
            if x.shape[0] % gas:
                raise ValueError(f"batch dim {x.shape[0]} of {k!r} not divisible by gas={gas}")
        micro = {k: x.reshape(gas, x.shape[0] // gas, *x.shape[1:]) for k, x in batch.items()}
        device = batch["labels"].device
        wn = token_weights(batch, gas)
        if chaos_scale is not None:
            chaos_scale = torch.broadcast_to(chaos_scale.to(torch.float32), (gas,))
        acc, losses, metricses, fins = accumulate(
            leaves, params, [{k: x[i] for k, x in micro.items()} for i in range(gas)], wn,
            chaos_scale)
        wn_live = wn * fins.to(torch.float32)
        # exactly gas when every micro-batch is finite (sum(wn) == gas)
        denom = torch.where(torch.all(fins), torch.tensor(float(gas), device=device),
                            torch.clamp_min(torch.sum(wn_live), 1e-6))
        with torch.no_grad():
            for a in acc:
                a.copy_((a.to(torch.float32) / denom).to(a.dtype))

        def wmean(xs):
            x = torch.stack(xs)
            return torch.sum(torch.where(fins, x * wn.to(x.dtype), 0.0)) / denom.to(x.dtype)

        metrics = {k: wmean([m[k] for m in metricses]) for k in metricses[0]}
        usable = torch.any(fins)
        loss = torch.where(usable, wmean(losses), torch.tensor(float("nan"), device=device))
        aux = {"usable": usable,
               "nonfinite_micros": torch.sum((~fins).to(torch.int32)),
               "bad_replicas": torch.zeros((), dtype=torch.int32, device=device),
               "bad_micro_bits": _micro_bits(~fins)}
        return loss, metrics, acc, aux

    def consensus_grads(leaves, params, batch, chaos_scale, rstat):
        """The fleet-voted verdict, the reference's ``consensus_grads`` on
        one device: the batch rows split into ``n_rep`` replica shards of
        ``gas`` micro-batches; each replica accumulates its own gradients
        (per-micro finite masking inside) and judges them against the shared
        ``rstat`` baseline (every micro non-finite, a non-finite norm, or a
        z-score and multiplicative spike).  A bad replica's contribution is
        masked before the sum over replicas (the reference's cross-replica
        reduce), with the weights renormalized over the survivors.  Replicas
        run one after another; two gradient-sized buffers are live (the
        replica's and the running sum)."""
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

        total = [torch.zeros(p.shape, dtype=cfg.compute_dtype, device=p.device) for p in leaves]
        wlosses, wmets, fins_r, bad_r, live_ws = [], [], [], [], []
        for r in range(R):
            g_r, ls, mets, fins = accumulate(
                leaves, params, [{k: x[r, i] for k, x in micro.items()} for i in range(gas)],
                wn[r], None if scale is None else scale[r])
            # local verdict on this replica's per-micro-average gradient
            live_w = torch.sum(wn[r] * fins.to(torch.float32))
            norm_r = adamw.global_norm(g_r) / torch.clamp_min(live_w, 1e-6)
            z_r = (norm_r - rstat["ema"]) / std
            spike_r = armed & (z_r > rs.zscore_threshold) & (norm_r > rs.spike_factor * rstat["ema"])
            bad = (~torch.any(fins)) | (~torch.isfinite(norm_r)) | spike_r
            with torch.no_grad():
                # mask a bad replica before the reduce: its poison never enters
                for t, a in zip(total, g_r):
                    t.add_(torch.where(bad, torch.zeros((), dtype=a.dtype, device=device), a))
            del g_r

            def wsum(xs):
                x = torch.stack(xs)
                return torch.sum(torch.where(fins, x * wn[r].to(x.dtype), 0.0))

            wlosses.append(wsum(ls))
            wmets.append({k: wsum([m[k] for m in mets]) for k in mets[0]})
            fins_r.append(fins)
            bad_r.append(bad)
            live_ws.append(live_w)
        fins, bad_r, live_ws = torch.stack(fins_r), torch.stack(bad_r), torch.stack(live_ws)
        good_r = ~bad_r
        n_bad = torch.sum(bad_r.to(torch.int32))              # the fleet vote
        all_clean = torch.all(fins) & (n_bad == 0)
        live_w = torch.sum(torch.where(good_r, live_ws, 0.0))
        denom = torch.where(all_clean, torch.tensor(float(R * gas), device=device),
                            torch.clamp_min(live_w, 1e-6))
        with torch.no_grad():
            for t in total:
                t.copy_((t.to(torch.float32) / denom).to(t.dtype))

        def vote(xs):
            x = torch.stack(xs)
            return torch.sum(torch.where(good_r, x, 0.0)) / denom.to(x.dtype)

        metrics = {k: vote([m[k] for m in wmets]) for k in wmets[0]}
        usable = live_w > 0
        loss = torch.where(usable, vote(wlosses), torch.tensor(float("nan"), device=device))
        aux = {"usable": usable,
               "nonfinite_micros": torch.sum((~fins).to(torch.int32)),
               "bad_replicas": n_bad,
               "bad_micro_bits": _micro_bits(torch.any(~fins, dim=0))}
        return loss, metrics, total, aux

    def train_step(state, batch):
        with _rules(plan, mesh):
            return _train_step(state, batch)

    def _train_step(state, batch):
        batch = dict(batch)
        chaos_scale = batch.pop("_chaos_grad_scale", None)
        rstat = state["rstat"]
        leaf_layout(state["params"])
        loss, metrics, grads, aux = grads_and_metrics(state["params"], batch, chaos_scale,
                                                      rstat)
        device = loss.device

        # in-step anomaly signals, all on the device
        gnorm = norm(grads)
        finite = aux["usable"] & torch.isfinite(gnorm)
        armed = rstat["n"] >= rs.warmup_steps
        std = torch.sqrt(torch.clamp_min(rstat["var"], 1e-12))
        z = torch.where(finite, (gnorm - rstat["ema"]) / std,
                        torch.tensor(float("inf"), device=device))
        spike = armed & (z > rs.zscore_threshold) & (gnorm > rs.spike_factor * rstat["ema"])
        if rs.enabled:
            skip = (~finite) | spike
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
        accept = (~skip) & finite
        new_rstat = {
            "ema": torch.where(accept, ema_new, rstat["ema"]),
            "var": torch.where(accept, var_new, rstat["var"]),
            "n": rstat["n"] + accept.to(torch.int32),
            "rewarm": torch.clamp_min(rstat["rewarm"] - 1, 0),
        }

        # skip → zero-update: params, m, v, Adam's step and ef stay as they
        # were (applied leaf by leaf, in place); the step count advances
        keep = skip if rs.enabled else None
        sharded = layout.get("sharded")
        grads = apply_compression(grads, train_cfg.compression, state.get("ef"), skip=keep,
                                  sharded=sharded)
        lr = schedule.lr_schedule(state["step"], peak=train_cfg.peak_lr,
                                  warmup=train_cfg.warmup, total=train_cfg.total_steps)
        lr = lr * schedule.rewarm_factor(rstat["rewarm"], rs.rewarm_steps)
        om = adamw.adamw_update(grads, state["opt"], state["params"], lr, train_cfg.adam,
                                skip=keep, sharded=sharded)
        del grads
        new_state = dict(state, step=state["step"] + 1, rstat=new_rstat)
        metrics = dict(metrics, loss=loss, **om)
        metrics.update(
            grad_norm=gnorm,
            all_finite=finite.to(torch.float32),
            skipped=skip.to(torch.float32),
            gnorm_z=torch.where(armed & finite, z, 0.0),
            nonfinite_micros=aux["nonfinite_micros"].to(torch.float32),
            bad_replicas=aux["bad_replicas"].to(torch.float32),
            n_replicas=torch.full((), float(n_rep), dtype=torch.float32, device=device),
            bad_micro_bits=aux["bad_micro_bits"],
            lr=lr)
        return new_state, metrics

    return train_step


def make_eval_step(cfg: ModelConfig, plan: ParallelismConfig, mesh=None):
    """(params, batch) → the loss metrics {"xent", "aux"}, without gradients."""
    check_plan(plan, mesh, cfg)

    def eval_step(params, batch):
        with torch.no_grad(), _rules(plan, mesh):
            _, metrics = model_api.loss_fn(cfg, params, batch, remat_policy="none")
        return metrics

    return eval_step


def make_serve_step(cfg: ModelConfig, plan: Optional[ParallelismConfig] = None, mesh=None):
    """One greedy decode step: (params, token (B,), t, caches) →
    (next token (B,) int32, caches); ``t`` is an int, or a (B,) int32
    tensor of one position per row.  ``torch.argmax`` takes the first
    maximum, as ``jnp.argmax`` does; on a mesh over the gathered logits.
    One position a row: no sequence parallel."""
    plan = plan or ParallelismConfig()
    check_plan(plan, mesh, cfg)

    def serve_step(params, token, t, caches):
        with _rules(plan, mesh, seq=None):
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

    def prefill(params, batch):
        with torch.no_grad(), _rules(plan, mesh):
            return _whole_logits(cfg, model_api.forward(cfg, params, batch,
                                                        last_only=last_only))

    return prefill


def make_prefill_cache(cfg: ModelConfig, plan: Optional[ParallelismConfig] = None, mesh=None):
    """Prompt ingestion: (params, batch, caches) → (last-position logits
    (B, V), caches), the caches filled with the prompt's K/V."""
    plan = plan or ParallelismConfig()
    check_plan(plan, mesh, cfg)

    def prefill_cache(params, batch, caches):
        with _rules(plan, mesh):
            logits, caches = model_api.prefill_cache(cfg, params, batch, caches)
            return _whole_logits(cfg, logits), caches

    return prefill_cache


def one_device(what: str, mesh) -> None:
    """Raise for ``what`` on a mesh: it runs on one device only."""
    if mesh is not None:
        raise NotImplementedError(f"{what} on a mesh: the continuous-batching steps under "
                                  f"tensor parallelism are not ported yet {PARALLEL}")


def make_slot_serve_step(cfg: ModelConfig, plan: Optional[ParallelismConfig] = None,
                         mesh=None):
    """Continuous-batching decode: like ``make_serve_step``, but every slot
    (batch row) carries its own position ``ts[i]``, so requests at
    different depths decode together in one full-width step.  The reference
    vmaps its single-request decode over the slots; the port's decode takes
    the (B,) int32 positions as they are (one launch per layer, no loop over
    slots, no host sync), so this is ``make_serve_step`` called with a
    tensor for ``t``: (params, tokens (B,), ts (B,), caches) → (next (B,)
    int32, caches).  One device only."""
    one_device("the slot step", mesh)
    return make_serve_step(cfg)


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
