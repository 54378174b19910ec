"""Step functions, mirroring the single-device case of ``repro.core.stepfn``
(no mesh, no jit: PyTorch runs eagerly).

``make_train_step`` is the reference's pp=1 step: gradients of ``loss_fn``
(one micro-batch, or ``plan.gas`` of them accumulated token-weighted in the
compute dtype, a non-finite micro-batch masked out), the in-step finite /
z-score skip gate on ``rstat``, gradient compression, the LR schedule with
its re-warm factor, and AdamW with the zero-update on a skipped step.  The
train state is updated in place (params, ``m``, ``v`` and ``ef`` leaf by
leaf), the metrics are 0-d tensors on the device under the reference's
names, and the step reads nothing back to the host.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional

import torch

from repro_torch.core.recipe import ParallelismConfig
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


def check_single_device(plan: ParallelismConfig) -> None:
    for axis in ("tp", "pp", "dp", "pods"):
        if getattr(plan, axis) > 1:
            raise NotImplementedError(
                f"{axis}={getattr(plan, axis)}: the parallel recipe over "
                "torch.distributed is not ported yet (ROADMAP queue 1, item 7); "
                "this step runs on one device")


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
               train_cfg: TrainConfig = TrainConfig()) -> Dict[str, Any]:
    """fp32 parameters from ``gen`` on its device, AdamW moments, step 0."""
    check_single_device(plan)
    params = model_api.init_params(cfg, gen)
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
                    train_cfg: TrainConfig = TrainConfig()):
    """Returns train_step(state, batch) → (state, metrics); ``batch`` holds
    tensors on the state's device, optionally ``_chaos_grad_scale`` (the
    fault-injection harness' gradient multiplier, per micro-batch)."""
    check_single_device(plan)
    rs = train_cfg.resilience
    if rs.enabled and rs.consensus and rs.consensus_replicas > 1:
        raise NotImplementedError("skip consensus across replicas comes with the "
                                  "fleet's port (ROADMAP queue 1, item 9)")

    def value_and_grad(leaves, params, batch):
        loss, metrics = model_api.loss_fn(cfg, params, batch,
                                          remat_policy=plan.remat_policy)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g for p, g in zip(leaves, grads)]
        return loss.detach(), {k: v.detach() for k, v in metrics.items()}, grads

    def grads_and_metrics(params, batch, chaos_scale):
        """(loss, metrics, grads in leaf order, anomaly aux), honouring
        ``plan.gas``: with gas > 1 the micro-batches' gradients accumulate in
        the compute dtype, each weighted by its live-token count, and a
        non-finite micro-batch is dropped with the weights renormalized."""
        leaves = [p.requires_grad_() for _, p in tree_leaves(params)]
        if plan.gas <= 1:
            loss, metrics, grads = value_and_grad(leaves, params, batch)
            if chaos_scale is not None:
                _scale_(grads, torch.prod(chaos_scale.to(torch.float32)))
            usable = torch.isfinite(adamw.global_norm(grads))
            aux = {"usable": usable,
                   "nonfinite_micros": (~usable).to(torch.int32),
                   "bad_micro_bits": (~usable).to(torch.float32)}
            return loss, metrics, grads, aux
        gas = plan.gas
        for k, x in batch.items():
            if x.shape[0] % gas:
                raise ValueError(f"batch dim {x.shape[0]} of {k!r} not divisible by gas={gas}")
        micro = {k: x.reshape(gas, x.shape[0] // gas, *x.shape[1:]) for k, x in batch.items()}
        device = batch["labels"].device
        if batch.get("loss_mask") is not None:
            w = torch.sum(batch["loss_mask"].to(torch.float32).reshape(gas, -1), dim=1)
        else:
            w = torch.full((gas,), batch["labels"].reshape(gas, -1).shape[1],
                           dtype=torch.float32, device=device)
        wn = w * (gas / torch.clamp_min(torch.sum(w), 1.0))
        if chaos_scale is not None:
            chaos_scale = torch.broadcast_to(chaos_scale.to(torch.float32), (gas,))

        acc = [torch.zeros(p.shape, dtype=cfg.compute_dtype, device=p.device) for p in leaves]
        zero = torch.zeros((), dtype=cfg.compute_dtype, device=device)
        losses, metricses, fins = [], [], []
        for i in range(gas):
            loss, metrics, g = value_and_grad(leaves, params, {k: x[i] for k, x in micro.items()})
            if chaos_scale is not None:
                _scale_(g, chaos_scale[i])
            fin = torch.isfinite(adamw.global_norm(g))
            with torch.no_grad():
                for a, gi in zip(acc, g):
                    a.add_(torch.where(fin, (gi * wn[i]).to(a.dtype), zero))
            del g
            losses.append(loss)
            metricses.append(metrics)
            fins.append(fin)
        fins = torch.stack(fins)
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
               "bad_micro_bits": _micro_bits(~fins)}
        return loss, metrics, acc, aux

    def train_step(state, batch):
        batch = dict(batch)
        chaos_scale = batch.pop("_chaos_grad_scale", None)
        rstat = state["rstat"]
        loss, metrics, grads, aux = grads_and_metrics(state["params"], batch, chaos_scale)
        device = loss.device

        # in-step anomaly signals, all on the device
        gnorm = adamw.global_norm(grads)
        finite = aux["usable"] & torch.isfinite(gnorm)
        armed = rstat["n"] >= rs.warmup_steps
        std = torch.sqrt(torch.clamp_min(rstat["var"], 1e-12))
        z = torch.where(finite, (gnorm - rstat["ema"]) / std,
                        torch.tensor(float("inf"), device=device))
        spike = armed & (z > rs.zscore_threshold) & (gnorm > rs.spike_factor * rstat["ema"])
        skip = (~finite) | spike if rs.enabled else torch.zeros((), dtype=torch.bool,
                                                                 device=device)

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
        grads = apply_compression(grads, train_cfg.compression, state.get("ef"), skip=keep)
        lr = schedule.lr_schedule(state["step"], peak=train_cfg.peak_lr,
                                  warmup=train_cfg.warmup, total=train_cfg.total_steps)
        lr = lr * schedule.rewarm_factor(rstat["rewarm"], rs.rewarm_steps)
        om = adamw.adamw_update(grads, state["opt"], state["params"], lr, train_cfg.adam,
                                skip=keep)
        del grads
        new_state = dict(state, step=state["step"] + 1, rstat=new_rstat)
        metrics = dict(metrics, loss=loss, **om)
        metrics.update(
            grad_norm=gnorm,
            all_finite=finite.to(torch.float32),
            skipped=skip.to(torch.float32),
            gnorm_z=torch.where(armed & finite, z, 0.0),
            nonfinite_micros=aux["nonfinite_micros"].to(torch.float32),
            bad_replicas=torch.zeros((), dtype=torch.float32, device=device),
            n_replicas=torch.ones((), dtype=torch.float32, device=device),
            bad_micro_bits=aux["bad_micro_bits"],
            lr=lr)
        return new_state, metrics

    return train_step


def make_eval_step(cfg: ModelConfig, plan: ParallelismConfig):
    """(params, batch) → the loss metrics {"xent", "aux"}, without gradients."""

    def eval_step(params, batch):
        with torch.no_grad():
            _, metrics = model_api.loss_fn(cfg, params, batch, remat_policy="none")
        return metrics

    return eval_step


def make_serve_step(cfg: ModelConfig):
    """One greedy decode step: (params, token (B,), t, caches) →
    (next token (B,) int32, caches).  ``torch.argmax`` takes the first
    maximum, as ``jnp.argmax`` does."""

    def serve_step(params, token, t: int, caches):
        logits, caches = model_api.decode_step(cfg, params, token, t, caches)
        return logits.argmax(dim=-1).to(torch.int32), caches

    return serve_step


def make_prefill_cache(cfg: ModelConfig):
    """Prompt ingestion: (params, batch, caches) → (last-position logits
    (B, V), caches), the caches filled with the prompt's K/V."""

    def prefill_cache(params, batch, caches):
        return model_api.prefill_cache(cfg, params, batch, caches)

    return prefill_cache
