"""Fault-tolerant training loop, ``repro.runtime.train_loop`` line for line
over the port's state: restore → train → periodic atomic checkpoint
→ clean preemption handling, plus the host half of the resilience contract
(``runtime.resilience``): a skip/rollback recovery state machine driven by the
in-step anomaly signals, a running watchdog thread for hung/straggling steps,
and checkpoint I/O whose failures are retried, surfaced, and tracked instead
of silently lost.  The loop is deliberately free of any state that is not in
the checkpoint (including the rolled-forward data cursor, stored in the
manifest ``extra``), so kill -9 at any point loses at most ``ckpt_every``
steps and a restart continues bit-exactly (tested).

Where the port differs: the step's metrics (0-d device tensors) are read to
the host once per step, inside the watchdog's window, so a step's measured
time includes its device work; a restore lands on the live state's device
(the store restores onto its template's).

On a mesh (``mesh=``, a ``launch.mesh.RecipeMesh``; every rank runs the
loop) a checkpoint gathers the sharded state leaf by leaf into host memory
on rank 0 (``checkpoint.elastic.host_snapshot``), which writes it and
collects old steps; the ranks meet at a barrier before any of them reads a
checkpoint and when the loop ends.  A restore reads the whole state on the
host of every rank and moves only its shards to the device.  The step's
metrics are the same on every rank, and the measured straggler signal is
the slowest rank's, so every rank logs the same events.
"""

from __future__ import annotations

import dataclasses
import signal
import time
from typing import Any, Callable, Dict, Optional

import torch
import torch.distributed as dist

from repro_torch.checkpoint import RetryPolicy, restore_latest, save_checkpoint
from repro_torch.checkpoint.elastic import (canonicalize_state, host_snapshot,
                                            replan_state, reshard_state)
from repro_torch.core import tp
from repro_torch.core.recipe import ParallelismConfig
from repro_torch.runtime.chaos import FaultPlan
from repro_torch.runtime.fleet import FleetController
from repro_torch.runtime.resilience import (ROLLBACK, SKIP, RecoveryPolicy,
                                            ResilienceConfig, ResilienceEvent)
from repro_torch.runtime.watchdog import StepWatchdog


def log_event(tracker, step, kind, payload):
    """Thin indirection over ``session.tracker.log_event`` — imported lazily
    because ``session`` imports this module (TrainSession wraps the loop)."""
    from repro_torch.session.tracker import log_event as _impl
    _impl(tracker, step, kind, payload)


def _host_metrics(metrics: Dict[str, Any]) -> Dict[str, float]:
    """The step's 0-d metrics as python floats, in one transfer."""
    vals = torch.stack([torch.as_tensor(v).detach().to(torch.float32).reshape(())
                        for v in metrics.values()]).tolist()
    return dict(zip(metrics, vals))


@dataclasses.dataclass
class LoopConfig:
    total_steps: int
    ckpt_every: int = 50
    ckpt_dir: Optional[str] = None
    log_every: int = 10
    step_deadline_s: float = 3600.0
    keep_ckpts: int = 3
    async_ckpt: bool = True
    straggler_factor: float = 4.0   # measured last/median step-time ratio
    #                                 above which a structured ``straggler``
    #                                 event is emitted (watchdog deadline
    #                                 events fire independently of this)


class Preempted(Exception):
    pass


def run_training(state, train_step: Callable, batches, loop_cfg: LoopConfig,
                 *, plan: ParallelismConfig = ParallelismConfig(),
                 log: Callable[[str], None] = print,
                 tracker=None,
                 resilience: Optional[ResilienceConfig] = None,
                 chaos: Optional[FaultPlan] = None,
                 fleet: Optional[FleetController] = None,
                 make_step: Optional[
                     Callable[[ParallelismConfig], Callable]] = None,
                 ckpt_retry: Optional[RetryPolicy] = None,
                 clock: Callable[[], float] = time.monotonic,
                 mesh=None, cfg=None) -> Dict[str, Any]:
    """Run (or resume) training. ``batches(i)`` → batch dict for data index i.

    ``tracker`` is any ``session.tracker.Tracker`` — every logged step's
    metrics stream through it, every recovery transition lands as a
    structured event (``log_event``), and ``finish()`` runs on the way out,
    also on preemption, so file-backed trackers keep what was logged.
    ``resilience`` configures the skip/rollback policy (it should match the
    ``TrainConfig.resilience`` built into the step — ``TrainSession``
    keeps them in sync); ``chaos`` is the fault-injection harness
    (``runtime.chaos.FaultPlan``, replacing the old ``fail_at_step``);
    ``ckpt_retry`` bounds checkpoint I/O retries.

    ``fleet`` is a ``runtime.fleet.FleetController``: the loop feeds it one
    heartbeat per replica per step (local step time from the watchdog;
    simulated peers through ``chaos.peer_step_time``) and consults
    ``fleet.observe`` after every step — a replica-lost or persistent-
    straggler decision triggers the elastic **re-plan** arm: block-join the
    checkpoint writer, shrink the plan (``fleet.shrink_plan``), restore the
    last good checkpoint under the new plan (or re-plan the live state when
    no checkpoint exists — the skipped/clean params are still good), rebuild
    the step via ``make_step(new_plan)``, fast-forward the data
    cursor, resume.  ``make_step`` is required for a re-plan to complete;
    without it the decision is surfaced as ``replan_unavailable``.
    ``mesh`` and ``cfg`` (the model config: the state's whole shapes) run
    the loop on every rank of a mesh; the fleet's re-plan is one device's
    (there, at any pp: a re-plan that halves the pipeline keeps the flat
    block list, ``checkpoint.elastic.replan_state``).
    Returns {state, history, resumed_from, stragglers, events, skipped_steps,
    rollbacks, replans, plan, data_offset}.
    """
    if mesh is not None and fleet is not None:
        raise NotImplementedError(
            "the fleet's re-plan onto a smaller mesh is not ported yet (ROADMAP Queue 1, "
            "item 3: the parallel recipe over torch.distributed; its item 3.4, the fleet)")
    writes = mesh is None or mesh.rank == 0

    def meet():
        """On a mesh: every rank waits until rank 0's writes are on disk."""
        if mesh is not None:
            dist.barrier()

    def restore(state):
        """(the newest checkpoint in ``state``'s layout, its extra, its
        step), or Nones: on a mesh read on the host, each rank keeping its
        shards."""
        on_mesh = mesh is not None
        restored, extra, step = restore_latest(
            loop_cfg.ckpt_dir, canonicalize_state(state, plan), retry=retry, log=log,
            fault_hook=read_fault, device="cpu" if on_mesh else None)
        if restored is not None:
            restored = reshard_state(restored, plan, mesh=mesh,
                                     device=state["step"].device if on_mesh else None)
        return restored, extra, step

    rs = resilience if resilience is not None else ResilienceConfig()
    policy = RecoveryPolicy(rs)
    retry = ckpt_retry if ckpt_retry is not None else RetryPolicy()
    read_fault = chaos.ckpt_read_hook() if chaos is not None else None
    write_fault = chaos.ckpt_write_hook() if chaos is not None else None
    if chaos is not None:
        batches = chaos.wrap_batches(batches)

    def emit(step: int, kind: str, **detail):
        policy.events.append(ResilienceEvent(step, kind, detail))
        log_event(tracker, step, kind, detail)

    start_step = 0
    data_offset = 0
    resumed_from = None
    if loop_cfg.ckpt_dir:
        restored, extra, step = restore(state)
        if restored is not None:
            state = restored
            start_step = int(extra.get("next_step", step))
            data_offset = int(extra.get("data_offset", 0))
            resumed_from = start_step
            log(f"[loop] resumed from checkpoint at step {start_step}"
                + (f" (data cursor +{data_offset})" if data_offset else ""))

    preempt = {"flag": False}

    def on_sigterm(signum, frame):
        preempt["flag"] = True

    old_handler = signal.signal(signal.SIGTERM, on_sigterm)

    stragglers = []
    wd = StepWatchdog(loop_cfg.step_deadline_s,
                      on_timeout=lambda s, el: stragglers.append((s, el)),
                      clock=clock)
    wd.start()
    straggler_cursor = 0
    history = []
    pending_writer = None
    n_replans = 0

    def forensics(detail: Dict[str, Any], batch, metrics, step: int) -> None:
        """Anomaly data forensics: stamp the offending batch's identity onto
        a skip event so a bad shard can be traced back to the data, not just
        the step — which data index, its content hash, and which micro-
        batches inside it went non-finite (decoded from the in-step
        ``bad_micro_bits`` bitmask)."""
        detail["data_index"] = step + data_offset
        try:
            from repro_torch.data.pipeline import batch_fingerprint
            detail["batch_hash"] = batch_fingerprint(batch)
        except Exception:                    # noqa: BLE001 — best-effort
            pass
        bits = int(float(metrics.get("bad_micro_bits", 0.0)))
        if bits:
            detail["bad_micros"] = [i for i in range(32) if (bits >> i) & 1]

    def reap_writer(writer, *, block: bool, at_step: int):
        """Check a background writer's fate; surface failures as events
        instead of silently believing the checkpoint exists."""
        if writer is None:
            return None
        if not block and not writer.done():
            return writer
        err = writer.exception()
        if err is not None:
            log(f"[loop] background checkpoint write for step {writer.step} "
                f"FAILED after retries: {err}")
            emit(at_step, "ckpt_write_failed",
                 ckpt_step=writer.step, error=str(err))
        return None

    def write_ckpt(step: int, *, emergency: bool = False):
        nonlocal pending_writer
        pending_writer = reap_writer(pending_writer, block=True, at_step=step)
        tag = loop_cfg.total_steps + 1_000_000 if emergency else step
        extra = {"next_step": step, "data_offset": data_offset}
        whole = (canonicalize_state(state, plan) if mesh is None
                 else host_snapshot(state, plan, mesh=mesh, cfg=cfg, keep=writes))
        if not writes:
            return
        try:
            writer = save_checkpoint(
                loop_cfg.ckpt_dir, tag, whole,
                extra=extra, keep=loop_cfg.keep_ckpts,
                background=loop_cfg.async_ckpt and not emergency,
                retry=retry, log=log, fault_hook=write_fault)
        except Exception as e:               # noqa: BLE001 — surfaced
            log(f"[loop] checkpoint write for step {step} FAILED after "
                f"retries: {e}")
            emit(step, "ckpt_write_failed", ckpt_step=tag, error=str(e))
            return
        pending_writer = writer

    step = start_step
    try:
        while step < loop_cfg.total_steps:
            if preempt["flag"]:
                raise Preempted()
            if chaos is not None:
                chaos.maybe_crash(step)
                chaos.maybe_sigterm(step)
            wd.begin_step(step)
            batch = batches(step + data_offset)
            state, metrics = train_step(state, batch)
            metrics = _host_metrics(metrics)     # the step's one host sync
            if chaos is not None:
                chaos.maybe_slow(step)       # inside the watchdog window
            wd.end_step(step)
            while straggler_cursor < len(stragglers):
                s, el = stragglers[straggler_cursor]
                straggler_cursor += 1
                emit(s, "straggler", elapsed_s=float(el),
                     deadline_s=loop_cfg.step_deadline_s, source="deadline")
            # measured straggling (no deadline needed): last completed step
            # vs the median — the quantitative signal the deadline thread
            # can't give
            sf = wd.slowdown_factor()
            if mesh is not None:
                sf = float(tp.collective("all_reduce_max", torch.tensor(
                    -1.0 if sf is None else sf, dtype=torch.float64,
                    device=state["step"].device), None))
                sf = None if sf < 0 else sf
            if sf is not None and sf > loop_cfg.straggler_factor:
                emit(step, "straggler", source="measured",
                     elapsed_s=float(wd.last_step_time() or 0.0),
                     median_s=float(wd.median_step_time() or 0.0),
                     slowdown=float(sf))

            # --- fleet liveness: heartbeats in, re-plan decisions out ------
            if fleet is not None:
                t_local = float(wd.last_step_time() or 0.0)
                for r in range(fleet.n_replicas):
                    if not fleet.alive(r):
                        continue
                    t_r = t_local
                    if chaos is not None and r != fleet.local_replica:
                        t_r = chaos.peer_step_time(r, step, t_local)
                    fleet.heartbeat(r, step, t_r)
                if chaos is not None:
                    lost = chaos.maybe_lose_replica(step)
                    if lost is not None:
                        fleet.mark_lost(lost, step, reason="chaos")
                        emit(step, "replica_lost", replica=lost,
                             reason="chaos")
                decision = fleet.observe(step)
                if decision is not None:
                    if decision.kind == "straggler":
                        emit(step, "straggler", source="fleet",
                             replica=decision.replica, **decision.detail)
                    elif decision.detail.get("reason") == "missed_heartbeats":
                        emit(step, "replica_lost", replica=decision.replica,
                             **decision.detail)
                    # ---- elastic re-plan ------------------------------
                    t0 = clock()
                    new_plan = None
                    try:
                        new_plan = fleet.shrink_plan(plan)
                    except ValueError as e:
                        emit(step, "replan_unavailable", reason=str(e),
                             trigger=decision.kind)
                    if new_plan is not None and make_step is None:
                        emit(step, "replan_unavailable", trigger=decision.kind,
                             reason="no step factory (make_step=None)")
                        log(f"[fleet] step {step}: re-plan wanted "
                            f"({decision.kind}, replica {decision.replica}) "
                            f"but no make_step factory — continuing degraded")
                        new_plan = None
                    if new_plan is not None:
                        pending_writer = reap_writer(pending_writer,
                                                     block=True, at_step=step)
                        restored = extra2 = None
                        if loop_cfg.ckpt_dir:
                            restored, extra2, ck = restore_latest(
                                loop_cfg.ckpt_dir,
                                canonicalize_state(state, plan),
                                retry=retry, log=log, fault_hook=read_fault)
                        if restored is not None:
                            target = int(extra2.get("next_step", ck))
                            data_offset = int(
                                extra2.get("data_offset", data_offset))
                            state = reshard_state(restored, new_plan)
                        else:
                            # no checkpoint: the live params are clean
                            # (anomalies never landed), so re-plan the live
                            # state in place — zero steps lost
                            target = step + 1
                            state = replan_state(state, plan, new_plan)
                        train_step = make_step(new_plan)
                        detail = {
                            "trigger": decision.kind,
                            "replica": decision.replica,
                            "old_plan": str(plan), "new_plan": str(new_plan),
                            "restored_step": (target if restored is not None
                                              else None),
                            "steps_lost": step + 1 - target,
                            "latency_s": float(clock() - t0)}
                        emit(step, "replan", **detail)
                        log(f"[fleet] step {step}: {decision.kind} (replica "
                            f"{decision.replica}) — re-planned "
                            f"{detail['old_plan']} -> {detail['new_plan']}, "
                            f"resuming at step {target} "
                            f"({detail['steps_lost']} steps lost)")
                        n_replans += 1
                        plan = new_plan
                        fleet.on_replanned(step)
                        step = target
                        continue

            # --- recovery policy: reads the in-step anomaly scalars that
            # already ride the metrics transfer -----------------------------
            action = policy.observe(step, metrics)
            if action == SKIP:
                forensics(policy.events[-1].detail, batch, metrics, step)
                log(f"[resilience] step {step}: anomalous update skipped "
                    f"(grad_norm={policy.events[-1].detail['grad_norm']:.4g}, "
                    f"{policy.consecutive_skips} consecutive)")
                log_event(tracker, step, policy.events[-1].kind,
                          policy.events[-1].detail)
            elif action == ROLLBACK:
                forensics(policy.events[-1].detail, batch, metrics, step)
                log_event(tracker, step, policy.events[-1].kind,
                          policy.events[-1].detail)
                t0 = clock()
                restored = extra2 = None
                if loop_cfg.ckpt_dir:
                    pending_writer = reap_writer(pending_writer, block=True,
                                                 at_step=step)
                    meet()
                    restored, extra2, ck = restore(state)
                if restored is not None:
                    target = int(extra2.get("next_step", ck))
                    jump = (step + 1 - target) + rs.skip_window_margin
                    data_offset += jump
                    state = restored
                    if rs.rewarm_steps > 0 and "rstat" in state:
                        state["rstat"] = dict(
                            state["rstat"],
                            rewarm=torch.full_like(state["rstat"]["rewarm"],
                                                   rs.rewarm_steps))
                    detail = {"steps_lost": step + 1 - target,
                              "data_skipped": jump,
                              "rewarm_steps": rs.rewarm_steps,
                              "latency_s": float(clock() - t0)}
                    policy.on_rollback(step, target, **detail)
                    emit_detail = dict(detail, restored_step=target)
                    log_event(tracker, step, ROLLBACK, emit_detail)
                    log(f"[resilience] step {step}: {rs.max_consecutive_skips}"
                        f" consecutive skips — rolled back to step {target}, "
                        f"data cursor +{jump}, LR re-warm "
                        f"{rs.rewarm_steps} steps")
                    step = target
                    continue
                # no checkpoint to roll back to: the skipped updates never
                # touched params, so training continues on the next batch —
                # but say so loudly
                reason = ("no checkpoint directory" if not loop_cfg.ckpt_dir
                          else "no restorable checkpoint")
                policy.on_rollback(step, None, reason=reason)
                log_event(tracker, step, "rollback_unavailable",
                          {"reason": reason})
                log(f"[resilience] step {step}: rollback wanted but no "
                    f"checkpoint available — continuing (updates were "
                    f"skipped, params are clean)")

            if step % loop_cfg.log_every == 0:
                m = dict(metrics)
                history.append({"step": step, **m})
                if tracker is not None:
                    tracker.log_metrics(step, m)
                log(f"[loop] step {step}: " +
                    " ".join(f"{k}={v:.4g}" for k, v in m.items()))
            # never checkpoint mid skip-streak: a rollback target must be a
            # step the policy considered healthy
            if (loop_cfg.ckpt_dir and (step + 1) % loop_cfg.ckpt_every == 0
                    and policy.healthy):
                write_ckpt(step + 1)
            step += 1
    except Preempted:
        if loop_cfg.ckpt_dir:
            write_ckpt(step, emergency=True)
            if pending_writer is not None:
                pending_writer = reap_writer(pending_writer, block=True,
                                             at_step=step)
            emit(step, "preempt", emergency_ckpt=True)
            log("[loop] preempted — emergency checkpoint written")
        else:
            emit(step, "preempt", emergency_ckpt=False)
        raise
    finally:
        pending_writer = reap_writer(pending_writer, block=True, at_step=step)
        meet()
        wd.stop()
        signal.signal(signal.SIGTERM, old_handler)
        if tracker is not None:
            tracker.finish()

    return {"state": state, "history": history, "resumed_from": resumed_from,
            "stragglers": stragglers, "events": policy.events,
            "skipped_steps": policy.n_skipped, "rollbacks": policy.n_rollbacks,
            "replans": n_replans, "plan": plan, "data_offset": data_offset}
