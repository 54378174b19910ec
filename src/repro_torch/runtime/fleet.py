"""Elastic fleet recovery: replica liveness tracking + re-plan decisions (a
copy of ``repro.runtime.fleet``).

The resilience layer recovers a *single* replica (skip → rollback); on a
real 128-node fleet the dominant interruption mode is losing a node outright
(the Frontier study, arXiv 2312.12705), and OpenGPT-X's best practices
(arXiv 2504.10013) make automated elastic restart a first-class requirement.
This module is the control plane that turns node loss and persistent
stragglers into a *plan change* instead of a dead job:

* ``FleetController`` tracks per-replica liveness and step-time history from
  heartbeats (the loop feeds it the ``StepWatchdog``'s measured step times;
  chaos feeds simulated peers — ``FaultPlan.peer_step_time`` /
  ``maybe_lose_replica``).  A replica is declared lost on an explicit signal
  (SLURM node-fail event, chaos injection) or after ``miss_patience``
  heartbeat gaps; a replica whose step times exceed
  ``straggler_factor × fleet median`` for ``straggler_patience`` consecutive
  steps is a persistent straggler.

* ``observe(step)`` returns a ``ReplanDecision`` when the fleet must shrink.
  The loop's re-plan arm then: block-joins the checkpoint writer, picks the
  shrunk plan (``shrink_plan``: drop a dp way while the dp axis has slack,
  else halve the pipeline — ``core.scaling.strong_plan``'s gas ≥ pp law
  keeps the shrunk pipe full), restores the last good checkpoint through
  ``checkpoint.elastic.replan_state`` under the new plan, fast-forwards the
  data cursor from the manifest, and resumes with a rebuilt step.

Everything is host-side and clock-injectable: the chaos harness exercises
replica loss and straggler re-plans end-to-end on a simulated fleet with no
wall-time dependence.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

from repro_torch.core.recipe import ParallelismConfig


@dataclasses.dataclass(frozen=True)
class FleetConfig:
    straggler_factor: float = 2.0    # replica median vs fleet median ratio
    straggler_patience: int = 3      # consecutive slow steps → persistent
    miss_patience: int = 3           # missed heartbeats → presumed lost
    window: int = 16                 # step-time history kept per replica


@dataclasses.dataclass
class ReplanDecision:
    """Why the fleet must re-plan: which replica, and what it did."""

    kind: str                        # replica_lost | straggler
    replica: int
    step: int
    detail: Dict[str, float] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class _Replica:
    alive: bool = True
    last_step: int = -1
    slow_streak: int = 0
    times: List[float] = dataclasses.field(default_factory=list)


def _median(xs: List[float]) -> Optional[float]:
    if not xs:
        return None
    s = sorted(xs)
    return s[len(s) // 2]


def shrink_plan(plan: ParallelismConfig, *, lost: int = 1,
                n_layers: Optional[int] = None) -> ParallelismConfig:
    """The shrunk plan after losing ``lost`` replicas.

    Preference order mirrors the recipe's scaling laws: give up dp ways
    first (data parallelism is the elastic axis — per-replica work and the
    pipeline schedule are untouched), and only when the dp axis is exhausted
    halve the pipeline, re-balancing gas so the shrunk pipe still fills
    (``core.scaling.strong_plan`` refuses gas < pp for the same reason).
    The global batch is preserved in both arms, so the training trajectory
    from a common checkpoint is the shrunk plan's own clean trajectory."""
    if plan.dp > lost:
        return dataclasses.replace(plan, dp=plan.dp - lost)
    if plan.pp > 1:
        new_pp = plan.pp // 2
        while new_pp > 1 and (n_layers is not None
                              and n_layers % (new_pp * plan.vpp)):
            new_pp //= 2
        if n_layers is not None and n_layers % (new_pp * plan.vpp):
            new_pp = 1
        gas = plan.gas
        if plan.vpp > 1 and new_pp > 1 and gas % new_pp:
            gas -= gas % new_pp            # keep the interleaved rounds law
        gas = max(gas, new_pp)             # strong_plan's "pipe must fill"
        return dataclasses.replace(plan, pp=new_pp, gas=gas, dp=1)
    raise ValueError(
        f"cannot shrink plan {plan}: no dp slack and no pipeline to halve")


class FleetController:
    """Host-side fleet liveness/straggler tracker + re-plan state machine.

    One controller instance lives on the coordinating host (every host runs
    the same deterministic logic from the same heartbeat stream, so the
    decision is fleet-consistent without extra coordination — the same
    argument the data pipeline makes).  ``observe`` is called once per loop
    step *after* heartbeats are fed; at most one decision is outstanding at
    a time and ``on_replanned`` re-arms the machine."""

    def __init__(self, n_replicas: int, cfg: Optional[FleetConfig] = None,
                 local_replica: int = 0):
        if n_replicas < 1:
            raise ValueError("n_replicas must be >= 1")
        self.cfg = cfg if cfg is not None else FleetConfig()
        self.local_replica = local_replica
        self.replicas: Dict[int, _Replica] = {
            r: _Replica() for r in range(n_replicas)}
        self.decisions: List[ReplanDecision] = []
        self.n_replans = 0
        self._pending: Optional[ReplanDecision] = None

    # ------------------------------------------------------------------
    # signals in
    # ------------------------------------------------------------------
    @property
    def n_replicas(self) -> int:
        return len(self.replicas)

    @property
    def n_alive(self) -> int:
        return sum(r.alive for r in self.replicas.values())

    def alive(self, replica: int) -> bool:
        return self.replicas[replica].alive

    def heartbeat(self, replica: int, step: int, step_time_s: float) -> None:
        """One replica finished ``step`` in ``step_time_s`` seconds."""
        rep = self.replicas[replica]
        if not rep.alive:
            return
        rep.last_step = step
        rep.times.append(float(step_time_s))
        del rep.times[:-self.cfg.window]

    def mark_lost(self, replica: int, step: int,
                  reason: str = "signal") -> None:
        """Explicit loss signal (scheduler event, chaos injection)."""
        rep = self.replicas[replica]
        if not rep.alive:
            return
        rep.alive = False
        if self._pending is None:
            self._pending = ReplanDecision(
                "replica_lost", replica, step,
                {"reason": reason, "last_step": rep.last_step})

    def median_step_time(self, replica: int) -> Optional[float]:
        return _median(self.replicas[replica].times)

    def fleet_median(self) -> Optional[float]:
        meds = [m for r, rep in self.replicas.items() if rep.alive
                for m in [_median(rep.times)] if m is not None]
        return _median(meds)

    # ------------------------------------------------------------------
    # decisions out
    # ------------------------------------------------------------------
    def observe(self, step: int) -> Optional[ReplanDecision]:
        """At most one decision per call; loss signals win over stragglers."""
        if self._pending is None:
            self._check_missed(step)
        if self._pending is None:
            self._check_stragglers(step)
        decision, self._pending = self._pending, None
        if decision is not None:
            self.decisions.append(decision)
        return decision

    def _check_missed(self, step: int) -> None:
        for r, rep in self.replicas.items():
            if not rep.alive or rep.last_step < 0:
                continue
            if step - rep.last_step > self.cfg.miss_patience:
                rep.alive = False
                self._pending = ReplanDecision(
                    "replica_lost", r, step,
                    {"reason": "missed_heartbeats",
                     "last_step": rep.last_step})
                return

    def _check_stragglers(self, step: int) -> None:
        fleet_med = self.fleet_median()
        if fleet_med is None or fleet_med <= 0:
            return
        for r, rep in self.replicas.items():
            if not rep.alive or not rep.times:
                continue
            slowdown = rep.times[-1] / fleet_med
            if slowdown > self.cfg.straggler_factor:
                rep.slow_streak += 1
            else:
                rep.slow_streak = 0
            if rep.slow_streak >= self.cfg.straggler_patience:
                rep.alive = False     # drop the straggler: shrink without it
                self._pending = ReplanDecision(
                    "straggler", r, step,
                    {"slowdown": slowdown,
                     "median_s": _median(rep.times) or 0.0,
                     "fleet_median_s": fleet_med,
                     "streak": rep.slow_streak})
                return

    def shrink_plan(self, plan: ParallelismConfig, *,
                    n_layers: Optional[int] = None) -> ParallelismConfig:
        """The plan for the surviving fleet (module-level law, bound to how
        many replicas this controller has actually lost since the last
        re-plan — at least one, because a decision triggered it)."""
        lost = max(1, self.n_replicas - self.n_alive - self._already_dropped)
        return shrink_plan(plan, lost=lost, n_layers=n_layers)

    _already_dropped: int = 0

    def on_replanned(self, step: int) -> None:
        """The loop completed a re-plan: re-arm, and fold the dead replicas
        into the baseline so the next loss is counted from the new fleet."""
        self.n_replans += 1
        self._already_dropped = self.n_replicas - self.n_alive
        for rep in self.replicas.values():
            rep.slow_streak = 0
