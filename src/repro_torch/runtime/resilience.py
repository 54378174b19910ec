"""Training resilience: in-step anomaly detection + skip/rollback recovery,
a copy of ``repro.runtime.resilience``.

Multi-week runs at 128-node scale are dominated by failures the *loop* has to
absorb, not the scheduler: loss spikes, non-finite gradients, hung replicas,
flaky checkpoint I/O (the OpenGPT-X best-practices report, arXiv 2504.10013,
and the Frontier study, arXiv 2312.12705, both rank divergence handling and
restart hygiene as first-order concerns).  The contract here has two halves:

* **Device side** (``core.stepfn.make_train_step``): every train step computes
  the global grad-norm and an all-finite flag on the device and returns them
  in the metrics dict as 0-d tensors — detection rides the one metrics read
  the loop already does per step, no extra host sync.  The step carries an EMA/variance of
  accepted grad-norms in ``state["rstat"]`` and applies a **zero-update**
  (params/opt unchanged, data cursor advances) whenever gradients are
  non-finite or the norm z-scores as a spike.  Under gradient accumulation,
  non-finite *micro-batches* are masked out of the accumulation (weight
  renormalized over the survivors) instead of poisoning the whole step.

* **Host side** (``runtime.train_loop.run_training``): a ``RecoveryPolicy``
  state machine watches the ``skipped`` flag.  Isolated anomalies stay
  skip-only; after ``max_consecutive_skips`` the loop **rolls back** to the
  last good checkpoint, fast-forwards the data cursor past the offending
  batch window, and re-warms the LR for ``rewarm_steps`` (see
  ``optim.schedule.rewarm_factor``).  Every transition is a structured event
  through ``session.tracker``.

The ``runtime.chaos`` harness injects each fault class end-to-end;
``chip_smoke.py`` runs its drills on the card.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional

# policy actions returned by RecoveryPolicy.observe()
OK = "ok"
SKIP = "skip"
ROLLBACK = "rollback"
# event kind for a skip whose verdict was VOTED across dp replicas (the
# consensus path) — the policy treats it exactly like SKIP, trackers see the
# distinct kind so fleet-wide agreement is auditable post-hoc
CONSENSUS_SKIP = "consensus_skip"


@dataclasses.dataclass(frozen=True)
class ResilienceConfig:
    """Knobs for both halves of the resilience contract.

    The device-side gate and the loop-side policy read the same config:
    ``TrainSession`` threads ``TrainConfig.resilience`` into the step
    *and* into ``run_training`` so the two stay in sync.
    """

    enabled: bool = True
    # --- in-step skip gate (device side) ---------------------------------
    # a step is skipped (zero-update) when grads are non-finite, or when the
    # grad-norm is BOTH a statistical outlier (z > zscore_threshold against
    # the accepted-step EMA/variance) AND a multiplicative one
    # (norm > spike_factor * EMA) — the conjunction keeps a tightly-converged
    # variance from flagging harmless 2x wiggles, and a loose variance from
    # hiding a genuine 100x blow-up.
    zscore_threshold: float = 8.0
    spike_factor: float = 10.0
    ema_decay: float = 0.99
    warmup_steps: int = 20          # accepted steps before the z-gate arms
    # --- cross-replica skip consensus (device side, fleet) ---------------
    # On a dp>1 mesh a verdict reached on one replica but not another desyncs
    # every collective that follows: consensus computes a LOCAL verdict per
    # data-parallel replica (from that replica's own batch shard) and reduces
    # it across the replica axis inside the step (on a real fleet that
    # reduction is the cross-dp collective), so every replica sees the
    # identical voted bit and the zero-update is taken (or not) fleet-wide,
    # bit-identically.  A *minority* of bad replicas is masked out of the
    # gradient accumulation (survivor-renormalized, like GAS micro masking)
    # instead of skipping the step; the full skip fires only when the vote
    # says the step is unsalvageable.  dp=1 (and consensus off) keeps the
    # PR-8 single-verdict path bit-for-bit.
    consensus: bool = True
    consensus_replicas: int = 0     # 0 → infer dp·pods from the mesh; >0
    #                                 forces that many simulated replica
    #                                 groups (single-device fleet tests)
    mask_divergent_replicas: bool = True   # minority bad → mask + continue;
    #                                        False → any bad replica skips
    # --- loop recovery policy (host side) --------------------------------
    max_consecutive_skips: int = 3  # K skips → rollback to last good ckpt
    rewarm_steps: int = 10          # linear LR re-warm after a rollback
    skip_window_margin: int = 0     # extra batches to drop past the window


@dataclasses.dataclass
class ResilienceEvent:
    """One structured recovery-path transition (also mirrored to trackers)."""

    step: int
    kind: str                       # skip | consensus_skip | rollback |
    #                                 rollback_unavailable | straggler |
    #                                 replica_lost | replan |
    #                                 replan_unavailable | ckpt_write_failed |
    #                                 preempt
    detail: Dict[str, Any] = dataclasses.field(default_factory=dict)


def _scalar(metrics: Dict[str, Any], key: str, default: float = 0.0) -> float:
    v = metrics.get(key)
    if v is None:
        return default
    return float(v)


class RecoveryPolicy:
    """Host-side skip/rollback state machine.

    ``observe(step, metrics)`` consumes the in-step signals (``skipped``,
    ``grad_norm``, ``all_finite`` — scalars already coming back with the
    step's metrics) and returns OK, SKIP, or ROLLBACK.  The loop owns the
    actual rollback; ``on_rollback`` resets the streak and records the event.
    ``healthy`` gates checkpoint writes so a skip-streak can never be
    checkpointed as if it were good progress.
    """

    def __init__(self, cfg: Optional[ResilienceConfig] = None):
        self.cfg = cfg if cfg is not None else ResilienceConfig()
        self.consecutive_skips = 0
        self.n_skipped = 0
        self.n_rollbacks = 0
        self.events: List[ResilienceEvent] = []

    @property
    def healthy(self) -> bool:
        return self.consecutive_skips == 0

    def observe(self, step: int, metrics: Dict[str, Any]) -> str:
        if not self.cfg.enabled:
            return OK
        skipped = _scalar(metrics, "skipped") > 0.5
        if not skipped:
            self.consecutive_skips = 0
            return OK
        self.consecutive_skips += 1
        self.n_skipped += 1
        # a verdict voted across >1 replicas is logged under its own kind so
        # the fleet-wide agreement is auditable; the state machine is blind
        # to the difference (the voted bit already IS the agreed decision)
        voted = _scalar(metrics, "n_replicas", 1.0) > 1.0
        self.events.append(ResilienceEvent(
            step, CONSENSUS_SKIP if voted else SKIP, {
                "grad_norm": _scalar(metrics, "grad_norm", float("nan")),
                "all_finite": _scalar(metrics, "all_finite", 1.0),
                "gnorm_z": _scalar(metrics, "gnorm_z"),
                "bad_replicas": _scalar(metrics, "bad_replicas"),
                "n_replicas": _scalar(metrics, "n_replicas", 1.0),
                "consecutive": self.consecutive_skips,
            }))
        if self.consecutive_skips >= self.cfg.max_consecutive_skips:
            return ROLLBACK
        return SKIP

    def on_rollback(self, step: int, restored_step: Optional[int],
                    **detail) -> None:
        self.consecutive_skips = 0
        if restored_step is None:
            self.events.append(
                ResilienceEvent(step, "rollback_unavailable", dict(detail)))
            return
        self.n_rollbacks += 1
        self.events.append(ResilienceEvent(step, ROLLBACK, {
            "restored_step": restored_step, **detail}))
