"""Training resilience, the device side: ``ResilienceConfig``, a copy of
``repro.runtime.resilience.ResilienceConfig``.

The single-device train step (``core.stepfn.make_train_step``) reads it for
its in-step skip gate: a step whose gradients are non-finite, or whose
gradient norm is both a z-score and a multiplicative outlier against the
EMA of accepted steps, becomes a zero-update.  The loop side (the
``RecoveryPolicy`` with rollback and re-warm) comes with the training
loop's port; the consensus across data-parallel replicas with the fleet's.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ResilienceConfig:
    enabled: bool = True
    # --- in-step skip gate (device side) ---------------------------------
    zscore_threshold: float = 8.0
    spike_factor: float = 10.0
    ema_decay: float = 0.99
    warmup_steps: int = 20          # accepted steps before the z-gate arms
    # --- cross-replica skip consensus (device side, fleet) ---------------
    consensus: bool = True
    consensus_replicas: int = 0     # 0 → dp·pods of the mesh; >0 simulates
    mask_divergent_replicas: bool = True
    # --- loop recovery policy (host side) --------------------------------
    max_consecutive_skips: int = 3
    rewarm_steps: int = 10          # linear LR re-warm after a rollback
    skip_window_margin: int = 0
