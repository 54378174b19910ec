"""Fault-injection harness for the training loop, a copy of
``repro.runtime.chaos`` (which replaced ``fail_at_step``).

A ``FaultPlan`` declares *which* faults hit *when*; ``run_training`` (and
``TrainSession.run(chaos=...)``) threads it through every recovery path so
each fault class is exercised end-to-end, not just unit-mocked:

* ``nan_grad_steps`` / ``spike_steps`` / ``nan_micro`` — poison the gradients
  of specific **data indices** (not loop steps: after a rollback fast-forwards
  the cursor past the window, the poison is genuinely gone, like a bad shard
  that got skipped).  Injection works by attaching a per-micro-batch
  ``_chaos_grad_scale`` vector to the batch (a numpy array, which
  ``TrainSession`` moves to the device with the rest of the batch);
  ``stepfn`` multiplies gradients by it inside the step, so the real
  detection/masking machinery sees genuinely non-finite grads.
* ``crash_at`` — raise mid-loop (the restart drill formerly spelled
  ``fail_at_step``).
* ``sigterm_at`` — deliver a real SIGTERM to this process (preemption drill).
* ``slow_steps`` — stall inside the step window so the ``StepWatchdog``
  deadline thread fires (``sleep`` is injectable for fake-clock tests).
* ``ckpt_write_failures`` / ``ckpt_partial_leaf`` / ``ckpt_read_failures`` —
  fail checkpoint I/O attempts (transiently, or mid-write leaving an orphaned
  ``.tmp``) to exercise the retry policy and corrupt-fallback paths.
* ``replica_nan`` / ``replica_spike`` — poison ONE replica's gradients (data
  index keyed, ``replicas`` rows in the scale matrix): the skip-consensus
  vote must mask exactly that replica, fleet-wide and bit-identically.
* ``lose_replica`` / ``straggle_replica`` — node loss and persistent
  stragglers (loop-step keyed), feeding the ``FleetController`` liveness
  tracker so the elastic ``replan()`` path is exercised end-to-end.

Every injection is recorded in ``injected`` so tests and the resilience
benchmark can assert exactly what fired.
"""

from __future__ import annotations

import dataclasses
import os
import signal
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np


class ChaosError(RuntimeError):
    """An injected fault (so tests can tell chaos from real failures)."""


@dataclasses.dataclass
class FaultPlan:
    # gradient anomalies, keyed by DATA INDEX (step + data_offset)
    nan_grad_steps: Tuple[int, ...] = ()
    spike_steps: Tuple[int, ...] = ()
    spike_scale: float = 1e4
    nan_micro: Dict[int, Tuple[int, ...]] = dataclasses.field(
        default_factory=dict)          # data index -> micro-batch indices
    gas: int = 1                       # width of the _chaos_grad_scale vector

    # fleet faults: per-REPLICA gradient divergence (data-index keyed — the
    # consensus vote must mask exactly the injected replica), replica loss
    # and persistent stragglers (loop-step keyed — they drive the
    # ``FleetController`` re-plan state machine)
    replicas: int = 1                  # replica rows of the chaos scale matrix
    replica_nan: Dict[int, Tuple[int, ...]] = dataclasses.field(
        default_factory=dict)          # data index -> replica ids (NaN grads)
    replica_spike: Dict[int, Tuple[int, ...]] = dataclasses.field(
        default_factory=dict)          # data index -> replica ids (finite
    #                                    divergence at ``spike_scale``)
    lose_replica: Dict[int, int] = dataclasses.field(
        default_factory=dict)          # loop step -> replica id lost
    straggle_replica: Dict[int, Tuple[int, float]] = dataclasses.field(
        default_factory=dict)          # replica id -> (from loop step,
    #                                    slowdown factor on its heartbeats)

    # control-flow faults, keyed by LOOP STEP
    crash_at: Optional[int] = None
    sigterm_at: Optional[int] = None
    slow_steps: Dict[int, float] = dataclasses.field(default_factory=dict)
    sleep: Callable[[float], None] = time.sleep

    # checkpoint I/O faults (consumed in order, one per attempt)
    ckpt_write_failures: int = 0       # fail this many write attempts outright
    ckpt_partial_leaf: Optional[int] = None  # die once, after N leaves written
    ckpt_read_failures: int = 0        # fail this many restore read attempts

    # record of everything that actually fired: (where, kind)
    injected: List[Tuple[int, str]] = dataclasses.field(default_factory=list)

    # ------------------------------------------------------------------
    # gradient poisoning (rides the batch into the step)
    # ------------------------------------------------------------------
    def _poisons_grads(self) -> bool:
        return bool(self.nan_grad_steps or self.spike_steps or self.nan_micro
                    or self.replica_nan or self.replica_spike)

    def grad_scale(self, data_index: int) -> Optional[np.ndarray]:
        """Per-micro gradient scale for this data index (None = no injection
        configured at all, so batches stay untouched).  With ``replicas > 1``
        the vector is the flattened (replicas, gas) matrix the consensus
        path consumes — replica faults poison one row."""
        if not self._poisons_grads():
            return None
        R, G = max(1, self.replicas), max(1, self.gas)
        s = np.ones((R, G), np.float32)
        if data_index in self.nan_grad_steps:
            s[:] = np.nan
            self.injected.append((data_index, "nan_grads"))
        if data_index in self.spike_steps:
            s[:] = self.spike_scale
            self.injected.append((data_index, "grad_spike"))
        for m in self.nan_micro.get(data_index, ()):
            s[:, m] = np.nan
            self.injected.append((data_index, f"nan_micro_{m}"))
        for r in self.replica_nan.get(data_index, ()):
            s[r, :] = np.nan
            self.injected.append((data_index, f"replica_nan_{r}"))
        for r in self.replica_spike.get(data_index, ()):
            s[r, :] = self.spike_scale
            self.injected.append((data_index, f"replica_spike_{r}"))
        return s.reshape(-1)

    def wrap_batches(self, batches: Callable[[int], dict]) -> Callable[[int], dict]:
        """Attach ``_chaos_grad_scale`` (numpy, f32) to every batch; identity
        when no grad faults are planned."""
        if not self._poisons_grads():
            return batches

        def wrapped(i: int) -> dict:
            b = dict(batches(i))
            b["_chaos_grad_scale"] = self.grad_scale(i)
            return b

        return wrapped

    # ------------------------------------------------------------------
    # control-flow faults
    # ------------------------------------------------------------------
    def maybe_crash(self, step: int) -> None:
        if self.crash_at is not None and step == self.crash_at:
            self.injected.append((step, "crash"))
            raise RuntimeError(f"injected failure at step {step}")

    def maybe_sigterm(self, step: int) -> None:
        if self.sigterm_at is not None and step == self.sigterm_at:
            self.injected.append((step, "sigterm"))
            os.kill(os.getpid(), signal.SIGTERM)

    def maybe_slow(self, step: int) -> None:
        d = self.slow_steps.get(step)
        if d:
            self.injected.append((step, "slow_step"))
            self.sleep(d)

    # ------------------------------------------------------------------
    # fleet faults (consumed by the loop's FleetController wiring)
    # ------------------------------------------------------------------
    def maybe_lose_replica(self, step: int) -> Optional[int]:
        """Replica lost at this loop step (the node-loss drill): returns the
        replica id once, None otherwise."""
        r = self.lose_replica.get(step)
        if r is not None:
            del self.lose_replica[step]      # fire once
            self.injected.append((step, "replica_lost"))
        return r

    def peer_step_time(self, replica: int, step: int, local_s: float) -> float:
        """Simulated peer heartbeat: replica ``replica``'s reported step time,
        derived from the local one.  A persistent-straggler fault multiplies
        it by the configured slowdown from its start step on."""
        fault = self.straggle_replica.get(replica)
        if fault is not None and step >= fault[0]:
            self.injected.append((step, f"straggle_replica_{replica}"))
            return local_s * fault[1]
        return local_s

    # ------------------------------------------------------------------
    # checkpoint I/O faults (hooks for checkpoint.store)
    # ------------------------------------------------------------------
    def ckpt_write_hook(self) -> Optional[Callable[[int], None]]:
        """Hook called before each leaf write: ``hook(i_leaf)`` may raise.
        Returns None when no write faults are planned (zero overhead)."""
        if self.ckpt_write_failures <= 0 and self.ckpt_partial_leaf is None:
            return None

        def hook(i_leaf: int) -> None:
            if self.ckpt_partial_leaf is not None and i_leaf >= self.ckpt_partial_leaf:
                self.ckpt_partial_leaf = None   # fire once
                self.injected.append((i_leaf, "ckpt_partial_write"))
                raise ChaosError("injected partial checkpoint write")
            if i_leaf == 0 and self.ckpt_write_failures > 0:
                self.ckpt_write_failures -= 1
                self.injected.append((0, "ckpt_write_fail"))
                raise ChaosError("injected checkpoint write failure")

        return hook

    def ckpt_read_hook(self) -> Optional[Callable[[], None]]:
        """Hook called before each checkpoint read attempt; raises a transient
        OSError while read failures remain."""
        if self.ckpt_read_failures <= 0:
            return None

        def hook() -> None:
            if self.ckpt_read_failures > 0:
                self.ckpt_read_failures -= 1
                self.injected.append((0, "ckpt_read_fail"))
                raise OSError("injected transient checkpoint read failure")

        return hook

    def counts(self) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for _, kind in self.injected:
            out[kind] = out.get(kind, 0) + 1
        return out
