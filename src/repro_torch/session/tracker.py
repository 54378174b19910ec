"""Pluggable metrics trackers for the training loop (a copy of
``repro.session.tracker``).

A tracker is anything with ``log_metrics(step, metrics)`` / ``finish()`` —
the protocol is deliberately tiny so wandb/tensorboard adapters are a dozen
lines.  ``TrainSession.run(tracker=...)`` threads one through the
fault-tolerant loop (every logged step lands in the tracker as well as the
returned history).
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, Protocol, Sequence, Union, runtime_checkable

Scalar = Union[int, float]

# The structured recovery/lifecycle event kinds the loop emits (the closed
# vocabulary dashboards and tests key on — ``runtime.train_loop`` and
# ``runtime.resilience`` are the only writers):
#   skip                 anomalous update zero'd (single-replica verdict)
#   consensus_skip       same, but the verdict was VOTED across dp replicas
#   rollback             K consecutive skips → restored last good checkpoint
#   rollback_unavailable rollback wanted, no checkpoint to restore
#   straggler            slow step: source=deadline|measured|fleet
#   replica_lost         a data-parallel replica left the fleet
#   replan               elastic re-plan completed (old/new plan, steps_lost)
#   replan_unavailable   re-plan wanted but impossible (no plan slack / no
#                        step factory)
#   ckpt_write_failed    checkpoint write failed after retries
#   preempt              SIGTERM received, emergency checkpoint attempted
RECOVERY_EVENT_KINDS = (
    "skip", "consensus_skip", "rollback", "rollback_unavailable",
    "straggler", "replica_lost", "replan", "replan_unavailable",
    "ckpt_write_failed", "preempt")


@runtime_checkable
class Tracker(Protocol):
    def log_metrics(self, step: int, metrics: Dict[str, Scalar]) -> None:
        """Record one step's scalar metrics."""

    def finish(self) -> None:
        """Flush and release resources; the tracker may not be used after."""


def log_event(tracker, step: int, kind: str, payload: Dict[str, object]) -> None:
    """Emit a structured recovery/lifecycle event (skip, rollback, straggler,
    ckpt_write_failed, preempt, ...) through ``tracker`` if it supports
    events — minimal trackers that only implement the metrics protocol are
    silently tolerated."""
    fn = getattr(tracker, "log_event", None)
    if tracker is not None and fn is not None:
        fn(step, kind, payload)


def _scalarize(metrics: Dict[str, object]) -> Dict[str, Scalar]:
    """Coerce 0-d tensors and numpy scalars to plain python scalars (JSON-safe);
    short lists of scalars (e.g. a forensics event's ``bad_micros``) pass
    through as-is."""
    out: Dict[str, Scalar] = {}
    for k, v in metrics.items():
        if isinstance(v, (int, float, str, bool, list)) or v is None:
            out[k] = v
        else:
            out[k] = float(v)
    return out


class NullTracker:
    """Default no-op sink."""

    def log_metrics(self, step: int, metrics: Dict[str, Scalar]) -> None:
        pass

    def log_event(self, step: int, kind: str, payload: Dict[str, object]) -> None:
        pass

    def finish(self) -> None:
        pass


class JsonlTracker:
    """Append-only JSONL file: one ``{"step": ..., **metrics}`` object per
    line.  Opens lazily, flushes per line (a preempted run keeps every logged
    step), and is idempotent under ``finish()``."""

    def __init__(self, path: Union[str, Path]):
        self.path = Path(path)
        self._fh = None

    def _write(self, row: Dict[str, object]) -> None:
        if self._fh is None:
            self.path.parent.mkdir(parents=True, exist_ok=True)
            self._fh = self.path.open("a")
        self._fh.write(json.dumps(row) + "\n")
        self._fh.flush()

    def log_metrics(self, step: int, metrics: Dict[str, Scalar]) -> None:
        self._write({"step": int(step), **_scalarize(metrics)})

    def log_event(self, step: int, kind: str, payload: Dict[str, object]) -> None:
        self._write({"event": kind, "step": int(step), **_scalarize(payload)})

    def finish(self) -> None:
        if self._fh is not None:
            self._fh.close()
            self._fh = None


class InMemoryTracker:
    """Keeps rows (and events) in lists — handy for tests and ad-hoc
    analysis."""

    def __init__(self):
        self.rows = []
        self.events = []
        self.finished = False

    def log_metrics(self, step: int, metrics: Dict[str, Scalar]) -> None:
        self.rows.append({"step": int(step), **_scalarize(metrics)})

    def log_event(self, step: int, kind: str, payload: Dict[str, object]) -> None:
        self.events.append({"event": kind, "step": int(step),
                            **_scalarize(payload)})

    def finish(self) -> None:
        self.finished = True


class CompositeTracker:
    """Fan one stream of metrics out to several trackers."""

    def __init__(self, trackers: Sequence[Tracker]):
        self.trackers = list(trackers)

    def log_metrics(self, step: int, metrics: Dict[str, Scalar]) -> None:
        for t in self.trackers:
            t.log_metrics(step, metrics)

    def log_event(self, step: int, kind: str, payload: Dict[str, object]) -> None:
        for t in self.trackers:
            log_event(t, step, kind, payload)

    def finish(self) -> None:
        for t in self.trackers:
            t.finish()
