"""Straggler / hang mitigation: a per-step deadline monitor (a copy of
``repro.runtime.watchdog``).

On a real fleet the callback triggers the preempt-and-restart path (SLURM
requeue / GKE eviction) for the slow replica; here the clock is injectable so
the behaviour is unit-testable without wall-time.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, List, Optional


class StepWatchdog:
    def __init__(self, deadline_s: float, on_timeout: Callable[[int, float], None],
                 clock: Callable[[], float] = time.monotonic,
                 poll_interval: float = 0.05):
        self.deadline_s = deadline_s
        self.on_timeout = on_timeout
        self.clock = clock
        self.poll = poll_interval
        self._step = -1
        self._started_at: Optional[float] = None
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._fired_for = set()
        self._thread: Optional[threading.Thread] = None
        self.step_times: List[float] = []

    def start(self):
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def begin_step(self, step: int):
        with self._lock:
            self._step = step
            self._started_at = self.clock()

    def end_step(self, step: int):
        with self._lock:
            if self._started_at is not None:
                self.step_times.append(self.clock() - self._started_at)
            self._started_at = None

    def check_once(self):
        """Single poll (used directly by tests with a fake clock)."""
        with self._lock:
            if self._started_at is None or self._step in self._fired_for:
                return
            elapsed = self.clock() - self._started_at
            if elapsed > self.deadline_s:
                self._fired_for.add(self._step)
                step, el = self._step, elapsed
            else:
                return
        self.on_timeout(step, el)

    def median_step_time(self) -> Optional[float]:
        if not self.step_times:
            return None
        s = sorted(self.step_times)
        return s[len(s) // 2]

    def last_step_time(self) -> Optional[float]:
        """Duration of the most recently completed step (None before any)."""
        return self.step_times[-1] if self.step_times else None

    def slowdown_factor(self) -> Optional[float]:
        """How much slower the last completed step ran than the median —
        the measured straggler signal the loop emits as a structured event
        and feeds the fleet's heartbeats (None until a positive median
        exists, so zero-duration fake-clock steps never divide by zero)."""
        med = self.median_step_time()
        last = self.last_step_time()
        if med is None or last is None or med <= 0:
            return None
        return last / med

    def is_straggling(self, factor: float = 2.0) -> bool:
        """Current step exceeding ``factor`` × median step time?"""
        med = self.median_step_time()
        with self._lock:
            if med is None or self._started_at is None:
                return False
            return (self.clock() - self._started_at) > factor * med

    def _run(self):
        while not self._stop.is_set():
            self.check_once()
            time.sleep(self.poll)

    def stop(self):
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=1.0)
