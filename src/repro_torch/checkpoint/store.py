"""Atomic, integrity-checked, mesh-independent checkpoints: a copy of
``repro.checkpoint.store`` over the port's train state.

The files are the reference's: a ``step_<N>`` directory of ``leaf_*.npy``
under the reference's leaf paths, stacked (L, ...) blocks and dtypes
(``checkpoint.bridge.state_to_numpy``), and a ``manifest.json`` with a
sha256 per leaf, so either package restores the other's checkpoints.  The
snapshot copies every leaf to the host before ``save_checkpoint`` returns:
the port's optimizer updates the state in place, so a background write of
views would record a later step.  A restore returns the state's tensors on
the template's device, or on the one it is given (a mesh reads the whole
state on the host and keeps its shards).

Fault-tolerance contract:
  * atomic: leaves are written into ``step_<N>.tmp`` and the directory is
    renamed only after every file + manifest is fsynced — a crash mid-write
    never corrupts the restore path; orphaned ``.tmp`` dirs from a writer that
    died mid-write are garbage-collected on the next save;
  * integrity: the manifest carries a sha256 per leaf; restore verifies and
    falls back to the previous step if anything is damaged;
  * mesh-independent: params are canonicalized (pipeline stage axis unstacked)
    before writing, so a checkpoint taken under (pp=8, tp=16) restores under
    any other plan — this is what makes elastic re-scaling work;
  * async: ``save_checkpoint(..., background=True)`` snapshots to host memory
    and writes on a thread, returning a ``CheckpointWriter`` handle whose
    ``join()`` re-raises writer failures — a failed background write can never
    silently leave training believing it has a checkpoint it doesn't;
  * flaky-I/O tolerant: writes and reads run under an injectable
    ``RetryPolicy`` (bounded attempts, exponential backoff), and restore
    fallbacks are reported through an injectable ``log`` instead of stdout.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import shutil
import threading
import time
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.checkpoint.bridge import BF16_RECORD, state_from_numpy, state_leaves, to_host


class CheckpointError(RuntimeError):
    pass


@dataclasses.dataclass
class RetryPolicy:
    """Bounded-retry/backoff for flaky checkpoint I/O (Lustre hiccups, NFS
    timeouts).  ``sleep`` is injectable so tests run without wall-time."""

    attempts: int = 3
    backoff_s: float = 0.05
    multiplier: float = 2.0
    sleep: Callable[[float], None] = time.sleep

    def run(self, fn: Callable[[], Any], *, describe: str = "checkpoint I/O",
            log: Optional[Callable[[str], None]] = None) -> Any:
        delay = self.backoff_s
        last: Optional[BaseException] = None
        for attempt in range(max(1, self.attempts)):
            try:
                return fn()
            except Exception as e:           # noqa: BLE001 — surfaced below
                last = e
                if log is not None:
                    log(f"[checkpoint] {describe} failed "
                        f"(attempt {attempt + 1}/{self.attempts}): {e}")
                if attempt + 1 < self.attempts:
                    self.sleep(delay)
                    delay *= self.multiplier
        assert last is not None
        raise last


class CheckpointWriter:
    """Result handle for a background checkpoint write.

    The writer thread stores any exception (after the retry policy is
    exhausted) instead of dying silently; ``join()`` re-raises it, and
    ``exception()`` exposes it for callers that prefer log-and-continue
    (``run_training`` surfaces it as a structured ``ckpt_write_failed``
    event and keeps training on the previous checkpoint)."""

    def __init__(self, step: int):
        self.step = step
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def _run(self, fn: Callable[[], None]) -> None:
        try:
            fn()
        except BaseException as e:           # noqa: BLE001 — stored, not lost
            self._error = e

    def _start(self, fn: Callable[[], None]) -> "CheckpointWriter":
        self._thread = threading.Thread(target=self._run, args=(fn,),
                                        daemon=True)
        self._thread.start()
        return self

    def done(self) -> bool:
        return self._thread is None or not self._thread.is_alive()

    def exception(self, timeout: Optional[float] = None) -> Optional[BaseException]:
        if self._thread is not None:
            self._thread.join(timeout)
        return self._error

    def join(self, timeout: Optional[float] = None, *,
             reraise: bool = True) -> None:
        if self._thread is not None:
            self._thread.join(timeout)
        if reraise and self._error is not None:
            raise self._error


def _sha(arr: np.ndarray) -> str:
    """The reference's digest (sha256 of the array's bytes), without copying
    them into a ``bytes`` object first."""
    raw = np.ascontiguousarray(arr).reshape(-1).view(np.uint8)
    return hashlib.sha256(memoryview(raw)).hexdigest()[:16]


def _dtype_name(arr: np.ndarray) -> str:
    return "bfloat16" if arr.dtype == BF16_RECORD else str(arr.dtype)


def _gc_orphan_tmps(directory: Path, current: Optional[str] = None) -> None:
    """Remove ``step_*.tmp`` left behind by a writer that died mid-write."""
    for p in directory.glob("step_*.tmp"):
        if p.name != current:
            shutil.rmtree(p, ignore_errors=True)


def save_checkpoint(directory: str | Path, step: int, state, *,
                    extra: Optional[Dict[str, Any]] = None,
                    background: bool = False,
                    keep: int = 3,
                    retry: Optional[RetryPolicy] = None,
                    log: Optional[Callable[[str], None]] = None,
                    fault_hook: Optional[Callable[[int], None]] = None
                    ) -> CheckpointWriter | None:
    """Write ``state`` (the port's train state, or its host snapshot
    ``[(reference path, array)]``: ``elastic.host_snapshot``) for ``step``.

    Foreground (default): retries per ``retry`` and raises the final failure.
    ``background=True``: snapshots to host memory, writes on a thread, and
    returns a ``CheckpointWriter`` whose ``join()`` re-raises failures.
    ``fault_hook(i_leaf)`` is the chaos-harness injection point (called before
    each leaf write; may raise)."""
    directory = Path(directory)
    directory.mkdir(parents=True, exist_ok=True)
    retry = retry if retry is not None else RetryPolicy()
    # snapshot to host memory first: copies, since the next step updates the
    # state in place
    host = state if isinstance(state, list) else [(k, to_host(v)) for k, v in state_leaves(state)]

    def write_once():
        tmp = directory / f"step_{step:08d}.tmp"
        final = directory / f"step_{step:08d}"
        _gc_orphan_tmps(directory, current=tmp.name)
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir()
        manifest = {"step": step, "extra": extra or {}, "leaves": {}}
        for i, (key, arr) in enumerate(host):
            if fault_hook is not None:
                fault_hook(i)
            fn = f"leaf_{i:05d}.npy"
            np.save(tmp / fn, arr)
            manifest["leaves"][key] = {
                "file": fn, "shape": list(arr.shape), "dtype": _dtype_name(arr),
                "sha": _sha(arr),
            }
        with open(tmp / "manifest.json", "w") as f:
            json.dump(manifest, f)
            f.flush()
            os.fsync(f.fileno())
        if final.exists():
            shutil.rmtree(final)
        os.rename(tmp, final)
        _gc(directory, keep)

    def write():
        retry.run(write_once, describe=f"write step {step}", log=log)

    if background:
        return CheckpointWriter(step)._start(write)
    write()
    return None


def _gc(directory: Path, keep: int):
    steps = sorted(list_steps(directory))
    for s in steps[:-keep]:
        shutil.rmtree(directory / f"step_{s:08d}", ignore_errors=True)


def list_steps(directory: str | Path) -> List[int]:
    directory = Path(directory)
    if not directory.exists():
        return []
    out = []
    for p in directory.iterdir():
        if p.is_dir() and p.name.startswith("step_") and not p.name.endswith(".tmp"):
            if (p / "manifest.json").exists():
                out.append(int(p.name[5:]))
    return sorted(out)


def _load_step(directory: Path, step: int, template,
               fault_hook: Optional[Callable[[], None]] = None, device=None
               ) -> Tuple[Any, Dict[str, Any]]:
    if fault_hook is not None:
        fault_hook()
    d = directory / f"step_{step:08d}"
    with open(d / "manifest.json") as f:
        manifest = json.load(f)
    flat = state_leaves(template)
    keys = [k for k, _ in flat]
    leaves = {}
    for key in keys:
        meta = manifest["leaves"].get(key)
        if meta is None:
            raise CheckpointError(f"step {step}: missing leaf {key}")
        arr = np.load(d / meta["file"])
        if _sha(arr) != meta["sha"]:
            raise CheckpointError(f"step {step}: corrupt leaf {key}")
        if meta["dtype"] == "bfloat16":
            arr = arr.view(BF16_RECORD)
        leaves[key] = arr
    if device is None:
        first = flat[0][1]
        device = (first[0] if isinstance(first, list) else first).device
    # every leaf is verified before one is placed on the template's device:
    # a corrupt step leaves no partial state behind
    return state_from_numpy(leaves, device=device), manifest["extra"]


def restore_step(directory: str | Path, step: int, template, *,
                 retry: Optional[RetryPolicy] = None,
                 log: Optional[Callable[[str], None]] = None,
                 fault_hook: Optional[Callable[[], None]] = None, device=None):
    load = lambda: _load_step(Path(directory), step, template, fault_hook, device)
    if retry is None:
        return load()
    return retry.run(load, describe=f"read step {step}", log=log)


def restore_latest(directory: str | Path, template, *,
                   retry: Optional[RetryPolicy] = None,
                   log: Optional[Callable[[str], None]] = None,
                   fault_hook: Optional[Callable[[], None]] = None, device=None):
    """Restore the newest valid checkpoint, skipping corrupt ones, onto
    ``device`` (the template's by default).

    Transient read errors are retried per ``retry`` before the step is given
    up on; fallbacks are reported through ``log`` (defaults to stdout) so
    recovery events are observable in JSONL trackers, not lost on a console.
    Returns (state, extra, step) or (None, None, None)."""
    directory = Path(directory)
    log = log if log is not None else print
    for step in reversed(list_steps(directory)):
        try:
            state, extra = restore_step(directory, step, template, retry=retry,
                                        log=log, fault_hook=fault_hook, device=device)
            return state, extra, step
        except (CheckpointError, OSError, ValueError) as e:  # corrupt → older
            log(f"[checkpoint] step {step} unusable ({e}); trying older")
    return None, None, None
