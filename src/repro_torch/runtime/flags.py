"""Process-wide dispatch flags: the part of ``repro.runtime.flags`` that the
port reads.

``fused_rmsnorm`` (from ``REPRO_FUSED_RMSNORM``, off unless ``"1"``, as in
the reference) sends ``kernels.ops.rmsnorm`` to K7; off, it takes the plain
oracle.  The reference's flash and decode flags have no counterpart: the
port dispatches its attention kernels by the tensor's device.
"""

from __future__ import annotations

import os
from contextlib import contextmanager

_FLAGS = {
    "fused_rmsnorm": os.environ.get("REPRO_FUSED_RMSNORM", "0") == "1",
}


def use_fused_rmsnorm() -> bool:
    return bool(_FLAGS["fused_rmsnorm"])


def set_flag(name: str, value) -> None:
    if name not in _FLAGS:
        raise KeyError(name)
    _FLAGS[name] = value


@contextmanager
def flag_ctx(**kv):
    old = {k: _FLAGS[k] for k in kv}   # KeyError on unknown flag names
    _FLAGS.update(kv)
    try:
        yield
    finally:
        _FLAGS.update(old)
