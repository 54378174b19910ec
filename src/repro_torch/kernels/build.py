"""Build the hand-written CUDA kernels in ``csrc/`` and load them with ctypes.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled by its
own ``nvcc`` (all started together) into ``build/repro_torch_kernels/`` at
the repository root, which ``.gitignore`` lists.  A library is named by the
hash of its source, the shared headers and the flags, so a changed source is
rebuilt and an unchanged one is loaded as it is.  Nothing is built when this
module is imported: the first kernel launch (or :func:`build_all`) builds.

The sources and the build directory are found relative to this file, so
the port runs from a checkout or an editable install (``pip install -e
.[torch]``) only: a plain install ships no ``csrc/`` and :func:`build_all`
then raises.

Every kernel wrapper adds one to ``launch_counts[<name>]`` where it launches
its kernel, and nowhere else, so a run can show which kernels it went
through: ``flash_fwd`` (K1), ``flash_delta``, ``flash_dq`` and
``flash_dkv`` (K2-K4, one library, ``flash_bwd``) and ``decode_attention``
(K5).
"""

from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
KERNELS = ("flash_fwd", "flash_bwd", "decode_attention")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

launch_counts: collections.Counter = collections.Counter()
_loaded: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    cands = [shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"]
    if os.environ.get("CUDA_HOME"):
        cands.insert(0, str(Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc"))
    for c in cands:
        if c and Path(c).is_file():
            return c
    raise RuntimeError("nvcc not found (looked in CUDA_HOME, PATH and "
                       "/usr/local/cuda/bin): the CUDA kernels cannot be built")


def _digest(name: str) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))]:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def library_path(name: str) -> Path:
    return BUILD_DIR / f"{name}-{_digest(name)}.so"


def build_all() -> Dict[str, Path]:
    """Compile every kernel whose library is missing, one ``nvcc`` per
    source, all in parallel.  Raises with the compiler's output on failure.
    Returns {name: library path}; ``<path>.log`` holds ptxas's report."""
    if not all((CSRC / f"{n}.cu").is_file() for n in KERNELS):
        raise RuntimeError(f"CUDA sources not found in {CSRC}: the port runs from a "
                           "checkout or an editable install (pip install -e .[torch])")
    paths = {n: library_path(n) for n in KERNELS}
    todo = {n: p for n, p in paths.items() if not p.exists()}
    if not todo:
        return paths
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for n, p in todo.items():
        tmp = p.with_suffix(f".tmp{os.getpid()}")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{n}.cu")]
        procs[n] = (tmp, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                          stderr=subprocess.STDOUT, text=True))
    failed = []
    for n, (tmp, proc) in procs.items():
        out, _ = proc.communicate()
        Path(f"{paths[n]}.log").write_text(out)
        if proc.returncode != 0:
            failed.append(f"--- nvcc {n}.cu (exit {proc.returncode}) ---\n{out}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, paths[n])
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return paths


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if needed."""
    lib = _loaded.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build_all()[name]))
        _loaded[name] = lib
    return lib


def check(rc: int, name: str) -> None:
    """Raise if a C entry point reported an error (its ``cudaGetLastError()``
    after the launch, or an argument it refused)."""
    if rc != 0:
        raise RuntimeError(f"{name}: kernel launch failed with CUDA error {rc}")
