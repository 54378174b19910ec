"""The weight bridge: the reference's parameters into the port's model.

The reference names each leaf by its ``/``-joined pytree path
(``repro/checkpoint/store.py:_flatten``): ``embed``, ``blocks/attn/wq``,
``blocks/mlp/w_gate``, ``final_norm/scale``, ... and, in a train state,
``params/...``, ``opt/m/...``, ``opt/v/...``, ``opt/step``, ``step``,
``rstat/...`` and ``ef/...``.  Its stacked ``blocks`` leaves are (L, ...)
wherever they stand, and become the port's list of L per-layer dicts.  A
``save_checkpoint`` directory (``manifest.json`` + ``leaf_*.npy``) is read
with numpy alone; bf16 leaves, which numpy stores as raw 2-byte records,
are reinterpreted from their bits.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Any, Dict, Mapping, Union

import numpy as np
import torch

BLOCKS = "blocks"


def _to_tensor(arr: np.ndarray, dtype: str = "") -> torch.Tensor:
    if dtype == "bfloat16" or arr.dtype.name == "bfloat16":
        bits = np.ascontiguousarray(arr).view(np.uint16)
        return torch.from_numpy(bits.copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(arr, copy=True))


def _insert(tree: Dict[str, Any], parts, t: torch.Tensor, key: str) -> None:
    """Set leaf ``t`` at ``parts``; below a ``blocks`` node the stacked leaf
    is split along its first axis into the per-layer dicts."""
    for i, p in enumerate(parts[:-1]):
        if p == BLOCKS:
            blocks = tree.setdefault(BLOCKS, [{} for _ in range(t.shape[0])])
            if len(blocks) != t.shape[0]:
                raise ValueError(f"{key}: {t.shape[0]} layers, expected {len(blocks)}")
            for layer, sub in zip(blocks, t.unbind(0)):
                _insert(layer, parts[i + 1:], sub.clone(), key)
            return
        tree = tree.setdefault(p, {})
    tree[parts[-1]] = t


def _tree(flat: Mapping[str, Any], drop: str = "") -> Dict[str, Any]:
    tree: Dict[str, Any] = {}
    for key, arr in flat.items():
        parts = key.split("/")
        if parts[0] == drop:
            parts = parts[1:]
        t = arr if isinstance(arr, torch.Tensor) else _to_tensor(np.asarray(arr))
        _insert(tree, parts, t, key)
    return tree


def params_from_numpy(flat: Mapping[str, Any]) -> Dict[str, Any]:
    """``{path: array}`` of the reference's parameters → the port's parameter
    dict (CPU tensors, dtypes as given).  A leading ``params/`` (a training
    state's checkpoint) is dropped."""
    return _tree(flat, drop="params")


def state_from_numpy(flat: Mapping[str, Any]) -> Dict[str, Any]:
    """``{path: array}`` of a whole reference train state (``params/…``,
    ``opt/m/…``, ``opt/v/…``, ``opt/step``, ``step``, ``rstat/…`` and, with
    int8 compression, ``ef/…``) → the port's train state (CPU tensors,
    dtypes as given), every stacked ``blocks`` leaf split per layer."""
    state = _tree(flat)
    missing = {"params", "opt", "step"} - set(state)
    if missing:
        raise ValueError(f"not a train state: {sorted(missing)} missing")
    return state


def load_reference_checkpoint(directory: Union[str, Path]) -> Dict[str, torch.Tensor]:
    """Read a reference checkpoint with numpy alone → ``{path: tensor}``.

    ``directory`` is one ``step_<N>`` directory, or a ``save_checkpoint``
    directory, of which the newest complete step is read."""
    d = Path(directory)
    if not (d / "manifest.json").exists():
        steps = sorted(p for p in d.glob("step_*")
                       if p.is_dir() and (p / "manifest.json").exists())
        if not steps:
            raise FileNotFoundError(f"no checkpoint step under {d}")
        d = steps[-1]
    manifest = json.loads((d / "manifest.json").read_text())
    out = {}
    for key, meta in manifest["leaves"].items():
        arr = np.load(d / meta["file"], allow_pickle=False)
        if list(arr.shape) != list(meta["shape"]):
            raise ValueError(f"{d}: leaf {key} has shape {arr.shape}, "
                             f"manifest says {meta['shape']}")
        out[key] = _to_tensor(arr, meta["dtype"])
    return out
