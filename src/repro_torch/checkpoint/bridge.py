"""The weight bridge: the reference's parameters into the port's model.

The reference names each parameter leaf by its ``/``-joined pytree path
(``repro/checkpoint/store.py:_flatten``): ``embed``, ``blocks/attn/wq``,
``blocks/mlp/w_gate``, ``final_norm/scale``, ...  Its stacked ``blocks/*``
leaves are (L, ...) and become the port's list of L per-layer dicts.  A
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


def params_from_numpy(flat: Mapping[str, Any]) -> Dict[str, Any]:
    """``{path: array}`` of the reference's parameters → the port's parameter
    dict (CPU tensors, dtypes as given).  A leading ``params/`` (a training
    state's checkpoint) is dropped."""
    tree: Dict[str, Any] = {}
    for key, arr in flat.items():
        parts = key.split("/")
        if parts[0] == "params":
            parts = parts[1:]
        t = arr if isinstance(arr, torch.Tensor) else _to_tensor(np.asarray(arr))
        if parts[0] == BLOCKS:
            blocks = tree.setdefault(BLOCKS, [{} for _ in range(t.shape[0])])
            if len(blocks) != t.shape[0]:
                raise ValueError(f"{key}: {t.shape[0]} layers, expected {len(blocks)}")
            for layer, sub in zip(blocks, t.unbind(0)):
                _set(layer, parts[1:], sub.clone())
        else:
            _set(tree, parts, t)
    return tree


def _set(tree: Dict[str, Any], parts, value) -> None:
    for p in parts[:-1]:
        tree = tree.setdefault(p, {})
    tree[parts[-1]] = value


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
