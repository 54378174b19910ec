"""The weight bridge: the reference's parameters and train states into the
port's, and the port's train states back into the reference's layout.

The reference names each leaf by its ``/``-joined pytree path
(``repro/checkpoint/store.py:_flatten``): ``embed``, ``blocks/attn/wq``,
``blocks/mlp/w_gate``, ``final_norm/scale``, ... and, in a train state,
``params/...``, ``opt/m/...``, ``opt/v/...``, ``opt/step``, ``step``,
``rstat/...`` and ``ef/...``.  Its stacked ``blocks`` leaves are (L, ...)
wherever they stand, and become the port's list of L per-layer dicts.  A
``save_checkpoint`` directory (``manifest.json`` + ``leaf_*.npy``) is read
with numpy alone; bf16 leaves, which numpy stores as raw 2-byte records,
are reinterpreted from their bits.

The write side, ``state_to_numpy``, is the inverse of ``state_from_numpy``:
the port's per-layer ``blocks`` lists restack into (L, ...) leaves under the
reference's paths, in the reference's leaf order (dict keys sorted), every
leaf a host copy that the live state can no longer change; bf16 leaves
become 2-byte void records, as numpy stores the reference's.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Any, Dict, List, Mapping, Tuple, Union

import numpy as np
import torch

BLOCKS = "blocks"


BF16_RECORD = np.dtype("V2")        # how numpy stores a bf16 array


def _to_tensor(arr: np.ndarray, dtype: str = "") -> torch.Tensor:
    """A CPU tensor over ``arr``'s memory (over a copy of a read-only
    array); bf16, given by name or as 2-byte records, from its bits."""
    if not arr.flags.writeable:
        arr = arr.copy()
    arr = np.asarray(arr, order="C")        # keeps a 0-d array 0-d
    if dtype == "bfloat16" or arr.dtype.name == "bfloat16" or arr.dtype == BF16_RECORD:
        return torch.from_numpy(arr.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def _insert(tree: Dict[str, Any], parts, t: torch.Tensor, key: str, device) -> None:
    """Set a copy of leaf ``t`` on ``device`` at ``parts``; below a
    ``blocks`` node the stacked leaf is split along its first axis into the
    per-layer dicts."""
    for i, p in enumerate(parts[:-1]):
        if p == BLOCKS:
            blocks = tree.setdefault(BLOCKS, [{} for _ in range(t.shape[0])])
            if len(blocks) != t.shape[0]:
                raise ValueError(f"{key}: {t.shape[0]} layers, expected {len(blocks)}")
            for layer, sub in zip(blocks, t.unbind(0)):
                _insert(layer, parts[i + 1:], sub, key, device)
            return
        tree = tree.setdefault(p, {})
    tree[parts[-1]] = t.to(device, copy=True)


def _tree(flat: Mapping[str, Any], drop: str = "", device="cpu") -> Dict[str, Any]:
    tree: Dict[str, Any] = {}
    for key, arr in flat.items():
        parts = key.split("/")
        if parts[0] == drop:
            parts = parts[1:]
        t = arr if isinstance(arr, torch.Tensor) else _to_tensor(np.asarray(arr))
        _insert(tree, parts, t, key, device)
    return tree


def params_from_numpy(flat: Mapping[str, Any]) -> Dict[str, Any]:
    """``{path: array}`` of the reference's parameters → the port's parameter
    dict (CPU tensors, dtypes as given).  A leading ``params/`` (a training
    state's checkpoint) is dropped."""
    return _tree(flat, drop="params")


def state_from_numpy(flat: Mapping[str, Any], *, device="cpu") -> Dict[str, Any]:
    """``{path: array}`` of a whole reference train state (``params/…``,
    ``opt/m/…``, ``opt/v/…``, ``opt/step``, ``step``, ``rstat/…`` and, with
    int8 compression, ``ef/…``) → the port's train state (tensors on
    ``device``, copied leaf by leaf, dtypes as given), every stacked
    ``blocks`` leaf split per layer."""
    state = _tree(flat, device=device)
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


def state_leaves(state: Mapping[str, Any], prefix: Tuple[str, ...] = ()
                 ) -> List[Tuple[str, Union[torch.Tensor, List[torch.Tensor]]]]:
    """[(reference path, leaf)] of a port tree in the reference's leaf order
    (dict keys sorted at every level).  Below a ``blocks`` list a leaf is
    the list of its L per-layer tensors, which the reference stacks."""
    out: List[Tuple[str, Any]] = []
    for k in sorted(state):
        v, path = state[k], prefix + (k,)
        if isinstance(v, dict):
            out += state_leaves(v, path)
        elif isinstance(v, list):
            layers = [dict(state_leaves(layer, path)) for layer in v]
            out += [(key, [layer[key] for layer in layers]) for key, _ in
                    state_leaves(v[0], path)]
        else:
            out.append(("/".join(path), v))
    return out


def to_host(leaf: Union[torch.Tensor, List[torch.Tensor]]) -> np.ndarray:
    """A host copy of one leaf of ``state_leaves`` (per-layer tensors stacked
    on a new first axis); bf16 as 2-byte records."""
    if isinstance(leaf, list):
        t = torch.empty((len(leaf), *leaf[0].shape), dtype=leaf[0].dtype)
        for row, x in zip(t, leaf):
            row.copy_(x.detach())
    else:
        t = leaf.detach().to("cpu", copy=True)
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(BF16_RECORD)
    return t.numpy()


def state_to_numpy(state: Mapping[str, Any]) -> Dict[str, np.ndarray]:
    """The port's train state → ``{path: array}`` in the reference's layout
    and leaf order (the inverse of ``state_from_numpy``).  Every array is a
    host copy: a later in-place update of the state does not reach it."""
    return {key: to_host(leaf) for key, leaf in state_leaves(state)}
