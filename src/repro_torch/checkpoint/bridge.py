"""The weight bridge: the reference's parameters and train states into the
port's, and the port's train states back into the reference's layout.

The reference names each leaf by its ``/``-joined pytree path
(``repro/checkpoint/store.py:_flatten``): ``embed``, ``blocks/attn/wq``,
``blocks/mlp/w_gate``, ``blocks/moe/router``, ``pre_blocks/0/mlp/w_up``
(a MoE config's unstacked dense layers), ``final_norm/scale``, ... and, in a train state,
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

On a mesh every rank bridges the whole state on the host and keeps its
shards (``core.sharding.shard_params`` for tp's slices and ZeRO-3's,
``shard_state`` for ZeRO's ``m``, ``v`` and ``ef``;
``checkpoint.elastic.reshard_state`` does both and moves only the shards to
the device), and a sharded state is gathered to the host leaf by leaf before
it is written (``elastic.host_snapshot``): the files never hold a shard.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Any, Callable, Dict, List, Mapping, Optional, Tuple, Union

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
    per-layer dicts, and a numbered node (``pre_blocks/<i>``, a list the
    reference keeps unstacked) is entry i of a list."""
    for i, p in enumerate(parts[:-1]):
        if p == BLOCKS:
            blocks = tree.setdefault(BLOCKS, [{} for _ in range(t.shape[0])])
            if len(blocks) != t.shape[0]:
                raise ValueError(f"{key}: {t.shape[0]} layers, expected {len(blocks)}")
            for layer, sub in zip(blocks, t.unbind(0)):
                _insert(layer, parts[i + 1:], sub, key, device)
            return
        if parts[i + 1].isdigit():
            entries = tree.setdefault(p, [])
            j = int(parts[i + 1])
            entries.extend({} for _ in range(j + 1 - len(entries)))
            _insert(entries[j], parts[i + 2:], t, key, device)
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
    (dict keys sorted at every level, list entries in order).  Below a
    ``blocks`` list a leaf is the list of its L per-layer tensors, which the
    reference stacks; another list (``pre_blocks``) is unstacked, its
    entries numbered in the path."""
    out: List[Tuple[str, Any]] = []
    for k in sorted(state):
        v, path = state[k], prefix + (k,)
        if isinstance(v, dict):
            out += state_leaves(v, path)
        elif isinstance(v, list) and k != BLOCKS:
            for i, entry in enumerate(v):
                out += state_leaves(entry, path + (str(i),))
        elif isinstance(v, list):
            layers = [dict(state_leaves(layer, path)) for layer in v]
            out += [(key, [layer[key] for layer in layers]) for key, _ in
                    state_leaves(v[0], path)]
        else:
            out.append(("/".join(path), v))
    return out


def to_host(leaf: Union[torch.Tensor, List[torch.Tensor]],
            fetch: Callable[[torch.Tensor], torch.Tensor] = torch.Tensor.detach,
            rows: Optional[List[List[int]]] = None) -> np.ndarray:
    """A host copy of one leaf of ``state_leaves`` (per-layer tensors stacked
    on a new first axis); bf16 as 2-byte records.  ``fetch(x)`` is copied in
    place of each tensor ``x``, one at a time (on a mesh: ``x`` gathered
    whole).  ``rows``: the i-th tensor's fetch holds several layers (the
    pipeline stages' i-th, gathered over the ``pp`` line), which land at
    layers ``rows[i]``."""
    xs = leaf if isinstance(leaf, list) else [leaf]
    n = len(xs) if rows is None else sum(map(len, rows))
    t = None
    for i, x in enumerate(xs):
        x = fetch(x)
        if t is None:
            lead = (n,) if isinstance(leaf, list) else ()
            t = torch.empty(lead + tuple(x.shape[rows is not None:]), dtype=x.dtype)
        if rows is not None:
            t[rows[i]] = x.cpu()
        else:
            (t[i] if isinstance(leaf, list) else t).copy_(x)
        del x
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(BF16_RECORD)
    return t.numpy()


def _stacked_block(key: str) -> bool:
    parts = key.split("/")
    return "blocks" in parts[:-1]


def unstack_pipeline(flat: Mapping[str, Any], plan) -> Dict[str, Any]:
    """The reference's pp-stacked tree (``{path: array}``; its block leaves
    ``(PP, L/PP, ...)`` or ``(VPP, PP, L/(PP·VPP), ...)`` under ``plan``)
    → the canonical ``(L, ...)`` leaves that ``state_from_numpy`` reads."""
    lead = 1 if plan.pp == 1 else (2 if plan.vpp == 1 else 3)
    return {k: (np.asarray(v).reshape((-1,) + np.shape(v)[lead:]) if _stacked_block(k)
                else v) for k, v in flat.items()}


def state_to_numpy(state: Mapping[str, Any]) -> Dict[str, np.ndarray]:
    """The port's train state → ``{path: array}`` in the reference's layout
    and leaf order (the inverse of ``state_from_numpy``).  Every array is a
    host copy: a later in-place update of the state does not reach it."""
    return {key: to_host(leaf) for key, leaf in state_leaves(state)}
