"""Nests of dicts and lists of tensors: the port's parameter and state trees
(the reference's pytrees, with the stacked ``blocks`` as a list)."""

from __future__ import annotations

from typing import Any, List, Tuple


def tree_map(fn, tree):
    """Apply ``fn`` to every tensor of a nest of dicts and lists."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_map(fn, v) for v in tree]
    return fn(tree)


def tree_leaves(tree, path: Tuple = ()) -> List[Tuple[Tuple, Any]]:
    """[(path, leaf)] in a fixed order: dict keys sorted (as JAX orders
    pytree dicts), list entries in order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k], path + (k,))]
    if isinstance(tree, list):
        return [x for i, v in enumerate(tree) for x in tree_leaves(v, path + (i,))]
    return [(path, tree)]
