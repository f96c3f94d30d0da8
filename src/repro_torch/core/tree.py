"""Helpers over parameter / state trees: nested dicts of tensors in the
reference's layout (layer-stacked leaves under ``layers``)."""
from __future__ import annotations

from typing import Any, Callable, Dict, List


def tree_map(fn: Callable[[Any], Any], tree: Any) -> Any:
    """Apply ``fn`` to every leaf of a nested dict, keeping the layout."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def tree_leaves(tree: Any) -> List[Any]:
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    return [tree]


def layer_slice(stacked: Dict[str, Any], i: int) -> Dict[str, Any]:
    """Layer ``i`` of a layer-stacked tree, as views (writes go through)."""
    return tree_map(lambda t: t[i], stacked)


def stack_trees(trees: List[Dict[str, Any]]) -> Dict[str, Any]:
    """Stack same-layout trees along a new leading axis (the reference's
    vmapped per-layer init)."""
    import torch

    first = trees[0]
    if isinstance(first, dict):
        return {k: stack_trees([t[k] for t in trees]) for k in first}
    return torch.stack(trees)
