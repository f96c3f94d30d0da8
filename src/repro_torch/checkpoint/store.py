"""Pytree (de)serialization in the reference's npz layout, numpy only.

A checkpoint is one ``.npz``: every leaf under its ``/``-joined path
(``layers/mlp/up/U``; list items as ``[i]``) plus a ``__struct__`` json
treedef. The layout is byte-compatible with the JAX package's
``checkpoint/store.py``, so either side can read what the other wrote.
Leaves may be numpy arrays or torch tensors (fetched to host); loads
return numpy arrays — ``bridge.params_from_numpy`` places them.
Atomic: write to ``<path>.tmp``, fsync, rename.
"""
from __future__ import annotations

import json
import os
from typing import Any

import numpy as np

_SEP = "/"


def _flatten_with_paths(tree: Any, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flatten_with_paths(tree[k], f"{prefix}{_SEP}{k}" if prefix else str(k))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _flatten_with_paths(v, f"{prefix}{_SEP}[{i}]")
    else:
        yield prefix, tree


def _structure(tree: Any):
    if isinstance(tree, dict):
        return {k: _structure(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return {"__seq__": type(tree).__name__, "items": [_structure(v) for v in tree]}
    return None  # leaf marker


def _rebuild(struct, leaves: dict, prefix=""):
    if isinstance(struct, dict) and "__seq__" in struct:
        items = [
            _rebuild(s, leaves, f"{prefix}{_SEP}[{i}]")
            for i, s in enumerate(struct["items"])
        ]
        return tuple(items) if struct["__seq__"] == "tuple" else items
    if isinstance(struct, dict):
        return {
            k: _rebuild(v, leaves, f"{prefix}{_SEP}{k}" if prefix else str(k))
            for k, v in struct.items()
        }
    return leaves[prefix]


def _to_numpy(leaf: Any) -> np.ndarray:
    if hasattr(leaf, "detach"):                  # torch.Tensor
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def save_pytree(tree: Any, path: str) -> None:
    """Atomic save of a nested dict/list of arrays or tensors."""
    arrays = {p: _to_numpy(leaf) for p, leaf in _flatten_with_paths(tree)}
    tmp = path + ".tmp"
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(tmp, "wb") as f:
        np.savez(f, **{"__struct__": json.dumps(_structure(tree))}, **arrays)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def load_pytree(path: str) -> Any:
    """Load a checkpoint as a nested tree of numpy arrays."""
    with np.load(path, allow_pickle=False) as z:
        struct = json.loads(str(z["__struct__"]))
        leaves = {k: z[k] for k in z.files if k != "__struct__"}
    return _rebuild(struct, leaves)


def flatten(tree: Any) -> dict:
    """``{"a/b/c": leaf}`` view of a tree — the npz key space."""
    return dict(_flatten_with_paths(tree))


def unflatten(flat: dict) -> dict:
    """The nested dict of a ``{"a/b/c": leaf}`` mapping (inverse of
    :func:`flatten` for trees of dicts); an npz's ``__struct__`` entry
    is skipped."""
    tree: dict = {}
    for key, leaf in flat.items():
        if key == "__struct__":
            continue
        node = tree
        *parents, last = key.split(_SEP)
        for part in parents:
            node = node.setdefault(part, {})
        node[last] = leaf
    return tree
