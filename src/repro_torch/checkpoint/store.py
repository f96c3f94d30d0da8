"""Pytree (de)serialization in the reference's npz layout.

A checkpoint is one ``.npz``: every leaf under its ``/``-joined path
(``layers/mlp/up/U``; list items as ``[i]``) plus a ``__struct__`` json
treedef. The layout is the JAX package's ``checkpoint/store.py``'s, so
either side can read what the other wrote. Leaves may be numpy arrays or
torch tensors: a tensor is copied to the host (a copy even when it lies
on the CPU, so a later in-place step never changes what is written), and
a bf16 tensor is written as the reference writes one, its raw bits as a
2-byte void (``V2``: numpy has no bfloat16). Loads return numpy arrays;
:func:`to_tensor` places one, a ``V2`` leaf as bf16 bit for bit.
Atomic: write to ``<path>.tmp``, fsync, rename.
"""
from __future__ import annotations

import json
import os
from typing import Any

import numpy as np
import torch

_SEP = "/"
_BF16_BITS = np.dtype("V2")   # a bf16 leaf's raw bits on disk


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


def to_numpy(leaf: Any) -> np.ndarray:
    """A host copy of one leaf in the npz layout: a tensor is copied (on
    the CPU too), a bf16 tensor's bits become a ``V2`` array."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().to("cpu", copy=True)
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(_BF16_BITS)
        return t.numpy()
    return np.asarray(leaf)


def to_tensor(leaf: Any, device=None) -> torch.Tensor:
    """A loaded leaf as a tensor on ``device`` (a copy: the tensor never
    aliases the array): a 2-byte void array (``V2`` from a file, or
    ml_dtypes' bfloat16 from ``jax.device_get``) is bf16, bit for bit."""
    arr = np.asarray(leaf)
    if arr.dtype.kind == "V" and arr.dtype.itemsize == 2:
        return torch.from_numpy(arr.view(np.int16).copy()).view(torch.bfloat16).to(device)
    return torch.tensor(arr, device=device)


def host_tree(tree: Any) -> Any:
    """The tree with every leaf fetched by :func:`to_numpy`: a snapshot a
    background writer can save while the caller's tensors change."""
    if isinstance(tree, dict):
        return {k: host_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(host_tree(v) for v in tree)
    return to_numpy(tree)


def save_pytree(tree: Any, path: str) -> None:
    """Atomic save of a nested dict/list of arrays or tensors."""
    arrays = {p: to_numpy(leaf) for p, leaf in _flatten_with_paths(tree)}
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
