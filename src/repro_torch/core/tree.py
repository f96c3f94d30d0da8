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
    vmapped per-layer init). The input dicts are emptied leaf by leaf as
    the leaves are stacked, so a model's layers never exist twice in
    memory."""
    import torch

    first = trees[0]
    if isinstance(first, dict):
        return {k: stack_trees([t.pop(k) for t in trees]) for k in list(first)}
    return torch.stack(trees)


def unstack_tree(stacked: Dict[str, Any], n: int) -> List[Dict[str, Any]]:
    """The ``n`` layers of a layer-stacked tree as views, one ``unbind``
    per leaf (its backward stacks the layers' gradients in one op)."""
    if isinstance(stacked, dict):
        parts = {k: unstack_tree(v, n) for k, v in stacked.items()}
        return [{k: parts[k][i] for k in stacked} for i in range(n)]
    return list(stacked.unbind(0))


def _walk(tree: Any, fn) -> Any:
    """Depth-first walk replacing spectral groups via ``fn(group)``."""
    from repro_torch.core.spectral import is_spectral

    if is_spectral(tree):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _walk(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_walk(v, fn) for v in tree)
    return tree


def retract_tree(params: Any, method: str = "qr") -> Any:
    """Stiefel retraction of U and V of every spectral group in the tree
    (paper Algorithm 1, lines 5-7, over the whole model); every other
    leaf is returned as it is."""
    from repro_torch.core.retraction import retract

    def _retract_group(g):
        out = dict(g)
        out["U"] = retract(g["U"], method=method)
        out["V"] = retract(g["V"], method=method)
        return out

    return _walk(params, _retract_group)


def spectral_leaf_mask(params: Any) -> Any:
    """Tree of bools marking the U/s/V leaves of spectral groups."""
    from repro_torch.core.spectral import is_spectral

    def _walk_mask(tree):
        if is_spectral(tree):
            return {k: (k in ("U", "s", "V")) for k in tree}
        if isinstance(tree, dict):
            return {k: _walk_mask(v) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return type(tree)(_walk_mask(v) for v in tree)
        return False

    return _walk_mask(params)


def orthogonality_error(U) -> Any:
    """max |U^T U - I| over the last two axes and every leading one (the
    paper's Table 2 'Ortho. Error'), fp32."""
    import torch

    Uf = U.float()
    G = torch.einsum("...mk,...ml->...kl", Uf, Uf)
    eye = torch.eye(G.shape[-1], dtype=G.dtype, device=G.device)
    return torch.max(torch.abs(G - eye))


def max_orthogonality_error(params: Any):
    """Max orthogonality error over every spectral factor of the tree,
    as a 0-d fp32 tensor (0 for a tree without spectral groups)."""
    import torch

    errs = []

    def _collect(g):
        errs.append(orthogonality_error(g["U"]))
        errs.append(orthogonality_error(g["V"]))
        return g

    _walk(params, _collect)
    if not errs:
        return torch.zeros((), dtype=torch.float32)
    return torch.max(torch.stack(errs))
