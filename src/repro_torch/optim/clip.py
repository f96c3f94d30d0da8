"""Global-norm gradient clipping (the reference's ``optim/clip.py``)."""
from __future__ import annotations

import torch

from repro_torch.core.tree import tree_leaves, tree_map


def global_norm(tree) -> torch.Tensor:
    return torch.sqrt(torch.stack(
        [torch.sum(torch.square(g.to(torch.float32))) for g in tree_leaves(tree)]).sum())


def clip_by_global_norm(grads, max_norm: float):
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / (norm + 1e-12), max=1.0)
    return tree_map(lambda g: (g.to(torch.float32) * scale).to(g.dtype), grads), norm
