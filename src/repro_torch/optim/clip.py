"""Global-norm gradient clipping (the reference's ``optim/clip.py``)."""
from __future__ import annotations

import torch

from repro_torch.core.tree import tree_leaves, tree_map


def global_norm(tree) -> torch.Tensor:
    return torch.sqrt(torch.stack(
        [torch.sum(torch.square(g.to(torch.float32))) for g in tree_leaves(tree)]).sum())


def clip_by_global_norm(grads, max_norm: float):
    """(grads scaled to a global norm of at most ``max_norm``, the norm).
    The gradients are scaled in place: the step owns them. Each is the
    reference's ``(g.astype(f32) * scale).astype(g.dtype)``: an fp32
    leaf is multiplied where it lies, any other leaf gets the fp32 product
    rounded once (a bf16 ``mul_`` by a 0-d fp32 CUDA tensor may round the
    scale to bf16 first)."""
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / (norm + 1e-12), max=1.0)

    def clip(g):
        if g.dtype == torch.float32:
            return g.mul_(scale)
        return g.copy_(g.to(torch.float32) * scale)

    return tree_map(clip, grads), norm
