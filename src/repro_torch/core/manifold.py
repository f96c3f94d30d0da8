"""Stiefel manifold utilities (the reference's ``core/manifold.py``):
diagnostics and tangent-space projection."""
from __future__ import annotations

import torch

from repro_torch.core.tree import orthogonality_error

__all__ = ["orthogonality_error", "project_tangent", "frobenius_tail"]


def project_tangent(U: torch.Tensor, G: torch.Tensor) -> torch.Tensor:
    """Project an ambient gradient G (..., m, k) onto the tangent space of
    the Stiefel manifold at U: PT(G) = G - U sym(U^T G). The paper takes
    plain Euclidean AdamW steps and relies on the retraction; the
    projection is an optional mode beyond the paper."""
    UtG = torch.einsum("...mk,...ml->...kl", U, G)
    sym = 0.5 * (UtG + UtG.transpose(-1, -2))
    return G - torch.einsum("...mk,...kl->...ml", U, sym)


def frobenius_tail(s: torch.Tensor, k: int) -> torch.Tensor:
    """The optimal rank-k approximation error sqrt(sum_{i>k} sigma_i^2)
    (Eckart-Young), which tests hold truncation against."""
    s_sorted = torch.sort(s, descending=True).values
    return torch.sqrt(torch.sum(s_sorted[k:] ** 2))
