"""Dense <-> spectral conversion by truncated SVD, and energy-based rank
selection (the reference's ``core/convert.py``; paper S4.4's '95% energy
retention' mode). The SVD runs in fp32 (``torch.linalg.svd``); the signs
of singular vectors depend on the backend, so U and V agree with the
reference's up to a sign per column, and s, ranks and products agree."""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch


def dense_to_spectral(W: torch.Tensor, k: int,
                      dtype: Optional[torch.dtype] = None) -> Dict[str, torch.Tensor]:
    """Rank-k spectral factors of a dense (..., m, n) matrix:
    ``W ~= U @ diag(s) @ V.T`` with U (..., m, k), V (..., n, k); exact when
    k >= rank(W). The conversion the paper applies to pretrained
    checkpoints (S4.2, S4.4)."""
    dtype = dtype or W.dtype
    u, s, vt = torch.linalg.svd(W.to(torch.float32), full_matrices=False)
    return {"U": u[..., :, :k].to(dtype), "s": s[..., :k].to(dtype),
            "V": vt.transpose(-1, -2)[..., :, :k].to(dtype)}


def spectral_to_dense(params: Dict[str, torch.Tensor]) -> torch.Tensor:
    """The dense matrix of spectral factors. For tests and export only:
    the training and serving paths never form it (the paper's core
    invariant)."""
    return torch.einsum("...mk,...k,...nk->...mn", params["U"], params["s"], params["V"])


def rank_for_energy(s: torch.Tensor, energy: float = 0.95) -> int:
    """The smallest k with sum_{i<=k} s_i^2 >= energy * sum s_i^2 (a
    Python int: rank choice happens when the model is built)."""
    s2 = torch.sort(torch.as_tensor(s) ** 2, descending=True).values
    cum = torch.cumsum(s2, 0)
    k = int(torch.searchsorted(cum, energy * cum[-1])) + 1
    return min(k, s2.shape[0])


def convert_mlp_tree_to_spectral(params: Any, energy: float = 0.95) -> Tuple[Any, List[int]]:
    """Every MLP projection of a dense parameter tree (a ``{"w"}`` group on
    a path holding ``/mlp/``) converted to spectral form by truncated SVD
    at ``energy`` retention, the paper's S4.4 conversion. Layer-stacked
    weights (L, m, n) take the largest rank over their layers, so the
    stack keeps one shape. Returns (new tree, chosen ranks)."""
    ranks: List[int] = []

    def conv(tree, path=""):
        if not isinstance(tree, dict):
            return tree
        if set(tree) == {"w"} and "/mlp/" in path + "/":
            W = tree["w"]
            s = torch.linalg.svdvals(W.to(torch.float32))
            if W.ndim == 3:
                k = max(rank_for_energy(s[i], energy) for i in range(s.shape[0]))
            else:
                k = rank_for_energy(s, energy)
            ranks.append(k)
            return dense_to_spectral(W, k)
        return {key: conv(v, f"{path}/{key}") for key, v in tree.items()}

    return conv(params), ranks


def truncation_error(W: torch.Tensor, params: Dict[str, torch.Tensor]) -> torch.Tensor:
    """||W - U diag(s) V^T||_F, which tests hold against the Eckart-Young
    optimum."""
    return torch.linalg.norm(W.to(torch.float32) - spectral_to_dense(params).to(torch.float32))
