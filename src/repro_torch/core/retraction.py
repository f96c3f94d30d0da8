"""Stiefel-manifold retractions for spectral factors (the reference's
``core/retraction.py``).

Paper (Algorithm 1, lines 5-7): after each AdamW step,

    Q, R = qr(U);  U <- Q * sign(diag(R))

The sign correction makes the retraction continuous (QR is unique only
up to column signs). CholeskyQR2 and Cayley are the reference's
alternatives. Every retraction runs in fp32 whatever the storage dtype
and broadcasts over leading (layer) axes. The reference's row-sharded
``axis_name`` form waits for training across devices.
"""
from __future__ import annotations

from typing import Callable, Dict

import torch


def _sign_fix(Q: torch.Tensor, R: torch.Tensor) -> torch.Tensor:
    """Q * sign(diag(R)) with sign(0) := 1 for determinism."""
    d = torch.diagonal(R, dim1=-2, dim2=-1)
    sign = torch.where(d >= 0, 1.0, -1.0).to(Q.dtype)
    return Q * sign[..., None, :]


def qr_retract(U: torch.Tensor) -> torch.Tensor:
    """Paper-faithful QR retraction with sign correction (Eq. 5):
    ``U (..., m, k) -> Q * sign(diag(R))``, computed in fp32."""
    Q, R = torch.linalg.qr(U.float())
    return _sign_fix(Q, R).to(U.dtype)


def _cholesky_qr_once(U: torch.Tensor) -> torch.Tensor:
    """One CholeskyQR pass: G = U^T U, L = chol(G), U <- U L^{-T}."""
    G = torch.einsum("...mk,...ml->...kl", U, U)
    k = G.shape[-1]
    trace = torch.diagonal(G, dim1=-2, dim2=-1).sum(-1)
    G = G + (1e-10 * trace[..., None, None] / k) * torch.eye(k, dtype=G.dtype,
                                                             device=G.device)
    L = torch.linalg.cholesky(G)
    # U_new L^T = U
    return torch.linalg.solve_triangular(L.transpose(-1, -2), U, upper=True, left=False)


def cholesky_qr2_retract(U: torch.Tensor) -> torch.Tensor:
    """CholeskyQR2: two CholeskyQR passes, fp32-grade orthogonality for
    cond(U) up to ~1e4; the same factor as the sign-fixed QR."""
    Uf = _cholesky_qr_once(_cholesky_qr_once(U.float()))
    return Uf.to(U.dtype)


def cayley_retract(U: torch.Tensor, tangent_scale: float = 1.0) -> torch.Tensor:
    """Cayley-transform retraction [Li et al., 2020]: the deviation of U
    from its CholeskyQR point Q, made skew, drives
    ``Q (I - A/2)^{-1} (I + A/2)``."""
    Uf = U.float()
    Q = _cholesky_qr_once(Uf)
    D = (Uf - Q) * tangent_scale
    A = torch.einsum("...mk,...ml->...kl", Q, D)
    A = A - A.transpose(-1, -2)
    eye = torch.eye(A.shape[-1], dtype=Uf.dtype, device=Uf.device)
    M = torch.linalg.solve(eye - 0.5 * A, eye + 0.5 * A)
    return torch.einsum("...mk,...kl->...ml", Q, M).to(U.dtype)


RETRACTIONS: Dict[str, Callable[..., torch.Tensor]] = {
    "qr": qr_retract,
    "cholesky_qr2": cholesky_qr2_retract,
    "cayley": cayley_retract,
}


def retract(U: torch.Tensor, method: str = "qr", **kwargs) -> torch.Tensor:
    """Dispatch a retraction by name; extra kwargs go to the method."""
    fn = RETRACTIONS.get(method)
    if fn is None:
        raise ValueError(f"unknown retraction {method!r}; options {list(RETRACTIONS)}")
    return fn(U, **kwargs)
