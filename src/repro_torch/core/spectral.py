"""SpectralLinear: the paper's permanent truncated-SVD parameterization.

A weight matrix ``W (m, n)`` is stored as ``U (m, k)``, ``s (k,)``,
``V (n, k)`` with ``W = U @ diag(s) @ V.T``. The dense ``W`` is never
materialized — the forward flows through the three small factors
(paper Eq. 1–4). Parameters are plain dicts of tensors in the
reference's layout, so npz checkpoints map one-to-one.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional

import torch

# A spectral parameter group is a dict with exactly these keys.
SPECTRAL_KEYS = ("U", "s", "V")

SpectralParams = Dict[str, torch.Tensor]


def spectral_init(
    m: int,
    n: int,
    k: int,
    *,
    generator: torch.Generator,
    device: torch.device,
    dtype: torch.dtype = torch.float32,
    scale: Optional[float] = None,
) -> SpectralParams:
    """Initialize spectral factors for from-scratch training.

    U, V get orthonormal columns (QR of Gaussian). The singular values
    decay geometrically and are scaled so the implied dense matrix has
    the Frobenius norm of a LeCun-normal dense init:
    ``E||W||_F^2 = m * n / m`` and ``||U diag(s) V^T||_F^2 = ||s||_2^2``.
    Same distribution as the reference; other draws (torch RNG).
    """
    if k > min(m, n):
        raise ValueError(f"rank {k} exceeds min(m={m}, n={n})")
    u0 = torch.randn((m, k), generator=generator, device=device, dtype=torch.float32)
    v0 = torch.randn((n, k), generator=generator, device=device, dtype=torch.float32)
    U, _ = torch.linalg.qr(u0)
    V, _ = torch.linalg.qr(v0)
    sigma = scale if scale is not None else 1.0 / math.sqrt(m)
    # geometric decay over the retained spectrum (condition ~ 100)
    decay = torch.logspace(0.0, -2.0, k, device=device, dtype=torch.float32)
    s = decay * (sigma * math.sqrt(m * n) / torch.linalg.norm(decay))
    return {"U": U.to(dtype), "s": s.to(dtype), "V": V.to(dtype)}


def spectral_apply(params: SpectralParams, x: torch.Tensor) -> torch.Tensor:
    """``y = ((x @ U) * s) @ V.T`` as three plain matmuls in x.dtype —
    the reference's ``core/spectral.py:spectral_apply``, where h is
    rounded to x.dtype before the scale. The model's spectral
    projections go through ``kernels/ops.py:spectral_matmul`` instead
    (h in fp32, on chip); this chain is its library yardstick."""
    U, s, V = params["U"], params["s"], params["V"]
    h = x @ U.to(x.dtype)
    h = h * s.to(h.dtype)
    return h @ V.T.to(x.dtype)


def is_spectral(params: Any) -> bool:
    """True if this tree node is a spectral parameter group."""
    return (
        isinstance(params, dict)
        and set(params.keys()) >= set(SPECTRAL_KEYS)
        and all(isinstance(params[k], torch.Tensor) for k in SPECTRAL_KEYS)
        and params["U"].ndim >= 2
        and params["s"].ndim == params["U"].ndim - 1
    )
