"""Plain PyTorch version of the fused spectral matmul kernel."""
from __future__ import annotations

import torch


def spectral_matmul_ref(x: torch.Tensor, U: torch.Tensor, s: torch.Tensor,
                        V: torch.Tensor) -> torch.Tensor:
    """y = ((x @ U) * s) @ V.T — paper Eq. 2-4. x: (M, m), U: (m, k),
    s: (k,), V: (n, k) -> y: (M, n) in x.dtype. The factors are rounded
    to x.dtype; both products accumulate in fp32 (the products of
    bf16 values are exact in fp32), h * s is fp32 and is rounded to
    x.dtype once before the second product."""
    dt = x.dtype
    h = x.float() @ U.to(dt).float()
    h = h * s.float()
    y = h.to(dt).float() @ V.to(dt).float().T
    return y.to(dt)
