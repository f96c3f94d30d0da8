"""Plain PyTorch versions of the fused spectral matmul kernels (bf16/fp32
factors and int8 factors)."""
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


def spectral_matmul_q8_ref(x: torch.Tensor, U_q8: torch.Tensor, gain: torch.Tensor,
                           V_q8: torch.Tensor) -> torch.Tensor:
    """y = ((x @ widen(U_q8)) * gain) @ widen(V_q8).T over int8 factors.
    x: (M, m) float, U_q8: (m, k) int8, gain: (k,) fp32 (the fused
    u_scale * s * v_scale), V_q8: (n, k) int8 -> y: (M, n) in x.dtype.
    The codes widen exactly (|q| <= 127 is exact in bf16); h = x @ U_q8
    accumulates in fp32, takes the gain in fp32 and is rounded to
    x.dtype once before the second product, as the TPU kernel does
    (``src/repro/kernels/spectral_matmul_q8.py:43-47``)."""
    dt = x.dtype
    h = x.float() @ U_q8.float()
    h = h * gain.float()
    y = h.to(dt).float() @ V_q8.float().T
    return y.to(dt)
