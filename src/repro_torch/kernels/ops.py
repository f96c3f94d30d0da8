"""Public wrapper of the fused spectral matmul: leading dims, dtype
handling, and the choice between the CUDA kernel and its plain version.

The tensor's device decides: a CPU tensor runs the plain version
(``kernels/ref.py``), a CUDA tensor launches the kernel or raises.
Forward only — the backward (the reference's ``ops.py:_vjp_bwd``, five
plain GEMMs) arrives with the training slice.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.ref import spectral_matmul_ref
from repro_torch.kernels.spectral_matmul import spectral_matmul_cuda


def spectral_matmul(x: torch.Tensor, U: torch.Tensor, s: torch.Tensor,
                    V: torch.Tensor) -> torch.Tensor:
    """y = ((x @ U) * s) @ V.T with h kept on chip.
    x: (..., m); U: (m, k); s: (k,); V: (n, k) -> (..., n) in x.dtype.
    Factors in another dtype than x are rounded to it first (the
    reference's apply-time cast); serving casts them once at load."""
    lead = x.shape[:-1]
    m = x.shape[-1]
    n = V.shape[0]
    x2 = x.reshape(-1, m)
    if x.device.type == "cpu":
        y = spectral_matmul_ref(x2, U, s, V)
    elif x.device.type == "cuda":
        y = spectral_matmul_cuda(x2.contiguous(), U.to(x.dtype).contiguous(),
                                 s.float().contiguous(), V.to(x.dtype).contiguous())
    else:
        raise ValueError(f"spectral_matmul: no kernel for device {x.device}")
    return y.reshape(*lead, n)
