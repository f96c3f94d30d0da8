"""Linear layers: dense or spectral (SCT). One call site for both, so the
paper's technique is a config switch on every projection.

The spectral branch always runs the fused kernel wrapper
(``kernels/ops.py:spectral_matmul``): the CUDA kernel for CUDA tensors,
its plain version for CPU tensors, with the reference's backward for
autograd. The dense branch is a plain matmul. The reference's int8
branches come with int8 serving.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.spectral import is_spectral, spectral_init
from repro_torch.kernels.ops import spectral_matmul


def init_linear(
    in_dim: int,
    out_dim: int,
    *,
    generator: torch.Generator,
    device: torch.device,
    rank: Optional[int] = None,
    bias: bool = False,
    dtype: torch.dtype = torch.float32,
    scale: Optional[float] = None,
):
    """rank=None -> dense {'w': (in, out)[, 'b']}; rank=k -> spectral
    {'U': (in,k), 's': (k,), 'V': (out,k)[, 'b']} (paper Eq. 1)."""
    if rank is not None:
        k = min(rank, in_dim, out_dim)
        p = spectral_init(in_dim, out_dim, k, generator=generator, device=device,
                          dtype=dtype, scale=scale)
    else:
        sigma = scale if scale is not None else in_dim ** -0.5
        w = torch.randn((in_dim, out_dim), generator=generator, device=device,
                        dtype=torch.float32) * sigma
        p = {"w": w.to(dtype)}
    if bias:
        p["b"] = torch.zeros((out_dim,), dtype=dtype, device=device)
    return p


def apply_linear(p, x: torch.Tensor) -> torch.Tensor:
    """Dispatch on parameterization; the dense (m, n) matrix is never
    built in the spectral branch."""
    if is_spectral(p):
        y = spectral_matmul(x, p["U"], p["s"], p["V"])
    elif "w" in p:
        y = x @ p["w"].to(x.dtype)
    else:
        raise NotImplementedError(
            f"linear parameters with keys {sorted(p)}: only dense and "
            f"spectral groups are ported (int8 serving is not)")
    if "b" in p:
        y = y + p["b"].to(y.dtype)
    return y

