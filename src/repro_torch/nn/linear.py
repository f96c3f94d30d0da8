"""Linear layers: dense or spectral (SCT). One call site for both, so the
paper's technique is a config switch on every projection.

The spectral branch always runs the fused kernel wrapper
(``kernels/ops.py:spectral_matmul``): the CUDA kernel for CUDA tensors,
its plain version for CPU tensors, with the reference's backward for
autograd. An int8 spectral group (``serving/quantize.py``) runs the
int8 kernel wrapper (``kernels/ops.py:spectral_matmul_q8``) on its codes.
The dense branch is a plain matmul; an int8 dense ``w`` is dequantized
for the call, as the reference computes it outside any Pallas kernel.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.spectral import is_spectral, spectral_init
from repro_torch.kernels.ops import spectral_matmul, spectral_matmul_q8
from repro_torch.serving.quantize import dequantize_int8, is_quantized, is_quantized_spectral


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
    """Dispatch on parameterization (the reference's
    ``src/repro/nn/linear.py:57``); the dense (m, n) matrix is never
    built in the spectral branches."""
    if is_spectral(p):
        y = spectral_matmul(x, p["U"], p["s"], p["V"])
    elif is_quantized_spectral(p):              # int8 spectral group
        y = spectral_matmul_q8(x, p["U"], p["s"], p["V"])
    elif is_quantized(p.get("w")):              # int8 dense weight
        y = x @ dequantize_int8(p["w"], x.dtype)
    else:
        y = x @ p["w"].to(x.dtype)
    if "b" in p:
        y = y + p["b"].to(y.dtype)
    return y

