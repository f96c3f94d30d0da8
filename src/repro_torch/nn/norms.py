"""RMSNorm.

Statistics are computed in fp32 inside the reduction; the normalized
output stays in the input dtype, as in the reference (its default,
non-``FP32_NORM_PATH`` branch): a bf16 model keeps a bf16 residual
stream.
"""
from __future__ import annotations

import torch


def init_rmsnorm(dim: int, *, device, dtype=torch.float32):
    return {"scale": torch.ones((dim,), dtype=dtype, device=device)}


def apply_rmsnorm(p, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    # square in x.dtype, mean accumulated in fp32 (the reference's
    # ``jnp.mean(jnp.square(x), dtype=float32)``)
    var = torch.mean(torch.square(x), dim=-1, keepdim=True, dtype=torch.float32)
    inv = torch.rsqrt(var + eps)
    return x * inv.to(x.dtype) * p["scale"].to(x.dtype)
