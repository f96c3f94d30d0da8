"""MLP blocks: SwiGLU and GELU. These are the layers the paper converts
to spectral form (gate_proj / up_proj / down_proj — S4.2)."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.nn.linear import apply_linear, init_linear


def init_mlp(d_model: int, d_ff: int, *, generator, device, rank=None,
             act: str = "swiglu", bias: bool = False, dtype=torch.float32):
    kw = dict(generator=generator, device=device, rank=rank, bias=bias, dtype=dtype)
    p = {
        "up": init_linear(d_model, d_ff, **kw),
        "down": init_linear(d_ff, d_model, **kw),
    }
    if act == "swiglu":
        p["gate"] = init_linear(d_model, d_ff, **kw)
    return p


def apply_mlp(p, x: torch.Tensor, *, act: str = "swiglu") -> torch.Tensor:
    up = apply_linear(p["up"], x)
    if act == "swiglu":
        h = F.silu(apply_linear(p["gate"], x)) * up
    elif act == "gelu":
        h = F.gelu(up, approximate="tanh")      # jax.nn.gelu's default
    else:
        raise ValueError(act)
    return apply_linear(p["down"], h)
