"""Public wrappers of the fused spectral matmuls (bf16/fp32 factors and
int8 factors): leading dims, dtype handling, the choice between the CUDA
kernel and its plain version, and the gradient.

The tensor's device decides: a CPU tensor runs the plain version
(``kernels/ref.py``), a CUDA tensor launches the kernel or raises. The
backward is the reference's ``kernels/ops.py:_vjp_bwd`` product for
product: h is recomputed, and the five products (dV, dhs, ds, dU, dx)
are plain ``torch.matmul``/``einsum`` calls, as the reference leaves
them to XLA outside any Pallas kernel. The int8 variant has no
gradient: its backward raises, as the reference's ``_q8_vjp_fwd`` does.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.ref import spectral_matmul_q8_ref, spectral_matmul_ref
from repro_torch.kernels.spectral_matmul import spectral_matmul_cuda
from repro_torch.kernels.spectral_matmul_q8 import spectral_matmul_q8_cuda


def _forward(x2: torch.Tensor, U: torch.Tensor, s: torch.Tensor,
             V: torch.Tensor) -> torch.Tensor:
    if x2.device.type == "cpu":
        return spectral_matmul_ref(x2, U, s, V)
    if x2.device.type == "cuda":
        return spectral_matmul_cuda(x2.contiguous(), U.to(x2.dtype).contiguous(),
                                    s.float().contiguous(), V.to(x2.dtype).contiguous())
    raise ValueError(f"spectral_matmul: no kernel for device {x2.device}")


class _SpectralMatmul(torch.autograd.Function):
    """y = ((x @ U) * s) @ V.T through the fused kernel; the backward
    follows the reference's ``_vjp_bwd``."""

    @staticmethod
    def forward(ctx, x2, U, s, V):
        ctx.save_for_backward(x2, U, s, V)
        return _forward(x2, U, s, V)

    @staticmethod
    def backward(ctx, dy2):
        x2, U, s, V = ctx.saved_tensors
        dt = x2.dtype
        f32 = torch.float32
        # recompute h (remat): never stored by the forward
        h = x2.to(f32) @ U.to(dt).to(f32)
        hs = h * s.to(f32)
        dV = (dy2.to(f32).T @ hs).to(V.dtype)
        dhs = dy2.to(f32) @ V.to(dy2.dtype).to(f32)
        ds = torch.einsum("Mk,Mk->k", dhs, h).to(s.dtype)
        dh = dhs * s.to(f32)
        dU = (x2.to(f32).T @ dh).to(U.dtype)
        dx = (dh.to(dt).to(f32) @ U.to(dt).to(f32).T).to(dt)
        return dx, dU, ds, dV


def spectral_matmul(x: torch.Tensor, U: torch.Tensor, s: torch.Tensor,
                    V: torch.Tensor) -> torch.Tensor:
    """y = ((x @ U) * s) @ V.T with h kept on chip.
    x: (..., m); U: (m, k); s: (k,); V: (n, k) -> (..., n) in x.dtype.
    Factors in another dtype than x are rounded to it first (the
    reference's apply-time cast); serving casts them once at load.
    Differentiable in x, U, s and V; gradients come back in each
    input's own dtype (fp32 masters get fp32 gradients)."""
    lead = x.shape[:-1]
    m = x.shape[-1]
    n = V.shape[0]
    x2 = x.reshape(-1, m)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x2, U, s, V)):
        y = _SpectralMatmul.apply(x2, U, s, V)
    else:
        y = _forward(x2, U, s, V)
    return y.reshape(*lead, n)


def _forward_q8(x2, U_q8, gain, V_q8):
    if x2.device.type == "cpu":
        return spectral_matmul_q8_ref(x2, U_q8, gain, V_q8)
    if x2.device.type == "cuda":
        return spectral_matmul_q8_cuda(x2.contiguous(), U_q8.contiguous(),
                                       gain.contiguous(), V_q8.contiguous())
    raise ValueError(f"spectral_matmul_q8: no kernel for device {x2.device}")


class _SpectralMatmulQ8(torch.autograd.Function):
    """The int8 forward under autograd: serving-only, so its backward
    raises instead of returning a cotangent for int8 factors."""

    @staticmethod
    def forward(ctx, x2, U_q8, gain, V_q8):
        return _forward_q8(x2, U_q8, gain, V_q8)

    @staticmethod
    def backward(ctx, dy2):
        raise TypeError(
            "spectral_matmul_q8 is a serving-only kernel over int8 factors; it has "
            "no gradient (train against the fp spectral factors, or dequantize_tree "
            "first)")


def spectral_matmul_q8(x: torch.Tensor, U_qt: dict, s: torch.Tensor,
                       V_qt: dict) -> torch.Tensor:
    """y = ((x @ U) * s) @ V.T over int8 factors, consumed directly:
    ``U_qt``/``V_qt`` are ``{"q8", "scale"}`` tensors
    (``serving/quantize.py``), and the per-column scales commute with
    both products, so ``u_scale * s * v_scale`` fold into one fp32 gain
    on h. x: (..., m); U_qt["q8"]: (m, k); s: (k,); V_qt["q8"]: (n, k)
    -> (..., n) in x.dtype. Reference: ``src/repro/kernels/ops.py:83``."""
    lead = x.shape[:-1]
    m = x.shape[-1]
    U_q8, V_q8 = U_qt["q8"], V_qt["q8"]
    gain = U_qt["scale"].float() * s.float() * V_qt["scale"].float()
    x2 = x.reshape(-1, m)
    if torch.is_grad_enabled() and (x2.requires_grad or gain.requires_grad):
        y = _SpectralMatmulQ8.apply(x2, U_q8, gain, V_q8)
    else:
        y = _forward_q8(x2, U_q8, gain, V_q8)
    return y.reshape(*lead, V_q8.shape[0])
