"""Selective scan: the CUDA kernel (``csrc/mamba_scan.cu``), which
replaces the JAX package's ``kernels/mamba_scan.py:52``
``mamba_scan_pallas``, and its wrapper.

The tensor's device decides: CPU tensors run the plain version
(``kernels/mamba_ref.py``), CUDA tensors launch the kernel or raise. The
kernel has no backward yet: under autograd the wrapper's backward raises
``TypeError`` (training the hybrid family is a later slice).
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels.mamba_ref import mamba_scan_ref

STATE_WIDTHS = (4, 8, 16, 32, 64)     # d_state values the kernel is built for


def mamba_scan_cuda(u, dt, B, C, A, D) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel launch: u/dt (b, S, di) and B/C (b, S, ds) in one dtype
    (fp32 or bf16), A (di, ds) and D (di,) fp32, all contiguous on one
    CUDA device; S >= 1, ds in :data:`STATE_WIDTHS`. Returns (y (b, S,
    di) in u.dtype, hT (b, di, ds) fp32)."""
    b, S, di = u.shape
    ds = B.shape[-1]
    if (dt.shape != u.shape or B.shape != (b, S, ds) or C.shape != B.shape
            or A.shape != (di, ds) or D.shape != (di,)):
        raise ValueError(f"mamba_scan: shapes u {tuple(u.shape)}, dt {tuple(dt.shape)}, "
                         f"B {tuple(B.shape)}, C {tuple(C.shape)}, A {tuple(A.shape)}, "
                         f"D {tuple(D.shape)}")
    code = build.dtype_code(u, "mamba_scan")
    if dt.dtype != u.dtype or B.dtype != u.dtype or C.dtype != u.dtype:
        raise TypeError("mamba_scan: u, dt, B and C must share one dtype")
    if A.dtype != torch.float32 or D.dtype != torch.float32:
        raise TypeError("mamba_scan: the kernel takes A and D in fp32")
    if S < 1 or ds not in STATE_WIDTHS:
        raise ValueError(f"mamba_scan: S={S}, d_state={ds}: the kernel takes S >= 1 and "
                         f"d_state in {STATE_WIDTHS}")
    build.require_cuda("mamba_scan", u, dt, B, C, A, D)
    y = torch.empty_like(u)
    hT = torch.empty((b, di, ds), dtype=torch.float32, device=u.device)
    err = build.library().sct_mamba_scan(
        u.data_ptr(), dt.data_ptr(), B.data_ptr(), C.data_ptr(), A.data_ptr(), D.data_ptr(),
        y.data_ptr(), hT.data_ptr(), b, S, di, ds, code, build.stream_of(u))
    build.check(err, "mamba_scan")
    build.LAUNCHES["mamba_scan"] += 1
    return y, hT


def _forward(u, dt, B, C, A, D):
    if u.device.type == "cpu":
        return mamba_scan_ref(u, dt, B, C, A, D)
    if u.device.type == "cuda":
        return mamba_scan_cuda(u.contiguous(), dt.contiguous(), B.contiguous(),
                               C.contiguous(), A.float().contiguous(), D.float().contiguous())
    raise ValueError(f"mamba_scan: no kernel for device {u.device}")


class _MambaScan(torch.autograd.Function):
    """The forward under autograd; serving-only until the hybrid family
    trains, so its backward raises."""

    @staticmethod
    def forward(ctx, u, dt, B, C, A, D):
        return _forward(u, dt, B, C, A, D)

    @staticmethod
    def backward(ctx, *grads):
        raise TypeError("mamba_scan has no backward yet: training the hybrid family needs "
                        "a hand-written backward kernel for the selective scan")


def mamba_scan(u: torch.Tensor, dt: torch.Tensor, B: torch.Tensor, C: torch.Tensor,
               A: torch.Tensor, D: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Selective scan from the zero state. u, dt: (b, S, di); B, C: (b, S,
    ds); A: (di, ds) negative; D: (di,). Returns (y (b, S, di) in u.dtype,
    the final state hT (b, di, ds) fp32)."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (u, dt, B, C, A, D)):
        return _MambaScan.apply(u, dt, B, C, A, D)
    return _forward(u, dt, B, C, A, D)
