"""Plain PyTorch version of the selective-scan kernel
(``csrc/mamba_scan.cu``): the recurrence of the JAX package's Pallas
kernel (``src/repro/kernels/mamba_scan.py:27-49``) step by step, in the
kernel's arithmetic, returning the final state too.

    h_t = exp(dt_t * A) * h_{t-1} + (dt_t * u_t) * B_t        (h from zero)
    y_t = sum_j h_t[:, j] * C_t[j] + u_t * D

Everything is fp32 (inputs converted exactly, whatever their dtype and
strides), y rounds once a step to u's dtype, the final h stays fp32. The
sum over the state axis is a binary tree over neighbouring pairs,
((p0 + p1) + (p2 + p3)) + ..., the order in which the kernel sums (each
thread its contiguous states, then the groups' partials), and every
product and sum is its own rounded operation, as the kernel computes it
without fused multiply-adds: with the same ``exp`` the two agree bit for
bit.

:func:`mamba_scan_twin_ref` is the reference model's jnp twin
(``src/repro/nn/mamba.py:49-76`` ``_ssm_scan``), which carries h in u's
dtype: the same function in fp32, another rounding in bf16.
"""
from __future__ import annotations

from typing import Tuple

import torch


def tree_sum(x: torch.Tensor) -> torch.Tensor:
    """The sum over the last axis (a power of two wide) as a binary tree
    over neighbouring pairs."""
    while x.shape[-1] > 1:
        x = x[..., 0::2] + x[..., 1::2]
    return x[..., 0]


def mamba_scan_ref(u: torch.Tensor, dt: torch.Tensor, B: torch.Tensor, C: torch.Tensor,
                   A: torch.Tensor, D: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """u, dt: (b, S, di); B, C: (b, S, ds) with ds a power of two; A:
    (di, ds); D: (di,); any dtype and strides. Returns (y (b, S, di) in
    u.dtype, final state hT (b, di, ds) fp32). Only the state update is a
    loop over time; the factors before it and the sums after it run over
    every step at once, each element by the same operations."""
    b, S, di = u.shape
    ds = B.shape[-1]
    if ds < 1 or ds & (ds - 1):
        raise ValueError(f"mamba_scan_ref: d_state {ds} is not a power of two")
    uf, dtf, Bf, Cf = (t.float() for t in (u, dt, B, C))
    dA = torch.exp(dtf[..., None] * A.float())                   # (b, S, di, ds)
    dBu = (dtf * uf)[..., None] * Bf[:, :, None, :]
    h = torch.zeros((b, di, ds), dtype=torch.float32, device=u.device)
    hs = []
    for t in range(S):
        h = dA[:, t] * h + dBu[:, t]
        hs.append(h)
    y = tree_sum(torch.stack(hs, dim=1) * Cf[:, :, None, :])
    return (y + uf * D.float()).to(u.dtype), h


def mamba_scan_twin_ref(u, dt, B, C, A, D) -> Tuple[torch.Tensor, torch.Tensor]:
    """The reference model's scan (its ``_ssm_scan``): h carried in
    u's dtype from zero, y = h . C, then ``+ u * D`` in u's dtype.
    Returns (y, hT), both in u.dtype."""
    b, S, di = u.shape
    h = torch.zeros((b, di, B.shape[-1]), dtype=u.dtype, device=u.device)
    A = A.to(u.dtype)
    ys = []
    for t in range(S):
        dA = torch.exp(dt[:, t, :, None] * A[None])
        h = dA * h + dt[:, t, :, None] * B[:, t, None, :] * u[:, t, :, None]
        ys.append(torch.einsum("bds,bs->bd", h, C[:, t]))
    return torch.stack(ys, dim=1) + u * D.to(u.dtype), h
