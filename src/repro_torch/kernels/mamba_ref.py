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

:func:`mamba_scan_fwd_ref` is the same forward returning, beside (y, hT),
the states the training forward records for the backward: h before every
``record_steps(ds)``-th step. :func:`mamba_scan_bwd_ref` is the plain
version of the backward kernel (``csrc/mamba_scan_bwd.cu``), in its
order: it recomputes h over each recorded stretch of steps from the
state recorded at its start and runs the reverse recurrence, with
g_t = dL/dh_t,

    g_t   = dy_t C_t + exp(dt_{t+1} A) * g_{t+1}       (g_{S-1}: + dhT)
    du_t  = dt_t sum_j g_t B_t + dy_t D
    ddt_t = sum_j g_t (A exp(dt_t A) h_{t-1}) + u_t sum_j g_t B_t
    dB_t  = sum_d g_t dt_t u_t,   dC_t = sum_d dy_t h_t
    dA    = sum_{b,t} g_t dt_t exp(dt_t A) h_{t-1},   dD = sum_{b,t} dy_t u_t

the sums over the states as the forward's tree, the sums over channels
as a tree over each block's 32 channels and then block after block in
order, dA and dD accumulated step after step from the last and then
batch row after batch row.

:func:`mamba_scan_twin_ref` is the reference model's jnp twin
(``src/repro/nn/mamba.py:49-76`` ``_ssm_scan``), which carries h in u's
dtype: the same function in fp32, another rounding in bf16.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

CHANNELS = 32                         # channels a block, one a lane (csrc kChannels)
TILE = 32                             # time steps a staged tile of the forward (csrc kTile)


def record_steps(ds: int) -> int:
    """Steps between the states the training forward records, the
    backward's tile: 32 up to d_state 16, 512 / d_state above, so that a
    tile's states and exps (2 x steps x 32 channels x d_state fp32) take
    at most 128 KB of a block's shared memory."""
    return TILE if ds <= 16 else max(1, 512 // ds)


def tree_sum(x: torch.Tensor) -> torch.Tensor:
    """The sum over the last axis (a power of two wide) as a binary tree
    over neighbouring pairs."""
    while x.shape[-1] > 1:
        x = x[..., 0::2] + x[..., 1::2]
    return x[..., 0]


def _scan(u, dt, B, C, A, D):
    """(y in u.dtype, hT fp32, every step's state h_t fp32)."""
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
    return (y + uf * D.float()).to(u.dtype), h, hs


def mamba_scan_ref(u: torch.Tensor, dt: torch.Tensor, B: torch.Tensor, C: torch.Tensor,
                   A: torch.Tensor, D: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """u, dt: (b, S, di); B, C: (b, S, ds) with ds a power of two; A:
    (di, ds); D: (di,); any dtype and strides. Returns (y (b, S, di) in
    u.dtype, final state hT (b, di, ds) fp32). Only the state update is a
    loop over time; the factors before it and the sums after it run over
    every step at once, each element by the same operations."""
    y, h, _ = _scan(u, dt, B, C, A, D)
    return y, h


def mamba_scan_fwd_ref(u, dt, B, C, A, D):
    """:func:`mamba_scan_ref` and the states the training forward records:
    (y, hT, starts), starts (b, ceil(S / R), di, ds) fp32 with starts[:, k]
    the state before step k R (zero for k = 0), R = ``record_steps(ds)``."""
    y, h, hs = _scan(u, dt, B, C, A, D)
    b, S, di = u.shape
    R = record_steps(B.shape[-1])
    starts = [torch.zeros_like(h)] + [hs[k - 1] for k in range(R, S, R)]
    return y, h, torch.stack(starts, dim=1)


def _block_sum(x: torch.Tensor) -> torch.Tensor:
    """(b, n, nblk * 32, ds) -> (b, nblk, n, ds): each block's 32 channels
    summed as a binary tree over neighbouring pairs."""
    b, n, dp, ds = x.shape
    x = x.reshape(b, n, dp // CHANNELS, CHANNELS, ds).transpose(-1, -2)
    return tree_sum(x).transpose(1, 2)


def mamba_scan_bwd_ref(u, dt, B, C, A, D, starts, dy, dhT: Optional[torch.Tensor] = None):
    """The backward of :func:`mamba_scan_ref` from the recorded ``starts``
    (:func:`mamba_scan_fwd_ref`), dy (b, S, di) and, or None (zero), the
    final state's gradient dhT (b, di, ds). Returns (du, ddt, dB, dC, dA,
    dD): du, ddt, dB and dC in u's dtype (dB, dC contiguous), dA and dD in
    A's and D's. Everything is fp32 and every product and sum its own
    rounded operation, in the kernel's order (module docstring): channels
    are padded to whole blocks of 32 with zeros, which add exact zeros."""
    b, S, di = u.shape
    ds = B.shape[-1]
    R = record_steps(ds)
    nblk = -(-di // CHANNELS)
    pad = nblk * CHANNELS - di
    dev, f32 = u.device, torch.float32
    uf, dtf, dyf = (F.pad(t.float(), (0, pad)) for t in (u, dt, dy))
    Bf, Cf = B.float(), C.float()
    Af = F.pad(A.float(), (0, 0, 0, pad))
    Df = F.pad(D.float(), (0, pad))
    hs0 = F.pad(starts.float(), (0, 0, 0, pad))
    r = (torch.zeros((b, di + pad, ds), dtype=f32, device=dev) if dhT is None
         else F.pad(dhT.float(), (0, 0, 0, pad)))
    dA_acc = torch.zeros((b, di + pad, ds), dtype=f32, device=dev)
    dD_acc = torch.zeros((b, di + pad), dtype=f32, device=dev)
    du = torch.empty((b, S, di + pad), dtype=f32, device=dev)
    ddt = torch.empty_like(du)
    pB = torch.empty((b, nblk, S, ds), dtype=f32, device=dev)
    pC = torch.empty_like(pB)
    for k in reversed(range(-(-S // R))):
        sl = slice(k * R, min(S, (k + 1) * R))
        nt = sl.stop - sl.start
        ut, dtt, dyt, Bt, Ct = uf[:, sl], dtf[:, sl], dyf[:, sl], Bf[:, sl], Cf[:, sl]
        a = torch.exp(dtt[..., None] * Af)                            # (b, nt, di, ds)
        dut = dtt * ut
        dBu = dut[..., None] * Bt[:, :, None, :]
        h, H = hs0[:, k], []
        for j in range(nt):
            h = a[:, j] * h + dBu[:, j]
            H.append(h)
        H = torch.stack(H, dim=1)
        Hprev = torch.cat([hs0[:, k, None], H[:, :-1]], dim=1)
        Gs = [None] * nt
        for j in reversed(range(nt)):
            G = dyt[:, j, :, None] * Ct[:, j, None, :] + r
            r = a[:, j] * G
            Gs[j] = G
        Gs = torch.stack(Gs, dim=1)
        q = Gs * (a * Hprev)
        sB = tree_sum(Gs * Bt[:, :, None, :])
        sA = tree_sum(q * Af)
        du[:, sl] = dtt * sB + dyt * Df
        ddt[:, sl] = sA + ut * sB
        for j in reversed(range(nt)):
            dA_acc = dA_acc + q[:, j] * dtt[:, j, :, None]
            dD_acc = dD_acc + dyt[:, j] * ut[:, j]
        pC[:, :, sl] = _block_sum(dyt[..., None] * H)
        pB[:, :, sl] = _block_sum(Gs * dut[..., None])
    dB, dC = pB[:, 0], pC[:, 0]
    for n in range(1, nblk):
        dB, dC = dB + pB[:, n], dC + pC[:, n]
    dA, dD = dA_acc[0], dD_acc[0]
    for n in range(1, b):
        dA, dD = dA + dA_acc[n], dD + dD_acc[n]
    return (du[..., :di].to(u.dtype).contiguous(), ddt[..., :di].to(u.dtype).contiguous(),
            dB.to(u.dtype), dC.to(u.dtype), dA[:di].to(A.dtype), dD[:di].to(D.dtype))


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
