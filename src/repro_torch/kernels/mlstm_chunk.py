"""Chunkwise mLSTM: the CUDA kernel (``csrc/mlstm_chunk.cu``), which
replaces the JAX package's ``kernels/mlstm_chunk.py:82``
``mlstm_chunk_pallas``, and its wrapper.

The tensor's device decides: CPU tensors run the plain version
(``kernels/mlstm_ref.py``), CUDA tensors launch the kernel or raise. The
kernel has no backward yet: under autograd the wrapper's backward raises
``TypeError`` (the training slice brings a hand-written one).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels.mlstm_ref import mlstm_chunk_ref

CHUNK = 64            # the kernel's chunk length (csrc/mlstm_chunk.cu kT)
COLS = 32             # value columns of C per state block (kDv)
MAX_DH = 1024         # C's column slice must fit one block's shared memory

State = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def mlstm_chunk_cuda(q, k, v, i_pre, f_pre, state: Optional[State] = None):
    """The kernel launch: q/k/v (B, S, dh), i_pre/f_pre (B, S) and the
    optional state (C (B, dh, dh), n (B, dh), m (B,)), all fp32 and
    contiguous on one CUDA device; dh a multiple of 32, at most 1024.
    Returns (y, (C, n, m)). One call is two launches (scores, then the
    state walk) and counts once."""
    B, S, dh = q.shape
    if k.shape != q.shape or v.shape != q.shape or i_pre.shape != (B, S) \
            or f_pre.shape != (B, S):
        raise ValueError(f"mlstm_chunk: shapes q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}, i_pre {tuple(i_pre.shape)}, "
                         f"f_pre {tuple(f_pre.shape)}")
    tensors = [q, k, v, i_pre, f_pre]
    if state is not None:
        C0, n0, m0 = state
        if C0.shape != (B, dh, dh) or n0.shape != (B, dh) or m0.shape != (B,):
            raise ValueError(f"mlstm_chunk: state shapes C {tuple(C0.shape)}, n "
                             f"{tuple(n0.shape)}, m {tuple(m0.shape)} for {(B, S, dh)}")
        tensors += [C0, n0, m0]
    for t in tensors:
        if t.dtype != torch.float32:
            raise TypeError(f"mlstm_chunk: the kernel takes fp32, got {t.dtype}")
    if S < 1 or dh % COLS or dh > MAX_DH:
        raise ValueError(f"mlstm_chunk: S={S}, dh={dh}: the kernel takes S >= 1 and dh a "
                         f"multiple of {COLS}, at most {MAX_DH}")
    build.require_cuda("mlstm_chunk", *tensors)
    if any(t.data_ptr() % 16 for t in tensors[:3] + tensors[5:6]):
        raise ValueError("mlstm_chunk: q, k, v and C0 must be 16-byte aligned (the kernel "
                         "reads their rows as float4)")
    dev = q.device
    nc = -(-S // CHUNK)
    scores = torch.empty((B, nc, CHUNK, CHUNK), dtype=torch.float32, device=dev)
    y = torch.empty_like(q)
    C = torch.empty((B, dh, dh), dtype=torch.float32, device=dev)
    n = torch.empty((B, dh), dtype=torch.float32, device=dev)
    m = torch.empty((B,), dtype=torch.float32, device=dev)
    st = [t.data_ptr() for t in state] if state is not None else [None] * 3
    err = build.library().sct_mlstm_chunk(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), i_pre.data_ptr(), f_pre.data_ptr(),
        *st, scores.data_ptr(), y.data_ptr(), C.data_ptr(), n.data_ptr(), m.data_ptr(),
        B, S, dh, build.stream_of(q))
    build.check(err, "mlstm_chunk")
    build.LAUNCHES["mlstm_chunk"] += 1
    return y, (C, n, m)


def _forward(q, k, v, i_pre, f_pre, state):
    if q.device.type == "cpu":
        return mlstm_chunk_ref(q, k, v, i_pre, f_pre, state)
    if q.device.type == "cuda":
        st = tuple(t.contiguous() for t in state) if state is not None else None
        return mlstm_chunk_cuda(q.contiguous(), k.contiguous(), v.contiguous(),
                                i_pre.contiguous(), f_pre.contiguous(), st)
    raise ValueError(f"mlstm_chunk: no kernel for device {q.device}")


class _MLSTMChunk(torch.autograd.Function):
    """The forward under autograd; serving-only until the training slice,
    so its backward raises."""

    @staticmethod
    def forward(ctx, q, k, v, i_pre, f_pre, C0, n0, m0):
        state = (C0, n0, m0) if C0 is not None else None
        y, (C, n, m) = _forward(q, k, v, i_pre, f_pre, state)
        return y, C, n, m

    @staticmethod
    def backward(ctx, *grads):
        raise TypeError(
            "mlstm_chunk has no backward yet: training the ssm_lm family needs a "
            "hand-written backward kernel (the training slice)")


def mlstm_chunk(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, i_pre: torch.Tensor,
                f_pre: torch.Tensor, state: Optional[State] = None):
    """Chunkwise stabilised mLSTM over the folded (B = batch * heads)
    layout. q/k/v: (B, S, dh) fp32, k pre-scaled by 1/sqrt(dh);
    i_pre/f_pre: (B, S) fp32; ``state``: (C (B, dh, dh), n (B, dh),
    m (B,)) or None for the empty state. Returns (y (B, S, dh),
    (C, n, m))."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad
            for t in (q, k, v, i_pre, f_pre, *(state or ()))):
        C0, n0, m0 = state if state is not None else (None, None, None)
        y, C, n, m = _MLSTMChunk.apply(q, k, v, i_pre, f_pre, C0, n0, m0)
        return y, (C, n, m)
    return _forward(q, k, v, i_pre, f_pre, state)
