"""Causal flash attention: the CUDA kernels (``csrc/flash_attention.cu``),
which replace the JAX package's
``kernels/flash_attention.py:flash_attention_pallas`` (forward) and its
jnp ``nn/attention.py:_flash_bwd_impl`` (backward), and their wrappers.

The tensor's device decides: CPU tensors run the plain version
(``kernels/flash_ref.py``), CUDA tensors launch the kernel or raise.
The model reaches both through ``nn/attention.py:_flash``.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import build
from repro_torch.kernels.flash_ref import flash_bwd_ref, flash_fwd_ref

HEAD_DIMS = (64, 128)
MAX_GROUP = 64          # query heads per kv head: one 64-row query tile


def _check(q, k, v, name):
    if q.dim() != 5 or k.dim() != 4 or v.dim() != 4:
        raise ValueError(f"{name}: q (b, s, g, r, d), k/v (b, s, g, d); got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    b, sq, g, r, d = q.shape
    if k.shape[0] != b or k.shape[2:] != (g, d) or v.shape != k.shape:
        raise ValueError(f"{name}: shapes q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}")
    if d not in HEAD_DIMS:
        raise ValueError(f"{name}: head dim {d} not in {HEAD_DIMS}")
    if r > MAX_GROUP:
        raise ValueError(f"{name}: {r} query heads per kv head > {MAX_GROUP}")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"{name}: q, k and v must share a dtype")
    return b, sq, k.shape[1], g, r, d


def _scale(d: int) -> float:
    return 1.0 / math.sqrt(d)


def flash_attention_fwd_cuda(q, k, v, causal: bool = True):
    """The forward launch: (out in q.dtype, m, l (b, sq, g, r) fp32)."""
    b, sq, skv, g, r, d = _check(q, k, v, "flash_attention_fwd")
    code = build.dtype_code(q, "flash_attention_fwd")
    build.require_cuda("flash_attention_fwd", q, k, v)
    out = torch.empty_like(q)
    m = torch.empty((b, sq, g, r), dtype=torch.float32, device=q.device)
    l = torch.empty_like(m)
    err = build.library().sct_flash_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), m.data_ptr(), l.data_ptr(),
        b, sq, skv, g, r, d, int(causal), code, _scale(d), build.stream_of(q))
    build.check(err, "flash_attention_fwd")
    build.LAUNCHES["flash_attention_fwd"] += 1
    return out, m, l


def flash_attention_bwd_cuda(q, k, v, out, m, l, dout, causal: bool = True):
    """The backward launch (a delta/dQ kernel, then a dK/dV kernel):
    (dq, dk, dv) in q's, k's and v's dtype."""
    b, sq, skv, g, r, d = _check(q, k, v, "flash_attention_bwd")
    if out.shape != q.shape or dout.shape != q.shape or out.dtype != q.dtype \
            or dout.dtype != q.dtype:
        raise ValueError("flash_attention_bwd: out and dout must match q")
    if m.shape != (b, sq, g, r) or l.shape != m.shape or m.dtype != torch.float32 \
            or l.dtype != torch.float32:
        raise ValueError("flash_attention_bwd: m and l must be (b, sq, g, r) fp32")
    code = build.dtype_code(q, "flash_attention_bwd")
    build.require_cuda("flash_attention_bwd", q, k, v, out, m, l, dout)
    delta = torch.empty_like(m)
    dq = torch.empty_like(q)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    err = build.library().sct_flash_attention_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), dout.data_ptr(),
        m.data_ptr(), l.data_ptr(), delta.data_ptr(), dq.data_ptr(), dk.data_ptr(),
        dv.data_ptr(), b, sq, skv, g, r, d, int(causal), code, _scale(d),
        build.stream_of(q))
    build.check(err, "flash_attention_bwd")
    build.LAUNCHES["flash_attention_bwd"] += 1
    return dq, dk, dv


def flash_attention_fwd(q, k, v, causal: bool = True):
    """q (b, sq, g, r, d), k/v (b, skv, g, d) -> (out (b, sq, g, r, d),
    m, l (b, sq, g, r) fp32): causal online-softmax attention and the
    softmax statistics its backward needs."""
    if q.device.type == "cpu":
        return flash_fwd_ref(q, k, v, causal)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_fwd: no kernel for device {q.device}")
    return flash_attention_fwd_cuda(q.contiguous(), k.contiguous(), v.contiguous(), causal)


def flash_attention_bwd(q, k, v, out, m, l, dout, causal: bool = True):
    """Gradients of :func:`flash_attention_fwd` from the saved
    (q, k, v, out, m, l) and dout: (dq, dk, dv)."""
    if q.device.type == "cpu":
        return flash_bwd_ref(q, k, v, out, m, l, dout, causal)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_bwd: no kernel for device {q.device}")
    c = [t.contiguous() for t in (q, k, v, out, m, l, dout)]
    return flash_attention_bwd_cuda(*c, causal)
