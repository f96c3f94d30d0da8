"""Causal flash attention: the CUDA kernels (``csrc/flash_attention.cu``),
which replace the JAX package's
``kernels/flash_attention.py:flash_attention_pallas`` (forward) and its
jnp ``nn/attention.py:_flash_bwd_impl`` (backward), and their wrappers.

The tensor's device decides: CPU tensors run the plain version
(``kernels/flash_ref.py``), CUDA tensors launch the kernel or raise.
The model reaches both through ``nn/attention.py:_flash``.

q and k are ``dk`` wide, v (and out, dout, dv) ``dv`` wide: (64, 64) and
(128, 128) for GQA, (192, 128) for deepseek's MLA in its expanded form
(q/k heads of 128 nope + 64 rope, v heads of 128). The softmax scale is
``1 / sqrt(dk)``, q's width, as the reference's.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import build
from repro_torch.kernels.flash_ref import flash_bwd_ref, flash_fwd_ref

HEAD_DIMS = ((64, 64), (128, 128), (192, 128))   # (q/k width, v width)
MAX_GROUP = 64          # query heads per kv head: one 64-row query tile


def _check(q, k, v, name):
    if q.dim() != 5 or k.dim() != 4 or v.dim() != 4:
        raise ValueError(f"{name}: q (b, s, g, r, dk), k (b, s, g, dk), v (b, s, g, dv); "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    b, sq, g, r, dk = q.shape
    dv = v.shape[-1]
    if k.shape[0] != b or k.shape[2:] != (g, dk) or v.shape[:3] != k.shape[:3]:
        raise ValueError(f"{name}: shapes q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}")
    if (dk, dv) not in HEAD_DIMS:
        raise ValueError(f"{name}: head dims (q/k {dk}, v {dv}) not in {HEAD_DIMS}")
    if r > MAX_GROUP:
        raise ValueError(f"{name}: {r} query heads per kv head > {MAX_GROUP}")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"{name}: q, k and v must share a dtype")
    return b, sq, k.shape[1], g, r, dk, dv


def _scale(d: int) -> float:
    return 1.0 / math.sqrt(d)


def flash_attention_fwd_cuda(q, k, v, causal: bool = True):
    """The forward launch: (out (b, sq, g, r, dv) in q.dtype, m, l (b, sq, g,
    r) fp32)."""
    b, sq, skv, g, r, dk, dv = _check(q, k, v, "flash_attention_fwd")
    code = build.dtype_code(q, "flash_attention_fwd")
    build.require_cuda("flash_attention_fwd", q, k, v)
    out = torch.empty((b, sq, g, r, dv), dtype=q.dtype, device=q.device)
    m = torch.empty((b, sq, g, r), dtype=torch.float32, device=q.device)
    l = torch.empty_like(m)
    err = build.library().sct_flash_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), m.data_ptr(), l.data_ptr(),
        b, sq, skv, g, r, dk, dv, int(causal), code, _scale(dk), build.stream_of(q))
    build.check(err, "flash_attention_fwd")
    build.LAUNCHES["flash_attention_fwd"] += 1
    return out, m, l


def flash_attention_bwd_cuda(q, k, v, out, m, l, dout, causal: bool = True):
    """The backward launch (a delta/dQ kernel, then a dK/dV kernel):
    (dq, dk, dv) shaped and typed like q, k and v."""
    b, sq, skv, g, r, dk_w, dv_w = _check(q, k, v, "flash_attention_bwd")
    o_shape = (b, sq, g, r, dv_w)
    if out.shape != o_shape or dout.shape != o_shape or out.dtype != q.dtype \
            or dout.dtype != q.dtype:
        raise ValueError(f"flash_attention_bwd: out and dout must be {o_shape} in q's dtype")
    if m.shape != (b, sq, g, r) or l.shape != m.shape or m.dtype != torch.float32 \
            or l.dtype != torch.float32:
        raise ValueError("flash_attention_bwd: m and l must be (b, sq, g, r) fp32")
    code = build.dtype_code(q, "flash_attention_bwd")
    build.require_cuda("flash_attention_bwd", q, k, v, out, m, l, dout)
    # the kernels' scratch: per query row delta (and, for the bf16 kernels,
    # m log2(e) and 1 / l, computed once for the dK/dV kernel)
    delta = torch.empty((3, *m.shape), dtype=torch.float32, device=q.device)
    dq = torch.empty_like(q)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    err = build.library().sct_flash_attention_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), dout.data_ptr(),
        m.data_ptr(), l.data_ptr(), delta.data_ptr(), dq.data_ptr(), dk.data_ptr(),
        dv.data_ptr(), b, sq, skv, g, r, dk_w, dv_w, int(causal), code, _scale(dk_w),
        build.stream_of(q))
    build.check(err, "flash_attention_bwd")
    build.LAUNCHES["flash_attention_bwd"] += 1
    return dq, dk, dv


def flash_attention_fwd(q, k, v, causal: bool = True):
    """q (b, sq, g, r, dk), k (b, skv, g, dk), v (b, skv, g, dv) -> (out
    (b, sq, g, r, dv), m, l (b, sq, g, r) fp32): causal online-softmax
    attention and the softmax statistics its backward needs."""
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
