"""Plain PyTorch versions of the flash-attention kernels
(``csrc/flash_attention.cu``): the CPU path of the model's flash branch
and the oracle the kernels are held against on the card.

``flash_fwd_ref`` / ``flash_bwd_ref`` mirror the JAX package's
``nn/attention.py:_flash_fwd_impl`` / ``_flash_bwd_impl`` step for step:
the same q/kv chunking (``FLASH_Q_CHUNK`` 2048, ``FLASH_KV_CHUNK``
4096) and the same casts: the products Q·K^T and dO·V^T come out of
their einsums in the inputs' dtype (rounded once) and are cast to fp32,
the softmax and its statistics are fp32, ``p`` is rounded to q's dtype
before P·V, ``ds`` before dQ and dK, and the accumulators are fp32. The
roundings matter in bf16: ``dp - delta`` cancels, so a dp formed in
fp32 instead moves some gradients by more than the bf16 rung. A ragged last chunk is sliced, so any length
runs (the model's flash branch only sees multiples of the chunks).

Layouts are the model's grouped ones: q ``(b, s, g, r, d)``, k/v
``(b, s, g, d)``; the softmax statistics ``m``/``l`` are ``(b, s, g, r)``
fp32, the layout the kernels write.
"""
from __future__ import annotations

import math

import torch

NEG_INF = -1e30
FLASH_Q_CHUNK = 2048
FLASH_KV_CHUNK = 4096


def flash_attention_ref(q, k, v, *, causal: bool = True):
    """The reference's ``kernels/flash_ref.py`` oracle: q (B, sq, d),
    k/v (B, skv, d) with batch and heads folded; fp32 softmax."""
    d = q.shape[-1]
    s = torch.einsum("bqd,bkd->bqk", q, k).float() / math.sqrt(d)
    if causal:
        sq, sk = q.shape[1], k.shape[1]
        mask = torch.arange(sq, device=q.device)[:, None] >= torch.arange(sk, device=q.device)
        s = s.masked_fill(~mask[None], NEG_INF)
    p = torch.softmax(s, dim=-1).to(q.dtype)
    return torch.einsum("bqk,bkd->bqd", p, v)


def _chunks(n: int, c: int):
    return [(i, min(i + c, n)) for i in range(0, n, c)]


def _scores(q_i, k_j, qpos, kpos, causal: bool, scale: float):
    """(b, g, r, cq, ck) fp32 scores of one chunk pair, masked."""
    s_ij = torch.einsum("bqgrd,bkgd->bgrqk", q_i, k_j).float() * scale
    if causal:
        mask = qpos[:, None] >= kpos[None, :]
        s_ij = s_ij.masked_fill(~mask[None, None, None], NEG_INF)
    return s_ij


def flash_fwd_ref(q, k, v, causal: bool = True):
    """q (b, sq, g, r, d), k (b, skv, g, d), v (b, skv, g, dv) ->
    (out (b, sq, g, r, dv) in q.dtype, m, l (b, sq, g, r) fp32)."""
    b, sq, g, r, d = q.shape
    skv = k.shape[1]
    dv = v.shape[-1]
    scale = 1.0 / math.sqrt(d)
    dev = q.device
    outs, ms, ls = [], [], []
    for q0, q1 in _chunks(sq, min(FLASH_Q_CHUNK, sq)):
        q_i = q[:, q0:q1]
        qpos = torch.arange(q0, q1, device=dev)
        acc = torch.zeros((b, g, r, q1 - q0, dv), dtype=torch.float32, device=dev)
        m = torch.full((b, g, r, q1 - q0), NEG_INF, dtype=torch.float32, device=dev)
        l = torch.zeros((b, g, r, q1 - q0), dtype=torch.float32, device=dev)
        for k0, k1 in _chunks(skv, min(FLASH_KV_CHUNK, skv)):
            s_ij = _scores(q_i, k[:, k0:k1], qpos, torch.arange(k0, k1, device=dev),
                           causal, scale)
            m_new = torch.maximum(m, s_ij.amax(dim=-1))
            p = torch.exp(s_ij - m_new[..., None])
            alpha = torch.exp(m - m_new)
            l = l * alpha + p.sum(dim=-1)
            acc = acc * alpha[..., None] + torch.einsum(
                "bgrqk,bkgd->bgrqd", p.to(q.dtype), v[:, k0:k1]).float()
            m = m_new
        out = acc / torch.clamp(l[..., None], min=1e-30)
        outs.append(out.permute(0, 3, 1, 2, 4).to(q.dtype))
        ms.append(m.permute(0, 3, 1, 2))
        ls.append(l.permute(0, 3, 1, 2))
    return torch.cat(outs, 1), torch.cat(ms, 1).contiguous(), torch.cat(ls, 1).contiguous()


def flash_bwd_ref(q, k, v, out, m, l, dout, causal: bool = True):
    """The recompute-p flash backward (``_flash_bwd_impl``):
      delta_i = rowsum(dO_i * O_i)
      p_ij    = exp(s_ij - m_i) / l_i
      dV_j   += p_ij^T dO_i
      ds_ij   = p_ij * (dO_i V_j^T - delta_i) * scale
      dQ_i   += ds_ij K_j ;  dK_j += ds_ij^T Q_i
    Returns (dq in q.dtype, dk in k.dtype, dv in v.dtype); dk/dv sum
    over the r heads of each group."""
    b, sq, g, r, d = q.shape
    skv = k.shape[1]
    dv_dim = v.shape[-1]
    scale = 1.0 / math.sqrt(d)
    dev = q.device
    dk_acc = torch.zeros((b, skv, g, d), dtype=torch.float32, device=dev)
    dv_acc = torch.zeros((b, skv, g, dv_dim), dtype=torch.float32, device=dev)
    dqs = []
    for q0, q1 in _chunks(sq, min(FLASH_Q_CHUNK, sq)):
        q_i = q[:, q0:q1]
        do_i = dout[:, q0:q1].float()
        o_i = out[:, q0:q1].float()
        m_i = m[:, q0:q1].permute(0, 2, 3, 1)                    # (b, g, r, cq)
        l_i = torch.clamp(l[:, q0:q1].permute(0, 2, 3, 1), min=1e-30)
        delta = torch.einsum("bqgrd,bqgrd->bgrq", do_i, o_i)
        qpos = torch.arange(q0, q1, device=dev)
        dq_i = torch.zeros((b, q1 - q0, g, r, d), dtype=torch.float32, device=dev)
        for k0, k1 in _chunks(skv, min(FLASH_KV_CHUNK, skv)):
            k_j, v_j = k[:, k0:k1], v[:, k0:k1]
            s_ij = _scores(q_i, k_j, qpos, torch.arange(k0, k1, device=dev), causal, scale)
            p = torch.exp(s_ij - m_i[..., None]) / l_i[..., None]
            pv = p.to(v.dtype)
            dv_j = torch.einsum("bgrqk,bqgrd->bkgd", pv, do_i.to(v.dtype))
            dp = torch.einsum("bqgrd,bkgd->bgrqk", do_i.to(v.dtype), v_j).float()
            ds = p * (dp - delta[..., None]) * scale
            dsq = ds.to(q.dtype)
            dq_i = dq_i + torch.einsum("bgrqk,bkgd->bqgrd", dsq, k_j).float()
            dk_j = torch.einsum("bgrqk,bqgrd->bkgd", dsq, q_i)
            dk_acc[:, k0:k1] += dk_j.float()
            dv_acc[:, k0:k1] += dv_j.float()
        dqs.append(dq_i)
    dq = torch.cat(dqs, 1).to(q.dtype)
    return dq, dk_acc.to(k.dtype), dv_acc.to(v.dtype)
