"""Plain PyTorch versions of the paged decode kernels (GQA and absorbed
MLA): gather the block table into the logical view, then masked direct
softmax; the cold variants first substitute the dequantized int8 shadow
rows for the pages flagged cold.

The reference's ``kernels/paged_ref.py:paged_gqa_decode_ref`` computes
in q's dtype; this version holds the fp32 decode contract the kernels
(TPU and CUDA) and the gather branch of ``apply_gqa_decode_paged``
keep — scores, softmax and the sum in fp32, one rounding at the output.
For fp32 q the two are the same function."""
from __future__ import annotations

import math

import torch

from repro_torch.serving.paged_cache import paged_gather

NEG_INF = -1e30


def paged_gqa_decode_ref(q, k_pool, v_pool, block_table, seq_lens):
    """q: (b, kvh, rep, hd); pools (P+1, page, kvh, hd); block_table
    (b, n) int32; seq_lens (b,) int32. Returns (b, kvh, rep, hd) in
    q.dtype over logical positions ``pos <= seq_lens[i]``."""
    hd = q.shape[-1]
    ck = paged_gather(k_pool, block_table).float()      # (b, S, kvh, hd)
    cv = paged_gather(v_pool, block_table).float()
    S = ck.shape[1]
    pos = torch.arange(S, device=q.device)
    valid = pos[None, :] <= seq_lens[:, None].long()
    scores = torch.einsum("bgrd,bkgd->bgrk", q.float(), ck) / math.sqrt(hd)
    scores = scores.masked_fill(~valid[:, None, None, :], NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    return torch.einsum("bgrk,bkgd->bgrd", probs, cv).to(q.dtype)


def paged_gqa_decode_cold_ref(q, k_pool, v_pool, k_q8, k_scale, v_q8, v_scale,
                              block_table, seq_lens, cold_flags):
    """Cold-aware decode, plain: every page whose physical id is flagged
    in ``cold_flags`` (P+1,) int32 reads ``q8 * scale`` in fp32 from the
    int8 shadow pools ``k_q8``/``v_q8`` (P+1, page, kvh, hd) and their
    per-page scales ``k_scale``/``v_scale`` (P+1, kvh, hd); the other
    pages read the bf16 pools. The substituted fp32 pools then go
    through :func:`paged_gqa_decode_ref` — the oracle
    ``tests/test_kernels_paged.py:161-181`` builds for the reference's
    ``paged_gqa_decode_cold_pallas``."""
    sel = (cold_flags != 0)[:, None, None, None]
    k = torch.where(sel, k_q8.float() * k_scale.float()[:, None], k_pool.float())
    v = torch.where(sel, v_q8.float() * v_scale.float()[:, None], v_pool.float())
    return paged_gqa_decode_ref(q, k, v, block_table, seq_lens)


def paged_mla_decode_ref(q_lat, q_rope, ckv_pool, kr_pool, block_table, seq_lens, *,
                         scale: float):
    """Absorbed-MLA one-token decode, plain. q_lat (b, h, L) is q_nope
    already absorbed through W_uk, q_rope (b, h, R); latent pools ckv
    (P+1, page, L) and kr (P+1, page, R); ``scale`` is 1/sqrt(qk_nope +
    qk_rope), the pre-absorption head dim. The score is ``(q_lat . ckv +
    q_rope . kr) * scale`` over positions ``pos <= seq_lens[i]``; the ckv
    rows are also the values. Returns o_lat (b, h, L) in q_lat's dtype:
    the reference's ``kernels/paged_ref.py:paged_mla_decode_ref`` under
    the fp32 decode contract (scores, softmax and the sum in fp32, one
    rounding at the output)."""
    cckv = paged_gather(ckv_pool, block_table).float()  # (b, S, L)
    ckr = paged_gather(kr_pool, block_table).float()    # (b, S, R)
    S = cckv.shape[1]
    valid = torch.arange(S, device=q_lat.device)[None, :] <= seq_lens[:, None].long()
    scores = (torch.einsum("bhl,bSl->bhS", q_lat.float(), cckv)
              + torch.einsum("bhr,bSr->bhS", q_rope.float(), ckr)) * scale
    probs = torch.softmax(scores.masked_fill(~valid[:, None, :], NEG_INF), dim=-1)
    return torch.einsum("bhS,bSl->bhl", probs, cckv).to(q_lat.dtype)


def paged_mla_decode_cold_ref(q_lat, q_rope, ckv_pool, kr_pool, ckv_q8, ckv_scale, kr_q8,
                              kr_scale, block_table, seq_lens, cold_flags, *, scale: float):
    """:func:`paged_mla_decode_ref` with the cold tier: every page flagged
    in ``cold_flags`` (P+1,) int32 reads ``q8 * scale`` in fp32 from the
    int8 shadow pools ``ckv_q8`` (P+1, page, L) / ``kr_q8`` (P+1, page, R)
    and their per-page scales ``ckv_scale`` (P+1, L) / ``kr_scale``
    (P+1, R), for keys and values both — the oracle
    ``tests/test_kernels_paged.py:187-209`` builds for the reference's
    ``paged_mla_decode_cold_pallas``."""
    sel = (cold_flags != 0)[:, None, None]
    ckv = torch.where(sel, ckv_q8.float() * ckv_scale.float()[:, None], ckv_pool.float())
    kr = torch.where(sel, kr_q8.float() * kr_scale.float()[:, None], kr_pool.float())
    return paged_mla_decode_ref(q_lat, q_rope, ckv, kr, block_table, seq_lens, scale=scale)


def bf16x3(x: torch.Tensor):
    """The MLA kernel's split of an fp32 operand into three bf16 parts,
    ``x = hi + mid + lo`` (``csrc/paged_mla_decode.cu`` ``split3``): hi
    rounds x, mid rounds x - hi, lo rounds what is left. Both differences
    are exact in fp32 and the parts carry all 24 significand bits, so
    (hi + mid) + lo gives x back for normal inputs."""
    hi = x.float().to(torch.bfloat16)
    r = x.float() - hi.float()
    mid = r.to(torch.bfloat16)
    lo = (r - mid.float()).to(torch.bfloat16)
    return hi, mid, lo


def bf16x3_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a (fp32) @ b (bf16-exact values) as the kernel's tensor-core products
    take it: three bf16 products, each exact, summed in fp32, lo first."""
    hi, mid, lo = bf16x3(a)
    bf = b.float()
    return (lo.float() @ bf + mid.float() @ bf) + hi.float() @ bf
