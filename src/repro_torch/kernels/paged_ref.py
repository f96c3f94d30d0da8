"""Plain PyTorch versions of the paged GQA decode kernels: gather the
block table into the logical view, then masked direct softmax; the cold
variant first substitutes the dequantized int8 shadow rows for the
pages flagged cold.

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
