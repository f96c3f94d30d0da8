"""Plain PyTorch version of the paged GQA decode kernel: gather the
block table into the logical view, then masked direct softmax.

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
