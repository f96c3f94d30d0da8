"""Plain PyTorch version of the chunkwise mLSTM kernel
(``csrc/mlstm_chunk.cu``): the reference's chunk body
(``src/repro/nn/xlstm.py:59-95`` ``_mlstm_chunk_body``) looped over
chunks as its ``_mlstm_core`` loops them, in the kernel's folded
``(B = batch * heads, S, dh)`` layout, returning the final state too.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

MLSTM_CHUNK = 256
NEG_INIT = -1e30      # the stabiliser of an empty state (the reference's m0)


def init_state(B: int, dh: int, *, device) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The empty recurrent state: C (B, dh, dh) and n (B, dh) zero, m (B,)
    at -1e30."""
    return (torch.zeros((B, dh, dh), dtype=torch.float32, device=device),
            torch.zeros((B, dh), dtype=torch.float32, device=device),
            torch.full((B,), NEG_INIT, dtype=torch.float32, device=device))


def _cumsum(logf: torch.Tensor) -> torch.Tensor:
    """Prefix sums along the chunk, accumulated in fp64 and rounded once
    to fp32, as the kernel sums them. The fp64 partial sums of fp32 gate
    values are exact, or within an fp64 ulp, in any order, so the kernel's
    sequential sum and a parallel scan round to the same fp32 values;
    fp32 scans in two orders differ by an fp32 ulp of the sum, large for
    a strongly forgetting gate, and every weight exp(b_t - b_j + i_j -
    m_t) would inherit the difference."""
    return torch.cumsum(logf.double(), dim=1).float()


def _chunk_body(q, k, v, i_c, logf, C0, n0, m0):
    """One chunk: q/k/v (B, T, dh) fp32, i_c/logf (B, T); state C0 (B, dh,
    dh), n0 (B, dh), m0 (B,). Returns (out (B, T, dh), (C, n, m))."""
    T = q.shape[1]
    bcum = _cumsum(logf)                                       # (B, T)
    btot = bcum[:, -1]                                         # (B,)
    # intra-chunk log weights w_{t,j} = b_t - b_j + i_j  (j <= t)
    logD = bcum[:, :, None] - bcum[:, None, :] + i_c[:, None, :]
    causal = torch.tril(torch.ones((T, T), dtype=torch.bool, device=q.device))
    logD = logD.masked_fill(~causal, -torch.inf)
    inter = bcum + m0[:, None]                                 # (B, T)
    m_loc = torch.maximum(inter, torch.amax(logD, dim=2))      # (B, T)
    w = torch.exp(logD - m_loc[:, :, None])                    # (B, t, j)
    inter_sc = torch.exp(inter - m_loc)                        # (B, T)
    scores = torch.einsum("btd,bjd->btj", q, k)
    num = (torch.einsum("btj,bjd->btd", w * scores, v)
           + inter_sc[..., None] * torch.einsum("btd,bde->bte", q, C0))
    den = (torch.einsum("btj,btj->bt", w, scores)
           + inter_sc * torch.einsum("btd,bd->bt", q, n0))
    den = torch.maximum(torch.abs(den), torch.exp(-m_loc))
    out = num / den[..., None]
    # end-of-chunk state
    a = btot[:, None] - bcum + i_c                             # (B, T)
    m_new = torch.maximum(btot + m0, torch.amax(a, dim=1))     # (B,)
    decay0 = torch.exp(btot + m0 - m_new)
    wa = torch.exp(a - m_new[:, None])
    C_new = decay0[:, None, None] * C0 + torch.einsum("bj,bjd,bje->bde", wa, k, v)
    n_new = decay0[:, None] * n0 + torch.einsum("bj,bjd->bd", wa, k)
    return out, (C_new, n_new, m_new)


def mlstm_chunk_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    i_pre: torch.Tensor, f_pre: torch.Tensor,
                    state: Optional[Tuple[torch.Tensor, torch.Tensor, torch.Tensor]] = None,
                    *, chunk: int = MLSTM_CHUNK, ragged: bool = False):
    """Chunkwise stabilised mLSTM. q/k/v: (B, S, dh) fp32, k pre-scaled
    by 1/sqrt(dh); i_pre/f_pre: (B, S) fp32 gate pre-activations;
    ``state`` (C (B, dh, dh), n (B, dh), m (B,)) or None for the empty
    state. Returns (y (B, S, dh), (C, n, m)).

    Chunks as the reference does: T = min(chunk, S), and one chunk of
    length S when T does not divide S; with ``ragged`` the last chunk is
    shorter instead, as the kernel cuts them (``chunk`` = its 64). Any
    chunking gives the same function in exact arithmetic (m is a running
    max)."""
    B, S, dh = q.shape
    if state is None:
        state = init_state(B, dh, device=q.device)
    logf = F.logsigmoid(f_pre)
    T = min(chunk, S)
    if S % T and not ragged:
        T = S
    outs = []
    for c0 in range(0, S, T):
        sl = slice(c0, c0 + T)
        out, state = _chunk_body(q[:, sl], k[:, sl], v[:, sl], i_pre[:, sl], logf[:, sl],
                                 *state)
        outs.append(out)
    return torch.cat(outs, dim=1), state
