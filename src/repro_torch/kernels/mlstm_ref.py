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


def init_state(B: int, dh: int, *, device,
               dtype=torch.float32) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The empty recurrent state: C (B, dh, dh) and n (B, dh) zero, m (B,)
    at -1e30."""
    return (torch.zeros((B, dh, dh), dtype=dtype, device=device),
            torch.zeros((B, dh), dtype=dtype, device=device),
            torch.full((B,), NEG_INIT, dtype=dtype, device=device))


def _cumsum(logf: torch.Tensor) -> torch.Tensor:
    """Prefix sums along the chunk, accumulated in fp64 and rounded once
    to fp32, as the kernel sums them. The fp64 partial sums of fp32 gate
    values are exact, or within an fp64 ulp, in any order, so the kernel's
    sequential sum and a parallel scan round to the same fp32 values;
    fp32 scans in two orders differ by an fp32 ulp of the sum, large for
    a strongly forgetting gate, and every weight exp(b_t - b_j + i_j -
    m_t) would inherit the difference."""
    return torch.cumsum(logf.double(), dim=1).to(logf.dtype)


def _chunk_body(q, k, v, i_c, logf, C0, n0, m0):
    """One chunk: q/k/v (B, T, dh) fp32, i_c/logf (B, T); state C0 (B, dh,
    dh), n0 (B, dh), m0 (B,). Returns (out (B, T, dh), (C, n, m))."""
    T = q.shape[1]
    bcum = _cumsum(logf)                                       # (B, T)
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
    return out, _state_pass(k, v, i_c, logf, C0, n0, m0)


def _state_pass(k, v, i_c, logf, C0, n0, m0):
    """The end-of-chunk state (C, n, m) of :func:`_chunk_body`."""
    bcum = _cumsum(logf)
    btot = bcum[:, -1]
    a = btot[:, None] - bcum + i_c                             # (B, T)
    m_new = torch.maximum(btot + m0, torch.amax(a, dim=1))     # (B,)
    decay0 = torch.exp(btot + m0 - m_new)
    wa = torch.exp(a - m_new[:, None])
    C_new = decay0[:, None, None] * C0 + torch.einsum("bj,bjd,bje->bde", wa, k, v)
    n_new = decay0[:, None] * n0 + torch.einsum("bj,bjd->bd", wa, k)
    return C_new, n_new, m_new


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
    shorter instead, as the kernel cuts them (``chunk`` = its 256). Any
    chunking gives the same function in exact arithmetic (m is a running
    max)."""
    B, S, dh = q.shape
    if state is None:
        state = init_state(B, dh, device=q.device, dtype=q.dtype)
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


def _gate_share(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """The share of max(x, y)'s gradient that goes to x: 1, 0, or 0.5 at a
    tie (autograd's split of ``torch.maximum``)."""
    return torch.where(x > y, 1.0, torch.where(x == y, 0.5, 0.0))


def _argmax_share(x: torch.Tensor, mx: torch.Tensor, dim: int) -> torch.Tensor:
    """Where x along ``dim`` equals its max ``mx``, one over the number of
    such entries, else 0 (autograd's split of ``torch.amax`` among ties)."""
    hit = (x == mx.unsqueeze(dim)).to(x.dtype)
    return hit / hit.sum(dim, keepdim=True)


def _dot64(eq: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``torch.einsum(eq, a, b)`` summed in fp64 and rounded once: the
    products of fp32 values are exact in fp64, so the kernel and this
    version, which sum in other orders, round to the same value."""
    return torch.einsum(eq, a.double(), b.double()).to(a.dtype)


def _chunk_bwd(q, k, v, i_c, logf, C0, n0, m0, y, dy, dC1, dn1, dm1):
    """The gradients of one chunk of :func:`_chunk_body`, given those of its
    outputs y (B, T, dh) and of its end state (dC1, dn1, dm1). Returns the
    chunk's (dq, dk, dv, di, db) with db the gradient of its log-forget
    prefix sums, and (dC0, dn0, dm0) of its start state.

    The algorithm of ``csrc/mlstm_chunk_bwd.cu``. With D_t = dy_t . y_t
    (y_t = num_t / den_t, so den's gradient needs no num), den_raw the
    un-clamped denominator and e_t = exp(inter_t - m_loc_t): dnum_t =
    dy_t / den_t, dP_tj = dnum_t . v_j + dden_raw_t, G = dP * P, and
    e_t's gradient times e_t is q_t . (dq's carried-state term), so q @ C0
    is never formed again. The scores and the dots dy . v and dy . y are
    summed in fp64 and rounded once, as the kernel sums them. The
    stabilisers' gradients (m_loc's, and the end state's m) are computed as
    autograd computes them and go to their argmax, split evenly among
    ties."""
    bcum = _cumsum(logf)
    btot = bcum[:, -1]
    T = q.shape[1]
    causal = torch.tril(torch.ones((T, T), dtype=torch.bool, device=q.device))
    logD = (bcum[:, :, None] - bcum[:, None, :] + i_c[:, None, :]).masked_fill(~causal,
                                                                               -torch.inf)
    inter = bcum + m0[:, None]
    rowmax = torch.amax(logD, dim=2)
    m_loc = torch.maximum(inter, rowmax)
    w = torch.exp(logD - m_loc[:, :, None])
    e = torch.exp(inter - m_loc)
    P = w * _dot64("btd,bjd->btj", q, k)
    den_raw = P.sum(2) + e * _dot64("btd,bd->bt", q, n0)
    floor = torch.exp(-m_loc)
    den = torch.maximum(torch.abs(den_raw), floor)
    D = _dot64("btd,btd->bt", dy, y)
    dden = -D / den
    to_abs = _gate_share(torch.abs(den_raw), floor)
    dden_raw = dden * to_abs * torch.sign(den_raw)
    dm_floor = -dden * (1.0 - to_abs) * floor
    s = 1.0 / den
    # dP_tj = s_t (dy_t . v_j - D_t), |den_raw| binding: where a row's weight
    # sits on one j, y_t ~ v_j and the two dots cancel; both are rounded
    # once from fp64 sums, so the difference is the same in any order
    D_abs = D * to_abs * torch.sign(den_raw)
    dP = (s[..., None] * (_dot64("btd,bjd->btj", dy, v) - D_abs[..., None])).masked_fill(
        ~causal, 0.0)
    dS = dP * w
    G = dP * P
    # the carried state's share of dq: e_t (C0 dnum_t + dden_raw_t n0); its
    # dot with q_t is e_t's gradient times e_t
    dq_state = ((e * s)[..., None] * torch.einsum("bte,bde->btd", dy, C0)
                + (e * dden_raw)[..., None] * n0[:, None, :])
    dinter = torch.einsum("btd,btd->bt", q, dq_state)
    dm_loc = dm_floor - G.sum(2) - dinter
    to_inter = _gate_share(inter, rowmax)
    dinter = dinter + dm_loc * to_inter
    dlogD = G + _argmax_share(logD, rowmax, 2) * (dm_loc * (1.0 - to_inter))[..., None]
    dq = torch.einsum("btj,bjd->btd", dS, k) + dq_state
    dk = torch.einsum("btj,btd->bjd", dS, q)
    dv = torch.einsum("btj,btd->bjd", P * s[..., None], dy)
    di = dlogD.sum(1)
    db = dlogD.sum(2) - dlogD.sum(1) + dinter
    # the end state: C1 = decay0 C0 + sum_j wa_j k_j v_j^T, n1 likewise
    a = btot[:, None] - bcum + i_c
    amax_a = torch.amax(a, dim=1)
    x0 = btot + m0
    m1 = torch.maximum(x0, amax_a)
    decay0 = torch.exp(x0 - m1)
    wa = torch.exp(a - m1[:, None])
    dCv = torch.einsum("bje,bde->bjd", v, dC1) + dn1[:, None, :]     # dC1 v_j + dn1
    dk = dk + wa[..., None] * dCv
    dv = dv + wa[..., None] * torch.einsum("bjd,bde->bje", k, dC1)
    da = wa * torch.einsum("bjd,bjd->bj", k, dCv)
    ddecay = torch.einsum("bde,bde->b", dC1, C0) + torch.einsum("bd,bd->b", dn1, n0)
    dm1_all = dm1 - da.sum(1) - ddecay * decay0
    to_x0 = _gate_share(x0, amax_a)
    dx0 = ddecay * decay0 + dm1_all * to_x0
    da = da + _argmax_share(a, amax_a, 1) * (dm1_all * (1.0 - to_x0))[:, None]
    di = di + da
    db = db - da
    db[:, -1] += da.sum(1) + dx0
    dm0 = dinter.sum(1) + dx0
    dC0 = decay0[:, None, None] * dC1 + torch.einsum("btd,bte->bde", (e * s)[..., None] * q, dy)
    dn0 = decay0[:, None] * dn1 + torch.einsum("bt,btd->bd", e * dden_raw, q)
    return (dq, dk, dv, di, db), (dC0, dn0, dm0)


def mlstm_chunk_bwd_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        i_pre: torch.Tensor, f_pre: torch.Tensor,
                        state: Optional[Tuple[torch.Tensor, torch.Tensor, torch.Tensor]],
                        y: torch.Tensor, dy: Optional[torch.Tensor],
                        dC: Optional[torch.Tensor], dn: Optional[torch.Tensor],
                        dm: Optional[torch.Tensor], *, chunk: int = MLSTM_CHUNK):
    """Gradients of :func:`mlstm_chunk_ref` cut into ``chunk``-token chunks
    with a ragged last one (the CUDA kernel's chunks): the plain version of
    ``csrc/mlstm_chunk_bwd.cu``. Inputs as the forward's, plus its output
    ``y`` and the gradients of y and of the final (C, n, m), any of which
    may be None (zero). Returns (dq, dk, dv, di_pre, df_pre, dstate) with
    dstate (dC0, dn0, dm0) when a state was passed, else None.

    A forward sweep rebuilds every chunk's starting state; a reverse sweep
    carries the state's gradients (dC, dn and m's) from chunk to chunk.
    The gradient of the log-forget prefix sums is summed back in fp64, as
    the forward sums them, and passed through log sigmoid."""
    B, S, dh = q.shape
    st = state if state is not None else init_state(B, dh, device=q.device, dtype=q.dtype)
    logf = F.logsigmoid(f_pre)
    bounds = [(c0, min(c0 + chunk, S)) for c0 in range(0, S, chunk)]
    starts = []
    for c0, c1 in bounds:
        starts.append(st)
        st = _state_pass(k[:, c0:c1], v[:, c0:c1], i_pre[:, c0:c1], logf[:, c0:c1], *st)
    zero = torch.zeros_like
    dy = zero(y) if dy is None else dy
    dC = zero(st[0]) if dC is None else dC
    dn = zero(st[1]) if dn is None else dn
    dm = zero(st[2]) if dm is None else dm
    dq, dk, dv, di, db = (torch.empty_like(t) for t in (q, k, v, i_pre, f_pre))
    for (c0, c1), start in zip(reversed(bounds), reversed(starts)):
        sl = slice(c0, c1)
        grads, (dC, dn, dm) = _chunk_bwd(q[:, sl], k[:, sl], v[:, sl], i_pre[:, sl],
                                         logf[:, sl], *start, y[:, sl], dy[:, sl], dC, dn, dm)
        for out, g in zip((dq, dk, dv, di, db), grads):
            out[:, sl] = g
        dlogf = torch.flip(torch.cumsum(torch.flip(db[:, sl].double(), [1]), 1), [1]).to(db.dtype)
        db[:, sl] = dlogf * torch.sigmoid(-f_pre[:, sl])
    return dq, dk, dv, di, db, ((dC, dn, dm) if state is not None else None)
