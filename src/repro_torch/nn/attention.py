"""GQA attention with a training path, a prefill path (fills the cache)
and a single-token decode path, over a static cache or a paged pool.

Cache layouts (per layer; the model stacks a leading L axis):
  static: {"k": (b, S, kvh, hd), "v": (b, S, kvh, hd)}
  paged:  {"k": (P+1, page, kvh, hd), "v": ...}  (serving/paged_cache.py)

Caches are updated in place (the reference returns new arrays); each
function still returns the cache so call sites read the same.

Unmasked self-attention longer than ``FLASH_THRESHOLD`` takes the
flash branch (``_flash``: the CUDA flash kernels on the card, their plain
version on the CPU) under the reference's exact condition; every other
call runs the direct softmax.

A paged cache may carry the streaming cold tier's int8 shadow leaves
(``k_q8``/``k_scale``/``v_q8``/``v_scale``); with ``cold_flags`` the
flagged pages read their dequantized shadow rows (``_gather_cold`` at
prefill, the cold decode kernel at decode).

Not ported here: tensor parallelism, MLA.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels.flash_attention import flash_attention_bwd, flash_attention_fwd
from repro_torch.kernels.flash_ref import FLASH_KV_CHUNK, FLASH_Q_CHUNK
from repro_torch.kernels.paged_decode import paged_gqa_decode, paged_gqa_decode_cold
from repro_torch.nn.linear import apply_linear, init_linear
from repro_torch.nn.rotary import apply_rope, rope_tables
from repro_torch.serving.paged_cache import (
    paged_append,
    paged_gather,
    paged_slots,
    paged_write_slice,
)

NEG_INF = -1e30
FLASH_THRESHOLD = 2048  # direct softmax at or below this sequence length


def _sdpa_direct(q, k, v, *, causal: bool, q_offset=0, kv_len_mask=None):
    """O(s^2)-memory attention. q: (b, sq, g, r, d) grouped; k/v:
    (b, skv, g, d). Scores come out of the einsum in q.dtype and are
    softmaxed in fp32; probabilities are rounded to q.dtype — the
    reference's ``_sdpa_direct`` step for step."""
    b, sq, g, r, d = q.shape
    scores = torch.einsum("bqgrd,bkgd->bgrqk", q, k).to(torch.float32)
    scores = scores / math.sqrt(d)
    if causal:
        qpos = torch.arange(sq, device=q.device) + int(q_offset)
        kpos = torch.arange(k.shape[1], device=q.device)
        mask = qpos[:, None] >= kpos[None, :]
        scores = scores.masked_fill(~mask[None, None, None], NEG_INF)
    if kv_len_mask is not None:
        scores = scores.masked_fill(~kv_len_mask[:, None, None, None, :], NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.einsum("bgrqk,bkgd->bqgrd", probs, v)


class _Flash(torch.autograd.Function):
    """Flash attention with its recompute-p backward (the reference's
    ``_flash`` custom VJP): the forward saves (q, k, v, out, m, l), the
    backward runs the backward kernel (plain version on CPU tensors)."""

    @staticmethod
    def forward(ctx, q, k, v, causal):
        out, m, l = flash_attention_fwd(q, k, v, causal)
        ctx.save_for_backward(q, k, v, out, m, l)
        ctx.causal = causal
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, m, l = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, m, l, dout.contiguous(), ctx.causal)
        return dq, dk, dv, None


def _flash(q, k, v, causal: bool):
    """q (b, s, g, r, d), k/v (b, s, g, d) -> (b, s, g, r, d)."""
    return _Flash.apply(q, k, v, causal)


def _sdpa(q, k, v, *, causal: bool, q_offset=0, kv_len_mask=None):
    """q: (b, sq, h, d); k/v: (b, skv, kvh, d). GQA through grouped-head
    einsums — kv heads are never materialized repeated. The flash branch
    is taken under the reference's condition, so both packages pick the
    same branch at every shape."""
    b, sq, h, d = q.shape
    skv, kvh = k.shape[1], k.shape[2]
    qg = q.reshape(b, sq, kvh, h // kvh, d)
    use_flash = (
        kv_len_mask is None
        and sq == skv
        and sq > FLASH_THRESHOLD
        and sq % min(FLASH_Q_CHUNK, sq) == 0
        and skv % min(FLASH_KV_CHUNK, skv) == 0
        and isinstance(q_offset, int)
        and q_offset == 0
    )
    if use_flash:
        out = _flash(qg, k, v, causal)
    else:
        out = _sdpa_direct(qg, k, v, causal=causal, q_offset=q_offset,
                           kv_len_mask=kv_len_mask)
    return out.reshape(b, sq, h, v.shape[-1])


def init_gqa(cfg, *, generator, device, dtype=torch.float32):
    """cfg needs: d_model, n_heads, n_kv_heads, head_dim, qkv_bias,
    attn_rank (None => dense, the paper-faithful default)."""
    d, h, kvh, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    kw = dict(generator=generator, device=device, rank=cfg.attn_rank, dtype=dtype)
    return {
        "wq": init_linear(d, h * hd, bias=cfg.qkv_bias, **kw),
        "wk": init_linear(d, kvh * hd, bias=cfg.qkv_bias, **kw),
        "wv": init_linear(d, kvh * hd, bias=cfg.qkv_bias, **kw),
        "wo": init_linear(h * hd, d, bias=False, **kw),
    }


def step_rope(cfg, positions):
    """The (cos, sin) tables every layer of one step shares (None
    without RoPE)."""
    if cfg.rope == "rope":
        return rope_tables(positions, cfg.head_dim, cfg.rope_theta)
    if cfg.rope != "none":
        raise NotImplementedError(f"rope={cfg.rope!r} is not ported")
    return None


def _gqa_qkv(p, x, cfg, positions, rope=None):
    """Projections + RoPE. ``rope``: this step's tables (``step_rope``),
    computed here when the caller has none."""
    b, s, _ = x.shape
    h, kvh, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = apply_linear(p["wq"], x).reshape(b, s, h, hd)
    k = apply_linear(p["wk"], x).reshape(b, s, kvh, hd)
    v = apply_linear(p["wv"], x).reshape(b, s, kvh, hd)
    if rope is None:
        rope = step_rope(cfg, positions)
    if rope is not None:
        q = apply_rope(q, None, tables=rope)
        k = apply_rope(k, None, tables=rope)
    return q, k, v


def _positions(start, s: int, b: int, device) -> torch.Tensor:
    return (int(start) + torch.arange(s, device=device)).expand(b, s)


def apply_gqa(p, x, cfg, *, positions, causal=True, rope=None):
    """Training / no-cache forward."""
    b, s, _ = x.shape
    q, k, v = _gqa_qkv(p, x, cfg, positions, rope)
    o = _sdpa(q, k, v, causal=causal)
    return apply_linear(p["wo"], o.reshape(b, s, -1))


def apply_gqa_prefill(p, x, cfg, *, positions, cache, rope=None):
    """Fill cache[:, :s] (in place) and return outputs (causal)."""
    b, s, _ = x.shape
    q, k, v = _gqa_qkv(p, x, cfg, positions, rope)
    cache["k"][:, :s] = k.to(cache["k"].dtype)
    cache["v"][:, :s] = v.to(cache["v"].dtype)
    o = _sdpa(q, k, v, causal=True)
    return apply_linear(p["wo"], o.reshape(b, s, -1)), cache


def apply_gqa_decode(p, x, cfg, *, cache, cache_len: int, rope=None):
    """One-token step against the static cache. x: (b, 1, d); cache_len:
    tokens already cached. Attends over the whole cache with a validity
    mask. Decode attention runs in fp32 with one output rounding — the
    contract all decode paths share (static, paged gather, kernels), so
    bf16 greedy decode stays token-identical across them."""
    b, s, _ = x.shape
    positions = _positions(cache_len, s, b, x.device)
    q, k, v = _gqa_qkv(p, x, cfg, positions, rope)
    cache["k"][:, cache_len:cache_len + s] = k.to(cache["k"].dtype)
    cache["v"][:, cache_len:cache_len + s] = v.to(cache["v"].dtype)
    ck, cv = cache["k"], cache["v"]
    S = ck.shape[1]
    valid = (torch.arange(S, device=x.device) <= cache_len).expand(b, S)
    o = _sdpa(q.float(), ck.float(), cv.float(), causal=False,
              kv_len_mask=valid).to(q.dtype)
    return apply_linear(p["wo"], o.reshape(b, s, -1)), cache


def _gather_cold(cache, name, block_table, cold_flags):
    """Gather one paged pool leaf into the logical (b, S, *f) view with
    the pages flagged cold replaced by their dequantized int8 shadow rows
    (``q8 * scale`` in fp32), returned in fp32; without cold flags or
    shadow leaves this is ``paged_gather``. The reference's
    ``src/repro/nn/attention.py:330``."""
    pool = cache[name]
    g = paged_gather(pool, block_table)
    if cold_flags is None or name + "_q8" not in cache:
        return g
    b, n = block_table.shape
    page = pool.shape[1]
    q8 = paged_gather(cache[name + "_q8"], block_table)            # (b, S, *f)
    scale = cache[name + "_scale"][block_table.long()]             # (b, n, *f)
    deq = (q8.float().reshape(b, n, page, *pool.shape[2:])
           * scale[:, :, None].float()).reshape(g.shape)
    flag = cold_flags[block_table.long()] != 0                      # (b, n)
    flag = flag.repeat_interleave(page, dim=1)                      # (b, S)
    flag = flag.reshape(flag.shape + (1,) * (g.ndim - 2))
    return torch.where(flag, deq, g.float())


def apply_gqa_prefill_paged(p, x, cfg, *, cache, block_table, start: int, rope=None,
                            cold_flags=None):
    """Chunked prefill from a logical offset against a paged pool.

    x: (1, c, d) — one sequence's prompt tokens at absolute positions
    [start, start+c); block_table: (1, n_pages). The chunk's K/V is
    written into the sequence's pages, then attention runs over the
    gathered logical view: positions < start are the cached prefix,
    positions >= start+c stay behind the causal mask. With
    ``cold_flags`` the view is gathered in fp32 through
    :func:`_gather_cold` (no kernel, as in the reference,
    ``src/repro/nn/attention.py:388-389``)."""
    b, c, _ = x.shape
    positions = _positions(start, c, b, x.device)
    q, k, v = _gqa_qkv(p, x, cfg, positions, rope)
    paged_write_slice(cache["k"], block_table[0], start, k[0])
    paged_write_slice(cache["v"], block_table[0], start, v[0])
    ck = _gather_cold(cache, "k", block_table, cold_flags).to(q.dtype)
    cv = _gather_cold(cache, "v", block_table, cold_flags).to(q.dtype)
    o = _sdpa(q, ck, cv, causal=True, q_offset=start)
    return apply_linear(p["wo"], o.reshape(b, c, -1)), cache


def apply_gqa_decode_paged(p, x, cfg, *, cache, block_table, seq_lens, rope=None,
                           slots=None, cold_flags=None):
    """One-token step against a paged pool: block_table (b, n_pages)
    int32, seq_lens (b,) int32 per-slot fill levels. The new token is
    appended into each slot's current page, then attention runs through
    the paged decode kernel, which walks the block table itself
    (``kernels/paged_decode.py``; its plain version on the CPU). With
    ``cold_flags`` and shadow leaves in the cache every step runs the
    cold kernel, flagged pages or not (the reference's dispatch,
    ``src/repro/nn/attention.py:439-443``).
    ``rope`` / ``slots``: the step's RoPE tables and append targets
    (``paged_slots``), shared by every layer; computed here if absent."""
    b, s, _ = x.shape
    h, kvh, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    positions = seq_lens[:, None].long()
    q, k, v = _gqa_qkv(p, x, cfg, positions, rope)
    if slots is None:
        slots = paged_slots(block_table, seq_lens, cache["k"].shape[1])
    paged_append(cache["k"], block_table, seq_lens, k[:, 0], slots=slots)
    paged_append(cache["v"], block_table, seq_lens, v[:, 0], slots=slots)
    qg = q[:, 0].reshape(b, kvh, h // kvh, hd)
    if cold_flags is not None and "k_q8" in cache:
        og = paged_gqa_decode_cold(qg, cache["k"], cache["v"], cache["k_q8"],
                                   cache["k_scale"], cache["v_q8"], cache["v_scale"],
                                   block_table, seq_lens, cold_flags)
    else:
        og = paged_gqa_decode(qg, cache["k"], cache["v"], block_table, seq_lens)
    o = og.reshape(b, s, h * hd)
    return apply_linear(p["wo"], o), cache
