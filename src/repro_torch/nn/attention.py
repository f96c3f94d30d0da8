"""GQA and MLA attention with a training path, a prefill path (fills the
cache) and a single-token decode path, over a static cache or a paged
pool.

Cache layouts (per layer; the model stacks a leading L axis):
  GQA static: {"k": (b, S, kvh, hd), "v": (b, S, kvh, hd)}
  GQA paged:  {"k": (P+1, page, kvh, hd), "v": ...}  (serving/paged_cache.py)
  MLA static: {"ckv": (b, S, kv_lora), "krope": (b, S, qk_rope)}
  MLA paged:  {"ckv": (P+1, page, kv_lora), "krope": (P+1, page, qk_rope)}

Caches are updated in place (the reference returns new arrays); each
function still returns the cache so call sites read the same.

Unmasked self-attention longer than ``FLASH_THRESHOLD`` takes the
flash branch (``_flash``: the CUDA flash kernels on the card, their plain
version on the CPU) under the reference's exact condition; every other
call runs the direct softmax.

A paged cache may carry the streaming cold tier's int8 shadow leaves
(``k_q8``/``k_scale``/``v_q8``/``v_scale``); with ``cold_flags`` the
flagged pages read their dequantized shadow rows (``_gather_cold`` at
prefill, the cold decode kernel at decode); the MLA pools carry
``ckv_q8``/``ckv_scale``/``krope_q8``/``krope_scale`` the same way.

MLA (deepseek's Multi-head Latent Attention, the reference's
``src/repro/nn/attention.py:462-717``) caches the compressed latent
``ckv`` and one shared RoPE key ``krope`` per token. Its training and
static prefill form expands full K/V from the latent; its decode and
chunked-prefill forms absorb ``W_uk`` into the query and attend over the
latent rows directly (``_mla_absorbed_attend``); the paged decode runs
the absorbed-MLA kernels (``kernels/paged_decode.py``).

Not ported here: tensor parallelism.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels.flash_attention import flash_attention_bwd, flash_attention_fwd
from repro_torch.kernels.flash_ref import FLASH_KV_CHUNK, FLASH_Q_CHUNK
from repro_torch.kernels.paged_decode import (
    paged_gqa_decode,
    paged_gqa_decode_cold,
    paged_mla_decode,
    paged_mla_decode_cold,
)
from repro_torch.nn.linear import apply_linear, init_linear
from repro_torch.nn.norms import apply_rmsnorm, init_rmsnorm
from repro_torch.nn.rotary import apply_rope, mrope_tables, rope_tables
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
    backward runs the backward kernel (plain version on CPU tensors) and
    returns dq, dk and dv in q's, k's and v's shapes (MLA: v is narrower
    than q and k)."""

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
    """q (b, s, g, r, dk), k (b, s, g, dk), v (b, s, g, dv) -> (b, s, g, r, dv)."""
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
    without RoPE). MLA rotates only its ``qk_rope_dim`` channels (q_rope
    and the shared krope), so its tables are built at that width. Under
    ``rope="mrope"`` text-only positions (b, s) are broadcast to three
    equal streams (the reference's ``src/repro/nn/attention.py:271-274``);
    positions (3, b, s) are taken as given."""
    if cfg.rope == "rope":
        dim = cfg.qk_rope_dim if cfg.attention == "mla" else cfg.head_dim
        return rope_tables(positions, dim, cfg.rope_theta)
    if cfg.rope == "mrope":
        if positions.ndim == 2:
            positions = positions[None].expand(3, *positions.shape)
        return mrope_tables(positions, cfg.head_dim, cfg.mrope_sections, cfg.rope_theta)
    if cfg.rope != "none":
        raise ValueError(f"unknown rope {cfg.rope!r}; options rope, mrope, none")
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


# ---------------------------------------------------------------- MLA ----

def init_mla(cfg, *, generator, device, dtype=torch.float32):
    """DeepSeek Multi-head Latent Attention; every projection dense (the
    latent up-projections already are low-rank factors by design). cfg
    needs: d_model, n_heads, q_lora_rank (0 => one direct q projection),
    kv_lora_rank, qk_nope_dim, qk_rope_dim, v_head_dim."""
    d, h = cfg.d_model, cfg.n_heads
    nope, rope_d, vd = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    kw = dict(generator=generator, device=device, dtype=dtype)
    p = {}
    if cfg.q_lora_rank:
        p["wdq"] = init_linear(d, cfg.q_lora_rank, **kw)
        p["q_norm"] = init_rmsnorm(cfg.q_lora_rank, device=device, dtype=dtype)
        p["wuq"] = init_linear(cfg.q_lora_rank, h * (nope + rope_d), **kw)
    else:
        p["wq"] = init_linear(d, h * (nope + rope_d), **kw)
    p["wdkv"] = init_linear(d, cfg.kv_lora_rank + rope_d, **kw)
    p["kv_norm"] = init_rmsnorm(cfg.kv_lora_rank, device=device, dtype=dtype)
    p["wukv"] = init_linear(cfg.kv_lora_rank, h * (nope + vd), **kw)
    p["wo"] = init_linear(h * vd, d, **kw)
    return p


def _mla_q(p, x, cfg, rope):
    """(q_nope (b, s, h, nope), q_rope (b, s, h, rope_d) rotated)."""
    b, s, _ = x.shape
    nope, rope_d = cfg.qk_nope_dim, cfg.qk_rope_dim
    if cfg.q_lora_rank:
        q = apply_linear(p["wuq"], apply_rmsnorm(p["q_norm"], apply_linear(p["wdq"], x)))
    else:
        q = apply_linear(p["wq"], x)
    q_nope, q_rope = q.reshape(b, s, cfg.n_heads, nope + rope_d).split([nope, rope_d], -1)
    return q_nope, apply_rope(q_rope, None, tables=rope)


def _mla_ckv(p, x, cfg, rope):
    """The compressed latent ckv (b, s, kv_lora) and the shared rotated
    key krope (b, s, rope_d): exactly what the caches hold."""
    ckv, krope = apply_linear(p["wdkv"], x).split([cfg.kv_lora_rank, cfg.qk_rope_dim], -1)
    ckv = apply_rmsnorm(p["kv_norm"], ckv)
    krope = apply_rope(krope[:, :, None, :], None, tables=rope)[:, :, 0, :]
    return ckv, krope


def _mla_expanded(p, x, cfg, q_nope, q_rope, ckv, krope, causal):
    """Attention over full K/V expanded from the latent (the training and
    static-prefill form). q and k are nope + rope wide, v v_head_dim wide:
    past ``FLASH_THRESHOLD`` the flash kernels run at (192, 128) at full
    width (their wrappers copy v, a strided view of wukv's output,
    contiguous)."""
    b, s, _ = x.shape
    h, nope, rope_d, vd = cfg.n_heads, cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    k_nope, v = apply_linear(p["wukv"], ckv).reshape(b, s, h, nope + vd).split([nope, vd], -1)
    k = torch.cat([k_nope, krope[:, :, None, :].expand(b, s, h, rope_d)], dim=-1)
    o = _sdpa(torch.cat([q_nope, q_rope], dim=-1), k, v, causal=causal)
    return apply_linear(p["wo"], o.reshape(b, s, -1))


def _mla_rope(cfg, positions, rope):
    return rope if rope is not None else step_rope(cfg, positions)


def apply_mla(p, x, cfg, *, positions, causal=True, rope=None):
    """Training / no-cache forward: expand full K/V from the latent."""
    rope = _mla_rope(cfg, positions, rope)
    q_nope, q_rope = _mla_q(p, x, cfg, rope)
    ckv, krope = _mla_ckv(p, x, cfg, rope)
    return _mla_expanded(p, x, cfg, q_nope, q_rope, ckv, krope, causal)


def apply_mla_prefill(p, x, cfg, *, positions, cache, rope=None):
    """Fill cache[:, :s] (in place) with the latent and the rope key, and
    return the expanded form's outputs (causal)."""
    s = x.shape[1]
    rope = _mla_rope(cfg, positions, rope)
    q_nope, q_rope = _mla_q(p, x, cfg, rope)
    ckv, krope = _mla_ckv(p, x, cfg, rope)
    cache["ckv"][:, :s] = ckv.to(cache["ckv"].dtype)
    cache["krope"][:, :s] = krope.to(cache["krope"].dtype)
    return _mla_expanded(p, x, cfg, q_nope, q_rope, ckv, krope, True), cache


def _split_wukv(p, cfg):
    """W_uk (kv_lora, h, nope) and W_uv (kv_lora, h, vd): views of the
    dense (kv_lora, h (nope + vd)) up-projection, for the absorbed paths."""
    h, nope, vd = cfg.n_heads, cfg.qk_nope_dim, cfg.v_head_dim
    w = p["wukv"]["w"].reshape(cfg.kv_lora_rank, h, nope + vd)
    return w[:, :, :nope], w[:, :, nope:]


def _mla_absorbed_attend(p, x, cfg, q_nope, q_rope, cckv, ckr, valid, *, precise=False):
    """Absorbed attention straight against the latent view cckv (b, S,
    kv_lora) / ckr (b, S, rope_d) under ``valid``, (b, S) (one mask for
    every query: decode) or (b, s, S) (per query: chunked prefill); full
    K/V never exists. With ``precise`` every einsum runs in fp32 with one
    rounding to x.dtype before wo (the decode contract the paged kernel
    keeps); otherwise in x.dtype, as the reference's prefill does."""
    b, s, _ = x.shape
    h, vd = cfg.n_heads, cfg.v_head_dim
    wuk, wuv = _split_wukv(p, cfg)
    ct = torch.float32 if precise else x.dtype
    q_lat = torch.einsum("bshn,lhn->bshl", q_nope.to(ct), wuk.to(ct))
    scores = (torch.einsum("bshl,bSl->bhsS", q_lat, cckv.to(ct))
              + torch.einsum("bshr,bSr->bhsS", q_rope.to(ct), ckr.to(ct)))
    scores = scores.to(torch.float32) / math.sqrt(cfg.qk_nope_dim + cfg.qk_rope_dim)
    mask = valid[:, None, None, :] if valid.ndim == 2 else valid[:, None, :, :]
    probs = torch.softmax(scores.masked_fill(~mask, NEG_INF), dim=-1).to(ct)
    o_lat = torch.einsum("bhsS,bSl->bshl", probs, cckv.to(ct))
    o = torch.einsum("bshl,lhv->bshv", o_lat, wuv.to(ct))
    return apply_linear(p["wo"], o.to(x.dtype).reshape(b, s, h * vd))


def apply_mla_decode(p, x, cfg, *, cache, cache_len: int, rope=None):
    """Absorbed one-token step against the static latent cache (fp32
    attention, one rounding before wo)."""
    b, s, _ = x.shape
    rope = _mla_rope(cfg, _positions(cache_len, s, b, x.device), rope)
    q_nope, q_rope = _mla_q(p, x, cfg, rope)
    ckv, krope = _mla_ckv(p, x, cfg, rope)
    cache["ckv"][:, cache_len:cache_len + s] = ckv.to(cache["ckv"].dtype)
    cache["krope"][:, cache_len:cache_len + s] = krope.to(cache["krope"].dtype)
    S = cache["ckv"].shape[1]
    valid = (torch.arange(S, device=x.device) <= cache_len).expand(b, S)
    out = _mla_absorbed_attend(p, x, cfg, q_nope, q_rope, cache["ckv"], cache["krope"],
                               valid, precise=True)
    return out, cache


def apply_mla_prefill_paged(p, x, cfg, *, cache, block_table, start: int, rope=None,
                            cold_flags=None):
    """Chunked prefill from a logical offset against the paged latent
    pools (the MLA twin of :func:`apply_gqa_prefill_paged`): the chunk's
    latent and rope key are written into the sequence's pages, then the
    absorbed attend runs in x.dtype over the gathered view (cold pages
    dequantized, :func:`_gather_cold`) under a per-query causal mask at
    absolute positions."""
    b, c, _ = x.shape
    positions = _positions(start, c, b, x.device)
    rope = _mla_rope(cfg, positions, rope)
    q_nope, q_rope = _mla_q(p, x, cfg, rope)
    ckv, krope = _mla_ckv(p, x, cfg, rope)
    paged_write_slice(cache["ckv"], block_table[0], start, ckv[0])
    paged_write_slice(cache["krope"], block_table[0], start, krope[0])
    cckv = _gather_cold(cache, "ckv", block_table, cold_flags)
    ckr = _gather_cold(cache, "krope", block_table, cold_flags)
    S = cckv.shape[1]
    valid = torch.arange(S, device=x.device)[None, None, :] <= positions[:, :, None]
    out = _mla_absorbed_attend(p, x, cfg, q_nope, q_rope, cckv, ckr, valid)
    return out, cache


def apply_mla_decode_paged(p, x, cfg, *, cache, block_table, seq_lens, rope=None,
                           slots=None, cold_flags=None):
    """Absorbed one-token step against the paged latent pools through the
    absorbed-MLA decode kernel (its plain version on the CPU): q_nope is
    absorbed through W_uk in fp32, the kernel walks the block table over
    the latent pools with fp32 q_lat and q_rope and returns the fp32
    latent context o_lat, and W_uv applies in fp32 with one rounding
    before wo — the reference's ``src/repro/nn/attention.py:683-707``.
    With ``cold_flags`` and shadow leaves every step runs the cold kernel.
    ``rope`` / ``slots``: the step's RoPE tables and append targets."""
    b, s, _ = x.shape
    h, vd = cfg.n_heads, cfg.v_head_dim
    rope = _mla_rope(cfg, seq_lens[:, None].long(), rope)
    q_nope, q_rope = _mla_q(p, x, cfg, rope)
    ckv, krope = _mla_ckv(p, x, cfg, rope)
    if slots is None:
        slots = paged_slots(block_table, seq_lens, cache["ckv"].shape[1])
    paged_append(cache["ckv"], block_table, seq_lens, ckv[:, 0], slots=slots)
    paged_append(cache["krope"], block_table, seq_lens, krope[:, 0], slots=slots)
    wuk, wuv = _split_wukv(p, cfg)
    q_lat = torch.einsum("bhn,lhn->bhl", q_nope[:, 0].float(), wuk.float())
    q_r = q_rope[:, 0].float()
    scale = 1.0 / math.sqrt(cfg.qk_nope_dim + cfg.qk_rope_dim)
    if cold_flags is not None and "ckv_q8" in cache:
        o_lat = paged_mla_decode_cold(q_lat, q_r, cache["ckv"], cache["krope"],
                                      cache["ckv_q8"], cache["ckv_scale"], cache["krope_q8"],
                                      cache["krope_scale"], block_table, seq_lens, cold_flags,
                                      scale=scale)
    else:
        o_lat = paged_mla_decode(q_lat, q_r, cache["ckv"], cache["krope"], block_table,
                                 seq_lens, scale=scale)
    o = torch.einsum("bhl,lhv->bhv", o_lat, wuv.float())
    return apply_linear(p["wo"], o.to(x.dtype).reshape(b, s, h * vd)), cache
