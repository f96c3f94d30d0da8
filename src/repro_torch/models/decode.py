"""Serving paths of the ported families: state construction, prefill
and single-token decode.

``dense_lm`` caches KV in a static ``(batch, max_seq)`` cache or in paged
pools (serving/paged_cache.py). Caches are stacked along a leading layer
axis; the layer loop hands each layer views of its slice, which the
attention functions update in place. KV pools stay bf16 whatever the
compute dtype, as in the reference's ``_attn_pool_spec``.

``moe_lm`` (deepseek) caches like ``dense_lm``, one stack per layer
stack: ``dense_cache`` for its ``first_dense_layers``, ``moe_cache`` for
its MoE layers (the reference's ``src/repro/models/decode.py:33``). Its
MLA layers cache the compressed latent ``ckv`` (…, kv_lora) and the
shared rope key ``krope`` (…, qk_rope) in place of K/V: static
``(L, batch, max_seq, ·)``, paged ``(L, num_pages + 1, page, ·)``, bf16;
with the cold tier ``ckv_q8``/``krope_q8`` int8 and per-page scales
``ckv_scale`` (L, num_pages + 1, kv_lora) / ``krope_scale`` fp32.

``ssm_lm`` (xlstm) carries fixed-size recurrent state per sequence,
indexed by slot in both layouts (the reference's
``src/repro/models/decode.py:138-181``): ``mlstm`` C (n_periods,
slstm_every - 1, batch, heads, dh, dh), n and m, fp32; ``slstm`` h, c,
n and m (n_periods, batch, heads, d // heads), fp32. Its prefill runs
the chunkwise forward from the empty state and writes each layer's final
state into the state it is given; its decode step updates the state in
place for every slot (an inactive slot evolves harmlessly on token 0
until a prefill overwrites it). It never prefills from an offset, so it
opts out of prefix sharing and chunked prefill.

``hybrid`` (jamba) carries both (the reference's ``src/repro/models/
decode.py:168-173``): ``attn_cache``, the attention layers' K/V stacked
over periods (static ``(n_periods, batch, max_seq, kvh, hd)`` or paged
pools ``(n_periods, num_pages + 1, page, kvh, hd)``), and ``mamba``, each
mamba layer's conv tail ``(n_periods, attn_every - 1, batch, d_conv - 1,
di)`` and SSM state ``(..., batch, di, d_state)``, bf16 whatever the
compute dtype (the reference's ``_mamba_state_spec``). Its prefill fills
the static cache and writes each mamba layer's final state (rounded to
bf16); its decode step appends to the pools through the paged kernel and
steps every slot's mamba state in place. Like xlstm it opts out of
offset prefill: the engine prefills a prompt whole into a batch-1 static
state, then writes its K/V into the sequence's pages and its mamba state
into its slot.
"""
from __future__ import annotations

from typing import Any, Callable, Dict

import torch

from repro_torch.config.model_config import ModelConfig
from repro_torch.core.tree import layer_slice
from repro_torch.device import compute_dtype
from repro_torch.models.lm import (
    _norm_apply,
    ff_apply,
    layer_stacks,
    n_periods,
    require_family,
)
from repro_torch.nn import attention as attn
from repro_torch.nn import mamba as mamba_mod
from repro_torch.nn import xlstm as xlstm_mod
from repro_torch.nn.embedding import apply_embedding, apply_lm_head
from repro_torch.serving.paged_cache import paged_slots

Params = Dict[str, Any]

# state-dict keys holding attention caches
ATTN_STATE_KEYS = ("cache", "dense_cache", "moe_cache", "attn_cache")

# the cache key of each homogeneous layer stack (models/lm.py:layer_stacks)
CACHE_KEYS = {"layers": "cache", "dense_layers": "dense_cache", "moe_layers": "moe_cache"}

# families whose whole decode state is paged attention KV, so a prompt
# can prefill from an offset (shared prefixes, chunked prefill)
PREFIX_SHARING_FAMILIES = ("dense_lm", "moe_lm")

KV_DTYPE = torch.bfloat16


def supports_prefix_sharing(cfg: ModelConfig) -> bool:
    return cfg.family in PREFIX_SHARING_FAMILIES


def recurrent_slot_axes(cfg: ModelConfig) -> Dict[str, int]:
    """State key -> the axis of the serving slot (batch) in its stacked
    leaves; the engine scatters a prefilled sequence's state there."""
    if cfg.family == "hybrid":
        return {"mamba": 2}         # (n_periods, n_mamba, batch, ...)
    if cfg.family == "ssm_lm":
        return {"mlstm": 2, "slstm": 1}
    return {}


# ======================================================================
# State init
# ======================================================================

def _ssm_state(cfg: ModelConfig, batch: int, device):
    """Zero recurrent state (m included, as the reference's zero-filled
    ``lm_init_state``: a prefill replaces it before it is read)."""
    _, h, dh = xlstm_mod.mlstm_dims(cfg)
    P, n_m = n_periods(cfg), cfg.slstm_every - 1
    ds = cfg.d_model // cfg.n_heads

    def zeros(*shape):
        return torch.zeros(shape, dtype=torch.float32, device=device)

    return {
        "mlstm": {"C": zeros(P, n_m, batch, h, dh, dh), "n": zeros(P, n_m, batch, h, dh),
                  "m": zeros(P, n_m, batch, h)},
        "slstm": {name: zeros(P, batch, cfg.n_heads, ds) for name in ("h", "c", "n", "m")},
    }


def _mamba_state(cfg: ModelConfig, batch: int, device):
    """Zero mamba state of every mamba layer: {"conv", "ssm"} stacked
    (n_periods, attn_every - 1, batch, ...), bf16."""
    P, n_m = n_periods(cfg), cfg.attn_every - 1
    st = mamba_mod.mamba_init_state(cfg, P * n_m * batch, device=device)
    return {name: t.view(P, n_m, batch, *t.shape[1:]) for name, t in st.items()}


def _attn_leaves(cfg: ModelConfig, lead, device, cold_kv: str = "none"):
    """One stack's attention cache: ``lead`` is (layers, batch, max_seq)
    static or (layers, num_pages + 1, page) paged. GQA: "k"/"v" (*lead,
    kvh, hd); MLA: "ckv" (*lead, kv_lora), "krope" (*lead, qk_rope); bf16.
    ``cold_kv="int8"`` (paged) adds every leaf's int8 shadow ``<name>_q8``
    and its fp32 per-page scales ``<name>_scale`` (layers, num_pages + 1,
    *feature), the token axis reduced."""
    if cfg.attention == "mla":
        feats = {"ckv": (cfg.kv_lora_rank,), "krope": (cfg.qk_rope_dim,)}
    else:
        feats = {"k": (cfg.n_kv_heads, cfg.head_dim), "v": (cfg.n_kv_heads, cfg.head_dim)}
    cache = {name: torch.zeros((*lead, *f), dtype=KV_DTYPE, device=device)
             for name, f in feats.items()}
    if cold_kv == "int8":
        for name, f in feats.items():
            cache[name + "_q8"] = torch.zeros((*lead, *f), dtype=torch.int8, device=device)
            cache[name + "_scale"] = torch.zeros((*lead[:2], *f), dtype=torch.float32,
                                                 device=device)
    return cache


def _attn_state(cfg: ModelConfig, lead, device, cold_kv: str = "none"):
    """The attention caches of every stack: {cache key: leaves}, ``lead``
    without the layer axis. hybrid: one attention layer a period."""
    if cfg.family == "hybrid":
        return {"attn_cache": _attn_leaves(cfg, (n_periods(cfg), *lead), device, cold_kv)}
    return {CACHE_KEYS[key]: _attn_leaves(cfg, (count, *lead), device, cold_kv)
            for key, _, count in layer_stacks(cfg)}


def lm_init_state(cfg: ModelConfig, batch: int, max_seq: int, *, device):
    """Zero static-cache decode state: {"cache": {"k"/"v": (L, batch,
    max_seq, kvh, hd) bf16}}; for moe_lm {"dense_cache", "moe_cache"} of
    MLA leaves (L, batch, max_seq, ·); for ssm_lm the recurrent state of
    ``batch`` sequences (``max_seq`` does not bound it); for hybrid
    {"attn_cache": (n_periods, batch, max_seq, kvh, hd) pairs, "mamba"}."""
    require_family(cfg, "serve")
    if cfg.family == "ssm_lm":
        return _ssm_state(cfg, batch, device)
    state = _attn_state(cfg, (batch, max_seq), device)
    if cfg.family == "hybrid":
        state["mamba"] = _mamba_state(cfg, batch, device)
    return state


def lm_init_paged_state(cfg: ModelConfig, pcfg, *, device, cold_kv: str = "none"):
    """Zero paged decode state: {"cache": {"k"/"v": (L, num_pages + 1,
    page_size, kvh, hd) bf16}} — one shared pool per layer, the last
    page the null page. ``cold_kv="int8"`` adds the streaming cold
    tier's shadow leaves (the reference's ``_attn_pool_spec``,
    ``src/repro/models/decode.py:93-127``): ``k_q8``/``v_q8`` int8 of
    the pools' shape and ``k_scale``/``v_scale`` (L, num_pages + 1, kvh,
    hd) fp32, one scale per page and channel. For moe_lm the MLA pools of
    each stack (``_attn_leaves``) under "dense_cache" and "moe_cache". For
    ssm_lm: the recurrent state of ``pcfg.max_slots`` slots (no pools);
    for hybrid the pools of its attention layers (one a period) under
    "attn_cache" and the mamba state of ``pcfg.max_slots`` slots."""
    require_family(cfg, "serve")
    if cold_kv not in ("none", "int8"):
        raise ValueError(f"cold_kv must be 'none' or 'int8', got {cold_kv!r}")
    if cfg.family == "ssm_lm":
        if cold_kv != "none":
            raise NotImplementedError("a cold KV tier needs paged attention pools; "
                                      f"family {cfg.family!r} has none")
        return _ssm_state(cfg, pcfg.max_slots, device)
    state = _attn_state(cfg, (pcfg.num_pages + 1, pcfg.page_size), device, cold_kv)
    if cfg.family == "hybrid":
        state["mamba"] = _mamba_state(cfg, pcfg.max_slots, device)
    return state


# ======================================================================
# Prefill (static cache)
# ======================================================================

def prefill_lm(params: Params, tokens: torch.Tensor, cfg: ModelConfig, state):
    """Process the prompt, fill the static cache. Returns (last-token
    logits (b, 1, vocab), state). For ssm_lm the prompt runs the
    chunkwise forward from the empty state and every layer's final state
    is written into ``state`` (b sequences); for hybrid the attention
    layers fill the static cache and every mamba layer's final state
    (conv tail, SSM state) is written, rounded to the state's bf16."""
    require_family(cfg, "serve")
    if cfg.family == "ssm_lm":
        return _ssm_prefill(params, tokens, cfg, state)
    b, s = tokens.shape
    x = apply_embedding(params["embed"], tokens, compute_dtype=compute_dtype(cfg))
    positions = torch.arange(s, device=x.device).expand(b, s)
    rope = attn.step_rope(cfg, positions)
    prefill = attn.apply_mla_prefill if cfg.attention == "mla" else attn.apply_gqa_prefill

    def attn_prefill(p, h, cache):
        return prefill(p, h, cfg, positions=positions, cache=cache, rope=rope)

    if cfg.family == "hybrid":
        x = _hybrid_stack(params, x, state, cfg, attn_prefill, _mamba_prefill)
    else:
        x = _layer_stacks(params, x, state, cfg, attn_prefill)
    x = _norm_apply(cfg, params["final_norm"], x[:, -1:, :])
    return apply_lm_head(params["embed"], x), state


# ======================================================================
# Decode / chunk steps
# ======================================================================

def decode_step_lm(params: Params, tokens: torch.Tensor, state, cache_len: int,
                   cfg: ModelConfig):
    """tokens (b, 1) + static state -> (logits (b, 1, vocab), state);
    cache_len is the number of tokens already cached (ssm_lm: unused)."""
    if cfg.family == "ssm_lm":
        return _ssm_decode(params, tokens, state, cfg)
    b, s = tokens.shape
    rope = attn.step_rope(cfg, torch.full((b, s), int(cache_len), dtype=torch.long,
                                          device=tokens.device))

    decode = attn.apply_mla_decode if cfg.attention == "mla" else attn.apply_gqa_decode

    def attn_decode(p, h, cache):
        return decode(p, h, cfg, cache=cache, cache_len=int(cache_len), rope=rope)

    return _decode_step_body(params, tokens, state, cfg, attn_decode)


def decode_step_lm_paged(params: Params, tokens: torch.Tensor, state,
                         block_table: torch.Tensor, seq_lens: torch.Tensor,
                         cfg: ModelConfig, *, cold_flags=None):
    """One-token step for every slot against the paged pools, mixed fill
    levels in one step (the continuous-batching contract).
    block_table: (slots, n_pages) int32; seq_lens: (slots,) int32;
    ``cold_flags`` (num_pages + 1,) int32: the streaming cold tier's
    per-page flags, with the shadow leaves in the state (threaded as in
    ``src/repro/models/decode.py:379-432``). For ssm_lm the block table
    and lengths are unused: every slot's recurrent state steps once."""
    if cfg.family == "ssm_lm":
        return _ssm_decode(params, tokens, state, cfg)
    # every layer shares the step's RoPE tables and append targets (every
    # stack's pools share one page geometry)
    rope = attn.step_rope(cfg, seq_lens[:, None].long())
    pool = next(iter(state[next(k for k in ATTN_STATE_KEYS if k in state)].values()))
    slots = paged_slots(block_table, seq_lens, pool.shape[2])
    decode = attn.apply_mla_decode_paged if cfg.attention == "mla" else attn.apply_gqa_decode_paged

    def attn_decode(p, h, cache):
        return decode(p, h, cfg, cache=cache, block_table=block_table, seq_lens=seq_lens,
                      rope=rope, slots=slots, cold_flags=cold_flags)

    return _decode_step_body(params, tokens, state, cfg, attn_decode)


def prefill_chunk_lm_paged(params: Params, tokens: torch.Tensor, state,
                           block_table: torch.Tensor, start: int, cfg: ModelConfig, *,
                           cold_flags=None):
    """Chunked/offset prefill of one sequence: tokens (1, c) at absolute
    positions [start, start+c), pages mapped in block_table (1, n_pages);
    ``cold_flags`` as in :func:`decode_step_lm_paged`. Returns (logits
    (1, c, vocab), state)."""
    if not supports_prefix_sharing(cfg):
        raise NotImplementedError(
            f"chunked/offset prefill needs pure paged-attention state; "
            f"family {cfg.family!r} opts out")

    c = tokens.shape[1]
    rope = attn.step_rope(cfg, (int(start) + torch.arange(c, device=tokens.device))[None])

    chunk = (attn.apply_mla_prefill_paged if cfg.attention == "mla"
             else attn.apply_gqa_prefill_paged)

    def attn_chunk(p, h, cache):
        return chunk(p, h, cfg, cache=cache, block_table=block_table, start=int(start),
                     rope=rope, cold_flags=cold_flags)

    return _decode_step_body(params, tokens, state, cfg, attn_chunk)


def _decode_step_body(params: Params, tokens: torch.Tensor, state, cfg: ModelConfig,
                      attn_decode: Callable):
    """Layer loop shared by the static and paged steps;
    ``attn_decode(layer_params, h, cache) -> (out, cache)`` is the
    layout-specific part."""
    require_family(cfg, "serve")
    x = apply_embedding(params["embed"], tokens, compute_dtype=compute_dtype(cfg))
    if cfg.family == "hybrid":
        x = _hybrid_stack(params, x, state, cfg, attn_decode, _mamba_decode)
    else:
        x = _layer_stacks(params, x, state, cfg, attn_decode)
    x = _norm_apply(cfg, params["final_norm"], x)
    return apply_lm_head(params["embed"], x), state


def _layer_stacks(params: Params, x: torch.Tensor, state, cfg: ModelConfig,
                  attn_fn: Callable) -> torch.Tensor:
    """Every layer of every homogeneous stack (dense_lm's ``layers``;
    moe_lm's ``dense_layers`` then ``moe_layers``) over ``x``:
    ``attn_fn(p, h, cache)`` runs the attention against the layer's view
    of its stack's cache (written in place), then the MLP or the MoE (its
    aux loss dropped, as in the reference's serving paths)."""
    for key, _, count in layer_stacks(cfg):
        caches = state[CACHE_KEYS[key]]
        for i in range(count):
            p = layer_slice(params[key], i)
            h, _ = attn_fn(p["attn"], _norm_apply(cfg, p["attn_norm"], x),
                           layer_slice(caches, i))
            x = x + h
            h, _ = ff_apply(cfg, p, _norm_apply(cfg, p["mlp_norm"], x))
            x = x + h
    return x


# ======================================================================
# hybrid (jamba): the period loop over attention and mamba layers
# ======================================================================

def _hybrid_stack(params: Params, x: torch.Tensor, state, cfg: ModelConfig,
                  attn_fn: Callable, mamba_fn: Callable) -> torch.Tensor:
    """Every period's layers over ``x``: ``attn_fn(p, h, cache)`` runs the
    attention layer against its period's cache, ``mamba_fn(p, h, cfg,
    st)`` a mamba layer against its state (views: written in place), and
    each layer's feed-forward follows (the MoE's aux loss is dropped, as
    in the reference's serving paths)."""
    for i in range(n_periods(cfg)):
        pp = layer_slice(params["periods"], i)
        cache = layer_slice(state["attn_cache"], i)
        mstate = layer_slice(state["mamba"], i)
        mi = 0
        for p in range(cfg.attn_every):
            lp = pp[f"p{p}"]
            h = _norm_apply(cfg, lp["pre_norm"], x)
            if "attn" in lp:
                h, _ = attn_fn(lp["attn"], h, cache)
            else:
                h = mamba_fn(lp["mamba"], h, cfg, layer_slice(mstate, mi))
                mi += 1
            x = x + h
            h, _ = ff_apply(cfg, lp, _norm_apply(cfg, lp["ff_norm"], x))
            x = x + h
    return x


def _mamba_prefill(p, h, cfg, st):
    """The prompt's forward, its final state written into ``st``."""
    out, new = mamba_mod.apply_mamba(p, h, cfg, return_state=True)
    for name, t in new.items():
        st[name].copy_(t)
    return out


def _mamba_decode(p, h, cfg, st):
    """One token for every row, the state stepped in place."""
    out, new = mamba_mod.apply_mamba_decode(p, h, cfg, state=st)
    for name, t in new.items():
        st[name].copy_(t)
    return out


# ======================================================================
# ssm_lm (xlstm): prefill and decode over the recurrent state
# ======================================================================

def _ssm_layers(cfg: ModelConfig):
    """(position in the period, index among the period's mLSTMs or None
    for the sLSTM)."""
    for p in range(cfg.slstm_every):
        if p == cfg.slstm_offset:
            yield p, None
        else:
            yield p, p if p < cfg.slstm_offset else p - 1


def _ssm_prefill(params: Params, tokens: torch.Tensor, cfg: ModelConfig, state):
    x = apply_embedding(params["embed"], tokens, compute_dtype=compute_dtype(cfg))
    for i in range(n_periods(cfg)):
        pp = layer_slice(params["periods"], i)
        for p, mi in _ssm_layers(cfg):
            lp = pp[f"p{p}"]
            h = _norm_apply(cfg, lp["pre_norm"], x)
            if mi is None:
                h, new = xlstm_mod.apply_slstm_with_state(lp["slstm"], h, cfg)
                dst = layer_slice(state["slstm"], i)
            else:
                h, new = xlstm_mod.apply_mlstm_with_state(lp["mlstm"], h, cfg)
                dst = layer_slice(layer_slice(state["mlstm"], i), mi)
            for name, t in new.items():
                dst[name].copy_(t)
            x = x + h
    x = _norm_apply(cfg, params["final_norm"], x[:, -1:, :])
    return apply_lm_head(params["embed"], x), state


def _ssm_decode(params: Params, tokens: torch.Tensor, state, cfg: ModelConfig):
    require_family(cfg, "serve")
    x = apply_embedding(params["embed"], tokens, compute_dtype=compute_dtype(cfg))
    for i in range(n_periods(cfg)):
        pp = layer_slice(params["periods"], i)
        for p, mi in _ssm_layers(cfg):
            lp = pp[f"p{p}"]
            h = _norm_apply(cfg, lp["pre_norm"], x)
            if mi is None:
                st = layer_slice(state["slstm"], i)
                h, new = xlstm_mod.apply_slstm_decode(lp["slstm"], h, cfg, state=st)
                for name, t in new.items():
                    st[name].copy_(t)
            else:
                st = layer_slice(layer_slice(state["mlstm"], i), mi)
                h, _ = xlstm_mod.apply_mlstm_decode(lp["mlstm"], h, cfg, state=st)
            x = x + h
    x = _norm_apply(cfg, params["final_norm"], x)
    return apply_lm_head(params["embed"], x), state
