"""Serving paths for the dense decoder: cache construction, prefill and
single-token decode, over a static ``(batch, max_seq)`` cache or paged
pools (serving/paged_cache.py).

Caches are stacked along a leading layer axis; the layer loop hands
each layer views of its slice, which the attention functions update in
place. KV pools stay bf16 whatever the compute dtype, as in the
reference's ``_attn_pool_spec``.
"""
from __future__ import annotations

from typing import Any, Callable, Dict

import torch

from repro_torch.config.model_config import ModelConfig
from repro_torch.core.tree import layer_slice
from repro_torch.device import compute_dtype
from repro_torch.models.lm import _norm_apply, require_dense
from repro_torch.nn import attention as attn
from repro_torch.nn.embedding import apply_embedding, apply_lm_head
from repro_torch.nn.mlp import apply_mlp
from repro_torch.serving.paged_cache import paged_slots

Params = Dict[str, Any]

# state-dict keys holding attention caches
ATTN_STATE_KEYS = ("cache",)

# families whose whole decode state is paged attention KV, so a prompt
# can prefill from an offset (shared prefixes, chunked prefill)
PREFIX_SHARING_FAMILIES = ("dense_lm", "moe_lm")

KV_DTYPE = torch.bfloat16


def supports_prefix_sharing(cfg: ModelConfig) -> bool:
    return cfg.family in PREFIX_SHARING_FAMILIES


# ======================================================================
# State init
# ======================================================================

def _kv_pair(shape, device):
    return {"k": torch.zeros(shape, dtype=KV_DTYPE, device=device),
            "v": torch.zeros(shape, dtype=KV_DTYPE, device=device)}


def lm_init_state(cfg: ModelConfig, batch: int, max_seq: int, *, device):
    """Zero static-cache decode state: {"cache": {"k"/"v": (L, batch,
    max_seq, kvh, hd) bf16}}."""
    require_dense(cfg)
    return {"cache": _kv_pair(
        (cfg.n_layers, batch, max_seq, cfg.n_kv_heads, cfg.head_dim), device)}


def lm_init_paged_state(cfg: ModelConfig, pcfg, *, device, cold_kv: str = "none"):
    """Zero paged decode state: {"cache": {"k"/"v": (L, num_pages + 1,
    page_size, kvh, hd) bf16}} — one shared pool per layer, the last
    page the null page. ``cold_kv="int8"`` adds the streaming cold
    tier's shadow leaves (the reference's ``_attn_pool_spec``,
    ``src/repro/models/decode.py:93-127``): ``k_q8``/``v_q8`` int8 of
    the pools' shape and ``k_scale``/``v_scale`` (L, num_pages + 1, kvh,
    hd) fp32, one scale per page and channel."""
    require_dense(cfg)
    if cold_kv not in ("none", "int8"):
        raise ValueError(f"cold_kv must be 'none' or 'int8', got {cold_kv!r}")
    L, P = cfg.n_layers, pcfg.num_pages + 1
    kvh, hd = cfg.n_kv_heads, cfg.head_dim
    cache = _kv_pair((L, P, pcfg.page_size, kvh, hd), device)
    if cold_kv == "int8":
        for name in ("k", "v"):
            cache[name + "_q8"] = torch.zeros((L, P, pcfg.page_size, kvh, hd),
                                              dtype=torch.int8, device=device)
            cache[name + "_scale"] = torch.zeros((L, P, kvh, hd), dtype=torch.float32,
                                                 device=device)
    return {"cache": cache}


# ======================================================================
# Prefill (static cache)
# ======================================================================

def prefill_lm(params: Params, tokens: torch.Tensor, cfg: ModelConfig, state):
    """Process the prompt, fill the static cache. Returns (last-token
    logits (b, 1, vocab), state)."""
    require_dense(cfg)
    b, s = tokens.shape
    x = apply_embedding(params["embed"], tokens, compute_dtype=compute_dtype(cfg))
    positions = torch.arange(s, device=x.device).expand(b, s)
    rope = attn.step_rope(cfg, positions)
    for i in range(cfg.n_layers):
        p = layer_slice(params["layers"], i)
        cache = layer_slice(state["cache"], i)
        h = _norm_apply(cfg, p["attn_norm"], x)
        h, _ = attn.apply_gqa_prefill(p["attn"], h, cfg, positions=positions, cache=cache,
                                      rope=rope)
        x = x + h
        h = _norm_apply(cfg, p["mlp_norm"], x)
        x = x + apply_mlp(p["mlp"], h, act=cfg.act)
    x = _norm_apply(cfg, params["final_norm"], x[:, -1:, :])
    return apply_lm_head(params["embed"], x), state


# ======================================================================
# Decode / chunk steps
# ======================================================================

def decode_step_lm(params: Params, tokens: torch.Tensor, state, cache_len: int,
                   cfg: ModelConfig):
    """tokens (b, 1) + static state -> (logits (b, 1, vocab), state);
    cache_len is the number of tokens already cached."""
    b, s = tokens.shape
    rope = attn.step_rope(cfg, torch.full((b, s), int(cache_len), dtype=torch.long,
                                          device=tokens.device))

    def attn_decode(p, h, cache):
        return attn.apply_gqa_decode(p, h, cfg, cache=cache, cache_len=int(cache_len),
                                     rope=rope)

    return _decode_step_body(params, tokens, state, cfg, attn_decode)


def decode_step_lm_paged(params: Params, tokens: torch.Tensor, state,
                         block_table: torch.Tensor, seq_lens: torch.Tensor,
                         cfg: ModelConfig, *, cold_flags=None):
    """One-token step for every slot against the paged pools, mixed fill
    levels in one step (the continuous-batching contract).
    block_table: (slots, n_pages) int32; seq_lens: (slots,) int32;
    ``cold_flags`` (num_pages + 1,) int32: the streaming cold tier's
    per-page flags, with the shadow leaves in the state (threaded as in
    ``src/repro/models/decode.py:379-432``)."""
    # every layer shares the step's RoPE tables and append targets
    rope = attn.step_rope(cfg, seq_lens[:, None].long())
    slots = paged_slots(block_table, seq_lens, state["cache"]["k"].shape[2])

    def attn_decode(p, h, cache):
        return attn.apply_gqa_decode_paged(p, h, cfg, cache=cache,
                                           block_table=block_table, seq_lens=seq_lens,
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

    def attn_chunk(p, h, cache):
        return attn.apply_gqa_prefill_paged(p, h, cfg, cache=cache,
                                            block_table=block_table, start=int(start),
                                            rope=rope, cold_flags=cold_flags)

    return _decode_step_body(params, tokens, state, cfg, attn_chunk)


def _decode_step_body(params: Params, tokens: torch.Tensor, state, cfg: ModelConfig,
                      attn_decode: Callable):
    """Layer loop shared by the static and paged steps;
    ``attn_decode(layer_params, h, cache) -> (out, cache)`` is the
    layout-specific part."""
    require_dense(cfg)
    x = apply_embedding(params["embed"], tokens, compute_dtype=compute_dtype(cfg))
    for i in range(cfg.n_layers):
        p = layer_slice(params["layers"], i)
        h = _norm_apply(cfg, p["attn_norm"], x)
        h, _ = attn_decode(p["attn"], h, layer_slice(state["cache"], i))
        x = x + h
        h = _norm_apply(cfg, p["mlp_norm"], x)
        x = x + apply_mlp(p["mlp"], h, act=cfg.act)
    x = _norm_apply(cfg, params["final_norm"], x)
    return apply_lm_head(params["embed"], x), state
