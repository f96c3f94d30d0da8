"""Long-context streaming KV policy: attention sinks + sliding-window
page eviction + cold-page int8 demotion (StreamingLLM adapted to the
paged cache).

The insight from StreamingLLM (SNIPPETS.md Snippet 2) is that softmax
attention parks a large fraction of its mass on the first few tokens
regardless of content — evict those *attention sinks* and generation
collapses, keep them plus a sliding window of recent tokens and quality
degrades gracefully while memory stays O(sink + window). Mapped onto
this repo's page-granular cache:

  * the first ``sink_pages`` pages of every streaming sequence are
    **pinned** in the :class:`~repro_torch.serving.paged_cache.PagePool`
    (``pin``/``unpin``) — the evictor cannot reach them, by
    construction and by a loud runtime guard;
  * once a sequence's resident pages would exceed the cap
    ``sink_pages + window_pages + 1`` (sinks + window + the partially
    filled growth page), the **oldest non-sink page** is evicted:
    released back to the refcounted pool, the block-table row compacted
    left, and the sequence's *resident* length shrunk by ``page_size``
    while ``evicted_tokens`` grows by the same amount;
  * resident pages older than the window but not yet evicted are
    **cold**: with ``cold_kv="int8"`` the engine demotes them to a
    page-granular int8 shadow pool (``serving/quantize.py
    quantize_kv_pages``) and attention transparently dequantizes them
    on attend — in the jnp gather path and in the cold-aware Pallas
    paged-decode kernels.

Position contract (the StreamingLLM "positions within the cache" rule):
RoPE positions are **cache-slot-relative**. ``SeqState.seq_len`` counts
*resident* tokens only, so the existing position derivations —
``seq_lens[:, None]`` at decode, ``start + arange(chunk)`` at chunked
prefill with ``start = prefill_pos - evicted_tokens`` — yield cache
positions with no attention-side changes. Keys keep the rotation they
were written with; after an eviction the query-key distance to older
resident keys shrinks by ``page_size``, exactly the in-cache-distance
semantics StreamingLLM uses (and the reason streaming output is
token-identical to the full cache *until* the first eviction).

This module is the pure policy half: geometry, eviction arithmetic,
cold-set enumeration. The scheduler owns the host mutation (evict /
compact / pin), the engine owns the device mutation (demote / flag).
"""
from __future__ import annotations

import dataclasses

from repro_torch.serving.paged_cache import PagedCacheConfig

__all__ = [
    "StreamingConfig",
    "resident_cap",
    "windowed_reservation",
    "evictions_needed",
    "cold_page_indices",
    "identity_horizon",
    "validate_geometry",
]


@dataclasses.dataclass(frozen=True)
class StreamingConfig:
    """Streaming policy knobs.

    ``sink_pages`` — pages pinned forever at the head of every sequence
    (attention sinks; >= 1).
    ``window_pages`` — sliding window of recent pages kept resident
    (>= 1).
    ``cold_kv`` — codec for resident pages older than the window:
    ``"none"`` keeps them bf16, ``"int8"`` demotes them page-granularly
    with transparent dequant-on-attend.
    """
    sink_pages: int = 1
    window_pages: int = 4
    cold_kv: str = "none"

    def __post_init__(self) -> None:
        if self.sink_pages < 1:
            raise ValueError("streaming sink_pages must be >= 1")
        if self.window_pages < 1:
            raise ValueError("streaming window_pages must be >= 1")
        if self.cold_kv not in ("none", "int8"):
            raise ValueError(
                f"streaming cold_kv must be 'none' or 'int8', "
                f"got {self.cold_kv!r}")


def resident_cap(cfg: StreamingConfig) -> int:
    """Maximum pages a streaming sequence ever holds: sinks + window +
    one partially-filled growth page. The page after this cap is the
    eviction trigger."""
    return cfg.sink_pages + cfg.window_pages + 1


def windowed_reservation(cfg: StreamingConfig, pcfg: PagedCacheConfig,
                         max_total_len: int) -> int:
    """Admission reservation for a streaming sequence: the windowed cap
    unless the request is short enough to never hit it — O(sink +
    window) instead of O(prompt + max_new_tokens)."""
    return min(pcfg.pages_for(max_total_len), resident_cap(cfg))


def evictions_needed(cfg: StreamingConfig, pcfg: PagedCacheConfig,
                     resident_len: int, extra_tokens: int) -> int:
    """How many oldest-middle pages must be evicted before appending
    ``extra_tokens`` to a sequence currently holding ``resident_len``
    resident tokens. Each eviction frees exactly one page *and* shrinks
    the resident length by ``page_size``, so the count is simply the
    overshoot past the resident cap."""
    return max(0, pcfg.pages_for(resident_len + extra_tokens)
               - resident_cap(cfg))


def cold_page_indices(cfg: StreamingConfig, n_pages: int) -> range:
    """Logical page indices (into a sequence's page list) that are
    resident but older than the sliding window — the int8 demotion
    candidates. Always full pages: the window covers the trailing
    ``window_pages`` slots including the partial growth page."""
    return range(cfg.sink_pages, max(cfg.sink_pages,
                                     n_pages - cfg.window_pages))


def identity_horizon(cfg: StreamingConfig, pcfg: PagedCacheConfig) -> int:
    """Token count up to which streaming greedy output is guaranteed
    token-identical to the full-cache engine: while the total length
    stays within sinks + window, nothing has been evicted *or* demoted
    (the first demotion candidate appears when the growth page — page
    ``sink + window`` — is allocated)."""
    return (cfg.sink_pages + cfg.window_pages) * pcfg.page_size


def validate_geometry(cfg: StreamingConfig, pcfg: PagedCacheConfig) -> None:
    """The resident cap must fit both the block-table width and the
    pool, or streaming admission could never place a sequence."""
    cap = resident_cap(cfg)
    if cap > pcfg.max_pages_per_seq:
        raise ValueError(
            f"streaming resident cap {cap} (sink {cfg.sink_pages} + "
            f"window {cfg.window_pages} + 1) exceeds max_pages_per_seq "
            f"{pcfg.max_pages_per_seq}")
    if cap > pcfg.num_pages:
        raise ValueError(
            f"streaming resident cap {cap} exceeds the page pool "
            f"({pcfg.num_pages} pages)")
