"""Continuous-batching scheduler: a FIFO request queue (or the SLO-aware
:class:`SLOScheduler`'s fair-share order) feeding a fixed set of decode
slots, with refcounted page-pool accounting, an optional
shared-prefix index, chunked prefill, and cancellation/deadlines.

Policy (host-side, cheap — the device only ever sees static shapes):

  * **admission** — strictly FIFO: the head request is admitted when a
    slot is free, its worst-case page need fits the *unreserved* pool,
    and the per-step prefill token budget allows it. Later requests
    never jump the head (no starvation under a full queue).
  * **reservation** — pages for ``prompt + max_new_tokens`` are reserved
    at admission (in full, even when a prefix is shared — the
    conservative bound under which an admitted sequence can never hit
    pool OOM mid-flight) but allocated lazily as the sequence crosses
    page boundaries. Pages held only by the prefix index are evictable
    on demand, so reservations stay honourable with a warm cache.
  * **prefix sharing** — at admission the prompt's page-aligned chunks
    are looked up in the :class:`PrefixCache`; matched pages are mapped
    into the block table via ``PagePool.share`` and only the tail is
    prefilled. At least one tail token always remains (prefill must
    produce next-token logits). A completed prefill inserts its full
    prompt pages back into the index.
  * **chunked prefill** — a sequence is admitted in ``prefilling``
    status with ``prefill_pos`` tracking cached tokens; the engine
    advances it in budget-sized chunks interleaved with decode steps
    and calls :meth:`finish_prefill` when the prompt is fully cached.
    Prefilling slots are invisible to the decode step
    (:meth:`decode_view` nulls their block-table rows).
  * **copy-on-write** — :meth:`ensure_append_capacity` forks any page a
    decode append would write while its refcount is > 1 (fresh page +
    device copy, reported to the engine). Under the full-page-sharing
    policy appends never actually target shared pages — the fork path
    is the safety net that makes that a checked invariant rather than
    an assumption.
  * **eviction** — finished sequences (max_new reached, EOS, a
    ``cancel`` call, or a blown deadline) free their slot, release
    their pages, and land in the per-step drain list — the caller
    collects them via :meth:`drain_finished` every step, so nothing
    accumulates in the scheduler under continuous traffic.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Deque, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.serving.paged_cache import PagedCacheConfig, PagePool
from repro_torch.serving.streaming import (
    StreamingConfig,
    cold_page_indices,
    evictions_needed,
    resident_cap,
    validate_geometry,
    windowed_reservation,
)


@dataclasses.dataclass
class Request:
    """One serving request: ``prompt`` is a 1-D int32 token array of
    shape ``(prompt_len,)``; generation runs until ``max_new_tokens``
    (or ``eos_id``, when set). ``arrival`` is the engine step at which
    the request becomes visible to the scheduler — traces with
    staggered arrivals exercise mid-flight slot joins. ``deadline``
    (engine steps after arrival) bounds total service time: a request
    still unfinished when it expires is evicted with status
    ``"timeout"`` and whatever tokens it produced. ``rid`` keys the
    result dict ``ServingEngine.run`` returns.

    ``tenant`` and ``priority`` are scheduling metadata an SLO-aware
    scheduler consumes (per-tenant fair share; priority class 0 is the
    most urgent) — the FIFO scheduler carries them through untouched.

    ``submit_clock`` is stamped by the scheduler when the request is
    actually handed over (:meth:`ContinuousBatchingScheduler.submit`),
    and relative deadlines are measured from
    :attr:`deadline_anchor` = ``max(arrival, submit_clock)`` — on a
    reused engine whose step clock never reset, a fresh request with
    ``arrival=0`` must not inherit steps it was never alive for."""
    rid: int
    prompt: np.ndarray                 # (prompt_len,) int32 token ids
    max_new_tokens: int
    arrival: int = 0                   # engine step at which it enters the queue
    eos_id: Optional[int] = None
    deadline: Optional[int] = None     # max engine steps after deadline_anchor
    tenant: str = "default"
    priority: int = 0                  # 0 = most urgent class
    submit_clock: Optional[int] = None  # engine step of scheduler hand-over

    @property
    def deadline_anchor(self) -> int:
        """The step relative deadlines count from: submit time, never
        earlier than the declared arrival (a future-arrival request's
        deadline still starts at its arrival)."""
        if self.submit_clock is None:
            return self.arrival
        return max(self.arrival, self.submit_clock)

    @property
    def prompt_len(self) -> int:
        return int(self.prompt.shape[0])

    @property
    def max_total_len(self) -> int:
        return self.prompt_len + self.max_new_tokens


@dataclasses.dataclass
class SeqState:
    request: Request
    slot: int
    seq_len: int                       # tokens whose KV/state is cached
    pages: List[int]                   # mapped physical pages, logical order
    reserved_pages: int                # worst-case commitment at admission
    shared_len: int = 0                # prefix tokens mapped from the cache
    prefill_pos: int = 0               # prompt tokens cached so far
    status: str = "prefilling"         # prefilling|decoding|finished|cancelled|
                                       # timeout|shed
    generated: List[int] = dataclasses.field(default_factory=list)
    admit_clock: Optional[int] = None  # engine step of admission
    first_token_clock: Optional[int] = None  # engine step of the first token
    evicted_tokens: int = 0            # tokens dropped by streaming eviction
    pinned: List[int] = dataclasses.field(default_factory=list)  # sink pages

    @property
    def finished(self) -> bool:
        if len(self.generated) >= self.request.max_new_tokens:
            return True
        eos = self.request.eos_id
        return eos is not None and len(self.generated) > 0 and self.generated[-1] == eos


@dataclasses.dataclass
class _PrefixEntry:
    page: int
    key: int
    parent: Optional[int]              # parent chain key (None at the root)
    tick: int
    children: set = dataclasses.field(default_factory=set)


class PrefixCache:
    """Index of page-aligned prompt chunks -> physical pages.

    Keys are a running hash chain over page-sized token chunks, so a
    lookup walks the chain from the root and stops at the first miss —
    only a *prefix* of full pages is ever matched. Entries hold one
    pool reference each (the cache keeps hot prefixes alive after their
    sequences finish); :meth:`evict` drops LRU leaf entries whose page
    nobody else references, so eviction never orphans a reachable chain
    or steals a page out from under a live sequence."""

    def __init__(self, pool: PagePool, page_size: int):
        self.pool = pool
        self.page_size = page_size
        self._entries: Dict[int, _PrefixEntry] = {}
        self._tick = 0
        self.hit_pages = 0
        self.lookup_pages = 0
        self.inserted_pages = 0
        self.evicted_pages = 0

    def __len__(self) -> int:
        return len(self._entries)

    @property
    def pages(self) -> List[int]:
        return [e.page for e in self._entries.values()]

    def _chain_keys(self, prompt: np.ndarray, n_pages: int) -> List[int]:
        ps = self.page_size
        keys, h = [], 0
        chunks = np.asarray(prompt[: n_pages * ps], dtype=np.int32)
        for i in range(n_pages):
            h = hash((h, chunks[i * ps:(i + 1) * ps].tobytes()))
            keys.append(h)
        return keys

    def lookup(self, prompt: np.ndarray) -> List[int]:
        """Longest chain of cached pages covering a *proper* prefix of
        the prompt (at least one tail token is always left to prefill).
        Returns page ids in logical order; the caller maps them with
        ``pool.share``."""
        n = (len(prompt) - 1) // self.page_size
        self._tick += 1
        self.lookup_pages += n
        pages: List[int] = []
        for key in self._chain_keys(prompt, n):
            e = self._entries.get(key)
            if e is None:
                break
            e.tick = self._tick
            pages.append(e.page)
        self.hit_pages += len(pages)
        return pages

    def insert(self, prompt: np.ndarray, pages: Sequence[int]) -> None:
        """Register every *full* prompt page under its chain key. Pages
        already present (another sequence inserted the same chunk
        first) are skipped; new entries take a pool reference."""
        n = min(len(prompt) // self.page_size, len(pages))
        self._tick += 1
        parent: Optional[int] = None
        for i, key in enumerate(self._chain_keys(prompt, n)):
            e = self._entries.get(key)
            if e is None:
                self.pool.share([pages[i]])
                e = _PrefixEntry(page=int(pages[i]), key=key, parent=parent,
                                 tick=self._tick)
                self._entries[key] = e
                if parent is not None:
                    self._entries[parent].children.add(key)
                self.inserted_pages += 1
            else:
                e.tick = self._tick
            parent = key

    def evictable_count(self) -> int:
        """Pages :meth:`evict` can free: every entry whose page only the
        cache holds, leaf or not (an inner one goes with its subtree)."""
        return sum(1 for e in self._entries.values() if self.pool.refcount(e.page) == 1)

    def evict(self, n: int) -> int:
        """Free up to ``n`` pages that only the cache holds. LRU leaves go
        first (evicting one may expose its parent). When none is left, the
        LRU inner entry whose page only the cache holds goes with its
        subtree: a child can be held by a live sequence that does not hold
        the parent (``insert`` chains a sequence's own page under an entry
        another sequence inserted first), and the parent's page would
        otherwise stay allocated, covered by no reservation and by no
        eviction. Returns pages actually freed."""
        freed = 0
        while freed < n:
            only = [e for e in self._entries.values() if self.pool.refcount(e.page) == 1]
            if not only:
                break
            leaves = [e for e in only if not e.children]
            freed += self._drop(min(leaves or only, key=lambda e: e.tick))
        return freed

    def _drop(self, entry: _PrefixEntry) -> int:
        """Remove ``entry`` and its subtree from the index (a lookup stops
        at the first miss, so the subtree is unreachable without it),
        releasing the index's reference on each page. Returns pages freed."""
        if entry.parent is not None and entry.parent in self._entries:
            self._entries[entry.parent].children.discard(entry.key)
        freed = 0
        stack = [entry]
        while stack:
            e = stack.pop()
            del self._entries[e.key]
            stack.extend(self._entries[c] for c in e.children if c in self._entries)
            freed += self.pool.refcount(e.page) == 1
            self.pool.release([e.page])
            self.evicted_pages += 1
        return freed

    def stats(self) -> Dict[str, int]:
        return {
            "prefix_entries": len(self._entries),
            "prefix_lookup_pages": self.lookup_pages,
            "prefix_hit_pages": self.hit_pages,
            "prefix_inserted_pages": self.inserted_pages,
            "prefix_evicted_pages": self.evicted_pages,
        }


class ContinuousBatchingScheduler:
    """Owns slots, block tables, the page pool, and the prefix index.
    The engine calls, once per step: ``submit`` -> ``expire_deadlines``
    -> [``admit`` -> chunked prefill -> ``finish_prefill``]* ->
    ``ensure_append_capacity`` (returns COW forks) -> decode via
    ``decode_view`` -> ``on_token`` -> ``drain_finished``."""

    def __init__(self, pcfg: PagedCacheConfig,
                 prefill_token_budget: Optional[int] = None,
                 prefix_sharing: bool = False,
                 streaming: Optional[StreamingConfig] = None):
        self.pcfg = pcfg
        self.pool = PagePool(pcfg.num_pages)
        self.prefill_token_budget = prefill_token_budget
        self.streaming = streaming
        if streaming is not None:
            validate_geometry(streaming, pcfg)
        self.stream_evictions = 0      # pages evicted by the sliding window
        self.prefix_cache = (PrefixCache(self.pool, pcfg.page_size)
                             if prefix_sharing else None)
        self.waiting: Deque[Request] = deque()
        self.active: Dict[int, SeqState] = {}          # slot -> seq
        self._free_slots: List[int] = list(range(pcfg.max_slots - 1, -1, -1))
        self._reserved_total = 0
        self.block_table = np.full((pcfg.max_slots, pcfg.max_pages_per_seq),
                                   pcfg.null_page, dtype=np.int32)
        self.seq_lens = np.zeros((pcfg.max_slots,), dtype=np.int32)
        self._finished_step: List[SeqState] = []       # drained every step
        self.finished_count = 0
        self.cow_forks = 0
        self._now = 0                  # engine-step clock (expire_deadlines)

    # ------------------------------------------------------------- api --
    def submit(self, req: Request, now: Optional[int] = None) -> None:
        """Queue one request. ``now`` is the submitter's engine-step
        clock; it anchors the request's relative deadline (see
        :attr:`Request.deadline_anchor`). When omitted, the scheduler's
        own clock is used — an explicit ``submit_clock`` already on the
        request is respected either way."""
        if req.submit_clock is None:
            req.submit_clock = self._now if now is None else int(now)
        need = self._pages_needed(req.max_total_len)
        if need > self.pcfg.max_pages_per_seq:
            raise ValueError(
                f"request {req.rid}: {req.max_total_len} tokens exceed "
                f"max_pages_per_seq*page_size={self.pcfg.max_seq}")
        if need > self.pcfg.num_pages:
            raise ValueError(
                f"request {req.rid}: needs {need} pages, pool has {self.pcfg.num_pages}")
        self.waiting.append(req)

    def _pages_needed(self, max_total_len: int) -> int:
        """Worst-case page commitment for one request: the full
        ``prompt + max_new_tokens`` footprint, or — under streaming —
        the windowed resident cap, whichever is smaller. This is the
        whole admission story of the streaming subsystem: a 100k-token
        session reserves O(sink + window) pages."""
        if self.streaming is not None:
            return windowed_reservation(self.streaming, self.pcfg,
                                        max_total_len)
        return self.pcfg.pages_for(max_total_len)

    @property
    def has_work(self) -> bool:
        return bool(self.waiting or self.active)

    def _alloc(self, n: int) -> List[int]:
        """Pool alloc that reclaims prefix-cache-only pages on demand —
        reservations count cache-held pages as reclaimable."""
        short = n - self.pool.free_count
        if short > 0 and self.prefix_cache is not None:
            self.prefix_cache.evict(short)
        return self.pool.alloc(n)

    def _next_request(self) -> Optional[Request]:
        """The admission-policy hook: the next waiting request to try,
        or None to stop admitting this step. FIFO (this class) always
        answers the queue head — later requests never jump it. The
        :class:`SLOScheduler` overrides this with fair-share/priority/
        deadline selection (and sheds doomed requests as a side
        effect)."""
        return self.waiting[0] if self.waiting else None

    def _remove_waiting(self, req: Request) -> None:
        for i, r in enumerate(self.waiting):
            if r is req:
                del self.waiting[i]
                return
        raise AssertionError(f"request {req.rid} not in the waiting queue")

    def _on_admitted(self, seq: SeqState) -> None:
        """Post-admission hook (SLO fair-share accounting)."""

    def admit(self) -> List[SeqState]:
        """Admit from the queue while slot/pages/budget allow, in the
        order :meth:`_next_request` dictates (FIFO here). Returns newly
        admitted sequences in ``prefilling`` status, with any cached
        prefix already mapped (the engine prefills the tail from
        ``prefill_pos``). The selected request admits or blocks — when
        it doesn't fit, nothing behind it is admitted either, so big
        requests cannot be starved by small ones under any policy."""
        admitted: List[SeqState] = []
        budget = self.prefill_token_budget
        spent = 0
        while self.waiting and self._free_slots:
            req = self._next_request()
            if req is None:
                break
            need = self._pages_needed(req.max_total_len)
            if self._reserved_total + need > self.pcfg.num_pages:
                break                                   # selected waits; no queue-jumping
            shared = (self.prefix_cache.lookup(req.prompt)
                      if self.prefix_cache is not None else [])
            raw_hits = len(shared)
            if self.streaming is not None and len(shared) >= need:
                # a cached prefix longer than the resident cap cannot be
                # mapped (the block-table row is windowed); keep the
                # head — the part containing the pinned sinks
                shared = shared[:need - 1]
            shared_len = len(shared) * self.pcfg.page_size
            tail = req.prompt_len - shared_len
            if budget is not None and spent and spent + tail > budget:
                if self.prefix_cache is not None:
                    # the request wasn't admitted — it will be looked up
                    # again next step, so roll this probe back out of
                    # the hit-rate stats (the LRU touch is harmless)
                    n = (req.prompt_len - 1) // self.pcfg.page_size
                    self.prefix_cache.lookup_pages -= n
                    self.prefix_cache.hit_pages -= raw_hits
                break                                   # budget bounds each step, but
                                                        # never blocks the first admit
                                                        # (progress guarantee)
            self._remove_waiting(req)
            slot = self._free_slots.pop()
            self.pool.share(shared)
            init = min(self.pcfg.pages_for(req.prompt_len), need)
            fresh = self._alloc(init - len(shared))
            pages = list(shared) + fresh
            self._reserved_total += need
            seq = SeqState(request=req, slot=slot, seq_len=0,
                           pages=pages, reserved_pages=need,
                           shared_len=shared_len, prefill_pos=shared_len,
                           admit_clock=self._now)
            self.active[slot] = seq
            self.block_table[slot, :len(pages)] = pages
            self.seq_lens[slot] = 0                     # decode-invisible until
            spent += tail                               # finish_prefill
            self._pin_sinks(seq)
            admitted.append(seq)
            self._on_admitted(seq)
        return admitted

    def prefilling(self) -> List[SeqState]:
        """Active sequences with prompt tokens still to cache, in slot
        admission order (FIFO over the step)."""
        return [s for s in self.active.values() if s.status == "prefilling"]

    def finish_prefill(self, slot: int) -> None:
        """Prompt fully cached: the sequence joins the decode batch and
        its full prompt pages enter the prefix index. Under streaming
        only the *resident* tokens count toward ``seq_len`` (positions
        are cache-slot-relative), and after a mid-prefill eviction only
        the pinned sink prefix is inserted — the rest of the page list
        no longer corresponds to prompt positions."""
        seq = self.active[slot]
        assert seq.prefill_pos == seq.request.prompt_len
        seq.status = "decoding"
        seq.seq_len = seq.request.prompt_len - seq.evicted_tokens
        self.seq_lens[slot] = seq.seq_len
        if self.prefix_cache is not None:
            if seq.evicted_tokens:
                ps = self.pcfg.page_size
                n_sink = self.streaming.sink_pages
                self.prefix_cache.insert(seq.request.prompt[:n_sink * ps],
                                         seq.pages[:n_sink])
            else:
                self.prefix_cache.insert(seq.request.prompt, seq.pages)

    # ------------------------------------------------------ streaming --
    def _pin_sinks(self, seq: SeqState) -> None:
        """Pin any not-yet-pinned sink-region pages the sequence now
        holds (pages appear lazily, so pinning is incremental: at
        admission, after a prefill-chunk alloc, after a decode-boundary
        alloc). Pins are per-sequence and undone at eviction."""
        if self.streaming is None:
            return
        n = min(self.streaming.sink_pages, len(seq.pages))
        for p in seq.pages[len(seq.pinned):n]:
            self.pool.pin([p])
            seq.pinned.append(p)

    def stream_maintain(self, slot: int, extra_tokens: int) -> int:
        """Evict oldest non-sink pages until ``extra_tokens`` more can
        be appended within the resident cap: release each victim back
        to the pool, compact the block-table row left, and shrink the
        resident length by a page while ``evicted_tokens`` grows by the
        same amount. Returns pages evicted. The engine calls this
        before every decode append and between prefill chunks — the
        sliding-window half of the streaming policy."""
        if self.streaming is None:
            return 0
        seq = self.active[slot]
        resident = (seq.seq_len if seq.status == "decoding"
                    else seq.prefill_pos - seq.evicted_tokens)
        k = evictions_needed(self.streaming, self.pcfg, resident,
                             extra_tokens)
        for _ in range(k):
            self._stream_evict_one(seq)
        return k

    def _stream_evict_one(self, seq: SeqState) -> None:
        ps = self.pcfg.page_size
        n_sink = self.streaming.sink_pages
        assert len(seq.pages) > n_sink, (
            f"seq {seq.request.rid}: eviction would reach a sink page")
        victim = seq.pages.pop(n_sink)
        self.pool.release([victim])
        seq.evicted_tokens += ps
        if seq.status == "decoding":
            seq.seq_len -= ps
            self.seq_lens[seq.slot] = seq.seq_len
        self.block_table[seq.slot, :len(seq.pages)] = seq.pages
        self.block_table[seq.slot, len(seq.pages):] = self.pcfg.null_page
        self.stream_evictions += 1

    def stream_prepare_chunk(self, slot: int, chunk_tokens: int) -> None:
        """Prefill-side capacity: make room for (evicting as needed)
        and allocate every page the next ``chunk_tokens`` cache
        positions touch. The engine caps chunks at
        ``window_pages * page_size``, so eviction can always free
        enough room and each chunk makes at least a page of
        progress."""
        if self.streaming is None:
            return
        self.stream_maintain(slot, chunk_tokens)
        seq = self.active[slot]
        resident = seq.prefill_pos - seq.evicted_tokens
        last = (resident + chunk_tokens - 1) // self.pcfg.page_size
        while len(seq.pages) <= last:
            assert len(seq.pages) < seq.reserved_pages, (
                f"seq {seq.request.rid} outgrew its reservation")
            (page,) = self._alloc(1)
            seq.pages.append(page)
            self.block_table[slot, len(seq.pages) - 1] = page
        self._pin_sinks(seq)

    def stream_cold_pages(self, slot: int) -> List[int]:
        """Physical ids of this sequence's cold pages — resident, older
        than the window, full of written tokens, not shared (demoting a
        page another sequence or the prefix index also maps would
        corrupt *their* hot view). The engine demotes these to the int8
        shadow pool.

        "Full of written tokens" departs from the reference, whose copy
        demotes every page older than the window. Admission allocates a
        prompt's pages up to the resident cap before any is written, so
        before a long prompt's first chunk the reference demotes a page
        that holds stale contents; its flag then stays set while the
        chunk writes the page's hot rows, and attention reads the stale
        shadow until the page is freed."""
        if self.streaming is None:
            return []
        seq = self.active[slot]
        written = (seq.seq_len if seq.status == "decoding"
                   else seq.prefill_pos - seq.evicted_tokens)
        full = written // self.pcfg.page_size
        return [seq.pages[i]
                for i in cold_page_indices(self.streaming, len(seq.pages))
                if i < full and self.pool.refcount(seq.pages[i]) == 1]

    def decode_view(self) -> Tuple[np.ndarray, np.ndarray]:
        """(block_table, seq_lens) as the decode step may see them:
        slots still prefilling are nulled so the batched append can't
        write into their half-filled pages."""
        bt = self.block_table.copy()
        sl = self.seq_lens.copy()
        for seq in self.active.values():
            if seq.status != "decoding":
                bt[seq.slot, :] = self.pcfg.null_page
                sl[seq.slot] = 0
        return bt, sl

    def ensure_append_capacity(self) -> List[Tuple[int, int, int]]:
        """Before a decode step: every decoding slot must own — with
        refcount 1 — the page its next token lands in. Boundary pages
        are allocated from the reservation; a shared target page is
        forked copy-on-write. Returns ``(slot, src_page, dst_page)``
        forks for the engine to copy device-side (empty under the
        full-page sharing policy — see class docstring)."""
        return self.ensure_burst_capacity(
            {slot: 1 for slot, seq in self.active.items()
             if seq.status == "decoding"})

    def ensure_burst_capacity(self, burst: Dict[int, int]
                              ) -> List[Tuple[int, int, int]]:
        """Generalized :meth:`ensure_append_capacity` for multi-token
        draft/verify bursts: each decoding slot in ``burst`` must own —
        with refcount 1 — every page covering the ``burst[slot]`` token
        positions ``[seq_len, seq_len + n)`` the burst will write.
        Missing pages are allocated from the reservation (the caller
        caps ``n`` at the sequence's remaining token budget, so the
        reservation always covers the burst); a shared page in the
        write range forks copy-on-write. Returns ``(slot, src, dst)``
        forks for the engine to copy device-side — in every ladder
        level's pool, for a speculative engine."""
        forks: List[Tuple[int, int, int]] = []
        ps = self.pcfg.page_size
        for slot, n in burst.items():
            seq = self.active[slot]
            if seq.status != "decoding" or n < 1:
                continue
            first = seq.seq_len // ps
            last = (seq.seq_len + n - 1) // ps
            for page_idx in range(first, last + 1):
                if page_idx >= len(seq.pages):
                    assert len(seq.pages) < seq.reserved_pages, (
                        f"seq {seq.request.rid} outgrew its reservation")
                    (page,) = self._alloc(1)
                    seq.pages.append(page)
                    self.block_table[slot, page_idx] = page
                elif self.pool.is_shared(seq.pages[page_idx]):
                    src = seq.pages[page_idx]
                    (dst,) = self._alloc(1)
                    if src in seq.pinned:
                        # forking a pinned (shared sink) page: move our
                        # pin to the private copy before releasing the
                        # reference the pin was counted against
                        self.pool.unpin([src])
                        self.pool.pin([dst])
                        seq.pinned[seq.pinned.index(src)] = dst
                    self.pool.release([src])
                    seq.pages[page_idx] = dst
                    self.block_table[slot, page_idx] = dst
                    self.cow_forks += 1
                    forks.append((slot, src, dst))
            self._pin_sinks(seq)
        return forks

    def on_token(self, slot: int, token: int) -> Optional[SeqState]:
        """Record one generated token for a slot (its KV was appended by
        the decode step). Returns the SeqState if the sequence finished
        (already evicted), else None."""
        seq = self.active[slot]
        seq.generated.append(int(token))
        seq.seq_len += 1
        self.seq_lens[slot] = seq.seq_len
        if seq.finished:
            self._evict(seq, "finished")
            return seq
        return None

    def on_prefill_token(self, slot: int, token: int) -> Optional[SeqState]:
        """Record the token produced by prefill (not yet in the cache —
        the next decode step appends it)."""
        seq = self.active[slot]
        if seq.first_token_clock is None:
            seq.first_token_clock = self._now
        seq.generated.append(int(token))
        if seq.finished:                                 # max_new_tokens == 1
            self._evict(seq, "finished")
            return seq
        return None

    # -------------------------------------------- cancel / deadlines --
    def cancel(self, rid: int, status: str = "cancelled") -> bool:
        """Cancel a request wherever it is: drop it from the queue, or
        evict its sequence with partial results. The cancelled request
        still surfaces through :meth:`drain_finished` (with ``status``
        set) so callers see every submitted rid exactly once."""
        for req in self.waiting:
            if req.rid == rid:
                self.waiting.remove(req)
                seq = SeqState(request=req, slot=-1, seq_len=0, pages=[],
                               reserved_pages=0, status=status)
                self._finished_step.append(seq)
                self.finished_count += 1
                return True
        for seq in list(self.active.values()):
            if seq.request.rid == rid:
                self._evict(seq, status)
                return True
        return False

    def expire_deadlines(self, clock: int) -> int:
        """Evict every request whose deadline (engine steps since its
        :attr:`Request.deadline_anchor` — submit time, not raw arrival,
        so engine reuse cannot dilate a relative deadline) has passed —
        waiting or active. Called once per engine step with the current
        clock. Returns the number expired; the sequences themselves
        surface through :meth:`drain_finished` with status
        ``"timeout"``. Also advances the scheduler's notion of *now* —
        the clock admission policies (SLO shedding, ``admit_clock``)
        reason against."""
        self._now = clock
        expired = [r.rid for r in list(self.waiting)
                   if r.deadline is not None
                   and clock - r.deadline_anchor >= r.deadline]
        expired += [s.request.rid for s in list(self.active.values())
                    if s.request.deadline is not None
                    and clock - s.request.deadline_anchor >= s.request.deadline]
        for rid in expired:
            self.cancel(rid, status="timeout")
        return len(expired)

    def drain_finished(self) -> List[SeqState]:
        """Hand completed/cancelled sequences to the caller and forget
        them — the per-step drain that keeps scheduler memory bounded
        under continuous traffic."""
        out, self._finished_step = self._finished_step, []
        return out

    # -------------------------------------------------------- internal --
    def _evict(self, seq: SeqState, status: str) -> None:
        del self.active[seq.slot]
        if seq.pinned:
            self.pool.unpin(seq.pinned)
            seq.pinned = []
        self.pool.release(seq.pages)
        self._reserved_total -= seq.reserved_pages
        self.block_table[seq.slot, :] = self.pcfg.null_page
        self.seq_lens[seq.slot] = 0
        self._free_slots.append(seq.slot)
        seq.status = status
        self._finished_step.append(seq)
        self.finished_count += 1

    # ------------------------------------------------------ invariants --
    def check_invariants(self) -> None:
        """Cheap structural invariants, asserted by tests after every
        step: slots partition exactly, refcounts account for every
        holder, pages never leak, reservations stay honourable."""
        assert len(self.active) + len(self._free_slots) == self.pcfg.max_slots
        assert set(self.active) | set(self._free_slots) == set(range(self.pcfg.max_slots))
        holders: Dict[int, int] = {}
        for s in self.active.values():
            for p in s.pages:
                holders[p] = holders.get(p, 0) + 1
        cache_pages = set(self.prefix_cache.pages) if self.prefix_cache else set()
        for p in cache_pages:
            holders[p] = holders.get(p, 0) + 1
        # every reference accounted for: refcount == seq holders + index
        for p, n in holders.items():
            assert self.pool.refcount(p) == n, \
                f"page {p}: refcount {self.pool.refcount(p)} != holders {n}"
        assert len(holders) == self.pool.allocated_count, "page leak"
        assert self.pool.free_count + self.pool.allocated_count == self.pcfg.num_pages
        assert self._reserved_total <= self.pcfg.num_pages
        # reservations stay honourable: free + cache-evictable pages
        # cover every sequence's remaining worst-case growth
        remaining = sum(s.reserved_pages - len(s.pages) for s in self.active.values())
        evictable = (self.prefix_cache.evictable_count() if self.prefix_cache else 0)
        assert self.pool.free_count + evictable >= remaining, (
            f"reservation not honourable: free {self.pool.free_count} + "
            f"evictable {evictable} < remaining {remaining}")
        for seq in self.active.values():
            assert len(seq.pages) <= seq.reserved_pages
            assert seq.reserved_pages - len(seq.pages) >= 0
            used = self.block_table[seq.slot][self.block_table[seq.slot] != self.pcfg.null_page]
            assert list(used) == seq.pages
            if seq.status == "prefilling":
                assert seq.shared_len <= seq.prefill_pos <= seq.request.prompt_len
            if self.streaming is not None:
                # windowed residency: never more pages than the cap,
                # sinks pinned exactly (the pages that are pinned are
                # the head of the page list, each with a live pin)
                assert len(seq.pages) <= resident_cap(self.streaming)
                assert len(seq.pinned) <= self.streaming.sink_pages
                assert seq.pinned == seq.pages[:len(seq.pinned)]
                for p in seq.pinned:
                    assert self.pool.pin_count(p) >= 1
                assert seq.evicted_tokens % self.pcfg.page_size == 0


class SLOScheduler(ContinuousBatchingScheduler):
    """SLO-aware multi-tenant admission over the continuous-batching
    machinery (the reference's ``src/repro/serving/scheduler.py:715``).
    Page accounting, prefill chunking, copy-on-write, deadlines and
    eviction are inherited; only which waiting request admits next
    changes, plus deadline-aware shedding:

      * **per-tenant fair share** — every token served (the uncached
        prompt tail at admission, then each generated token) is charged
        to its request's tenant; admission picks from the tenant with the
        least service so far;
      * **priority classes** — within that tenant, lower
        ``Request.priority`` admits first (class 0 is the most urgent);
        priority ranks below fairness;
      * **earliest deadline first** among equal priorities, then queue
        order (ties break as in the reference: FIFO);
      * **shedding** — with ``shed=True`` a waiting request that cannot
        finish inside its deadline even if served from now on, one token
        a step, is refused with status ``"shed"`` (at selection and on
        every clock tick) and never holds a slot.

    With no request shed, admission order is the only difference from
    FIFO, and greedy decoding is per request: the tokens are the static
    path's."""

    def __init__(self, pcfg: PagedCacheConfig,
                 prefill_token_budget: Optional[int] = None,
                 prefix_sharing: bool = False,
                 streaming: Optional[StreamingConfig] = None, *,
                 shed: bool = True):
        super().__init__(pcfg, prefill_token_budget, prefix_sharing=prefix_sharing,
                         streaming=streaming)
        self.shed = shed
        self.served_tokens: Dict[str, int] = {}        # tenant -> tokens charged
        self.shed_count = 0

    # ---------------------------------------------------- accounting --
    def _charge(self, tenant: str, tokens: int) -> None:
        self.served_tokens[tenant] = self.served_tokens.get(tenant, 0) + tokens

    def _on_admitted(self, seq: SeqState) -> None:
        self._charge(seq.request.tenant, seq.request.prompt_len - seq.shared_len)

    def on_token(self, slot: int, token: int) -> Optional[SeqState]:
        self._charge(self.active[slot].request.tenant, 1)
        return super().on_token(slot, token)

    def on_prefill_token(self, slot: int, token: int) -> Optional[SeqState]:
        self._charge(self.active[slot].request.tenant, 1)
        return super().on_prefill_token(slot, token)

    # ----------------------------------------------------- admission --
    def _doomed(self, req: Request) -> bool:
        """Cannot meet its deadline: admitted now, its prefill done this
        step and one token a step after, the last token would still land
        at or past expiry (``clock - anchor >= deadline``)."""
        if req.deadline is None:
            return False
        remaining = req.deadline_anchor + req.deadline - self._now
        return remaining < req.max_new_tokens

    def _shed_doomed(self) -> None:
        if not self.shed:
            return
        for req in [r for r in self.waiting if self._doomed(r)]:
            self.cancel(req.rid, status="shed")
            self.shed_count += 1

    def expire_deadlines(self, clock: int) -> int:
        self._now = clock
        self._shed_doomed()
        return super().expire_deadlines(clock)

    def _next_request(self) -> Optional[Request]:
        self._shed_doomed()
        if not self.waiting:
            return None
        return min(
            enumerate(self.waiting),
            key=lambda iv: (self.served_tokens.get(iv[1].tenant, 0),
                            iv[1].priority,
                            (iv[1].deadline_anchor + iv[1].deadline
                             if iv[1].deadline is not None else float("inf")),
                            iv[0]),
        )[1]

    def stats(self) -> Dict[str, int]:
        """``shed`` and ``tenant_<name>_tokens`` (tokens charged to each
        tenant so far)."""
        out = {"shed": self.shed_count}
        for tenant, tokens in sorted(self.served_tokens.items()):
            out[f"tenant_{tenant}_tokens"] = tokens
        return out
