"""Paged KV cache: fixed-size pages allocated from a shared pool, with a
per-sequence block table mapping logical token positions to physical
pages (the vLLM/SHARK-Engine design).

A sequence only holds the pages its tokens occupy, so a mixed stream of
request lengths shares one small pool.

Device side (leaves are per-layer pools):
  * pool layout    — ``(num_pages + 1, page_size, *feature)``; the last
    page is the *null page*: inactive decode slots point at it, so the
    batched one-token append always has a harmless write target.
  * ``paged_gather``      — block table -> contiguous ``(slots, S, ...)``
    view for attention (masked positions may hold stale page data; the
    attention mask makes them unreachable).
  * ``paged_append``      — write one new token per slot at its fill
    position.
  * ``paged_write_slice`` — write a prompt chunk at a logical offset.
  * ``paged_write_pages`` — scatter a whole prompt's cache into its pages.
  * ``copy_page``         — the device half of a copy-on-write fork.

Unlike the reference's functional updates, the writers update the pool
in place (no second pool-sized buffer per step) and return it, so call
sites read the same as the reference's.

Host side: ``PagePool`` is the refcounted free-list allocator the
continuous-batching scheduler draws from (a copy of the reference's).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence

import torch


@dataclasses.dataclass(frozen=True)
class PagedCacheConfig:
    """Geometry of the shared pool.

    ``num_pages`` is the allocatable pool size (pool arrays carry one
    extra null page). ``max_pages_per_seq`` bounds the block-table width;
    the contiguous attention view is ``page_size * max_pages_per_seq``
    tokens wide.
    """
    page_size: int = 16
    num_pages: int = 64
    max_slots: int = 4
    max_pages_per_seq: int = 8

    @property
    def max_seq(self) -> int:
        return self.page_size * self.max_pages_per_seq

    @property
    def null_page(self) -> int:
        return self.num_pages

    def pages_for(self, n_tokens: int) -> int:
        return -(-n_tokens // self.page_size)


# ======================================================================
# Device-side ops (single pool leaf; models stack a leading layer axis)
# ======================================================================

def paged_gather(pool: torch.Tensor, block_table: torch.Tensor) -> torch.Tensor:
    """pool (P, page, *f) + block_table (b, n) -> (b, n*page, *f).

    Pages land in logical order, so the result is positionally identical
    to a static ``(b, S)`` cache for the first ``seq_len`` tokens of each
    row; positions past ``seq_len`` may hold stale or null-page data and
    must stay behind the attention validity mask.
    """
    b, n = block_table.shape
    g = pool[block_table.long()]                       # (b, n, page, *f)
    return g.reshape(b, n * pool.shape[1], *pool.shape[2:])


def paged_slots(block_table: torch.Tensor, seq_lens: torch.Tensor, page: int):
    """(physical page, offset) of position ``seq_lens[i]`` of every slot —
    where this step's token lands. Shared by every layer's append."""
    lens = seq_lens.long()
    page_idx = torch.clamp(lens // page, max=block_table.shape[1] - 1)
    phys = torch.gather(block_table.long(), 1, page_idx[:, None])[:, 0]
    return phys, lens % page


def paged_append(pool: torch.Tensor, block_table: torch.Tensor,
                 seq_lens: torch.Tensor, vals: torch.Tensor, *, slots=None) -> torch.Tensor:
    """Write one token per slot, in place: pool[bt[i, len_i // page],
    len_i % page] = vals[i]. vals: (b, *f). Inactive slots (len 0, block
    table on the null page) write harmlessly into the null page.
    ``slots`` is :func:`paged_slots`'s result, when the caller has it."""
    phys, off = slots if slots is not None else paged_slots(block_table, seq_lens,
                                                            pool.shape[1])
    pool[phys, off] = vals.to(pool.dtype)
    return pool


def paged_write_slice(pool: torch.Tensor, block_table: torch.Tensor, start: int,
                      vals: torch.Tensor) -> torch.Tensor:
    """Write a contiguous chunk of tokens at a logical offset, in place.

    pool (P, page, *f); block_table (n,) — one sequence's page ids;
    start — logical position of ``vals[0]``; vals (c, *f). Token i lands
    at pool[bt[(start+i) // page], (start+i) % page] — the chunked-prefill
    write path.
    """
    page = pool.shape[1]
    pos = int(start) + torch.arange(vals.shape[0], device=pool.device)
    phys = block_table.long()[pos // page]
    pool[phys, pos % page] = vals.to(pool.dtype)
    return pool


def paged_write_pages(pool: torch.Tensor, page_ids: torch.Tensor, vals: torch.Tensor,
                      *, n_stack: int = 0) -> torch.Tensor:
    """Scatter a contiguous per-sequence cache into its pages, in place.

    pool (*stack, P, page, *f) with ``n_stack`` leading stacked axes (the
    block table is shared by every layer, so one call writes every
    layer's pool); page_ids (n,); vals (*stack, s, *f) with s <= n*page.
    The tail of the last page is written as zeros, as the reference's
    ``paged_write_pages`` pads it (masked until an append overwrites it).
    """
    page = pool.shape[n_stack + 1]
    n = page_ids.shape[0]
    s = vals.shape[n_stack]
    pad = list(vals.shape)
    pad[n_stack] = n * page - s
    vals = torch.cat([vals.to(pool.dtype), vals.new_zeros(pad, dtype=pool.dtype)],
                     dim=n_stack)
    vals = vals.reshape(vals.shape[:n_stack] + (n, page) + vals.shape[n_stack + 1:])
    pool[(slice(None),) * n_stack + (page_ids.long(),)] = vals
    return pool


def copy_page(pool: torch.Tensor, src: int, dst: int) -> torch.Tensor:
    """pool[dst] = pool[src], in place — the device half of a
    copy-on-write fork."""
    pool[dst] = pool[src]
    return pool


# ------------------------------------------------- recurrent slot state --

def slot_write(state_tree: Dict, axis: int, slot: int, values: Dict) -> Dict:
    """Scatter one sequence's recurrent state (batch-1 leaves) into the
    slot axis ``axis`` of the stacked serving state, in place, for every
    leaf of the tree (the reference's functional ``slot_write``)."""
    for name, leaf in state_tree.items():
        if isinstance(leaf, dict):
            slot_write(leaf, axis, slot, values[name])
        else:
            leaf.select(axis, slot).copy_(values[name].squeeze(axis))
    return state_tree


def slot_read(state_tree: Dict, axis: int, slot: int) -> Dict:
    """One sequence's recurrent state as views, keeping a batch-1 axis so
    it round-trips with :func:`slot_write`."""
    return {name: slot_read(leaf, axis, slot) if isinstance(leaf, dict)
            else leaf.narrow(axis, slot, 1) for name, leaf in state_tree.items()}


# ======================================================================
# Host-side allocator
# ======================================================================

class PagePool:
    """Refcounted free-list page allocator. Pages are plain ints in
    [0, num_pages); the null page is never handed out.

    ``alloc`` hands out pages at refcount 1; ``share`` maps an
    already-allocated page into another holder (refcount + 1);
    ``release``/``free`` drop one reference and return the page to the
    free list only when the last holder lets go. A holder about to
    *write* a shared page must fork it first (allocate a fresh page,
    ``copy_page`` on device, release the shared one) — the scheduler's
    copy-on-write step."""

    def __init__(self, num_pages: int):
        self.num_pages = num_pages
        self._free: List[int] = list(range(num_pages - 1, -1, -1))
        self._refs: Dict[int, int] = {}
        # counted pins: a pinned page may gain/lose *extra* references
        # (prefix sharing), but its refcount may never fall below its pin
        # count — releasing into a pin is an eviction-policy bug and
        # raises instead of silently recycling a live attention sink
        self._pins: Dict[int, int] = {}
        # optional hook fired with the list of pages that just hit
        # refcount zero (after they return to the free list) — the
        # engine uses it to clear cold-KV flags on every release path
        # (streaming eviction, sequence finish, cancel, prefix-cache
        # eviction) without chasing each call site
        self.on_free = None
        # high-water mark of concurrently allocated pages, maintained at
        # the allocation site itself — callers that sample residency at
        # one point in their loop (the engine's per-step stat) would miss
        # pages allocated and released between samples (COW forks,
        # decode-time boundary appends on a finishing sequence)
        self.peak_allocated = 0

    @property
    def free_count(self) -> int:
        return len(self._free)

    @property
    def allocated_count(self) -> int:
        return len(self._refs)

    def refcount(self, page: int) -> int:
        return self._refs.get(page, 0)

    def is_shared(self, page: int) -> bool:
        return self._refs.get(page, 0) > 1

    def alloc(self, n: int) -> List[int]:
        if n > len(self._free):
            raise RuntimeError(f"page pool exhausted: want {n}, have {len(self._free)}")
        out = [self._free.pop() for _ in range(n)]
        for p in out:
            self._refs[p] = 1
        self.peak_allocated = max(self.peak_allocated, len(self._refs))
        return out

    def share(self, page_ids: Sequence[int]) -> None:
        """Add one reference to each (already-allocated) page."""
        for p in page_ids:
            if p not in self._refs:
                raise RuntimeError(f"share of unallocated page {p}")
        for p in page_ids:
            self._refs[p] += 1

    def pin(self, page_ids: Sequence[int]) -> None:
        """Pin allocated pages (counted): each pin consumes one of the
        page's references, so ``release`` below that floor raises. The
        attention-sink guard — a sliding-window evictor that reaches a
        sink fails loudly instead of corrupting a shared prefix."""
        for p in page_ids:
            if p not in self._refs:
                raise RuntimeError(f"pin of unallocated page {p}")
            if self._pins.get(p, 0) >= self._refs[p]:
                raise RuntimeError(f"pin of page {p} exceeds refcount")
        for p in page_ids:
            self._pins[p] = self._pins.get(p, 0) + 1

    def unpin(self, page_ids: Sequence[int]) -> None:
        """Drop one pin per page (must currently be pinned)."""
        for p in page_ids:
            if self._pins.get(p, 0) <= 0:
                raise RuntimeError(f"unpin of unpinned page {p}")
        for p in page_ids:
            self._pins[p] -= 1
            if self._pins[p] == 0:
                del self._pins[p]

    def pin_count(self, page: int) -> int:
        return self._pins.get(page, 0)

    def release(self, page_ids: Sequence[int]) -> None:
        """Drop one reference per page; free at refcount zero. Releasing
        a page nobody holds raises (the double-free guard), as does a
        release that would take a page's refcount below its pin count
        (the pinned-sink guard)."""
        # validate cumulatively: a batch may release the same page more
        # than once (one list entry per reference), so the guard must
        # check the total drop, not each entry against the pre-state
        drops: Dict[int, int] = {}
        for p in page_ids:
            drops[p] = drops.get(p, 0) + 1
        for p, k in drops.items():
            if self._refs.get(p, 0) < k:
                raise RuntimeError(f"double free of page {p}")
            if self._refs[p] - k < self._pins.get(p, 0):
                raise RuntimeError(f"release of pinned page {p}")
        freed: List[int] = []
        for p in page_ids:
            self._refs[p] -= 1
            if self._refs[p] == 0:
                del self._refs[p]
                self._free.append(p)
                freed.append(p)
        if freed and self.on_free is not None:
            self.on_free(freed)

    # pre-refcount name, kept for callers that never share
    free = release
