"""The port's continuous-batching scheduler under random schedules.

Random admit / chunk-prefill / append / finish / cancel schedules run
through ``repro_torch.serving.scheduler.ContinuousBatchingScheduler``,
with the invariants checked after every transition (the body of the JAX
package's ``tests/test_serving_fuzz.py::test_scheduler_random_schedule_invariants``,
here on the port). The first case is the one that failed before the
prefix index could free every page only it holds: seed 1, page size 3,
two slots, eight pages, prefix sharing.
"""
import random as pyrandom

import numpy as np
import pytest

from repro_torch.serving.paged_cache import PagedCacheConfig, PagePool
from repro_torch.serving.scheduler import ContinuousBatchingScheduler, PrefixCache, Request

EOS = 7


def _full_invariants(sched, pcfg):
    sched.check_invariants()
    for slot in sched._free_slots:
        assert (sched.block_table[slot] == pcfg.null_page).all()
        assert sched.seq_lens[slot] == 0
    if sched.prefix_cache is None:
        owner = {}
        for slot, seq in sched.active.items():
            for p in seq.pages:
                assert p != pcfg.null_page
                assert p not in owner, f"page {p} aliased by {owner[p]} and {slot}"
                owner[p] = slot


def _rand_requests(rng, pcfg, n_max=16, shared_pool=None):
    cap = pcfg.max_pages_per_seq * pcfg.page_size
    reqs = []
    for i in range(rng.randint(1, n_max)):
        max_new = rng.randint(1, cap - 1)
        plen = rng.randint(1, cap - max_new)
        if shared_pool is not None and rng.random() < 0.6:
            head = shared_pool[rng.randrange(len(shared_pool))][:plen]
            tail = rng.getrandbits(16)
            prompt = np.concatenate(
                [head, np.full((max(plen - len(head), 0),), tail % 97, np.int32)])[:plen]
        else:
            prompt = np.asarray([rng.randint(0, 96) for _ in range(plen)], np.int32)
        reqs.append(Request(
            rid=i, prompt=prompt.astype(np.int32), max_new_tokens=max_new,
            arrival=rng.randint(0, 8), eos_id=EOS if rng.random() < 0.5 else None,
            deadline=rng.randint(4, 40) if rng.random() < 0.25 else None))
    return [r for r in reqs if pcfg.pages_for(r.max_total_len) <= pcfg.num_pages]


# (seed, page_size, slots, pool_pages, prefix_sharing)
CASES = [(1, 3, 2, 8, True), (7, 2, 3, 12, True), (11, 4, 1, 9, True), (23, 5, 4, 20, True),
         (42, 8, 6, 40, True), (5, 3, 2, 8, False), (99, 2, 5, 16, False)]


@pytest.mark.parametrize("case", CASES, ids=lambda c: "-".join(map(str, c)))
def test_scheduler_random_schedule_invariants(case):
    seed, page_size, slots, pool_pages, prefix_sharing = case
    rng = pyrandom.Random(seed)
    mpps = max(2, min(8, pool_pages // 2))
    pcfg = PagedCacheConfig(page_size=page_size, num_pages=pool_pages, max_slots=slots,
                            max_pages_per_seq=mpps)
    budget = rng.choice([None, 2 * page_size, 6 * page_size])
    sched = ContinuousBatchingScheduler(pcfg, prefill_token_budget=budget,
                                        prefix_sharing=prefix_sharing)
    shared_pool = [np.asarray([rng.randint(0, 96) for _ in range(mpps * page_size)], np.int32)
                   for _ in range(2)] if prefix_sharing else None
    reqs = _rand_requests(rng, pcfg, shared_pool=shared_pool)
    pending = sorted(reqs, key=lambda r: r.arrival)
    drained, clock = [], 0
    while pending or sched.has_work:
        assert clock < 5000, "scheduler failed to drain"
        while pending and pending[0].arrival <= clock:
            sched.submit(pending.pop(0))
        sched.expire_deadlines(clock)
        _full_invariants(sched, pcfg)
        sched.admit()
        _full_invariants(sched, pcfg)
        for seq in sched.prefilling():
            plen = seq.request.prompt_len
            c = rng.randint(1, max(1, plen - seq.prefill_pos))
            seq.prefill_pos = min(plen, seq.prefill_pos + c)
            if seq.prefill_pos == plen:
                sched.finish_prefill(seq.slot)
                tok = EOS if (seq.request.eos_id and rng.random() < 0.15) else 1
                sched.on_prefill_token(seq.slot, tok)
            _full_invariants(sched, pcfg)
        if rng.random() < 0.1 and sched.active:
            sched.cancel(rng.choice([s.request.rid for s in sched.active.values()]))
            _full_invariants(sched, pcfg)
        decoding = [s for s in sched.active.values() if s.status == "decoding"]
        if decoding:
            sched.ensure_append_capacity()
            _full_invariants(sched, pcfg)
            for seq in decoding:
                if seq.slot not in sched.active:
                    continue
                tgt = seq.pages[seq.seq_len // pcfg.page_size]
                assert not sched.pool.is_shared(tgt)
            for seq in list(decoding):
                if seq.slot not in sched.active:
                    continue
                tok = EOS if (seq.request.eos_id and rng.random() < 0.2) else 1
                sched.on_token(seq.slot, tok)
                _full_invariants(sched, pcfg)
        drained += sched.drain_finished()
        clock += 1
    cache_pages = len(sched.prefix_cache.pages) if sched.prefix_cache else 0
    assert sched.pool.allocated_count == cache_pages
    assert sorted(s.request.rid for s in drained) == sorted(r.rid for r in reqs)
    if sched.prefix_cache is not None:
        sched.prefix_cache.evict(pcfg.num_pages)
        assert sched.pool.allocated_count == 0


def test_prefix_cache_frees_an_inner_page_only_it_holds():
    """A chain whose inner page only the index holds while a live
    sequence holds its child (``insert`` chained the sequence's own page
    under an entry another sequence inserted first): the inner page
    counts as evictable and ``evict`` frees it, dropping its subtree
    from the index and leaving the child to the sequence."""
    pool = PagePool(8)
    cache = PrefixCache(pool, page_size=2)
    a = np.asarray([1, 2, 3, 4], np.int32)
    b = np.asarray([1, 2, 5, 6], np.int32)
    pa, pb = pool.alloc(2), pool.alloc(2)
    cache.insert(a, pa)                      # root page pa[0], child pa[1]
    cache.insert(b, pb)                      # b's second page under pa[0]
    pool.release(pa)                         # sequence a done: pa cache-only
    pool.release(pb[:1])                     # b keeps only its second page
    assert pool.refcount(pa[0]) == 1 and pool.refcount(pb[1]) == 2
    before = pool.free_count
    assert cache.evictable_count() == 2      # pa[1] (a leaf) and pa[0] (inner)
    assert cache.evict(8) == 2
    assert pool.free_count == before + 2
    assert pool.refcount(pb[1]) == 1         # the sequence still holds it
    assert len(cache) == 0
