"""Port vs reference: the SLO scheduler (``serving/scheduler.py:SLOScheduler``).

The reference's contract cases (``tests/test_slo_scheduler.py``: fair
share across tenants, a priority flood that cannot starve another
tenant, priority above deadline within a tenant, earliest deadline first
within a class, the FIFO deadline tiebreak, shedding of doomed requests,
the served-token ledger) run on both packages' schedulers, through the
same host-side driver (no model: instant prefill, one token a step).
Seeded random schedules (tenants, priorities, deadlines, cancellations,
ragged prefill) drive both schedulers in lockstep: each step's admission
order, shed set, statuses and ``served_tokens`` must be equal. At the
engine, the SLO scheduler with loose deadlines gives every request the
static path's tokens and the JAX SLO engine's, in fp32.
"""
import random as pyrandom

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.config import get_config as jax_get_config  # noqa: E402
from repro.models.model import init_model as jax_init_model  # noqa: E402
from repro.serving import PagedCacheConfig as JaxPagedCacheConfig  # noqa: E402
from repro.serving import Request as JaxRequest  # noqa: E402
from repro.serving import SLOScheduler as JaxSLOScheduler  # noqa: E402
from repro.serving.engine import ServingEngine as JaxServingEngine  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.config import get_config  # noqa: E402
from repro_torch.serving import PagedCacheConfig, Request, ServingEngine  # noqa: E402
from repro_torch.serving.scheduler import SLOScheduler  # noqa: E402

torch.set_num_threads(2)

# (scheduler, paged-cache config, request) classes of each package
PACKAGES = {"port": (SLOScheduler, PagedCacheConfig, Request),
            "reference": (JaxSLOScheduler, JaxPagedCacheConfig, JaxRequest)}


@pytest.fixture(params=sorted(PACKAGES))
def pkg(request):
    return PACKAGES[request.param]


def _finish_prefill(sched, seq, tok=1):
    seq.prefill_pos = seq.request.prompt_len
    sched.finish_prefill(seq.slot)
    sched.on_prefill_token(seq.slot, tok)


def _drive_clocked(sched, pending, max_steps=2000):
    """The reference tests' driver: (admission order, drained seqs)."""
    pending = list(pending)
    admitted, drained = [], []
    clock = 0
    while pending or sched.has_work:
        assert clock < max_steps, "scheduler wedged"
        while pending and pending[0].arrival <= clock:
            sched.submit(pending.pop(0))
        sched.expire_deadlines(clock)
        admitted += [s.request.rid for s in sched.admit()]
        for seq in sched.prefilling():
            _finish_prefill(sched, seq)
        sched.ensure_append_capacity()
        for slot, seq in list(sched.active.items()):
            if seq.status == "decoding":
                sched.on_token(slot, 1)
        sched.check_invariants()
        drained += sched.drain_finished()
        clock += 1
    return admitted, drained


def _make(pkg, slots=1, num_pages=32, shed=True):
    sched_cls, pcfg_cls, _ = pkg
    return sched_cls(pcfg_cls(page_size=4, num_pages=num_pages, max_slots=slots,
                              max_pages_per_seq=4), shed=shed)


def _req(pkg, rid, *, plen=4, gen=4, tenant="t0", priority=0, deadline=None, arrival=0):
    return pkg[2](rid=rid, prompt=np.zeros(plen, np.int32), max_new_tokens=gen,
                  arrival=arrival, deadline=deadline, tenant=tenant, priority=priority)


def test_fair_share_interleaves_tenants_queued_back_to_back(pkg):
    sched = _make(pkg)
    reqs = ([_req(pkg, i, tenant="t0") for i in range(6)]
            + [_req(pkg, i + 6, tenant="t1") for i in range(6)])
    order, drained = _drive_clocked(sched, reqs)
    assert len(drained) == 12
    tenants = ["t0" if r < 6 else "t1" for r in order]
    assert tenants[1] == "t1"
    for k in range(1, len(tenants) + 1):
        assert abs(tenants[:k].count("t0") - tenants[:k].count("t1")) <= 1


def test_priority_flood_cannot_starve_another_tenant(pkg):
    sched = _make(pkg)
    reqs = ([_req(pkg, i, tenant="t0", priority=0) for i in range(5)]
            + [_req(pkg, i + 5, tenant="t1", priority=1) for i in range(5)])
    order, _ = _drive_clocked(sched, reqs)
    tenants = ["t0" if r < 5 else "t1" for r in order]
    for k in range(1, len(tenants) + 1):
        assert abs(tenants[:k].count("t0") - tenants[:k].count("t1")) <= 1


def test_priority_beats_deadline_within_tenant_edf_within_class(pkg):
    sched = _make(pkg, shed=False)
    reqs = [_req(pkg, 0, gen=3), _req(pkg, 1, priority=1, deadline=30, arrival=1),
            _req(pkg, 2, priority=0, deadline=200, arrival=1),
            _req(pkg, 3, priority=1, deadline=20, arrival=1),
            _req(pkg, 4, priority=1, arrival=1)]
    order, drained = _drive_clocked(sched, reqs)
    assert order == [0, 2, 3, 1, 4]
    assert all(s.status == "finished" for s in drained)


def test_deadline_tiebreak_is_fifo(pkg):
    sched = _make(pkg, shed=False)
    reqs = [_req(pkg, 0, gen=2)] + [_req(pkg, i, deadline=100, arrival=1) for i in (1, 2, 3)]
    order, _ = _drive_clocked(sched, reqs)
    assert order == [0, 1, 2, 3]


@pytest.mark.parametrize("shed, want", [(True, "shed"), (False, "timeout")])
def test_doomed_request_is_shed_not_served(pkg, shed, want):
    sched = _make(pkg, shed=shed)
    _, drained = _drive_clocked(sched, [_req(pkg, 0, gen=8, deadline=5),
                                        _req(pkg, 1, gen=4, deadline=100)])
    by_rid = {s.request.rid: s for s in drained}
    assert by_rid[0].status == want and by_rid[1].status == "finished"
    assert sched.shed_count == (1 if shed else 0)
    if shed:
        assert len(by_rid[0].generated) == 0


def test_request_doomed_by_queueing_is_shed_at_admission_time(pkg):
    sched = _make(pkg)
    _, drained = _drive_clocked(sched, [_req(pkg, 0, gen=12),
                                        _req(pkg, 1, gen=8, deadline=10, arrival=1),
                                        _req(pkg, 2, gen=4, deadline=100, arrival=1)])
    by_rid = {s.request.rid: s.status for s in drained}
    assert by_rid == {0: "finished", 1: "shed", 2: "finished"}


def test_served_token_accounting(pkg):
    sched = _make(pkg, slots=2)
    _drive_clocked(sched, [_req(pkg, 0, plen=6, gen=4, tenant="a"),
                           _req(pkg, 1, plen=3, gen=2, tenant="b")])
    assert sched.served_tokens == {"a": 10, "b": 5}
    assert sched.stats() == {"shed": 0, "tenant_a_tokens": 10, "tenant_b_tokens": 5}


# -------------------------------------------------- lockstep random schedules --

def _random_requests(rng, pcfg, cls):
    cap = pcfg.max_pages_per_seq * pcfg.page_size
    out = []
    for i in range(rng.randint(1, 16)):
        gen = rng.randint(1, cap - 1)
        plen = rng.randint(1, cap - gen)
        out.append(dict(rid=i, prompt=np.asarray([rng.randint(0, 96) for _ in range(plen)],
                                                 np.int32),
                        max_new_tokens=gen, arrival=rng.randint(0, 8),
                        deadline=rng.randint(2, 60) if rng.random() < 0.5 else None,
                        tenant=f"t{rng.randint(0, 2)}", priority=rng.randint(0, 2)))
    return [r for r in out if pcfg.pages_for(len(r["prompt"]) + r["max_new_tokens"])
            <= pcfg.num_pages]


# (seed, page_size, slots, pool_pages, shed)
LOCKSTEP = [(0, 4, 2, 16, True), (1, 2, 3, 12, True), (5, 8, 1, 10, False),
            (17, 3, 4, 24, True), (29, 6, 6, 40, False), (31, 5, 2, 8, True)]


@pytest.mark.parametrize("seed, page_size, slots, pool_pages, shed", LOCKSTEP)
def test_random_schedules_match_reference_step_by_step(seed, page_size, slots, pool_pages,
                                                       shed):
    """Both schedulers take the same submissions, ragged prefill chunks,
    cancellations and tokens, drawn once per step from one seeded stream:
    after every step the admitted rids (in order), the drained rids and
    statuses, the shed count and ``served_tokens`` are equal."""
    mpps = max(2, min(8, pool_pages // 2))
    geom = dict(page_size=page_size, num_pages=pool_pages, max_slots=slots,
                max_pages_per_seq=mpps)
    port = SLOScheduler(PagedCacheConfig(**geom), shed=shed)
    ref = JaxSLOScheduler(JaxPagedCacheConfig(**geom), shed=shed)
    spec = _random_requests(pyrandom.Random(seed), PagedCacheConfig(**geom), Request)
    pending = {"port": sorted((Request(**r) for r in spec), key=lambda r: r.arrival),
               "ref": sorted((JaxRequest(**r) for r in spec), key=lambda r: r.arrival)}
    rng = pyrandom.Random(seed + 1000)
    clock = 0
    while pending["port"] or port.has_work:
        assert clock < 5000, "scheduler wedged"
        for name, sched in (("port", port), ("ref", ref)):
            while pending[name] and pending[name][0].arrival <= clock:
                sched.submit(pending[name].pop(0))
            sched.expire_deadlines(clock)
        admitted = [[s.request.rid for s in sched.admit()] for sched in (port, ref)]
        assert admitted[0] == admitted[1], (clock, admitted)
        for seq in port.prefilling():
            plen = seq.request.prompt_len
            c = rng.randint(1, max(1, plen - seq.prefill_pos))
            twin = next(s for s in ref.prefilling() if s.request.rid == seq.request.rid)
            for sched, s in ((port, seq), (ref, twin)):
                s.prefill_pos = min(plen, s.prefill_pos + c)
                if s.prefill_pos == plen:
                    sched.finish_prefill(s.slot)
                    sched.on_prefill_token(s.slot, 1)
        if rng.random() < 0.1 and port.active:
            rid = rng.choice(sorted(s.request.rid for s in port.active.values()))
            assert port.cancel(rid) and ref.cancel(rid)
        for sched in (port, ref):
            decoding = [s for s in sched.active.values() if s.status == "decoding"]
            if decoding:
                sched.ensure_append_capacity()
                for s in list(decoding):
                    if s.slot in sched.active:
                        sched.on_token(s.slot, 1)
            sched.check_invariants()
        drained = [sorted((s.request.rid, s.status, len(s.generated))
                          for s in sched.drain_finished()) for sched in (port, ref)]
        assert drained[0] == drained[1], (clock, drained)
        assert port.shed_count == ref.shed_count and port.served_tokens == ref.served_tokens
        clock += 1
    assert not ref.has_work and port.pool.allocated_count == 0
    if not shed:
        assert port.shed_count == 0


# ------------------------------------------------------------------ engine --

def test_engine_slo_outputs_token_identical_to_oracle_and_reference():
    """Loose deadlines: nothing is shed, admissions reorder, and every
    request's tokens are the static path's and the JAX SLO engine's, in
    fp32; the stats carry the shed count and each tenant's tokens."""
    from repro_torch.launch.serve import static_greedy_reference

    jcfg = jax_get_config("smollm2-135m", reduced=True).replace(dtype="float32")
    tcfg = get_config("smollm2-135m", reduced=True).replace(dtype="float32")
    jp = jax_init_model(jax.random.PRNGKey(0), jcfg)
    tp = params_from_numpy(jax.device_get(jp), tcfg, device="cpu")
    geom = dict(page_size=4, num_pages=24, max_slots=2, max_pages_per_seq=4)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, tcfg.vocab, size=n).astype(np.int32) for n in (3, 7, 5, 9, 4, 6)]

    def trace(cls):
        return [cls(rid=i, prompt=p, max_new_tokens=4, deadline=200, tenant=f"t{i % 3}",
                    priority=i % 2) for i, p in enumerate(prompts)]

    jeng = JaxServingEngine(jcfg, jp, JaxPagedCacheConfig(**geom), prefill_token_budget=16,
                            scheduler="slo")
    ref = jeng.run(trace(JaxRequest))
    engine = ServingEngine(tcfg, tp, PagedCacheConfig(**geom), device="cpu",
                           prefill_token_budget=16, scheduler="slo")
    got = engine.run(trace(Request))
    assert set(engine.last_statuses.values()) == {"finished"}
    for i, p in enumerate(prompts):
        np.testing.assert_array_equal(got[i], ref[i], err_msg=f"request {i} vs reference")
        np.testing.assert_array_equal(
            got[i], static_greedy_reference(tcfg, engine.params, p, 4,
                                            engine.pcfg.max_seq, device="cpu"),
            err_msg=f"request {i} vs static")
    st, jst = engine.stats(), jeng.stats()
    assert st["shed"] == 0
    tenants = {k: v for k, v in st.items() if k.startswith("tenant_")}
    assert len(tenants) == 3 and tenants == {k: v for k, v in jst.items()
                                             if k.startswith("tenant_")}
