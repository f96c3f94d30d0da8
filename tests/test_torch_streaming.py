"""Port vs reference: long-context streaming with the int8 cold tier.

The plain cold decode (``kernels/paged_ref.py:paged_gqa_decode_cold_ref``)
is held against the reference's ``paged_gqa_decode_cold_pallas`` (in
interpret mode) and its gather path (``_gather_cold`` + ``_sdpa``); the
cold paged state has the reference's leaves; one decode step with cold
pages flagged gives the reference's logits and appended pools from the
same pool contents; and whole streaming sessions (page 4, 8 pages, sink
1, window 2, as in ``tests/test_streaming.py``) give the reference
engine's tokens and eviction/demotion ledger.

The reference's streaming session is not deterministic as it stands: its
chunk step receives ``jnp.asarray`` of a row of the scheduler's block
table, which on the CPU may alias the host array, and the next chunk's
eviction compacts that row in place while the asynchronously dispatched
chunk has not yet read it. The sessions here therefore run the
reference's chunk step to completion before the host goes on (a wrapper
around the reference engine's own ``_chunk_fn``; nothing in the
reference package changes). Each reference session still runs twice and
its tokens are compared with the port's only when the two runs agree;
the module-level step test holds the port past the horizon regardless.
The port demotes a page only once it is full of written tokens, where
the reference may demote a prompt page before writing it
(``test_cold_tier_demotes_only_written_pages``; ROADMAP queue 3); the
sessions compared with the reference here give the same tokens either
way.

Tolerances (ladder, outputs scaled by the reference's RMS): fp32 5e-5
(the same fp32 sums in another order), bf16 5e-2. Engines run fp32
compute. Inputs are made with numpy and fed to both packages.
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.config import get_config as jax_get_config  # noqa: E402
from repro.kernels.paged_decode import paged_gqa_decode_cold_pallas  # noqa: E402
from repro.kernels.testing import forced_interpret  # noqa: E402
from repro.models.model import init_model as jax_init_model  # noqa: E402
from repro.serving import PagedCacheConfig as JaxPagedCacheConfig  # noqa: E402
from repro.serving import Request as JaxRequest  # noqa: E402
from repro.serving import StreamingConfig as JaxStreamingConfig  # noqa: E402
from repro.serving.engine import ServingEngine as JaxServingEngine  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.config import get_config  # noqa: E402
from repro_torch.kernels.build import LAUNCHES  # noqa: E402
from repro_torch.kernels.paged_decode import paged_gqa_decode_cold  # noqa: E402
from repro_torch.kernels.testing import (  # noqa: E402
    TOLERANCE_LADDER,
    assert_scaled_close,
    make_block_table,
    ragged_seq_lens,
)
from repro_torch.launch.serve import static_greedy_reference  # noqa: E402
from repro_torch.serving import PagedCacheConfig, Request, ServingEngine  # noqa: E402
from repro_torch.serving import quantize as tq  # noqa: E402
from repro_torch.serving.streaming import StreamingConfig, identity_horizon  # noqa: E402

torch.set_num_threads(2)

DTYPES = {"float32": (torch.float32, jnp.float32), "bfloat16": (torch.bfloat16, jnp.bfloat16)}
LEDGER = ("stream_evictions", "stream_demotions", "cold_page_bytes", "peak_pages",
          "generated_tokens")


# ------------------------------------------------------- the cold decode --

def _cold_case(b, kvh, rep, hd, page, n, p_cold, seed=0):
    """numpy inputs: bf16-valued pools, int8 shadows quantized from noise
    independent of the pools (a wrong-tier read misses by O(1), as the
    reference's ``_cold_shadow`` builds them), ragged lengths, a
    shuffled table, slot 0 parked on the null page, random flags."""
    num_pages = b * n + 3
    rng = np.random.default_rng(seed)
    shape = (num_pages + 1, page, kvh, hd)
    pools = [torch.tensor(rng.standard_normal(shape), dtype=torch.float32).bfloat16()
             for _ in range(2)]
    shadows = [tq.quantize_kv_pages(torch.tensor(rng.standard_normal(shape),
                                                 dtype=torch.float32), token_axis=1)
               for _ in range(2)]
    q = rng.standard_normal((b, kvh, rep, hd)).astype(np.float32)
    sl = ragged_seq_lens(b, page * n - 1, page, seed)
    bt = make_block_table(b, n, num_pages, sl, page, seed)
    bt[0, :] = num_pages
    cold = (rng.uniform(size=(num_pages + 1,)) < p_cold).astype(np.int32)
    return (q, pools[0], pools[1], shadows[0]["q8"], shadows[0]["scale"],
            shadows[1]["q8"], shadows[1]["scale"], bt, sl, torch.tensor(cold))


def _jax_args(args, jdt):
    q, kp, vp, kq, ks, vq, vs, bt, sl, cold = args
    return (jnp.asarray(q, jdt), jnp.asarray(kp.float().numpy(), jnp.bfloat16),
            jnp.asarray(vp.float().numpy(), jnp.bfloat16), jnp.asarray(kq.numpy()),
            jnp.asarray(ks.numpy()), jnp.asarray(vq.numpy()), jnp.asarray(vs.numpy()),
            jnp.asarray(bt.numpy()), jnp.asarray(sl.numpy()), jnp.asarray(cold.numpy()))


@pytest.mark.parametrize("p_cold", [0.0, 0.5, 1.0])
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("case", [(4, 2, 3, 64, 4, 6), (3, 1, 4, 20, 3, 5)],
                         ids=lambda c: "-".join(map(str, c)))
def test_plain_cold_decode_matches_reference_kernel(case, dtype, p_cold):
    tdt, jdt = DTYPES[dtype]
    args = _cold_case(*case, p_cold)
    before = LAUNCHES["paged_gqa_decode_cold"]
    y = paged_gqa_decode_cold(torch.tensor(args[0]).to(tdt), *args[1:])
    assert LAUNCHES["paged_gqa_decode_cold"] == before      # CPU tensors: plain version
    assert y.dtype == tdt
    with forced_interpret():
        yr = paged_gqa_decode_cold_pallas(*_jax_args(args, jdt))
    for part in (slice(1, None), slice(0, 1)):          # live slots, then the null slot
        assert_scaled_close(y[part].float().numpy(), np.asarray(yr, np.float32)[part],
                            TOLERANCE_LADDER[tdt])


@pytest.mark.parametrize("p_cold", [0.0, 0.5, 1.0])
def test_plain_cold_decode_matches_reference_gather_path(p_cold):
    """Against the reference's other branch of the same attention:
    ``_gather_cold`` into the logical view, then the masked fp32
    ``_sdpa`` (``SCT_PAGED_KERNEL=0``); and the port's ``_gather_cold``
    gives the reference's view bit for bit."""
    from repro.nn.attention import _gather_cold as jax_gather_cold
    from repro.nn.attention import _sdpa as jax_sdpa
    from repro_torch.nn.attention import _gather_cold

    args = _cold_case(4, 2, 3, 16, 4, 6, p_cold, seed=1)
    q, kp, vp, kq, ks, vq, vs, bt, sl, cold = args
    y = paged_gqa_decode_cold(torch.tensor(q), *args[1:])
    j = _jax_args(args, jnp.float32)
    jcache = {"k": j[1], "v": j[2], "k_q8": j[3], "k_scale": j[4], "v_q8": j[5],
              "v_scale": j[6]}
    tcache = {"k": kp, "v": vp, "k_q8": kq, "k_scale": ks, "v_q8": vq, "v_scale": vs}
    ck = jax_gather_cold(jcache, "k", j[7], j[9])
    cv = jax_gather_cold(jcache, "v", j[7], j[9])
    for name, ref in (("k", ck), ("v", cv)):
        got = _gather_cold(tcache, name, bt, cold)
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    b, kvh, rep, hd = q.shape
    valid = jnp.arange(ck.shape[1])[None, :] <= j[8][:, None]
    yr = jax_sdpa(j[0].reshape(b, 1, kvh * rep, hd), ck, cv, causal=False,
                  kv_len_mask=valid).reshape(b, kvh, rep, hd)
    assert_scaled_close(y[1:].numpy(), np.asarray(yr)[1:], TOLERANCE_LADDER[torch.float32])


# ---------------------------------------------------------- model level --

@pytest.fixture(scope="module")
def llama():
    jcfg = jax_get_config("llama3.2-1b", reduced=True).replace(dtype="float32")
    tcfg = get_config("llama3.2-1b", reduced=True).replace(dtype="float32")
    jp = jax_init_model(jax.random.PRNGKey(0), jcfg)
    return jcfg, jp, tcfg, params_from_numpy(jax.device_get(jp), tcfg, device="cpu")


def test_cold_paged_state_has_reference_leaves(llama):
    from repro.models.model import init_paged_state as jax_init_paged_state
    from repro_torch.models.model import init_paged_state

    jcfg, _, tcfg, _ = llama
    geom = dict(page_size=4, num_pages=8, max_slots=1, max_pages_per_seq=4)
    for cold_kv in ("none", "int8"):
        got = init_paged_state(tcfg, PagedCacheConfig(**geom), device="cpu", cold_kv=cold_kv)
        ref = jax_init_paged_state(jcfg, JaxPagedCacheConfig(**geom), cold_kv)
        assert sorted(got) == sorted(ref) == ["cache"]
        assert sorted(got["cache"]) == sorted(ref["cache"])
        for name, leaf in got["cache"].items():
            assert tuple(leaf.shape) == ref["cache"][name].shape, name
            assert str(leaf.dtype).replace("torch.", "") == str(ref["cache"][name].dtype)
            assert not leaf.any()


def test_decode_step_with_cold_pages_matches_reference(llama):
    """Past the horizon, at module level: one batched decode step over
    pools, shadows and flags filled from numpy (some of every slot's
    pages cold) gives the reference's logits and appended pools."""
    from repro.models.model import decode_step_paged as jax_decode_step_paged
    from repro.models.model import init_paged_state as jax_init_paged_state
    from repro_torch.models.model import decode_step_paged, init_paged_state

    jcfg, jp, tcfg, tp = llama
    pcfg = PagedCacheConfig(page_size=4, num_pages=16, max_slots=3, max_pages_per_seq=5)
    state = init_paged_state(tcfg, pcfg, device="cpu", cold_kv="int8")
    rng = np.random.default_rng(4)
    cache = state["cache"]
    for name in ("k", "v"):
        cache[name].copy_(torch.tensor(rng.standard_normal(tuple(cache[name].shape)),
                                       dtype=torch.float32))
        qt = tq.quantize_kv_pages(torch.tensor(rng.standard_normal(tuple(cache[name].shape)),
                                               dtype=torch.float32), token_axis=2)
        cache[name + "_q8"].copy_(qt["q8"])
        cache[name + "_scale"].copy_(qt["scale"])
    jstate = jax_init_paged_state(jcfg, JaxPagedCacheConfig(page_size=4, num_pages=16,
                                                            max_slots=3, max_pages_per_seq=5),
                                  "int8")
    jstate = {"cache": {k: jnp.asarray(v.float().numpy() if v.dtype == torch.bfloat16
                                       else v.numpy(), jstate["cache"][k].dtype)
                        for k, v in cache.items()}}
    bt = np.array([[3, 7, 1, 16, 16], [0, 5, 9, 12, 2], [16, 16, 16, 16, 16]], np.int32)
    sl = np.array([9, 17, 0], np.int32)
    cold = np.zeros((17,), np.int32)
    cold[[7, 5, 9, 12]] = 1                                  # mid-sequence pages
    toks = np.array([[11], [402], [0]], np.int32)
    logits, state = decode_step_paged(tp, torch.tensor(toks, dtype=torch.int64), state,
                                      torch.tensor(bt), torch.tensor(sl), tcfg,
                                      cold_flags=torch.tensor(cold))
    jlogits, jstate = jax_decode_step_paged(jp, jnp.asarray(toks), jstate, jnp.asarray(bt),
                                            jnp.asarray(sl), jcfg,
                                            cold_flags=jnp.asarray(cold))
    assert_scaled_close(logits[:2].numpy(), np.asarray(jlogits)[:2],
                        TOLERANCE_LADDER[torch.float32])
    for name in ("k", "v"):
        np.testing.assert_array_equal(state["cache"][name].float().numpy(),
                                      np.asarray(jstate["cache"][name], np.float32))
    # the flags decide: the same step with none set reads other values
    # (the append rewrites the same token at the same position)
    hot, _ = decode_step_paged(tp, torch.tensor(toks, dtype=torch.int64), state,
                               torch.tensor(bt), torch.tensor(sl), tcfg,
                               cold_flags=torch.zeros_like(torch.tensor(cold)))
    assert not torch.allclose(hot[:2], logits[:2], atol=1e-3)


# ------------------------------------------------------------- sessions --

GEOM = dict(page_size=4, num_pages=8, max_slots=1, max_pages_per_seq=4)
# (prompt_len, max_new_tokens, arrival): one session far past the pool's
# nominal capacity, then two requests inside the 12-token horizon
SESSION = [(24, 40, 0), (5, 7, 0), (3, 9, 1)]


def _session_prompts(vocab):
    rng = np.random.default_rng(1)
    return [rng.integers(0, vocab, size=(n,)).astype(np.int32) for n, _, _ in SESSION]


def _jax_session(jcfg, jp, cold_kv, prompts):
    engine = JaxServingEngine(jcfg, jp, JaxPagedCacheConfig(**GEOM),
                              streaming=JaxStreamingConfig(1, 2, cold_kv),
                              chunked_prefill=True)
    chunk = engine._chunk_fn                 # run each chunk before the host mutates
    engine._chunk_fn = lambda *a: jax.block_until_ready(chunk(*a))
    out = engine.run([JaxRequest(rid=i, prompt=p, max_new_tokens=g, arrival=a)
                      for i, (p, (_, g, a)) in enumerate(zip(prompts, SESSION))])
    engine.sched.check_invariants()
    return out, engine.stats()


def _port_session(tcfg, tp, cold_kv, prompts, **kw):
    engine = ServingEngine(tcfg, tp, PagedCacheConfig(**GEOM), device="cpu",
                           streaming=StreamingConfig(1, 2, cold_kv), chunked_prefill=True,
                           **kw)
    out = engine.run([Request(rid=i, prompt=p, max_new_tokens=g, arrival=a)
                      for i, (p, (_, g, a)) in enumerate(zip(prompts, SESSION))])
    engine.sched.check_invariants()
    assert engine.sched.pool.allocated_count == 0
    return out, engine.stats(), engine


@pytest.mark.parametrize("cold_kv", ["none", "int8"])
def test_streaming_session_matches_reference_engine(llama, cold_kv):
    jcfg, jp, tcfg, tp = llama
    prompts = _session_prompts(tcfg.vocab)
    out, st, engine = _port_session(tcfg, tp, cold_kv, prompts)
    out2, st2, _ = _port_session(tcfg, tp, cold_kv, prompts)
    ref, jst = _jax_session(jcfg, jp, cold_kv, prompts)
    ref2, _ = _jax_session(jcfg, jp, cold_kv, prompts)
    assert st["stream_evictions"] > 0
    assert st["peak_pages"] <= 1 + 2 + 1                       # resident cap
    if cold_kv == "int8":
        assert st["stream_demotions"] > 0 and st["cold_page_bytes"] > 0
    else:
        assert st["stream_demotions"] == 0
    for key in LEDGER:                                         # host-side: exact
        assert st[key] == jst[key] == st2[key], key
    horizon = identity_horizon(engine.streaming, engine.pcfg)
    for i, (n, g, _) in enumerate(SESSION):
        np.testing.assert_array_equal(out[i], out2[i], err_msg=f"request {i}: port rerun")
        if n + g <= horizon:
            np.testing.assert_array_equal(
                out[i], static_greedy_reference(tcfg, engine.params, prompts[i], g,
                                                engine.pcfg.max_seq, device="cpu"),
                err_msg=f"request {i} vs static")
        if np.array_equal(ref[i], ref2[i]):                    # a stable reference only
            np.testing.assert_array_equal(out[i], ref[i], err_msg=f"request {i} vs engine")


def test_every_request_equals_its_replay_alone(llama):
    """The exact oracle of the card's phases: two slots, staggered
    arrivals, int8 weights and the int8 cold tier; every request, long
    or short, gives the tokens it gives when served alone, and the one
    within the horizon is the static path's choice at every step."""
    from repro_torch.launch.serve import replay_alone, static_logit_gaps

    _, _, tcfg, tp = llama
    pcfg = PagedCacheConfig(page_size=4, num_pages=16, max_slots=2, max_pages_per_seq=4)
    engine = ServingEngine(tcfg, tp, pcfg, device="cpu", quantize="int8",
                           streaming=StreamingConfig(1, 2, "int8"))
    rng = np.random.default_rng(5)
    reqs = [Request(rid=i, prompt=rng.integers(0, tcfg.vocab, size=(n,)).astype(np.int32),
                    max_new_tokens=g, arrival=a)
            for i, (n, g, a) in enumerate([(14, 30, 0), (5, 7, 1), (9, 25, 2)])]
    out = engine.run(reqs)
    assert engine.stats()["stream_demotions"] > 0
    for r in reqs:
        np.testing.assert_array_equal(out[r.rid], replay_alone(engine, r),
                                      err_msg=f"request {r.rid}")
    short = reqs[1]
    assert short.prompt_len + short.max_new_tokens <= identity_horizon(engine.streaming, pcfg)
    gaps = static_logit_gaps(tcfg, engine.params, short.prompt, out[short.rid],
                             pcfg.max_seq, device="cpu")
    assert gaps.shape == (short.max_new_tokens,) and gaps.max() == 0.0
    # a token the static path would not choose shows as a gap
    wrong = out[short.rid].copy()
    wrong[3] = (wrong[3] + 1) % tcfg.vocab
    assert static_logit_gaps(tcfg, engine.params, short.prompt, wrong, pcfg.max_seq,
                             device="cpu")[3] > 1.0


def test_streaming_with_int8_weights_matches_reference_engine(llama):
    """The chip's streaming cell on the CPU: int8 weights and int8 cold
    KV together."""
    jcfg, jp, tcfg, tp = llama
    prompts = _session_prompts(tcfg.vocab)
    out, st, _ = _port_session(tcfg, tp, "int8", prompts, quantize="int8")
    engine = JaxServingEngine(jcfg, jp, JaxPagedCacheConfig(**GEOM),
                              streaming=JaxStreamingConfig(1, 2, "int8"),
                              chunked_prefill=True, quantize="int8")
    chunk = engine._chunk_fn
    engine._chunk_fn = lambda *a: jax.block_until_ready(chunk(*a))
    ref = engine.run([JaxRequest(rid=i, prompt=p, max_new_tokens=g, arrival=a)
                      for i, (p, (_, g, a)) in enumerate(zip(prompts, SESSION))])
    jst = engine.stats()
    for key in LEDGER + ("weight_bytes",):
        assert st[key] == jst[key], key
    for i in range(len(SESSION)):
        np.testing.assert_array_equal(out[i], ref[i], err_msg=f"request {i}")


def test_cold_tier_demotes_only_written_pages(llama):
    """A page is demoted only once every one of its positions holds a
    written token. Admission allocates a long prompt's pages up to the
    resident cap before its first chunk runs, and the reference demotes
    the one past the sink then, stale; with the flag set, attention reads
    that stale shadow. Here every demotion sees a full page, and a reused
    engine gives the same tokens for the same trace twice (the reference
    engine does not: ROADMAP queue 3)."""
    _, _, tcfg, tp = llama
    pcfg = PagedCacheConfig(page_size=16, num_pages=32, max_slots=2, max_pages_per_seq=8)
    engine = ServingEngine(tcfg, tp, pcfg, device="cpu", prefill_token_budget=64,
                           streaming=StreamingConfig(1, 4, "int8"))
    rng = np.random.default_rng(7)
    trace = [Request(rid=i, prompt=rng.integers(0, tcfg.vocab, size=(n,)).astype(np.int32),
                     max_new_tokens=g) for i, (n, g) in enumerate([(96, 40), (128, 24)])]
    demote = engine._demote
    seen = []

    def checked_demote(page):
        seq = next(q for q in engine.sched.active.values() if page in q.pages)
        written = (seq.seq_len if seq.status == "decoding"
                   else seq.prefill_pos - seq.evicted_tokens)
        assert seq.pages.index(page) < written // pcfg.page_size, (page, seq.pages, written)
        seen.append(page)
        demote(page)

    engine._demote = checked_demote
    first = engine.run(trace)
    second = engine.run(trace)
    assert seen and engine.stats()["stream_demotions"] == len(seen)
    for r in trace:
        np.testing.assert_array_equal(first[r.rid], second[r.rid], err_msg=f"request {r.rid}")


def test_streaming_prefix_cache_warm_shared_sinks(llama):
    """A cached shared prefix inside the sink region is mapped, not
    copied, stays warm across run() calls, gives the static path's and
    the reference's tokens, and every pin unwinds
    (``tests/test_streaming.py:278`` on the port)."""
    jcfg, jp, tcfg, tp = llama
    geom = dict(page_size=4, num_pages=16, max_slots=2, max_pages_per_seq=4)
    rng = np.random.default_rng(2)
    prompt = rng.integers(0, tcfg.vocab, size=(9,)).astype(np.int32)
    engine = ServingEngine(tcfg, tp, PagedCacheConfig(**geom), device="cpu",
                           streaming=StreamingConfig(1, 2), prefix_cache=True)
    out1 = engine.run([Request(rid=0, prompt=prompt, max_new_tokens=3)])
    shared_before = engine.stats()["prefix_shared_tokens"]
    out2 = engine.run([Request(rid=1, prompt=prompt, max_new_tokens=3)])
    engine.sched.check_invariants()
    assert engine.stats()["prefix_shared_tokens"] > shared_before
    np.testing.assert_array_equal(out1[0], out2[1])
    np.testing.assert_array_equal(
        out1[0], static_greedy_reference(tcfg, engine.params, prompt, 3,
                                         engine.pcfg.max_seq, device="cpu"))
    jeng = JaxServingEngine(jcfg, jp, JaxPagedCacheConfig(**geom),
                            streaming=JaxStreamingConfig(1, 2), prefix_cache=True)
    np.testing.assert_array_equal(
        out1[0], jeng.run([JaxRequest(rid=0, prompt=prompt, max_new_tokens=3)])[0])
    for p in engine.sched.prefix_cache.pages:
        assert engine.sched.pool.refcount(p) == 1
        assert engine.sched.pool.pin_count(p) == 0
    assert engine.sched.pool.allocated_count == len(engine.sched.prefix_cache.pages)


# ------------------------------------------------------------------ CLI --

def test_cli_streaming_cold_int8_verify_on_cpu(capsys):
    from repro_torch.launch.serve import main

    main(["--arch", "llama3.2-1b", "--reduced", "--paged", "--stream", "--verify",
          "--device", "cpu", "--quantize", "int8", "--streaming-window", "2",
          "--cold-kv", "int8", "--page-size", "4", "--num-pages", "32",
          "--pages-per-seq", "8", "--requests", "4", "--prompt-len", "8", "--gen", "14"])
    out = capsys.readouterr().out
    assert "streaming: sink=1p + window=2p resident cap" in out
    assert "demoted to int8" in out and "weights:" in out
    assert "beyond the 12-token streaming identity horizon skipped" in out


@pytest.mark.parametrize("argv, match", [
    (["--cold-kv", "int8"], "--cold-kv needs --streaming-window"),
    (["--streaming-window", "8"], "exceeds --pages-per-seq"),
    (["--streaming-window", "0"], ">= 1"),
], ids=["cold-without-window", "cap-over-table", "empty-window"])
def test_cli_streaming_flag_checks(argv, match):
    from repro_torch.launch.serve import main

    with pytest.raises(SystemExit, match=match):
        main(["--arch", "llama3.2-1b", "--reduced", "--paged", "--stream",
              "--device", "cpu", *argv])


def test_unported_streaming_options_raise(llama):
    """What the slice leaves out still raises: tensor-parallel serving
    (with or without streaming) and the SLO scheduler."""
    _, _, tcfg, tp = llama
    pcfg = PagedCacheConfig(**GEOM)
    for kw in ({"streaming": StreamingConfig(1, 2, "int8"), "mesh": object()},
               {"streaming": StreamingConfig(1, 2), "scheduler": "slo"}):
        with pytest.raises(NotImplementedError):
            ServingEngine(tcfg, tp, pcfg, device="cpu", **kw)
    with pytest.raises(ValueError, match="int4"):
        ServingEngine(tcfg, tp, pcfg, device="cpu", quantize="int4")
