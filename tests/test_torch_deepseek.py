"""Port vs reference: the moe_lm family (deepseek-v3-671b, reduced: 3 layers,
the first dense, MLA attention, an MoE of 4 experts top-2 with one shared
expert) end to end.

The reference's ``init_model`` draws cross over through the weight
bridge; the same token ids run through both packages: the forward and its
loss (with the MoE aux loss), the static prefill and decode step with
their latent caches, a paged decode step against the static one (the
port's twin of ``tests/test_serving.py:186``), and the serving engine
with the prefix cache, chunked prefill and a reused slot. The models are
built with ``capacity_factor=8.0``, the reference tests' pin, where expert
capacity never binds, so the batched and the per-request paths route every
token alike (the reference's ``models/decode.py:46-54``).

Tolerances: fp32 compute at the ladder's 5e-5 rung on outputs divided by
the reference's root mean square; the bf16 latent caches at the bf16
rung. Greedy tokens in fp32 must be identical. In bf16 the reference
itself does not promise token identity between its chunked paged engine
and its static path (``tests/test_decode_consistency.py:118``, an xfail):
the port is held to the reference's agreement floor (``:132``): every
first token equal to the static path's, at least half of the requests
token for token.
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.checkpoint.store import _flatten_with_paths  # noqa: E402
from repro.config import get_config as jax_get_config  # noqa: E402
from repro.models import model as jm  # noqa: E402
from repro.serving import PagedCacheConfig as JaxPagedCacheConfig  # noqa: E402
from repro.serving import Request as JaxRequest  # noqa: E402
from repro.serving.engine import ServingEngine as JaxServingEngine  # noqa: E402
from repro.serving.streaming import StreamingConfig as JaxStreamingConfig  # noqa: E402
from repro_torch.bridge import expected_shapes, params_from_numpy  # noqa: E402
from repro_torch.config import get_config  # noqa: E402
from repro_torch.kernels.build import LAUNCHES  # noqa: E402
from repro_torch.kernels.testing import Tol, assert_scaled_close  # noqa: E402
from repro_torch.models import model as tm  # noqa: E402
from repro_torch.serving import PagedCacheConfig, Request, ServingEngine  # noqa: E402
from repro_torch.serving.paged_cache import PagePool, paged_write_pages  # noqa: E402
from repro_torch.serving.streaming import StreamingConfig, identity_horizon  # noqa: E402

torch.set_num_threads(2)

RUNG = Tol(rtol=5e-5, atol=5e-5)
BF16_RUNG = Tol(rtol=5e-2, atol=5e-2)
ARCH = "deepseek-v3-671b"
PIN = 8.0


def _close(got, ref, what="", tol=RUNG):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else got
    assert_scaled_close(np.asarray(got, np.float32),
                        np.asarray(jnp.asarray(ref, jnp.float32)), tol, err_msg=what)


def _configs(**kw):
    return (jax_get_config(ARCH, reduced=True).replace(**kw),
            get_config(ARCH, reduced=True).replace(**kw))


@pytest.fixture(scope="module")
def models():
    jcfg, tcfg = _configs(dtype="float32", capacity_factor=PIN)
    jp = jm.init_model(jax.random.PRNGKey(0), jcfg)
    return jcfg, jp, tcfg, params_from_numpy(jax.device_get(jp), tcfg, device="cpu")


def test_bridge_keys_and_shapes_are_the_reference_npz(models):
    """``expected_shapes`` (the port's init on the meta device) is the
    reference's npz layout key for key: the dense and MoE stacks, MLA's
    latent projections and norms, the shared expert."""
    _, jp, tcfg, tp = models
    npz = {k: tuple(v.shape) for k, v in _flatten_with_paths(jax.device_get(jp))}
    assert expected_shapes(tcfg) == npz
    assert "moe_layers/moe/shared/up/U" in npz and "dense_layers/attn/wukv/w" in npz
    assert tm.param_count(tp) == jm.param_count(jp)


def test_forward_logits_and_loss(models):
    jcfg, jp, tcfg, tp = models
    rng = np.random.default_rng(1)
    toks = rng.integers(0, jcfg.vocab, size=(2, 11)).astype(np.int32)
    labels = rng.integers(0, jcfg.vocab, size=(2, 11)).astype(np.int32)
    ref, raux = jm.forward(jp, jnp.asarray(toks), jcfg)
    jloss, jmet = jm.train_loss(jp, {"tokens": jnp.asarray(toks),
                                     "labels": jnp.asarray(labels)}, jcfg)
    with torch.no_grad():
        got, aux = tm.forward(tp, torch.tensor(toks), tcfg)
        loss, met = tm.train_loss(tp, {"tokens": torch.tensor(toks),
                                       "labels": torch.tensor(labels)}, tcfg)
    _close(got, ref, "logits")
    _close(aux, raux, "aux loss")
    assert float(aux) > 0.0
    _close(loss, jloss, "loss")
    _close(met["aux_loss"], jmet["aux_loss"], "loss's aux")


def test_static_prefill_and_decode_states(models):
    jcfg, jp, tcfg, tp = models
    rng = np.random.default_rng(2)
    toks = rng.integers(0, jcfg.vocab, size=(2, 9)).astype(np.int32)
    nxt = rng.integers(0, jcfg.vocab, size=(2, 1)).astype(np.int32)
    jl, js = jm.prefill(jp, jnp.asarray(toks), jcfg, jm.init_decode_state(jcfg, 2, 16))
    with torch.no_grad():
        tl, ts = tm.prefill(tp, torch.tensor(toks), tcfg,
                            tm.init_decode_state(tcfg, 2, 16, device="cpu"))
    _close(tl, jl, "prefill logits")
    assert set(ts) == set(js) == {"dense_cache", "moe_cache"}
    for key in ts:
        assert set(ts[key]) == set(js[key]) == {"ckv", "krope"}
        for name in ts[key]:
            assert tuple(ts[key][name].shape) == js[key][name].shape
            assert ts[key][name].dtype == torch.bfloat16
            _close(ts[key][name], js[key][name], f"prefill {key}/{name}", tol=BF16_RUNG)
    jd, js = jm.decode_step(jp, jnp.asarray(nxt), js, jnp.int32(9), jcfg)
    with torch.no_grad():
        td, ts = tm.decode_step(tp, torch.tensor(nxt), ts, 9, tcfg)
    _close(td, jd, "decode logits")
    for key in ts:
        for name in ts[key]:
            _close(ts[key][name], js[key][name], f"decode {key}/{name}", tol=BF16_RUNG)


@pytest.mark.parametrize("cold_kv", ["none", "int8"])
def test_paged_decode_step_matches_static(models, cold_kv):
    """The reference's construction (``tests/test_serving.py:186-222``):
    the static prefill's latents scattered into pages; one paged step
    through the absorbed-MLA kernel's plain version equals the static
    step (with the cold tier armed and no page flagged, through the cold
    one)."""
    _, _, tcfg, tp = models
    b, plen = 2, 6
    pcfg = PagedCacheConfig(page_size=4, num_pages=8, max_slots=b, max_pages_per_seq=3)
    prompt = torch.tensor(np.random.default_rng(5).integers(0, tcfg.vocab, size=(b, plen)))
    with torch.no_grad():
        state = tm.init_decode_state(tcfg, b, pcfg.max_seq, device="cpu")
        logits, state = tm.prefill(tp, prompt, tcfg, state)
        tok = torch.argmax(logits[:, -1], -1)[:, None]
        pstate = tm.init_paged_state(tcfg, pcfg, device="cpu", cold_kv=cold_kv)
        pool = PagePool(pcfg.num_pages)
        bt = np.full((b, pcfg.max_pages_per_seq), pcfg.null_page, dtype=np.int32)
        for slot in range(b):
            pages = pool.alloc(pcfg.pages_for(plen + 1))
            bt[slot, :len(pages)] = pages
            for key, cache in state.items():
                for name, leaf in cache.items():
                    paged_write_pages(pstate[key][name], torch.tensor(pages),
                                      leaf[:, slot, :plen], n_stack=1)
        ref, _ = tm.decode_step(tp, tok, state, plen, tcfg)
        flags = torch.zeros((pcfg.num_pages + 1,), dtype=torch.int32)
        LAUNCHES.clear()
        got, _ = tm.decode_step_paged(tp, tok, pstate, torch.tensor(bt),
                                      torch.full((b,), plen, dtype=torch.int32), tcfg,
                                      cold_flags=flags if cold_kv == "int8" else None)
    assert not LAUNCHES                         # the CPU runs the plain versions
    _close(got, ref.numpy(), "paged vs static decode logits")


def _trace(vocab, cls):
    """The reference's prefix/chunk trace (``tests/test_decode_consistency.py:89``):
    a 9-token system prompt shared by three requests, two slots, so the
    third takes a slot another request finished in."""
    rng = np.random.default_rng(0)
    system = rng.integers(0, vocab, size=(9,)).astype(np.int32)
    return [cls(rid=i, prompt=np.concatenate(
                [system, rng.integers(0, vocab, size=(t,)).astype(np.int32)]),
                max_new_tokens=g, arrival=a)
            for i, (t, g, a) in enumerate([(3, 4, 0), (2, 3, 2), (4, 4, 4)])]


def test_engine_tokens_identical_to_reference_engine(models):
    """Prefix cache, chunked prefill (budget 6) and slot reuse: the port's
    engine gives the JAX engine's tokens and its own static path's, token
    for token in fp32."""
    from repro_torch.launch.serve import static_greedy_reference

    jcfg, jp, tcfg, tp = models
    geom = dict(page_size=4, num_pages=32, max_slots=2, max_pages_per_seq=6)
    ref = JaxServingEngine(jcfg, jp, JaxPagedCacheConfig(**geom), prefill_token_budget=6,
                           prefix_cache=True, chunked_prefill=True).run(
        _trace(jcfg.vocab, JaxRequest))
    pcfg = PagedCacheConfig(**geom)
    engine = ServingEngine(tcfg, tp, pcfg, device="cpu", prefill_token_budget=6,
                           prefix_cache=True, chunked_prefill=True)
    got = engine.run(_trace(tcfg.vocab, Request))
    engine.sched.check_invariants()
    st = engine.stats()
    assert st["prefix_shared_tokens"] > 0 and st["prefill_chunks"] > len(got)
    for r in _trace(tcfg.vocab, Request):
        np.testing.assert_array_equal(got[r.rid], ref[r.rid], err_msg=f"request {r.rid}")
        np.testing.assert_array_equal(
            got[r.rid], static_greedy_reference(tcfg, engine.params, r.prompt,
                                                r.max_new_tokens, pcfg.max_seq, device="cpu"),
            err_msg=f"request {r.rid} vs static")


def test_bf16_agreement_floor():
    """The reference's floor (``tests/test_decode_consistency.py:132``) on
    its own trace, native bf16 at capacity factor 8.0: the port's chunked
    engine against the reference's static path over the same weights —
    every first token equal, at least half of the requests token for
    token."""
    from repro.launch.serve import static_greedy_reference as jax_static

    jcfg, tcfg = _configs(capacity_factor=PIN)
    assert tcfg.dtype == "bfloat16"
    jp = jm.init_model(jax.random.PRNGKey(0), jcfg)
    tp = params_from_numpy(jax.device_get(jp), tcfg, device="cpu")
    pcfg = PagedCacheConfig(page_size=16, num_pages=64, max_slots=4, max_pages_per_seq=8)
    rng = np.random.default_rng(0)
    reqs = [Request(rid=i, prompt=rng.integers(0, tcfg.vocab, size=(t,)).astype(np.int32),
                    max_new_tokens=g, arrival=0)
            for i, (t, g) in enumerate([(9, 4), (16, 8), (21, 12), (13, 4)])]
    engine = ServingEngine(tcfg, tp, pcfg, device="cpu", prefill_token_budget=64,
                           chunked_prefill=True)
    outs = engine.run(reqs)
    exact = 0
    for r in reqs:
        ref = np.asarray(jax_static(jcfg, jp, r.prompt, r.max_new_tokens, pcfg.max_seq))
        assert outs[r.rid][0] == ref[0], f"request {r.rid}: first token"
        exact += int(np.array_equal(outs[r.rid], ref))
    assert exact >= len(reqs) / 2, f"only {exact}/{len(reqs)} requests token-exact"


def test_cold_tier_matches_reference_streaming_engine(models):
    """Streaming with the int8 cold tier (sink 1, window 2, page 4): one
    session decodes far past the resident cap, two stay inside the
    horizon. The port's ledger and tokens equal the JAX streaming
    engine's (its chunk step run to completion before the host goes on:
    as it stands it races the scheduler's in-place block-table edits,
    ROADMAP queue 3); the requests within the horizon are the static
    path's. The session's prompt fits the window: the reference demotes a
    longer prompt's page before writing it and reads the stale shadow
    (queue 3), where the port demotes only written pages and a long
    prompt's first token stays the static path's."""
    from repro_torch.launch.serve import static_greedy_reference

    jcfg, jp, tcfg, tp = models
    geom = dict(page_size=4, num_pages=12, max_slots=2, max_pages_per_seq=4)
    spec = [(7, 18, 0), (5, 6, 0), (4, 7, 1)]
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, tcfg.vocab, size=(n,)).astype(np.int32) for n, _, _ in spec]

    jeng = JaxServingEngine(jcfg, jp, JaxPagedCacheConfig(**geom),
                            streaming=JaxStreamingConfig(1, 2, "int8"), chunked_prefill=True)
    chunk = jeng._chunk_fn
    jeng._chunk_fn = lambda *a: jax.block_until_ready(chunk(*a))
    ref = jeng.run([JaxRequest(rid=i, prompt=p, max_new_tokens=g, arrival=a)
                    for i, (p, (_, g, a)) in enumerate(zip(prompts, spec))])
    jst = jeng.stats()
    pcfg = PagedCacheConfig(**geom)
    scfg = StreamingConfig(1, 2, "int8")
    engine = ServingEngine(tcfg, tp, pcfg, device="cpu", streaming=scfg, chunked_prefill=True)
    out = engine.run([Request(rid=i, prompt=p, max_new_tokens=g, arrival=a)
                      for i, (p, (_, g, a)) in enumerate(zip(prompts, spec))])
    engine.sched.check_invariants()
    st = engine.stats()
    assert st["stream_evictions"] > 0 and st["stream_demotions"] > 0
    for key in ("stream_evictions", "stream_demotions", "cold_page_bytes", "peak_pages"):
        assert st[key] == jst[key], key
    assert set(engine.state) == {"dense_cache", "moe_cache"}
    assert engine.state["moe_cache"]["ckv_scale"].shape == (2, 13, tcfg.kv_lora_rank)
    horizon = identity_horizon(scfg, pcfg)
    for i, (n, g, _) in enumerate(spec):
        np.testing.assert_array_equal(out[i], ref[i], err_msg=f"request {i} vs engine")
        if n + g <= horizon:
            np.testing.assert_array_equal(
                out[i], static_greedy_reference(tcfg, engine.params, prompts[i], g,
                                                pcfg.max_seq, device="cpu"),
                err_msg=f"request {i} vs static")
    long = rng.integers(0, tcfg.vocab, size=(13,)).astype(np.int32)
    first = ServingEngine(tcfg, tp, pcfg, device="cpu", streaming=scfg,
                          chunked_prefill=True).run([Request(rid=0, prompt=long,
                                                             max_new_tokens=2)])[0][0]
    assert first == static_greedy_reference(tcfg, tp, long, 1, pcfg.max_seq, device="cpu")[0]


def test_serving_keeps_wukv_fp32(models):
    """serving_params casts once to the compute dtype but keeps MLA's
    up-projection in fp32: the absorbed decode reads W_uk and W_uv as fp32
    (``src/repro/nn/attention.py:678-684``), and a bf16 copy would give
    another q_lat. A leaf named ``w`` elsewhere is cast."""
    _, _, tcfg, tp = models
    cfg = tcfg.replace(dtype="bfloat16")
    sp = tm.serving_params(tp, cfg, torch.device("cpu"))
    for stack in ("dense_layers", "moe_layers"):
        attn = sp[stack]["attn"]
        assert attn["wukv"]["w"].dtype == torch.float32
        assert torch.equal(attn["wukv"]["w"], tp[stack]["attn"]["wukv"]["w"])
        assert attn["wdkv"]["w"].dtype == attn["wo"]["w"].dtype == torch.bfloat16
    moe = sp["moe_layers"]["moe"]
    assert moe["router"]["w"].dtype == moe["gate"]["U"].dtype == torch.bfloat16
    assert moe["gate"]["s"].dtype == moe["shared"]["up"]["s"].dtype == torch.float32
    w = tp["moe_layers"]["attn"]["wukv"]["w"]
    assert not torch.equal(w.to(torch.bfloat16).float(), w)   # the cast would lose bits


def test_cli_serves_deepseek_on_cpu(capsys):
    from repro_torch.launch.serve import main

    main(["--arch", ARCH, "--reduced", "--paged", "--stream", "--device", "cpu",
          "--requests", "4", "--gen", "6", "--prompt-len", "10"])
    out = capsys.readouterr().out
    assert "served 4 requests" in out and "paged attention cache:" in out
    main(["--arch", ARCH, "--reduced", "--paged", "--stream", "--device", "cpu",
          "--requests", "3", "--gen", "12", "--prompt-len", "10", "--page-size", "4",
          "--num-pages", "16", "--streaming-window", "2", "--cold-kv", "int8"])
    out = capsys.readouterr().out
    assert "served 3 requests" in out and "demoted to int8" in out


def test_cli_verify_refuses_where_capacity_binds():
    """At the config's capacity factor (1.25) a 4-slot decode step gives
    each of the reduced config's 4 experts 2 slots for 4 rows x top 2:
    --verify stops before serving."""
    from repro_torch.launch.serve import decode_capacity_binds, main

    assert decode_capacity_binds(get_config(ARCH, reduced=True), 4) == 2
    assert decode_capacity_binds(get_config(ARCH), 4) == 1
    assert decode_capacity_binds(get_config(ARCH).replace(capacity_factor=32.0), 4) is None
    assert decode_capacity_binds(get_config(ARCH).replace(capacity_factor=8.0), 4) == 1
    with pytest.raises(SystemExit, match=r"capacity of 2 tokens.*capacity_factor=8\.0"):
        main(["--arch", ARCH, "--reduced", "--paged", "--stream", "--verify",
              "--device", "cpu"])


def test_unported_paths_raise(models):
    from repro_torch.launch.steps import make_train_step

    _, _, tcfg, tp = models
    # the family trains (tests/test_torch_deepseek_train.py), microbatched
    # too (tests/test_torch_runtime.py); rank telemetry is not ported
    assert callable(make_train_step(tcfg, microbatches=2))
    with pytest.raises(NotImplementedError, match="telemetry"):
        make_train_step(tcfg, microbatches=2, telemetry=True)
    # int8 weights are served (tests/test_torch_quantize_moe.py): the MoE
    # subtree and wukv stay raw; tensor-parallel serving raises
    pcfg = PagedCacheConfig(page_size=4, num_pages=12, max_slots=2, max_pages_per_seq=4)
    engine = ServingEngine(tcfg, tp, pcfg, device="cpu", quantize="int8")
    assert torch.is_tensor(engine.params["moe_layers"]["moe"]["router"]["w"])
    with pytest.raises(NotImplementedError, match="item 8"):
        ServingEngine(tcfg, tp, pcfg, device="cpu", mesh=object())

