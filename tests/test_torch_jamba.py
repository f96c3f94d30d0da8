"""Port vs reference: the hybrid family (jamba-v0.1-52b, reduced: 2 periods
of 4 layers, attention at position 2, MoE on odd positions) end to end.

The reference's ``init_model`` draws cross over through the weight
bridge; the same token ids run through both packages: the forward and
its loss (with the MoE aux loss), the static prefill and decode step with
their states, the paged decode step against the static one, and the
serving engine with a reused slot. The models are built with
``capacity_factor=8.0``, the reference tests' pin, where expert capacity
never binds, so the batched and the per-request paths route every token
alike (the reference's ``models/decode.py:46-54``).

Tolerances (fp32 compute): the ladder's 5e-5 rung on outputs divided by
the reference's root mean square for the forward and the prefill; the
bf16 leaves of the serving state (K/V, the mamba conv tail and SSM
state) at the bf16 rung, and the logits of a step that reads them at
1e-3 — each side rounds fp32 values that agree at the fp32 rung, one
that straddles a bf16 rounding boundary lands a bf16 step away, and such
an element moves the next logits by ~1e-4 of their RMS. Serving compares
greedy tokens, which must be identical.
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.config import get_config as jax_get_config  # noqa: E402
from repro.models import model as jm  # noqa: E402
from repro.serving import PagedCacheConfig as JaxPagedCacheConfig  # noqa: E402
from repro.serving import Request as JaxRequest  # noqa: E402
from repro.serving.engine import ServingEngine as JaxServingEngine  # noqa: E402
from repro_torch.bridge import expected_shapes, params_from_numpy  # noqa: E402
from repro_torch.checkpoint.store import flatten  # noqa: E402
from repro_torch.config import get_config  # noqa: E402
from repro_torch.kernels.testing import Tol, assert_scaled_close  # noqa: E402
from repro_torch.models import model as tm  # noqa: E402
from repro_torch.serving import PagedCacheConfig, Request, ServingEngine  # noqa: E402
from repro_torch.serving.paged_cache import PagePool, paged_write_pages, slot_read  # noqa: E402

torch.set_num_threads(2)

RUNG = Tol(rtol=5e-5, atol=5e-5)
BF16_RUNG = Tol(rtol=5e-2, atol=5e-2)
STATE_TOL = Tol(rtol=1e-3, atol=1e-3)
ARCH = "jamba-v0.1-52b"
PIN = 8.0


def _close(got, ref, what="", tol=RUNG):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else got
    assert_scaled_close(np.asarray(got, np.float32),
                        np.asarray(jnp.asarray(ref, jnp.float32)), tol, err_msg=what)


@pytest.fixture(scope="module")
def models():
    jcfg = jax_get_config(ARCH, reduced=True).replace(dtype="float32", capacity_factor=PIN)
    tcfg = get_config(ARCH, reduced=True).replace(dtype="float32", capacity_factor=PIN)
    jp = jm.init_model(jax.random.PRNGKey(0), jcfg)
    return jcfg, jp, tcfg, params_from_numpy(jax.device_get(jp), tcfg, device="cpu")


def test_forward_logits_and_loss(models):
    """Weights across by the bridge, key for key; logits, the MoE aux loss
    and the total loss of the forward."""
    jcfg, jp, tcfg, tp = models
    rng = np.random.default_rng(1)
    toks = rng.integers(0, jcfg.vocab, size=(2, 11)).astype(np.int32)
    labels = rng.integers(0, jcfg.vocab, size=(2, 11)).astype(np.int32)
    assert tm.param_count(tp) == jm.param_count(jp)
    assert expected_shapes(tcfg) == {k: tuple(v.shape) for k, v in flatten(tp).items()}
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
    for key in ("attn_cache", "mamba"):
        assert set(ts[key]) == set(js[key])
        for name in ts[key]:
            assert tuple(ts[key][name].shape) == js[key][name].shape
            assert ts[key][name].dtype == torch.bfloat16
            _close(ts[key][name], js[key][name], f"prefill {key}/{name}", tol=BF16_RUNG)
    jd, js = jm.decode_step(jp, jnp.asarray(nxt), js, jnp.int32(9), jcfg)
    with torch.no_grad():
        td, ts = tm.decode_step(tp, torch.tensor(nxt), ts, 9, tcfg)
    _close(td, jd, "decode logits", tol=STATE_TOL)
    for key in ("attn_cache", "mamba"):
        for name in ts[key]:
            _close(ts[key][name], js[key][name], f"decode {key}/{name}", tol=BF16_RUNG)


def test_paged_decode_step_matches_static(models):
    """The reference's construction (``tests/test_serving.py:186-222``):
    the static prefill's K/V scattered into pages, its mamba state kept
    slot for slot; one paged step equals the static step."""
    _, _, tcfg, tp = models
    b, plen = 2, 6
    pcfg = PagedCacheConfig(page_size=4, num_pages=8, max_slots=b, max_pages_per_seq=3)
    prompt = torch.tensor(np.random.default_rng(5).integers(0, tcfg.vocab, size=(b, plen)))
    with torch.no_grad():
        state = tm.init_decode_state(tcfg, b, pcfg.max_seq, device="cpu")
        logits, state = tm.prefill(tp, prompt, tcfg, state)
        tok = torch.argmax(logits[:, -1], -1)[:, None]
        pstate = tm.init_paged_state(tcfg, pcfg, device="cpu")
        pool = PagePool(pcfg.num_pages)
        bt = np.full((b, pcfg.max_pages_per_seq), pcfg.null_page, dtype=np.int32)
        for slot in range(b):
            pages = pool.alloc(pcfg.pages_for(plen + 1))
            bt[slot, :len(pages)] = pages
            ids = torch.tensor(pages)
            for name, leaf in state["attn_cache"].items():
                paged_write_pages(pstate["attn_cache"][name], ids, leaf[:, slot, :plen],
                                  n_stack=1)
        for name, leaf in state["mamba"].items():
            pstate["mamba"][name].copy_(leaf)
        ref, _ = tm.decode_step(tp, tok, state, plen, tcfg)
        got, _ = tm.decode_step_paged(tp, tok, pstate, torch.tensor(bt),
                                      torch.full((b,), plen, dtype=torch.int32), tcfg)
    _close(got, ref.numpy(), "paged vs static decode logits")


def _trace(vocab, cls):
    rng = np.random.default_rng(1)
    # three requests through two slots: request 2 takes the slot request 0
    # finished in
    spec = [(4, 3, 0), (6, 7, 0), (5, 4, 2)]
    return [cls(rid=i, prompt=rng.integers(0, vocab, size=(n,)).astype(np.int32),
                max_new_tokens=g, arrival=a) for i, (n, g, a) in enumerate(spec)]


def test_engine_tokens_identical_to_reference_engine(models):
    """Interleaved requests and a reused slot: the port's engine gives the
    JAX engine's tokens and the static path's (stepped at the engine's
    slot count, with fp32 attention over its cache and through the paged
    decode in the engine's page geometry); each prefill writes the prompt's K/V into its pages and
    overwrites every leaf of its slot's mamba state."""
    from repro_torch.launch.serve import static_greedy_reference, static_page_size, static_rows

    jcfg, jp, tcfg, tp = models
    geom = dict(page_size=4, num_pages=12, max_slots=2, max_pages_per_seq=4)
    ref = JaxServingEngine(jcfg, jp, JaxPagedCacheConfig(**geom),
                           prefix_cache=True, chunked_prefill=True).run(
        _trace(jcfg.vocab, JaxRequest))
    pcfg = PagedCacheConfig(**geom)
    engine = ServingEngine(tcfg, tp, pcfg, device="cpu", prefix_cache=True,
                           chunked_prefill=True)
    assert not engine.prefix_cache and not engine.chunked_prefill   # the opt-out
    trace = _trace(tcfg.vocab, Request)
    slots = {}
    prefill_full = engine._prefill_full

    def watched(seq):
        prefill_full(seq)
        slots[seq.request.rid] = seq.slot
        solo = tm.init_decode_state(tcfg, 1, 16, device="cpu")
        _, solo = tm.prefill(engine.params, torch.tensor(seq.request.prompt)[None].long(),
                             tcfg, solo)
        got = slot_read(engine.state["mamba"], 2, seq.slot)
        for name in got:
            assert torch.equal(got[name], solo["mamba"][name]), (seq.request.rid, name)
        n = seq.request.prompt_len
        for name, pool in engine.state["attn_cache"].items():
            rows = pool[:, seq.pages].flatten(1, 2)[:, :n]
            assert torch.equal(rows, solo["attn_cache"][name][:, 0, :n]), name

    engine._prefill_full = watched
    got = engine.run(trace)
    assert slots[2] == slots[0]
    engine.sched.check_invariants()
    assert (static_rows(engine), static_page_size(engine)) == (2, 4)
    for r in trace:
        np.testing.assert_array_equal(got[r.rid], ref[r.rid], err_msg=f"request {r.rid}")
        for page_size in (None, 4):     # fp32 attention over the cache; the paged decode
            np.testing.assert_array_equal(
                got[r.rid], static_greedy_reference(tcfg, engine.params, r.prompt,
                                                    r.max_new_tokens, pcfg.max_seq,
                                                    device="cpu", rows=2, page_size=page_size),
                err_msg=f"request {r.rid} vs static, page size {page_size}")
    st = engine.stats()
    assert st["recurrent_state_bytes"] > 0 and st["attn_cache_bytes"] > 0


def test_serving_keeps_A_log_fp32(models):
    """serving_params casts once to the compute dtype but keeps A_log in
    fp32: the reference takes -exp(A_log) in fp32 at every call, and a
    bf16 A_log gives another A."""
    from repro_torch.nn.mamba import _mamba_ssm_params

    _, _, tcfg, tp = models
    cfg = tcfg.replace(dtype="bfloat16")
    sp = tm.serving_params(tp, cfg, torch.device("cpu"))
    mamba = sp["periods"]["p0"]["mamba"]
    assert mamba["A_log"].dtype == torch.float32
    assert mamba["in_proj"]["w"].dtype == torch.bfloat16
    assert mamba["D"].dtype == torch.bfloat16
    assert sp["periods"]["p1"]["moe"]["gate"]["U"].dtype == torch.bfloat16
    assert sp["periods"]["p1"]["moe"]["gate"]["s"].dtype == torch.float32
    xi = torch.zeros((1, 1, 2 * cfg.d_model), dtype=torch.bfloat16)
    lp = {k: v[0] for k, v in mamba.items() if not isinstance(v, dict)}
    lp.update({k: {n: t[0] for n, t in v.items()} for k, v in mamba.items()
               if isinstance(v, dict)})
    A = _mamba_ssm_params(lp, xi, cfg)[3]
    assert torch.equal(A, -torch.exp(tp["periods"]["p0"]["mamba"]["A_log"][0].float())
                       .to(torch.bfloat16))
    # a bf16 A_log would not: log(3), log(5), ... round, and so does A
    assert not torch.equal(A, -torch.exp(tp["periods"]["p0"]["mamba"]["A_log"][0]
                                         .to(torch.bfloat16).float()).to(torch.bfloat16))


def test_cli_serves_jamba_on_cpu(capsys):
    from repro_torch.launch.serve import main

    main(["--arch", ARCH, "--reduced", "--paged", "--stream", "--device", "cpu",
          "--requests", "4", "--gen", "6", "--prompt-len", "10"])
    out = capsys.readouterr().out
    assert "served 4 requests" in out
    assert "recurrent state:" in out


def test_cli_verify_refuses_where_capacity_binds():
    """At the config's capacity factor a decode step over 4 slots gives
    each expert fewer slots than rows: --verify stops before serving and
    names the capacity and the reference's pin."""
    from repro_torch.launch.serve import decode_capacity_binds, main

    assert decode_capacity_binds(get_config(ARCH, reduced=True), 4) == 2
    assert decode_capacity_binds(get_config(ARCH), 4) == 1
    assert decode_capacity_binds(get_config(ARCH).replace(capacity_factor=PIN), 4) is None
    assert decode_capacity_binds(get_config("llama3.2-1b"), 4) is None
    with pytest.raises(SystemExit, match=r"capacity of 2 tokens.*capacity_factor=8\.0"):
        main(["--arch", ARCH, "--reduced", "--paged", "--stream", "--verify",
              "--device", "cpu"])


def test_unported_paths_raise(models):
    from repro_torch.api import ModelSpec, RunSpec, Trainer, TrainSpec
    from repro_torch.launch.steps import make_train_step
    from repro_torch.serving.streaming import StreamingConfig

    _, _, tcfg, tp = models
    # training the hybrid family is ported: the train step and the Trainer accept it
    assert callable(make_train_step(tcfg))
    Trainer(RunSpec(model=ModelSpec(ARCH, reduced=True), train=TrainSpec(steps=1)),
            device="cpu")
    pcfg = PagedCacheConfig(page_size=4, num_pages=12, max_slots=2, max_pages_per_seq=4)
    with pytest.raises(NotImplementedError):
        ServingEngine(tcfg, tp, pcfg, device="cpu", quantize="int8")
    with pytest.raises(NotImplementedError):
        ServingEngine(tcfg, tp, pcfg, device="cpu",
                      streaming=StreamingConfig(sink_pages=1, window_pages=1))
    with pytest.raises(NotImplementedError, match="offset"):
        tm.prefill_chunk_paged(tp, torch.zeros((1, 2), dtype=torch.long),
                               tm.init_paged_state(tcfg, pcfg, device="cpu"),
                               torch.zeros((1, 4), dtype=torch.int32), 0, tcfg)
