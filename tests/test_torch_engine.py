"""Port vs reference: the continuous-batching engine.

The same staggered trace runs through the reference's ``ServingEngine``
and the port's, from the same weights (through the bridge), at fp32
compute with bf16 KV pools in both. Greedy tokens must be identical per
request, and the port's engine must match its own batch-1
``static_greedy_reference``. fp32 compute keeps the comparison about
the algorithm: in bf16 the port's spectral h stays fp32 where the
reference's default path rounds it (see test_torch_model.py).
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.config import get_config as jax_get_config  # noqa: E402
from repro.models.model import init_model as jax_init_model  # noqa: E402
from repro.serving import PagedCacheConfig as JaxPagedCacheConfig  # noqa: E402
from repro.serving import Request as JaxRequest  # noqa: E402
from repro.serving.engine import ServingEngine as JaxServingEngine  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.config import get_config  # noqa: E402
from repro_torch.launch.serve import build_parser, build_trace, static_greedy_reference  # noqa: E402
from repro_torch.serving import PagedCacheConfig, Request, ServingEngine  # noqa: E402

torch.set_num_threads(2)

GEOM = dict(page_size=8, num_pages=24, max_slots=3, max_pages_per_seq=4)
# (prompt_len, max_new_tokens, arrival); the shared 9-token system
# prefix makes the prefix-cache variant map one full page
SPEC = [(5, 6, 0), (11, 4, 0), (7, 8, 1), (3, 5, 3), (13, 3, 4)]


def _trace(vocab, cls, shared_prefix):
    rng = np.random.default_rng(0)
    sysp = rng.integers(0, vocab, size=(9,)).astype(np.int32)
    reqs = []
    for i, (n, g, a) in enumerate(SPEC):
        tail = rng.integers(0, vocab, size=(n,)).astype(np.int32)
        prompt = np.concatenate([sysp, tail]) if shared_prefix else tail
        reqs.append(cls(rid=i, prompt=prompt, max_new_tokens=g, arrival=a))
    return reqs


@pytest.fixture(scope="module")
def models():
    jcfg = jax_get_config("llama3.2-1b", reduced=True).replace(dtype="float32")
    tcfg = get_config("llama3.2-1b", reduced=True).replace(dtype="float32")
    jp = jax_init_model(jax.random.PRNGKey(0), jcfg)
    return jcfg, jp, tcfg, params_from_numpy(jax.device_get(jp), tcfg, device="cpu")


@pytest.mark.parametrize("variant", ["fifo", "prefix_chunked"])
def test_engine_tokens_identical_to_reference_engine(models, variant):
    jcfg, jp, tcfg, tp = models
    kw = dict(prefill_token_budget=8)
    if variant == "prefix_chunked":
        kw.update(prefix_cache=True, chunked_prefill=True)
    shared = variant == "prefix_chunked"
    ref = JaxServingEngine(jcfg, jp, JaxPagedCacheConfig(**GEOM), **kw).run(
        _trace(jcfg.vocab, JaxRequest, shared))
    pcfg = PagedCacheConfig(**GEOM)
    engine = ServingEngine(tcfg, tp, pcfg, device="cpu", **kw)
    trace = _trace(tcfg.vocab, Request, shared)
    got = engine.run(trace)
    engine.sched.check_invariants()
    assert sorted(got) == sorted(ref)
    for r in trace:
        np.testing.assert_array_equal(got[r.rid], ref[r.rid], err_msg=f"request {r.rid}")
        solo = static_greedy_reference(tcfg, engine.params, r.prompt, r.max_new_tokens,
                                       pcfg.max_seq, device="cpu")
        np.testing.assert_array_equal(got[r.rid], solo, err_msg=f"request {r.rid} vs static")
    st = engine.stats()
    assert st["generated_tokens"] == sum(g for _, g, _ in SPEC)
    if shared:
        assert st["prefix_shared_tokens"] > 0
        assert st["prefill_tokens"] + st["prefix_shared_tokens"] == st["prompt_tokens"]
    else:
        assert engine.sched.pool.allocated_count == 0


def test_build_trace_matches_reference():
    """The launcher's trace is the reference's for the same flags."""
    from repro.launch.serve import build_trace as jax_build_trace

    args = build_parser().parse_args(["--shared-prefix", "3", "--requests", "6"])
    a = build_trace(args, 512, PagedCacheConfig())
    b = jax_build_trace(args, 512, JaxPagedCacheConfig())
    assert [(r.rid, r.arrival, r.max_new_tokens) for r in a] == \
        [(r.rid, r.arrival, r.max_new_tokens) for r in b]
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x.prompt, y.prompt)


@pytest.mark.parametrize("kw", [{"mesh": object()}, {"scheduler": "slo"}],
                         ids=["mesh", "slo"])
def test_unported_engine_options_raise(models, kw):
    """Tensor-parallel serving raises, naming its ROADMAP item; the SLO
    scheduler is ported (tests/test_torch_slo.py) and an unknown
    scheduler's name raises."""
    from repro_torch.serving.scheduler import SLOScheduler

    _, _, tcfg, tp = models
    if "mesh" in kw:
        with pytest.raises(NotImplementedError, match="item 8"):
            ServingEngine(tcfg, tp, PagedCacheConfig(**GEOM), device="cpu", **kw)
        return
    engine = ServingEngine(tcfg, tp, PagedCacheConfig(**GEOM), device="cpu", **kw)
    assert isinstance(engine.sched, SLOScheduler)
    with pytest.raises(ValueError, match="fifo, slo"):
        ServingEngine(tcfg, tp, PagedCacheConfig(**GEOM), device="cpu", scheduler="edf")


def test_cli_serves_and_verifies_on_cpu(capsys):
    from repro_torch.launch.serve import main

    main(["--arch", "llama3.2-1b", "--reduced", "--paged", "--stream", "--verify",
          "--device", "cpu", "--requests", "4", "--gen", "6", "--prompt-len", "10"])
    assert "verify: all 4 requests match" in capsys.readouterr().out


def _llama_engine(dtype, trace_spec):
    from repro_torch.models.model import init_model

    cfg = get_config("llama3.2-1b", reduced=True).replace(dtype=dtype)
    pcfg = PagedCacheConfig(**GEOM)
    engine = ServingEngine(cfg, init_model(cfg, seed=0, device="cpu"), pcfg, device="cpu",
                           prefill_token_budget=8)
    rng = np.random.default_rng(3)
    trace = [Request(rid=i, prompt=rng.integers(0, cfg.vocab, size=(n,)).astype(np.int32),
                     max_new_tokens=g, arrival=a) for i, (n, g, a) in enumerate(trace_spec)]
    return engine, trace, engine.run(trace)


def test_verify_is_exact_in_fp32(capsys):
    """In fp32 --verify compares token for token with the static path: a
    correct engine passes, one wrong token fails."""
    from repro_torch.launch.serve import verify

    engine, trace, out = _llama_engine("float32", [(5, 6, 0), (9, 5, 1)])
    verify(engine, trace, out, None)
    assert "verify: all 2 requests match the static path token-for-token" in \
        capsys.readouterr().out
    bad = dict(out)
    bad[1] = out[1].copy()
    bad[1][2] = (bad[1][2] + 1) % engine.cfg.vocab
    with pytest.raises(SystemExit, match="1/2 requests diverged"):
        verify(engine, trace, bad, None)


def test_bf16_gate_accepts_a_near_tie_and_refuses_a_wrong_token():
    """The bf16 gate (``check_oracles``): a token that is the static
    path's runner-up within the ladder's allowance (a near-tie that a
    rounding step can flip) passes the static half; the static path's
    worst token at the same place is refused, and so is any token that
    differs from the request served alone."""
    from repro_torch.launch.serve import check_oracles, verify
    from repro_torch.kernels.testing import tolerance_for
    from repro_torch.models.model import decode_step, init_decode_state, prefill

    engine, trace, out = _llama_engine("bfloat16", [(6, 16, 0)])
    cfg, r = engine.cfg, trace[0]
    tol = tolerance_for(torch.bfloat16)
    with torch.no_grad():
        state = init_decode_state(cfg, 1, engine.pcfg.max_seq, device="cpu")
        logits, state = prefill(engine.params, torch.tensor(r.prompt)[None].long(), cfg, state)
        for j, tok in enumerate(out[r.rid]):
            lg = logits[0, -1].float()
            top2 = torch.topk(lg, 2)
            allowance = tol.atol * lg.pow(2).mean().sqrt() + tol.rtol * top2.values[0].abs()
            if top2.values[0] - top2.values[1] <= allowance:
                break
            logits, state = decode_step(engine.params, torch.tensor([[int(tok)]]), state,
                                        r.prompt_len + j, cfg)
        else:
            pytest.fail("no near-tie within the ladder in the request's tokens")
    near = np.append(out[r.rid][:j], int(top2.indices[1])).astype(np.int32)
    rep = check_oracles(engine, [], {r.rid: near}, [r])
    assert 0.0 < rep["max_gap"] <= 1.0
    wrong = np.append(out[r.rid][:j], int(torch.argmin(lg))).astype(np.int32)
    with pytest.raises(AssertionError, match="ladder's allowance"):
        check_oracles(engine, [], {r.rid: wrong}, [r])
    with pytest.raises(SystemExit, match="served alone"):
        verify(engine, trace, {r.rid: np.append(wrong, out[r.rid][j + 1:])}, None)
    check_oracles(engine, trace, out, trace)           # the engine's own tokens pass
