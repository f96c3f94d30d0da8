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
    _, _, tcfg, tp = models
    with pytest.raises(NotImplementedError):
        ServingEngine(tcfg, tp, PagedCacheConfig(**GEOM), device="cpu", **kw)


def test_cli_serves_and_verifies_on_cpu(capsys):
    from repro_torch.launch.serve import main

    main(["--arch", "llama3.2-1b", "--reduced", "--paged", "--stream", "--verify",
          "--device", "cpu", "--requests", "4", "--gen", "6", "--prompt-len", "10"])
    assert "verify: all 4 requests match" in capsys.readouterr().out
