"""Port vs reference: int8 weights on the moe_lm family (deepseek-v3-671b,
reduced: 3 layers, the first dense, MLA attention, an MoE of 4 experts
top-2 with one shared expert).

``quantize_tree`` must give the reference's codes and scales bit for bit
and leave raw what the reference leaves raw: the embedding, the whole
``moe`` subtree (router, expert banks, shared expert) and MLA's ``wukv``
(``src/repro/serving/quantize.py:34-40``). The int8 engine runs the dense
MLP's spectral groups through the int8 matmul and dequantizes the MLA
projections per call; in fp32 compute its greedy tokens must be the JAX
int8 engine's and the static path's over the dequantized weights, token
for token, at capacity factor 8.0 (the reference tests' pin, where expert
capacity never binds). The reference's own int8 deepseek test at the
config's 1.25 fails in the JAX package (ROADMAP queue 3); it is not run
here.
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.config import get_config as jax_get_config  # noqa: E402
from repro.launch.serve import static_greedy_reference as jax_static  # noqa: E402
from repro.models.model import init_model as jax_init_model  # noqa: E402
from repro.serving import PagedCacheConfig as JaxPagedCacheConfig  # noqa: E402
from repro.serving import Request as JaxRequest  # noqa: E402
from repro.serving import quantize as jq  # noqa: E402
from repro.serving.engine import ServingEngine as JaxServingEngine  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.config import get_config  # noqa: E402
from repro_torch.launch.serve import replay_alone, static_greedy_reference  # noqa: E402
from repro_torch.models.model import serving_params  # noqa: E402
from repro_torch.serving import PagedCacheConfig, Request, ServingEngine  # noqa: E402
from repro_torch.serving import quantize as tq  # noqa: E402

from test_torch_quantize import _assert_trees_equal  # noqa: E402

torch.set_num_threads(2)

ARCH, PIN = "deepseek-v3-671b", 8.0
GEOM = dict(page_size=4, num_pages=32, max_slots=2, max_pages_per_seq=6)


@pytest.fixture(scope="module")
def models():
    jcfg = jax_get_config(ARCH, reduced=True).replace(dtype="float32", capacity_factor=PIN)
    tcfg = get_config(ARCH, reduced=True).replace(dtype="float32", capacity_factor=PIN)
    jp = jax_init_model(jax.random.PRNGKey(0), jcfg)
    return jcfg, jp, tcfg, params_from_numpy(jax.device_get(jp), tcfg, device="cpu")


def _trace(vocab, cls):
    """Three requests behind a shared two-page system prefix."""
    rng = np.random.default_rng(3)
    shared = rng.integers(0, vocab, size=(8,)).astype(np.int32)
    return [cls(rid=i, prompt=np.concatenate(
                [shared, rng.integers(0, vocab, size=(n,)).astype(np.int32)]),
                max_new_tokens=g, arrival=a)
            for i, (n, g, a) in enumerate([(7, 5, 0), (11, 4, 0), (5, 6, 2)])]


def test_int8_tree_codes_scales_and_raw_subtrees_equal_reference(models):
    _, jp, _, tp = models
    tqt, jqt = tq.quantize_tree(tp), jq.quantize_tree(jp)
    _assert_trees_equal(tqt, jqt)
    assert tq.param_bytes(tqt) == jq.param_bytes(jqt)
    # raw: the embedding, the whole moe subtree, wukv (every stack)
    assert tqt["embed"]["w"] is tp["embed"]["w"]
    assert tqt["moe_layers"]["moe"] is not None
    for path in (("moe_layers", "moe"), ("dense_layers", "attn", "wukv"),
                 ("moe_layers", "attn", "wukv")):
        got, raw = tqt, tp
        for key in path:
            got, raw = got[key], raw[key]
        for a, b in zip(jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(raw)):
            assert a is b, path
    # quantized: the dense MLP's spectral groups and MLA's other projections
    assert tq.is_quantized_spectral(tqt["dense_layers"]["mlp"]["up"])
    for name in ("wdq", "wuq", "wdkv", "wo"):
        assert tq.is_quantized(tqt["moe_layers"]["attn"][name]["w"]), name
    # served: codes int8, scales fp32, the raw subtrees cast as any leaf
    sp = serving_params(tp, get_config(ARCH, reduced=True), torch.device("cpu"),
                        quantize="int8")
    assert sp["dense_layers"]["mlp"]["up"]["U"]["q8"].dtype == torch.int8
    assert sp["moe_layers"]["moe"]["shared"]["up"]["U"].dtype == torch.bfloat16
    assert sp["moe_layers"]["attn"]["wukv"]["w"].dtype == torch.float32


def test_int8_engine_matches_reference_engine_and_oracle(models):
    """fp32 compute at capacity 8.0 with the prefix cache and chunked
    prefill: the port's int8 engine gives the JAX int8 engine's tokens,
    the static path's over the dequantized weights, and each request's
    replay alone (the launch counts are ``chip_smoke.py``'s: a wrapper
    counts only where it launches its kernel)."""
    jcfg, jp, tcfg, tp = models
    kw = dict(prefill_token_budget=6, prefix_cache=True, chunked_prefill=True,
              quantize="int8")
    jeng = JaxServingEngine(jcfg, jp, JaxPagedCacheConfig(**GEOM), **kw)
    ref = jeng.run(_trace(jcfg.vocab, JaxRequest))
    pcfg = PagedCacheConfig(**GEOM)
    engine = ServingEngine(tcfg, tp, pcfg, device="cpu", **kw)
    trace = _trace(tcfg.vocab, Request)
    got = engine.run(trace)
    engine.sched.check_invariants()
    st = engine.stats()
    assert st["prefix_shared_tokens"] > 0 and st["prefill_chunks"] > len(got)
    oracle = jq.dequantize_tree(jeng.params)
    for r in trace:
        np.testing.assert_array_equal(got[r.rid], ref[r.rid], err_msg=f"request {r.rid}")
        np.testing.assert_array_equal(
            got[r.rid], jax_static(jcfg, oracle, r.prompt, r.max_new_tokens, pcfg.max_seq),
            err_msg=f"request {r.rid} vs the dequantized oracle")
        np.testing.assert_array_equal(
            got[r.rid], static_greedy_reference(tcfg, tq.dequantize_tree(engine.params),
                                                r.prompt, r.max_new_tokens, pcfg.max_seq,
                                                device="cpu"),
            err_msg=f"request {r.rid} vs the port's dequantized static path")
        np.testing.assert_array_equal(got[r.rid], replay_alone(engine, r),
                                      err_msg=f"request {r.rid} vs alone")
    assert st["weight_bytes"] == jeng.stats()["weight_bytes"]
    assert st["weight_bytes"] < st["weight_bytes_fp"]
    _assert_trees_equal(engine.params, jeng.params)


def test_cli_serves_int8_deepseek_on_cpu(capsys):
    from repro_torch.launch.serve import main

    main(["--arch", ARCH, "--reduced", "--paged", "--stream", "--device", "cpu",
          "--quantize", "int8", "--requests", "3", "--gen", "4", "--prompt-len", "8"])
    out = capsys.readouterr().out
    assert "served 3 requests" in out and "weights:" in out and "int8" in out
