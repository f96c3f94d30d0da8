"""Port vs reference: int8 serving.

The codecs (``serving/quantize.py``) must give the reference's int8
codes and scales bit for bit on the same fp32 input; the plain version
of the int8 spectral matmul is held against the reference's
``kernels/ops.py:spectral_matmul_q8`` (its Pallas kernel in interpret
mode) over the reference's scale profiles; the int8 engine must give the
reference engine's greedy tokens and the reference CLI's oracle (the
static path over ``dequantize_tree``) on the same weights.

Tolerances (ladder, outputs scaled by the reference's RMS): fp32 5e-5 —
the same fp32 sums in another order; bf16 5e-2 — both round h and y to
bf16 once, at the same places. Engines run fp32 compute, so token
equality is about the algorithm. Inputs are made with numpy and fed to
both packages.
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.config import get_config as jax_get_config  # noqa: E402
from repro.kernels.testing import SCALE_PROFILES, forced_interpret, scale_profile  # noqa: E402
from repro.models.model import init_model as jax_init_model  # noqa: E402
from repro.serving import quantize as jq  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.config import get_config  # noqa: E402
from repro_torch.kernels.build import LAUNCHES  # noqa: E402
from repro_torch.kernels.ops import spectral_matmul_q8  # noqa: E402
from repro_torch.kernels.testing import TOLERANCE_LADDER, assert_scaled_close  # noqa: E402
from repro_torch.models.model import serving_params  # noqa: E402
from repro_torch.nn.linear import apply_linear  # noqa: E402
from repro_torch.serving import quantize as tq  # noqa: E402

torch.set_num_threads(2)

DTYPES = {"float32": (torch.float32, jnp.float32), "bfloat16": (torch.bfloat16, jnp.bfloat16)}


def _np(tree):
    """A torch or jax tree as a flat {path: (dtype name, numpy values)},
    bf16 values widened to fp32 (numpy has no bf16)."""
    out = {}

    def walk(t, prefix):
        if isinstance(t, dict):
            for k, v in t.items():
                walk(v, f"{prefix}/{k}" if prefix else k)
        elif isinstance(t, torch.Tensor):
            t = t.detach().cpu()
            name = str(t.dtype).replace("torch.", "")
            out[prefix] = (name, (t.float() if t.dtype == torch.bfloat16 else t).numpy())
        else:
            name = str(t.dtype)
            out[prefix] = (name, np.asarray(t, np.float32) if name == "bfloat16"
                           else np.asarray(t))

    walk(tree, "")
    return out


def _assert_trees_equal(a, b):
    fa, fb = _np(a), _np(b)
    assert sorted(fa) == sorted(fb)
    for key in fa:
        assert fa[key][0] == fb[key][0], (key, fa[key][0], fb[key][0])
        np.testing.assert_array_equal(fa[key][1], fb[key][1], err_msg=key)


# ----------------------------------------------------------------- codecs --

@pytest.mark.parametrize("shape", [(256, 32), (4, 64, 8), (2, 48, 16)],
                         ids=["2d", "stacked", "stacked-rank16"])
def test_quantize_int8_codes_and_scales_equal_reference(shape):
    rng = np.random.default_rng(0)
    w = (rng.standard_normal(shape) * rng.uniform(0.01, 10.0, size=shape[-1])).astype(np.float32)
    w[..., 0, :] *= 0.0                       # an all-but-one-row channel edge
    w[..., 3] = 0.0                           # an all-zero channel: the 1e-12 floor
    got = tq.quantize_int8(torch.tensor(w))
    ref = jq.quantize_int8(jnp.asarray(w))
    assert got["q8"].dtype == torch.int8 and got["scale"].dtype == torch.float32
    np.testing.assert_array_equal(got["q8"].numpy(), np.asarray(ref["q8"]))
    np.testing.assert_array_equal(got["scale"].numpy(), np.asarray(ref["scale"]))
    for dt, jdt in DTYPES.values():
        np.testing.assert_array_equal(
            tq.dequantize_int8(got, dt).float().numpy(),
            np.asarray(jq.dequantize_int8(ref, jdt), np.float32))


def test_quantize_kv_pages_equal_reference():
    """The cold-tier codec on one page of every layer, (L, page, kvh,
    hd) from a bf16 pool: per-(layer, head, feature) scales."""
    rng = np.random.default_rng(1)
    vals = torch.tensor(rng.standard_normal((2, 4, 3, 8)).astype(np.float32)).bfloat16()
    got = tq.quantize_kv_pages(vals, token_axis=1)
    ref = jq.quantize_kv_pages(jnp.asarray(vals.float().numpy(), jnp.bfloat16), token_axis=1)
    assert tuple(got["scale"].shape) == (2, 3, 8)
    np.testing.assert_array_equal(got["q8"].numpy(), np.asarray(ref["q8"]))
    np.testing.assert_array_equal(got["scale"].numpy(), np.asarray(ref["scale"]))
    np.testing.assert_array_equal(tq.dequantize_kv_pages(got, token_axis=1).numpy(),
                                  np.asarray(jq.dequantize_kv_pages(ref, token_axis=1)))


@pytest.fixture(scope="module")
def llama():
    jcfg = jax_get_config("llama3.2-1b", reduced=True).replace(dtype="float32")
    tcfg = get_config("llama3.2-1b", reduced=True).replace(dtype="float32")
    jp = jax_init_model(jax.random.PRNGKey(0), jcfg)
    return jcfg, jp, tcfg, params_from_numpy(jax.device_get(jp), tcfg, device="cpu")


def test_quantize_tree_and_param_bytes_equal_reference(llama):
    """Same tree, same codes, same skipped subtrees, same byte count;
    dequantize_tree gives the reference's floats."""
    _, jp, _, tp = llama
    tqt, jqt = tq.quantize_tree(tp), jq.quantize_tree(jp)
    _assert_trees_equal(tqt, jqt)
    assert tq.is_quantized_spectral(tqt["layers"]["mlp"]["up"])
    assert tq.is_quantized(tqt["layers"]["attn"]["wq"]["w"])
    assert tqt["embed"]["w"] is tp["embed"]["w"]                  # SKIP_KEYS
    assert not tq.is_quantized(tqt["layers"]["attn_norm"])
    assert tq.param_bytes(tqt) == jq.param_bytes(jqt)
    assert tq.param_bytes(tp) == jq.param_bytes(jp)
    _assert_trees_equal(tq.dequantize_tree(tqt), jq.dequantize_tree(jqt))
    assert tq.SKIP_KEYS == jq.SKIP_KEYS


def test_quantize_tree_skip_keys_and_include_dense_match_reference():
    """Every SKIP_KEYS subtree passes through, dense w only with
    include_dense, 1-D w never — on a synthetic tree holding them all."""
    rng = np.random.default_rng(2)

    def arr(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    tree = {name: {"w": arr(6, 5)} for name in jq.SKIP_KEYS}
    tree.update(proj={"w": arr(6, 5), "b": arr(5)}, vec={"w": arr(5)},
                lin={"U": arr(6, 4), "s": arr(4), "V": arr(5, 4)})
    ttree = {k: {kk: torch.tensor(v) for kk, v in d.items()} for k, d in tree.items()}
    jtree = {k: {kk: jnp.asarray(v) for kk, v in d.items()} for k, d in tree.items()}
    for include_dense in (True, False):
        _assert_trees_equal(tq.quantize_tree(ttree, include_dense),
                            jq.quantize_tree(jtree, include_dense))


# --------------------------------------------------------- the q8 matmul --

def _q8_case(M, m, n, k, profile, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((M, m)).astype(np.float32)
    uq = rng.integers(-127, 128, size=(m, k)).astype(np.int8)
    vq = rng.integers(-127, 128, size=(n, k)).astype(np.int8)
    s = rng.uniform(0.1, 1.0, size=(k,)).astype(np.float32)
    us = np.asarray(scale_profile(profile, k)) / np.sqrt(m)
    vs = np.asarray(scale_profile(profile, k))[::-1].copy() / np.sqrt(k)
    return x, uq, us.astype(np.float32), s, vq, vs.astype(np.float32)


def test_scale_profiles_equal_reference():
    """The port's scale_profile (used by the card's checks) gives the
    reference's vectors, to the few fp32 ulps by which the reference's
    fp32 ``10 ** linspace`` misses the correctly rounded value."""
    from repro_torch.kernels import testing as tt

    assert tt.SCALE_PROFILES == SCALE_PROFILES
    for kind in SCALE_PROFILES:
        np.testing.assert_allclose(tt.scale_profile(kind, 16).numpy(),
                                   np.asarray(scale_profile(kind, 16)), rtol=1e-5)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("profile", SCALE_PROFILES)
def test_plain_q8_matches_reference_kernel(profile, dtype):
    """Port (plain version on CPU tensors) against the reference's
    Pallas q8 kernel in interpret mode, over the reference's scale
    profiles on u_scale and v_scale (eight decades in 'extreme')."""
    tdt, jdt = DTYPES[dtype]
    x, uq, us, s, vq, vs = _q8_case(37, 96, 80, 16, profile)
    before = LAUNCHES["spectral_matmul_q8"]
    y = spectral_matmul_q8(torch.tensor(x).to(tdt)[None],
                           {"q8": torch.tensor(uq), "scale": torch.tensor(us)},
                           torch.tensor(s), {"q8": torch.tensor(vq), "scale": torch.tensor(vs)})
    assert LAUNCHES["spectral_matmul_q8"] == before       # CPU tensors: plain version
    assert y.shape == (1, 37, 80) and y.dtype == tdt
    from repro.kernels.ops import spectral_matmul_q8 as jax_q8

    with forced_interpret():
        yr = jax_q8(jnp.asarray(x, jdt), {"q8": jnp.asarray(uq), "scale": jnp.asarray(us)},
                    jnp.asarray(s), {"q8": jnp.asarray(vq), "scale": jnp.asarray(vs)})
    assert_scaled_close(y[0].float().numpy(), np.asarray(yr, np.float32),
                        TOLERANCE_LADDER[tdt])


def test_q8_has_no_gradient():
    """Differentiating through int8 factors raises instead of returning
    a cotangent, as the reference's custom VJP does."""
    x, uq, us, s, vq, vs = _q8_case(3, 32, 24, 16, "unit")
    xt = torch.tensor(x, requires_grad=True)
    y = spectral_matmul_q8(xt, {"q8": torch.tensor(uq), "scale": torch.tensor(us)},
                           torch.tensor(s), {"q8": torch.tensor(vq), "scale": torch.tensor(vs)})
    with pytest.raises(TypeError, match="no gradient"):
        y.sum().backward()
    assert xt.grad is None


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_apply_linear_q8_branches_match_reference(dtype):
    """A quantized spectral group and a quantized dense w through
    apply_linear on both sides (the reference's Pallas q8 wrapper in
    interpret mode for the spectral group)."""
    from repro.nn.linear import apply_linear as jax_apply_linear

    tdt, jdt = DTYPES[dtype]
    rng = np.random.default_rng(3)
    U = np.linalg.qr(rng.standard_normal((48, 16)))[0].astype(np.float32)
    V = np.linalg.qr(rng.standard_normal((40, 16)))[0].astype(np.float32)
    group = {"U": U, "s": rng.uniform(0.5, 2.0, size=(16,)).astype(np.float32), "V": V,
             "b": rng.standard_normal((40,)).astype(np.float32)}
    dense = {"w": (rng.standard_normal((48, 24)) / 7.0).astype(np.float32)}
    x = rng.standard_normal((2, 5, 48)).astype(np.float32)
    for p in (group, dense):
        tp = tq.quantize_tree({"lin": {k: torch.tensor(v) for k, v in p.items()}})["lin"]
        jp = jq.quantize_tree({"lin": {k: jnp.asarray(v) for k, v in p.items()}})["lin"]
        y = apply_linear(tp, torch.tensor(x).to(tdt))
        with forced_interpret():
            yr = jax_apply_linear(jp, jnp.asarray(x, jdt), use_pallas=True)
        assert y.dtype == tdt
        assert_scaled_close(y.float().numpy(), np.asarray(yr, np.float32),
                            TOLERANCE_LADDER[tdt])


def test_serving_params_keeps_codes_int8_and_scales_fp32(llama):
    """Quantized from the fp32 masters, then cast: q8 stays int8, the
    scales and s stay fp32, every other float leaf goes to bf16; an
    already-quantized tree passes through with the same codes."""
    _, _, tcfg, tp = llama
    cfg = tcfg.replace(dtype="bfloat16")
    sp = serving_params(tp, cfg, torch.device("cpu"), quantize="int8")
    again = serving_params(tq.quantize_tree(tp), cfg, torch.device("cpu"))
    for tree in (sp, again):
        up = tree["layers"]["mlp"]["up"]
        wq = tree["layers"]["attn"]["wq"]["w"]
        assert up["U"]["q8"].dtype == torch.int8 and wq["q8"].dtype == torch.int8
        assert up["U"]["scale"].dtype == torch.float32
        assert wq["scale"].dtype == torch.float32
        assert up["s"].dtype == torch.float32
        assert tree["embed"]["w"].dtype == torch.bfloat16
        assert tree["layers"]["attn_norm"]["scale"].dtype == torch.bfloat16
    _assert_trees_equal(sp, again)
    np.testing.assert_array_equal(sp["layers"]["mlp"]["up"]["V"]["scale"].numpy(),
                                  tq.quantize_int8(tp["layers"]["mlp"]["up"]["V"])["scale"]
                                  .numpy())
    with pytest.raises(ValueError, match="int4"):
        serving_params(tp, cfg, torch.device("cpu"), quantize="int4")


# ------------------------------------------------------------- the engine --

@pytest.mark.parametrize("arch", ["llama3.2-1b", "smollm2-135m"])
def test_int8_engine_matches_reference_engine_and_oracle(arch):
    """The acceptance path of ``--quantize int8``: the port's int8 engine
    gives the reference int8 engine's tokens and the reference CLI's
    oracle (the static path over the dequantized weights), at fp32
    compute; and its own static path over its int8 tree."""
    from repro.launch.serve import static_greedy_reference as jax_static
    from repro.serving import PagedCacheConfig as JaxPagedCacheConfig
    from repro.serving import Request as JaxRequest
    from repro.serving.engine import ServingEngine as JaxServingEngine
    from repro_torch.launch.serve import (
        replay_alone,
        static_greedy_reference,
        static_logit_gaps,
    )
    from repro_torch.serving import PagedCacheConfig, Request, ServingEngine

    jcfg = jax_get_config(arch, reduced=True).replace(dtype="float32")
    tcfg = get_config(arch, reduced=True).replace(dtype="float32")
    jp = jax_init_model(jax.random.PRNGKey(0), jcfg)
    tp = params_from_numpy(jax.device_get(jp), tcfg, device="cpu")
    geom = dict(page_size=8, num_pages=16, max_slots=2, max_pages_per_seq=4)
    rng = np.random.default_rng(0)
    spec = [(rng.integers(0, tcfg.vocab, size=(n,)).astype(np.int32), i // 2)
            for i, n in enumerate([6, 9, 4])]
    jeng = JaxServingEngine(jcfg, jp, JaxPagedCacheConfig(**geom), quantize="int8")
    ref = jeng.run([JaxRequest(rid=i, prompt=p, max_new_tokens=5, arrival=a)
                    for i, (p, a) in enumerate(spec)])
    pcfg = PagedCacheConfig(**geom)
    engine = ServingEngine(tcfg, tp, pcfg, device="cpu", quantize="int8")
    reqs = [Request(rid=i, prompt=p, max_new_tokens=5, arrival=a)
            for i, (p, a) in enumerate(spec)]
    got = engine.run(reqs)
    engine.sched.check_invariants()
    oracle = jq.dequantize_tree(jeng.params)
    for i, (p, _) in enumerate(spec):
        np.testing.assert_array_equal(got[i], ref[i], err_msg=f"request {i} vs engine")
        np.testing.assert_array_equal(got[i], jax_static(jcfg, oracle, p, 5, pcfg.max_seq),
                                      err_msg=f"request {i} vs dequantized oracle")
        np.testing.assert_array_equal(
            got[i], static_greedy_reference(tcfg, engine.params, p, 5, pcfg.max_seq,
                                            device="cpu"), err_msg=f"request {i} vs static")
        np.testing.assert_array_equal(got[i], replay_alone(engine, reqs[i]),
                                      err_msg=f"request {i} vs alone")
        assert static_logit_gaps(tcfg, engine.params, p, got[i], pcfg.max_seq,
                                 device="cpu").max() == 0.0
    st, jst = engine.stats(), jeng.stats()
    assert st["weight_bytes_fp"] == jst["weight_bytes_fp"]
    assert st["weight_bytes"] == jst["weight_bytes"]          # fp32 compute: fp32 leaves
    _assert_trees_equal(engine.params, jeng.params)


def test_cli_quantize_verify_on_cpu(capsys):
    from repro_torch.launch.serve import main

    main(["--arch", "llama3.2-1b", "--reduced", "--paged", "--stream", "--verify",
          "--device", "cpu", "--quantize", "int8", "--requests", "4", "--gen", "6",
          "--prompt-len", "10"])
    out = capsys.readouterr().out
    assert "weights:" in out and "bytes int8" in out
    assert "verify: all 4 requests match" in out
    assert "greedy tokens agree with the dequantized int8 weights" in out
