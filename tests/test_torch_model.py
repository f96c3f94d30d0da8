"""Port vs reference: the dense decoder end to end at reduced size.

The reference's ``init_model`` parameters cross over through the weight
bridge (``repro_torch.bridge.params_from_numpy``), then the same token
ids run through both packages: the training forward, the static-cache
prefill + decode step, and the paged chunk prefill + batched paged
decode step.

Tolerances, on outputs scaled by max(1, max|ref|):
  * fp32 compute: 1e-4 — both sides accumulate in fp32 and differ by
    summation order across a few layers (the kernel ladder's 5e-5 rung
    per op, compounded);
  * bf16 compute: 5e-2 (the ladder's bf16 rung). In bf16 the port
    computes what the reference's ``use_pallas=True`` path computes —
    the spectral h stays fp32 and is rounded once — while the
    reference's default ``spectral_apply`` rounds h to bf16 first, so
    the bf16 check runs against the reference's Pallas path, and the
    token-identity checks (test_torch_engine.py) run at fp32 compute.
KV pools are bf16 in both packages whatever the compute dtype; pools
are compared at one bf16 ulp (2**-7 relative). Outputs of the paths
that attend over the bf16 pools (paged prefill and decode) get 1e-3:
two fp32 values that differ only by summation order can straddle a
bf16 rounding boundary, and one pool element a bf16 ulp apart moves the
logits by ~1e-4.
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.config import get_config as jax_get_config  # noqa: E402
from repro.models import model as jm  # noqa: E402
from repro.serving import PagedCacheConfig as JaxPagedCacheConfig  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.config import get_config  # noqa: E402
from repro_torch.models import model as tm  # noqa: E402
from repro_torch.serving.paged_cache import PagedCacheConfig  # noqa: E402

torch.set_num_threads(2)

ARCHES = ["llama3.2-1b", "smollm2-135m"]
FP32_TOL = 1e-4
BF16_TOL = 5e-2
POOL_TOL = 1e-3


def _cfgs(arch, dtype="float32"):
    return (jax_get_config(arch, reduced=True).replace(dtype=dtype),
            get_config(arch, reduced=True).replace(dtype=dtype))


def _params(jcfg, tcfg, seed=0):
    jp = jm.init_model(jax.random.PRNGKey(seed), jcfg)
    return jp, params_from_numpy(jax.device_get(jp), tcfg, device="cpu")


def _close(y, yr, tol):
    y, yr = np.asarray(y, np.float32), np.asarray(yr, np.float32)
    assert y.shape == yr.shape
    scale = max(1.0, float(np.max(np.abs(yr))))
    np.testing.assert_allclose(y / scale, yr / scale, rtol=tol, atol=tol)


def _tokens(vocab, shape, seed=1):
    return np.random.default_rng(seed).integers(0, vocab, size=shape).astype(np.int32)


@pytest.mark.parametrize("arch", ARCHES)
def test_forward_logits_fp32(arch):
    jcfg, tcfg = _cfgs(arch)
    jp, tp = _params(jcfg, tcfg)
    toks = _tokens(jcfg.vocab, (2, 11))
    ref, _ = jm.forward(jp, jnp.asarray(toks), jcfg)
    got, aux = tm.forward(tp, torch.tensor(toks), tcfg)
    assert tm.param_count(tp) == jm.param_count(jp)
    _close(got.numpy(), ref, FP32_TOL)
    assert float(aux) == 0.0


def test_forward_logits_bf16_vs_reference_pallas_path():
    jcfg, tcfg = _cfgs("llama3.2-1b", "bfloat16")
    jp, tp = _params(jcfg, tcfg)
    toks = _tokens(jcfg.vocab, (1, 9))
    ref, _ = jm.forward(jp, jnp.asarray(toks), jcfg.replace(use_pallas=True))
    got, _ = tm.forward(tm.serving_params(tp, tcfg, torch.device("cpu")),
                        torch.tensor(toks), tcfg)
    assert got.dtype == torch.bfloat16
    _close(got.float().numpy(), ref, BF16_TOL)


@pytest.mark.parametrize("arch", ARCHES)
def test_static_prefill_and_decode_step(arch):
    jcfg, tcfg = _cfgs(arch)
    jp, tp = _params(jcfg, tcfg)
    b, plen, S = 2, 7, 16
    toks = _tokens(jcfg.vocab, (b, plen))
    nxt = _tokens(jcfg.vocab, (b, 1), seed=2)

    jstate = jm.init_decode_state(jcfg, b, S)
    jl, jstate = jm.prefill(jp, jnp.asarray(toks), jcfg, jstate)
    jd, jstate = jm.decode_step(jp, jnp.asarray(nxt), jstate, jnp.int32(plen), jcfg)
    tstate = tm.init_decode_state(tcfg, b, S, device="cpu")
    tl, tstate = tm.prefill(tp, torch.tensor(toks), tcfg, tstate)
    td, tstate = tm.decode_step(tp, torch.tensor(nxt), tstate, plen, tcfg)
    _close(tl.numpy(), jl, FP32_TOL)
    _close(td.numpy(), jd, FP32_TOL)
    assert tstate["cache"]["k"].dtype == torch.bfloat16
    _close(tstate["cache"]["k"].float().numpy(),
           np.asarray(jstate["cache"]["k"], np.float32), 2 ** -7)


@pytest.mark.parametrize("arch", ARCHES)
def test_paged_chunk_prefill_and_decode_step(arch):
    """Two sequences prefill through the paged chunk path (one in two
    chunks, from an offset), then one batched paged decode step."""
    jcfg, tcfg = _cfgs(arch)
    jp, tp = _params(jcfg, tcfg)
    geom = dict(page_size=4, num_pages=12, max_slots=2, max_pages_per_seq=4)
    jpcfg, tpcfg = JaxPagedCacheConfig(**geom), PagedCacheConfig(**geom)
    bt = np.array([[5, 2, 9, 12], [0, 7, 3, 12]], np.int32)    # 12 = null page
    prompts = [_tokens(jcfg.vocab, (6,), seed=3), _tokens(jcfg.vocab, (9,), seed=4)]
    chunks = [[(0, 6)], [(0, 5), (5, 9)]]

    jstate = jm.init_paged_state(jcfg, jpcfg)
    tstate = tm.init_paged_state(tcfg, tpcfg, device="cpu")
    for i, (prompt, spans) in enumerate(zip(prompts, chunks)):
        for a, z in spans:
            jl, jstate = jm.prefill_chunk_paged(
                jp, jnp.asarray(prompt[a:z])[None], jstate, jnp.asarray(bt[i:i + 1]),
                jnp.int32(a), jcfg)
            tl, tstate = tm.prefill_chunk_paged(
                tp, torch.tensor(prompt[a:z])[None], tstate, torch.tensor(bt[i:i + 1]),
                a, tcfg)
            _close(tl.numpy(), jl, POOL_TOL)
    _close(tstate["cache"]["v"].float().numpy(),
           np.asarray(jstate["cache"]["v"], np.float32), 2 ** -7)

    nxt = _tokens(jcfg.vocab, (2, 1), seed=5)
    sl = np.array([6, 9], np.int32)
    jd, _ = jm.decode_step_paged(jp, jnp.asarray(nxt), jstate, jnp.asarray(bt),
                                 jnp.asarray(sl), jcfg)
    td, _ = tm.decode_step_paged(tp, torch.tensor(nxt), tstate, torch.tensor(bt),
                                 torch.tensor(sl), tcfg)
    _close(td.numpy(), jd, POOL_TOL)


def test_apply_rope_matches_reference():
    """RoPE from positions (the tables every layer of a step shares)."""
    from repro.nn.rotary import apply_rope as jax_apply_rope
    from repro_torch.nn.rotary import apply_rope

    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, 5, 3, 16)).astype(np.float32)
    pos = rng.integers(0, 4000, size=(2, 5)).astype(np.int32)
    got = apply_rope(torch.tensor(x), torch.tensor(pos), 500_000.0)
    ref = jax_apply_rope(jnp.asarray(x), jnp.asarray(pos), 500_000.0)
    _close(got.numpy(), ref, FP32_TOL)


def test_unported_families_raise():
    """encdec (whisper) is not ported: neither its init nor its training;
    moe_lm (deepseek) trains, but only with MLA and RMSNorm."""
    from repro_torch.models.lm import require_family

    with pytest.raises(NotImplementedError):
        tm.init_model(get_config("whisper-medium", reduced=True), device="cpu")
    with pytest.raises(NotImplementedError, match="family 'encdec': train is not ported"):
        require_family(get_config("whisper-medium", reduced=True), "train")
    require_family(get_config("deepseek-v3-671b", reduced=True), "train")
    with pytest.raises(NotImplementedError, match="RMSNorm"):
        require_family(get_config("deepseek-v3-671b", reduced=True).replace(norm="layernorm"),
                       "train")


def test_entry_points_need_a_device_or_cuda(monkeypatch):
    """No silent CPU fallback: without a GPU an entry point that was not
    asked for the CPU raises."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tm.init_model(get_config("llama3.2-1b", reduced=True))
