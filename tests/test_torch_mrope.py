"""Port vs reference: M-RoPE and qwen2-vl-72b (the dense family with QKV
bias and Qwen2-VL's multimodal RoPE; reduced: 2 layers, d_model 64, 4/2
heads of 16, sections (2, 3, 3)).

``apply_mrope`` selects each half-dim slot's position stream by an index
over the stream axis where the reference multiplies by a one-hot; on the
CPU both are exact, so on the same per-stream angles the selected angles
are the same bits, and the (cos, sin) tables equal ``torch.cos``/
``torch.sin`` of the reference's selection bit for bit. The outputs are
compared at the ladder's rung: XLA's and torch's ``cos`` differ in the
last bit, and so does their ``pow`` for one of the 64 frequencies at
head_dim 128 and theta 1e6 (the port's RoPE shares that table). Text-only
positions (three equal streams) give RoPE's tables exactly.

The model: logits in fp32 at 1e-4 of their scale (``test_torch_model.py``'s
tolerance) and in bf16 against the reference's Pallas path at 5e-2; the
static prefill and decode step; the engine's greedy tokens equal to the
JAX engine's in fp32; the CLI with ``--paged --stream --verify``.
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.config import get_config as jax_get_config  # noqa: E402
from repro.models import model as jm  # noqa: E402
from repro.nn.rotary import apply_mrope as jax_apply_mrope  # noqa: E402
from repro.serving import PagedCacheConfig as JaxPagedCacheConfig  # noqa: E402
from repro.serving import Request as JaxRequest  # noqa: E402
from repro.serving.engine import ServingEngine as JaxServingEngine  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.config import get_config  # noqa: E402
from repro_torch.kernels.testing import Tol, assert_scaled_close  # noqa: E402
from repro_torch.models import model as tm  # noqa: E402
from repro_torch.nn.attention import step_rope  # noqa: E402
from repro_torch.nn.rotary import apply_mrope, mrope_tables, rope_freqs, rope_tables  # noqa: E402
from repro_torch.serving import PagedCacheConfig, Request, ServingEngine  # noqa: E402

torch.set_num_threads(2)

ARCH = "qwen2-vl-72b"
FP32, BF16 = Tol(rtol=5e-5, atol=5e-5), Tol(rtol=5e-2, atol=5e-2)
THETA = 1_000_000.0


def _reference_angles(pos3, head_dim, sections):
    """The reference's selection of each half-dim slot's angle, its
    one-hot product over the streams (``src/repro/nn/rotary.py:47-55``),
    on the per-stream angles of the port's frequency table."""
    half = head_dim // 2
    freqs = jnp.asarray(rope_freqs(head_dim, THETA, "cpu").numpy())
    aps = jnp.asarray(pos3)[..., None].astype(jnp.float32) * freqs
    sect = jnp.repeat(jnp.arange(len(sections)), jnp.array(sections),
                      total_repeat_length=half)
    sel = jax.nn.one_hot(sect, len(sections), dtype=jnp.float32)
    return np.asarray(jnp.einsum("pbsh,hp->bsh", aps, sel))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("sections, head_dim", [((2, 3, 3), 16), ((16, 24, 24), 128)],
                         ids=["reduced", "full"])
def test_apply_mrope_matches_reference(sections, head_dim, dtype):
    rng = np.random.default_rng(0)
    pos3 = rng.integers(0, 5000, size=(3, 2, 7)).astype(np.int32)     # distinct streams
    x = rng.standard_normal((2, 7, 3, head_dim)).astype(np.float32)
    tdt, jdt = {"float32": (torch.float32, jnp.float32),
                "bfloat16": (torch.bfloat16, jnp.bfloat16)}[dtype]
    xt = torch.tensor(x).to(tdt)
    xj = jnp.asarray(xt.float().numpy()).astype(jdt)
    cos, sin = mrope_tables(torch.tensor(pos3).long(), head_dim, sections, THETA)
    ang = torch.tensor(_reference_angles(pos3, head_dim, sections))
    assert torch.equal(cos[:, :, 0], torch.cos(ang)) and torch.equal(sin[:, :, 0], torch.sin(ang))
    got = apply_mrope(xt, torch.tensor(pos3).long(), sections, THETA)
    ref = jax_apply_mrope(xj, jnp.asarray(pos3), sections, THETA)
    assert got.dtype == tdt
    assert_scaled_close(got.float().numpy(), np.asarray(ref, np.float32),
                        FP32 if dtype == "float32" else BF16)
    with pytest.raises(AssertionError):
        mrope_tables(torch.tensor(pos3).long(), head_dim, (1, 1, 1), THETA)


def test_text_only_mrope_is_rope():
    """Three equal streams: M-RoPE's tables are RoPE's, bit for bit;
    ``step_rope`` broadcasts (b, s) positions to them."""
    cfg = get_config(ARCH, reduced=True)
    pos = torch.tensor(np.random.default_rng(1).integers(0, 3000, size=(2, 9)))
    mc, ms = mrope_tables(pos[None].expand(3, 2, 9), cfg.head_dim, cfg.mrope_sections, THETA)
    rc, rs = rope_tables(pos, cfg.head_dim, THETA)
    assert torch.equal(mc, rc) and torch.equal(ms, rs)
    sc, ss = step_rope(cfg, pos)
    assert torch.equal(sc, rc) and torch.equal(ss, rs)


def test_vision_stub_is_the_reference_stub():
    from repro.data import vision_stub as jvs
    from repro_torch.data import vision_stub as tvs

    np.testing.assert_array_equal(tvs.vision_stub_embeddings(2, 5, 16, seed=3),
                                  jvs.vision_stub_embeddings(2, 5, 16, seed=3))
    np.testing.assert_array_equal(tvs.audio_frame_stub(1, 4, 8), jvs.audio_frame_stub(1, 4, 8))


@pytest.fixture(scope="module")
def models():
    jcfg = jax_get_config(ARCH, reduced=True).replace(dtype="float32")
    tcfg = get_config(ARCH, reduced=True).replace(dtype="float32")
    jp = jm.init_model(jax.random.PRNGKey(0), jcfg)
    return jcfg, jp, tcfg, params_from_numpy(jax.device_get(jp), tcfg, device="cpu")


def _tokens(vocab, shape, seed=1):
    return np.random.default_rng(seed).integers(0, vocab, size=shape).astype(np.int32)


def test_qwen2_vl_forward_logits(models):
    """QKV bias is in the tree, and the LM head is the embedding's
    transpose as in the reference (which reads ``tie_embeddings``
    nowhere: every family's head is tied); the logits are the reference's
    in fp32, and in bf16 within the rung of its Pallas path."""
    jcfg, jp, tcfg, tp = models
    assert "b" in tp["layers"]["attn"]["wq"] and sorted(tp) == sorted(jp)
    toks = _tokens(tcfg.vocab, (2, 13))
    ref, _ = jm.forward(jp, jnp.asarray(toks), jcfg)
    got, _ = tm.forward(tp, torch.tensor(toks), tcfg)
    assert tm.param_count(tp) == jm.param_count(jp)
    assert_scaled_close(got.numpy(), np.asarray(ref), Tol(rtol=1e-4, atol=1e-4))
    jb = jax_get_config(ARCH, reduced=True).replace(use_pallas=True)
    tb = get_config(ARCH, reduced=True)
    ref, _ = jm.forward(jp, jnp.asarray(toks[:1]), jb)
    got, _ = tm.forward(tm.serving_params(tp, tb, torch.device("cpu")),
                        torch.tensor(toks[:1]), tb)
    assert got.dtype == torch.bfloat16
    assert_scaled_close(got.float().numpy(), np.asarray(ref, np.float32), BF16)


def test_qwen2_vl_static_prefill_and_decode_step(models):
    jcfg, jp, tcfg, tp = models
    b, plen, S = 2, 7, 16
    toks, nxt = _tokens(tcfg.vocab, (b, plen)), _tokens(tcfg.vocab, (b, 1), seed=2)
    jstate = jm.init_decode_state(jcfg, b, S)
    jl, jstate = jm.prefill(jp, jnp.asarray(toks), jcfg, jstate)
    jd, _ = jm.decode_step(jp, jnp.asarray(nxt), jstate, jnp.int32(plen), jcfg)
    tstate = tm.init_decode_state(tcfg, b, S, device="cpu")
    tl, tstate = tm.prefill(tp, torch.tensor(toks), tcfg, tstate)
    td, _ = tm.decode_step(tp, torch.tensor(nxt), tstate, plen, tcfg)
    assert_scaled_close(tl.numpy(), np.asarray(jl), Tol(rtol=1e-4, atol=1e-4))
    assert_scaled_close(td.numpy(), np.asarray(jd), Tol(rtol=1e-4, atol=1e-4))


def _trace(vocab, cls):
    rng = np.random.default_rng(4)
    return [cls(rid=i, prompt=rng.integers(0, vocab, size=(n,)).astype(np.int32),
                max_new_tokens=g, arrival=a)
            for i, (n, g, a) in enumerate([(6, 5, 0), (13, 4, 0), (9, 6, 1), (3, 5, 3)])]


def test_qwen2_vl_engine_tokens_identical_to_reference_engine(models):
    """Paged chunk prefill (chunked, budget 6) and paged decode: the
    port's engine gives the JAX engine's greedy tokens in fp32, and its
    own static path's."""
    from repro_torch.launch.serve import static_greedy_reference

    jcfg, jp, tcfg, tp = models
    geom = dict(page_size=4, num_pages=24, max_slots=2, max_pages_per_seq=6)
    ref = JaxServingEngine(jcfg, jp, JaxPagedCacheConfig(**geom), prefill_token_budget=6,
                           chunked_prefill=True).run(_trace(jcfg.vocab, JaxRequest))
    pcfg = PagedCacheConfig(**geom)
    engine = ServingEngine(tcfg, tp, pcfg, device="cpu", prefill_token_budget=6,
                           chunked_prefill=True)
    trace = _trace(tcfg.vocab, Request)
    got = engine.run(trace)
    engine.sched.check_invariants()
    for r in trace:
        np.testing.assert_array_equal(got[r.rid], ref[r.rid], err_msg=f"request {r.rid}")
        np.testing.assert_array_equal(
            got[r.rid], static_greedy_reference(tcfg, engine.params, r.prompt,
                                                r.max_new_tokens, pcfg.max_seq, device="cpu"),
            err_msg=f"request {r.rid} vs static")


def test_cli_serves_qwen2_vl_and_verifies_on_cpu(capsys):
    from repro_torch.launch.serve import main

    main(["--arch", ARCH, "--reduced", "--paged", "--stream", "--verify", "--device", "cpu",
          "--requests", "4", "--gen", "6", "--prompt-len", "10"])
    assert "verify: all 4 requests match" in capsys.readouterr().out
