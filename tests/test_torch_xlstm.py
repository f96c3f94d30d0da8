"""Port vs reference: the xlstm-1.3b family (``ssm_lm``) at reduced size.

The same inputs, drawn with numpy, run through the JAX package and the
port: the chunkwise mLSTM's plain version against the reference's chunk
body and its Pallas kernel (interpret mode), the mLSTM and sLSTM blocks,
the model's forward, static prefill and decode, and the serving engine.
Parameters are the reference's ``init_model`` draws, carried over with
``bridge.params_from_numpy``.

Tolerance: fp32 compute at the ladder's 5e-5 rung, on outputs divided by
the reference's root mean square (``kernels/testing.py``): both sides
accumulate in fp32 and differ by summation order. Serving compares
greedy tokens, which must be identical.
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.config import get_config as jax_get_config  # noqa: E402
from repro.kernels.mlstm_chunk import mlstm_chunk_pallas  # noqa: E402
from repro.models import model as jm  # noqa: E402
from repro.nn import xlstm as jx  # noqa: E402
from repro.serving import PagedCacheConfig as JaxPagedCacheConfig  # noqa: E402
from repro.serving import Request as JaxRequest  # noqa: E402
from repro.serving.engine import ServingEngine as JaxServingEngine  # noqa: E402
from repro_torch.bridge import expected_shapes, params_from_numpy  # noqa: E402
from repro_torch.checkpoint.store import flatten  # noqa: E402
from repro_torch.config import get_config  # noqa: E402
from repro_torch.core.tree import tree_map  # noqa: E402
from repro_torch.kernels.mlstm_chunk import CHUNK as KERNEL_CHUNK  # noqa: E402
from repro_torch.kernels.mlstm_ref import init_state, mlstm_chunk_ref  # noqa: E402
from repro_torch.kernels.testing import Tol, assert_scaled_close, mlstm_inputs  # noqa: E402
from repro_torch.models import model as tm  # noqa: E402
from repro_torch.nn import xlstm as tx  # noqa: E402
from repro_torch.serving import PagedCacheConfig, Request, ServingEngine  # noqa: E402

torch.set_num_threads(2)

RUNG = Tol(rtol=5e-5, atol=5e-5)       # the fp32 rung, RMS-scaled
ARCH = "xlstm-1.3b"


def _close(got, ref, what=""):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else got
    assert_scaled_close(np.asarray(got, np.float32), np.asarray(ref, np.float32), RUNG,
                        err_msg=what)


@pytest.fixture(scope="module")
def models():
    jcfg = jax_get_config(ARCH, reduced=True).replace(dtype="float32")
    tcfg = get_config(ARCH, reduced=True).replace(dtype="float32")
    jp = jm.init_model(jax.random.PRNGKey(0), jcfg)
    return jcfg, jp, tcfg, params_from_numpy(jax.device_get(jp), tcfg, device="cpu")


def _torch_tree(tree):
    return tree_map(lambda a: torch.tensor(np.asarray(a)), jax.device_get(tree))


def _block(models, kind):
    """The first period's first mLSTM (or its sLSTM) in both packages."""
    jcfg, jp, tcfg, tp = models
    p = "p0" if kind == "mlstm" else f"p{jcfg.slstm_offset}"
    jblock = jax.tree.map(lambda t: t[0], jp["periods"][p][kind])
    return jblock, _torch_tree(jblock)


def _np(*shape, seed=0, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def _jax_chunks(q, k, v, i_pre, f_pre, state, chunk=jx.MLSTM_CHUNK, ragged=False):
    """The reference's chunk loop (``_mlstm_core``'s) over folded (B, S,
    dh) inputs, one head a row: y and the final (C, n, m). With ``ragged``
    the chunks are cut as the CUDA kernel cuts them (the last one shorter)
    in place of the reference's one chunk of S where ``chunk`` does not
    divide S."""
    B, S, dh = q.shape
    logf = jax.nn.log_sigmoid(jnp.asarray(f_pre))
    C, n, m = (jnp.asarray(t.numpy())[:, None] for t in state)
    T = min(chunk, S)
    if S % T and not ragged:
        T = S
    outs = []
    for c0 in range(0, S, T):
        sl = slice(c0, c0 + T)
        out, (C, n, m) = jx._mlstm_chunk_body(
            *(jnp.asarray(t[:, sl].numpy())[:, :, None] for t in (q, k, v)),
            jnp.asarray(i_pre[:, sl].numpy())[:, :, None], logf[:, sl, None], C, n, m)
        outs.append(out[:, :, 0])
    return jnp.concatenate(outs, axis=1), (C[:, 0], n[:, 0], m[:, 0])


@pytest.mark.parametrize("S", [1, 7, 64, 300, 512])
def test_mlstm_ref_vs_reference_chunk_body(S):
    """y and the final state from a carried-in state; S = 300 is the
    reference's one-chunk fallback (256 does not divide it), S = 512 two
    chunks of 256."""
    q, k, v, i, f, state = mlstm_inputs(3, S, 32, "unit", seed=S, with_state=True)
    y, (C, n, m) = mlstm_chunk_ref(q, k, v, i, f, state)
    yr, (Cr, nr, mr) = _jax_chunks(q, k, v, i, f, state)
    for what, got, ref in (("y", y, yr), ("C", C, Cr), ("n", n, nr), ("m", m, mr)):
        _close(got, ref, f"{what} S={S}")


@pytest.mark.parametrize("with_state", [False, True], ids=["empty", "state"])
@pytest.mark.parametrize("S", [1, 37, 160, 256, 257, 300, 1000])
def test_mlstm_ref_at_kernel_chunks_vs_reference(S, with_state):
    """The plain version cut as the CUDA kernel cuts (256-token chunks, the
    last one ragged) against the reference's chunk body over the same
    chunks, from the empty state the engine's prefill starts from and from
    a given one, at the fp32 rung. Up to S = 256 these are the chunks of
    the reference's ``_mlstm_core`` itself (one chunk of S); past 256 the
    reference takes one chunk of S where 256 does not divide S, whose fp32
    prefix sums round elsewhere and move the stabiliser m by their ulp
    (~2e-4 at S = 1000), so the body is run over the kernel's chunks."""
    q, k, v, i, f, state = mlstm_inputs(2, S, 32, "unit", seed=S, with_state=with_state)
    y, (C, n, m) = mlstm_chunk_ref(q, k, v, i, f, state, chunk=KERNEL_CHUNK, ragged=True)
    st = state if state is not None else init_state(2, 32, device="cpu")
    yr, (Cr, nr, mr) = _jax_chunks(q, k, v, i, f, st, chunk=KERNEL_CHUNK, ragged=True)
    if S <= KERNEL_CHUNK:                  # the reference's own chunking
        y0, st0 = _jax_chunks(q, k, v, i, f, st)
        assert all(np.array_equal(np.asarray(a), np.asarray(b))
                   for a, b in zip((y0, *st0), (yr, Cr, nr, mr)))
    for what, got, ref in (("y", y, yr), ("C", C, Cr), ("n", n, nr), ("m", m, mr)):
        _close(got, ref, f"{what} S={S}")


@pytest.mark.parametrize("S", [1, 7, 64, 300, 512])
def test_mlstm_core_vs_reference(models, S):
    """The block's core from gate inputs xu (b, S, di) through its own
    q/k/v/gate projections: y and the state, empty state in."""
    jcfg, _, tcfg, _ = models
    jb, tb = _block(models, "mlstm")
    xu = _np(2, S, 2 * jcfg.d_model, seed=S)
    yr, sr = jx._mlstm_core(jb, jnp.asarray(xu), jcfg)
    y, st = tx._mlstm_core(tb, torch.tensor(xu), tcfg)
    _close(y, yr, f"y S={S}")
    for name in ("C", "n", "m"):
        _close(st[name], sr[name], f"{name} S={S}")


@pytest.mark.parametrize("S,dh,chunk", [(128, 32, 64), (64, 16, 64)])
def test_mlstm_ref_vs_pallas_kernel_interpret(S, dh, chunk):
    """The TPU kernel, run as the JAX package's tests run it on the CPU."""
    q, k, v, i, f, _ = mlstm_inputs(3, S, dh, "unit", seed=dh)
    y, _ = mlstm_chunk_ref(q, k, v, i, f, chunk=chunk)
    yr = mlstm_chunk_pallas(*(jnp.asarray(t.numpy()) for t in (q, k, v, i, f)),
                            chunk=chunk, interpret=True)
    _close(y, yr)


def test_mlstm_decode_and_recurrent_form(models):
    """One recurrent step against the reference's, from a prefilled
    state; and the chunkwise prefill of a prompt followed by decode
    steps against the recurrent cell run token by token from the empty
    state (the two forms are one function)."""
    jcfg, _, tcfg, _ = models
    jb, tb = _block(models, "mlstm")
    x = _np(2, 20, jcfg.d_model, seed=3)
    _, js = jx.apply_mlstm_with_state(jb, jnp.asarray(x[:, :17]), jcfg)
    _, ts = tx.apply_mlstm_with_state(tb, torch.tensor(x[:, :17]), tcfg)
    jo, js = jx.apply_mlstm_decode(jb, jnp.asarray(x[:, 17:18]), jcfg, state=js)
    to, ts = tx.apply_mlstm_decode(tb, torch.tensor(x[:, 17:18]), tcfg, state=ts)
    _close(to, jo, "decode out")
    for name in ("C", "n", "m"):
        _close(ts[name], js[name], f"decode {name}")

    with torch.no_grad():
        chunked, st = tx.apply_mlstm_with_state(tb, torch.tensor(x[:, :12]), tcfg)
        rec = tx.mlstm_init_state(tcfg, 2, device="cpu")
        steps = []
        for t in range(20):
            out, rec = tx.apply_mlstm_decode(tb, torch.tensor(x[:, t:t + 1]), tcfg, state=rec)
            steps.append(out)
            if t == 11:
                _close(torch.cat(steps, 1), chunked.numpy(), "prefill outputs vs recurrent")
                for name in ("C", "n", "m"):
                    _close(st[name], rec[name].numpy(), f"prefill {name} vs recurrent")
        for t in range(12, 20):
            out, st = tx.apply_mlstm_decode(tb, torch.tensor(x[:, t:t + 1]), tcfg, state=st)
            _close(out, steps[t].numpy(), f"decode after prefill, token {t}")


def test_slstm_cell_block_and_decode(models):
    jcfg, _, tcfg, _ = models
    jb, tb = _block(models, "slstm")
    b, d = 2, jcfg.d_model
    nh, dh = jcfg.n_heads, d // jcfg.n_heads
    xg = _np(b, 4 * d, seed=4)
    st = {name: _np(b, nh, dh, seed=5 + j) for j, name in enumerate(("h", "c", "n", "m"))}
    st["n"] = np.abs(st["n"])
    ref = jx._slstm_cell(jb, jcfg, jnp.asarray(xg), {k: jnp.asarray(v) for k, v in st.items()})
    got = tx._slstm_cell(tb, tcfg, torch.tensor(xg), {k: torch.tensor(v) for k, v in st.items()})
    for name in ("h", "c", "n", "m"):
        _close(got[name], ref[name], f"cell {name}")

    x = _np(b, 9, d, seed=9)
    _close(tx.apply_slstm(tb, torch.tensor(x), tcfg), jx.apply_slstm(jb, jnp.asarray(x), jcfg),
           "apply_slstm")
    jst = jx.slstm_init_state(jcfg, b)
    tst = tx.slstm_init_state(tcfg, b, device="cpu")
    for t in range(3):
        jo, jst = jx.apply_slstm_decode(jb, jnp.asarray(x[:, t:t + 1]), jcfg, state=jst)
        to, tst = tx.apply_slstm_decode(tb, torch.tensor(x[:, t:t + 1]), tcfg, state=tst)
        _close(to, jo, f"decode out {t}")
    for name in ("h", "c", "n", "m"):
        _close(tst[name], jst[name], f"decode {name}")


def test_forward_logits_and_loss(models):
    jcfg, jp, tcfg, tp = models
    rng = np.random.default_rng(1)
    toks = rng.integers(0, jcfg.vocab, size=(2, 11)).astype(np.int32)
    labels = rng.integers(0, jcfg.vocab, size=(2, 11)).astype(np.int32)
    assert tm.param_count(tp) == jm.param_count(jp)
    assert expected_shapes(tcfg) == {k: tuple(v.shape) for k, v in flatten(tp).items()}
    ref, _ = jm.forward(jp, jnp.asarray(toks), jcfg)
    with torch.no_grad():
        got, aux = tm.forward(tp, torch.tensor(toks), tcfg)
        loss, _ = tm.train_loss(tp, {"tokens": torch.tensor(toks),
                                     "labels": torch.tensor(labels)}, tcfg)
    _close(got, ref, "logits")
    assert float(aux) == 0.0
    jloss, _ = jm.train_loss(jp, {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)},
                             jcfg)
    _close(loss, jloss, "loss")


def test_static_prefill_and_decode_states(models):
    jcfg, jp, tcfg, tp = models
    rng = np.random.default_rng(2)
    toks = rng.integers(0, jcfg.vocab, size=(2, 9)).astype(np.int32)
    nxt = rng.integers(0, jcfg.vocab, size=(2, 1)).astype(np.int32)
    jl, js = jm.prefill(jp, jnp.asarray(toks), jcfg, jm.init_decode_state(jcfg, 2, 16))
    jd, js = jm.decode_step(jp, jnp.asarray(nxt), js, jnp.int32(9), jcfg)
    with torch.no_grad():
        tl, ts = tm.prefill(tp, torch.tensor(toks), tcfg,
                            tm.init_decode_state(tcfg, 2, 16, device="cpu"))
        td, ts = tm.decode_step(tp, torch.tensor(nxt), ts, 9, tcfg)
    _close(tl, jl, "prefill logits")
    _close(td, jd, "decode logits")
    for key in ("mlstm", "slstm"):
        assert set(ts[key]) == set(js[key])
        for name in ts[key]:
            assert tuple(ts[key][name].shape) == js[key][name].shape
            _close(ts[key][name], js[key][name], f"{key}/{name}")


def _trace(vocab, cls):
    rng = np.random.default_rng(1)
    # three requests through two slots: request 2 takes the slot request 0
    # finished in
    spec = [(4, 3, 0), (6, 7, 0), (5, 4, 2)]
    return [cls(rid=i, prompt=rng.integers(0, vocab, size=(n,)).astype(np.int32),
                max_new_tokens=g, arrival=a) for i, (n, g, a) in enumerate(spec)]


def test_engine_tokens_identical_to_reference_engine(models):
    """Interleaved requests and a slot reused after a finished request:
    the port's engine gives the JAX engine's tokens and the static
    path's; every leaf of the reused slot was overwritten by its
    prefill."""
    from repro_torch.launch.serve import static_greedy_reference
    from repro_torch.serving.paged_cache import slot_read

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
        # the slot now holds exactly this prompt's prefilled state
        solo = tm.init_decode_state(tcfg, 1, 16, device="cpu")
        _, solo = tm.prefill(engine.params, torch.tensor(seq.request.prompt)[None].long(),
                             tcfg, solo)
        for key, axis in (("mlstm", 2), ("slstm", 1)):
            got = slot_read(engine.state[key], axis, seq.slot)
            for name in got:
                assert torch.equal(got[name], solo[key][name]), (seq.request.rid, key, name)

    engine._prefill_full = watched
    got = engine.run(trace)
    assert slots[2] == slots[0]
    engine.sched.check_invariants()
    for r in trace:
        np.testing.assert_array_equal(got[r.rid], ref[r.rid], err_msg=f"request {r.rid}")
        np.testing.assert_array_equal(
            got[r.rid], static_greedy_reference(tcfg, engine.params, r.prompt,
                                                r.max_new_tokens, pcfg.max_seq, device="cpu"),
            err_msg=f"request {r.rid} vs static")
    assert engine.stats()["recurrent_state_bytes"] > 0


def test_cli_serves_xlstm_and_verifies_on_cpu(capsys):
    from repro_torch.launch.serve import main

    main(["--arch", ARCH, "--reduced", "--paged", "--stream", "--verify", "--device", "cpu",
          "--requests", "4", "--gen", "6", "--prompt-len", "10"])
    out = capsys.readouterr().out
    assert "verify: all 4 requests match" in out
    assert "recurrent state:" in out
    exact = out.split("; ")[-1].split(" tokens are exactly")[0]
    n, total = exact.split("/")
    assert n == total, out


def test_serving_keeps_wr_fp32_and_unported_paths_raise(models):
    from repro_torch.api import ModelSpec, RunSpec, Trainer, TrainSpec
    from repro_torch.launch.steps import make_train_step
    from repro_torch.serving.streaming import StreamingConfig

    _, _, tcfg, tp = models
    cfg = tcfg.replace(dtype="bfloat16")
    sp = tm.serving_params(tp, cfg, torch.device("cpu"))
    assert sp["periods"][f"p{cfg.slstm_offset}"]["slstm"]["wr"].dtype == torch.float32
    assert sp["periods"]["p0"]["mlstm"]["wq"]["w"].dtype == torch.bfloat16
    # training is ported: make_train_step and the Trainer build
    assert callable(make_train_step(cfg))
    trainer = Trainer(RunSpec(model=ModelSpec(ARCH, reduced=True), train=TrainSpec(steps=1)),
                      device="cpu")
    assert trainer.cfg.family == "ssm_lm"
    pcfg = PagedCacheConfig(page_size=4, num_pages=12, max_slots=2, max_pages_per_seq=4)
    with pytest.raises(NotImplementedError):
        ServingEngine(cfg, tp, pcfg, device="cpu", quantize="int8")
    with pytest.raises(NotImplementedError):
        ServingEngine(cfg, tp, pcfg, device="cpu",
                      streaming=StreamingConfig(sink_pages=1, window_pages=1))
    # the mLSTM kernel wrapper has a gradient: the plain backward on the CPU
    q, k, v, i, f, _ = mlstm_inputs(1, 5, 8, "unit")
    q.requires_grad_()
    y, _ = tx.mlstm_chunk(q, k, v, i, f)
    y.sum().backward()
    assert q.grad is not None and bool(torch.isfinite(q.grad).all())
    assert float(q.grad.abs().max()) > 0.0
