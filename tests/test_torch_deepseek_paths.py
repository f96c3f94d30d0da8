"""Port vs reference on the setup of a reference divergence that ROADMAP
queue 3 records: the reference's
``test_speculative.py::test_rank_shrunk_restore_shares_pool_layout[deepseek-v3-671b]``,
whose engine (MLA paged path) leaves its static path. The port is run on
the same setup and compared layer by layer against both reference paths.

Tolerances: the ladder's fp32 rung (5e-5 of the reference's RMS) on the
logits of the model cut after each layer; both packages compute in fp32
and differ by summation order.
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
from repro_torch.kernels.testing import Tol, assert_scaled_close  # noqa: E402
from repro_torch.models import model as tm  # noqa: E402
from repro_torch.serving import PagedCacheConfig, Request, ServingEngine  # noqa: E402

torch.set_num_threads(2)

RUNG = Tol(rtol=5e-5, atol=5e-5)
ARCH = "deepseek-v3-671b"


def _close(got, ref, what=""):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else got
    assert_scaled_close(np.asarray(got, np.float32),
                        np.asarray(jnp.asarray(ref, jnp.float32)), RUNG, err_msg=what)


def _truncated(params, cfg, n_layers):
    """The first ``n_layers`` layers of a moe_lm tree (and its config): the
    logits of the cut model read the residual after that layer through
    the same final norm and head."""
    out = dict(params)
    dense = min(n_layers, cfg.first_dense_layers)
    out["dense_layers"] = jax.tree.map(lambda a: a[:dense], params["dense_layers"])
    out["moe_layers"] = jax.tree.map(lambda a: a[:n_layers - dense], params["moe_layers"])
    return out, cfg.replace(n_layers=n_layers)


def test_rank_shrunk_setup_matches_both_reference_paths():
    """ROADMAP queue 3: the reference's
    ``test_speculative.py::test_rank_shrunk_restore_shares_pool_layout[deepseek-v3-671b]``
    (reduced deepseek, fp32, capacity 8.0, weights shrunk to rank 8, page
    8, 3 slots) finds its engine off its static path. Layer by layer (the
    logits of the model cut after each layer) at the first decode step
    that differs (the 9-token prompt's step 1, token 181 fed): the port's
    static path is the reference's static path and the port's paged path
    (chunk prefill, paged decode) the reference's paged path, at the fp32
    rung; the two paths part in both packages. Cause: the static prefill
    attends over the prompt's latents in fp32, the chunk prefill over the
    latents read back from the bf16 pools; rounding the static prefill's
    latents the same way makes the two paths one."""
    from repro.serving.speculative import derive_drafters

    from repro_torch.launch.serve import static_greedy_reference
    from repro_torch.nn import attention as tattn

    jcfg = jax_get_config(ARCH, reduced=True).replace(dtype="float32", capacity_factor=8.0)
    tcfg = get_config(ARCH, reduced=True).replace(dtype="float32", capacity_factor=8.0)
    (shrunk,) = derive_drafters(jm.init_model(jax.random.PRNGKey(0), jcfg), [8])
    tcfg = tcfg.replace_sct(rank=8)
    prompt = np.random.RandomState(0).randint(1, jcfg.vocab, size=(14,)).astype(np.int32)[5:]
    pcfg = dict(page_size=8, num_pages=24, max_slots=1, max_pages_per_seq=4)
    bt = np.arange(4, dtype=np.int32)[None]
    tok, pos = np.array([[181]], np.int32), len(prompt)
    paths = {}
    for n in range(1, tcfg.n_layers + 1):
        jp, jc = _truncated(shrunk, jcfg, n)
        tc = tcfg.replace(n_layers=n)
        tp = params_from_numpy({k: v for k, v in jax.device_get(jp).items()
                                if k != "moe_layers" or n > tcfg.first_dense_layers},
                               tc, device="cpu")
        _, js = jm.prefill(jp, jnp.asarray(prompt)[None], jc, jm.init_decode_state(jc, 1, 32))
        j_static, _ = jm.decode_step(jp, jnp.asarray(tok), js, jnp.int32(pos), jc)
        _, js = jm.prefill_chunk_paged(jp, jnp.asarray(prompt)[None],
                                       jm.init_paged_state(jc, JaxPagedCacheConfig(**pcfg)),
                                       jnp.asarray(bt), jnp.int32(0), jc)
        j_paged, _ = jm.decode_step_paged(jp, jnp.asarray(tok), js, jnp.asarray(bt),
                                          jnp.asarray([pos], jnp.int32), jc)
        with torch.no_grad():
            _, ts = tm.prefill(tp, torch.tensor(prompt)[None].long(), tc,
                               tm.init_decode_state(tc, 1, 32, device="cpu"))
            t_static, _ = tm.decode_step(tp, torch.tensor(tok).long(), ts, pos, tc)
            _, ts = tm.prefill_chunk_paged(tp, torch.tensor(prompt)[None].long(),
                                           tm.init_paged_state(tc, PagedCacheConfig(**pcfg),
                                                               device="cpu"),
                                           torch.tensor(bt), 0, tc)
            t_paged, _ = tm.decode_step_paged(tp, torch.tensor(tok).long(), ts,
                                              torch.tensor(bt), torch.tensor([pos]).int(), tc)
        _close(t_static, j_static, f"layer {n}: static path")
        _close(t_paged, j_paged, f"layer {n}: paged path")
        paths[n] = float(np.abs(np.asarray(j_static) - np.asarray(j_paged)).max()
                         / np.sqrt(np.mean(np.asarray(j_static) ** 2)))
    assert paths[tcfg.n_layers] > RUNG.atol, paths       # the two paths part
    tp = params_from_numpy(jax.device_get(shrunk), tcfg, device="cpu")
    engine = ServingEngine(tcfg, tp, PagedCacheConfig(**pcfg), device="cpu")
    got = engine.run([Request(rid=0, prompt=prompt, max_new_tokens=5)])[0]
    assert got[0] == 181 and not np.array_equal(
        got, static_greedy_reference(tcfg, tp, prompt, 5, 32, device="cpu"))
    mla_ckv = tattn._mla_ckv

    def rounded(p, x, cfg, rope):
        return tuple(t.to(torch.bfloat16).to(t.dtype) for t in mla_ckv(p, x, cfg, rope))

    tattn._mla_ckv = rounded
    try:
        np.testing.assert_array_equal(
            got, static_greedy_reference(tcfg, tp, prompt, 5, 32, device="cpu"))
    finally:
        tattn._mla_ckv = mla_ckv
