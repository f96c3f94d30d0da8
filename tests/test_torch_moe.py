"""Port vs reference: the Mixture-of-Experts layer of the hybrid family
(jamba's, reduced), spectral and dense experts.

The same inputs, drawn with numpy, and the reference's ``init_model``
draws run through ``repro.nn.moe.apply_moe`` and the port's, at a
capacity factor where capacity never binds (8.0, the reference tests'
pin), at the config's 1.25 (tokens dropped) and at 0.01 (one slot an
expert). A router with two equal columns forces exact top-k ties, which
the port breaks toward the lower expert index as ``jax.lax.top_k`` does.

Tolerance: fp32 at the ladder's 5e-5 rung on outputs divided by the
reference's root mean square; the routing (experts, gates, drops) must
be identical, so a wrong tie or drop shows as a whole token's error.
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.config import get_config as jax_get_config  # noqa: E402
from repro.nn import moe as jmoe  # noqa: E402
from repro_torch.config import get_config  # noqa: E402
from repro_torch.core.tree import tree_map  # noqa: E402
from repro_torch.kernels.testing import Tol, assert_scaled_close  # noqa: E402
from repro_torch.nn import moe as tmoe  # noqa: E402

torch.set_num_threads(2)

RUNG = Tol(rtol=5e-5, atol=5e-5)
ARCH = "jamba-v0.1-52b"


def _cfgs(spectral=True):
    jcfg = jax_get_config(ARCH, reduced=True).replace(dtype="float32")
    tcfg = get_config(ARCH, reduced=True).replace(dtype="float32")
    if not spectral:
        jcfg, tcfg = (c.replace_sct(spectral_mlp=False) for c in (jcfg, tcfg))
    return jcfg, tcfg


def _params(jcfg, seed=0, tie=False):
    jp = jmoe.init_moe(jax.random.PRNGKey(seed), jcfg)
    if tie:
        w = jp["router"]["w"]
        jp["router"]["w"] = w.at[:, 1].set(w[:, 0]).at[:, 3].set(w[:, 2])
    return jp, tree_map(lambda a: torch.tensor(np.asarray(a)), jax.device_get(jp))


def _x(b, s, d, seed=1):
    return np.random.default_rng(seed).standard_normal((b, s, d)).astype(np.float32)


def _close(got, ref, what):
    assert_scaled_close(got.detach().float().numpy(), np.asarray(ref, np.float32), RUNG,
                        err_msg=what)


def _drops(jp, x, jcfg, cf):
    """Picks the reference drops at capacity factor ``cf``."""
    T = x.shape[0] * x.shape[1]
    logits = jnp.asarray(x.reshape(T, -1)) @ jp["router"]["w"]
    _, idx = jax.lax.top_k(jax.nn.softmax(logits, axis=-1), jcfg.top_k)
    counts = np.bincount(np.asarray(idx).ravel(), minlength=jcfg.n_experts)
    return int(np.maximum(counts - tmoe.capacity(jcfg, T, cf), 0).sum())


@pytest.mark.parametrize("spectral", [True, False], ids=["spectral", "dense"])
@pytest.mark.parametrize("cf", [8.0, 1.25, 0.01])
def test_apply_moe_vs_reference(cf, spectral):
    jcfg, tcfg = _cfgs(spectral)
    jp, tp = _params(jcfg)
    x = _x(2, 9, jcfg.d_model)
    ref, raux = jmoe.apply_moe(jp, jnp.asarray(x), jcfg, capacity_factor=cf)
    got, aux = tmoe.apply_moe(tp, torch.tensor(x), tcfg, capacity_factor=cf)
    drops = _drops(jp, x, jcfg, cf)
    assert (drops == 0) == (cf == 8.0), drops          # the cases bind as labelled
    _close(got, ref, f"out cf={cf}")
    _close(aux, raux, f"aux cf={cf}")
    assert aux.dtype == torch.float32 and aux.ndim == 0


@pytest.mark.parametrize("cf", [8.0, 1.25])
def test_top_k_ties_break_toward_the_lower_expert(cf):
    """Equal router columns give equal probabilities; the reference picks
    the lower index, and so does the port (torch.topk promises no
    order). At 1.25 the tie also decides which picks are dropped."""
    jcfg, tcfg = _cfgs()
    jp, tp = _params(jcfg, seed=2, tie=True)
    x = _x(3, 7, jcfg.d_model, seed=3)
    T = 21
    xt = torch.tensor(x).reshape(T, -1)
    probs = torch.softmax(xt @ tp["router"]["w"], dim=-1)
    assert torch.equal(probs[:, 0], probs[:, 1]) and torch.equal(probs[:, 2], probs[:, 3])
    vals, idx = tmoe.top_k(probs, jcfg.top_k)
    jvals, jidx = jax.lax.top_k(jnp.asarray(probs.numpy()), jcfg.top_k)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(vals.numpy(), np.asarray(jvals))
    assert set(np.unique(idx.numpy()[:, 0])) <= {0, 2}     # the lower of each tied pair
    ref, raux = jmoe.apply_moe(jp, jnp.asarray(x), jcfg, capacity_factor=cf)
    got, aux = tmoe.apply_moe(tp, torch.tensor(x), tcfg, capacity_factor=cf)
    _close(got, ref, f"out with ties, cf={cf}")
    _close(aux, raux, f"aux with ties, cf={cf}")


def test_capacity_and_unported_mesh():
    jcfg, tcfg = _cfgs()
    # the reference's C_loc = max(1, int(capacity_factor * T * top_k / E))
    assert tmoe.capacity(tcfg, 4, 1.25) == 2          # 4 experts, top 2
    assert tmoe.capacity(tcfg, 4, 8.0) == 16
    assert tmoe.capacity(tcfg, 4, 0.01) == 1
    full = get_config(ARCH)
    assert tmoe.capacity(full, 4, full.capacity_factor) == 1   # binds at 4 slots
    assert tmoe.capacity(full, 4, 8.0) == 4
    _, tp = _params(jcfg)
    with pytest.raises(NotImplementedError, match="mesh"):
        tmoe.apply_moe(tp, torch.zeros((1, 2, jcfg.d_model)), tcfg, mesh=object())


def test_init_moe_layout():
    """Expert leaves carry the leading E axis, spectral U and V with
    orthonormal columns, the reference's shapes key for key."""
    jcfg, tcfg = _cfgs()
    jp = jax.eval_shape(lambda k: jmoe.init_moe(k, jcfg), jax.random.PRNGKey(0))
    tp = tmoe.init_moe(tcfg, generator=torch.Generator().manual_seed(0),
                       device=torch.device("cpu"))
    shapes = jax.tree.map(lambda s: tuple(s.shape), jp)
    assert tree_map(lambda t: tuple(t.shape), tp) == shapes
    U = tp["gate"]["U"]
    eye = torch.eye(U.shape[-1]).expand(U.shape[0], -1, -1)
    assert torch.allclose(U.transpose(1, 2) @ U, eye, atol=1e-5)
    assert torch.equal(tp["gate"]["s"][0], tp["gate"]["s"][-1])
