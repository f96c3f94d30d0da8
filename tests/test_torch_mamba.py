"""Port vs reference: the mamba mixer of the hybrid family (jamba) at
reduced size, and the plain version of the selective-scan kernel.

The same inputs, drawn with numpy, run through the JAX package and the
port: the plain scan against the reference model's scan
(``repro.nn.mamba._ssm_scan``) and against its Pallas kernel in
interpret mode (as ``tests/test_kernels_recurrent.py`` runs it), the
causal conv, the prefill forward with its state, and the decode step
over a bf16 state. Parameters are the reference's ``init_model`` draws.

Tolerance: fp32 at the ladder's 5e-5 rung, on outputs divided by the
reference's root mean square (``kernels/testing.py``): both sides
accumulate in fp32 and differ by summation order and by their ``exp``.
Values rounded to the bf16 state are compared at the bf16 rung: each
side rounds an fp32 value that agrees at the fp32 rung, and one that
straddles a rounding boundary lands one bf16 step away.
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.config import get_config as jax_get_config  # noqa: E402
from repro.kernels.mamba_scan import mamba_scan_pallas  # noqa: E402
from repro.models import model as jm  # noqa: E402
from repro.nn import mamba as jmb  # noqa: E402
from repro_torch.config import get_config  # noqa: E402
from repro_torch.core.tree import tree_map  # noqa: E402
from repro_torch.kernels.mamba_ref import mamba_scan_ref, mamba_scan_twin_ref  # noqa: E402
from repro_torch.kernels.mamba_scan import mamba_scan  # noqa: E402
from repro_torch.kernels.testing import (  # noqa: E402
    MAMBA_PROFILES,
    Tol,
    assert_scaled_close,
    mamba_inputs,
)
from repro_torch.nn import mamba as tmb  # noqa: E402

torch.set_num_threads(2)

RUNG = Tol(rtol=5e-5, atol=5e-5)       # the fp32 rung, RMS-scaled
BF16_RUNG = Tol(rtol=5e-2, atol=5e-2)
ARCH = "jamba-v0.1-52b"


def _close(got, ref, what="", tol=RUNG):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else got
    ref = np.asarray(jnp.asarray(ref, jnp.float32)) if not isinstance(ref, np.ndarray) else ref
    assert_scaled_close(np.asarray(got, np.float32), np.asarray(ref, np.float32), tol,
                        err_msg=what)


def _j(t):
    return jnp.asarray(t.float().numpy()).astype(
        jnp.bfloat16 if t.dtype == torch.bfloat16 else jnp.float32)


@pytest.fixture(scope="module")
def mamba_block():
    """The first period's first mamba layer of the reduced config, fp32,
    in both packages."""
    jcfg = jax_get_config(ARCH, reduced=True).replace(dtype="float32", capacity_factor=8.0)
    tcfg = get_config(ARCH, reduced=True).replace(dtype="float32", capacity_factor=8.0)
    jp = jm.init_model(jax.random.PRNGKey(0), jcfg)
    jblock = jax.tree.map(lambda t: t[0], jp["periods"]["p0"]["mamba"])
    tblock = tree_map(lambda a: torch.tensor(np.asarray(a)), jax.device_get(jblock))
    return jcfg, jblock, tcfg, tblock


@pytest.mark.parametrize("profile", MAMBA_PROFILES)
@pytest.mark.parametrize("S", [1, 7, 40])
def test_scan_ref_vs_reference_scan(S, profile):
    """y and the final state against the reference model's scan, fp32."""
    u, dt, B, C, A, D = mamba_inputs(2, S, 48, 16, profile, seed=S)
    y, h = mamba_scan_ref(u, dt, B, C, A, D)
    yr, hr = jmb._ssm_scan(*(_j(t) for t in (u, dt, B, C, A, D)))
    assert y.dtype == torch.float32 and h.dtype == torch.float32
    _close(y, yr, f"y S={S} {profile}")
    _close(h, hr, f"hT S={S} {profile}")


@pytest.mark.parametrize("S,di,ds,tc,dic", [(64, 128, 16, 32, 64), (128, 96, 8, 64, 32)])
def test_scan_ref_vs_pallas_kernel_interpret(S, di, ds, tc, dic):
    """The TPU kernel, run as the JAX package's tests run it on the CPU
    (its chunks must divide S and di)."""
    u, dt, B, C, A, D = mamba_inputs(2, S, di, ds, "unit", seed=di)
    y, _ = mamba_scan_ref(u, dt, B, C, A, D)
    yr = mamba_scan_pallas(*(_j(t) for t in (u, dt, B, C, A, D)), t_chunk=tc, di_chunk=dic,
                           interpret=True)
    _close(y, yr)


def test_scan_wrapper_dispatch_and_twin():
    """On the CPU the wrapper is the plain version; its y rounds once to
    bf16 from an fp32 state, where the reference's twin (copied by
    ``mamba_scan_twin_ref``) carries h in bf16: the same function in
    fp32, another rounding in bf16. The kernel's wrapper has no
    gradient."""
    args = mamba_inputs(2, 9, 32, 16, "unit", seed=3)
    y, h = mamba_scan(*args)
    yr, hr = mamba_scan_ref(*args)
    assert torch.equal(y, yr) and torch.equal(h, hr)
    yt, ht = mamba_scan_twin_ref(*args)
    _close(yt, yr.numpy(), "twin vs plain, fp32")
    _close(ht, hr.numpy(), "twin state vs plain, fp32")
    jy, jh = jmb._ssm_scan(*(_j(t.bfloat16()) for t in args[:5]), _j(args[5]))
    ty, th = mamba_scan_twin_ref(*(t.bfloat16() for t in args[:4]), args[4], args[5])
    assert ty.dtype == torch.bfloat16 and th.dtype == torch.bfloat16
    _close(ty, jy, "twin vs the reference's scan, bf16", tol=BF16_RUNG)
    _close(th, jh, "twin state vs the reference's, bf16", tol=BF16_RUNG)
    yb, hb = mamba_scan(*(t.bfloat16() for t in args[:4]), args[4], args[5])
    assert yb.dtype == torch.bfloat16 and hb.dtype == torch.float32
    u = args[0].clone().requires_grad_()
    y, _ = mamba_scan(u, *args[1:])
    with pytest.raises(TypeError, match="no backward"):
        y.sum().backward()


def test_causal_conv(mamba_block):
    jcfg, jb, tcfg, tb = mamba_block
    x = np.random.default_rng(1).standard_normal((2, 9, 2 * jcfg.d_model)).astype(np.float32)
    got = tmb._causal_conv(torch.tensor(x), tb["conv_w"], tb["conv_b"])
    ref = jmb._causal_conv(jnp.asarray(x), jb["conv_w"], jb["conv_b"])
    _close(got, ref, "conv")


@pytest.mark.parametrize("S", [3, 11])
def test_apply_mamba_with_state(mamba_block, S):
    """The prefill forward, its conv tail and its final SSM state (fp32
    before the serving state rounds it)."""
    jcfg, jb, tcfg, tb = mamba_block
    x = np.random.default_rng(S).standard_normal((2, S, jcfg.d_model)).astype(np.float32)
    out, st = tmb.apply_mamba(tb, torch.tensor(x), tcfg, return_state=True)
    ref, rst = jmb.apply_mamba(jb, jnp.asarray(x), jcfg, return_state=True)
    _close(out, ref, "out")
    _close(st["conv"], rst["conv"], "conv tail")
    _close(st["ssm"], rst["ssm"], "ssm state")
    assert torch.equal(tmb.apply_mamba(tb, torch.tensor(x), tcfg), out)


def test_mamba_decode_over_bf16_state(mamba_block):
    """Decode steps over the bf16 serving state (fp32 compute): from the
    reference's own prefilled state, rounded to bf16, each step's output
    at the fp32 rung and the new bf16 state at the bf16 rung; the port's
    prefill rounds its state to the same bf16 values within a step."""
    jcfg, jb, tcfg, tb = mamba_block
    x = np.random.default_rng(4).standard_normal((2, 12, jcfg.d_model)).astype(np.float32)
    _, jnew = jmb.apply_mamba(jb, jnp.asarray(x[:, :9]), jcfg, return_state=True)
    js = {k: v.astype(jnp.bfloat16) for k, v in jnew.items()}
    _, tnew = tmb.apply_mamba(tb, torch.tensor(x[:, :9]), tcfg, return_state=True)
    tinit = tmb.mamba_init_state(tcfg, 2, device="cpu")
    assert all(t.dtype == torch.bfloat16 for t in tinit.values())
    for name in ("conv", "ssm"):
        _close(tnew[name].to(torch.bfloat16), js[name], f"prefill {name} in bf16",
               tol=BF16_RUNG)
    for t in range(9, 12):
        ts = {k: torch.tensor(np.asarray(v.astype(jnp.float32))).to(torch.bfloat16)
              for k, v in js.items()}
        to, tst = tmb.apply_mamba_decode(tb, torch.tensor(x[:, t:t + 1]), tcfg, state=ts)
        jo, js = jmb.apply_mamba_decode(jb, jnp.asarray(x[:, t:t + 1]), jcfg, state=js)
        _close(to, jo, f"decode out, token {t}")
        for name in ("conv", "ssm"):
            assert tst[name].dtype == torch.bfloat16
            _close(tst[name], js[name], f"decode {name}, token {t}", tol=BF16_RUNG)
