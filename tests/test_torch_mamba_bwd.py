"""Port vs reference: the backward of the selective scan (the plain
version of the kernel ``csrc/mamba_scan_bwd.cu``) on the CPU.

* ``mamba_scan_bwd_ref`` (the kernel's algorithm in torch ops: the states
  recomputed over each recorded stretch, the reverse recurrence, the sums
  over channels in the kernel's order) against autograd through the
  forward's plain version ``mamba_scan_ref`` at the fp32 rung (5e-5 of the
  reference's RMS, ``kernels/testing.py:TOLERANCE_LADDER``), and against
  ``jax.vjp`` of the reference model's scan (``repro.nn.mamba._ssm_scan``)
  in fp32 at 1e-4 of the reference's RMS: both accumulate in fp32 and
  differ by summation order (autograd's and XLA's against the kernel's
  trees) and by their ``exp``.
* S in {1, 3, 31, 32, 33, 64, 100} (across the 32-step stretches and, at
  d_state 64, the 8-step ones), d_state in {4, 16, 64}, the unit dt
  profile and one that drives dt * A to -30, with and without a gradient
  of the final state.
* The recorded states, the model's layout (A and D in u's dtype, B and C
  column views of one projection), and the wrapper under autograd on CPU
  tensors (the plain versions, no kernel counted).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.nn import mamba as jmb  # noqa: E402
from repro_torch.kernels.build import LAUNCHES  # noqa: E402
from repro_torch.kernels.mamba_ref import (  # noqa: E402
    mamba_scan_bwd_ref,
    mamba_scan_fwd_ref,
    mamba_scan_ref,
    record_steps,
)
from repro_torch.kernels.mamba_scan import mamba_scan  # noqa: E402
from repro_torch.kernels.testing import (  # noqa: E402
    MAMBA_PROFILES,
    Tol,
    assert_scaled_close,
    mamba_inputs,
    mamba_model_layout,
)

torch.set_num_threads(2)

RUNG = Tol(rtol=5e-5, atol=5e-5)      # the fp32 rung, RMS-scaled
GRAD = Tol(rtol=1e-4, atol=1e-4)      # against the reference's fp32 vjp
SEQS = (1, 3, 31, 32, 33, 64, 100)
STATES = (4, 16, 64)
B, DI = 2, 40                         # a ragged block of channels (32 + 8)
NAMES = ("du", "ddt", "dB", "dC", "dA", "dD")


def _close(got, ref, tol, what):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else got
    assert_scaled_close(np.asarray(got, np.float32), np.asarray(ref, np.float32), tol,
                        err_msg=what)


def _cotangents(y, h, finals, seed):
    rng = np.random.default_rng(seed)
    dy = torch.tensor(rng.standard_normal(tuple(y.shape)), dtype=torch.float32)
    dh = torch.tensor(rng.standard_normal(tuple(h.shape)), dtype=torch.float32)
    return dy, (dh if finals else None)


@jax.jit
def _jax_vjp(args, cot):
    """jax.vjp of the reference model's scan, compiled once a shape."""
    return jax.vjp(jmb._ssm_scan, *args)[1](cot)


def _case(S, ds, profile, finals):
    args = mamba_inputs(B, S, DI, ds, profile, seed=S + ds)
    y, h, starts = mamba_scan_fwd_ref(*args)
    dy, dh = _cotangents(y, h, finals, S + 1)
    return args, starts, dy, dh


@pytest.mark.parametrize("finals", [False, True], ids=["dy", "dy+dhT"])
@pytest.mark.parametrize("profile", MAMBA_PROFILES)
@pytest.mark.parametrize("ds", STATES)
@pytest.mark.parametrize("S", SEQS)
def test_bwd_ref_vs_autograd(S, ds, profile, finals):
    """The plain backward against autograd through the plain forward, at
    the fp32 rung."""
    args, starts, dy, dh = _case(S, ds, profile, finals)
    leaves = [t.clone().requires_grad_() for t in args]
    y, h = mamba_scan_ref(*leaves)
    loss = (y * dy).sum() + ((h * dh).sum() if finals else 0.0)
    ref = torch.autograd.grad(loss, leaves)
    got = mamba_scan_bwd_ref(*args, starts, dy, dh)
    for name, g, r, x in zip(NAMES, got, ref, args):
        assert g.dtype == x.dtype and g.shape == x.shape, name
        _close(g, r.numpy(), RUNG, f"{name} S={S} ds={ds} {profile}")


@pytest.mark.parametrize("finals", [False, True], ids=["dy", "dy+dhT"])
@pytest.mark.parametrize("profile", MAMBA_PROFILES)
@pytest.mark.parametrize("ds", STATES)
@pytest.mark.parametrize("S", SEQS)
def test_bwd_ref_vs_jax_vjp(S, ds, profile, finals):
    """The plain backward against jax.vjp of the reference model's scan,
    fp32, at 1e-4 of the reference's RMS."""
    args, starts, dy, dh = _case(S, ds, profile, finals)
    dhT = np.zeros((B, DI, ds), np.float32) if dh is None else dh.numpy()
    ref = _jax_vjp(tuple(jnp.asarray(t.numpy()) for t in args),
                   (jnp.asarray(dy.numpy()), jnp.asarray(dhT)))
    got = mamba_scan_bwd_ref(*args, starts, dy, dh)
    for name, g, r in zip(NAMES, got, ref):
        assert np.asarray(r).dtype == np.float32
        _close(g, np.asarray(r), GRAD, f"{name} S={S} ds={ds} {profile}")


@pytest.mark.parametrize("ds", STATES)
@pytest.mark.parametrize("S", [1, 31, 33, 100])
def test_recorded_states(S, ds):
    """starts[:, k] is the state before step k R (R = record_steps(ds); zero
    for k = 0), the forward's own values; y and hT are mamba_scan_ref's."""
    args = mamba_inputs(B, S, DI, ds, "unit", seed=S)
    y, h, starts = mamba_scan_fwd_ref(*args)
    R = record_steps(ds)
    assert starts.shape == (B, -(-S // R), DI, ds) and starts.dtype == torch.float32
    assert not bool(starts[:, 0].any())
    for k in range(1, starts.shape[1]):
        _, hk = mamba_scan_ref(*(t[:, :k * R] for t in args[:4]), *args[4:])
        assert torch.equal(starts[:, k], hk)
    yr, hr = mamba_scan_ref(*args)
    assert torch.equal(y, yr) and torch.equal(h, hr)


def test_record_steps_fit_the_kernel():
    """32 steps a stretch up to d_state 16, 512 / d_state above: the
    stretch's states and exps fit 128 KB, and a stretch is a whole number
    of the forward's 32-step tiles' groups."""
    for ds, R in ((4, 32), (8, 32), (16, 32), (32, 16), (64, 8)):
        assert record_steps(ds) == R
        assert 2 * R * 32 * ds * 4 <= 128 * 1024 and 32 % R == 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_bwd_ref_on_the_model_layout(dtype):
    """A and D in u's dtype and B, C column views of one projection: the
    gradients of the contiguous layout with fp32 A and D, rounded to each
    input's dtype (dA and dD the same fp32 sums)."""
    args = mamba_inputs(B, 45, DI, 16, "unit", dtype=dtype, seed=5)
    model = mamba_model_layout(*args, dt_rank=8)
    assert model[2].stride(-1) == 1 and model[2].stride(1) == 8 + 2 * 16
    y, h, starts = mamba_scan_fwd_ref(*model)
    dy, _ = _cotangents(y, h, False, 6)
    got = mamba_scan_bwd_ref(*model, starts, dy.to(dtype))
    ref = mamba_scan_bwd_ref(*args[:4], model[4].float(), model[5].float(), starts,
                             dy.to(dtype))
    for name, g, r, x in zip(NAMES, got, ref, model):
        assert g.dtype == x.dtype and g.is_contiguous(), name
        assert torch.equal(g, r.to(x.dtype)), name


def test_wrapper_backward_on_cpu_is_the_plain_version():
    """Under autograd on CPU tensors mamba_scan's backward is
    mamba_scan_bwd_ref on the recorded states, with the final state's
    gradient where a loss reads it; no kernel launch is counted."""
    args = mamba_inputs(B, 70, DI, 16, "unit", seed=7)
    model = mamba_model_layout(*(t.to(torch.bfloat16) for t in args[:4]), *args[4:], dt_rank=8)
    leaves = [model[0].clone().requires_grad_(), model[1].clone().requires_grad_()]
    proj = model[2]._base.clone().requires_grad_()
    Bv, Cv = proj[..., 8:24], proj[..., 24:]
    AD = [model[4].clone().requires_grad_(), model[5].clone().requires_grad_()]
    before = (LAUNCHES["mamba_scan"], LAUNCHES["mamba_scan_bwd"])
    y, h = mamba_scan(*leaves, Bv, Cv, *AD)
    dy, dh = _cotangents(y, h, True, 8)
    grads = torch.autograd.grad((y.float() * dy).sum() + (h * dh).sum(), [*leaves, proj, *AD])
    assert (LAUNCHES["mamba_scan"], LAUNCHES["mamba_scan_bwd"]) == before
    _, _, starts = mamba_scan_fwd_ref(*model)
    du, ddt, dB, dC, dA, dD = mamba_scan_bwd_ref(*model, starts, dy.to(torch.bfloat16), dh)
    for g, r in zip((*grads[:2], *grads[3:]), (du, ddt, dA, dD)):
        assert g.dtype == r.dtype and torch.equal(g, r)
    assert torch.equal(grads[2][..., 8:24], dB) and torch.equal(grads[2][..., 24:], dC)
    assert not bool(grads[2][..., :8].any())
