"""Port vs reference: flash attention and the spectral matmul's gradient.

* The port's ``nn/attention.py:_flash`` (on the CPU: the plain
  ``kernels/flash_ref.py`` forward and backward) against the JAX
  package's ``_flash`` and its ``jax.vjp`` at s = 4096, where the model
  takes the flash branch, for rep 1 and 4 and head dims 16 and 64; and
  at MLA's widths, q/k wider than v: the reduced deepseek configs' (24,
  16) at s = 4096 and the full configs' (192, 128) at s = 256.
* ``flash_attention_ref`` (the reference's oracle, heads folded into
  the batch) against the reference's, and against the grouped path.
* The port's ``_sdpa`` against the reference's at s = 2048 (direct
  branch) and 4096 (flash branch), with a spy on each side's ``_flash``:
  both switch branch at the same length.
* The spectral matmul's autograd (dx, dU, ds, dV) against ``jax.vjp`` of
  ``repro.kernels.ops.spectral_matmul`` (its Pallas forward in interpret
  mode, as the reference's tests run it), fp32 factors with fp32 and
  bf16 x.
* The ladder check rejects a flash kernel that drops the last kv tile.

Tolerances are the ladder's, on outputs divided by the reference's RMS:
fp32 5e-5 (both sides sum in fp32; they differ by summation order),
bf16 5e-2 (inputs and the rounded p/ds carry ~3 significant digits).
"""
import math

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels.flash_ref import flash_attention_ref as jax_flash_attention_ref  # noqa: E402
from repro.kernels.ops import spectral_matmul as jax_spectral_matmul  # noqa: E402
from repro.nn import attention as jattn  # noqa: E402
from repro_torch.kernels.flash_ref import (  # noqa: E402
    flash_attention_ref,
    flash_bwd_ref,
    flash_fwd_ref,
)
from repro_torch.kernels.ops import spectral_matmul  # noqa: E402
from repro_torch.kernels.testing import (  # noqa: E402
    TOLERANCE_LADDER,
    assert_kernel_matches,
    assert_scaled_close,
)
from repro_torch.nn import attention as tattn  # noqa: E402

torch.set_num_threads(2)

DTYPES = {"float32": (torch.float32, jnp.float32), "bfloat16": (torch.bfloat16, jnp.bfloat16)}
S_FLASH = 4096


def _qkv(b, s, g, r, d, seed=0, dv=None):
    """q (b, s, g, r, d), k (b, s, g, d), v (b, s, g, dv), dout (b, s, g,
    r, dv); dv = d unless given."""
    dv = d if dv is None else dv
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, s, g, r, d)).astype(np.float32)
    k = rng.standard_normal((b, s, g, d)).astype(np.float32)
    v = rng.standard_normal((b, s, g, dv)).astype(np.float32)
    do = rng.standard_normal((b, s, g, r, dv)).astype(np.float32)
    return q, k, v, do


def _close(got, ref, dtype, what):
    assert_scaled_close(np.asarray(got.detach().float()), np.asarray(ref, np.float32),
                        TOLERANCE_LADDER[dtype], err_msg=what)


def _flash_against_reference(dtype, q, k, v, do):
    tdt, jdt = DTYPES[dtype]
    out_ref, vjp = jax.vjp(lambda a, b, c: jattn._flash(a, b, c, True),
                           *(jnp.asarray(x, jdt) for x in (q, k, v)))
    grads_ref = vjp(jnp.asarray(do, jdt))
    tq, tk, tv = (torch.tensor(x).to(tdt).requires_grad_() for x in (q, k, v))
    out = tattn._flash(tq, tk, tv, True)
    out.backward(torch.tensor(do).to(tdt))
    assert out.dtype == tdt and tq.grad.dtype == tdt and tk.grad.dtype == tdt
    assert out.shape == do.shape
    _close(out, out_ref, tdt, "out")
    for name, got, ref in zip(("dq", "dk", "dv"), (tq.grad, tk.grad, tv.grad), grads_ref):
        assert got.shape == ref.shape, name
        _close(got, ref, tdt, name)


@pytest.mark.parametrize("d", [16, 64])
@pytest.mark.parametrize("rep", [1, 4])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_flash_matches_reference_forward_and_vjp(dtype, rep, d):
    _flash_against_reference(dtype, *_qkv(1, S_FLASH, 1, rep, d))


@pytest.mark.parametrize("s, g, dk, dv", [(S_FLASH, 2, 24, 16), (256, 2, 192, 128)],
                         ids=["reduced-24x16-s4096", "full-192x128-s256"])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_flash_matches_reference_at_mla_widths(dtype, s, g, dk, dv):
    """MLA's expanded form: q and k nope + rope wide, v v_head_dim wide (r
    1, k expanded to every head): out and dv are dv wide, dq and dk dk
    wide, the scale 1 / sqrt(dk), against jax.vjp of the reference's
    ``_flash`` at the ladder's rungs."""
    _flash_against_reference(dtype, *_qkv(1, s, g, 1, dk, seed=8, dv=dv))


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_flash_attention_oracle_matches_reference_and_the_flash_path(dtype):
    """``flash_attention_ref`` (heads folded into the batch, as the TPU
    kernel takes them) against the reference's oracle, and against the
    model's grouped flash path on the same numbers."""
    tdt, jdt = DTYPES[dtype]
    q, k, v, _ = _qkv(1, 192, 3, 1, 16, seed=4)
    folded = [x.transpose(0, 2, 3, 1, 4).reshape(3, 192, 16) if x.ndim == 5
              else x.transpose(0, 2, 1, 3).reshape(3, 192, 16) for x in (q, k, v)]
    got = flash_attention_ref(*(torch.tensor(x).to(tdt) for x in folded))
    _close(got, jax_flash_attention_ref(*(jnp.asarray(x, jdt) for x in folded)), tdt, "oracle")
    grouped = flash_fwd_ref(*(torch.tensor(x).to(tdt) for x in (q, k, v)))[0]
    _close(got, grouped[0, :, :, 0].transpose(0, 1).float(), tdt, "grouped vs folded")


def test_flash_statistics_match_reference():
    """m and l (the backward's residuals) equal the reference's, moved
    from its (nq, b, g, r, cq) chunk layout to (b, s, g, r)."""
    q, k, v, _ = _qkv(1, S_FLASH, 2, 2, 16, seed=3)
    _, m_ref, l_ref = jattn._flash_fwd_impl(*(jnp.asarray(x) for x in (q, k, v)), True)
    _, m, l = flash_fwd_ref(*(torch.tensor(x) for x in (q, k, v)), True)

    def layout(a):   # (nq, b, g, r, cq) -> (b, nq * cq, g, r)
        a = np.asarray(a)
        nq, b, g, r, cq = a.shape
        return a.transpose(1, 0, 4, 2, 3).reshape(b, nq * cq, g, r)

    np.testing.assert_allclose(m.numpy(), layout(m_ref), rtol=5e-5, atol=5e-5)
    np.testing.assert_allclose(l.numpy(), layout(l_ref), rtol=5e-5, atol=5e-5)


@pytest.mark.parametrize("s", [2048, S_FLASH])
def test_sdpa_switches_branch_with_the_reference(s, monkeypatch):
    b, h, kvh, d = 1, 4, 2, 16
    rng = np.random.default_rng(1)
    q = rng.standard_normal((b, s, h, d)).astype(np.float32)
    k = rng.standard_normal((b, s, kvh, d)).astype(np.float32)
    v = rng.standard_normal((b, s, kvh, d)).astype(np.float32)
    calls = {"jax": 0, "port": 0}

    def spy(mod, key):
        inner = mod._flash

        def wrapped(*a, **kw):
            calls[key] += 1
            return inner(*a, **kw)
        monkeypatch.setattr(mod, "_flash", wrapped)

    spy(jattn, "jax")
    spy(tattn, "port")
    ref = jattn._sdpa(*(jnp.asarray(x) for x in (q, k, v)), causal=True)
    got = tattn._sdpa(*(torch.tensor(x) for x in (q, k, v)), causal=True)
    flash = s > jattn.FLASH_THRESHOLD
    assert calls == {"jax": int(flash), "port": int(flash)}
    assert tattn.FLASH_THRESHOLD == jattn.FLASH_THRESHOLD
    assert (tattn.FLASH_Q_CHUNK, tattn.FLASH_KV_CHUNK) == (jattn.FLASH_Q_CHUNK,
                                                           jattn.FLASH_KV_CHUNK)
    _close(got, ref, torch.float32, f"_sdpa at s={s}")


def _spectral_inputs(M, m, n, k, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((M, m)).astype(np.float32)
    U = (rng.standard_normal((m, k)) / math.sqrt(m)).astype(np.float32)
    s = rng.uniform(0.1, 1.0, size=(k,)).astype(np.float32)
    V = (rng.standard_normal((n, k)) / math.sqrt(k)).astype(np.float32)
    dy = rng.standard_normal((M, n)).astype(np.float32)
    return x, U, s, V, dy


@pytest.mark.parametrize("x_dtype", list(DTYPES))
@pytest.mark.parametrize("shape", [(37, 64, 96, 16), (64, 256, 128, 32)],
                         ids=lambda s: "x".join(map(str, s)))
def test_spectral_gradients_match_reference_vjp(shape, x_dtype):
    """fp32 factors (the legacy masters); x and dy in fp32 or bf16. The
    gradients come back in each input's dtype on both sides."""
    tdt, jdt = DTYPES[x_dtype]
    x, U, s, V, dy = _spectral_inputs(*shape)
    y_ref, vjp = jax.vjp(jax_spectral_matmul, jnp.asarray(x, jdt), jnp.asarray(U),
                         jnp.asarray(s), jnp.asarray(V))
    grads_ref = vjp(jnp.asarray(dy, jdt))
    tx = torch.tensor(x).to(tdt).requires_grad_()
    tU, ts, tV = (torch.tensor(a).requires_grad_() for a in (U, s, V))
    y = spectral_matmul(tx, tU, ts, tV)
    y.backward(torch.tensor(dy).to(tdt))
    assert y.dtype == tdt and tx.grad.dtype == tdt
    assert tU.grad.dtype == ts.grad.dtype == tV.grad.dtype == torch.float32
    _close(y, y_ref, tdt, "y")
    for name, got, ref in zip(("dx", "dU", "ds", "dV"),
                              (tx.grad, tU.grad, ts.grad, tV.grad), grads_ref):
        _close(got, ref, tdt if name == "dx" else torch.float32, name)


def _drop_last_kv_tile(q, k, v, causal=True):
    """A faulty forward: the last 64 kv positions never reach the sum."""
    k, v = k.clone(), v.clone()
    k[:, -64:] = 0
    v[:, -64:] = 0
    return flash_fwd_ref(q, k, v, causal)[0]


def test_ladder_check_rejects_faulty_kernel():
    """The bf16 flash check at the training shape's head dim fails a
    kernel that drops the last kv tile."""
    q, k, v, _ = (torch.tensor(a).bfloat16() for a in _qkv(1, 1024, 2, 2, 64))
    fwd = lambda *a: flash_fwd_ref(*a)[0]  # noqa: E731
    assert_kernel_matches(fwd, fwd, (q, k, v))
    with pytest.raises(AssertionError):
        assert_kernel_matches(_drop_last_kv_tile, fwd, (q, k, v))


def test_flash_backward_ref_matches_autograd_of_direct_attention():
    """The recompute-p backward equals autograd through the direct
    softmax at fp32 (a second oracle, independent of the reference)."""
    q, k, v, do = (torch.tensor(a).double() for a in _qkv(1, 96, 2, 3, 16, seed=5))
    q, k, v = (t.float().requires_grad_() for t in (q, k, v))
    out = tattn._sdpa_direct(q, k, v, causal=True)
    out.backward(do.float())
    o, m, l = flash_fwd_ref(q.detach(), k.detach(), v.detach())
    dq, dk, dv = flash_bwd_ref(q.detach(), k.detach(), v.detach(), o, m, l, do.float())
    for got, ref in ((o, out), (dq, q.grad), (dk, k.grad), (dv, v.grad)):
        assert_scaled_close(got.numpy(), ref.detach().numpy(), TOLERANCE_LADDER[torch.float32])
