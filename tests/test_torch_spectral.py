"""Port vs reference: the fused spectral matmul.

The port's wrapper (``repro_torch.kernels.ops.spectral_matmul``) runs its
plain version on CPU tensors; it is held against the reference's
``kernels/ops.spectral_matmul``, which runs its Pallas kernel in
interpret mode on the CPU (as tests/test_kernels.py runs it). Inputs are
drawn once with numpy and fed to both.

Tolerances are the ladder's (``kernels/testing.py``), applied to outputs
scaled by the reference's RMS: fp32 5e-5 (both accumulate in fp32 and
differ only by summation order), bf16 5e-2 (inputs carry ~3 significant
digits; both keep h in fp32 and round it once). The CUDA kernel itself
is held against the same plain version on the card by chip_smoke.py and
by tests/test_torch_kernels_cuda.py.
"""
import math

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core.spectral import spectral_apply as jax_spectral_apply  # noqa: E402
from repro.kernels.ops import spectral_matmul as jax_spectral_matmul  # noqa: E402
from repro_torch.core.spectral import is_spectral, spectral_apply, spectral_init  # noqa: E402
from repro_torch.kernels.build import LAUNCHES  # noqa: E402
from repro_torch.kernels.ops import spectral_matmul  # noqa: E402
from repro_torch.kernels.ref import spectral_matmul_ref  # noqa: E402
from repro_torch.kernels.spectral_matmul import spectral_matmul_cuda  # noqa: E402
from repro_torch.kernels.testing import (  # noqa: E402
    TOLERANCE_LADDER,
    assert_kernel_matches,
    assert_scaled_close,
)

torch.set_num_threads(2)

# (M, m, n, k): ragged everywhere — M below/above the kernel's row
# blocks, m/n off every tile multiple, k from tiny to k == m
SHAPES = [
    (1, 64, 96, 16),
    (7, 130, 50, 8),
    (37, 300, 700, 64),
    (64, 128, 128, 128),
]

DTYPES = {"float32": (torch.float32, jnp.float32), "bfloat16": (torch.bfloat16, jnp.bfloat16)}


def _inputs(M, m, n, k, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((M, m)).astype(np.float32)
    U = (rng.standard_normal((m, k)) / math.sqrt(m)).astype(np.float32)
    s = rng.uniform(0.0, 1.0, size=(k,)).astype(np.float32)
    V = (rng.standard_normal((n, k)) / math.sqrt(n)).astype(np.float32)
    return x, U, s, V


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_spectral_matmul_matches_reference_kernel(shape, dtype):
    tdt, jdt = DTYPES[dtype]
    x, U, s, V = _inputs(*shape)
    launches = LAUNCHES["spectral_matmul"]
    y = spectral_matmul(torch.tensor(x).to(tdt), torch.tensor(U), torch.tensor(s),
                        torch.tensor(V))
    assert LAUNCHES["spectral_matmul"] == launches   # CPU tensors: plain version
    assert y.dtype == tdt and tuple(y.shape) == (shape[0], shape[2])
    yr = jax_spectral_matmul(jnp.asarray(x, jdt), jnp.asarray(U), jnp.asarray(s),
                             jnp.asarray(V))
    assert_scaled_close(y.float().numpy(), np.asarray(yr, np.float32), TOLERANCE_LADDER[tdt])


def test_spectral_matmul_leading_dims():
    x, U, s, V = _inputs(6, 64, 96, 8)
    xt = torch.tensor(x).reshape(2, 3, 64)
    y = spectral_matmul(xt, torch.tensor(U), torch.tensor(s), torch.tensor(V))
    assert tuple(y.shape) == (2, 3, 96)
    yr = jax_spectral_matmul(jnp.asarray(x).reshape(2, 3, 64), jnp.asarray(U),
                             jnp.asarray(s), jnp.asarray(V))
    assert_scaled_close(y.numpy(), np.asarray(yr), TOLERANCE_LADDER[torch.float32])


def test_spectral_apply_matches_reference():
    """The three-matmul chain (the library yardstick) is the reference's
    ``spectral_apply`` in fp32."""
    x, U, s, V = _inputs(5, 48, 80, 12)
    y = spectral_apply({"U": torch.tensor(U), "s": torch.tensor(s), "V": torch.tensor(V)},
                       torch.tensor(x))
    yr = jax_spectral_apply({"U": jnp.asarray(U), "s": jnp.asarray(s), "V": jnp.asarray(V)},
                            jnp.asarray(x))
    assert_scaled_close(y.numpy(), np.asarray(yr), TOLERANCE_LADDER[torch.float32])


def test_spectral_init_is_orthonormal_and_scaled():
    g = torch.Generator().manual_seed(0)
    p = spectral_init(96, 40, 16, generator=g, device=torch.device("cpu"))
    assert is_spectral(p)
    eye = torch.eye(16)
    assert torch.allclose(p["U"].T @ p["U"], eye, atol=1e-5)
    assert torch.allclose(p["V"].T @ p["V"], eye, atol=1e-5)
    # ||W||_F^2 = ||s||^2 = m * n / m (LeCun fan-in)
    assert abs(float((p["s"] ** 2).sum()) - 40.0) < 1e-3
    assert bool((p["s"][:-1] >= p["s"][1:]).all())


def test_wrapper_rejects_unknown_devices():
    x, U, s, V = (torch.tensor(a) for a in _inputs(2, 16, 16, 4))
    with pytest.raises(ValueError):
        spectral_matmul(x.to("meta"), U.to("meta"), s.to("meta"), V.to("meta"))


def test_cuda_wrapper_rejects_factors_it_cannot_vectorize():
    """The kernel reads U and V in 16-byte vectors: a rank that leaves a
    partial vector, or a misaligned factor, raises before any launch."""
    x, U, s, V = (torch.tensor(a) for a in _inputs(2, 16, 16, 4))
    with pytest.raises(ValueError, match="multiple of 8"):
        spectral_matmul_cuda(x.bfloat16(), U.bfloat16(), s, V.bfloat16())
    x, U, s, V = (torch.tensor(a) for a in _inputs(2, 16, 16, 8))
    U_off = torch.empty(U.numel() + 1)[1:].view_as(U).copy_(U)   # 4 bytes past a vector
    with pytest.raises(ValueError, match="aligned"):
        spectral_matmul_cuda(x, U_off, s, V)


def _drop_m_tail(x, U, s, V):
    return spectral_matmul_ref(x[:, :-1].contiguous(), U[:-1].contiguous(), s, V)


def _widen16_order(x, U, s, V):
    n, k = V.shape
    return spectral_matmul_ref(x, U, s, V.view(n, k // 2, 2).flip(-1).reshape(n, k))


@pytest.mark.parametrize("fault", [_drop_m_tail, _widen16_order], ids=lambda f: f.__name__[1:])
def test_ladder_check_rejects_faulty_kernel(fault):
    """The bf16 kernel-vs-plain check at the main path's MLP shape fails
    a kernel that drops the last row of the m-reduction, or that swaps
    the bf16 pairs it widens: outputs are scaled by their RMS, so the
    rung is 5% of a typical output value."""
    x, U, s, V = (torch.tensor(a).bfloat16() for a in _inputs(8, 2048, 8192, 128))
    s = s.float()
    assert_kernel_matches(spectral_matmul_ref, spectral_matmul_ref, (x, U, s, V))
    with pytest.raises(AssertionError):
        assert_kernel_matches(fault, spectral_matmul_ref, (x, U, s, V))
