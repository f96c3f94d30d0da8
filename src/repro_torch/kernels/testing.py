"""Differential kernel-vs-plain-version harness (the subset of the
reference's ``kernels/testing.py`` the port uses).

Every CUDA kernel of the port has a plain PyTorch version with the same
signature; tests and ``chip_smoke.py`` run both on the same inputs and
compare through :func:`assert_kernel_matches` under the per-precision
:data:`TOLERANCE_LADDER` — the same rungs the reference uses, so "close
enough in bf16" means the same thing on both sides of the port.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple, Optional

import numpy as np
import torch


class Tol(NamedTuple):
    """Relative / absolute tolerance pair for one precision rung."""

    rtol: float
    atol: float


# One rung per compute precision. fp32 kernels accumulate in fp32 and
# differ from the plain version only by reassociation (~1e-6 observed;
# 5e-5 leaves headroom for unlucky shapes). bf16 inputs carry ~3 decimal
# digits, so anything tighter than ~1e-2 tests the rounding of the
# inputs, not the kernel.
TOLERANCE_LADDER: dict = {
    torch.float32: Tol(rtol=5e-5, atol=5e-5),
    torch.bfloat16: Tol(rtol=5e-2, atol=5e-2),
    torch.float16: Tol(rtol=5e-3, atol=5e-3),
}


def tolerance_for(dtype: torch.dtype, ladder: Optional[dict] = None) -> Tol:
    """The rung for ``dtype`` (KeyError for a precision without one)."""
    return (TOLERANCE_LADDER if ladder is None else ladder)[dtype]


class KernelError(NamedTuple):
    """How far a kernel's output is from its plain version's: the largest
    absolute difference, and the same divided by the reference's root
    mean square (what the gate compares; read it against a rung's atol)."""

    max_abs: float
    max_scaled: float


def compare_kernel(
    kernel_fn: Callable[..., torch.Tensor],
    ref_fn: Callable[..., torch.Tensor],
    args: tuple,
    *,
    dtype: Any = None,
    tol: Optional[Tol] = None,
    ref_args: Optional[tuple] = None,
    label: str = "",
) -> KernelError:
    """Run ``kernel_fn(*args)`` and ``ref_fn(*(ref_args or args))`` and
    assert they agree within the ladder rung for ``dtype`` (default: the
    kernel output's dtype). Both are compared in fp32 after dividing by
    the reference's root mean square, so the rung is a fraction of a
    typical output value whatever the outputs' magnitude. (The
    reference package divides by ``max(1, max|ref|)``; for outputs well
    below 1, or with a few large entries, that makes the atol term as
    large as a typical output, and a wrong bf16 kernel can pass.)
    Returns the unscaled and the scaled max abs error."""
    y = kernel_fn(*args)
    yr = ref_fn(*(args if ref_args is None else ref_args))
    name = label or getattr(kernel_fn, "__name__", "kernel")
    if tuple(y.shape) != tuple(yr.shape):
        raise AssertionError(f"{name}: kernel shape {tuple(y.shape)} != "
                             f"reference shape {tuple(yr.shape)}")
    if tol is None:
        tol = tolerance_for(y.dtype if dtype is None else dtype)
    yf = y.detach().float().cpu().numpy()
    yrf = yr.detach().float().cpu().numpy()
    assert_scaled_close(yf, yrf, tol, err_msg=f"{name}: kernel vs reference")
    return kernel_error(yf, yrf)


def kernel_error(y, yr) -> KernelError:
    """:class:`KernelError` of ``y`` against ``yr`` (arrays), no check."""
    y = np.asarray(y, np.float32)
    yr = np.asarray(yr, np.float32)
    if not y.size:
        return KernelError(0.0, 0.0)
    err = float(np.max(np.abs(y - yr)))
    return KernelError(err, err / _rms_scale(yr))


def assert_kernel_matches(kernel_fn, ref_fn, args: tuple, **kw) -> float:
    """:func:`compare_kernel`, returning the unscaled max abs error."""
    return compare_kernel(kernel_fn, ref_fn, args, **kw).max_abs


def _rms_scale(yr) -> float:
    rms = float(np.sqrt(np.mean(np.square(yr)))) if yr.size else 0.0
    return rms if rms > 0.0 else 1.0


def assert_scaled_close(y, yr, tol: Tol, err_msg: str = "") -> None:
    """``y`` and ``yr`` agree within ``tol`` after both are divided by
    the root mean square of ``yr`` (1 when ``yr`` is all zeros)."""
    y = np.asarray(y, np.float32)
    yr = np.asarray(yr, np.float32)
    scale = _rms_scale(yr)
    np.testing.assert_allclose(y / scale, yr / scale, rtol=tol.rtol, atol=tol.atol,
                               err_msg=f"{err_msg} (outputs scaled by 1/{scale:g})")


SCALE_PROFILES = ("unit", "extreme", "tiny", "huge", "alternating")


def scale_profile(kind: str, k: int, device="cpu") -> torch.Tensor:
    """A (k,) fp32 per-channel scale vector of the named shape (the
    reference's ``kernels/testing.py:scale_profile``): the int8 kernels
    must hold under scales spanning eight decades."""
    if kind == "unit":
        return torch.ones((k,), dtype=torch.float32, device=device)
    if kind == "extreme":
        return (10.0 ** torch.linspace(-4.0, 4.0, k, dtype=torch.float64,
                                       device=device)).float()
    if kind == "tiny":
        return torch.full((k,), 1e-4, dtype=torch.float32, device=device)
    if kind == "huge":
        return torch.full((k,), 1e4, dtype=torch.float32, device=device)
    if kind == "alternating":
        return torch.where(torch.arange(k, device=device) % 2 == 0, 1e-3, 1e3).float()
    raise ValueError(f"unknown scale profile {kind!r}; one of {SCALE_PROFILES}")


def ragged_seq_lens(batch: int, max_len: int, page: int, seed: int = 0,
                    device="cpu") -> torch.Tensor:
    """(batch,) int32 lengths covering the masking edge cases: slot 0
    empty (len 0, the inactive-slot convention), slot 1 on a page
    boundary, slot 2 one before a boundary, slot 3 full; the rest
    uniform. ``pos <= len`` is in-bounds, so ``max_len`` is the largest
    legal index. Same draws as the reference for the same seed."""
    edges = [0, min(page, max_len), min(2 * page - 1, max_len), max_len]
    rng = np.random.default_rng(seed)
    body = rng.integers(0, max_len + 1, size=max(0, batch - len(edges)))
    lens = np.concatenate([np.asarray(edges[:batch]), body])[:batch]
    return torch.tensor(lens, dtype=torch.int32, device=device)


def make_block_table(batch: int, n_pages_per_seq: int, num_pages: int,
                     seq_lens: torch.Tensor, page: int, seed: int = 0,
                     device="cpu") -> torch.Tensor:
    """(batch, n_pages_per_seq) int32 block table with shuffled physical
    page ids; pages past each row's live prefix point at the null page
    (id ``num_pages``). Same table as the reference for the same seed."""
    if batch * n_pages_per_seq > num_pages:
        raise ValueError("pool too small to fuzz")
    rng = np.random.default_rng(seed)
    perm = rng.permutation(num_pages)[: batch * n_pages_per_seq]
    table = perm.reshape(batch, n_pages_per_seq).astype(np.int32)
    lens = seq_lens.cpu().numpy()
    for i in range(batch):
        table[i, int(lens[i]) // page + 1:] = num_pages
    return torch.tensor(table, dtype=torch.int32, device=device)


MLSTM_PROFILES = ("unit", "stabiliser")


def mlstm_inputs(B: int, S: int, dh: int, profile: str, seed: int = 0, device="cpu",
                 with_state: bool = False):
    """(q, k, v, i_pre, f_pre, state) fp32 for the chunkwise mLSTM, drawn
    with numpy from ``seed``. q and k have mean 1 (k over sqrt(dh), as
    the model pre-scales it), so a score q.k keeps its sign: where the
    scores change sign, den = |sum_j w s| can cancel, and any two
    summation orders then disagree by the cancellation, not by the
    kernel. Gates: ``unit`` i ~ N(0, 1), f ~ N(1, 1); ``stabiliser``
    drives the running max: i uniform in [-20, 20], f at either
    saturation (8 + N(0, 1) or -8 + N(0, 1) at random). ``with_state``
    adds a state (C, n, m) that the plain version reaches over a
    37-token prefix of the same draw, else None."""
    from repro_torch.kernels.mlstm_ref import mlstm_chunk_ref

    if profile not in MLSTM_PROFILES:
        raise ValueError(f"unknown mLSTM profile {profile!r}; one of {MLSTM_PROFILES}")
    rng = np.random.default_rng(seed)
    P = 37 if with_state else 0

    def gates(n):
        if profile == "unit":
            return rng.standard_normal((B, n)), rng.standard_normal((B, n)) + 1.0
        sign = np.where(rng.random((B, n)) < 0.5, 1.0, -1.0)
        return rng.uniform(-20.0, 20.0, (B, n)), 8.0 * sign + rng.standard_normal((B, n))

    q = rng.standard_normal((B, P + S, dh)) + 1.0
    k = (rng.standard_normal((B, P + S, dh)) + 1.0) / np.sqrt(dh)
    v = rng.standard_normal((B, P + S, dh))
    i_pre, f_pre = gates(P + S)
    t = [torch.tensor(a, dtype=torch.float32, device=device) for a in (q, k, v, i_pre, f_pre)]
    state = None
    if with_state:
        _, state = mlstm_chunk_ref(*(x[:, :P] for x in t))
    return (*(x[:, P:].contiguous() for x in t), state)


MAMBA_PROFILES = ("unit", "underflow")


def mamba_inputs(b: int, S: int, di: int, ds: int, profile: str, *, dtype=torch.float32,
                 seed: int = 0, device="cpu"):
    """(u, dt, B, C, A, D) for the selective scan, drawn with numpy from
    ``seed``: u, dt (b, S, di) and B, C (b, S, ds) in ``dtype``; A (di,
    ds) and D (di,) fp32. A is the model's -(1..ds) a channel, each
    entry scaled by exp(0.3 N(0, 1)); B, C ~ N(0, 1 / 4); D ~ 1 + N(0,
    1 / 100). ``unit``: u ~ N(0, 1), dt = softplus(N(-1, 1)), the JAX
    package's test draws; ``underflow``: dt sized so that dt * A spans
    down to -27..-30 in every channel (exp(dt A) ~ 1e-13: the state forgets
    at once)."""
    if profile not in MAMBA_PROFILES:
        raise ValueError(f"unknown mamba profile {profile!r}; one of {MAMBA_PROFILES}")
    rng = np.random.default_rng(seed)
    A = -np.arange(1, ds + 1) * np.exp(0.3 * rng.standard_normal((di, ds)))
    u = rng.standard_normal((b, S, di))
    if profile == "unit":
        dt = np.log1p(np.exp(rng.standard_normal((b, S, di)) - 1.0))
    else:
        dt = rng.uniform(0.9, 1.0, (b, S, di)) * 30.0 / np.abs(A).max(axis=1)
    B = 0.5 * rng.standard_normal((b, S, ds))
    C = 0.5 * rng.standard_normal((b, S, ds))
    D = 1.0 + 0.1 * rng.standard_normal((di,))
    t = [torch.tensor(a, dtype=torch.float32, device=device) for a in (u, dt, B, C, A, D)]
    return (*(x.to(dtype) for x in t[:4]), t[4], t[5])
