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


def assert_scaled_close(y, yr, tol: Tol, err_msg: str = "",
                        scale: Optional[float] = None) -> None:
    """``y`` and ``yr`` agree within ``tol`` after both are divided by
    ``scale``, by default the root mean square of ``yr`` (1 when ``yr`` is
    all zeros)."""
    y = np.asarray(y, np.float32)
    yr = np.asarray(yr, np.float32)
    scale = _rms_scale(yr) if scale is None else scale
    np.testing.assert_allclose(y / scale, yr / scale, rtol=tol.rtol, atol=tol.atol,
                               err_msg=f"{err_msg} (outputs scaled by 1/{scale:g})")


# (M, m, n, k) of the spectral matmul's checks: ragged shapes, one row to a
# prefill-sized batch, ranks 8-256, and the main paths' projections
SPECTRAL_SHAPES = [
    (1, 64, 96, 16), (7, 130, 50, 8), (37, 300, 700, 64), (64, 128, 128, 128),
    (8, 2048, 8192, 128), (37, 8192, 2048, 128), (160, 2048, 8192, 128),
    (3, 512, 384, 256),
    # xlstm-1.3b's projections at decode (4 slots) and a 160-token prefill:
    # up 2048->8192, down 4096->2048, ff_up 2048->5460, ff_down 2730->2048
    (4, 2048, 8192, 128), (160, 4096, 2048, 128), (4, 2048, 5460, 128),
    (160, 2730, 2048, 128),
    # jamba-v0.1-52b's MLPs at the kernels' largest rank: up/gate
    # 4096->14336 and down 14336->4096 at decode and a 160-token prefill
    (4, 4096, 14336, 256), (160, 4096, 14336, 256), (4, 14336, 4096, 256),
    (160, 14336, 4096, 256),
    # smollm2-1.7b's MLP in training (b 2 x s 4096 rows): up, down
    (8192, 2048, 8192, 128), (8192, 8192, 2048, 128)]

# (M, m, n, k) of the int8 spectral matmul's checks (its rank is a multiple
# of 16): ragged shapes, and the int8 serving cells' MLP (llama3.2-1b's
# 2048 <-> 8192, rank 128) at decode, a prefill chunk and a larger batch
SPECTRAL_Q8_SHAPES = [
    (1, 64, 96, 16), (7, 130, 50, 16), (37, 300, 700, 64), (4, 2048, 8192, 128),
    (37, 8192, 2048, 128), (256, 2048, 8192, 128), (3, 512, 384, 256)]

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


NOISE_FACTOR = 4


def noise_scale(yr, yr_alt, tol: Tol, factor: float = NOISE_FACTOR) -> float:
    """The scale an error against the plain version ``yr`` is divided by:
    its RMS, or ``factor`` times its distance to ``yr_alt`` (the same plain
    version with its sums taken in another order) over the rung's atol,
    where that is larger. The second is for an output that is zero in
    exact arithmetic and rounding noise in fp32 (the mLSTM's dq and dk at
    one token, where y_t = v_t whatever q and k are): its RMS is the noise,
    and any two orders disagree by all of it."""
    yr = np.asarray(yr, np.float32)
    if not yr.size:
        return 1.0
    diff = float(np.max(np.abs(yr - np.asarray(yr_alt, np.float32))))
    return max(_rms_scale(yr), factor * diff / tol.atol)


def mlstm_bwd_reordered(q, k, v, i_pre, f_pre, state, y, dy, dC=None, dn=None, dm=None):
    """The plain mLSTM backward with the head dimension reversed on the way
    in and back on the way out: the same gradients, every fp32 sum over dh
    taken in another order (for :func:`noise_scale`). Returns the list
    (dq, dk, dv, di, df[, dC0, dn0, dm0])."""
    from repro_torch.kernels.mlstm_ref import mlstm_chunk_bwd_ref

    def flip(t, dims):
        return None if t is None else torch.flip(t, dims)

    st = None if state is None else (flip(state[0], (1, 2)), flip(state[1], (1,)), state[2])
    g = mlstm_chunk_bwd_ref(*(flip(t, (2,)) for t in (q, k, v)), i_pre, f_pre, st,
                            flip(y, (2,)), flip(dy, (2,)), flip(dC, (1, 2)), flip(dn, (1,)), dm)
    out = [flip(t, (2,)) for t in g[:3]] + list(g[3:5])
    if g[5] is not None:
        out += [flip(g[5][0], (1, 2)), flip(g[5][1], (1,)), g[5][2]]
    return out


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


def mamba_model_layout(u, dt, B, C, A, D, *, dt_rank: int = 256, seed: int = 0):
    """The scan's inputs in the layout the model hands over
    (``nn/mamba.py:_mamba_ssm_params``): B and C column views of one (b, S,
    dt_rank + 2 ds) projection in u's dtype (its dt columns drawn from
    ``seed``), A and D in u's dtype. The values of B and C are kept."""
    b, S, ds = B.shape
    rng = np.random.default_rng(seed)
    proj = torch.tensor(rng.standard_normal((b, S, dt_rank + 2 * ds)), dtype=torch.float32,
                        device=u.device).to(u.dtype)
    proj[..., dt_rank:dt_rank + ds] = B
    proj[..., dt_rank + ds:] = C
    return (u, dt, proj[..., dt_rank:dt_rank + ds], proj[..., dt_rank + ds:], A.to(u.dtype),
            D.to(u.dtype))


def gqa_inputs(seq_lens, n_pages: int, kvh: int, rep: int, hd: int, page: int, *,
               dtype=torch.float32, null_slot: bool = False, p_cold: Optional[float] = None,
               seed: int = 0, device="cpu"):
    """Inputs of the paged GQA decode, drawn with numpy from ``seed``: q
    (b, kvh, rep, hd) ~ N(0, 1) in ``dtype``; pools k, v (P+1, page, kvh,
    hd) ~ N(0, 1) in bf16 everywhere (the null page included), P = b
    n_pages + 3; a shuffled block table whose rows end in null pages
    (:func:`make_block_table`); ``seq_lens`` (b,) int32. With
    ``null_slot`` slot 0 becomes an inactive slot (null page, length 0).
    Returns (q, k_pool, v_pool, block_table, seq_lens); with ``p_cold``
    (q, k_pool, v_pool, k_q8, k_scale, v_q8, v_scale, block_table,
    seq_lens, cold_flags): int8 shadows quantized per page from
    independent noise (a read of the wrong tier misses by O(1)) and cold
    flags drawn with probability ``p_cold``."""
    from repro_torch.serving.quantize import quantize_kv_pages

    b = len(seq_lens)
    num_pages = b * n_pages + 3
    rng = np.random.default_rng(seed)
    sl = torch.tensor(np.asarray(seq_lens), dtype=torch.int32)
    bt = make_block_table(b, n_pages, num_pages, sl, page, seed=seed)
    if null_slot:
        bt[0, :] = num_pages
        sl[0] = 0

    def draw(*shape):
        return torch.tensor(rng.standard_normal(shape, dtype=np.float32), device=device)

    shape = (num_pages + 1, page, kvh, hd)
    out = [draw(b, kvh, rep, hd).to(dtype), draw(*shape).to(torch.bfloat16),
           draw(*shape).to(torch.bfloat16)]
    if p_cold is not None:
        for _ in range(2):
            qt = quantize_kv_pages(draw(*shape), token_axis=1)
            out += [qt["q8"], qt["scale"]]
    out += [bt.to(device), sl.to(device)]
    if p_cold is not None:
        out.append(torch.tensor(rng.uniform(size=num_pages + 1) < p_cold, dtype=torch.int32,
                                device=device))
    return tuple(out)


def mla_inputs(seq_lens, n_pages: int, h: int, lat: int, rope: int, page: int, *,
               dtype=torch.float32, null_slot: bool = False, p_cold: Optional[float] = None,
               seed: int = 0, device="cpu"):
    """Inputs of the absorbed-MLA paged decode, drawn with numpy from
    ``seed``: q_lat (b, h, lat) and q_rope (b, h, rope) ~ N(0, 1) in
    ``dtype``; latent pools ckv (P+1, page, lat) and kr (P+1, page, rope)
    ~ N(0, 1) in bf16 everywhere (the null page included), P = b n_pages
    + 3; a shuffled block table whose rows end in null pages
    (:func:`make_block_table`); ``seq_lens`` (b,) int32. With
    ``null_slot`` slot 0 becomes an inactive slot (null page, length 0).
    Returns (q_lat, q_rope, ckv, kr, block_table, seq_lens); with
    ``p_cold`` (q_lat, q_rope, ckv, kr, ckv_q8, ckv_scale, kr_q8, kr_scale,
    block_table, seq_lens, cold_flags): int8 shadows quantized per page
    from independent noise (a read of the wrong tier misses by O(1)) and
    cold flags drawn with probability ``p_cold``."""
    from repro_torch.serving.quantize import quantize_kv_pages

    b = len(seq_lens)
    num_pages = b * n_pages + 3
    rng = np.random.default_rng(seed)
    sl = torch.tensor(np.asarray(seq_lens), dtype=torch.int32)
    bt = make_block_table(b, n_pages, num_pages, sl, page, seed=seed)
    if null_slot:
        bt[0, :] = num_pages
        sl[0] = 0

    def draw(*shape):
        return torch.tensor(rng.standard_normal(shape), dtype=torch.float32, device=device)

    q_lat, q_rope = draw(b, h, lat).to(dtype), draw(b, h, rope).to(dtype)
    ckv, kr = draw(num_pages + 1, page, lat), draw(num_pages + 1, page, rope)
    out = [q_lat, q_rope, ckv.to(torch.bfloat16), kr.to(torch.bfloat16)]
    if p_cold is not None:
        for src in (draw(*ckv.shape), draw(*kr.shape)):
            qt = quantize_kv_pages(src, token_axis=1)
            out += [qt["q8"], qt["scale"]]
    out += [bt.to(device), sl.to(device)]
    if p_cold is not None:
        out.append(torch.tensor(rng.uniform(size=num_pages + 1) < p_cold, dtype=torch.int32,
                                device=device))
    return tuple(out)
