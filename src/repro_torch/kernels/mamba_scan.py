"""Selective scan: the CUDA kernel (``csrc/mamba_scan.cu``), which
replaces the JAX package's ``kernels/mamba_scan.py:52``
``mamba_scan_pallas``, its backward (``csrc/mamba_scan_bwd.cu``, which
replaces differentiating the reference model's ``_ssm_scan`` under
``jax.grad``), their launch plans and the wrapper.

The tensor's device decides: CPU tensors run the plain versions
(``kernels/mamba_ref.py``), CUDA tensors launch the kernels or raise. On
the model's path a scan is one launch: the kernel takes A and D in u's
dtype and B and C as the column views of ``x_proj``'s output that
``nn/mamba.py`` hands over. Under autograd the forward also records the
state before every ``record_steps(ds)``-th step, and the backward
recomputes the states between them: one backward call (two launches, the
reverse walk and the reduction of its partials) returns every input's
gradient in the input's dtype. :func:`bwd_plan` is the backward's launch
plan.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels.mamba_ref import (
    CHANNELS,
    TILE,
    mamba_scan_bwd_ref,
    mamba_scan_fwd_ref,
    mamba_scan_ref,
    record_steps,
)

STATE_WIDTHS = (4, 8, 16, 32, 64)     # d_state values the kernel is built for
# states a thread, by d_state: a channel's states are split over
# d_state / STATES[d_state] neighbouring lanes, contiguous states each
STATES = {4: 4, 8: 4, 16: 4, 32: 8, 64: 16}


class ScanPlan(NamedTuple):
    """How the kernel covers (b, S, di, ds): block (x, y) takes channels
    32 x .. 32 x + 31 of batch row y; its thread t the channel 32 x + t //
    groups and the states (t % groups) x states .. + states - 1. Each block
    walks the ``tiles`` tiles of ``tile`` steps in order, a thread in groups
    of ``steps`` steps."""

    grid: Tuple[int, int]
    threads: int
    tile: int
    states: int
    groups: int
    steps: int
    tiles: int
    smem_bytes: int


def scan_plan(b: int, S: int, di: int, ds: int) -> ScanPlan:
    """The launch plan of the scan kernel: ``groups`` lanes a channel,
    ``steps`` = 32 / states steps a thread's group of loads and exps.
    Shared memory, fp32: two input buffers of a tile, each the (u, dt) pairs
    of 32 channels and the B and C rows, and two of the tile's y."""
    if ds not in STATE_WIDTHS:
        raise ValueError(f"mamba_scan: d_state={ds}: the kernel takes d_state in "
                         f"{STATE_WIDTHS}")
    states = STATES[ds]
    groups = ds // states
    words = 2 * (TILE * (2 * CHANNELS + 2 * ds) + TILE * CHANNELS)
    return ScanPlan(grid=(-(-di // CHANNELS), b), threads=CHANNELS * groups, tile=TILE,
                    states=states, groups=groups, steps=max(1, 32 // states),
                    tiles=-(-S // TILE), smem_bytes=4 * words)


SM_SMEM = 233472                      # shared memory an SM of an H100 holds (228 KB)
# states a thread in the backward, by d_state (csrc/mamba_scan_bwd.cu's
# instances); a thread keeps 32 / states steps of (exp, e h) pairs: 32 each
BWD_STATES = {4: 4, 8: 4, 16: 4, 32: 8, 64: 16}


class BwdPlan(NamedTuple):
    """How the backward kernel covers (b, S, di, ds): block (x, y) takes
    channels 32 x .. 32 x + 31 of batch row y; its thread t the channel 32 x
    + t // lanes and the states (t % lanes) x states .. + states - 1, so a
    warp holds ``channels`` channels. Each block walks the ``stretches``
    recorded stretches of ``stretch`` steps from the last: a forward pass
    through the stretch's ``groups`` groups of ``steps`` steps keeps each
    group's start, then from the last group back each group is recomputed
    from its start (but the last, whose exps the forward pass kept) and
    walked back a step at a time. The sums over the channels and the
    states go ``batch`` steps at a time, a lane summing ``outputs`` (step,
    state) pairs over the warp's channels. ``min_blocks``: the resident
    blocks an SM its launch bounds ask for."""

    grid: Tuple[int, int]
    threads: int
    states: int
    lanes: int
    warps: int
    channels: int
    stretch: int
    steps: int
    groups: int
    batch: int
    outputs: int
    stretches: int
    min_blocks: int
    smem_bytes: int


def bwd_smem_bytes(ds: int, itemsize: int = 2, states: int = None) -> int:
    """Shared memory of a backward block for inputs of ``itemsize`` bytes
    (fp32 4, bf16 2), fp32 words but the last: u, dt, dy of 32 channels
    over a stretch ([channel][step], rows of stretch + 4), B and C
    ([step][ds]); each warp's batch of products ([batch][channels x ds +
    16]) and its lanes' state sums ([2][batch][32]); the warps' sums over
    their channels of the stretch, dC and then dB ([warps][stretch][ds]);
    each thread's kept group starts ([groups - 1][threads][states]); then
    the raw stretch the copies land in, in the inputs' dtype (u, dt, dy,
    B, C)."""
    states = BWD_STATES[ds] if states is None else states
    threads = CHANNELS * ds // states
    warps = threads // 32
    R, batch = record_steps(ds), 4 if ds >= 8 else 8
    words = (3 * CHANNELS * (R + 4) + 2 * R * ds
             + warps * (batch * (CHANNELS // warps * ds + 16) + 2 * batch * 32)
             + warps * R * ds + (R * states // 32 - 1) * threads * states)
    return 4 * words + (3 * R * CHANNELS + 2 * R * ds) * itemsize


def bwd_plan(b: int, S: int, di: int, ds: int, itemsize: int = 2,
             states: int = None) -> BwdPlan:
    """The backward kernel's launch plan for inputs of ``itemsize`` bytes;
    ``states`` a thread defaults to :data:`BWD_STATES`. At 4 states a
    thread the launch bounds ask for 4 blocks an SM (the training shape's
    512 blocks in one wave on 132 SMs) where an SM's 228 KB of shared
    memory hold them, 1 KB more a block; else for 2."""
    if ds not in STATE_WIDTHS:
        raise ValueError(f"mamba_scan_bwd: d_state={ds}: the kernel takes d_state in "
                         f"{STATE_WIDTHS}")
    states = BWD_STATES[ds] if states is None else states
    lanes = ds // states
    threads = CHANNELS * lanes
    warps = threads // 32
    R = record_steps(ds)
    steps = 32 // states
    batch = 4 if ds >= 8 else 8
    smem = bwd_smem_bytes(ds, itemsize, states)
    min_blocks = min(4, SM_SMEM // (smem + 1024)) if states == 4 else 2
    return BwdPlan(grid=(-(-di // CHANNELS), b), threads=threads, states=states, lanes=lanes,
                   warps=warps, channels=CHANNELS // warps, stretch=R, steps=steps,
                   groups=R // steps, batch=batch, outputs=batch * ds // 32,
                   stretches=-(-S // R), min_blocks=min_blocks, smem_bytes=smem)


def _require_rows(name: str, t: torch.Tensor) -> None:
    if t.device.type != "cuda" or t.stride(-1) != 1:
        raise ValueError(f"mamba_scan: {name} must be a CUDA tensor whose last axis is "
                         f"contiguous (got {t.device}, strides {t.stride()})")


def _check(name, u, dt, B, C, A, D):
    """Shapes, dtypes and devices of the scan's inputs (both kernels take
    the same); returns (b, S, di, ds, the dtype code)."""
    b, S, di = u.shape
    ds = B.shape[-1]
    if (dt.shape != u.shape or B.shape != (b, S, ds) or C.shape != B.shape
            or A.shape != (di, ds) or D.shape != (di,)):
        raise ValueError(f"{name}: shapes u {tuple(u.shape)}, dt {tuple(dt.shape)}, "
                         f"B {tuple(B.shape)}, C {tuple(C.shape)}, A {tuple(A.shape)}, "
                         f"D {tuple(D.shape)}")
    code = build.dtype_code(u, name)
    if dt.dtype != u.dtype or B.dtype != u.dtype or C.dtype != u.dtype:
        raise TypeError(f"{name}: u, dt, B and C must share one dtype")
    if A.dtype != D.dtype or A.dtype not in (torch.float32, u.dtype):
        raise TypeError(f"{name}: A and D must both be fp32 or both {u.dtype} "
                        f"(got {A.dtype}, {D.dtype})")
    if S < 1:
        raise ValueError(f"{name}: S={S}: the kernel takes S >= 1")
    build.require_cuda(name, u, dt, A, D)
    for what, t in (("B", B), ("C", C)):
        _require_rows(what, t)
        if t.device != u.device:
            raise ValueError(f"{name}: {what} on {t.device}, u on {u.device}")
    return b, S, di, ds, code


def mamba_scan_cuda(u, dt, B, C, A, D, *, record: bool = False):
    """The kernel launch: u/dt (b, S, di) contiguous and B/C (b, S, ds) with
    a contiguous last axis (any batch and row stride), in one dtype (fp32 or
    bf16); A (di, ds) and D (di,) contiguous, both fp32 or both u's dtype;
    all on one CUDA device; S >= 1, ds in :data:`STATE_WIDTHS`. Returns (y
    (b, S, di) in u.dtype, hT (b, di, ds) fp32) and, with ``record``, the
    states the backward starts from: hs (b, ceil(S / R), di, ds) fp32, the
    state before every R-th step, R = ``record_steps(ds)`` (y and hT keep
    their bits)."""
    b, S, di, ds, code = _check("mamba_scan", u, dt, B, C, A, D)
    plan = scan_plan(b, S, di, ds)
    R = record_steps(ds)
    y = torch.empty_like(u)
    hT = torch.empty((b, di, ds), dtype=torch.float32, device=u.device)
    hs = (torch.empty((b, -(-S // R), di, ds), dtype=torch.float32, device=u.device)
          if record else None)
    err = build.library().sct_mamba_scan(
        u.data_ptr(), dt.data_ptr(), B.data_ptr(), C.data_ptr(), A.data_ptr(), D.data_ptr(),
        y.data_ptr(), hT.data_ptr(), None if hs is None else hs.data_ptr(), b, S, di, ds,
        plan.states, R, code, build.dtype_code(A, "mamba_scan"), B.stride(0), B.stride(1),
        C.stride(0), C.stride(1), plan.smem_bytes, build.stream_of(u))
    build.check(err, "mamba_scan")
    build.LAUNCHES["mamba_scan"] += 1
    return (y, hT, hs) if record else (y, hT)


def mamba_scan_bwd_cuda(u, dt, B, C, A, D, hs, dy, dhT=None):
    """The backward kernel's launches: the forward's inputs (as
    :func:`mamba_scan_cuda` takes them), its recorded states ``hs``, dy
    (b, S, di) in u's dtype and the final state's gradient dhT (b, di, ds)
    fp32 or None (zero). Returns (du, ddt, dB, dC, dA, dD): du, ddt, dB, dC
    in u's dtype (dB, dC contiguous), dA, dD in A's. One call is two
    launches (the reverse walk, the reduction of its per-block partials)
    and counts once; it is deterministic (no atomics)."""
    b, S, di, ds, code = _check("mamba_scan_bwd", u, dt, B, C, A, D)
    R = record_steps(ds)
    want = {"hs": (hs, (b, -(-S // R), di, ds), torch.float32),
            "dy": (dy, (b, S, di), u.dtype), "dhT": (dhT, (b, di, ds), torch.float32)}
    for what, (t, shape, dtype) in want.items():
        if t is not None and (tuple(t.shape) != shape or t.dtype != dtype):
            raise ValueError(f"mamba_scan_bwd: {what} {tuple(t.shape)} {t.dtype}, where "
                             f"{dtype} {shape} is due")
    build.require_cuda("mamba_scan_bwd", u, hs, dy, *([dhT] if dhT is not None else []))
    plan = bwd_plan(b, S, di, ds, u.element_size())
    nblk = plan.grid[0]
    f32 = dict(dtype=torch.float32, device=u.device)
    part_b = torch.empty((b, nblk, S, ds), **f32)
    part_c = torch.empty_like(part_b)
    part_a = torch.empty((b, di, ds), **f32)
    part_d = torch.empty((b, di), **f32)
    du, ddt = torch.empty_like(u), torch.empty_like(u)
    dB = torch.empty((b, S, ds), dtype=u.dtype, device=u.device)
    dC = torch.empty_like(dB)
    dA, dD = torch.empty_like(A), torch.empty_like(D)
    err = build.library().sct_mamba_scan_bwd(
        *(None if t is None else t.data_ptr() for t in (
            u, dt, B, C, A, D, hs, dy, dhT, du, ddt, dB, dC, dA, dD, part_b, part_c, part_a,
            part_d)),
        b, S, di, ds, plan.states, R, code, build.dtype_code(A, "mamba_scan_bwd"), B.stride(0),
        B.stride(1), C.stride(0), C.stride(1), plan.smem_bytes, build.stream_of(u))
    build.check(err, "mamba_scan_bwd")
    build.LAUNCHES["mamba_scan_bwd"] += 1
    return du, ddt, dB, dC, dA, dD


def _kernel_layout(u, dt, B, C, A, D):
    """The inputs as the kernels take them. No copy or cast on the model's
    layout: u and dt come contiguous, B and C as row views, A and D in u's
    dtype."""
    if A.dtype != D.dtype or A.dtype not in (torch.float32, u.dtype):
        A, D = A.float(), D.float()
    B, C = (t if t.stride(-1) == 1 else t.contiguous() for t in (B, C))
    return u.contiguous(), dt.contiguous(), B, C, A.contiguous(), D.contiguous()


def _forward(u, dt, B, C, A, D, record: bool = False):
    if u.device.type == "cpu":
        return (mamba_scan_fwd_ref if record else mamba_scan_ref)(u, dt, B, C, A, D)
    if u.device.type == "cuda":
        return mamba_scan_cuda(*_kernel_layout(u, dt, B, C, A, D), record=record)
    raise ValueError(f"mamba_scan: no kernel for device {u.device}")


class _MambaScan(torch.autograd.Function):
    """The forward under autograd. It keeps the inputs in the kernels'
    layout and the recorded states; the backward recomputes the states
    between them. A gradient of an output no loss reads (the final state
    in training) arrives as None and costs nothing."""

    @staticmethod
    def forward(ctx, u, dt, B, C, A, D):
        ctx.set_materialize_grads(False)
        dtypes = (A.dtype, D.dtype)
        if u.device.type == "cuda":
            u, dt, B, C, A, D = _kernel_layout(u, dt, B, C, A, D)
        y, hT, hs = _forward(u, dt, B, C, A, D, record=True)
        ctx.dtypes = dtypes
        ctx.save_for_backward(u, dt, B, C, A, D, hs)
        return y, hT

    @staticmethod
    def backward(ctx, dy, dhT):
        u, dt, B, C, A, D, hs = ctx.saved_tensors
        if dy is None and dhT is None:
            return (None,) * 6
        dy = torch.zeros_like(u) if dy is None else dy.to(u.dtype)
        dhT = None if dhT is None else dhT.float()
        if u.device.type == "cpu":
            grads = mamba_scan_bwd_ref(u, dt, B, C, A, D, hs, dy, dhT)
        elif u.device.type == "cuda":
            grads = mamba_scan_bwd_cuda(u, dt, B, C, A, D, hs, dy.contiguous(),
                                        None if dhT is None else dhT.contiguous())
        else:
            raise ValueError(f"mamba_scan: no kernel for device {u.device}")
        du, ddt, dB, dC, dA, dD = grads
        return du, ddt, dB, dC, dA.to(ctx.dtypes[0]), dD.to(ctx.dtypes[1])


def mamba_scan(u: torch.Tensor, dt: torch.Tensor, B: torch.Tensor, C: torch.Tensor,
               A: torch.Tensor, D: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Selective scan from the zero state. u, dt: (b, S, di); B, C: (b, S,
    ds), views welcome; A: (di, ds) negative; D: (di,). Returns (y (b, S,
    di) in u.dtype, the final state hT (b, di, ds) fp32)."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (u, dt, B, C, A, D)):
        return _MambaScan.apply(u, dt, B, C, A, D)
    return _forward(u, dt, B, C, A, D)
