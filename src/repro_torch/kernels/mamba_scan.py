"""Selective scan: the CUDA kernel (``csrc/mamba_scan.cu``), which
replaces the JAX package's ``kernels/mamba_scan.py:52``
``mamba_scan_pallas``, its launch plan and its wrapper.

The tensor's device decides: CPU tensors run the plain version
(``kernels/mamba_ref.py``), CUDA tensors launch the kernel or raise. On the
model's path a scan is one launch: the kernel takes A and D in u's dtype
and B and C as the column views of ``x_proj``'s output that
``nn/mamba.py`` hands over. The kernel has no backward yet: under autograd
the wrapper's backward raises ``TypeError`` (training the hybrid family is
a later slice).
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels.mamba_ref import mamba_scan_ref

STATE_WIDTHS = (4, 8, 16, 32, 64)     # d_state values the kernel is built for
CHANNELS = 32                         # channels a block, one a lane (csrc kChannels)
TILE = 32                             # time steps a staged tile (csrc kTile)
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


def _require_rows(name: str, t: torch.Tensor) -> None:
    if t.device.type != "cuda" or t.stride(-1) != 1:
        raise ValueError(f"mamba_scan: {name} must be a CUDA tensor whose last axis is "
                         f"contiguous (got {t.device}, strides {t.stride()})")


def mamba_scan_cuda(u, dt, B, C, A, D) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel launch: u/dt (b, S, di) contiguous and B/C (b, S, ds) with
    a contiguous last axis (any batch and row stride), in one dtype (fp32 or
    bf16); A (di, ds) and D (di,) contiguous, both fp32 or both u's dtype;
    all on one CUDA device; S >= 1, ds in :data:`STATE_WIDTHS`. Returns (y
    (b, S, di) in u.dtype, hT (b, di, ds) fp32)."""
    b, S, di = u.shape
    ds = B.shape[-1]
    if (dt.shape != u.shape or B.shape != (b, S, ds) or C.shape != B.shape
            or A.shape != (di, ds) or D.shape != (di,)):
        raise ValueError(f"mamba_scan: shapes u {tuple(u.shape)}, dt {tuple(dt.shape)}, "
                         f"B {tuple(B.shape)}, C {tuple(C.shape)}, A {tuple(A.shape)}, "
                         f"D {tuple(D.shape)}")
    code = build.dtype_code(u, "mamba_scan")
    if dt.dtype != u.dtype or B.dtype != u.dtype or C.dtype != u.dtype:
        raise TypeError("mamba_scan: u, dt, B and C must share one dtype")
    if A.dtype != D.dtype or A.dtype not in (torch.float32, u.dtype):
        raise TypeError(f"mamba_scan: A and D must both be fp32 or both {u.dtype} "
                        f"(got {A.dtype}, {D.dtype})")
    if S < 1:
        raise ValueError(f"mamba_scan: S={S}: the kernel takes S >= 1")
    plan = scan_plan(b, S, di, ds)
    build.require_cuda("mamba_scan", u, dt, A, D)
    for name, t in (("B", B), ("C", C)):
        _require_rows(name, t)
        if t.device != u.device:
            raise ValueError(f"mamba_scan: {name} on {t.device}, u on {u.device}")
    y = torch.empty_like(u)
    hT = torch.empty((b, di, ds), dtype=torch.float32, device=u.device)
    err = build.library().sct_mamba_scan(
        u.data_ptr(), dt.data_ptr(), B.data_ptr(), C.data_ptr(), A.data_ptr(), D.data_ptr(),
        y.data_ptr(), hT.data_ptr(), b, S, di, ds, plan.states, code,
        build.dtype_code(A, "mamba_scan"), B.stride(0), B.stride(1), C.stride(0), C.stride(1),
        plan.smem_bytes, build.stream_of(u))
    build.check(err, "mamba_scan")
    build.LAUNCHES["mamba_scan"] += 1
    return y, hT


def _forward(u, dt, B, C, A, D):
    if u.device.type == "cpu":
        return mamba_scan_ref(u, dt, B, C, A, D)
    if u.device.type == "cuda":
        # no copy or cast on the model's layout: u and dt come contiguous, B
        # and C as row views, A and D in u's dtype
        if A.dtype != D.dtype or A.dtype not in (torch.float32, u.dtype):
            A, D = A.float(), D.float()
        B, C = (t if t.stride(-1) == 1 else t.contiguous() for t in (B, C))
        return mamba_scan_cuda(u.contiguous(), dt.contiguous(), B, C, A.contiguous(),
                               D.contiguous())
    raise ValueError(f"mamba_scan: no kernel for device {u.device}")


class _MambaScan(torch.autograd.Function):
    """The forward under autograd; serving-only until the hybrid family
    trains, so its backward raises."""

    @staticmethod
    def forward(ctx, u, dt, B, C, A, D):
        return _forward(u, dt, B, C, A, D)

    @staticmethod
    def backward(ctx, *grads):
        raise TypeError("mamba_scan has no backward yet: training the hybrid family needs "
                        "a hand-written backward kernel for the selective scan")


def mamba_scan(u: torch.Tensor, dt: torch.Tensor, B: torch.Tensor, C: torch.Tensor,
               A: torch.Tensor, D: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Selective scan from the zero state. u, dt: (b, S, di); B, C: (b, S,
    ds), views welcome; A: (di, ds) negative; D: (di,). Returns (y (b, S,
    di) in u.dtype, the final state hT (b, di, ds) fp32)."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (u, dt, B, C, A, D)):
        return _MambaScan.apply(u, dt, B, C, A, D)
    return _forward(u, dt, B, C, A, D)
