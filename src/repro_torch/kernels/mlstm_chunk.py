"""Chunkwise mLSTM: the CUDA kernel (``csrc/mlstm_chunk.cu``), which
replaces the JAX package's ``kernels/mlstm_chunk.py:82``
``mlstm_chunk_pallas``, its backward (``csrc/mlstm_chunk_bwd.cu``, the
port's own: the JAX package differentiates its jnp chunk loop), and
their wrapper.

The tensor's device decides: CPU tensors run the plain versions
(``kernels/mlstm_ref.py``), CUDA tensors launch the kernels or raise.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels.mlstm_ref import mlstm_chunk_bwd_ref, mlstm_chunk_ref

CHUNK = 256           # the kernel's chunk length (csrc/mlstm_chunk.cu kT): the reference's
COLS = 32             # dh is a multiple of this
MAX_DH = 1024         # the widest head the kernel takes
TILE = 128            # C's tiles (kCT) and the score slices (kSD)


def chunk_lengths(S: int) -> list:
    """The kernel's chunks of an S-token call: T = min(256, S), the
    reference's, with a ragged last chunk past 256 (the reference takes one
    chunk of S when 256 does not divide S)."""
    return [min(CHUNK, S - c0) for c0 in range(0, S, CHUNK)]

State = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]

# the backward (csrc/mlstm_chunk_bwd.cu)
GRAD_TILE = 128       # dq / dk / dv tiles and dC tiles, rows and columns (kGT, kCT)
STAGE_DEPTH = 32      # reduction depth of a tensor-core stage (kKS)
ROW_SPLIT = 4         # blocks that share a chunk's rows in the rows pass (kRowSplit)
GRADS = ("dq", "dk", "dv")


class BwdPlan(NamedTuple):
    """How the backward kernel covers (B, S, dh), as
    ``csrc/mlstm_chunk_bwd.cu`` computes it from its arguments.

    The input gradients: block (x, y, z) of ``inputs_grid`` writes gradient
    ``GRADS[y]`` of head z, chunk x // (row_tiles * col_tiles), row tile
    (x // col_tiles) % row_tiles, column tile x % col_tiles
    (:func:`inputs_block`): a ``GRAD_TILE``-square tile; a tile past its
    chunk's rows writes nothing. Each tile runs its carried-state product
    (dh / ``STAGE_DEPTH`` stages) where ``state_products[y][c]``, then its
    triangle. The dC sweep: block (x, y, z) of ``dstate_grid`` owns dC rows
    y and columns x (tiles) of head z, walks the chunks in reverse and runs
    the update of the chunks in ``updates``. A product is skipped exactly
    where its factor is zero by construction: chunk 0's C0 when no state is
    passed (dq's dy C0^T, and the update that only dC0 would read) and the
    last chunk's dC1 when no gradient of the final C is (dk's v dC1^T, dv's
    k dC1). The rows pass: block (c, b, r) of ``rows_grid`` takes chunk c's
    rows t = r mod ``ROW_SPLIT`` (:func:`rows_of`)."""

    chunks: Tuple[int, ...]
    row_tiles: int
    col_tiles: int
    scores_grid: Tuple[int, int, int]
    rows_grid: Tuple[int, int, int]
    inputs_grid: Tuple[int, int, int]
    dstate_grid: Tuple[int, int, int]
    state_products: Tuple[Tuple[bool, ...], ...]
    updates: Tuple[int, ...]
    inputs_smem: int
    dstate_smem: int
    workspace_floats: int


def bwd_plan(B: int, S: int, dh: int, *, has_state: bool, has_dC: bool) -> BwdPlan:
    """The backward kernel's plan for (B, S, dh), with or without an
    initial state and a gradient of the final C."""
    chunks = tuple(chunk_lengths(S))
    nc = len(chunks)
    rows, cols = CHUNK // GRAD_TILE, -(-dh // GRAD_TILE)
    dq = tuple(has_state or c > 0 for c in range(nc))
    dkv = tuple(has_dC or c < nc - 1 for c in range(nc))
    updates = tuple(c for c in range(nc) if has_state or c > 0)
    # four raw stages of both operands and two of B's tf32 parts, rounded to 128 bytes
    # (the kernel's InputsSmem and DStateSmem)
    stage = max(GRAD_TILE * (STAGE_DEPTH + 4), STAGE_DEPTH * (GRAD_TILE + 8))
    split = 2 * 2 * GRAD_TILE * STAGE_DEPTH
    inputs_smem = -(-4 * (4 * 2 * stage + split) // 128) * 128
    dstate_smem = -(-4 * (4 * 2 * STAGE_DEPTH * (GRAD_TILE + 8) + split + 2 * CHUNK
                         + GRAD_TILE + 8) // 128) * 128

    def r64(n):
        return -(-n // 64) * 64

    # the scratch arrays of the kernel's carve(), each rounded up to 64 floats
    tok = B * S
    workspace = (2 * r64(B * nc * dh * dh) + 2 * r64(B * nc * dh) + 2 * r64(B * nc)
                 + 2 * r64(B * nc * CHUNK * CHUNK) + 5 * r64(tok) + r64(ROW_SPLIT * tok)
                 + 2 * r64(tok * cols) + r64(B * nc * cols * cols))
    return BwdPlan(chunks=chunks, row_tiles=rows, col_tiles=cols,
                   scores_grid=(nc * 10, 2, B), rows_grid=(nc, B, ROW_SPLIT),
                   inputs_grid=(nc * rows * cols, 3, B),
                   dstate_grid=(cols, cols, B), state_products=(dq, dkv, dkv), updates=updates,
                   inputs_smem=inputs_smem, dstate_smem=dstate_smem,
                   workspace_floats=workspace)


def rows_of(plan: BwdPlan, c: int, r: int, warp: int) -> range:
    """The rows of chunk c that warp ``warp`` of the rows pass's block r
    takes, in its order (8 warps a block)."""
    return range(r + ROW_SPLIT * warp, plan.chunks[c], ROW_SPLIT * 8)


def inputs_block(plan: BwdPlan, x: int) -> Tuple[int, int, int]:
    """(chunk, row tile, column tile) of the input gradients' block x."""
    return (x // (plan.row_tiles * plan.col_tiles), (x // plan.col_tiles) % plan.row_tiles,
            x % plan.col_tiles)


def plan_macs(plan: BwdPlan, dh: int) -> int:
    """Multiply-adds of one head that the plan runs, as these inputs need
    them: the five triangle products, the carried-state products and dC
    updates it does not skip, and the state pass (every chunk's update but
    the last's)."""
    macs = 0
    for c, T in enumerate(plan.chunks):
        macs += 5 * T * (T + 1) // 2 * dh
        macs += sum(live[c] for live in plan.state_products) * T * dh * dh
        macs += (c in plan.updates) * T * dh * dh
        macs += (c < len(plan.chunks) - 1) * T * dh * dh
    return macs


def _check_inputs(name, q, k, v, i_pre, f_pre, state):
    """The kernels' shared contract: shapes, fp32, one CUDA device,
    contiguous, dh a multiple of 32 up to 1024, 16-byte aligned rows.
    Returns the tensors checked."""
    B, S, dh = q.shape
    if k.shape != q.shape or v.shape != q.shape or i_pre.shape != (B, S) \
            or f_pre.shape != (B, S):
        raise ValueError(f"{name}: shapes q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}, i_pre {tuple(i_pre.shape)}, "
                         f"f_pre {tuple(f_pre.shape)}")
    tensors = [q, k, v, i_pre, f_pre]
    if state is not None:
        C0, n0, m0 = state
        if C0.shape != (B, dh, dh) or n0.shape != (B, dh) or m0.shape != (B,):
            raise ValueError(f"{name}: state shapes C {tuple(C0.shape)}, n "
                             f"{tuple(n0.shape)}, m {tuple(m0.shape)} for {(B, S, dh)}")
        tensors += [C0, n0, m0]
    for t in tensors:
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: the kernel takes fp32, got {t.dtype}")
    if S < 1 or dh % COLS or dh > MAX_DH:
        raise ValueError(f"{name}: S={S}, dh={dh}: the kernel takes S >= 1 and dh a "
                         f"multiple of {COLS}, at most {MAX_DH}")
    build.require_cuda(name, *tensors)
    if any(t.data_ptr() % 16 for t in tensors[:3] + tensors[5:6]):
        raise ValueError(f"{name}: q, k, v and C0 must be 16-byte aligned (the kernel "
                         "reads their rows as float4)")
    return tensors


def mlstm_chunk_cuda(q, k, v, i_pre, f_pre, state: Optional[State] = None):
    """The kernel launch: q/k/v (B, S, dh), i_pre/f_pre (B, S) and the
    optional state (C (B, dh, dh), n (B, dh), m (B,)), all fp32 and
    contiguous on one CUDA device; dh a multiple of 32, at most 1024.
    Returns (y, (C, n, m)). One call is three launches (the scores, the
    state's tiles, the outputs) and counts once."""
    _check_inputs("mlstm_chunk", q, k, v, i_pre, f_pre, state)
    B, S, dh = q.shape
    dev = q.device
    nc, nd = len(chunk_lengths(S)), -(-dh // TILE)
    f32 = dict(dtype=torch.float32, device=dev)
    part = torch.empty((B, nd, nc, CHUNK, CHUNK), **f32)     # score slices
    carry = state is not None or nc > 1                       # a q @ C0 product runs
    yq = torch.empty((B, nd, S, dh) if carry else (1,), **f32)
    qn = torch.empty((B, nd, S) if carry else (1,), **f32)
    mprev = torch.empty((B, nc), **f32)
    y = torch.empty_like(q)
    C = torch.empty((B, dh, dh), **f32)
    n = torch.empty((B, dh), **f32)
    m = torch.empty((B,), **f32)
    st = [t.data_ptr() for t in state] if state is not None else [None] * 3
    err = build.library().sct_mlstm_chunk(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), i_pre.data_ptr(), f_pre.data_ptr(),
        *st, part.data_ptr(), yq.data_ptr(), qn.data_ptr(), mprev.data_ptr(), y.data_ptr(),
        C.data_ptr(), n.data_ptr(), m.data_ptr(), B, S, dh, build.stream_of(q))
    build.check(err, "mlstm_chunk")
    build.LAUNCHES["mlstm_chunk"] += 1
    return y, (C, n, m)


def mlstm_chunk_bwd_cuda(q, k, v, i_pre, f_pre, state: Optional[State], y, dy, dC=None,
                         dn=None, dm=None):
    """The backward kernel's launch: the forward's inputs (as
    :func:`mlstm_chunk_cuda` takes them), its output y, and the gradients
    of y (B, S, dh) and of the final C, n, m (each may be None: zero).
    Returns (dq, dk, dv, di_pre, df_pre, dstate), dstate (dC0, dn0, dm0)
    when a state was passed, else None. One call is six launches (the
    chunks' starting states, the scores, the rows, the reverse sweep of
    dC, the input gradients, the gates: :func:`bwd_plan`) and counts once;
    it is deterministic (no atomics)."""
    tensors = _check_inputs("mlstm_chunk_bwd", q, k, v, i_pre, f_pre, state)
    B, S, dh = q.shape
    dy = torch.zeros_like(y) if dy is None else dy
    finals = [t for t in (dC, dn, dm) if t is not None]
    for t, want in ((y, q.shape), (dy, q.shape), (dC, (B, dh, dh)), (dn, (B, dh)), (dm, (B,))):
        if t is not None and (tuple(t.shape) != tuple(want) or t.dtype != torch.float32):
            raise ValueError(f"mlstm_chunk_bwd: a gradient of shape {tuple(t.shape)} "
                             f"({t.dtype}) where fp32 {tuple(want)} is due")
    build.require_cuda("mlstm_chunk_bwd", *tensors, y, dy, *finals)
    if dy.data_ptr() % 16:
        raise ValueError("mlstm_chunk_bwd: dy must be 16-byte aligned")
    plan = bwd_plan(B, S, dh, has_state=state is not None, has_dC=dC is not None)
    lib = build.library()
    if int(lib.sct_mlstm_chunk_bwd_workspace(B, S, dh)) != plan.workspace_floats:
        raise RuntimeError("mlstm_chunk_bwd: the kernel's workspace differs from its plan's")
    ws = torch.empty((plan.workspace_floats,), dtype=torch.float32, device=q.device)
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    di, df = torch.empty_like(i_pre), torch.empty_like(f_pre)
    dstate = None
    if state is not None:
        dstate = (torch.empty_like(state[0]), torch.empty_like(state[1]),
                  torch.empty_like(state[2]))

    def ptr(t):
        return None if t is None else t.data_ptr()

    st = state if state is not None else (None, None, None)
    ds = dstate if dstate is not None else (None, None, None)
    err = lib.sct_mlstm_chunk_bwd(
        *(ptr(t) for t in (q, k, v, i_pre, f_pre, *st, y, dy, dC, dn, dm, ws, dq, dk, dv, di, df,
                           *ds)), B, S, dh, build.stream_of(q))
    build.check(err, "mlstm_chunk_bwd")
    build.LAUNCHES["mlstm_chunk_bwd"] += 1
    return dq, dk, dv, di, df, dstate


def _forward(q, k, v, i_pre, f_pre, state):
    if q.device.type == "cpu":
        return mlstm_chunk_ref(q, k, v, i_pre, f_pre, state)
    if q.device.type == "cuda":
        st = tuple(t.contiguous() for t in state) if state is not None else None
        return mlstm_chunk_cuda(q.contiguous(), k.contiguous(), v.contiguous(),
                                i_pre.contiguous(), f_pre.contiguous(), st)
    raise ValueError(f"mlstm_chunk: no kernel for device {q.device}")


def _backward(q, k, v, i_pre, f_pre, state, y, dy, dC, dn, dm):
    if q.device.type == "cpu":
        return mlstm_chunk_bwd_ref(q, k, v, i_pre, f_pre, state, y, dy, dC, dn, dm,
                                   chunk=CHUNK)
    if q.device.type == "cuda":
        def c(t):
            return None if t is None else t.contiguous()

        st = tuple(c(t) for t in state) if state is not None else None
        return mlstm_chunk_bwd_cuda(c(q), c(k), c(v), c(i_pre), c(f_pre), st, c(y), c(dy),
                                    c(dC), c(dn), c(dm))
    raise ValueError(f"mlstm_chunk: no kernel for device {q.device}")


class _MLSTMChunk(torch.autograd.Function):
    """The forward under autograd. It keeps its inputs and y; the backward
    rebuilds the chunks' starting states itself. Gradients of outputs no
    loss reads arrive as None (the final state in training) and cost
    nothing."""

    @staticmethod
    def forward(ctx, q, k, v, i_pre, f_pre, C0, n0, m0):
        ctx.set_materialize_grads(False)
        state = (C0, n0, m0) if C0 is not None else None
        y, (C, n, m) = _forward(q, k, v, i_pre, f_pre, state)
        ctx.save_for_backward(q, k, v, i_pre, f_pre, C0, n0, m0, y)
        return y, C, n, m

    @staticmethod
    def backward(ctx, dy, dC, dn, dm):
        q, k, v, i_pre, f_pre, C0, n0, m0, y = ctx.saved_tensors
        state = (C0, n0, m0) if C0 is not None else None
        dq, dk, dv, di, df, dstate = _backward(q, k, v, i_pre, f_pre, state, y, dy, dC, dn, dm)
        return (dq, dk, dv, di, df, *(dstate if dstate is not None else (None,) * 3))


def mlstm_chunk(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, i_pre: torch.Tensor,
                f_pre: torch.Tensor, state: Optional[State] = None):
    """Chunkwise stabilised mLSTM over the folded (B = batch * heads)
    layout. q/k/v: (B, S, dh) fp32, k pre-scaled by 1/sqrt(dh);
    i_pre/f_pre: (B, S) fp32; ``state``: (C (B, dh, dh), n (B, dh),
    m (B,)) or None for the empty state. Returns (y (B, S, dh),
    (C, n, m))."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad
            for t in (q, k, v, i_pre, f_pre, *(state or ()))):
        C0, n0, m0 = state if state is not None else (None, None, None)
        y, C, n, m = _MLSTMChunk.apply(q, k, v, i_pre, f_pre, C0, n0, m0)
        return y, (C, n, m)
    return _forward(q, k, v, i_pre, f_pre, state)
