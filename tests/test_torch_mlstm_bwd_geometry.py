"""Host-side plan and arithmetic of the mLSTM backward kernel
(``csrc/mlstm_chunk_bwd.cu``), held on the CPU to what the CUDA kernel
needs.

The plan (``kernels/mlstm_chunk.py:bwd_plan``) mirrors how the kernel
covers (B, S, dh): the input gradients' blocks each write one 128 x 128
tile of dq, dk or dv of one head and chunk, the dC sweep's blocks one 128 x
128 tile of a head's dC; every tile must be covered once. A carried-state
product is skipped exactly where its factor is zero by construction
(chunk 0's starting C without a state, the last chunk's dC1 without a
gradient of the final C), which is the work ``chip_smoke.py:
mlstm_train_work`` leaves out of the bound. The dense products run as
3xTF32 on the tensor cores: x is split into two tf32 parts that keep 22 of
its 24 bits, and a 1024-deep product summed as the kernel sums it (each
wgmma's eight products added to the accumulator and truncated, a 32-deep
stage from zero, the stages added in fp32) stays within the fp32 rung of
the product in fp64.
"""
import importlib.util
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.mlstm_chunk import (  # noqa: E402
    CHUNK,
    GRAD_TILE,
    GRADS,
    STAGE_DEPTH,
    bwd_plan,
    chunk_lengths,
    inputs_block,
    plan_macs,
    rows_of,
)
from repro_torch.kernels.mlstm_ref import (  # noqa: E402
    _chunk_bwd,
    _state_pass,
    init_state,
)
from repro_torch.kernels.testing import Tol, assert_scaled_close, mlstm_inputs  # noqa: E402

torch.set_num_threads(2)

RUNG = Tol(rtol=5e-5, atol=5e-5)       # the fp32 rung, RMS-scaled
MAX_SMEM = 232448                      # 227 KB: the most a block may use on an H100
_spec = importlib.util.spec_from_file_location(
    "chip_smoke", Path(__file__).resolve().parent.parent / "chip_smoke.py")
cs = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(cs)
# (B, S, dh): chip_smoke.py's phase K sweep and xlstm-1.3b's training shape
SHAPES = sorted({(B, S, dh) for dh in cs.MLSTM_BWD_DH for B in cs.MLSTM_BWD_B
                 for S in cs.MLSTM_BWD_S} | {(8, 4096, 1024), (2, 600, 96)})
FLAGS = [(False, False), (True, False), (False, True), (True, True)]


def _ids(shapes):
    return ["x".join(map(str, s)) for s in shapes]


@pytest.mark.parametrize("shape", SHAPES, ids=_ids(SHAPES))
def test_plan_covers_every_gradient_tile_once(shape):
    B, S, dh = shape
    p = bwd_plan(B, S, dh, has_state=False, has_dC=False)
    assert p.inputs_grid == (len(p.chunks) * p.row_tiles * p.col_tiles, len(GRADS), B)
    assert p.row_tiles * GRAD_TILE == CHUNK and p.col_tiles * GRAD_TILE >= dh
    starts = np.cumsum([0] + list(p.chunks))
    for y in range(p.inputs_grid[1]):
        seen = np.zeros((B, S, dh), np.uint8)
        tiles = set()
        for z in range(B):
            for x in range(p.inputs_grid[0]):
                c, rt, ct = inputs_block(p, x)
                r0, c0 = rt * GRAD_TILE, ct * GRAD_TILE
                if r0 >= p.chunks[c]:
                    continue                  # past the chunk's rows: writes nothing
                rows = min(GRAD_TILE, p.chunks[c] - r0)
                seen[z, starts[c] + r0:starts[c] + r0 + rows, c0:c0 + GRAD_TILE] += 1
                tiles.add((z, c, rt, ct))
        assert (seen == 1).all(), GRADS[y]
        assert len(tiles) == sum(-(-T // GRAD_TILE) for T in p.chunks) * p.col_tiles * B


@pytest.mark.parametrize("shape", SHAPES, ids=_ids(SHAPES))
def test_plan_covers_every_dc_tile_once(shape):
    B, S, dh = shape
    p = bwd_plan(B, S, dh, has_state=True, has_dC=True)
    seen = np.zeros((B, dh, dh), np.uint8)
    nx, ny, nz = p.dstate_grid
    for z in range(nz):
        for y in range(ny):
            for x in range(nx):
                seen[z, y * GRAD_TILE:(y + 1) * GRAD_TILE, x * GRAD_TILE:(x + 1) * GRAD_TILE] += 1
    assert (seen == 1).all()
    assert p.inputs_smem <= MAX_SMEM and p.dstate_smem <= MAX_SMEM
    assert dh % STAGE_DEPTH == 0


@pytest.mark.parametrize("S", [1, 37, 256, 300, 4096])
def test_plan_takes_every_row_once(S):
    """The rows pass: every row of every chunk to one warp of one block."""
    p = bwd_plan(2, S, 32, has_state=False, has_dC=False)
    nc, B, split = p.rows_grid
    assert (nc, B) == (len(p.chunks), 2)
    for c, T in enumerate(p.chunks):
        seen = np.zeros(T, np.int32)
        for r in range(split):
            for warp in range(8):
                for t in rows_of(p, c, r, warp):
                    seen[t] += 1
        assert (seen == 1).all()


def _factors(B, S, dh, has_state, has_dC, seed=3):
    """Every chunk's starting C and the dC1 of its end, from the plain
    version's own sweeps (``mlstm_chunk_bwd_ref``'s loop)."""
    q, k, v, i, f, state = mlstm_inputs(B, S, dh, "unit", seed=seed, with_state=has_state)
    st = state if state is not None else init_state(B, dh, device="cpu")
    logf = torch.nn.functional.logsigmoid(f)
    bounds = [(c0, c0 + T) for c0, T in zip(range(0, S, CHUNK), chunk_lengths(S))]
    starts = []
    for c0, c1 in bounds:
        starts.append(st)
        st = _state_pass(k[:, c0:c1], v[:, c0:c1], i[:, c0:c1], logf[:, c0:c1], *st)
    gen = torch.Generator().manual_seed(seed)
    y = torch.randn(q.shape, generator=gen)
    dy = torch.randn(q.shape, generator=gen)
    dC = torch.randn(st[0].shape, generator=gen) if has_dC else torch.zeros_like(st[0])
    dn, dm = torch.zeros_like(st[1]), torch.zeros_like(st[2])
    dC1 = [None] * len(bounds)
    for c in reversed(range(len(bounds))):
        (c0, c1), start = bounds[c], starts[c]
        dC1[c] = dC
        sl = slice(c0, c1)
        _, (dC, dn, dm) = _chunk_bwd(q[:, sl], k[:, sl], v[:, sl], i[:, sl], logf[:, sl],
                                     *start, y[:, sl], dy[:, sl], dC, dn, dm)
    return [s[0] for s in starts], dC1


@pytest.mark.parametrize("flags", FLAGS, ids=["empty", "state", "dC", "state+dC"])
@pytest.mark.parametrize("S", [1, 37, 256, 300, 600])
def test_plan_skips_exactly_the_zero_factors(S, flags):
    has_state, has_dC = flags
    B, dh = 2, 32
    p = bwd_plan(B, S, dh, has_state=has_state, has_dC=has_dC)
    C0, dC1 = _factors(B, S, dh, has_state, has_dC)
    nc = len(p.chunks)
    for c in range(nc):
        # dq's dy C0^T runs where the chunk's C0 is not zero
        assert p.state_products[0][c] == bool(C0[c].abs().max() > 0), (c, "dq")
        # dk's v dC1^T and dv's k dC1 run where the chunk's dC1 is not zero
        for y in (1, 2):
            assert p.state_products[y][c] == bool(dC1[c].abs().max() > 0), (c, GRADS[y])
    # the sweep updates dC over every chunk whose result a later product or
    # dC0 reads: all but chunk 0, and chunk 0 where a state was passed
    assert p.updates == tuple(c for c in range(nc) if c > 0 or has_state)


@pytest.mark.parametrize("shape", SHAPES, ids=_ids(SHAPES))
def test_plan_work_is_the_bound_work(shape):
    """The plan's multiply-adds from the empty state without a final
    gradient are the ones ``mlstm_train_work`` counts for the bound."""
    B, S, dh = shape
    flops, _ = cs.mlstm_train_work(B, S, dh, backward=True)
    assert 2 * B * plan_macs(bwd_plan(B, S, dh, has_state=False, has_dC=False), dh) == flops
    full = plan_macs(bwd_plan(B, S, dh, has_state=True, has_dC=True), dh)
    nc = len(chunk_lengths(S))
    # with a state and a final gradient nothing is skipped: chunk 0's C0
    # dnum and its update, and the last chunk's dC1 v and dC1^T k
    T0, TL = chunk_lengths(S)[0], chunk_lengths(S)[-1]
    skipped = 2 * T0 * dh * dh + 2 * TL * dh * dh
    assert full - flops // (2 * B) == skipped, nc


def _rna_tf32(x: np.ndarray) -> np.ndarray:
    """cvt.rna.tf32.f32: x rounded to 10 explicit significand bits, ties
    away from zero (the low 13 bits of the fp32 pattern cleared)."""
    u = np.asarray(x, np.float32).view(np.uint32).astype(np.uint64)
    return ((u + 0x1000) & 0xFFFFE000).astype(np.uint32).view(np.float32)


def _split(x: np.ndarray):
    big = _rna_tf32(x)
    return big, _rna_tf32((x - big).astype(np.float32))


def test_split_tf32_keeps_22_bits():
    rng = np.random.default_rng(0)
    x = (rng.standard_normal(1 << 20) * 10.0 ** rng.uniform(-30, 30, 1 << 20)).astype(np.float32)
    big, small = _split(x)
    for part in (big, small):
        assert not (part.view(np.uint32) & 0x1FFF).any()      # tf32: 10 explicit bits
    rest = np.abs(x.astype(np.float64) - big.astype(np.float64) - small.astype(np.float64))
    assert (rest <= 2.0 ** -22 * np.abs(x.astype(np.float64))).all()
    # the split's first step is exact in fp32: x - big needs no rounding
    assert (x.astype(np.float64) - big.astype(np.float64)
            == (x - big).astype(np.float64)).all()


def _rz32(x: np.ndarray) -> np.ndarray:
    """fp64 values rounded toward zero to fp32 (the tensor cores' sums
    truncate)."""
    r = x.astype(np.float32)
    over = np.abs(r.astype(np.float64)) > np.abs(x)
    r[over] = np.nextafter(r[over], np.float32(0))
    return r


def _product_3xtf32(a: np.ndarray, b: np.ndarray, staged: bool = True) -> np.ndarray:
    """a @ b as the kernel sums it: a 32-deep stage from zero on the tensor
    cores, each k-step of 8 as small . big, big . small, big . big, every
    product exact and every addition to the accumulator truncated to fp32;
    the stages added to the result in fp32. ``staged=False``: one truncating
    accumulator over the whole depth instead."""
    (ab, asm), (bb, bs) = _split(a), _split(b)
    out = np.zeros((a.shape[0], b.shape[1]), np.float32)
    part = np.zeros_like(out)
    for s0 in range(0, a.shape[1], STAGE_DEPTH):
        if staged:
            part = np.zeros_like(out)
        for k0 in range(s0, s0 + STAGE_DEPTH, 8):
            ks = slice(k0, k0 + 8)
            for x, y in ((asm, bb), (ab, bs), (ab, bb)):
                part = _rz32(part.astype(np.float64)
                             + x[:, ks].astype(np.float64) @ y[ks].astype(np.float64))
        if staged:
            out = out + part
    return out if staged else part


@pytest.mark.parametrize("what", ["dy_C0", "k_dC1", "scores_k"])
def test_3xtf32_product_within_the_fp32_rung(what):
    """A 1024-deep product at the training widths (a 64 x 64 tile of it):
    dy C0^T (unit normals times a state of unit-scale rows), k dC1 (k with
    mean 1 / sqrt(dh), a gradient state) and a triangle product dS k over
    256 tokens, against the product in fp64."""
    rng = np.random.default_rng(1)
    dh = 1024
    if what == "dy_C0":
        a, b = rng.standard_normal((64, dh)), rng.standard_normal((dh, 64)) / np.sqrt(dh)
    elif what == "k_dC1":
        a = (rng.standard_normal((64, dh)) + 1.0) / np.sqrt(dh)
        b = rng.standard_normal((dh, 64)) * 3.0
    else:
        a = np.tril(rng.standard_normal((64, CHUNK)) * rng.uniform(0, 1, (64, CHUNK)), 192)
        b = (rng.standard_normal((CHUNK, 64)) + 1.0) / np.sqrt(dh)
    a, b = a.astype(np.float32), b.astype(np.float32)
    got = _product_3xtf32(a, b)
    ref = a.astype(np.float64) @ b.astype(np.float64)
    assert_scaled_close(got, ref, RUNG, what)
    # the error is that of fp32 arithmetic, not of tf32's 11 bits
    err = float(np.abs(got - ref).max()) / float(np.sqrt(np.mean(ref ** 2)))
    assert err < 2e-6, err


def test_stage_sums_keep_fp32_accuracy():
    """Why every stage is summed from zero and added in fp32: one
    truncating accumulator over a 1024-deep product (dy C0^T's widths)
    errs an order of magnitude more than the staged sum, which errs as
    fp32 arithmetic does."""
    rng = np.random.default_rng(1)
    a = rng.standard_normal((64, 1024)).astype(np.float32)
    b = (rng.standard_normal((1024, 64)) / 32.0).astype(np.float32)
    ref = a.astype(np.float64) @ b.astype(np.float64)
    rms = float(np.sqrt(np.mean(ref ** 2)))
    errs = {staged: float(np.abs(_product_3xtf32(a, b, staged) - ref).max()) / rms
            for staged in (True, False)}
    fp32 = float(np.abs(a @ b - ref).max()) / rms
    assert errs[True] < 2 * fp32 and errs[False] > 10 * errs[True], (errs, fp32)
