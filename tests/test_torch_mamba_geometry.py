"""Host-side plan and arithmetic of the selective-scan kernel
(``csrc/mamba_scan.cu``), held on the CPU to what the CUDA kernel needs.

The host picks the plan from b, S, di and ds alone
(``kernels/mamba_scan.py:scan_plan``): block (x, y) takes 32 channels of
batch row y, and a channel's states are split over ``groups`` neighbouring
lanes, ``states`` contiguous states each; each block walks the prompt in
tiles of ``tile`` steps, staging each tile's inputs (a thread its 16-byte
pieces of u and dt rows and its words of B and C), and a thread walks a
tile in groups of 32 / ``states`` steps, the lanes of a channel each
writing a share of y. Every (batch, channel, state) and every step must be
covered once, and the block must fit the card. The kernel sums over the
states as a binary tree over neighbouring pairs, a lane's states first and
the lanes' sums after (shuffles): the plain version's order, so the two
agree bit for bit. The plain version takes the model's layout (B and C
column views of ``x_proj``'s output, A and D in bf16) with the bits it
gives contiguous fp32 inputs, and stays within the fp32 rung of the
Pallas kernel in interpret mode at a ragged length.
"""
import importlib.util
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.mamba_scan import mamba_scan_pallas  # noqa: E402
from repro_torch.kernels.mamba_ref import mamba_scan_ref, tree_sum  # noqa: E402
from repro_torch.kernels.mamba_scan import (  # noqa: E402
    STATE_WIDTHS,
    STATES,
    mamba_scan,
    scan_plan,
)
from repro_torch.kernels.testing import (  # noqa: E402
    MAMBA_PROFILES,
    Tol,
    assert_scaled_close,
    mamba_inputs,
    mamba_model_layout,
)

torch.set_num_threads(2)

RUNG = Tol(rtol=5e-5, atol=5e-5)       # the fp32 rung, RMS-scaled
MAX_SMEM = 232448                      # 227 KB: the most a block may use on an H100
_spec = importlib.util.spec_from_file_location(
    "chip_smoke", Path(__file__).resolve().parent.parent / "chip_smoke.py")
cs = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(cs)
# (b, S, di, ds): chip_smoke.py's sweep at jamba's d_state, jamba's prompt,
# a training length, and every d_state the kernel is built for
SHAPES = ([(b, S, di, 16) for b in cs.MAMBA_B for S in cs.MAMBA_S for di in cs.MAMBA_DI]
          + [(1, cs.MLSTM_PREFILL_S, 8192, 16), (1, 4096, 8192, 16)]
          + [(2, 37, 200, ds) for ds in STATE_WIDTHS])
# (d_state, states a thread): the plan's, and at d_state 16 the 2 and 8
# that tools/flash_bwd_ablate.py --mamba builds
SPLITS = [(ds, n) for ds, n in STATES.items()] + [(16, 2), (16, 8)]


def _ids(shapes):
    return ["x".join(map(str, s)) for s in shapes]


@pytest.mark.parametrize("shape", SHAPES, ids=_ids(SHAPES))
def test_plan_covers_every_state_and_step_once(shape):
    b, S, di, ds = shape
    p = scan_plan(b, S, di, ds)
    assert p.states == STATES[ds] and p.groups * p.states == ds
    assert p.threads == 32 * p.groups and p.tiles * p.tile >= S > (p.tiles - 1) * p.tile
    # (batch, channel, state): block (x, y), thread t: channel 32 x + t //
    # groups, states (t % groups) states ..
    seen = np.zeros((b, di, ds), np.int32)
    for y in range(p.grid[1]):
        for x in range(p.grid[0]):
            for t in range(p.threads):
                c, g = 32 * x + t // p.groups, t % p.groups
                if c < di:
                    seen[y, c, g * p.states:(g + 1) * p.states] += 1
    assert (seen == 1).all()
    # a channel's lanes are neighbours within one warp (their shuffles)
    assert 32 % p.groups == 0 and p.threads % 32 == 0
    # steps: tile k holds steps k tile .. min(S, (k + 1) tile) - 1
    steps = np.concatenate([np.arange(k * p.tile, min(S, (k + 1) * p.tile))
                            for k in range(p.tiles)])
    assert (steps == np.arange(S)).all()


@pytest.mark.parametrize("vec", [8, 4], ids=["bf16", "fp32"])
@pytest.mark.parametrize("ds,states", SPLITS)
def test_staging_and_steps_cover_a_tile_once(ds, states, vec):
    """Piece e = tid + threads i of a tile's u and dt rows is step e /
    (32 / vec), channels vec (e % (32 / vec)) .. + vec (16 bytes: 8 bf16, 4
    fp32), for e below the tile's pieces; B and C word e = tid + threads i.
    Each covers the tile once; the tile's y goes out in the same pieces.
    The groups of 32 / states steps cover a full tile; in a group, lane g
    of a channel computes y of the steps s with s % groups == g, each step
    once."""
    p = scan_plan(1, 100, 64, ds)
    tile, groups = p.tile, ds // states
    threads, pieces = 32 * groups, 32 // vec
    steps = 32 // states                   # the kernel's kU
    assert tile % steps == 0 and (states != p.states or steps == p.steps)
    staged = np.zeros((tile, 32), np.int32)
    words = np.zeros(tile * ds, np.int32)
    for tid in range(threads):
        for i in range(-(-tile * pieces // threads)):
            e = tid + threads * i
            if e < tile * pieces:
                staged[e // pieces, vec * (e % pieces):vec * (e % pieces) + vec] += 1
        for i in range(tile * ds // threads):
            words[tid + threads * i] += 1
    assert tile * ds % threads == 0
    assert (staged == 1).all() and (words == 1).all()
    for n in (steps, 1):                      # a full group, a single step of the tail
        written = np.zeros(n, np.int32)
        for g in range(groups):
            written[[s for s in range(n) if s % groups == g]] += 1
        assert (written == 1).all()


@pytest.mark.parametrize("shape", SHAPES, ids=_ids(SHAPES))
def test_plan_fits_the_card(shape):
    b, S, di, ds = shape
    p = scan_plan(b, S, di, ds)
    assert p.smem_bytes <= MAX_SMEM and p.threads <= 1024
    assert p.grid[0] < 2 ** 31 and p.grid[1] <= 65535
    # shared memory: two input buffers ((u, dt) pairs, B and C rows) and two
    # of y; 16-byte words (the kernel's vector reads)
    words = 2 * (p.tile * (64 + 2 * ds) + p.tile * 32)
    assert p.smem_bytes == 4 * words and p.smem_bytes % 16 == 0


def test_plan_refuses_unbuilt_state_widths():
    for ds in (2, 12, 128):
        with pytest.raises(ValueError):
            scan_plan(1, 8, 64, ds)


@pytest.mark.parametrize("ds,states", SPLITS)
def test_thread_then_group_sums_are_the_plain_tree(ds, states):
    """Each lane sums its states as a tree, the shuffles over lanes 1, 2,
    .. apart sum the lanes' sums as a tree: the same bits as the plain
    version's tree over all the states."""
    x = torch.tensor(np.random.default_rng(ds).standard_normal((4096, ds)),
                     dtype=torch.float32) * torch.logspace(-3, 3, ds)
    parts = torch.stack([tree_sum(x[:, g * states:(g + 1) * states])
                         for g in range(ds // states)], dim=-1)
    assert torch.equal(tree_sum(parts), tree_sum(x))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("profile", MAMBA_PROFILES)
def test_plain_version_same_bits_on_the_model_layout(profile, dtype):
    """B and C as column views of one (b, S, dt_rank + 2 ds) projection, A
    and D in u's dtype: the bits of contiguous fp32 inputs of the same
    values, through the plain version and the wrapper."""
    b, S, di, ds, dtr = 2, 37, 48, 16, 8
    u, dt, B, C, A, D = mamba_inputs(b, S, di, ds, profile, dtype=dtype, seed=S)
    _, _, Bv, Cv, Ab, Db = mamba_model_layout(u, dt, B, C, A, D, dt_rank=dtr)
    assert not Bv.is_contiguous() and Bv.stride(1) == dtr + 2 * ds
    assert torch.equal(Bv, B) and torch.equal(Cv, C) and Ab.dtype == dtype
    y, h = mamba_scan_ref(u, dt, Bv, Cv, Ab, Db)
    yc, hc = mamba_scan_ref(u, dt, B.contiguous(), C.contiguous(), Ab.float(), Db.float())
    assert y.dtype == dtype and torch.equal(y, yc) and torch.equal(h, hc)
    yw, hw = mamba_scan(u, dt, Bv, Cv, Ab, Db)
    assert torch.equal(yw, y) and torch.equal(hw, h)


@pytest.mark.parametrize("S", [37, 70])
def test_plain_version_vs_pallas_kernel_at_a_ragged_length(S):
    """S not a multiple of the kernel's 32-step tile; the Pallas kernel in
    interpret mode, its time chunk the whole prompt."""
    u, dt, B, C, A, D = mamba_inputs(1, S, 48, 16, "unit", seed=S)
    y, _ = mamba_scan_ref(u, dt, B, C, A, D)
    yr = mamba_scan_pallas(*(jnp.asarray(t.numpy()) for t in (u, dt, B, C, A, D)),
                           interpret=True)
    assert_scaled_close(y.numpy(), np.asarray(yr, np.float32), RUNG)
