"""Host-side plan and arithmetic of the selective scan's backward kernel
(``csrc/mamba_scan_bwd.cu``), held on the CPU to what the CUDA kernel
needs.

The plan (``kernels/mamba_scan.py:bwd_plan``) mirrors how the kernel covers
(b, S, di, ds): block (x, y) takes 32 channels of batch row y, a channel's
states over ``lanes`` neighbouring lanes of one warp. A block walks the
recorded stretches from the last (``bwd_walk``, the kernel's loops): a
forward pass from the recorded state keeps each group's start, then the
groups run their reverse steps from the last, each recomputed from its
kept start but the last, whose exps the forward pass kept. Every (batch,
channel, state) and every
step must be covered once, and the block must fit the card at the
resident blocks its launch bounds ask for. The sums keep the plain
version's order (``kernels/mamba_ref.py:mamba_scan_bwd_ref``): over the
channels a tree over each warp's channels and then over the warps, which
is ``_block_sum``'s tree over the block's 32; over the states a lane's
tree and then the lanes'; and a group recomputed from a kept start has the
states of the stretch's single pass, so kernel and plain version agree bit
for bit.
"""
import importlib.util
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.mamba_ref import (  # noqa: E402
    CHANNELS,
    _block_sum,
    _scan,
    mamba_scan_fwd_ref,
    record_steps,
    tree_sum,
)
from repro_torch.kernels.mamba_scan import (  # noqa: E402
    BWD_STATES,
    STATE_WIDTHS,
    bwd_plan,
    bwd_smem_bytes,
)
from repro_torch.kernels.testing import MAMBA_PROFILES, mamba_inputs  # noqa: E402

torch.set_num_threads(2)

MAX_SMEM = 232448                      # 227 KB: the most a block may use on an H100
SM_SMEM = 233472                       # 228 KB an SM, of which each resident block
BLOCK_RESERVE = 1024                   # takes 1 KB more than it asks for
SM_REGISTERS, SM_THREADS = 65536, 2048
_spec = importlib.util.spec_from_file_location(
    "chip_smoke", Path(__file__).resolve().parent.parent / "chip_smoke.py")
cs = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(cs)
# (b, S, di, ds): chip_smoke.py's phase M sweep at jamba's d_state, the
# training shape, and every other d_state the kernel is built for
SHAPES = ([(b, S, di, 16) for b in cs.MAMBA_B for S in cs.MAMBA_BWD_S for di in cs.MAMBA_DI]
          + [(1, cs.MAMBA_LONG_S, 8192, 16), (2, 4096, 8192, 16)]
          + [(2, S, 200, w) for w in cs.MAMBA_BWD_WIDTHS for S in cs.MAMBA_BWD_WIDTH_S]
          + [(1, 70, 130, 16), (2, 45, 96, 4)])
# (d_state, states a thread): the plan's, and at d_state 16 the 2 and 8 an
# ablation builds
SPLITS = [(ds, n) for ds, n in BWD_STATES.items()] + [(16, 2), (16, 8)]
ITEMSIZES = {"bf16": 2, "fp32": 4}


def _ids(shapes):
    return ["x".join(map(str, s)) for s in shapes]


def bwd_walk(plan, S):
    """The kernel's walk (the stretch loop of ``mamba_scan_bwd_kernel``), in
    its order: (what, stretch k, group, step t0) for each pass over a
    group's steps t0 .. t0 + steps - 1 of stretch k (absolute steps; those
    past S are identity steps). ``forward``: the forward pass from the
    recorded state, through the groups in order, keeping each one's start;
    ``recompute``: a group's states and exps again from its kept start;
    ``reverse``: its reverse steps, from its last step back. The last
    group's forward pass keeps its exps, so it is not recomputed."""
    R, U = plan.stretch, plan.steps
    for k in reversed(range(-(-S // R))):
        for grp in range(plan.groups):
            yield "forward", k, grp, k * R + grp * U
        for grp in reversed(range(plan.groups)):
            if grp < plan.groups - 1:
                yield "recompute", k, grp, k * R + grp * U
            yield "reverse", k, grp, k * R + grp * U


@pytest.mark.parametrize("shape", SHAPES, ids=_ids(SHAPES))
def test_bwd_plan_covers_every_state_once(shape):
    b, S, di, ds = shape
    p = bwd_plan(b, S, di, ds)
    assert p.states == BWD_STATES[ds] and p.lanes * p.states == ds
    assert p.threads == CHANNELS * p.lanes and p.warps * 32 == p.threads
    assert p.channels * p.warps == CHANNELS and p.grid == (-(-di // CHANNELS), b)
    seen = np.zeros((b, di, ds), np.int32)
    for y in range(p.grid[1]):
        for x in range(p.grid[0]):
            for t in range(p.threads):
                c, g = CHANNELS * x + t // p.lanes, t % p.lanes
                # a channel's lanes are neighbours in one warp, a warp's
                # channels neighbours in the block
                assert t // 32 == (t // p.lanes) // p.channels
                if c < di:
                    seen[y, c, g * p.states:(g + 1) * p.states] += 1
    assert (seen == 1).all()


@pytest.mark.parametrize("shape", SHAPES, ids=_ids(SHAPES))
def test_bwd_walk_reverses_every_step_once_by_groups(shape):
    """Each stretch: the forward pass through its groups in order, then the
    reverse steps of its groups from the last back; over the whole walk the
    reverse steps visit S - 1 .. 0 once each, in that order (the steps past
    S of the last stretch are identity steps)."""
    b, S, di, ds = shape
    p = bwd_plan(b, S, di, ds)
    assert p.stretch == record_steps(ds) and p.groups * p.steps == p.stretch
    assert p.steps * p.states == 32 and p.stretches == -(-S // p.stretch)
    walk = list(bwd_walk(p, S))
    reverse = []
    for k in reversed(range(p.stretches)):
        passes = [(what, grp, t0) for what, kk, grp, t0 in walk if kk == k]
        fwd = [(grp, t0) for what, grp, t0 in passes if what == "forward"]
        assert fwd == [(grp, k * p.stretch + grp * p.steps) for grp in range(p.groups)]
        rev = [grp for what, grp, _ in passes if what == "reverse"]
        assert rev == list(reversed(range(p.groups)))
        # the forward pass comes first, then each group's recompute right
        # before its reverse steps
        assert [what for what, _, _ in passes[:p.groups]] == ["forward"] * p.groups
        for (what, grp, t0) in passes[p.groups:]:
            if what == "reverse":
                reverse += list(range(t0 + p.steps - 1, t0 - 1, -1))
    assert [t for t in reverse if t < S] == list(range(S - 1, -1, -1))
    assert len(reverse) == p.stretches * p.stretch
    # the stretches in order: the walk is the kernel's, from the last
    assert [kk for _, kk, _, _ in walk] == sorted([kk for _, kk, _, _ in walk], reverse=True)


@pytest.mark.parametrize("ds", STATE_WIDTHS)
def test_each_group_starts_on_a_recorded_or_kept_state(ds):
    """A group's states are recomputed from the stretch's recorded state
    (group 0) or from a start the forward pass kept, and only after that
    pass went through it; the last group is never recomputed (the forward
    pass kept its exps and e h)."""
    p = bwd_plan(1, 200, 64, ds)
    kept = {}
    for what, k, grp, t0 in bwd_walk(p, 200):
        if what == "forward":
            assert t0 == k * p.stretch + grp * p.steps
            assert grp == 0 or (k, grp - 1) in kept      # in order, from the recorded state
            kept[(k, grp)] = "recorded" if grp == 0 else "kept"
        elif what == "recompute":
            assert grp < p.groups - 1 and (k, grp) in kept
        else:
            assert (k, grp) in kept
    assert kept[(0, 0)] == "recorded" and t0 == 0


@pytest.mark.parametrize("profile", MAMBA_PROFILES)
@pytest.mark.parametrize("ds", STATE_WIDTHS)
def test_recompute_from_a_kept_start_gives_the_plain_states(ds, profile):
    """The kernel's walk in its operations, fp32: the forward pass from each
    recorded state keeps each group's start (and the last group's exps and
    e h); a group recomputed from its kept start gives h, the exps and e h
    of the plain version's single pass over the stretch bit for bit."""
    b, S, di = 1, 77, 40
    u, dt, B, C, A, D = mamba_inputs(b, S, di, ds, profile, seed=S + ds)
    p = bwd_plan(b, S, di, ds)
    _, _, H = _scan(u, dt, B, C, A, D)                    # every step's h
    H = torch.stack(H, dim=1)                             # (b, S, di, ds)
    starts = mamba_scan_fwd_ref(u, dt, B, C, A, D)[2]
    E = torch.exp(dt[..., None] * A)                      # the plain version's exps
    du = dt * u

    def steps(h, t0, t1):
        out = []
        for t in range(t0, t1):
            e = torch.exp(dt[:, t, :, None] * A)
            eh = e * h
            h = eh + du[:, t, :, None] * B[:, t, None, :]
            out.append((h, e, eh))
        return h, out

    kept = {}
    for what, k, grp, t0 in bwd_walk(p, S):
        t1 = min(S, t0 + p.steps)
        if t0 >= S:
            continue
        if what == "forward":
            h0 = starts[:, k] if grp == 0 else kept[(k, grp)]
            h, _ = steps(h0, t0, t1)
            kept[(k, grp)] = h0
            kept[(k, grp + 1)] = h
        elif what == "recompute" or (what == "reverse" and grp == p.groups - 1):
            _, out = steps(kept[(k, grp)], t0, t1)
            for t, (h, e, eh) in zip(range(t0, t1), out):
                hprev = H[:, t - 1] if t > 0 else torch.zeros_like(h)
                assert torch.equal(h, H[:, t]) and torch.equal(e, E[:, t])
                assert torch.equal(eh, E[:, t] * hprev)


def _lane_tree(v, axis):
    """np.float32 tree over neighbouring pairs along ``axis`` (a power of
    two wide), each add rounded: the kernel's in-lane trees."""
    v = np.moveaxis(v, axis, -1)
    while v.shape[-1] > 1:
        v = (v[..., 0::2] + v[..., 1::2]).astype(np.float32)
    return v[..., 0]


@pytest.mark.parametrize("ds,states", SPLITS)
def test_warp_then_block_channel_sums_are_block_sum(ds, states):
    """A batch's sums over the channels as the kernel takes them, in numpy
    fp32: each lane sums a (step, state) over its warp's channels as a tree
    (v[m] += v[m + d]), the block adds the warps' sums as a tree; the bits
    of the plain version's ``_block_sum`` over the block's 32 channels."""
    p = bwd_plan(1, 32, 64, ds, states=states)
    rng = np.random.default_rng(ds * 10 + states)
    n, nblk = 2 * p.batch, 2
    x = (rng.standard_normal((1, n, nblk * CHANNELS, ds))
         * np.logspace(-3, 3, CHANNELS * nblk)[None, None, :, None]).astype(np.float32)
    warps = x.reshape(1, n, nblk, p.warps, p.channels, ds)
    v = [warps[..., m, :] for m in range(p.channels)]     # the lane's loads, channel by channel
    d = 1
    while d < p.channels:
        for m in range(0, p.channels - d, 2 * d):
            v[m] = (v[m] + v[m + d]).astype(np.float32)
        d *= 2
    per_warp = v[0]                                       # (1, n, nblk, warps, ds)
    got = _lane_tree(per_warp, axis=3)                    # (1, n, nblk, ds)
    want = _block_sum(torch.from_numpy(x)).numpy()        # (1, nblk, n, ds)
    assert np.array_equal(got.transpose(0, 2, 1, 3), want)


@pytest.mark.parametrize("ds,states", SPLITS)
def test_lane_then_lanes_state_sums_are_the_plain_tree(ds, states):
    """Each lane sums its states as a tree and a lane of the batch adds the
    channel's lanes' sums as a tree: the plain version's tree over all the
    states, bit for bit."""
    x = torch.tensor(np.random.default_rng(ds + states).standard_normal((4096, ds)),
                     dtype=torch.float32) * torch.logspace(-3, 3, ds)
    lanes = torch.stack([tree_sum(x[:, g * states:(g + 1) * states])
                         for g in range(ds // states)], dim=-1)
    assert torch.equal(tree_sum(lanes), tree_sum(x))


@pytest.mark.parametrize("ds,states", SPLITS)
def test_batch_sums_cover_each_output_once(ds, states):
    """In a batch of ``batch`` steps, lane l of a warp sums over the warp's
    channels the ``outputs`` states sq .. of step l // (ds / outputs); the
    warp's lanes cover every (step, state) once. Over the states, lane e
    % 32 takes (step e // channels, channel e % channels) for e = lane,
    lane + 32, ..: every (step, channel) of the warp once, and each lane
    one channel (the D it holds)."""
    p = bwd_plan(1, 32, 64, ds, states=states)
    assert p.stretch % p.batch == 0 and p.outputs >= 1
    per_step = ds // p.outputs
    cover = np.zeros((p.batch, ds), np.int32)
    for lane in range(32):
        j, sq = lane // per_step, (lane % per_step) * p.outputs
        cover[j, sq:sq + p.outputs] += 1
    assert (cover == 1).all()
    cover = np.zeros((p.batch, p.channels), np.int32)
    for lane in range(32):
        chans = set()
        for e in range(lane, p.batch * p.channels, 32):
            cover[e // p.channels, e % p.channels] += 1
            chans.add(e % p.channels)
        assert len(chans) <= 1 and chans <= {lane % p.channels}
    assert (cover == 1).all()


@pytest.mark.parametrize("itemsize", list(ITEMSIZES.values()), ids=list(ITEMSIZES))
@pytest.mark.parametrize("ds,states", SPLITS)
def test_staging_covers_a_stretch_once(ds, states, itemsize):
    """The copies of a stretch: piece e = tid + threads i of u, dt and dy is
    array e // (R 32 / vec), row (e % ..) // (32 / vec), channels vec (e %
    (32 / vec)) ..; of B and C, array e // (R ds / vec), row, vec words; the
    conversion's piece e: array e // (R 4), row e % R, channels 8 ((e % 4 R)
    // R) .. + 7. Each covers the raw stretch once."""
    p = bwd_plan(1, 32, 64, ds, itemsize, states=states)
    R, vec = p.stretch, 16 // itemsize
    staged = np.zeros((3, R, CHANNELS), np.int32)
    row_pieces = CHANNELS // vec
    for tid in range(p.threads):
        for e in range(tid, 3 * R * row_pieces, p.threads):
            arr, rr, cc = e // (R * row_pieces), (e % (R * row_pieces)) // row_pieces, \
                vec * (e % row_pieces)
            staged[arr, rr, cc:cc + vec] += 1
    assert (staged == 1).all()
    if ds % vec == 0:
        bc = np.zeros((2, R, ds), np.int32)
        pieces = R * ds // vec
        for tid in range(p.threads):
            for e in range(tid, 2 * pieces, p.threads):
                j = vec * (e % (ds // vec))
                bc[e // pieces, (e % pieces) // (ds // vec), j:j + vec] += 1
        assert (bc == 1).all()
    conv = np.zeros((3, R, CHANNELS), np.int32)
    pieces = R * (CHANNELS // 8)
    for e in range(3 * pieces):
        cc = 8 * ((e % pieces) // R)
        conv[e // pieces, e % R, cc:cc + 8] += 1
    assert (conv == 1).all()


@pytest.mark.parametrize("itemsize", list(ITEMSIZES.values()), ids=list(ITEMSIZES))
@pytest.mark.parametrize("ds,states", SPLITS)
def test_bwd_plan_fits_the_card(ds, states, itemsize):
    """Shared memory: u, dt, dy [32][R + 4] and B, C [R][ds] in fp32; each
    warp's batch [batch][channels ds + 16] and state sums [2][batch][32];
    the warps' channel sums [warps][R][ds] (dC, then dB); each thread's
    kept group starts [groups - 1][threads][states]; the raw stretch in the
    inputs' dtype. The resident blocks the launch bounds ask for fit an
    SM's shared memory and threads (at d_state 16 in bf16, 4 blocks of 128
    threads: the training shape's 512 blocks on 132 SMs in one wave; 3 in
    fp32) and leave each thread at least 128 registers."""
    p = bwd_plan(2, 4096, 8192, ds, itemsize, states=states)
    R = p.stretch
    words = (3 * CHANNELS * (R + 4) + 2 * R * ds
             + p.warps * (p.batch * (p.channels * ds + 16) + 2 * p.batch * 32)
             + p.warps * R * ds + (p.groups - 1) * p.threads * p.states)
    assert p.smem_bytes == 4 * words + (3 * R * CHANNELS + 2 * R * ds) * itemsize
    assert p.smem_bytes % 16 == 0 and p.smem_bytes <= MAX_SMEM
    assert p.min_blocks * (p.smem_bytes + BLOCK_RESERVE) <= SM_SMEM
    assert p.min_blocks * p.threads <= SM_THREADS
    assert SM_REGISTERS // (p.min_blocks * p.threads) >= 128
    assert p.grid[0] < 2 ** 31 and p.grid[1] <= 65535
    if states == 4:
        assert p.min_blocks == min(4, SM_SMEM // (p.smem_bytes + BLOCK_RESERVE)) >= 3
    if ds == 16 and states == BWD_STATES[16] and itemsize == 2:
        assert p.min_blocks == 4 and p.min_blocks * 132 >= p.grid[0] * p.grid[1]
    assert bwd_smem_bytes(ds, itemsize, states) == p.smem_bytes


def test_bwd_plan_refuses_unbuilt_state_widths():
    for ds in (2, 12, 128):
        with pytest.raises(ValueError):
            bwd_plan(1, 8, 64, ds)
