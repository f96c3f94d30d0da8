"""Port vs reference: the paged GQA decode and the paged-cache ops.

The port's wrapper runs its plain version (gather + fp32 masked
softmax) on CPU tensors. It is held against the reference's
``paged_gqa_decode_ref`` in fp32 and against the reference's Pallas
kernel in interpret mode in fp32 and bf16, with ragged ``seq_lens``
(empty slot, page edges, full), a shuffled block table and a slot that
points only at the null page. Inputs come from numpy and feed both.

Tolerances (ladder, outputs scaled by the reference's RMS): fp32 5e-5 —
both compute in fp32 and differ by summation order (the kernel's online
softmax vs a direct softmax); bf16 5e-2 — q and the pools are bf16,
both compute in fp32 and round once at the output, so in practice they
agree to one bf16 ulp. The reference's gather oracle computes in q's
dtype, which in bf16 is not the fp32 decode contract, so it is compared
in fp32 only. The CUDA kernel is held against the plain version on the
card by chip_smoke.py and tests/test_torch_kernels_cuda.py; here its
launch geometry (``gqa_geometry``) is checked at the main path's shapes,
and a model of its walk reads every live row once and no page past the
one holding the last position.
"""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels.paged_decode import paged_gqa_decode_pallas  # noqa: E402
from repro.kernels.paged_ref import paged_gqa_decode_ref as jax_paged_ref  # noqa: E402
from repro.kernels.testing import forced_interpret  # noqa: E402
from repro.serving import paged_cache as jpc  # noqa: E402
from repro_torch.kernels.build import LAUNCHES  # noqa: E402
from repro_torch.kernels.paged_decode import (  # noqa: E402
    GQA_WARPS,
    gqa_geometry,
    paged_gqa_decode,
    paged_gqa_decode_cuda,
)
from repro_torch.kernels.paged_ref import paged_gqa_decode_ref  # noqa: E402
from repro_torch.kernels.testing import (  # noqa: E402
    TOLERANCE_LADDER,
    assert_kernel_matches,
    assert_scaled_close,
    make_block_table,
    ragged_seq_lens,
)
from repro_torch.serving import paged_cache as pc  # noqa: E402

torch.set_num_threads(2)

# b, kvh, rep, hd, page, n_pages_per_seq: MQA, grouped, MHA, odd page
# sizes and head dims off every tile multiple
CASES = [
    (5, 2, 3, 64, 4, 6),
    (4, 1, 4, 20, 3, 5),
    (4, 4, 1, 48, 8, 4),
]
DTYPES = {"float32": (torch.float32, jnp.float32), "bfloat16": (torch.bfloat16, jnp.bfloat16)}


def _case(b, kvh, rep, hd, page, n, seed=0):
    """numpy inputs: random pools (null page included), ragged lengths,
    a shuffled block table, and slot 0 parked on the null page."""
    num_pages = b * n + 3
    rng = np.random.default_rng(seed)
    k_pool = rng.standard_normal((num_pages + 1, page, kvh, hd)).astype(np.float32)
    v_pool = rng.standard_normal((num_pages + 1, page, kvh, hd)).astype(np.float32)
    q = rng.standard_normal((b, kvh, rep, hd)).astype(np.float32)
    sl = ragged_seq_lens(b, page * n - 1, page, seed)
    bt = make_block_table(b, n, num_pages, sl, page, seed)
    bt[0, :] = num_pages                  # inactive slot: null page, len 0
    return q, k_pool, v_pool, bt.numpy(), sl.numpy()


def _port(q, k_pool, v_pool, bt, sl, tdt):
    return paged_gqa_decode(torch.tensor(q).to(tdt), torch.tensor(k_pool).to(tdt),
                            torch.tensor(v_pool).to(tdt), torch.tensor(bt), torch.tensor(sl))


@pytest.mark.parametrize("case", CASES, ids=lambda c: "-".join(map(str, c)))
def test_plain_matches_reference_oracle_fp32(case):
    q, kp, vp, bt, sl = _case(*case)
    launches = LAUNCHES["paged_gqa_decode"]
    y = _port(q, kp, vp, bt, sl, torch.float32)
    assert LAUNCHES["paged_gqa_decode"] == launches    # CPU tensors: plain version
    yr = jax_paged_ref(jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
                       jnp.asarray(bt), jnp.asarray(sl))
    assert_scaled_close(y.numpy(), yr, TOLERANCE_LADDER[torch.float32])


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("case", CASES, ids=lambda c: "-".join(map(str, c)))
def test_plain_matches_reference_kernel(case, dtype):
    tdt, jdt = DTYPES[dtype]
    q, kp, vp, bt, sl = _case(*case)
    y = _port(q, kp, vp, bt, sl, tdt)
    assert y.dtype == tdt
    with forced_interpret():
        yr = paged_gqa_decode_pallas(jnp.asarray(q, jdt), jnp.asarray(kp, jdt),
                                     jnp.asarray(vp, jdt), jnp.asarray(bt), jnp.asarray(sl))
    assert_scaled_close(y.float().numpy(), yr, TOLERANCE_LADDER[tdt])


def test_paged_cache_ops_match_reference():
    """append / write_slice / copy_page / gather: same pools as the
    reference's functional ops (the port's write in place)."""
    rng = np.random.default_rng(3)
    P, page, f = 9, 4, (2, 3)
    pool = rng.standard_normal((P + 1, page, *f)).astype(np.float32)
    bt = np.array([[3, 7, 1], [P, P, P], [0, 5, P]], np.int32)
    lens = np.array([9, 0, 6], np.int32)
    vals = rng.standard_normal((3, *f)).astype(np.float32)
    chunk = rng.standard_normal((5, *f)).astype(np.float32)

    jp = jpc.paged_append(jnp.asarray(pool), jnp.asarray(bt), jnp.asarray(lens),
                          jnp.asarray(vals))
    jp = jpc.paged_write_slice(jp, jnp.asarray(bt[2]), jnp.int32(3), jnp.asarray(chunk))
    jp = jpc.copy_page(jp, jnp.int32(5), jnp.int32(8))
    tp = torch.tensor(pool)
    pc.paged_append(tp, torch.tensor(bt), torch.tensor(lens), torch.tensor(vals))
    pc.paged_write_slice(tp, torch.tensor(bt[2]), 3, torch.tensor(chunk))
    pc.copy_page(tp, 5, 8)
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(
        pc.paged_gather(tp, torch.tensor(bt)).numpy(),
        np.asarray(jpc.paged_gather(jp, jnp.asarray(bt))))


def test_page_pool_refcounts_match_reference():
    """The copied allocator behaves identically under one op sequence."""
    pools = [pc.PagePool(6), jpc.PagePool(6)]
    logs = []
    for pool in pools:
        a = pool.alloc(3)
        pool.share(a[:2])
        pool.pin([a[0]])
        pool.release(a[:2])
        b = pool.alloc(2)
        pool.release([a[2]])
        logs.append((a, b, pool.free_count, pool.allocated_count, pool.peak_allocated,
                     [pool.refcount(i) for i in range(6)]))
        with pytest.raises(RuntimeError):
            pool.release([a[0]])               # below its pin
    assert logs[0] == logs[1]


def test_cuda_wrapper_rejects_non_bf16_pools():
    """The port keeps KV pools in bf16; the kernel reads nothing else."""
    q, kp, vp, bt, sl = (torch.tensor(a) for a in _case(*CASES[0]))
    with pytest.raises(TypeError, match="bf16 pools"):
        paged_gqa_decode_cuda(q, kp, vp, bt, sl)


def _drop_last_position(q, kp, vp, bt, sl):
    return paged_gqa_decode_ref(q, kp, vp, bt, (sl - 1).clamp(min=0))


def _wrong_k_head(q, kp, vp, bt, sl):
    return paged_gqa_decode_ref(q, kp.flip(2), vp, bt, sl)


@pytest.mark.parametrize("fault", [_drop_last_position, _wrong_k_head],
                         ids=lambda f: f.__name__[1:])
def test_ladder_check_rejects_faulty_kernel(fault):
    """The bf16 kernel-vs-plain check at the main path's decode shape
    (kvh 8, rep 4, hd 64, page 16) fails a kernel that drops the token
    appended this step, or that reads another kv head's keys."""
    q, kp, vp, bt, sl = _case(8, 8, 4, 64, 16, 12)
    args = (torch.tensor(q).bfloat16(), torch.tensor(kp).bfloat16(),
            torch.tensor(vp).bfloat16(), torch.tensor(bt), torch.tensor(sl))
    assert_kernel_matches(paged_gqa_decode_ref, paged_gqa_decode_ref, args)
    with pytest.raises(AssertionError):
        assert_kernel_matches(fault, paged_gqa_decode_ref, args)


@pytest.mark.parametrize("hd, page, n_pages, expect", [
    (64, 16, 16, (8, 8, 16, 1, 2)),      # llama3.2-1b serving: a warp a 16-row page
    (64, 16, 8, (8, 8, 16, 1, 1)),       # the streaming cell's 8-page tables
    (128, 16, 16, (8, 16, 8, 2, 4)),     # jamba: half a page a unit
    (64, 16, 256, (8, 8, 16, 1, 32)),    # a 4096-token table
    (64, 16, 600, (8, 8, 16, 1, 75)),    # past 32 units a warp: the table entries reload
    (20, 3, 5, (4, 8, 16, 1, 1)),        # 8-byte vectors, 5 of 8 lanes a row
    (48, 8, 4, (8, 8, 16, 1, 1)),        # 6 of 8 lanes a row
    (16, 16, 40, (8, 2, 64, 1, 5)),      # the reduced configs' head dim
])
def test_gqa_geometry(hd, page, n_pages, expect):
    """The launch geometry of ``csrc/paged_decode.cu`` at the main path's
    shapes, the card tests' odd ones and long tables."""
    assert gqa_geometry(hd, page, n_pages) == expect


@pytest.mark.parametrize("hd", [512, 260, 129])
def test_gqa_geometry_refuses_rows_wider_than_a_warp(hd):
    with pytest.raises(ValueError, match="lanes a row"):
        gqa_geometry(hd, 16, 16)


@pytest.mark.parametrize("hd, page, n_pages", [(64, 16, 16), (128, 16, 16), (64, 16, 256),
                                               (20, 3, 5), (16, 16, 40), (64, 4, 600)])
def test_gqa_walk_reads_each_live_row_once(hd, page, n_pages):
    """The kernel's walk, modelled from its geometry: every warp w takes
    units w, w + W, ... for its trip count, and reads the live ones (up to
    the one holding position len). Every position 0..len is read exactly
    once, by lanes that cover all of hd, and no page past the one holding
    len is touched."""
    e, lp, rows, per_page, iters = gqa_geometry(hd, page, n_pages)
    assert e * lp >= hd > e * lp // 2 or lp == 1
    for length in sorted({0, 1, page - 1, page, 3 * page + 1, page * n_pages - 1}):
        if length >= page * n_pages:
            continue
        last = length // page
        live = last * per_page + (length - last * page) // rows + 1
        seen = []
        for w in range(GQA_WARPS):
            for u in range(w, w + iters * GQA_WARPS, GQA_WARPS):
                if u >= live:
                    continue
                pg, row0 = u // per_page, (u % per_page) * rows
                assert pg <= last
                seen += [pg * page + row0 + r for r in range(min(rows, page - row0))
                         if pg * page + row0 + r <= length]
        assert sorted(seen) == list(range(length + 1))
