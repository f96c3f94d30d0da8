"""Host-side geometry and arithmetic of the redesigned decode-path kernels,
held on the CPU to what the CUDA kernels need.

The absorbed-MLA decode (``csrc/paged_mla_decode.cu``): the host picks the
pages an item walks from b, h and the table width alone
(``kernels/paged_decode.py:mla_geometry``); block i x items a slot + k
takes item k of slot i, and a block whose item starts past the slot's live
pages returns before any barrier (``mla_items`` lists the blocks that
stay). Every such block must walk at least one live page, the items must
cover each slot's live pages once and in order, and the grid must hold
them all. Its tensor-core products split each fp32 operand into
three bf16 parts (``kernels/paged_ref.py:bf16x3``): the parts give the
operand back, and the three-pass product stays within the fp32 rung of the
fp32 product, the cold tier's scale folded onto the fp32 side included.

The chunkwise mLSTM (``csrc/mlstm_chunk.cu``) cuts a call into the
reference's 256-token chunks, the last one ragged
(``kernels/mlstm_chunk.py:chunk_lengths``)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.mlstm_chunk import CHUNK, chunk_lengths  # noqa: E402
from repro_torch.kernels.paged_decode import (  # noqa: E402
    MLA_HEADS,
    MLA_MAX_SMEM,
    mla_geometry,
    mla_items,
    mla_smem_bytes,
)
from repro_torch.kernels.paged_ref import bf16x3, bf16x3_matmul  # noqa: E402
from repro_torch.kernels.testing import Tol, assert_scaled_close  # noqa: E402

RUNG = Tol(rtol=5e-5, atol=5e-5)       # the fp32 rung, RMS-scaled
SMS = (132, 114)
PAGE = 16
# (name, lens, table width, heads): chip_smoke.py's timed shapes (the
# deepseek cell mid-trace, and the streaming cell's sink + window + 1 pages),
# its check shapes (one slot; four with a null slot), a head count that is
# not a multiple of the head group, and a long table
CASES = [
    ("hot", [40, 176, 87, 128], 16, 128),
    ("streaming", [95, 95, 95, 95], 8, 128),
    ("one slot", [185], 12, 128),
    ("null slot", [0, 16, 31, 191], 12, 128),
    ("ragged heads", [3, 20, 0, 40], 16, 72),
    ("long", [4000, 17, 2500, 4095], 256, 128),
]


def _live(n, n_pages, page=PAGE):
    return min(n_pages, n // page + 1)


@pytest.mark.parametrize("sms", SMS)
@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_mla_items_walk_live_pages_once(case, sms):
    _, lens, n_pages, h = case
    b = len(lens)
    ppi, per_slot = mla_geometry(b, h, n_pages, sms)
    items = mla_items(lens, PAGE, n_pages, ppi)
    assert 1 <= ppi <= n_pages and per_slot == -(-n_pages // ppi)
    # every block that stays walks at least one live page, at most ppi
    assert all(0 < end - first <= ppi for _, _, first, end in items)
    # the grid (b x items a slot) holds every item, one block each: no live
    # page is dropped
    blocks = [z for z, _, _, _ in items]
    assert len(set(blocks)) == len(blocks) and all(0 <= z < b * per_slot for z in blocks)
    # each slot's live pages, once, in order, on the slot's blocks
    for i, n in enumerate(lens):
        walked = [j for z, s, first, end in items if s == i for j in range(first, end)]
        assert walked == list(range(_live(n, n_pages)))
        assert all(i * per_slot <= z < (i + 1) * per_slot for z, s, _, _ in items if s == i)


@pytest.mark.parametrize("case", CASES[:2], ids=[c[0] for c in CASES[:2]])
def test_mla_timed_shapes_put_one_page_on_each_busy_block(case):
    """At the timed shapes the pages alone fit the SMs: one page an item,
    and the live items are fewer than the SMs (one wave, no block walks
    two pages while another walks none)."""
    _, lens, n_pages, h = case
    ppi, _ = mla_geometry(len(lens), h, n_pages, 132)
    items = mla_items(lens, PAGE, n_pages, ppi)
    assert ppi == 1
    assert len(items) * -(-h // MLA_HEADS) <= 132
    assert len(items) == sum(_live(n, n_pages) for n in lens)


def test_mla_geometry_lengthens_items_when_pages_outnumber_the_sms():
    # 64 slots x 2 head groups already fill the SMs: one item a slot
    assert mla_geometry(64, 128, 256, 132) == (256, 1)
    # 16 slots: 4 items a slot, of equal length
    assert mla_geometry(16, 128, 256, 132) == (64, 4)
    # ragged: 4 slots of a 20-page table, 16 items a slot at most -> 2
    # pages an item, 10 items a slot
    assert mla_geometry(4, 128, 20, 132) == (2, 10)


def test_mla_null_and_single_slot_have_one_item():
    ppi, _ = mla_geometry(1, 128, 12, 132)
    assert mla_items([0], PAGE, 12, ppi) == [(0, 0, 0, 1)]
    # the null slot (length 0) walks its one harmless page; blocks 0, 12
    # and 24 are the first of their slots' 12
    assert mla_items([0, 15, 16], PAGE, 12, 1) == [(0, 0, 0, 1), (12, 1, 0, 1), (24, 2, 0, 1),
                                                   (25, 2, 1, 2)]


def test_mla_shared_memory_budget():
    """deepseek's widths fit one block, hot and cold; a rope twice as wide
    does not fit the cold kernel, and the wrapper refuses it."""
    assert mla_smem_bytes(512, 64, False) <= MLA_MAX_SMEM
    assert mla_smem_bytes(512, 64, True) <= MLA_MAX_SMEM
    assert mla_smem_bytes(512, 128, True) > MLA_MAX_SMEM
    # padding: latent and rope widths round up to 16
    assert mla_smem_bytes(20, 12, False) == mla_smem_bytes(32, 16, False)


@pytest.mark.parametrize("scale", [1.0, 1e-3, 3e4])
def test_bf16x3_parts_give_the_operand_back(scale):
    x = torch.tensor(np.random.default_rng(0).standard_normal(4096) * scale,
                     dtype=torch.float32)
    hi, mid, lo = bf16x3(x)
    assert hi.dtype == mid.dtype == lo.dtype == torch.bfloat16
    assert torch.equal((hi.float() + mid.float()) + lo.float(), x)
    # each part is below the previous one's rounding step
    assert (mid.float().abs() <= hi.float().abs() * 2.0 ** -8).all()
    assert (lo.float().abs() <= mid.float().abs() * 2.0 ** -8).all()


@pytest.mark.parametrize("depth", [16, 576])
def test_bf16x3_product_within_the_fp32_rung(depth):
    """The scores' product (q fp32 against bf16 latent keys) and p . v
    (probabilities against bf16 values) in three passes, against the same
    product in fp64."""
    rng = np.random.default_rng(depth)
    a = torch.tensor(rng.standard_normal((64, depth)), dtype=torch.float32)
    b = torch.tensor(rng.standard_normal((depth, 16)), dtype=torch.float32).bfloat16()
    got = bf16x3_matmul(a, b)
    ref = (a.double() @ b.double()).float()
    assert_scaled_close(got.numpy(), ref.numpy(), RUNG)
    # one bf16 pass alone is far outside it
    one = (a.bfloat16().float() @ b.float())
    assert not np.allclose(one.numpy() / ref.pow(2).mean().sqrt().item(),
                           ref.numpy() / ref.pow(2).mean().sqrt().item(),
                           rtol=RUNG.rtol, atol=RUNG.atol)


def test_bf16x3_cold_scale_folds_onto_the_fp32_side():
    """A cold page's keys are q8 * scale per column: the kernel multiplies
    q by the scale and splits that against the exact bf16 codes, and sums
    p . q8 before the column's scale. Both stay within the rung of the
    reference's dequantized fp32 products."""
    rng = np.random.default_rng(3)
    q = torch.tensor(rng.standard_normal((64, 576)), dtype=torch.float32)
    codes = torch.tensor(rng.integers(-127, 128, (16, 576)), dtype=torch.float32)
    scale = torch.tensor(rng.uniform(1e-3, 5e-2, 576), dtype=torch.float32)
    keys = codes * scale                                   # the reference's widening
    got = bf16x3_matmul(q * scale, codes.t().bfloat16())
    ref = (q.double() @ keys.t().double()).float()
    assert_scaled_close(got.numpy(), ref.numpy(), RUNG)
    p = torch.softmax(ref * 0.07, dim=-1)
    got_pv = bf16x3_matmul(p, codes.bfloat16()) * scale
    ref_pv = (p.double() @ keys.double()).float()
    assert_scaled_close(got_pv.numpy(), ref_pv.numpy(), RUNG)


@pytest.mark.parametrize("S,expect", [
    (1, [1]), (37, [37]), (160, [160]), (256, [256]), (257, [256, 1]),
    (300, [256, 44]), (1000, [256, 256, 256, 232])])
def test_mlstm_kernel_chunks(S, expect):
    """T = min(256, S), the reference's chunk, with a ragged last chunk:
    a prompt of up to 256 tokens is one chunk (no carried-state product
    from the empty state)."""
    assert CHUNK == 256
    assert chunk_lengths(S) == expect
    assert sum(chunk_lengths(S)) == S
