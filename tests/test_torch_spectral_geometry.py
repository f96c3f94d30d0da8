"""The spectral kernels' launch geometry (``kernels/spectral_matmul.py``),
a pure-Python function that the CPU suite can hold to what the CUDA
kernels need: the m-reduction's cluster size (the number of m slices,
which fixes every row's summation order) depends on m alone, the decode
grid covers the SMs, and every checked shape gets a geometry the kernels
accept. The int8 kernels (``kernels/spectral_matmul_q8.py``) launch with
the same geometry (bf16 activations on the tensor-core kernel, fp32 on
the CUDA-core one) and get the same checks at their shapes."""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.spectral_matmul import (  # noqa: E402
    MAX_CLUSTER,
    MAX_RANK,
    TC_COL_ALIGN,
    cluster_size,
    kernel_geometry,
    launch_geometry,
    row_tile,
    split_over_cluster,
)
from repro_torch.kernels.testing import SPECTRAL_Q8_SHAPES, SPECTRAL_SHAPES  # noqa: E402

SMS = (132, 114, 78)     # H100 SXM, H100 PCIe, a part with fewer SMs
ROWS = (1, 4, 8, 16, 17, 37, 64, 160, 256, 1000, 4096, 8192, 16384)
DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
# the main paths' decode projections (M = 4 serving slots): llama3.2-1b's
# and smollm2's MLP, xlstm-1.3b's four, jamba's rank-256 MLP, deepseek's
# dense MLP and its d_model -> q_lora projection
DECODE = [(2048, 8192, 128), (8192, 2048, 128), (4096, 2048, 128), (2048, 5460, 128),
          (2730, 2048, 128), (4096, 14336, 256), (14336, 4096, 256), (7168, 18432, 128),
          (18432, 7168, 128), (7168, 1536, 128)]
# the int8 serving cells' spectral projections: llama3.2-1b's MLP, rank 128
INT8_MLP = [(2048, 8192, 128), (8192, 2048, 128)]


def grid_blocks(M, n, rows, width, bn):
    """Blocks a launch runs (csrc/spectral_matmul_tc.cu:launch): row tiles
    x column blocks rounded up to whole clusters of ``width`` blocks."""
    return -(-M // rows) * (-(-(-(-n // bn)) // width) * width)


def _ids(shape):
    return "x".join(map(str, shape))


def _cluster_depends_on_m_alone(m, n):
    for dtype in DTYPES.values():
        got = {kernel_geometry(M, m, n, dtype, sms)[2] for M in ROWS for sms in SMS}
        assert got == {cluster_size(m)}, (dtype, got)
    assert cluster_size(m) in (1, 2, 4, 8) and cluster_size(m) <= MAX_CLUSTER


def _decode_grid_covers_the_sms(m, n, dtype):
    for sms in SMS:
        rows, split, cl, bn = kernel_geometry(4, m, n, dtype, sms)
        assert split
        blocks = grid_blocks(4, n, rows, cl, bn)
        assert min(0.75 * sms, n // 16 // cl * cl) <= blocks <= sms, (sms, blocks, cl, bn)


@pytest.mark.parametrize("shape", SPECTRAL_SHAPES, ids=_ids)
def test_cluster_size_depends_on_m_alone(shape):
    """Whatever M, the SM count, the dtype's row tile or the choice to run
    the slices on a cluster or in one block, the number of m slices is
    cluster_size(m): a row's sums run in one order at every M."""
    _cluster_depends_on_m_alone(shape[1], shape[2])


@pytest.mark.parametrize("shape", SPECTRAL_Q8_SHAPES, ids=_ids)
def test_int8_cluster_size_depends_on_m_alone(shape):
    """The same for the int8 kernels' checked shapes: batch invariance of
    the int8 serving cells' rows rests on it."""
    _cluster_depends_on_m_alone(shape[1], shape[2])


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("mnk", DECODE, ids=_ids)
def test_decode_grid_covers_the_sms(mnk, dtype):
    """At decode (M = 4) the work is the factors, spread over the card:
    the grid runs at most one block an SM, and at least three quarters of
    the SMs' count in blocks, or every 16-column block of a narrower n."""
    _decode_grid_covers_the_sms(mnk[0], mnk[1], DTYPES[dtype])


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("mnk", INT8_MLP, ids=_ids)
def test_int8_decode_grid_covers_the_sms(mnk, dtype):
    """The same for the int8 serving cells' projections."""
    _decode_grid_covers_the_sms(mnk[0], mnk[1], DTYPES[dtype])


def _valid_geometry(M, m, n, k, dt, vec):
    """What the launchers accept (csrc/spectral_matmul_tc.cu,
    csrc/spectral_matmul.cuh, csrc/spectral_matmul_q8.cu): a rank of whole
    16-byte factor rows (``vec`` elements), a row tile they are built for
    that the cluster divides, whole 16-byte column blocks of y in bf16,
    column blocks that cover n exactly once, m slices that cover m, a grid
    within CUDA's limits."""
    assert k <= MAX_RANK and k % vec == 0
    rows, split, cl, bn = kernel_geometry(M, m, n, dt, 132)
    assert rows in ((16, 64) if dt == torch.bfloat16 else (8, 32))
    assert rows % cl == 0
    assert cl in (1, 2, 4, 8) and bn >= 1
    if dt == torch.bfloat16:
        assert bn % TC_COL_ALIGN == 0
    col_blocks = -(-n // bn)
    assert (col_blocks - 1) * bn < n <= col_blocks * bn
    width = cl if split else 1
    assert -(-col_blocks // width) * width <= 65535
    mslice = -(-(-(-m // cl)) // 64) * 64     # the tensor-core slice: whole 64-wide stages
    assert cl * mslice >= m


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("shape", SPECTRAL_SHAPES, ids=_ids)
def test_every_checked_shape_gets_a_valid_geometry(shape, dtype):
    """Every checked shape of the bf16 and fp32 kernels: their rank fills
    whole 16-byte rows of the dtype."""
    M, m, n, k = shape
    dt = DTYPES[dtype]
    _valid_geometry(M, m, n, k, dt, 16 // dt.itemsize)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("mnk", INT8_MLP + [s[1:] for s in SPECTRAL_Q8_SHAPES], ids=_ids)
def test_every_int8_shape_gets_a_valid_geometry(mnk, dtype):
    """Every M of ``ROWS`` on the int8 serving cells' projections and on
    the int8 kernels' checked shapes: int8 rows of 16 codes, and the
    geometry the launchers accept."""
    m, n, k = mnk
    for M in ROWS:
        _valid_geometry(M, m, n, k, DTYPES[dtype], 16)


@pytest.mark.parametrize("M,expect", [(1, True), (16, True), (17, True), (160, True),
                                      (4096, True), (4224, False), (8192, False)])
def test_one_block_runs_the_slices_only_when_row_tiles_fill_the_card(M, expect):
    """At decode and mid-size M the m slices run on a cluster; once the
    64-row tiles alone reach half the SMs (132 here) one block runs them
    all, which gives the same bits without the cluster reduction."""
    rows = row_tile(M, torch.bfloat16)
    assert split_over_cluster(M, rows, 132) is expect
    if not expect:   # phase 1 runs once or twice a row tile, not once a column block
        cl, bn = launch_geometry(M, 2048, 8192, 132, rows, TC_COL_ALIGN, split=False)
        assert cl == cluster_size(2048) and bn >= 8192 // 2
