"""The port's CUDA kernels against their plain PyTorch versions, on the
card: the spectral matmul (and its autograd; also at qwen2-vl-72b's MLP,
rank 256), its int8 variant (also at deepseek's dense MLP), the paged GQA
decode (also at qwen2-vl's rep 8, head dim 128) and its cold-tier variant, the absorbed-MLA paged
decode and its cold-tier variant, the flash-attention forward and
backward, the chunkwise mLSTM (forward and backward) and the selective
scan (forward and backward); the reduced xlstm's training step, and the
reduced xlstm, jamba and deepseek engines on the card. Every test here needs a GPU and skips without one
(the kernels have no CPU mode). The file imports neither JAX nor the reference
package, so it runs on a machine with CUDA and no JAX:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_kernels_cuda.py

Tolerances are the ladder's (fp32 5e-5, bf16 5e-2 on outputs scaled by
the reference's RMS, so a rung is a fraction of a typical output):
kernel and plain version compute the same fp32 sums in another order.
Inputs give O(1) outputs; the inactive null-page slot, whose output is
one raw V row, is compared on its own so it does not set the scale of
the live slots.
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.config import get_config  # noqa: E402
from repro_torch.kernels.build import LAUNCHES  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    flash_attention_bwd,
    flash_attention_fwd,
)
from repro_torch.kernels.flash_ref import flash_bwd_ref, flash_fwd_ref  # noqa: E402
from repro_torch.kernels.ops import spectral_matmul, spectral_matmul_q8  # noqa: E402
from repro_torch.kernels.paged_decode import (  # noqa: E402
    paged_gqa_decode,
    paged_gqa_decode_cold,
    paged_mla_decode,
    paged_mla_decode_cold,
)
from repro_torch.kernels.paged_ref import (  # noqa: E402
    paged_gqa_decode_cold_ref,
    paged_gqa_decode_ref,
    paged_mla_decode_cold_ref,
    paged_mla_decode_ref,
)
from repro_torch.kernels.mlstm_chunk import CHUNK as MLSTM_KERNEL_CHUNK  # noqa: E402
from repro_torch.kernels.mlstm_chunk import (  # noqa: E402
    bwd_plan,
    mlstm_chunk,
    mlstm_chunk_bwd_cuda,
)
from repro_torch.kernels.mlstm_ref import mlstm_chunk_bwd_ref, mlstm_chunk_ref  # noqa: E402
from repro_torch.kernels.mamba_ref import (  # noqa: E402
    mamba_scan_bwd_ref,
    mamba_scan_fwd_ref,
    mamba_scan_ref,
)
from repro_torch.kernels.mamba_scan import (  # noqa: E402
    mamba_scan,
    mamba_scan_bwd_cuda,
    mamba_scan_cuda,
)
from repro_torch.kernels.ref import spectral_matmul_q8_ref, spectral_matmul_ref  # noqa: E402
from repro_torch.serving.quantize import quantize_kv_pages  # noqa: E402
from repro_torch.kernels.testing import (  # noqa: E402
    MAMBA_PROFILES,
    MLSTM_PROFILES,
    SCALE_PROFILES,
    SPECTRAL_Q8_SHAPES,
    SPECTRAL_SHAPES,
    assert_kernel_matches,
    assert_scaled_close,
    gqa_inputs,
    make_block_table,
    mamba_inputs,
    mamba_model_layout,
    mla_inputs,
    mlstm_bwd_reordered,
    mlstm_inputs,
    noise_scale,
    ragged_seq_lens,
    scale_profile,
    tolerance_for,
)

pytestmark = pytest.mark.cuda

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
SPECTRAL = SPECTRAL_SHAPES
SPECTRAL_Q8 = SPECTRAL_Q8_SHAPES
# b, kvh, rep, hd, page, n_pages_per_seq
PAGED = [(5, 2, 3, 64, 4, 6), (4, 1, 4, 20, 3, 5), (4, 4, 1, 48, 8, 4), (8, 8, 4, 64, 16, 12),
         (4, 8, 4, 128, 16, 12),     # jamba's attention layers: head dim 128
         (4, 8, 8, 128, 16, 12),     # qwen2-vl-72b's: 64 heads over 8, head dim 128
         (4, 8, 4, 64, 16, 256),     # a 4096-token table: 32 units a warp
         (2, 4, 2, 64, 16, 600)]     # 9600 tokens: past 32 units a warp
# b, h, lat, rope, page, n_pages_per_seq of the absorbed-MLA decode: the
# reduced deepseek's widths, ragged head groups (72 heads: a 64-head block
# and a block of 8) and page sizes (40 rows: three 16-row tiles, the last
# ragged), and deepseek-v3-671b's (128 heads, latent 512, rope 64, page 16)
MLA = [(3, 4, 16, 8, 4, 6), (4, 20, 32, 12, 3, 5), (2, 16, 512, 64, 16, 4),
       (4, 128, 512, 64, 16, 12), (1, 128, 512, 64, 16, 12), (2, 72, 64, 16, 40, 3)]
# (B, S, dh) of the mLSTM kernel: one token, a ragged chunk, one and two
# chunks of 256 (the second of one token), four; the reduced head width and
# xlstm-1.3b's 1024
MLSTM = ([(B, S, 32) for B in (1, 4) for S in (1, 37, 64, 300)]
         + [(4, 160, 1024), (1, 256, 1024), (1, 257, 1024), (1, 1000, 1024)])
# (B, S, dh) of the mLSTM backward: one token, a ragged chunk, one and two
# chunks (the second ragged), the reduced head width and xlstm-1.3b's 1024
MLSTM_BWD = ([(B, S, 32) for B in (1, 4) for S in (1, 37, 256, 300)]
             + [(2, 160, 1024), (1, 300, 1024), (1, 1000, 1024)])
# (b, S, di, ds) of the selective scan: one token, ragged channels and
# steps, jamba's prefill (di 8192, ds 16), every state width it is built for
MAMBA = [(1, 1, 128, 16), (2, 37, 200, 16), (1, 160, 8192, 16), (2, 300, 96, 4),
         (1, 64, 130, 64), (2, 1000, 256, 8), (1, 33, 64, 32)]
# (b, S, di, ds) of the scan on the model's layout (A and D in u's dtype, B
# and C column views of one projection): one token, a ragged last tile,
# jamba's prompt, a training length, the smallest state width
MAMBA_MODEL = [(1, 1, 128, 16), (2, 37, 200, 16), (1, 160, 8192, 16), (1, 4096, 8192, 16),
               (2, 70, 96, 4)]
# (b, s, g, r, d[, dv]): rep 1 and 4 at s 256, 1000 (ragged tiles) and 4096,
# plus head dim 128, a group size that does not divide the 64-row tile, and
# the largest group (64 heads a kv head: one position a query tile); and
# MLA's widths, q/k 192 and v 128 (r 1 as in the model, and grouped)
FLASH = ([(1, s, g, r, 64) for s in (256, 1000, 4096) for g, r in ((4, 1), (2, 4))]
         + [(2, 256, 2, 2, 128), (1, 300, 1, 3, 64), (1, 200, 1, 64, 64),
            (1, 130, 2, 64, 128)]
         + [(1, s, 4, 1, 192, 128) for s in (37, 256, 1000, 4096)]
         + [(1, 300, 1, 3, 192, 128), (1, 130, 1, 64, 192, 128)])


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _spectral(M, m, n, k, dtype, device, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((M, m))
    U = rng.standard_normal((m, k)) / math.sqrt(m)
    s = rng.uniform(0.0, 1.0, size=(k,))
    V = rng.standard_normal((n, k)) / math.sqrt(k)   # O(1) outputs
    t = [torch.tensor(a, dtype=torch.float32, device=device) for a in (x, U, s, V)]
    return t[0].to(dtype), t[1].to(dtype), t[2], t[3].to(dtype)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("shape", SPECTRAL, ids=lambda s: "x".join(map(str, s)))
def test_spectral_matmul_kernel_vs_plain(cuda, shape, dtype):
    args = _spectral(*shape, DTYPES[dtype], cuda)
    before = LAUNCHES["spectral_matmul"]
    assert_kernel_matches(spectral_matmul, spectral_matmul_ref, args)
    assert LAUNCHES["spectral_matmul"] == before + 1


# row counts of the bf16 batch-invariance check: decode (row tile 16),
# ragged and prefill-sized batches, and the training M (row tile 128 or 64)
INVARIANT_ROWS = (4, 8, 37, 64, 160, 256, 8192)


@pytest.mark.parametrize("mnk", [(2048, 8192, 128), (8192, 2048, 128), (2048, 8192, 256)],
                         ids=lambda s: "x".join(map(str, s)))
def test_spectral_matmul_rows_are_batch_invariant(cuda, mnk):
    """A row's output does not depend on M or on the other rows: at every
    M, its first, a middle and its last row equal the same row alone (M =
    1), bit for bit, across the tensor-core kernel's row tiles. The
    engine's batched steps and the batch-1 reference agree exactly."""
    m, n, k = mnk
    x, U, s, V = _spectral(max(INVARIANT_ROWS), m, n, k, torch.bfloat16, cuda)
    for M in INVARIANT_ROWS:
        full = spectral_matmul(x[:M], U, s, V)
        for i in sorted({0, M // 2, M - 1}):
            assert torch.equal(spectral_matmul(x[i:i + 1], U, s, V)[0], full[i]), (M, i)


def test_spectral_matmul_raises_on_unsupported_dtype(cuda):
    x, U, s, V = _spectral(2, 64, 64, 16, torch.float32, cuda)
    with pytest.raises(TypeError):
        spectral_matmul(x.half(), U.half(), s, V.half())


def _q8(M, m, n, k, profile, dtype, device, seed=0):
    """x, {"q8", "scale"} factors with scales of the given profile (v's
    reversed, so the fused gain spans the product of both), fp32 s."""
    rng = np.random.default_rng(seed)
    x = torch.tensor(rng.standard_normal((M, m)), dtype=torch.float32, device=device)
    uq, vq = (torch.tensor(rng.integers(-127, 128, size=(r, k)), dtype=torch.int8,
                           device=device) for r in (m, n))
    us = scale_profile(profile, k, device) / math.sqrt(m) / 127.0
    vs = scale_profile(profile, k, device).flip(0) / math.sqrt(k) / 127.0
    s = torch.tensor(rng.uniform(0.0, 1.0, size=(k,)), dtype=torch.float32, device=device)
    return x.to(dtype), {"q8": uq, "scale": us}, s, {"q8": vq, "scale": vs}


def _q8_plain(x, U, s, V):
    """The plain version through the wrapper's own gain."""
    gain = U["scale"] * s * V["scale"]
    return spectral_matmul_q8_ref(x.reshape(-1, x.shape[-1]), U["q8"], gain, V["q8"])


@pytest.mark.parametrize("profile", SCALE_PROFILES)
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("shape", SPECTRAL_Q8, ids=lambda s: "x".join(map(str, s)))
def test_spectral_matmul_q8_kernel_vs_plain(cuda, shape, dtype, profile):
    args = _q8(*shape, profile, DTYPES[dtype], cuda)
    before = LAUNCHES["spectral_matmul_q8"]
    assert_kernel_matches(spectral_matmul_q8, _q8_plain, args,
                          label=f"spectral_matmul_q8 {shape} {dtype} {profile}")
    assert LAUNCHES["spectral_matmul_q8"] == before + 1


@pytest.mark.parametrize("profile", SCALE_PROFILES)
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_spectral_matmul_q8_rows_are_batch_invariant(cuda, dtype, profile):
    """Every row of an M = 1, 4, 37, 64, 160 or 256 call equals the same
    row alone, bit for bit, on both MLP shapes and under every scale
    profile: the int8 engine's batched steps and its batch-1 static
    reference agree exactly (M 16 and below runs 16-row tiles in bf16, 64
    above)."""
    for m, n in ((2048, 8192), (8192, 2048)):
        x, U, s, V = _q8(256, m, n, 128, profile, DTYPES[dtype], cuda)
        for M in (1, 4, 37, 64, 160, 256):
            full = spectral_matmul_q8(x[:M], U, s, V)
            for i in range(M):
                assert torch.equal(spectral_matmul_q8(x[i:i + 1], U, s, V)[0], full[i]), (
                    m, M, i)


# qwen2-vl-72b's MLP at decode and in a 64-token chunk: 8192 -> 29568 (up,
# gate) and 29568 -> 8192 (down: a 3696-row m slice a cluster block), rank 256
QWEN_MLP = [(4, 8192, 29568, 256), (4, 29568, 8192, 256), (64, 29568, 8192, 256)]
# deepseek-v3-671b's dense MLP under int8 weights: 7168 <-> 18432, rank 128
DEEPSEEK_Q8 = [(4, 7168, 18432, 128), (4, 18432, 7168, 128), (64, 18432, 7168, 128)]


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("shape", QWEN_MLP, ids=lambda s: "x".join(map(str, s)))
def test_spectral_matmul_at_qwen2_vl_mlp(cuda, shape, dtype):
    args = _spectral(*shape, DTYPES[dtype], cuda)
    before = LAUNCHES["spectral_matmul"]
    assert_kernel_matches(spectral_matmul, spectral_matmul_ref, args)
    assert LAUNCHES["spectral_matmul"] == before + 1
    if dtype == "bfloat16":
        x, U, s, V = args
        full = spectral_matmul(x, U, s, V)
        for i in sorted({0, x.shape[0] - 1}):
            assert torch.equal(spectral_matmul(x[i:i + 1], U, s, V)[0], full[i]), i


@pytest.mark.parametrize("profile", ["unit", "extreme"])
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("shape", DEEPSEEK_Q8, ids=lambda s: "x".join(map(str, s)))
def test_spectral_matmul_q8_at_deepseek_dense_mlp(cuda, shape, dtype, profile):
    args = _q8(*shape, profile, DTYPES[dtype], cuda)
    before = LAUNCHES["spectral_matmul_q8"]
    assert_kernel_matches(spectral_matmul_q8, _q8_plain, args,
                          label=f"spectral_matmul_q8 {shape} {dtype} {profile}")
    assert LAUNCHES["spectral_matmul_q8"] == before + 1


def test_spectral_matmul_q8_refuses_other_ranks(cuda):
    x, U, s, V = _q8(2, 64, 64, 16, "unit", torch.float32, cuda)
    U8 = {"q8": U["q8"][:, :8].contiguous(), "scale": U["scale"][:8].contiguous()}
    V8 = {"q8": V["q8"][:, :8].contiguous(), "scale": V["scale"][:8].contiguous()}
    with pytest.raises(ValueError, match="multiple of 16"):
        spectral_matmul_q8(x, U8, s[:8].contiguous(), V8)


def _cold_inputs(case, dtype, device, p_cold, seed=0):
    """Pools, int8 shadows quantized from independent noise (a read of
    the wrong tier misses by O(1)), ragged lengths, a shuffled table, a
    null-page slot and cold flags drawn with probability p_cold."""
    b, kvh, rep, hd, page, n = case
    num_pages = b * n + 3
    g = torch.Generator(device=device).manual_seed(seed)
    shape = (num_pages + 1, page, kvh, hd)
    k_pool, v_pool, k_src, v_src = (torch.randn(shape, generator=g, device=device)
                                    for _ in range(4))
    kq, vq = (quantize_kv_pages(t, token_axis=1) for t in (k_src, v_src))
    q = torch.randn((b, kvh, rep, hd), generator=g, device=device).to(dtype)
    sl = ragged_seq_lens(b, page * n - 1, page)
    bt = make_block_table(b, n, num_pages, sl, page)
    bt[0, :] = num_pages
    cold = (torch.rand((num_pages + 1,), generator=g, device=device) < p_cold).int()
    return (q, k_pool.bfloat16(), v_pool.bfloat16(), kq["q8"], kq["scale"], vq["q8"],
            vq["scale"], bt.to(device), sl.to(device), cold)


@pytest.mark.parametrize("p_cold", [0.0, 0.5, 1.0])
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("case", PAGED, ids=lambda c: "-".join(map(str, c)))
def test_paged_decode_cold_kernel_vs_plain(cuda, case, dtype, p_cold):
    args = _cold_inputs(case, DTYPES[dtype], cuda, p_cold)
    before = LAUNCHES["paged_gqa_decode_cold"]
    for part in (slice(1, None), slice(0, 1)):      # live slots, then the null slot
        assert_kernel_matches(lambda *a: paged_gqa_decode_cold(*a)[part],
                              lambda *a: paged_gqa_decode_cold_ref(*a)[part], args)
    assert LAUNCHES["paged_gqa_decode_cold"] == before + 2


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("case", PAGED, ids=lambda c: "-".join(map(str, c)))
def test_paged_decode_cold_kernel_without_flags_is_the_hot_kernel(cuda, case, dtype):
    """No page flagged: bit for bit the hot kernel's output."""
    q, kp, vp, kq, ks, vq, vs, bt, sl, cold = _cold_inputs(case, DTYPES[dtype], cuda, 0.0)
    assert not cold.any()
    assert torch.equal(paged_gqa_decode_cold(q, kp, vp, kq, ks, vq, vs, bt, sl, cold),
                       paged_gqa_decode(q, kp, vp, bt, sl))


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("case", PAGED, ids=lambda c: "-".join(map(str, c)))
def test_paged_decode_kernel_vs_plain(cuda, case, dtype):
    b, kvh, rep, hd, page, n = case
    num_pages = b * n + 3
    g = torch.Generator(device=cuda).manual_seed(0)
    k_pool = torch.randn((num_pages + 1, page, kvh, hd), generator=g, device=cuda)
    v_pool = torch.randn((num_pages + 1, page, kvh, hd), generator=g, device=cuda)
    q = torch.randn((b, kvh, rep, hd), generator=g, device=cuda).to(DTYPES[dtype])
    sl = ragged_seq_lens(b, page * n - 1, page)
    bt = make_block_table(b, n, num_pages, sl, page)
    bt[0, :] = num_pages                      # inactive slot on the null page
    args = (q, k_pool.to(torch.bfloat16), v_pool.to(torch.bfloat16), bt.to(cuda), sl.to(cuda))
    before = LAUNCHES["paged_gqa_decode"]
    for part in (slice(1, None), slice(0, 1)):      # live slots, then the null slot
        assert_kernel_matches(lambda *a: paged_gqa_decode(*a)[part],
                              lambda *a: paged_gqa_decode_ref(*a)[part], args)
    assert LAUNCHES["paged_gqa_decode"] == before + 2


@pytest.mark.parametrize("cold", [False, True], ids=["hot", "cold"])
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("case", PAGED, ids=lambda c: "-".join(map(str, c)))
def test_paged_decode_rows_equal_the_slot_alone(cuda, case, dtype, cold):
    """Two calls give the same bits, and each slot's row equals the slot
    computed alone at the same table width (the bf16 serving cells gate on
    a request served alone), hot and cold (half the pages flagged)."""
    b, kvh, rep, hd, page, n = case
    lens = ragged_seq_lens(b, page * n - 1, page, seed=1).tolist()
    args = gqa_inputs(lens, n, kvh, rep, hd, page, dtype=DTYPES[dtype], null_slot=True,
                      p_cold=0.5 if cold else None, seed=1, device=cuda)
    kern = paged_gqa_decode_cold if cold else paged_gqa_decode
    per_slot = (0, 7, 8) if cold else (0, 3, 4)      # q, block table, seq_lens
    full = kern(*args)
    assert torch.equal(full, kern(*args))
    for i in range(b):
        one = [t[i:i + 1] if j in per_slot else t for j, t in enumerate(args)]
        assert torch.equal(kern(*one)[0], full[i]), f"slot {i}"


def test_paged_decode_kernel_refuses_rows_wider_than_a_warp(cuda):
    q, kp, vp, bt, sl = gqa_inputs([5, 9], 2, 1, 2, 512, 8, device=cuda)
    with pytest.raises(ValueError, match="lanes a row"):
        paged_gqa_decode(q, kp, vp, bt, sl)


def _mla_case(case, dtype, device, p_cold=None):
    b, h, lat, rope, page, n = case
    lens = ragged_seq_lens(b, page * n - 1, page).tolist() if b > 1 else [page * n - 1]
    return mla_inputs(lens, n, h, lat, rope, page, dtype=dtype, null_slot=b > 1,
                      p_cold=p_cold, device=device)


def _mla_parts(b):
    """Live slots, then the null slot (one raw latent row: compared on its
    own so it does not set the live slots' scale)."""
    return [slice(1, None), slice(0, 1)] if b > 1 else [slice(None)]


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("case", MLA, ids=lambda c: "-".join(map(str, c)))
def test_paged_mla_decode_kernel_vs_plain(cuda, case, dtype):
    args = _mla_case(case, DTYPES[dtype], cuda)
    scale = 1.0 / math.sqrt(case[2] // 4 + case[3])
    before = LAUNCHES["paged_mla_decode"]
    for part in _mla_parts(case[0]):
        assert_kernel_matches(lambda *a: paged_mla_decode(*a, scale=scale)[part],
                              lambda *a: paged_mla_decode_ref(*a, scale=scale)[part], args)
    assert LAUNCHES["paged_mla_decode"] == before + len(_mla_parts(case[0]))


@pytest.mark.parametrize("p_cold", [0.0, 0.5, 1.0])
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("case", MLA, ids=lambda c: "-".join(map(str, c)))
def test_paged_mla_decode_cold_kernel_vs_plain(cuda, case, dtype, p_cold):
    args = _mla_case(case, DTYPES[dtype], cuda, p_cold)
    scale = 1.0 / math.sqrt(case[2] // 4 + case[3])
    before = LAUNCHES["paged_mla_decode_cold"]
    for part in _mla_parts(case[0]):
        assert_kernel_matches(lambda *a: paged_mla_decode_cold(*a, scale=scale)[part],
                              lambda *a: paged_mla_decode_cold_ref(*a, scale=scale)[part],
                              args)
    assert LAUNCHES["paged_mla_decode_cold"] == before + len(_mla_parts(case[0]))
    if p_cold == 0.0:                      # no page flagged: bit for bit the hot kernel
        q_lat, q_rope, ckv, kr, _, _, _, _, bt, sl, cold = args
        assert not cold.any()
        assert torch.equal(paged_mla_decode_cold(*args, scale=scale),
                           paged_mla_decode(q_lat, q_rope, ckv, kr, bt, sl, scale=scale))


@pytest.mark.parametrize("cold", [False, True], ids=["hot", "cold"])
def test_paged_mla_decode_live_pages_fewer_than_the_table(cuda, cold):
    """Slots whose live pages are far fewer than the table's 16 (one of
    them empty): the grid spans the table, the live items sit on its first
    blocks and the rest return at once. Against the plain version, every
    page cold in the cold kernel, and two calls give the same bits."""
    lens = [3, 20, 0, 40]
    scale = 1.0 / math.sqrt(192)
    args = mla_inputs(lens, 16, 128, 512, 64, 16, p_cold=1.0 if cold else None, seed=5,
                      device=cuda)
    kern = paged_mla_decode_cold if cold else paged_mla_decode
    ref = paged_mla_decode_cold_ref if cold else paged_mla_decode_ref
    if cold:
        args[-1].fill_(1)
    assert_kernel_matches(lambda *a: kern(*a, scale=scale), lambda *a: ref(*a, scale=scale),
                          args)
    assert torch.equal(kern(*args, scale=scale), kern(*args, scale=scale))


def test_paged_mla_decode_kernel_refuses_what_it_cannot_run(cuda):
    q_lat, q_rope, ckv, kr, bt, sl = _mla_case((2, 4, 16, 8, 4, 3), torch.float32, cuda)
    with pytest.raises(TypeError, match="differ"):
        paged_mla_decode(q_lat, q_rope.bfloat16(), ckv, kr, bt, sl, scale=0.1)
    with pytest.raises(TypeError, match="bf16 pools"):
        paged_mla_decode(q_lat, q_rope, ckv.float(), kr, bt, sl, scale=0.1)
    wide = torch.zeros((*ckv.shape[:2], 1024), dtype=torch.bfloat16, device=cuda)
    with pytest.raises(ValueError, match="limit"):
        paged_mla_decode(torch.zeros((2, 4, 1024), device=cuda), q_rope, wide, kr, bt, sl,
                         scale=0.1)


def test_deepseek_engine_on_cuda(cuda):
    """Reduced deepseek-v3-671b (capacity factor 8.0) through the engine on
    the card: every decode step runs the absorbed-MLA kernel once per
    layer and the GQA one never; with the int8 cold tier the cold kernel
    takes every step instead; every request equals itself served alone
    and stays within the ladder of the static path."""
    from repro_torch.launch.serve import check_oracles
    from repro_torch.models.model import init_model
    from repro_torch.serving import PagedCacheConfig, Request, ServingEngine
    from repro_torch.serving.streaming import StreamingConfig

    cfg = get_config("deepseek-v3-671b", reduced=True).replace(capacity_factor=8.0)
    pcfg = PagedCacheConfig(page_size=4, num_pages=32, max_slots=2, max_pages_per_seq=8)
    rng = np.random.default_rng(0)
    reqs = [Request(rid=i, prompt=rng.integers(0, cfg.vocab, size=(n,)).astype(np.int32),
                    max_new_tokens=g, arrival=a)
            for i, (n, g, a) in enumerate([(9, 4, 0), (5, 9, 0), (13, 5, 1), (7, 6, 2)])]
    params = init_model(cfg, seed=0, device=cuda)
    for streaming, name in ((None, "paged_mla_decode"),
                            (StreamingConfig(sink_pages=1, window_pages=2, cold_kv="int8"),
                             "paged_mla_decode_cold")):
        engine = ServingEngine(cfg, params, pcfg, streaming=streaming)
        LAUNCHES.clear()
        out = engine.run(reqs)
        assert LAUNCHES[name] == cfg.n_layers * engine.decode_steps
        other = "paged_mla_decode" if streaming else "paged_mla_decode_cold"
        assert LAUNCHES[other] == 0 and LAUNCHES["paged_gqa_decode"] == 0
        engine.sched.check_invariants()
        check_oracles(engine, reqs, out, reqs if streaming is None else [])


def test_engine_on_cuda_matches_static_reference(cuda):
    """Reduced llama through the engine on the card (both kernels on the
    path) gives the batch-1 static greedy reference's tokens."""
    from repro_torch.launch.serve import static_greedy_reference
    from repro_torch.models.model import init_model
    from repro_torch.serving import PagedCacheConfig, Request, ServingEngine

    cfg = get_config("llama3.2-1b", reduced=True)
    pcfg = PagedCacheConfig(page_size=8, num_pages=24, max_slots=3, max_pages_per_seq=4)
    rng = np.random.default_rng(0)
    reqs = [Request(rid=i, prompt=rng.integers(0, cfg.vocab, size=(n,)).astype(np.int32),
                    max_new_tokens=g, arrival=a)
            for i, (n, g, a) in enumerate([(5, 6, 0), (11, 4, 0), (7, 8, 1), (3, 5, 3)])]
    engine = ServingEngine(cfg, init_model(cfg, seed=0, device=cuda), pcfg,
                           prefill_token_budget=16)
    LAUNCHES.clear()
    out = engine.run(reqs)
    assert LAUNCHES["spectral_matmul"] > 0 and LAUNCHES["paged_gqa_decode"] > 0
    engine.sched.check_invariants()
    for r in reqs:
        ref = static_greedy_reference(cfg, engine.params, r.prompt, r.max_new_tokens,
                                      pcfg.max_seq)
        np.testing.assert_array_equal(out[r.rid], ref, err_msg=f"request {r.rid}")


def test_int8_streaming_engine_on_cuda(cuda):
    """Reduced llama with int8 weights and the int8 cold tier on the
    card: the q8 and cold kernels carry the whole path (the bf16
    spectral and hot decode kernels launch zero times), the session
    evicts and demotes, every request gives the tokens it gives served
    alone, and every request within the identity horizon stays within
    the tolerance ladder of the static path over the same int8 tree."""
    from repro_torch.launch.serve import replay_alone, static_logit_gaps
    from repro_torch.models.model import init_model
    from repro_torch.serving import PagedCacheConfig, Request, ServingEngine
    from repro_torch.serving.streaming import StreamingConfig, identity_horizon

    cfg = get_config("llama3.2-1b", reduced=True)
    pcfg = PagedCacheConfig(page_size=4, num_pages=16, max_slots=2, max_pages_per_seq=4)
    scfg = StreamingConfig(sink_pages=1, window_pages=2, cold_kv="int8")
    rng = np.random.default_rng(0)
    reqs = [Request(rid=i, prompt=rng.integers(0, cfg.vocab, size=(n,)).astype(np.int32),
                    max_new_tokens=g, arrival=a)
            for i, (n, g, a) in enumerate([(24, 40, 0), (5, 7, 0), (6, 6, 1), (20, 30, 2)])]
    engine = ServingEngine(cfg, init_model(cfg, seed=0, device=cuda), pcfg, quantize="int8",
                           streaming=scfg, chunked_prefill=True)
    LAUNCHES.clear()
    out = engine.run(reqs)
    assert LAUNCHES["spectral_matmul_q8"] > 0 and LAUNCHES["paged_gqa_decode_cold"] > 0
    assert LAUNCHES["spectral_matmul"] == 0 and LAUNCHES["paged_gqa_decode"] == 0
    st = engine.stats()
    assert st["stream_evictions"] > 0 and st["stream_demotions"] > 0
    engine.sched.check_invariants()
    horizon = identity_horizon(scfg, pcfg)
    for r in reqs:
        np.testing.assert_array_equal(out[r.rid], replay_alone(engine, r),
                                      err_msg=f"request {r.rid}")
        if r.prompt_len + r.max_new_tokens <= horizon:
            assert static_logit_gaps(cfg, engine.params, r.prompt, out[r.rid],
                                     pcfg.max_seq).max() <= 1.0, r.rid


def _flash_inputs(b, s, g, r, d, dtype, device, seed=0, dv=None):
    """q (b, s, g, r, d), k (b, s, g, d), v (b, s, g, dv), dout (b, s, g,
    r, dv); dv = d unless given."""
    dv = d if dv is None else dv
    gen = torch.Generator(device=device).manual_seed(seed)
    q, do = (torch.randn((b, s, g, r, w), generator=gen, device=device) for w in (d, dv))
    k, v = (torch.randn((b, s, g, w), generator=gen, device=device) for w in (d, dv))
    return [t.to(dtype) for t in (q, k, v, do)]


def _case_inputs(case, dtype, device):
    """``_flash_inputs`` of a FLASH case (b, s, g, r, d[, dv])."""
    b, s, g, r, d, *dv = case
    return _flash_inputs(b, s, g, r, d, dtype, device, dv=dv[0] if dv else None)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("case", FLASH, ids=lambda c: "-".join(map(str, c)))
def test_flash_kernels_vs_plain(cuda, case, dtype):
    """Forward (out, m, l) and backward (dq, dk, dv), each against the
    plain version on the same inputs; the backward gets the plain
    forward's out/m/l so it is checked on its own."""
    q, k, v, do = _case_inputs(case, DTYPES[dtype], cuda)
    before = (LAUNCHES["flash_attention_fwd"], LAUNCHES["flash_attention_bwd"])
    # m and l are fp32, but in bf16 they come from bf16 inputs (and the
    # plain version rounds its scores to bf16): the inputs' rung
    for i, name in enumerate(("out", "m", "l")):
        assert_kernel_matches(lambda *a, i=i: flash_attention_fwd(*a)[i],
                              lambda *a, i=i: flash_fwd_ref(*a)[i], (q, k, v),
                              dtype=DTYPES[dtype], label=f"flash_attention_fwd {name}")
    out, m, l = flash_fwd_ref(q, k, v)
    for i, name in enumerate(("dq", "dk", "dv")):
        assert_kernel_matches(lambda *a, i=i: flash_attention_bwd(*a)[i],
                              lambda *a, i=i: flash_bwd_ref(*a)[i], (q, k, v, out, m, l, do),
                              label=f"flash_attention_bwd {name}")
    assert (LAUNCHES["flash_attention_fwd"], LAUNCHES["flash_attention_bwd"]) == (
        before[0] + 3, before[1] + 3)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("case", [(1, 4096, 8, 4, 64), (1, 1000, 4, 4, 64),
                                  (1, 4096, 4, 1, 192, 128), (1, 1000, 2, 1, 192, 128)],
                         ids=lambda c: "-".join(map(str, c)))
def test_flash_backward_is_deterministic(cuda, case, dtype):
    """Two backward calls on the same inputs give the same bits: no
    atomics, every sum in a fixed order."""
    q, k, v, do = _case_inputs(case, DTYPES[dtype], cuda)
    out, m, l = flash_fwd_ref(q, k, v)
    first = flash_attention_bwd(q, k, v, out, m, l, do)
    second = flash_attention_bwd(q, k, v, out, m, l, do)
    for name, a, b in zip(("dq", "dk", "dv"), first, second):
        assert torch.equal(a, b), name


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("case", FLASH, ids=lambda c: "-".join(map(str, c)))
def test_flash_forward_is_deterministic(cuda, case, dtype, causal):
    """Two forward calls on the same inputs give the same bits, and match
    the plain version with and without the causal mask."""
    q, k, v, _ = _case_inputs(case, DTYPES[dtype], cuda)
    first = flash_attention_fwd(q, k, v, causal)
    second = flash_attention_fwd(q, k, v, causal)
    ref = flash_fwd_ref(q, k, v, causal)
    for name, a, b, r in zip(("out", "m", "l"), first, second, ref):
        assert torch.equal(a, b), name
        assert_kernel_matches(lambda: a, lambda: r, (), dtype=DTYPES[dtype],
                              label=f"flash_attention_fwd {name} causal={causal}")


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("case", FLASH, ids=lambda c: "-".join(map(str, c)))
def test_flash_backward_runs_from_the_kernel_forward(cuda, case, dtype):
    """The backward from the kernel forward's own (out, m, l), against the
    plain backward on the same inputs: the statistics the forward writes
    are the ones the backward reads (natural-log m, unclamped l)."""
    q, k, v, do = _case_inputs(case, DTYPES[dtype], cuda)
    out, m, l = flash_attention_fwd(q, k, v)
    for i, name in enumerate(("dq", "dk", "dv")):
        assert_kernel_matches(lambda *a, i=i: flash_attention_bwd(*a)[i],
                              lambda *a, i=i: flash_bwd_ref(*a)[i], (q, k, v, out, m, l, do),
                              label=f"flash_attention_bwd {name} from the kernel forward")


def test_flash_kernel_refuses_other_head_dims(cuda):
    """Widths no instance takes: 80, and q/k 192 with v 192 (MLA's q/k
    width with v as wide)."""
    for d, dv in ((80, 80), (192, 192)):
        q, k, v, _ = _flash_inputs(1, 64, 1, 1, d, torch.bfloat16, cuda, dv=dv)
        with pytest.raises(ValueError, match=rf"head dims \(q/k {d}, v {dv}\)"):
            flash_attention_fwd(q, k, v)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_spectral_autograd_vs_plain(cuda, dtype):
    """y and the gradients (dx, dU, ds, dV) through the kernel's autograd
    Function against autograd through the plain version, fp32 factors."""
    x, U, s, V = _spectral(256, 2048, 8192, 128, torch.float32, cuda)
    x = x.to(DTYPES[dtype])
    dy = torch.randn((256, 8192), device=cuda).to(DTYPES[dtype])

    def run(fn):
        leaves = [t.detach().clone().requires_grad_() for t in (x, U, s, V)]
        y = fn(*leaves)
        y.backward(dy)
        return [y] + [t.grad for t in leaves]

    got = run(spectral_matmul)
    ref = run(lambda a, u, sv, vv: spectral_matmul_ref(a, u, sv, vv))
    for name, g, r in zip(("y", "dx", "dU", "ds", "dV"), got, ref):
        assert g.dtype == r.dtype, name
        assert_kernel_matches(lambda: g, lambda: r, (), dtype=DTYPES[dtype], label=name)


@pytest.mark.parametrize("mn", [(2048, 8192), (8192, 2048)], ids=["up", "down"])
def test_spectral_autograd_bf16_factors_vs_plain(cuda, mn):
    """The bf16 policy's path: bf16 activations over bf16 factors (s too),
    y and the gradients (dx, dU, ds, dV) through the kernel's autograd
    Function against autograd through the plain version at the bf16 rung,
    every gradient in its input's dtype."""
    m, n = mn
    x, U, s, V = (t.to(torch.bfloat16) for t in _spectral(256, m, n, 128, torch.float32, cuda))
    dy = torch.randn((256, n), device=cuda).to(torch.bfloat16)

    def run(fn):
        leaves = [t.detach().clone().requires_grad_() for t in (x, U, s, V)]
        y = fn(*leaves)
        y.backward(dy)
        return [y] + [t.grad for t in leaves]

    got = run(spectral_matmul)
    ref = run(lambda a, u, sv, vv: spectral_matmul_ref(a, u, sv, vv))
    for name, g, r in zip(("y", "dx", "dU", "ds", "dV"), got, ref):
        assert g.dtype == r.dtype == torch.bfloat16, name
        assert_kernel_matches(lambda: g, lambda: r, (), dtype=torch.bfloat16, label=name)


def test_clip_and_adamw_on_bf16_cuda_leaves(cuda):
    """In-place clipping of a bf16 gradient on the card equals the fp32
    product rounded once (the reference's ``astype``), an fp32 one the
    product itself; AdamW on a bf16 parameter equals the update of its
    fp32 copy rounded once, with the same moments, bit for bit."""
    from repro_torch.optim.adamw import AdamWConfig, adamw_init, adamw_update
    from repro_torch.optim.clip import clip_by_global_norm

    rng = np.random.default_rng(11)
    g32 = torch.tensor(rng.standard_normal((1000, 300)) * 3.0, dtype=torch.float32, device=cuda)
    gb = torch.tensor(rng.standard_normal((513, 77)) * 3.0, dtype=torch.float32,
                      device=cuda).to(torch.bfloat16)
    grads = {"a": gb.clone(), "b": g32.clone()}
    clipped, norm = clip_by_global_norm(grads, 1.0)
    scale = torch.clamp(1.0 / (norm + 1e-12), max=1.0)
    assert float(scale) < 1.0
    assert clipped["a"] is grads["a"] and clipped["a"].dtype == torch.bfloat16
    assert torch.equal(clipped["a"].view(torch.int16),
                       (gb.float() * scale).to(torch.bfloat16).view(torch.int16))
    assert torch.equal(clipped["b"], g32 * scale)

    cfg = AdamWConfig(lr=3e-3)
    p32 = torch.tensor(rng.standard_normal((513, 77)), dtype=torch.float32, device=cuda)
    pb = p32.to(torch.bfloat16)
    wide = {"w": pb.float()}
    narrow = {"w": pb.clone()}
    st_w, st_n = adamw_init(wide), adamw_init(narrow)
    for i in range(3):
        g = torch.tensor(rng.standard_normal((513, 77)), dtype=torch.float32,
                         device=cuda).to(torch.bfloat16)
        wide, st_w = adamw_update(wide, {"w": g.clone()}, st_w, cfg)
        narrow, st_n = adamw_update(narrow, {"w": g.clone()}, st_n, cfg)
        assert narrow["w"].dtype == torch.bfloat16
        assert torch.equal(narrow["w"].view(torch.int16),
                           wide["w"].to(torch.bfloat16).view(torch.int16)), i
        assert torch.equal(st_n["mu"]["w"], st_w["mu"]["w"])
        assert torch.equal(st_n["nu"]["w"], st_w["nu"]["w"])
        wide = {"w": narrow["w"].float()}   # the bf16 run keeps only the rounded value


@pytest.mark.parametrize("with_state", [False, True], ids=["empty", "state"])
@pytest.mark.parametrize("profile", MLSTM_PROFILES)
@pytest.mark.parametrize("case", MLSTM, ids=lambda c: "x".join(map(str, c)))
def test_mlstm_chunk_kernel_vs_plain(cuda, case, profile, with_state):
    """y and the final (C, n, m), each against the plain version cut into
    the kernel's chunks (the function is the same under any chunking;
    the same chunks round the same prefix sums), at the fp32 rung; two
    calls give the same bits."""
    B, S, dh = case
    q, k, v, i, f, state = mlstm_inputs(B, S, dh, profile, seed=S, device=cuda,
                                        with_state=with_state)
    before = LAUNCHES["mlstm_chunk"]
    y, got = mlstm_chunk(q, k, v, i, f, state)
    assert LAUNCHES["mlstm_chunk"] == before + 1
    y2, got2 = mlstm_chunk(q, k, v, i, f, state)
    assert all(torch.equal(a, b) for a, b in zip((y, *got), (y2, *got2)))
    yr, ref = mlstm_chunk_ref(q, k, v, i, f, state, chunk=MLSTM_KERNEL_CHUNK, ragged=True)
    for name, g, r in zip(("y", "C", "n", "m"), (y, *got), (yr, *ref)):
        assert_kernel_matches(lambda: g, lambda: r, (), dtype=torch.float32,
                              label=f"mlstm_chunk {name} {case} {profile}")


@pytest.mark.parametrize("case", [(2, 37, 32), (2, 256, 64), (2, 300, 32), (1, 160, 1024)],
                         ids=lambda c: "x".join(map(str, c)))
def test_mlstm_chunk_kernel_vs_reference_chunking(cuda, case):
    """Against the plain version chunked as the reference chunks (256,
    or one chunk when 256 does not divide S): the kernel's chunks (256,
    the last one ragged) give the same function."""
    B, S, dh = case
    q, k, v, i, f, _ = mlstm_inputs(B, S, dh, "unit", seed=1, device=cuda)
    y, got = mlstm_chunk(q, k, v, i, f)
    yr, ref = mlstm_chunk_ref(q, k, v, i, f)
    for name, g, r in zip(("y", "C", "n", "m"), (y, *got), (yr, *ref)):
        assert_kernel_matches(lambda: g, lambda: r, (), dtype=torch.float32,
                              label=f"mlstm_chunk {name} {case}")


def test_mlstm_chunk_kernel_refuses_what_it_cannot_run(cuda):
    q, k, v, i, f, _ = mlstm_inputs(1, 8, 32, "unit", device=cuda)
    with pytest.raises(TypeError):
        mlstm_chunk(q.bfloat16(), k.bfloat16(), v.bfloat16(), i, f)
    q, k, v, i, f, _ = mlstm_inputs(1, 8, 48, "unit", device=cuda)
    with pytest.raises(ValueError):
        mlstm_chunk(q, k, v, i, f)


def _mlstm_grads(g):
    """(dq, dk, dv, di, df) and, when a state was passed, (dC0, dn0, dm0)."""
    return list(g[:5]) + (list(g[5]) if g[5] is not None else [])


@pytest.mark.parametrize("finals", [False, True], ids=["dy", "dy+dstate"])
@pytest.mark.parametrize("with_state", [False, True], ids=["empty", "state"])
@pytest.mark.parametrize("profile", MLSTM_PROFILES)
@pytest.mark.parametrize("case", MLSTM_BWD, ids=lambda c: "x".join(map(str, c)))
def test_mlstm_chunk_bwd_kernel_vs_plain(cuda, case, profile, with_state, finals):
    """Every gradient of the backward kernel against its plain version at
    the fp32 rung, with and without an initial state and gradients of the
    final state; one launch a call, and two calls give the same bits. The
    error is scaled by the plain version's RMS or, for a gradient that is
    zero in exact arithmetic (dq and dk at one token; a state dominated by
    one token), by its rounding noise (``noise_scale``)."""
    _check_mlstm_bwd(cuda, case, profile, with_state, finals)


@pytest.mark.parametrize("finals", [False, True], ids=["dy", "dy+dstate"])
@pytest.mark.parametrize("with_state", [False, True], ids=["empty", "state"])
def test_mlstm_chunk_bwd_kernel_at_training_shape(cuda, with_state, finals):
    """xlstm-1.3b's training shape (B 8 = 2 x 4 heads, S 4096, dh 1024)
    down every skip path of the kernel's plan: chunk 0's dy C0^T without a
    state, the last chunk's v dC1^T and k dC1 without a gradient of the
    final C, each run where its factor is not zero; held as the smaller
    cases are."""
    case = (8, 4096, 1024)
    plan = bwd_plan(*case, has_state=with_state, has_dC=finals)
    assert plan.state_products[0][0] == with_state
    assert plan.state_products[1][-1] == plan.state_products[2][-1] == finals
    _check_mlstm_bwd(cuda, case, "unit", with_state, finals)


def _check_mlstm_bwd(cuda, case, profile, with_state, finals):
    B, S, dh = case
    q, k, v, i, f, state = mlstm_inputs(B, S, dh, profile, seed=S, device=cuda,
                                        with_state=with_state)
    y, fin = mlstm_chunk(q, k, v, i, f, state)
    gen = torch.Generator(device=cuda).manual_seed(S)
    dy = torch.randn(y.shape, generator=gen, device=cuda)
    dfin = ([torch.randn(t.shape, generator=gen, device=cuda) for t in fin] if finals
            else [None] * 3)
    before = LAUNCHES["mlstm_chunk_bwd"]
    got = _mlstm_grads(mlstm_chunk_bwd_cuda(q, k, v, i, f, state, y, dy, *dfin))
    assert LAUNCHES["mlstm_chunk_bwd"] == before + 1
    again = _mlstm_grads(mlstm_chunk_bwd_cuda(q, k, v, i, f, state, y, dy, *dfin))
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    ref = _mlstm_grads(mlstm_chunk_bwd_ref(q, k, v, i, f, state, y, dy, *dfin))
    alt = mlstm_bwd_reordered(q, k, v, i, f, state, y, dy, *dfin)
    assert len(got) == len(ref) == len(alt) == (8 if with_state else 5)
    rung = tolerance_for(torch.float32)
    for name, g, r, a in zip(("dq", "dk", "dv", "di", "df", "dC0", "dn0", "dm0"), got, ref, alt):
        r, a = r.cpu().numpy(), a.cpu().numpy()
        assert_scaled_close(g.cpu().numpy(), r, rung, f"mlstm_chunk_bwd {name} {case} {profile}",
                            scale=noise_scale(r, a, rung))


def test_mlstm_chunk_autograd_on_cuda_runs_the_backward_kernel(cuda):
    """Under autograd on CUDA tensors the wrapper's backward is the kernel:
    one launch, and the gradients of autograd through the plain forward."""
    q, k, v, i, f, state = mlstm_inputs(2, 300, 64, "unit", seed=5, device=cuda,
                                        with_state=True)
    leaves = [t.clone().requires_grad_() for t in (q, k, v, i, f, *state)]
    dy = torch.randn((2, 300, 64), generator=torch.Generator(device=cuda).manual_seed(1),
                     device=cuda)
    LAUNCHES.clear()
    y, _ = mlstm_chunk(*leaves[:5], tuple(leaves[5:]))
    got = torch.autograd.grad((y * dy).sum(), leaves)
    assert LAUNCHES["mlstm_chunk"] == 1 and LAUNCHES["mlstm_chunk_bwd"] == 1
    plain = [t.clone().requires_grad_() for t in (q, k, v, i, f, *state)]
    yr, _ = mlstm_chunk_ref(*plain[:5], tuple(plain[5:]), chunk=MLSTM_KERNEL_CHUNK, ragged=True)
    ref = torch.autograd.grad((yr * dy).sum(), plain)
    for name, g, r in zip(("dq", "dk", "dv", "di", "df", "dC0", "dn0", "dm0"), got, ref):
        assert_kernel_matches(lambda: g, lambda: r, (), dtype=torch.float32, label=name)


def test_xlstm_training_on_cuda(cuda):
    """Reduced xlstm trains on the card: a step runs the mLSTM kernel twice
    a layer (forward and remat recompute) and its backward once; losses
    finite, the factors on the manifold."""
    from repro_torch.api import ModelSpec, RunSpec, Trainer, TrainSpec
    from repro_torch.core.tree import max_orthogonality_error

    spec = RunSpec(model=ModelSpec("xlstm-1.3b", reduced=True),
                   train=TrainSpec(steps=2, batch=2, seq=300, lr=1e-3))
    trainer = Trainer(spec, device=cuda)
    n_mlstm = trainer.cfg.n_layers // trainer.cfg.slstm_every * (trainer.cfg.slstm_every - 1)
    for _ in range(2):
        LAUNCHES.clear()
        loss = float(trainer.step()["loss"])
        assert np.isfinite(loss)
        assert LAUNCHES["mlstm_chunk"] == 2 * n_mlstm
        assert LAUNCHES["mlstm_chunk_bwd"] == n_mlstm
    assert float(max_orthogonality_error(trainer.params)) < 1e-4


def test_xlstm_engine_on_cuda(cuda):
    """Reduced xlstm through the engine on the card: every prefill runs the
    mLSTM kernel once per mLSTM layer and decode never does; a slot is
    reused after a finished request; every request equals itself served
    alone and stays within the ladder of the static path."""
    from repro_torch.launch.serve import check_oracles
    from repro_torch.models.model import init_model
    from repro_torch.serving import PagedCacheConfig, Request, ServingEngine

    cfg = get_config("xlstm-1.3b", reduced=True)
    pcfg = PagedCacheConfig(page_size=4, num_pages=48, max_slots=2, max_pages_per_seq=24)
    rng = np.random.default_rng(0)
    reqs = [Request(rid=i, prompt=rng.integers(0, cfg.vocab, size=(n,)).astype(np.int32),
                    max_new_tokens=g, arrival=a)
            for i, (n, g, a) in enumerate([(9, 4, 0), (5, 9, 0), (13, 5, 1), (70, 3, 2)])]
    engine = ServingEngine(cfg, init_model(cfg, seed=0, device=cuda), pcfg)
    LAUNCHES.clear()
    out = engine.run(reqs)
    n_mlstm = cfg.n_layers // cfg.slstm_every * (cfg.slstm_every - 1)
    assert LAUNCHES["mlstm_chunk"] == n_mlstm * len(reqs)
    assert LAUNCHES["spectral_matmul"] > 0
    engine.sched.check_invariants()
    check_oracles(engine, reqs, out, reqs)


@pytest.mark.parametrize("profile", MAMBA_PROFILES)
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("case", MAMBA, ids=lambda c: "x".join(map(str, c)))
def test_mamba_scan_kernel_vs_plain(cuda, case, dtype, profile):
    """y and the final state at the fp32 rung, bf16 inputs included: the
    kernel computes the plain version's fp32 operations in its order, so
    a bf16 y rounds from the same value."""
    b, S, di, ds = case
    args = mamba_inputs(b, S, di, ds, profile, dtype=DTYPES[dtype], seed=S, device=cuda)
    before = LAUNCHES["mamba_scan"]
    y, h = mamba_scan(*args)
    assert LAUNCHES["mamba_scan"] == before + 1
    assert y.dtype == DTYPES[dtype] and h.dtype == torch.float32
    yr, hr = mamba_scan_ref(*args)
    for name, g, r in (("y", y, yr), ("hT", h, hr)):
        assert_kernel_matches(lambda: g, lambda: r, (), dtype=torch.float32,
                              label=f"mamba_scan {name} {case} {dtype} {profile}")


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("case", MAMBA_MODEL, ids=lambda c: "x".join(map(str, c)))
def test_mamba_scan_kernel_on_the_model_layout(cuda, case, dtype):
    """A and D in u's dtype, B and C column views of a wider projection (as
    ``nn/mamba.py`` hands them over): one launch, the plain version's
    values at the fp32 rung, and the bits of the kernel on contiguous B and
    C with A and D in fp32."""
    b, S, di, ds = case
    u, dt, B, C, A, D = mamba_inputs(b, S, di, ds, "unit", dtype=DTYPES[dtype], seed=S,
                                     device=cuda)
    _, _, Bv, Cv, Am, Dm = mamba_model_layout(u, dt, B, C, A, D)
    before = LAUNCHES["mamba_scan"]
    y, h = mamba_scan(u, dt, Bv, Cv, Am, Dm)
    assert LAUNCHES["mamba_scan"] == before + 1
    yc, hc = mamba_scan(u, dt, B, C, Am.float(), Dm.float())
    assert torch.equal(y, yc) and torch.equal(h, hc)
    yr, hr = mamba_scan_ref(u, dt, Bv, Cv, Am, Dm)
    for name, g, r in (("y", y, yr), ("hT", h, hr)):
        assert_kernel_matches(lambda: g, lambda: r, (), dtype=torch.float32,
                              label=f"mamba_scan {name} {case} {dtype} model layout")


def test_mamba_scan_kernel_refuses_what_it_cannot_run(cuda):
    u, dt, B, C, A, D = mamba_inputs(1, 8, 64, 16, "unit", device=cuda)
    with pytest.raises(TypeError):
        mamba_scan(u.half(), dt.half(), B.half(), C.half(), A, D)
    with pytest.raises(TypeError):
        mamba_scan(u.bfloat16(), dt, B, C, A, D)
    with pytest.raises(ValueError):
        mamba_scan(u, dt, B[..., :12], C[..., :12], A[:, :12], D)
    with pytest.raises(ValueError):
        mamba_scan(u[:, :0], dt[:, :0], B[:, :0], C[:, :0], A, D)
    with pytest.raises(TypeError):
        mamba_scan_cuda(u, dt, B, C, A, D.bfloat16())
    with pytest.raises(ValueError):
        mamba_scan_cuda(u, dt, B[..., ::2], C[..., ::2], A[:, ::2].contiguous(), D)


def _mamba_cotangents(y, h, finals, seed):
    """dy in y's dtype and, with ``finals``, the final state's dhT (fp32):
    unit normals drawn with numpy."""
    rng = np.random.default_rng(seed)
    dy = torch.tensor(rng.standard_normal(tuple(y.shape)), dtype=torch.float32,
                      device=y.device).to(y.dtype)
    dh = (torch.tensor(rng.standard_normal(tuple(h.shape)), dtype=torch.float32,
                       device=h.device) if finals else None)
    return dy, dh


MAMBA_GRADS = ("du", "ddt", "dB", "dC", "dA", "dD")


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("case", MAMBA, ids=lambda c: "x".join(map(str, c)))
def test_mamba_scan_kernel_records_states(cuda, case, dtype):
    """The training forward's recorded states (h before every
    ``record_steps(ds)``-th step) at the fp32 rung of the plain version's,
    and y and hT the bits of the launch without recording."""
    b, S, di, ds = case
    args = mamba_inputs(b, S, di, ds, "unit", dtype=DTYPES[dtype], seed=S, device=cuda)
    y, h, hs = mamba_scan_cuda(*args, record=True)
    y0, h0 = mamba_scan_cuda(*args)
    assert torch.equal(y, y0) and torch.equal(h, h0)
    _, _, hr = mamba_scan_fwd_ref(*args)
    assert hs.shape == hr.shape and hs.dtype == torch.float32
    assert_kernel_matches(lambda: hs, lambda: hr, (), dtype=torch.float32,
                          label=f"mamba_scan recorded states {case} {dtype}")


@pytest.mark.parametrize("finals", [False, True], ids=["dy", "dy+dhT"])
@pytest.mark.parametrize("profile", MAMBA_PROFILES)
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("case", MAMBA, ids=lambda c: "x".join(map(str, c)))
def test_mamba_scan_bwd_kernel_vs_plain(cuda, case, dtype, profile, finals):
    """Every gradient of the backward kernel (#8b) at the fp32 rung of its
    plain version on the same recorded states, bf16 inputs included (both
    compute the same fp32 operations in one order and round once to the
    output dtype); one count a call, and two calls give the same bits."""
    b, S, di, ds = case
    args = mamba_inputs(b, S, di, ds, profile, dtype=DTYPES[dtype], seed=S, device=cuda)
    y, h, hs = mamba_scan_cuda(*args, record=True)
    dy, dh = _mamba_cotangents(y, h, finals, S + 1)
    before = LAUNCHES["mamba_scan_bwd"]
    got = mamba_scan_bwd_cuda(*args, hs, dy, dh)
    assert LAUNCHES["mamba_scan_bwd"] == before + 1
    again = mamba_scan_bwd_cuda(*args, hs, dy, dh)
    assert all(torch.equal(g, a) for g, a in zip(got, again))
    ref = mamba_scan_bwd_ref(*args, hs, dy, dh)
    for name, g, r, x in zip(MAMBA_GRADS, got, ref, args):
        assert g.dtype == x.dtype and tuple(g.shape) == tuple(x.shape), name
        assert_kernel_matches(lambda: g, lambda: r, (), dtype=torch.float32,
                              label=f"mamba_scan_bwd {name} {case} {dtype} {profile}")


def test_mamba_scan_bwd_kernel_bits_at_the_training_shape(cuda):
    """#8b at jamba's training shape (b 2, S 4096, di 8192, d_state 16, bf16,
    the model's layout, no gradient of the final state): every gradient is
    the plain version's bit for bit (both take one order of rounded
    operations and round once to the output dtype)."""
    args = mamba_model_layout(*mamba_inputs(2, 4096, 8192, 16, "unit", dtype=torch.bfloat16,
                                            seed=17, device=cuda), dt_rank=256)
    y, h, hs = mamba_scan_cuda(*args, record=True)
    dy, _ = _mamba_cotangents(y, h, False, 18)
    got = mamba_scan_bwd_cuda(*args, hs, dy)
    ref = mamba_scan_bwd_ref(*args, hs, dy)
    for name, g, r in zip(MAMBA_GRADS, got, ref):
        assert g.dtype == r.dtype and torch.equal(g, r), name


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("case", MAMBA_MODEL, ids=lambda c: "x".join(map(str, c)))
def test_mamba_scan_autograd_on_the_model_layout(cuda, case, dtype):
    """Under autograd on the model's layout (A and D in u's dtype, B and C
    column views of one projection): one forward launch (recording) and one
    backward call, every gradient the backward kernel's on the same inputs
    in each input's dtype, the projection's gradient the split's."""
    b, S, di, ds = case
    u, dt, B, C, A, D = mamba_inputs(b, S, di, ds, "unit", dtype=DTYPES[dtype], seed=S,
                                     device=cuda)
    _, _, Bv, Cv, Am, Dm = mamba_model_layout(u, dt, B, C, A, D)
    proj = Bv._base.detach().clone().requires_grad_()
    leaves = [t.clone().requires_grad_() for t in (u, dt, Am, Dm)]
    ds0 = proj.shape[-1] - 2 * ds
    _, Bp, Cp = torch.split(proj, [ds0, ds, ds], dim=-1)
    before = (LAUNCHES["mamba_scan"], LAUNCHES["mamba_scan_bwd"])
    y, h = mamba_scan(leaves[0], leaves[1], Bp, Cp, leaves[2], leaves[3])
    dy, _ = _mamba_cotangents(y, h, False, S + 2)
    grads = torch.autograd.grad((y.float() * dy.float()).sum(), [*leaves, proj])
    assert (LAUNCHES["mamba_scan"], LAUNCHES["mamba_scan_bwd"]) == (before[0] + 1,
                                                                     before[1] + 1)
    _, _, hs = mamba_scan_cuda(u, dt, Bv, Cv, Am, Dm, record=True)
    du, ddt, dB, dC, dA, dD = mamba_scan_bwd_cuda(u, dt, Bv, Cv, Am, Dm, hs, dy)
    for got, want in zip(grads[:4], (du, ddt, dA, dD)):
        assert got.dtype == want.dtype and torch.equal(got, want)
    assert torch.equal(grads[4][..., ds0:ds0 + ds], dB)
    assert torch.equal(grads[4][..., ds0 + ds:], dC)
    assert not bool(grads[4][..., :ds0].any())


def test_moe_top_k_ties_on_cuda(cuda):
    """The stable descending sort breaks exact ties toward the lower
    expert index on the card too (``jax.lax.top_k``'s order)."""
    from repro_torch.nn.moe import top_k

    probs = torch.tensor([[0.1, 0.3, 0.3, 0.3], [0.25, 0.25, 0.25, 0.25],
                          [0.4, 0.1, 0.4, 0.1]], device=cuda).repeat(64, 1)
    _, idx = top_k(probs, 2)
    assert idx.cpu().tolist() == [[1, 2], [0, 1], [0, 2]] * 64


def test_jamba_engine_on_cuda(cuda):
    """Reduced jamba (capacity factor 8.0, where capacity never binds)
    through the engine on the card: every prefill runs the scan kernel
    once per mamba layer and decode never does; every decode step runs
    the paged decode kernel once per attention layer; a slot is reused;
    every request equals itself served alone and stays within the ladder
    of the static path."""
    from repro_torch.launch.serve import check_oracles
    from repro_torch.models.lm import n_periods
    from repro_torch.models.model import init_model
    from repro_torch.serving import PagedCacheConfig, Request, ServingEngine

    cfg = get_config("jamba-v0.1-52b", reduced=True).replace(capacity_factor=8.0)
    pcfg = PagedCacheConfig(page_size=4, num_pages=48, max_slots=2, max_pages_per_seq=24)
    rng = np.random.default_rng(0)
    reqs = [Request(rid=i, prompt=rng.integers(0, cfg.vocab, size=(n,)).astype(np.int32),
                    max_new_tokens=g, arrival=a)
            for i, (n, g, a) in enumerate([(9, 4, 0), (5, 9, 0), (13, 5, 1), (70, 3, 2)])]
    engine = ServingEngine(cfg, init_model(cfg, seed=0, device=cuda), pcfg)
    LAUNCHES.clear()
    out = engine.run(reqs)
    n_mamba = n_periods(cfg) * (cfg.attn_every - 1)
    assert LAUNCHES["mamba_scan"] == n_mamba * len(reqs)
    assert LAUNCHES["paged_gqa_decode"] == n_periods(cfg) * engine.decode_steps
    assert LAUNCHES["spectral_matmul"] > 0
    engine.sched.check_invariants()
    check_oracles(engine, reqs, out, reqs)
