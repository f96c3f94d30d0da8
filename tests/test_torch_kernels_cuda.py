"""The port's CUDA kernels against their plain PyTorch versions, on the
card: the spectral matmul (and its autograd), its int8 variant, the
paged GQA decode and its cold-tier variant, the flash-attention
forward and backward, the chunkwise mLSTM and the selective scan; and
the reduced xlstm and jamba engines on the card. Every test here needs a GPU and skips without one
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
from repro_torch.kernels.paged_decode import paged_gqa_decode, paged_gqa_decode_cold  # noqa: E402
from repro_torch.kernels.paged_ref import (  # noqa: E402
    paged_gqa_decode_cold_ref,
    paged_gqa_decode_ref,
)
from repro_torch.kernels.mlstm_chunk import CHUNK as MLSTM_KERNEL_CHUNK  # noqa: E402
from repro_torch.kernels.mlstm_chunk import mlstm_chunk  # noqa: E402
from repro_torch.kernels.mlstm_ref import mlstm_chunk_ref  # noqa: E402
from repro_torch.kernels.mamba_ref import mamba_scan_ref  # noqa: E402
from repro_torch.kernels.mamba_scan import mamba_scan  # noqa: E402
from repro_torch.kernels.ref import spectral_matmul_q8_ref, spectral_matmul_ref  # noqa: E402
from repro_torch.serving.quantize import quantize_kv_pages  # noqa: E402
from repro_torch.kernels.testing import (  # noqa: E402
    MAMBA_PROFILES,
    MLSTM_PROFILES,
    SCALE_PROFILES,
    assert_kernel_matches,
    make_block_table,
    mamba_inputs,
    mlstm_inputs,
    ragged_seq_lens,
    scale_profile,
)

pytestmark = pytest.mark.cuda

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
# (M, m, n, k): ragged shapes, one row to a prefill-sized batch, ranks 8-256
SPECTRAL = [(1, 64, 96, 16), (7, 130, 50, 8), (37, 300, 700, 64), (64, 128, 128, 128),
            (8, 2048, 8192, 128), (37, 8192, 2048, 128), (160, 2048, 8192, 128),
            (3, 512, 384, 256),
            # xlstm-1.3b's projections at decode (4 slots) and a 160-token
            # prefill: up 2048->8192, down 4096->2048, ff_up 2048->5460,
            # ff_down 2730->2048
            (4, 2048, 8192, 128), (160, 4096, 2048, 128), (4, 2048, 5460, 128),
            (160, 2730, 2048, 128),
            # jamba-v0.1-52b's MLPs at the kernel's largest rank: up/gate
            # 4096->14336 and down 14336->4096 at decode and a 160-token prefill
            (4, 4096, 14336, 256), (160, 4096, 14336, 256), (4, 14336, 4096, 256),
            (160, 14336, 4096, 256)]
# (M, m, n, k) of the int8 kernel: its rank is a multiple of 16
SPECTRAL_Q8 = [(1, 64, 96, 16), (7, 130, 50, 16), (37, 300, 700, 64), (4, 2048, 8192, 128),
               (37, 8192, 2048, 128), (256, 2048, 8192, 128), (3, 512, 384, 256)]
# b, kvh, rep, hd, page, n_pages_per_seq
PAGED = [(5, 2, 3, 64, 4, 6), (4, 1, 4, 20, 3, 5), (4, 4, 1, 48, 8, 4), (8, 8, 4, 64, 16, 12),
         (4, 8, 4, 128, 16, 12)]     # jamba's attention layers: head dim 128
# (B, S, dh) of the mLSTM kernel: a ragged 64-token chunk, one token, two
# and sixteen chunks; the reduced head width and xlstm-1.3b's 1024
MLSTM = ([(B, S, 32) for B in (1, 4) for S in (1, 37, 64, 300)]
         + [(4, 160, 1024), (1, 1000, 1024)])
# (b, S, di, ds) of the selective scan: one token, ragged channels and
# steps, jamba's prefill (di 8192, ds 16), every state width it is built for
MAMBA = [(1, 1, 128, 16), (2, 37, 200, 16), (1, 160, 8192, 16), (2, 300, 96, 4),
         (1, 64, 130, 64), (2, 1000, 256, 8), (1, 33, 64, 32)]
# (b, s, g, r, d): rep 1 and 4 at s 256, 1000 (ragged tiles) and 4096, plus
# head dim 128 and a group size that does not divide the 64-row tile
FLASH = ([(1, s, g, r, 64) for s in (256, 1000, 4096) for g, r in ((4, 1), (2, 4))]
         + [(2, 256, 2, 2, 128), (1, 300, 1, 3, 64)])


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


def test_spectral_matmul_rows_are_batch_invariant(cuda):
    """A row's output does not depend on the other rows: the engine's
    batched decode and the batch-1 reference agree bit for bit."""
    x, U, s, V = _spectral(8, 2048, 8192, 128, torch.bfloat16, cuda)
    full = spectral_matmul(x, U, s, V)
    for i in (0, 5):
        assert torch.equal(spectral_matmul(x[i:i + 1], U, s, V)[0], full[i])


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


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_spectral_matmul_q8_rows_are_batch_invariant(cuda, dtype):
    """Every row of an M=37 call equals the same row alone, bit for bit,
    on both MLP shapes: the int8 engine's batched steps and its batch-1
    static reference agree exactly."""
    for m, n in ((2048, 8192), (8192, 2048)):
        x, U, s, V = _q8(37, m, n, 128, "unit", DTYPES[dtype], cuda)
        full = spectral_matmul_q8(x, U, s, V)
        for i in range(37):
            assert torch.equal(spectral_matmul_q8(x[i:i + 1], U, s, V)[0], full[i]), (m, i)


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


def _flash_inputs(b, s, g, r, d, dtype, device, seed=0):
    gen = torch.Generator(device=device).manual_seed(seed)
    q, do = (torch.randn((b, s, g, r, d), generator=gen, device=device) for _ in range(2))
    k, v = (torch.randn((b, s, g, d), generator=gen, device=device) for _ in range(2))
    return [t.to(dtype) for t in (q, k, v, do)]


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("case", FLASH, ids=lambda c: "-".join(map(str, c)))
def test_flash_kernels_vs_plain(cuda, case, dtype):
    """Forward (out, m, l) and backward (dq, dk, dv), each against the
    plain version on the same inputs; the backward gets the plain
    forward's out/m/l so it is checked on its own."""
    q, k, v, do = _flash_inputs(*case, DTYPES[dtype], cuda)
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


def test_flash_kernel_refuses_other_head_dims(cuda):
    q, k, v, _ = _flash_inputs(1, 64, 1, 1, 80, torch.bfloat16, cuda)
    with pytest.raises(ValueError, match="head dim 80"):
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


@pytest.mark.parametrize("with_state", [False, True], ids=["empty", "state"])
@pytest.mark.parametrize("profile", MLSTM_PROFILES)
@pytest.mark.parametrize("case", MLSTM, ids=lambda c: "x".join(map(str, c)))
def test_mlstm_chunk_kernel_vs_plain(cuda, case, profile, with_state):
    """y and the final (C, n, m), each against the plain version cut into
    the kernel's chunks (the function is the same under any chunking;
    the same chunks round the same prefix sums), at the fp32 rung."""
    B, S, dh = case
    q, k, v, i, f, state = mlstm_inputs(B, S, dh, profile, seed=S, device=cuda,
                                        with_state=with_state)
    before = LAUNCHES["mlstm_chunk"]
    y, got = mlstm_chunk(q, k, v, i, f, state)
    assert LAUNCHES["mlstm_chunk"] == before + 1
    yr, ref = mlstm_chunk_ref(q, k, v, i, f, state, chunk=MLSTM_KERNEL_CHUNK, ragged=True)
    for name, g, r in zip(("y", "C", "n", "m"), (y, *got), (yr, *ref)):
        assert_kernel_matches(lambda: g, lambda: r, (), dtype=torch.float32,
                              label=f"mlstm_chunk {name} {case} {profile}")


@pytest.mark.parametrize("case", [(2, 37, 32), (2, 256, 64), (2, 300, 32), (1, 160, 1024)],
                         ids=lambda c: "x".join(map(str, c)))
def test_mlstm_chunk_kernel_vs_reference_chunking(cuda, case):
    """Against the plain version chunked as the reference chunks (256,
    or one chunk when 256 does not divide S): the kernel's 64-token
    chunks give the same function."""
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
