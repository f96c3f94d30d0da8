"""The port's CUDA kernels against their plain PyTorch versions, on the
card: the spectral matmul (and its autograd), the paged GQA decode, and
the flash-attention forward and backward. Every test here needs a GPU and skips without one (the kernels
have no CPU mode). The file imports neither JAX nor the reference
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
from repro_torch.kernels.ops import spectral_matmul  # noqa: E402
from repro_torch.kernels.paged_decode import paged_gqa_decode  # noqa: E402
from repro_torch.kernels.paged_ref import paged_gqa_decode_ref  # noqa: E402
from repro_torch.kernels.ref import spectral_matmul_ref  # noqa: E402
from repro_torch.kernels.testing import (  # noqa: E402
    assert_kernel_matches,
    make_block_table,
    ragged_seq_lens,
)

pytestmark = pytest.mark.cuda

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
# (M, m, n, k): ragged shapes, one row to a prefill-sized batch, ranks 8-256
SPECTRAL = [(1, 64, 96, 16), (7, 130, 50, 8), (37, 300, 700, 64), (64, 128, 128, 128),
            (8, 2048, 8192, 128), (37, 8192, 2048, 128), (160, 2048, 8192, 128),
            (3, 512, 384, 256)]
# b, kvh, rep, hd, page, n_pages_per_seq
PAGED = [(5, 2, 3, 64, 4, 6), (4, 1, 4, 20, 3, 5), (4, 4, 1, 48, 8, 4), (8, 8, 4, 64, 16, 12)]
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
