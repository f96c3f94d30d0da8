"""Port vs reference: absorbed-MLA attention (deepseek) and its paged decode.

The kernels' plain versions (``kernels/paged_ref.py``, which the wrappers
run on CPU tensors) are held against the reference's
``paged_mla_decode_ref`` in fp32 and against its Pallas kernels
``paged_mla_decode_pallas`` / ``paged_mla_decode_cold_pallas`` in
interpret mode, in fp32 and bf16, with ragged ``seq_lens`` (an empty slot,
page edges, a full slot), a shuffled block table and a slot that points
only at the null page; the cold variant at p_cold 0, 0.5 and 1. The MLA
blocks of one layer of reduced deepseek-v3-671b (weights drawn by the
reference's ``init_mla`` and carried across) are held against the
reference's: the expanded form, the chunked paged prefill from an offset
(with and without cold pages) and the paged decode step through the
kernel. Inputs come from numpy seeds and feed both packages.

Tolerances (ladder, outputs over the reference's RMS): fp32 5e-5 — both
compute in fp32 and differ by summation order; bf16 5e-2 — the pools are
bf16 on both sides, both sum in fp32 and round once at the output (the
blocks in bf16 also round their projections where the reference does).
The reference's gather oracle computes in q's dtype, which in bf16 is not
the fp32 decode contract, so it is compared in fp32 only. The bf16 latent
pools a step writes are compared at the bf16 rung. The CUDA kernels are
held against the plain versions on the card (``chip_smoke.py``,
``tests/test_torch_kernels_cuda.py``).
"""
import math

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.config import get_config as jax_get_config  # noqa: E402
from repro.kernels.paged_decode import (  # noqa: E402
    paged_mla_decode_cold_pallas,
    paged_mla_decode_pallas,
)
from repro.kernels.paged_ref import paged_mla_decode_ref as jax_mla_ref  # noqa: E402
from repro.kernels.testing import forced_interpret  # noqa: E402
from repro.nn import attention as jattn  # noqa: E402
from repro_torch.config import get_config  # noqa: E402
from repro_torch.kernels.build import LAUNCHES  # noqa: E402
from repro_torch.kernels.paged_decode import paged_mla_decode, paged_mla_decode_cold  # noqa: E402
from repro_torch.kernels.testing import (  # noqa: E402
    TOLERANCE_LADDER,
    assert_scaled_close,
    mla_inputs,
    ragged_seq_lens,
)
from repro_torch.nn import attention as tattn  # noqa: E402
from repro_torch.nn.rotary import rope_tables  # noqa: E402

torch.set_num_threads(2)

ARCH = "deepseek-v3-671b"
BF16 = TOLERANCE_LADDER[torch.bfloat16]
FP32 = TOLERANCE_LADDER[torch.float32]
# b, h, lat, rope, page, n_pages_per_seq: the reference tests' two shapes
# and a wider one of 16 heads
CASES = [(2, 4, 32, 16, 4, 6), (3, 2, 24, 12, 3, 5), (5, 16, 64, 16, 8, 4)]
DTYPES = {"float32": (torch.float32, jnp.float32), "bfloat16": (torch.bfloat16, jnp.bfloat16)}
SCALE = 1.0 / math.sqrt(48 + 16)


def _np(t):
    return t.detach().float().numpy() if isinstance(t, torch.Tensor) else np.asarray(t, np.float32)


def _close(got, ref, tol, what=""):
    assert_scaled_close(_np(got), np.asarray(jnp.asarray(ref, jnp.float32)), tol, err_msg=what)


def _case(case, p_cold=None, seed=0):
    """numpy-seeded inputs (``mla_inputs``): ragged lengths, a shuffled
    table, slot 0 parked on the null page."""
    b, h, lat, rope, page, n = case
    lens = ragged_seq_lens(b, page * n - 1, page, seed).tolist()
    return mla_inputs(lens, n, h, lat, rope, page, null_slot=True, p_cold=p_cold, seed=seed)


def _jax(args, jdt=None):
    """The port's inputs as jax arrays: floats from their fp32 values
    (pools stay bf16), q in ``jdt``."""
    out = []
    for i, t in enumerate(args):
        if t.dtype == torch.bfloat16:
            out.append(jnp.asarray(t.float().numpy(), jnp.bfloat16))
        elif i < 2 and jdt is not None:
            out.append(jnp.asarray(t.float().numpy(), jdt))
        else:
            out.append(jnp.asarray(t.numpy()))
    return out


@pytest.mark.parametrize("case", CASES, ids=lambda c: "-".join(map(str, c)))
def test_plain_matches_reference_oracle_fp32(case):
    args = _case(case)
    launches = LAUNCHES["paged_mla_decode"]
    y = paged_mla_decode(*args, scale=SCALE)
    assert LAUNCHES["paged_mla_decode"] == launches          # CPU: no kernel launch
    assert y.dtype == torch.float32 and tuple(y.shape) == case[:2] + (case[2],)
    _close(y, jax_mla_ref(*_jax(args), scale=SCALE), FP32, "plain vs reference oracle")


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("case", CASES, ids=lambda c: "-".join(map(str, c)))
def test_plain_matches_pallas_interpret(case, dtype):
    tdt, jdt = DTYPES[dtype]
    args = _case(case, seed=1)
    args = (args[0].to(tdt), args[1].to(tdt)) + args[2:]
    y = paged_mla_decode(*args, scale=SCALE)
    with forced_interpret():
        ref = paged_mla_decode_pallas(*_jax(args, jdt), scale=SCALE)
    assert y.dtype == tdt and ref.dtype == jdt
    _close(y, ref, TOLERANCE_LADDER[tdt], f"plain vs pallas {dtype}")


@pytest.mark.parametrize("p_cold", [0.0, 0.5, 1.0])
@pytest.mark.parametrize("case", CASES[:2], ids=lambda c: "-".join(map(str, c)))
def test_cold_plain_matches_pallas_interpret(case, p_cold):
    """Shadows quantized from independent noise: a page read from the
    wrong tier misses by O(1). With no page flagged the cold plain version
    is the hot one."""
    args = _case(case, p_cold=p_cold, seed=2)
    launches = LAUNCHES["paged_mla_decode_cold"]
    y = paged_mla_decode_cold(*args, scale=SCALE)
    assert LAUNCHES["paged_mla_decode_cold"] == launches
    with forced_interpret():
        ref = paged_mla_decode_cold_pallas(*_jax(args), scale=SCALE)
    _close(y, ref, FP32, f"cold plain vs pallas p={p_cold}")
    q_lat, q_rope, ckv, kr, *_, bt, sl, cold = args
    if p_cold == 0.0:
        assert not cold.any()
        assert torch.equal(y, paged_mla_decode(q_lat, q_rope, ckv, kr, bt, sl, scale=SCALE))
    elif p_cold == 1.0:
        assert not torch.allclose(y, paged_mla_decode(q_lat, q_rope, ckv, kr, bt, sl,
                                                      scale=SCALE))


# ---------------------------------------------------------------- blocks --

@pytest.fixture(scope="module")
def layer():
    """One MLA layer of reduced deepseek-v3-671b, drawn by the reference
    and carried across as fp32 arrays."""
    jcfg = jax_get_config(ARCH, reduced=True).replace(dtype="float32")
    tcfg = get_config(ARCH, reduced=True).replace(dtype="float32")
    jp = jattn.init_mla(jax.random.PRNGKey(3), jcfg)
    tp = jax.tree.map(lambda a: torch.tensor(np.asarray(a)), jax.device_get(jp))
    return jcfg, jp, tcfg, tp


def _cast(tree, dtype):
    if isinstance(tree, dict):
        return {k: _cast(v, dtype) for k, v in tree.items()}
    return tree.to(dtype)


def test_step_rope_tables_at_the_rope_width(layer):
    """MLA rotates only qk_rope_dim channels: the shared tables are built
    at that width, not at head_dim (nope + rope)."""
    _, _, tcfg, _ = layer
    pos = torch.arange(5)[None]
    cos, _ = tattn.step_rope(tcfg, pos)
    assert cos.shape[-1] == tcfg.qk_rope_dim // 2 != tcfg.head_dim // 2
    assert torch.equal(cos, rope_tables(pos, tcfg.qk_rope_dim, tcfg.rope_theta)[0])


def test_apply_mla_matches_reference(layer):
    jcfg, jp, tcfg, tp = layer
    x = np.random.default_rng(4).standard_normal((2, 11, jcfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(11, dtype=np.int32)[None], (2, 11))
    ref = jattn.apply_mla(jp, jnp.asarray(x), jcfg, positions=jnp.asarray(pos))
    with torch.no_grad():
        got = tattn.apply_mla(tp, torch.tensor(x), tcfg, positions=torch.tensor(pos).long())
    _close(got, ref, FP32, "apply_mla")


def _pools(cfg, num_pages, page, rng, cold=False):
    """Random bf16 latent pools (and, with ``cold``, int8 shadows and
    their scales), as numpy float32 plus the dict of torch leaves."""
    from repro_torch.serving.quantize import quantize_kv_pages

    leaves = {"ckv": (num_pages + 1, page, cfg.kv_lora_rank),
              "krope": (num_pages + 1, page, cfg.qk_rope_dim)}
    out = {}
    for name, shape in leaves.items():
        out[name] = torch.tensor(rng.standard_normal(shape), dtype=torch.float32).bfloat16()
        if cold:
            qt = quantize_kv_pages(torch.tensor(rng.standard_normal(shape),
                                                dtype=torch.float32), token_axis=1)
            out[name + "_q8"], out[name + "_scale"] = qt["q8"], qt["scale"]
    return out


def _jax_cache(cache):
    return {k: jnp.asarray(v.float().numpy(), jnp.bfloat16) if v.dtype == torch.bfloat16
            else jnp.asarray(v.numpy()) for k, v in cache.items()}


@pytest.mark.parametrize("cold", [False, True], ids=["hot", "cold"])
def test_apply_mla_prefill_paged_matches_reference(layer, cold):
    """A 7-token chunk at offset 5 of a sequence whose first pages hold a
    cached prefix; the chunk's latents land in its pages, the absorbed
    attend runs over the gathered view (cold pages dequantized)."""
    jcfg, jp, tcfg, tp = layer
    rng = np.random.default_rng(6)
    page, n, start, c = 4, 4, 5, 7
    cache = _pools(tcfg, 10, page, rng, cold=cold)
    bt = np.array([[7, 2, 9, 4]], dtype=np.int32)
    flags = np.zeros((11,), np.int32)
    flags[7] = 1                                   # the prefix's first page is cold
    x = rng.standard_normal((1, c, jcfg.d_model)).astype(np.float32)
    jc = _jax_cache(cache)
    ref, jnew = jattn.apply_mla_prefill_paged(
        jp, jnp.asarray(x), jcfg, cache=jc, block_table=jnp.asarray(bt), start=start,
        cold_flags=jnp.asarray(flags) if cold else None)
    with torch.no_grad():
        got, tnew = tattn.apply_mla_prefill_paged(
            tp, torch.tensor(x), tcfg, cache=cache, block_table=torch.tensor(bt), start=start,
            cold_flags=torch.tensor(flags) if cold else None)
    _close(got, ref, FP32, "prefill chunk output")
    for name in ("ckv", "krope"):
        _close(tnew[name], jnew[name], BF16, f"pool {name}")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("cold", [False, True], ids=["hot", "cold"])
def test_apply_mla_decode_paged_matches_reference(layer, dtype, cold):
    """One decode step of three slots (ragged lengths, slot 0 inactive on
    the null page) through the kernel's plain version, against the
    reference's step through its Pallas kernel in interpret mode (and,
    with cold flags, its cold kernel): the same fp32 absorb, fp32 kernel
    I/O and one rounding before wo."""
    jcfg, jp, tcfg, tp = layer
    tdt, jdt = DTYPES[dtype]
    rng = np.random.default_rng(8)
    page, n, P = 4, 5, 16
    cache = _pools(tcfg, P, page, rng, cold=cold)
    sl = np.array([0, 9, 17], np.int32)
    bt = np.array([[P] * n, [3, 11, 5, P, P], [14, 0, 8, 2, 6]], np.int32)
    flags = (rng.uniform(size=P + 1) < 0.5).astype(np.int32)
    x = rng.standard_normal((3, 1, jcfg.d_model)).astype(np.float32)
    jc = _jax_cache(cache)
    jpd = jax.tree.map(lambda a: a.astype(jdt) if a.dtype == jnp.float32 else a, jp)
    jpd["wukv"] = jp["wukv"]                       # served in fp32 (models/model.py)
    with forced_interpret():
        ref, jnew = jattn.apply_mla_decode_paged(
            jpd, jnp.asarray(x, jdt), jcfg, cache=jc, block_table=jnp.asarray(bt),
            seq_lens=jnp.asarray(sl), cold_flags=jnp.asarray(flags) if cold else None)
    tpd = _cast(tp, tdt)
    tpd["wukv"] = tp["wukv"]
    with torch.no_grad():
        got, tnew = tattn.apply_mla_decode_paged(
            tpd, torch.tensor(x).to(tdt), tcfg, cache=cache, block_table=torch.tensor(bt),
            seq_lens=torch.tensor(sl), cold_flags=torch.tensor(flags) if cold else None)
    assert got.dtype == tdt
    _close(got, ref, TOLERANCE_LADDER[tdt], f"decode step {dtype}")
    for name in ("ckv", "krope"):
        _close(tnew[name], jnew[name], BF16, f"pool {name}")


def test_apply_mla_decode_static_matches_reference(layer):
    """The static cache's absorbed step (fp32 attention, the oracle the
    engine is checked against) after the expanded prefill."""
    jcfg, jp, tcfg, tp = layer
    rng = np.random.default_rng(9)
    x = rng.standard_normal((2, 6, jcfg.d_model)).astype(np.float32)
    nxt = rng.standard_normal((2, 1, jcfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(6, dtype=np.int32)[None], (2, 6))
    jcache = {"ckv": jnp.zeros((2, 12, jcfg.kv_lora_rank), jnp.bfloat16),
              "krope": jnp.zeros((2, 12, jcfg.qk_rope_dim), jnp.bfloat16)}
    _, jcache = jattn.apply_mla_prefill(jp, jnp.asarray(x), jcfg, positions=jnp.asarray(pos),
                                        cache=jcache)
    ref, jcache = jattn.apply_mla_decode(jp, jnp.asarray(nxt), jcfg, cache=jcache,
                                         cache_len=jnp.int32(6))
    tcache = {"ckv": torch.zeros((2, 12, tcfg.kv_lora_rank), dtype=torch.bfloat16),
              "krope": torch.zeros((2, 12, tcfg.qk_rope_dim), dtype=torch.bfloat16)}
    with torch.no_grad():
        _, tcache = tattn.apply_mla_prefill(tp, torch.tensor(x), tcfg,
                                            positions=torch.tensor(pos).long(), cache=tcache)
        got, tcache = tattn.apply_mla_decode(tp, torch.tensor(nxt), tcfg, cache=tcache,
                                             cache_len=6)
    _close(got, ref, FP32, "static decode step")
    for name in ("ckv", "krope"):
        _close(tcache[name], jcache[name], BF16, f"cached {name}")
