"""Paged flash-decode: the CUDA kernels and their wrappers.

``csrc/paged_decode.cu`` replaces the JAX package's GQA kernels
``kernels/paged_decode.py:110`` ``paged_gqa_decode_pallas`` and ``:205``
``paged_gqa_decode_cold_pallas``; ``csrc/paged_mla_decode.cu`` its
absorbed-MLA kernels ``:301`` ``paged_mla_decode_pallas`` and ``:399``
``paged_mla_decode_cold_pallas``.

The tensor's device decides: CPU tensors run the plain version
(``kernels/paged_ref.py``), CUDA tensors launch the kernel or raise.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels.paged_ref import (
    paged_gqa_decode_cold_ref,
    paged_gqa_decode_ref,
    paged_mla_decode_cold_ref,
    paged_mla_decode_ref,
)

# the MLA kernel keeps a thread's share of the latent accumulator in
# registers: at most this latent width (deepseek-v2/v3: 512)
MLA_MAX_LATENT = 512
MLA_HEADS = 64          # query heads a block serves from one staged tile
MLA_ROWS = 16           # token rows of a staged tile
MLA_MAX_SMEM = 232448   # shared memory a Hopper block may take
H100_SMS = 132


# csrc/paged_decode.cu: warps a block, warp-wide row loads a unit
GQA_WARPS, GQA_PASSES = 8, 4


def gqa_geometry(hd: int, page: int, n_pages: int) -> Tuple[int, int, int, int, int]:
    """(E, LP, rows a unit, units a page, units a warp) of a GQA decode
    launch (one block a slot and query head), as ``csrc/paged_decode.cu``
    ``launch`` picks them for aligned pools: E bf16 elements a lane (the
    widest of 8, 4, 2, 1 that divides hd), LP lanes a row (the power of
    two that covers hd / E; at most 32), units of ``GQA_PASSES`` x 32 / LP
    rows of one page, and the units each of the ``GQA_WARPS`` warps walks,
    from the table width alone, so that a slot's row is the same served
    alone or batched. Raises for a head dim the kernel does not take."""
    e = next(v for v in (8, 4, 2, 1) if hd % v == 0)
    lp = 1
    while e * lp < hd:
        lp *= 2
    if lp > 32:
        raise ValueError(f"paged_gqa_decode: head dim {hd} needs {lp} lanes a row; the "
                         f"kernel takes at most 32 (hd <= {32 * e} at this hd's vector)")
    rows = GQA_PASSES * 32 // lp
    per_page = -(-page // rows)
    return e, lp, rows, per_page, -(-n_pages * per_page // GQA_WARPS)


def mla_smem_bytes(lat: int, rope: int, cold: bool) -> int:
    """Shared memory of one MLA block (``csrc/paged_mla_decode.cu``
    ``make_layout``): fp32 q rows for 64 heads, a two-tile bf16 ring, the
    cold tier's int8 codes and scales, the score tiles and statistics."""
    lp = -(-lat // 16) * 16
    kd = lp + -(-rope // 16) * 16
    total = 4 * MLA_HEADS * (kd + 8) + 2 * 2 * MLA_ROWS * (kd + 8)
    if cold:
        total += 2 * MLA_ROWS * kd + 4 * 2 * kd
    return total + 4 * 2 * MLA_HEADS * 24 + 4 * 3 * MLA_HEADS


def mla_geometry(b: int, h: int, n_pages: int, sms: int = H100_SMS) -> Tuple[int, int]:
    """(pages an item walks, items a slot can have) of an MLA launch, from
    what the host knows without a device sync: the slots ``b``, the heads
    ``h`` and the table width ``n_pages`` (the engine keeps no host-side
    bound on live pages). A slot's table is cut into as many items as
    leave b x items x head groups within the ``sms`` SMs (one page an item
    while the pages alone fit), of equal length. The grid is b x items a
    slot x head groups (:func:`mla_items`)."""
    per_slot = max(1, sms // (b * -(-h // MLA_HEADS)))
    ppi = -(-n_pages // per_slot)
    return ppi, -(-n_pages // ppi)


def mla_items(seq_lens: Sequence[int], page: int, n_pages: int,
              ppi: int) -> List[Tuple[int, int, int, int]]:
    """The kernel's live work items: (block, slot, first page, end page).
    Block i x items a slot + k takes pages [k ppi, (k + 1) ppi) of slot i,
    cut at the slot's live pages (up to the one holding position
    seq_lens[i], at most the table width); a block whose item starts past
    them returns before any barrier and is not listed."""
    per_slot = -(-n_pages // ppi)
    items = []
    for i, n in enumerate(seq_lens):
        live = min(n_pages, int(n) // page + 1)
        items += [(i * per_slot + j // ppi, i, j, min(live, j + ppi))
                  for j in range(0, live, ppi)]
    return items


def _check_pools(name, q, k_pool, v_pool, block_table, seq_lens):
    b, kvh, rep, hd = q.shape
    if (k_pool.shape != v_pool.shape or k_pool.shape[2:] != (kvh, hd)
            or block_table.shape[0] != b or seq_lens.shape != (b,)):
        raise ValueError(
            f"{name}: shapes q {tuple(q.shape)}, pools "
            f"{tuple(k_pool.shape)}/{tuple(v_pool.shape)}, block_table "
            f"{tuple(block_table.shape)}, seq_lens {tuple(seq_lens.shape)}")
    if block_table.dtype != torch.int32 or seq_lens.dtype != torch.int32:
        raise TypeError(f"{name}: block_table and seq_lens must be int32")
    if k_pool.dtype != torch.bfloat16 or v_pool.dtype != torch.bfloat16:
        raise TypeError(f"{name}: the kernel reads bf16 pools, got "
                        f"{k_pool.dtype}/{v_pool.dtype}")
    gqa_geometry(hd, k_pool.shape[1], block_table.shape[1])


def paged_gqa_decode_cuda(q, k_pool, v_pool, block_table, seq_lens):
    """The kernel launch; all tensors contiguous on one CUDA device, the
    pools in bf16 (the port's KV dtype), q in fp32 or bf16."""
    b, kvh, rep, hd = q.shape
    _check_pools("paged_gqa_decode", q, k_pool, v_pool, block_table, seq_lens)
    q_code = build.dtype_code(q, "paged_gqa_decode")
    build.require_cuda("paged_gqa_decode", q, k_pool, v_pool, block_table, seq_lens)
    out = torch.empty_like(q)
    lib = build.library()
    err = lib.sct_paged_gqa_decode(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(), block_table.data_ptr(),
        seq_lens.data_ptr(), out.data_ptr(), b, kvh, rep, hd, k_pool.shape[1],
        block_table.shape[1], q_code, 1.0 / hd ** 0.5, build.stream_of(q))
    build.check(err, "paged_gqa_decode")
    build.LAUNCHES["paged_gqa_decode"] += 1
    return out


def paged_gqa_decode_cold_cuda(q, k_pool, v_pool, k_q8, k_scale, v_q8, v_scale,
                               block_table, seq_lens, cold_flags):
    """The cold kernel's launch: :func:`paged_gqa_decode_cuda`'s contract
    plus the int8 shadow pools (the pools' shape), their fp32 per-page
    scales (P+1, kvh, hd) and the int32 cold flags (P+1,)."""
    b, kvh, rep, hd = q.shape
    _check_pools("paged_gqa_decode_cold", q, k_pool, v_pool, block_table, seq_lens)
    P = k_pool.shape[0]
    if (k_q8.shape != k_pool.shape or v_q8.shape != k_pool.shape
            or k_scale.shape != (P, kvh, hd) or v_scale.shape != (P, kvh, hd)
            or cold_flags.shape != (P,)):
        raise ValueError(
            f"paged_gqa_decode_cold: shadow pools {tuple(k_q8.shape)}/"
            f"{tuple(v_q8.shape)}, scales {tuple(k_scale.shape)}/{tuple(v_scale.shape)}, "
            f"cold_flags {tuple(cold_flags.shape)} for pools {tuple(k_pool.shape)}")
    if (k_q8.dtype != torch.int8 or v_q8.dtype != torch.int8
            or k_scale.dtype != torch.float32 or v_scale.dtype != torch.float32
            or cold_flags.dtype != torch.int32):
        raise TypeError("paged_gqa_decode_cold: shadow pools int8, scales fp32, "
                        "cold_flags int32")
    q_code = build.dtype_code(q, "paged_gqa_decode_cold")
    build.require_cuda("paged_gqa_decode_cold", q, k_pool, v_pool, k_q8, k_scale, v_q8,
                       v_scale, block_table, seq_lens, cold_flags)
    out = torch.empty_like(q)
    err = build.library().sct_paged_gqa_decode_cold(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(), k_q8.data_ptr(),
        k_scale.data_ptr(), v_q8.data_ptr(), v_scale.data_ptr(), block_table.data_ptr(),
        seq_lens.data_ptr(), cold_flags.data_ptr(), out.data_ptr(), b, kvh, rep, hd,
        k_pool.shape[1], block_table.shape[1], q_code, 1.0 / hd ** 0.5, build.stream_of(q))
    build.check(err, "paged_gqa_decode_cold")
    build.LAUNCHES["paged_gqa_decode_cold"] += 1
    return out


def paged_gqa_decode(q, k_pool, v_pool, block_table, seq_lens):
    """q: (b, kvh, rep, hd) one-token queries grouped by kv head;
    k_pool/v_pool: (P+1, page, kvh, hd) with this step's token already
    appended at position seq_lens[i]; block_table: (b, n_pages) int32;
    seq_lens: (b,) int32. Returns (b, kvh, rep, hd) in q.dtype."""
    if q.device.type == "cpu":
        return paged_gqa_decode_ref(q, k_pool, v_pool, block_table, seq_lens)
    if q.device.type != "cuda":
        raise ValueError(f"paged_gqa_decode: no kernel for device {q.device}")
    return paged_gqa_decode_cuda(q.contiguous(), k_pool, v_pool,
                                 block_table.contiguous(), seq_lens.contiguous())


def paged_gqa_decode_cold(q, k_pool, v_pool, k_q8, k_scale, v_q8, v_scale,
                          block_table, seq_lens, cold_flags):
    """:func:`paged_gqa_decode` with the streaming cold tier: pages
    flagged in ``cold_flags`` (P+1,) int32 read the int8 shadow pools
    ``k_q8``/``v_q8`` (P+1, page, kvh, hd) times their per-page scales
    ``k_scale``/``v_scale`` (P+1, kvh, hd); hot pages read the bf16
    pools exactly as :func:`paged_gqa_decode` does. Returns
    (b, kvh, rep, hd) in q.dtype."""
    if q.device.type == "cpu":
        return paged_gqa_decode_cold_ref(q, k_pool, v_pool, k_q8, k_scale, v_q8, v_scale,
                                         block_table, seq_lens, cold_flags)
    if q.device.type != "cuda":
        raise ValueError(f"paged_gqa_decode_cold: no kernel for device {q.device}")
    return paged_gqa_decode_cold_cuda(q.contiguous(), k_pool, v_pool, k_q8, k_scale, v_q8,
                                      v_scale, block_table.contiguous(),
                                      seq_lens.contiguous(), cold_flags.contiguous())


def _check_mla(name, q_lat, q_rope, ckv_pool, kr_pool, block_table, seq_lens):
    b, h, lat = q_lat.shape
    if (q_rope.shape[:2] != (b, h) or ckv_pool.shape[2:] != (lat,)
            or kr_pool.shape[:2] != ckv_pool.shape[:2] or kr_pool.shape[2:] != q_rope.shape[2:]
            or block_table.shape[0] != b or seq_lens.shape != (b,)):
        raise ValueError(
            f"{name}: shapes q_lat {tuple(q_lat.shape)}, q_rope {tuple(q_rope.shape)}, "
            f"pools {tuple(ckv_pool.shape)}/{tuple(kr_pool.shape)}, block_table "
            f"{tuple(block_table.shape)}, seq_lens {tuple(seq_lens.shape)}")
    if lat > MLA_MAX_LATENT:
        raise ValueError(f"{name}: latent width {lat} > {MLA_MAX_LATENT}, the kernel's limit")
    if mla_smem_bytes(lat, q_rope.shape[2], name.endswith("_cold")) > MLA_MAX_SMEM:
        raise ValueError(f"{name}: latent {lat} + rope {q_rope.shape[2]} is past the "
                         f"kernel's shared-memory limit")
    if q_rope.dtype != q_lat.dtype:
        raise TypeError(f"{name}: q_lat {q_lat.dtype} and q_rope {q_rope.dtype} differ")
    if block_table.dtype != torch.int32 or seq_lens.dtype != torch.int32:
        raise TypeError(f"{name}: block_table and seq_lens must be int32")
    if ckv_pool.dtype != torch.bfloat16 or kr_pool.dtype != torch.bfloat16:
        raise TypeError(f"{name}: the kernel reads bf16 pools, got "
                        f"{ckv_pool.dtype}/{kr_pool.dtype}")


def _mla_launch(name, fn, q_lat, q_rope, ckv_pool, kr_pool, block_table, seq_lens, scale,
                cold=(), ppi=None):
    from repro_torch.kernels.spectral_matmul import _sm_count

    b, h, lat = q_lat.shape
    q_code = build.dtype_code(q_lat, name)
    build.require_cuda(name, q_lat, q_rope, ckv_pool, kr_pool, block_table, seq_lens, *cold)
    n_pages = block_table.shape[1]
    if ppi is None:
        ppi, per_slot = mla_geometry(b, h, n_pages, _sm_count(q_lat.device.index))
    else:                               # a probe's choice (tools/tc_probe.py --mla --split)
        per_slot = -(-n_pages // ppi)
    out = torch.empty_like(q_lat)
    items = b * per_slot if per_slot > 1 else 0      # scratch of the partial states
    part_o = torch.empty((max(items, 1), h, lat), dtype=torch.float32, device=q_lat.device)
    part_ml = torch.empty((max(items, 1), h, 2), dtype=torch.float32, device=q_lat.device)
    err = fn(q_lat.data_ptr(), q_rope.data_ptr(), ckv_pool.data_ptr(), kr_pool.data_ptr(),
             *(t.data_ptr() for t in cold), block_table.data_ptr(), seq_lens.data_ptr(),
             out.data_ptr(), part_o.data_ptr(), part_ml.data_ptr(), b, h, lat,
             q_rope.shape[2], ckv_pool.shape[1], n_pages, ppi, q_code, float(scale),
             build.stream_of(q_lat))
    build.check(err, name)
    build.LAUNCHES[name] += 1
    return out


def paged_mla_decode_cuda(q_lat, q_rope, ckv_pool, kr_pool, block_table, seq_lens, *,
                          scale: float):
    """The kernel launch; all tensors contiguous on one CUDA device, the
    pools in bf16, q_lat and q_rope in one dtype (fp32 or bf16)."""
    _check_mla("paged_mla_decode", q_lat, q_rope, ckv_pool, kr_pool, block_table, seq_lens)
    return _mla_launch("paged_mla_decode", build.library().sct_paged_mla_decode, q_lat,
                       q_rope, ckv_pool, kr_pool, block_table, seq_lens, scale)


def paged_mla_decode_cold_cuda(q_lat, q_rope, ckv_pool, kr_pool, ckv_q8, ckv_scale, kr_q8,
                               kr_scale, block_table, seq_lens, cold_flags, *, scale: float):
    """The cold kernel's launch: :func:`paged_mla_decode_cuda`'s contract
    plus the int8 shadow pools (the pools' shapes), their fp32 per-page
    scales (P+1, L) / (P+1, R) and the int32 cold flags (P+1,)."""
    name = "paged_mla_decode_cold"
    _check_mla(name, q_lat, q_rope, ckv_pool, kr_pool, block_table, seq_lens)
    P, lat, rope_d = ckv_pool.shape[0], ckv_pool.shape[2], kr_pool.shape[2]
    if (ckv_q8.shape != ckv_pool.shape or kr_q8.shape != kr_pool.shape
            or ckv_scale.shape != (P, lat) or kr_scale.shape != (P, rope_d)
            or cold_flags.shape != (P,)):
        raise ValueError(
            f"{name}: shadow pools {tuple(ckv_q8.shape)}/{tuple(kr_q8.shape)}, scales "
            f"{tuple(ckv_scale.shape)}/{tuple(kr_scale.shape)}, cold_flags "
            f"{tuple(cold_flags.shape)} for pools {tuple(ckv_pool.shape)}/"
            f"{tuple(kr_pool.shape)}")
    if (ckv_q8.dtype != torch.int8 or kr_q8.dtype != torch.int8
            or ckv_scale.dtype != torch.float32 or kr_scale.dtype != torch.float32
            or cold_flags.dtype != torch.int32):
        raise TypeError(f"{name}: shadow pools int8, scales fp32, cold_flags int32")
    return _mla_launch(name, build.library().sct_paged_mla_decode_cold, q_lat, q_rope,
                       ckv_pool, kr_pool, block_table, seq_lens, scale,
                       cold=(ckv_q8, ckv_scale, kr_q8, kr_scale, cold_flags))


def paged_mla_decode(q_lat, q_rope, ckv_pool, kr_pool, block_table, seq_lens, *,
                     scale: float):
    """Absorbed-MLA one-token decode. q_lat (b, h, L): q_nope absorbed
    through W_uk; q_rope (b, h, R); latent pools ckv (P+1, page, L) and kr
    (P+1, page, R) with this step's token already appended at position
    seq_lens[i]; block_table (b, n_pages) int32; seq_lens (b,) int32;
    ``scale`` = 1/sqrt(qk_nope + qk_rope), passed in (it is not derived
    from L). Returns the latent context o_lat (b, h, L) in q_lat.dtype;
    the caller applies W_uv and W_o."""
    if q_lat.device.type == "cpu":
        return paged_mla_decode_ref(q_lat, q_rope, ckv_pool, kr_pool, block_table, seq_lens,
                                    scale=scale)
    if q_lat.device.type != "cuda":
        raise ValueError(f"paged_mla_decode: no kernel for device {q_lat.device}")
    return paged_mla_decode_cuda(q_lat.contiguous(), q_rope.contiguous(), ckv_pool, kr_pool,
                                 block_table.contiguous(), seq_lens.contiguous(), scale=scale)


def paged_mla_decode_cold(q_lat, q_rope, ckv_pool, kr_pool, ckv_q8, ckv_scale, kr_q8,
                          kr_scale, block_table, seq_lens, cold_flags, *, scale: float):
    """:func:`paged_mla_decode` with the streaming cold tier: pages
    flagged in ``cold_flags`` (P+1,) int32 read ``q8 * scale`` from the
    int8 shadow pools ``ckv_q8`` / ``kr_q8`` and their per-page scales
    ``ckv_scale`` (P+1, L) / ``kr_scale`` (P+1, R), keys and values both;
    hot pages read the bf16 pools as :func:`paged_mla_decode` does."""
    if q_lat.device.type == "cpu":
        return paged_mla_decode_cold_ref(q_lat, q_rope, ckv_pool, kr_pool, ckv_q8, ckv_scale,
                                         kr_q8, kr_scale, block_table, seq_lens, cold_flags,
                                         scale=scale)
    if q_lat.device.type != "cuda":
        raise ValueError(f"paged_mla_decode_cold: no kernel for device {q_lat.device}")
    return paged_mla_decode_cold_cuda(q_lat.contiguous(), q_rope.contiguous(), ckv_pool,
                                      kr_pool, ckv_q8, ckv_scale, kr_q8, kr_scale,
                                      block_table.contiguous(), seq_lens.contiguous(),
                                      cold_flags.contiguous(), scale=scale)
