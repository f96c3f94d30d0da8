"""Paged GQA flash-decode: the CUDA kernels (``csrc/paged_decode.cu``),
which replace the JAX package's
``kernels/paged_decode.py:110`` ``paged_gqa_decode_pallas`` and
``:205`` ``paged_gqa_decode_cold_pallas``, and their wrappers.

The tensor's device decides: CPU tensors run the plain version
(``kernels/paged_ref.py``), CUDA tensors launch the kernel or raise.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.paged_ref import paged_gqa_decode_cold_ref, paged_gqa_decode_ref


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
