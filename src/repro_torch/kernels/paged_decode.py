"""Paged GQA flash-decode: the CUDA kernel (``csrc/paged_decode.cu``),
which replaces the JAX package's
``kernels/paged_decode.py:paged_gqa_decode_pallas``, and its wrapper.

The tensor's device decides: CPU tensors run the plain version
(``kernels/paged_ref.py``), CUDA tensors launch the kernel or raise.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.paged_ref import paged_gqa_decode_ref


def paged_gqa_decode_cuda(q, k_pool, v_pool, block_table, seq_lens):
    """The kernel launch; all tensors contiguous on one CUDA device, the
    pools in bf16 (the port's KV dtype), q in fp32 or bf16."""
    b, kvh, rep, hd = q.shape
    page = k_pool.shape[1]
    n_pages = block_table.shape[1]
    if (k_pool.shape != v_pool.shape or k_pool.shape[2:] != (kvh, hd)
            or block_table.shape[0] != b or seq_lens.shape != (b,)):
        raise ValueError(
            f"paged_gqa_decode: shapes q {tuple(q.shape)}, pools "
            f"{tuple(k_pool.shape)}/{tuple(v_pool.shape)}, block_table "
            f"{tuple(block_table.shape)}, seq_lens {tuple(seq_lens.shape)}")
    if block_table.dtype != torch.int32 or seq_lens.dtype != torch.int32:
        raise TypeError("paged_gqa_decode: block_table and seq_lens must be int32")
    if k_pool.dtype != torch.bfloat16 or v_pool.dtype != torch.bfloat16:
        raise TypeError(f"paged_gqa_decode: the kernel reads bf16 pools, got "
                        f"{k_pool.dtype}/{v_pool.dtype}")
    q_code = build.dtype_code(q, "paged_gqa_decode")
    build.require_cuda("paged_gqa_decode", q, k_pool, v_pool, block_table, seq_lens)
    out = torch.empty_like(q)
    lib = build.library()
    err = lib.sct_paged_gqa_decode(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(), block_table.data_ptr(),
        seq_lens.data_ptr(), out.data_ptr(), b, kvh, rep, hd, page, n_pages,
        q_code, 1.0 / hd ** 0.5, build.stream_of(q))
    build.check(err, "paged_gqa_decode")
    build.LAUNCHES["paged_gqa_decode"] += 1
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
