"""Launch of the fused spectral matmul CUDA kernel
(``csrc/spectral_matmul.cu``), which replaces the JAX package's
``kernels/spectral_matmul.py:spectral_matmul_pallas``.

The wrapper the model calls is ``kernels/ops.py:spectral_matmul``.
"""
from __future__ import annotations

import functools

import torch

from repro_torch.kernels import build

MAX_RANK = 256          # the kernel's shared-memory budget
MAX_CLUSTER = 8         # portable thread-block cluster size
ROWS_PER_SLICE = 256    # m rows a cluster block reduces, at least


def launch_geometry(M: int, m: int, n: int, sms: int) -> tuple:
    """(cluster size, output columns per block).

    The cluster size depends on m alone, so a row's summation order (and
    with it every bit of its output) never depends on M: batch invariant.
    Column blocks are sized so the grid covers every SM about once, with
    at least 16 columns a block."""
    cl = 1
    while cl < MAX_CLUSTER and cl * ROWS_PER_SLICE < m:
        cl *= 2
    row_blocks = -(-M // (8 if M <= 8 else 32))
    col_groups = max(1, sms // (row_blocks * cl))
    col_groups = max(1, min(col_groups, -(-n // (cl * 16))))
    return cl, -(-n // (col_groups * cl))


@functools.lru_cache(maxsize=None)
def _sm_count(device_index: int) -> int:
    return torch.cuda.get_device_properties(device_index).multi_processor_count


def spectral_matmul_cuda(x2: torch.Tensor, U: torch.Tensor, s: torch.Tensor,
                         V: torch.Tensor) -> torch.Tensor:
    """x2 (M, m), U (m, k) and V (n, k) in x2.dtype, s (k,) fp32, all
    contiguous on one CUDA device -> y (M, n) in x2.dtype.

    The kernel reads U and V in 16-byte vectors, so it takes a rank that
    fills whole vectors (a multiple of 8 in bf16, of 4 in fp32) and
    16-byte aligned factors; anything else raises ValueError."""
    M, m = x2.shape
    k = U.shape[1]
    n = V.shape[0]
    if U.shape != (m, k) or V.shape != (n, k) or s.shape != (k,):
        raise ValueError(f"spectral_matmul: shapes x {tuple(x2.shape)}, U "
                         f"{tuple(U.shape)}, s {tuple(s.shape)}, V {tuple(V.shape)}")
    if U.dtype != x2.dtype or V.dtype != x2.dtype or s.dtype != torch.float32:
        raise TypeError("spectral_matmul: U and V must be in x's dtype, s fp32")
    code = build.dtype_code(x2, "spectral_matmul")
    if k > MAX_RANK:
        raise ValueError(f"spectral_matmul: rank {k} > {MAX_RANK} is not supported")
    if k * U.element_size() % 16:
        raise ValueError(f"spectral_matmul: rank {k} is not a multiple of "
                         f"{16 // U.element_size()} in {U.dtype}")
    if U.data_ptr() % 16 or V.data_ptr() % 16:
        raise ValueError("spectral_matmul: U and V must be 16-byte aligned")
    build.require_cuda("spectral_matmul", x2, U, s, V)
    y = torch.empty((M, n), dtype=x2.dtype, device=x2.device)
    cl, bn = launch_geometry(M, m, n, _sm_count(x2.device.index))
    err = build.library().sct_spectral_matmul(
        x2.data_ptr(), U.data_ptr(), s.data_ptr(), V.data_ptr(), y.data_ptr(),
        M, m, n, k, code, cl, bn, build.stream_of(x2))
    build.check(err, "spectral_matmul")
    build.LAUNCHES["spectral_matmul"] += 1
    return y
