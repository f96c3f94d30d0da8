"""Launch of the fused spectral matmul CUDA kernels, which replace the JAX
package's ``kernels/spectral_matmul.py:spectral_matmul_pallas``: bf16
runs on the tensor cores (``csrc/spectral_matmul_tc.cu``), fp32 on the
CUDA cores (``csrc/spectral_matmul.cu``, the template of
``csrc/spectral_matmul.cuh``). The dtype picks the kernel; a call that
the picked kernel cannot take raises.

The wrapper the model calls is ``kernels/ops.py:spectral_matmul``.
"""
from __future__ import annotations

import functools

import torch

from repro_torch.kernels import build

MAX_RANK = 256          # the kernels' shared-memory budget
MAX_CLUSTER = 8         # portable thread-block cluster size
ROWS_PER_SLICE = 256    # m rows a cluster block reduces, at least
TC_COL_ALIGN = 8        # the tensor-core kernel's bn: whole 16-byte stores of y


def cluster_size(m: int) -> int:
    """Blocks that share one m-reduction: a function of m alone, so a
    row's summation order (and with it every bit of its output) never
    depends on M: batch invariant."""
    cl = 1
    while cl < MAX_CLUSTER and cl * ROWS_PER_SLICE < m:
        cl *= 2
    return cl


def row_tile(M: int, dtype: torch.dtype) -> int:
    """Rows of x a block takes: bf16 (tensor cores, bf16 or int8 factors)
    16 at decode, else 64; fp32 (CUDA cores) 8 at decode, else 32."""
    if dtype == torch.bfloat16:
        return 16 if M <= 16 else 64
    return 8 if M <= 8 else 32


def split_over_cluster(M: int, rows: int, sms: int) -> bool:
    """Whether the tensor-core kernel runs a row tile's m slices on the
    blocks of a cluster (True) or all in one block (False). One block
    computes the same sum in the same order, so the choice changes no bit;
    it is taken once the row tiles alone fill half the SMs."""
    return rows == 16 or -(-M // rows) < sms // 2


def launch_geometry(M: int, m: int, n: int, sms: int, rows: int,
                    col_align: int = 1, split: bool = True) -> tuple:
    """(cluster size, output columns per block) for row tiles of ``rows``.

    The cluster size, the number of m slices, depends on m alone. Column
    blocks are sized so the grid covers every SM about once, with at
    least 16 columns a block, then rounded up to ``col_align``; ``split``
    False runs a row tile's slices in one block instead of a cluster."""
    cl = cluster_size(m)
    width = cl if split else 1      # blocks that share a row tile's m-reduction
    row_blocks = -(-M // rows)
    col_groups = max(1, sms // (row_blocks * width))
    col_groups = max(1, min(col_groups, -(-n // (width * 16))))
    bn = -(-n // (col_groups * width))
    return cl, -(-bn // col_align) * col_align


def kernel_geometry(M: int, m: int, n: int, dtype: torch.dtype, sms: int) -> tuple:
    """(row tile, split over a cluster, cluster size, output columns per
    block) of a launch, bf16 or int8 factors alike: bf16 activations take
    the tensor-core kernel's geometry, fp32 the CUDA-core kernel's, which
    always runs its slices on a cluster."""
    rows = row_tile(M, dtype)
    if dtype == torch.bfloat16:
        split = split_over_cluster(M, rows, sms)
        return (rows, split) + launch_geometry(M, m, n, sms, rows, TC_COL_ALIGN, split)
    return (rows, True) + launch_geometry(M, m, n, sms, rows)


@functools.lru_cache(maxsize=None)
def _sm_count(device_index: int) -> int:
    return torch.cuda.get_device_properties(device_index).multi_processor_count


def spectral_matmul_cuda(x2: torch.Tensor, U: torch.Tensor, s: torch.Tensor,
                         V: torch.Tensor) -> torch.Tensor:
    """x2 (M, m), U (m, k) and V (n, k) in x2.dtype, s (k,) fp32, all
    contiguous on one CUDA device -> y (M, n) in x2.dtype.

    The kernels read U and V in 16-byte vectors, so they take a rank that
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
    rows, split, cl, bn = kernel_geometry(M, m, n, x2.dtype, _sm_count(x2.device.index))
    lib = build.library()
    if x2.dtype == torch.bfloat16:
        err = lib.sct_spectral_matmul_tc(
            x2.data_ptr(), U.data_ptr(), s.data_ptr(), V.data_ptr(), y.data_ptr(),
            M, m, n, k, rows, cl, int(split), bn, build.stream_of(x2))
    else:
        err = lib.sct_spectral_matmul(
            x2.data_ptr(), U.data_ptr(), s.data_ptr(), V.data_ptr(), y.data_ptr(),
            M, m, n, k, code, cl, bn, build.stream_of(x2))
    build.check(err, "spectral_matmul")
    build.LAUNCHES["spectral_matmul"] += 1
    return y
