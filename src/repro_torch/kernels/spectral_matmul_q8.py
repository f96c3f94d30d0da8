"""Launch of the fused int8 spectral matmul CUDA kernel
(``csrc/spectral_matmul_q8.cu``), which replaces the JAX package's
``kernels/spectral_matmul_q8.py:65`` ``spectral_matmul_q8_pallas``.

The kernel is the bf16 kernel's cluster design over int8 factors
(``csrc/spectral_matmul.cuh``), so it takes the same launch geometry.
The wrapper the model calls is ``kernels/ops.py:spectral_matmul_q8``;
its plain version is ``kernels/ref.py:spectral_matmul_q8_ref``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.spectral_matmul import MAX_RANK, _sm_count, launch_geometry


def spectral_matmul_q8_cuda(x2: torch.Tensor, U_q8: torch.Tensor, gain: torch.Tensor,
                            V_q8: torch.Tensor) -> torch.Tensor:
    """x2 (M, m) fp32/bf16, U_q8 (m, k) and V_q8 (n, k) int8, gain (k,)
    fp32, all contiguous on one CUDA device -> y (M, n) in x2.dtype.

    The kernel reads the codes in 16-byte vectors, so it takes a rank
    that is a multiple of 16 and 16-byte aligned factors; anything else
    raises ValueError."""
    M, m = x2.shape
    k = U_q8.shape[1]
    n = V_q8.shape[0]
    if U_q8.shape != (m, k) or V_q8.shape != (n, k) or gain.shape != (k,):
        raise ValueError(f"spectral_matmul_q8: shapes x {tuple(x2.shape)}, U "
                         f"{tuple(U_q8.shape)}, gain {tuple(gain.shape)}, V "
                         f"{tuple(V_q8.shape)}")
    if U_q8.dtype != torch.int8 or V_q8.dtype != torch.int8 or gain.dtype != torch.float32:
        raise TypeError("spectral_matmul_q8: U and V must be int8, gain fp32")
    code = build.dtype_code(x2, "spectral_matmul_q8")
    if k > MAX_RANK:
        raise ValueError(f"spectral_matmul_q8: rank {k} > {MAX_RANK} is not supported")
    if k % 16:
        raise ValueError(f"spectral_matmul_q8: rank {k} is not a multiple of 16")
    if U_q8.data_ptr() % 16 or V_q8.data_ptr() % 16:
        raise ValueError("spectral_matmul_q8: U and V must be 16-byte aligned")
    build.require_cuda("spectral_matmul_q8", x2, U_q8, gain, V_q8)
    y = torch.empty((M, n), dtype=x2.dtype, device=x2.device)
    cl, bn = launch_geometry(M, m, n, _sm_count(x2.device.index))
    err = build.library().sct_spectral_matmul_q8(
        x2.data_ptr(), U_q8.data_ptr(), gain.data_ptr(), V_q8.data_ptr(), y.data_ptr(),
        M, m, n, k, code, cl, bn, build.stream_of(x2))
    build.check(err, "spectral_matmul_q8")
    build.LAUNCHES["spectral_matmul_q8"] += 1
    return y
