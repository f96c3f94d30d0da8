// Fused spectral matmul over bf16/fp32 factors: y = ((x @ U) * s) @ V^T.
//
// Replaces the TPU kernel kernels/spectral_matmul.py:spectral_matmul_pallas
// of the JAX package (wrapper kernels/ops.py:spectral_matmul). The kernel,
// what bounds it and its design are in spectral_matmul.cuh, shared with
// the int8 variant.
#include "spectral_matmul.cuh"

// cl: cluster size (blocks sharing one m-reduction, 1..8); bn: output
// columns per block. The wrapper picks both (kernels/spectral_matmul.py).
extern "C" int sct_spectral_matmul(const void* x, const void* U, const void* s,
                                   const void* V, void* y, int M, int m, int n, int k,
                                   int dtype, int cl, int bn, void* stream) {
  return launch_dtype<FloatFactors>(x, U, s, V, y, M, m, n, k, dtype, cl, bn, stream);
}
