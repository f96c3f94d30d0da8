// Fused spectral matmul over fp32 factors: y = ((x @ U) * s) @ V^T.
//
// Replaces the TPU kernel kernels/spectral_matmul.py:spectral_matmul_pallas
// of the JAX package (wrapper kernels/ops.py:spectral_matmul) for fp32; bf16
// runs on the tensor cores (spectral_matmul_tc.cu). The kernel, what bounds
// it and its design are in spectral_matmul.cuh, shared with the int8
// variant.
#include "spectral_matmul.cuh"

// cl: cluster size (blocks sharing one m-reduction, 1..8); bn: output
// columns per block. The wrapper picks both (kernels/spectral_matmul.py).
extern "C" int sct_spectral_matmul(const void* x, const void* U, const void* s,
                                   const void* V, void* y, int M, int m, int n, int k,
                                   int dtype, int cl, int bn, void* stream) {
  if (dtype != sct::kFloat32) return cudaErrorInvalidValue;
  if (M <= 0 || n <= 0) return cudaSuccess;
  if (m <= 0 || k <= 0) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return M <= 8 ? launch<float, float, 8>(x, U, s, V, y, M, m, n, k, cl, bn, st)
                : launch<float, float, 32>(x, U, s, V, y, M, m, n, k, cl, bn, st);
}
