// Fused spectral matmul over int8 factors, fp32 activations:
// y = ((x @ widen(U_q8)) * gain) @ widen(V_q8)^T, gain = u_scale * s * v_scale.
//
// Replaces the TPU kernel kernels/spectral_matmul_q8.py:
// spectral_matmul_q8_pallas of the JAX package (wrapper
// kernels/ops.py:spectral_matmul_q8) for fp32 activations; bf16 activations
// run on the tensor cores (spectral_matmul_tc.cu, sct_spectral_matmul_q8_tc),
// since a TF32 product would miss the fp32 rung here.
//
// What bounds it: bytes. At decode (M = serving slots) the work is the int8
// factors, k * (m + n) bytes a projection: one llama3.2-1b layer's three MLP
// projections hold 3 x (2048 + 8192) x 128 B = 3.9 MB, ~1.2 us at 3.35 TB/s.
//
// What the design does about it: the codes stay int8 in device memory and
// in shared memory (the U ring and the staged V tile), so every byte moved
// is one code; each code is widened in a register as it is read (exact:
// |q| <= 127), and the three per-k scale vectors were folded by the wrapper
// into one fp32 gain applied once to the reduced h, before the h -> y pass.
// Everything else is the fp32 kernel's cluster design, template for
// template (spectral_matmul.cuh): the m-reduction split over a thread-block
// cluster, partial h summed through DSMEM in rank order, U streamed through
// a cp.async ring. Its sums run in an order fixed by (m, k, cluster size),
// never by M: batch invariant, as the other spectral kernels are.
#include "spectral_matmul.cuh"

// gain (k,) fp32; U (m, k) and V (n, k) int8 with k a multiple of 16;
// cl and bn as in sct_spectral_matmul (kernels/spectral_matmul_q8.py).
extern "C" int sct_spectral_matmul_q8(const void* x, const void* U_q8, const void* gain,
                                      const void* V_q8, void* y, int M, int m, int n, int k,
                                      int dtype, int cl, int bn, void* stream) {
  if (dtype != sct::kFloat32) return cudaErrorInvalidValue;
  if (M <= 0 || n <= 0) return cudaSuccess;
  if (m <= 0 || k <= 0) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return M <= 8 ? launch<float, int8_t, 8>(x, U_q8, gain, V_q8, y, M, m, n, k, cl, bn, st)
                : launch<float, int8_t, 32>(x, U_q8, gain, V_q8, y, M, m, n, k, cl, bn, st);
}
