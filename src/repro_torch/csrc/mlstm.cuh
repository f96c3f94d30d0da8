// Device helpers shared by the chunkwise mLSTM's forward
// (csrc/mlstm_chunk.cu) and backward (csrc/mlstm_chunk_bwd.cu): the chunk's
// gate statistics, rebuilt by every block that needs them, so both passes
// start from the same fp32 prefix sums.
#pragma once

#include "common.cuh"

namespace sct {
namespace mlstm {

constexpr int kBlock = 256;     // threads of a block that calls these: one token each

__device__ __forceinline__ float log_sigmoid(float x) {
  return fminf(x, 0.f) - log1pf(expf(-fabsf(x)));
}

// Chunk statistics, every thread of the block: b[j] (fp64 prefix sums of
// log sigmoid(f), rounded once) and ii[j] for the tc tokens of the chunk at
// row0; dsc is scratch of kBlock / 32 doubles. Returns b[tc - 1].
__device__ __forceinline__ float chunk_stats(const float* __restrict__ i_pre,
                                             const float* __restrict__ f_pre, size_t row0,
                                             int tc, float* b, float* ii, double* dsc) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  double x = tid < tc ? static_cast<double>(log_sigmoid(f_pre[row0 + tid])) : 0.0;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const double v = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += v;
  }
  if (lane == 31) dsc[warp] = x;
  __syncthreads();
  double base = 0.0;
  for (int w = 0; w < warp; ++w) base += dsc[w];
  if (tid < tc) {
    b[tid] = static_cast<float>(base + x);
    ii[tid] = i_pre[row0 + tid];
  }
  __syncthreads();
  return b[tc - 1];
}

// max over the block of v (every thread passes one value); fsc: 8 floats
__device__ __forceinline__ float block_max(float v, float* fsc) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  if (lane == 0) fsc[warp] = v;
  __syncthreads();
  float m = fsc[0];
  for (int w = 1; w < kBlock / 32; ++w) m = fmaxf(m, fsc[w]);
  __syncthreads();
  return m;
}

}  // namespace mlstm
}  // namespace sct
