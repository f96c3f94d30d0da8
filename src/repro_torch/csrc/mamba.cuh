// Helpers shared by the selective scan's forward (csrc/mamba_scan.cu) and
// backward (csrc/mamba_scan_bwd.cu): the block's channels, the steps
// between the states the forward records for the backward, the tree sum
// both take over the states, and the inputs' layout.
#pragma once

#include "common.cuh"

namespace sct {
namespace mamba {

constexpr int kChannels = 32;  // channels a block: one a lane
constexpr int kTile = 32;      // time steps a staged tile of the forward

// steps between recorded states (kernels/mamba_ref.py:record_steps): a
// whole tile up to d_state 16, fewer above so that the backward's stretch
// of states and exps fits 128 KB; a multiple of the forward's group of
// steps, so a recorded step starts a group
__host__ __device__ constexpr int rec_steps(int ds) { return ds <= 16 ? kTile : 512 / ds; }

// The sum of kN values as a binary tree over neighbouring pairs, in place:
// ((v0 + v1) + (v2 + v3)) + ... lands in v[0].
template <int kN>
__device__ __forceinline__ void tree_sum(float (&v)[kN]) {
#pragma unroll
  for (int w = 1; w < kN; w *= 2) {
#pragma unroll
    for (int i = 0; i + w < kN; i += 2 * w) v[i] = __fadd_rn(v[i], v[i + w]);
  }
}

// A and D are fp32 or the inputs' bf16
__device__ __forceinline__ float load_param(const void* p, size_t i, bool bf16) {
  return bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i])
              : static_cast<const float*>(p)[i];
}

struct Strides {
  long long b_batch, b_row, c_batch, c_row;  // of B and C, in elements
};

}  // namespace mamba
}  // namespace sct
