// Floors of the selective scan on one GPU, built and timed by
// tools/tc_probe.py --mamba (nvcc into src/repro_torch/_build/probe/):
//
// - floor_empty: a kernel that does nothing, on a given grid: the launch and
//   the timing events alone;
// - floor_one_round: one dependent round of loads and a store on the scan's
//   grid (a u, dt, B and C value a thread, their sum written out);
// - floor_exps: n_per_thread x 4 exponentials of dt * a a thread on a grid
//   that fills the card, each summed into a register (mode 0: the accurate
//   expf the scan computes, FMUL + expf + FADD an element; 1: the accurate
//   exp2f; 2: ex2.approx alone, which the MUFU unit's rate bounds).
//
// Timings only: the values written are meaningless.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

__global__ void empty_kernel() {}

__global__ void one_round_kernel(const __nv_bfloat16* __restrict__ u,
                                 const __nv_bfloat16* __restrict__ dt,
                                 const __nv_bfloat16* __restrict__ B,
                                 const __nv_bfloat16* __restrict__ C, float* __restrict__ out,
                                 int S, int di, int ds) {
  const int c = blockIdx.x * 32 + threadIdx.x % 32;
  const int r = threadIdx.x / 32;
  const size_t row = (size_t)blockIdx.y * S + min(r, S - 1);
  if (c >= di) return;
  const float v = __bfloat162float(u[row * di + c]) + __bfloat162float(dt[row * di + c]) +
                  __bfloat162float(B[row * ds + threadIdx.x % ds]) +
                  __bfloat162float(C[row * ds + threadIdx.x % ds]);
  out[((size_t)blockIdx.y * gridDim.x + blockIdx.x) * blockDim.x + threadIdx.x] = v;
}

__device__ __forceinline__ float ex2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

template <int kMode>
__device__ __forceinline__ float expo(float x) {
  if (kMode == 0) return expf(x);
  if (kMode == 1) return exp2f(x);
  return ex2_approx(x);
}

template <int kMode>
__global__ void exps_kernel(float* __restrict__ out, int n_per_thread) {
  const int gid = blockIdx.x * blockDim.x + threadIdx.x;
  const float a0 = -1.f - 0.37f * (threadIdx.x & 7), a1 = a0 - 1.f, a2 = a0 - 2.f,
              a3 = a0 - 3.f;
  float dt = 0.01f + 1e-3f * (blockIdx.x & 15);
  float s0 = 0.f, s1 = 0.f, s2 = 0.f, s3 = 0.f;
#pragma unroll 4
  for (int i = 0; i < n_per_thread; ++i) {
    s0 = __fadd_rn(s0, expo<kMode>(__fmul_rn(dt, a0)));
    s1 = __fadd_rn(s1, expo<kMode>(__fmul_rn(dt, a1)));
    s2 = __fadd_rn(s2, expo<kMode>(__fmul_rn(dt, a2)));
    s3 = __fadd_rn(s3, expo<kMode>(__fmul_rn(dt, a3)));
    dt = __fadd_rn(dt, 1e-4f);
  }
  out[gid] = (s0 + s1) + (s2 + s3);
}

}  // namespace

extern "C" int floor_empty(int grid_x, int grid_y, int threads, void* stream) {
  empty_kernel<<<dim3(grid_x, grid_y), threads, 0, static_cast<cudaStream_t>(stream)>>>();
  return cudaGetLastError();
}

extern "C" int floor_one_round(const void* u, const void* dt, const void* B, const void* C,
                               void* out, int b, int S, int di, int ds, void* stream) {
  const dim3 grid((di + 31) / 32, b);
  one_round_kernel<<<grid, 128, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(u), static_cast<const __nv_bfloat16*>(dt),
      static_cast<const __nv_bfloat16*>(B), static_cast<const __nv_bfloat16*>(C),
      static_cast<float*>(out), S, di, ds);
  return cudaGetLastError();
}

extern "C" int floor_exps(void* out, int blocks, int threads, int n_per_thread, int mode,
                          void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* o = static_cast<float*>(out);
  if (mode == 0) exps_kernel<0><<<blocks, threads, 0, st>>>(o, n_per_thread);
  else if (mode == 1) exps_kernel<1><<<blocks, threads, 0, st>>>(o, n_per_thread);
  else exps_kernel<2><<<blocks, threads, 0, st>>>(o, n_per_thread);
  return cudaGetLastError();
}
