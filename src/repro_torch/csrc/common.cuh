// Shared helpers for the port's hand-written Hopper kernels.
//
// Every kernel is exposed through a plain C function (no PyTorch headers)
// that launches on the caller's stream and returns the cudaError_t of the
// launch; the Python wrapper loads the library with ctypes and raises on a
// non-zero code. Kernels allocate nothing: outputs come from the wrapper.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace sct {

// dtype codes shared with kernels/build.py
enum DType : int { kFloat32 = 0, kBFloat16 = 1 };

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_float(int8_t v) { return static_cast<float>(v); }

template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) { return v; }
// round-to-nearest-even, the rounding torch's .to(torch.bfloat16) uses
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// Opt a kernel into more than the default 48 KB of dynamic shared memory.
template <typename Kernel>
inline cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

// Programmatic dependent launch (Hopper). A kernel started by
// launch_dependent() may begin while the kernel before it on the stream
// still runs, once every block of that kernel has called allow_dependents()
// or exited; it calls grid_dependency_wait() before it reads anything that
// kernel writes (the wait returns when the earlier grid has completed and
// its writes are visible). Every block of a dependent kernel waits before
// it exits, so that its own completion still implies the earlier grid's.
// Without the launch attribute both calls do nothing.
__device__ __forceinline__ void grid_dependency_wait() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}
__device__ __forceinline__ void allow_dependents() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}

template <typename... KArgs, typename... Args>
inline cudaError_t launch_dependent(void (*kernel)(KArgs...), dim3 grid, dim3 block, size_t smem,
                                    cudaStream_t stream, Args... args) {
  cudaLaunchConfig_t config = {};
  config.gridDim = grid;
  config.blockDim = block;
  config.dynamicSmemBytes = smem;
  config.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  config.attrs = attr;
  config.numAttrs = 1;
  return cudaLaunchKernelEx(&config, kernel, static_cast<KArgs>(args)...);
}

}  // namespace sct
