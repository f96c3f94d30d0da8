// Tensor-core rates of one GPU, built and timed by tools/tc_probe.py
// --mlstm-bwd (nvcc into src/repro_torch/_build/probe/): what the mLSTM
// backward's products can reach on each path to the tensor cores.
//
// - floor_mma_tf32: mma.sync m16n8k8 in tf32 (the legacy warp-level path),
//   16 independent accumulator tiles a warp, iters x 16 products a warp;
// - floor_wgmma_tf32: wgmma m64n128k8 in tf32, A from registers and B from
//   shared memory, iters x 4 products a warpgroup between waits;
// - floor_mma_f64: mma.sync m8n8k4 in fp64, 8 independent tiles a warp,
//   iters x 8 products a warp; and mma.sync m16n8k8 / m16n8k16 in fp64
//   (sm_90's shapes), 8 tiles a warp.
//
// Each runs blocks x 256 threads; the operands are constants. Timings only:
// the values written are meaningless.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

__global__ void __launch_bounds__(256) mma_tf32_kernel(float* out, int iters) {
  uint32_t a[4], b0 = 0x3f800000u, b1 = 0x3f000000u;
#pragma unroll
  for (int i = 0; i < 4; ++i) a[i] = 0x3f800000u + threadIdx.x;
  float c[16][4] = {};
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int t = 0; t < 16; ++t)
      asm volatile(
          "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
          "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
          : "+f"(c[t][0]), "+f"(c[t][1]), "+f"(c[t][2]), "+f"(c[t][3])
          : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
  float s = 0.f;
#pragma unroll
  for (int t = 0; t < 16; ++t) s += c[t][0] + c[t][1] + c[t][2] + c[t][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

__global__ void __launch_bounds__(256) mma_f64_kernel(float* out, int iters) {
  const double a = 1.0 + threadIdx.x, b = 0.5;
  double c[8][2] = {};
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int t = 0; t < 8; ++t)
      asm volatile("mma.sync.aligned.m8n8k4.row.col.f64.f64.f64.f64 {%0,%1}, {%2}, {%3}, {%0,%1};\n"
                   : "+d"(c[t][0]), "+d"(c[t][1])
                   : "d"(a), "d"(b));
  }
  double s = 0.0;
#pragma unroll
  for (int t = 0; t < 8; ++t) s += c[t][0] + c[t][1];
  out[blockIdx.x * blockDim.x + threadIdx.x] = static_cast<float>(s);
}

template <int kK>
__global__ void __launch_bounds__(256) mma_f64_16_kernel(float* out, int iters) {
  double a[kK / 2], b[kK / 4];
#pragma unroll
  for (int i = 0; i < kK / 2; ++i) a[i] = 1.0 + threadIdx.x + i;
#pragma unroll
  for (int i = 0; i < kK / 4; ++i) b[i] = 0.5 + i;
  double c[8][4] = {};
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int t = 0; t < 8; ++t) {
      if constexpr (kK == 8)
        asm volatile(
            "mma.sync.aligned.m16n8k8.row.col.f64.f64.f64.f64 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
            "{%8,%9}, {%0,%1,%2,%3};\n"
            : "+d"(c[t][0]), "+d"(c[t][1]), "+d"(c[t][2]), "+d"(c[t][3])
            : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(b[0]), "d"(b[1]));
      else
        asm volatile(
            "mma.sync.aligned.m16n8k16.row.col.f64.f64.f64.f64 {%0,%1,%2,%3}, "
            "{%4,%5,%6,%7,%8,%9,%10,%11}, {%12,%13,%14,%15}, {%0,%1,%2,%3};\n"
            : "+d"(c[t][0]), "+d"(c[t][1]), "+d"(c[t][2]), "+d"(c[t][3])
            : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(a[4]), "d"(a[5]), "d"(a[6]),
              "d"(a[7]), "d"(b[0]), "d"(b[1]), "d"(b[2]), "d"(b[3]));
    }
  }
  double s = 0.0;
#pragma unroll
  for (int t = 0; t < 8; ++t) s += c[t][0] + c[t][1] + c[t][2] + c[t][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = static_cast<float>(s);
}

__device__ __forceinline__ uint64_t desc_of(const void* smem, int lbo, int sbo) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  return static_cast<uint64_t>((a & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo & 0x3FFFF) >> 4) << 16) |
         (static_cast<uint64_t>((sbo & 0x3FFFF) >> 4) << 32);
}

__global__ void __launch_bounds__(256) wgmma_tf32_kernel(float* out, int iters) {
  __shared__ __align__(128) float bs[128 * 8];
  for (int i = threadIdx.x; i < 128 * 8; i += blockDim.x) bs[i] = 1.f;
  __syncthreads();
  uint32_t a[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) a[i] = 0x3f800000u + threadIdx.x;
  // B: 128 (n) x 8 (k) tf32, K-major core matrices of 8 rows x 16 bytes,
  // 128 bytes apart along N, 2048 along K
  const uint64_t desc = desc_of(bs, 2048, 128);
  float d[64] = {};
  for (int it = 0; it < iters; ++it) {
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int t = 0; t < 4; ++t)
      asm volatile(
          "{\n.reg .pred p;\nsetp.ne.b32 p, 1, 0;\n"
          "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
          "%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,"
          "%16,%17,%18,%19,%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31,"
          "%32,%33,%34,%35,%36,%37,%38,%39,%40,%41,%42,%43,%44,%45,%46,%47,"
          "%48,%49,%50,%51,%52,%53,%54,%55,%56,%57,%58,%59,%60,%61,%62,%63"
          "}, {%64,%65,%66,%67}, %68, p, 1, 1;\n}\n"
          : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
            "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
            "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
            "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
            "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
            "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
            "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
            "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
            "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
            "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
            "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
          : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc));
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
  }
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < 64; ++i) s += d[i];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

}  // namespace

// kind 0: mma.sync tf32, 1: wgmma tf32, 2: mma.sync fp64 m8n8k4, 3: m16n8k8,
// 4: m16n8k16; out: blocks x 256 floats
extern "C" int floor_mma(float* out, int kind, int blocks, int iters, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (kind == 0) mma_tf32_kernel<<<blocks, 256, 0, st>>>(out, iters);
  else if (kind == 1) wgmma_tf32_kernel<<<blocks, 256, 0, st>>>(out, iters);
  else if (kind == 2) mma_f64_kernel<<<blocks, 256, 0, st>>>(out, iters);
  else if (kind == 3) mma_f64_16_kernel<8><<<blocks, 256, 0, st>>>(out, iters);
  else mma_f64_16_kernel<16><<<blocks, 256, 0, st>>>(out, iters);
  return static_cast<int>(cudaGetLastError());
}
