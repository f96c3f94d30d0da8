// Device helpers shared by the chunkwise mLSTM's forward
// (csrc/mlstm_chunk.cu) and backward (csrc/mlstm_chunk_bwd.cu): the chunk's
// gate statistics, rebuilt by every block that needs them, so both passes
// start from the same fp32 prefix sums; and the 3xTF32 product on the
// tensor cores that both run their dense products with.
#pragma once

#include <cstdint>

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

// x = big + small, both tf32 (10 explicit significand bits each): 22 of
// x's 24 bits; the three products big.big + big.small + small.big then
// carry every product to ~2^-21, summed in fp32 (3xTF32)
__device__ __forceinline__ void split_tf32(float x, uint32_t& big, uint32_t& small) {
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(big) : "f"(x));
  const float r = x - __uint_as_float(big);
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(small) : "f"(r));
}

// c (16 x 8 fp32) += a (16 x 8 tf32, row) . b (8 x 8 tf32, col); lane 4 g + t
// holds a = {A[g][t], A[g+8][t], A[g][t+4], A[g+8][t+4]}, b = {B[t][g],
// B[t+4][g]}, c = {C[g][2t], C[g][2t+1], C[g+8][2t], C[g+8][2t+1]}
__device__ __forceinline__ void mma_tf32(float* c, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// split_tf32's parts without the conversion instruction: cvt.rna rounds
// half away from zero, as adding half a tf32 ulp to the magnitude's bits
// and clearing the 13 bits below does (finite x); two integer and one fp32
// operation a part, at the full rate of those pipes
__device__ __forceinline__ void split_tf32_int(float x, uint32_t& big, uint32_t& small) {
  big = (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
  small = (__float_as_uint(x - __uint_as_float(big)) + 0x1000u) & 0xFFFFE000u;
}

// Warpgroup product on the tensor cores in tf32: d (64 x 128 fp32, 64
// registers a thread: warp w of the warpgroup holds rows 16 w .. + 16, n8
// tile j in d[4 j .. 4 j + 3] in the m16n8 C layout) = (accumulate ? d : 0)
// + a (64 x 8: warp w's rows in registers, in the mma.m16n8k8 A layout) . b
// (8 x 128, K-major in shared memory, described by desc: csrc/mma.cuh
// wgmma_desc). Issue only: the caller fences, commits and waits.
__device__ __forceinline__ void wgmma_tf32_n128(float* d, const uint32_t* a, uint64_t desc,
                                                int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
      "%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,"
      "%16,%17,%18,%19,%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31,"
      "%32,%33,%34,%35,%36,%37,%38,%39,%40,%41,%42,%43,%44,%45,%46,%47,"
      "%48,%49,%50,%51,%52,%53,%54,%55,%56,%57,%58,%59,%60,%61,%62,%63"
      "}, {%64,%65,%66,%67}, %68, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),
        "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),
        "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(accumulate));
}

}  // namespace mlstm
}  // namespace sct
