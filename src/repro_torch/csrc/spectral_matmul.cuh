// Fused spectral matmul on the CUDA cores, fp32 activations, shared by two
// factor storages: y = ((x @ widen(U)) * g) @ widen(V)^T.
//
//   * spectral_matmul.cu    — fp32 U and V, g = s;
//   * spectral_matmul_q8.cu — U, V int8 codes, g = u_scale * s * v_scale.
//
// bf16 activations run on the tensor cores instead, both storages
// (spectral_matmul_tc.cu): a TF32 product would miss the fp32 rung.
//
// x (M, m) and y (M, n) in the activation dtype T (fp32), U (m, k) and V
// (n, k) in the factor storage TF (fp32, or int8), g (k,) fp32. Numerics follow
// kernels/ref.py: h = x @ widen(U) accumulated in fp32, scaled by g in
// fp32, rounded once to T; y = h_g @ widen(V)^T accumulated in fp32 and
// rounded at the output. Widening is exact (int8 codes |q| <= 127 are exact
// in bf16 and in fp32), so the int8 kernel is the plain spectral matmul's
// function on factors that happen to be integers.
//
// What bounds it: at decode M is the number of serving slots (<= 8), so the
// work is two skinny products whose bytes are the factors (sizeof(TF) * k *
// (m + n) bytes: ~5 MB at llama3.2-1b's MLP shapes in fp32, a quarter of
// that in int8): memory-bound.
//
// Design. The rank-k activation h never reaches device memory. The TPU
// kernels carry h across a sequential grid axis; Hopper blocks run in
// parallel with nothing carried between them, so the m-reduction is split
// across a thread-block cluster instead:
//   * grid (row blocks of BM rows) x (column blocks), clustered CL column
//     blocks at a time. Block rank c of a cluster reduces its slice of m:
//     partial h_c = x[:, slice_c] @ U[slice_c, :] in fp32 shared memory.
//     U streams through a 4-stage cp.async ring of ~16 KB chunks, raw (int8
//     stays int8 in shared memory; each element is widened in a register as
//     it is read); one thread per rank column, each chunk's rows split over
//     thread groups; x is staged per slice;
//   * after a cluster barrier every block sums the CL partials through
//     distributed shared memory, in rank order, scales by g and rounds to T;
//   * each block then emits its own bn output columns, staging V in
//     64-column tiles (fp32 factors as they are;
//     int8 factors staged raw, with a 4-byte row pad against bank conflicts,
//     and widened four codes at a time in registers): one thread per
//     (column, row group), a k-long dot from shared memory, coalesced stores.
// U is read once per cluster, spread over CL SMs, and enough blocks exist to
// fill the card even when M is 1. Every sum runs in a fixed order that
// depends on (m, k, CL) only, never on M or on the other rows (batch
// invariance: the engine's batched decode and the batch-1 reference agree
// bit for bit). Ragged M, m and n are masked in the kernel; k <= 256 and a
// multiple of 16 / sizeof(TF), U and V 16-byte aligned.
#pragma once

#include <cooperative_groups.h>

#include <cstdint>
#include <type_traits>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;
constexpr int kStages = 4;       // U chunks in flight
constexpr int kStageBytes = 16384;
constexpr int kXFloats = 8192;   // staged x: BM rows x (8192 / BM) columns, fp32
constexpr int kTileCols = 64;    // V rows (output columns) staged per pass
constexpr int kMaxRank = 256;
constexpr int kQ8Pad = 4;        // bytes of pad per staged int8 V row

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void widen16(const float* src, float* dst) {
  const float4 v = *reinterpret_cast<const float4*>(src);
  dst[0] = v.x; dst[1] = v.y; dst[2] = v.z; dst[3] = v.w;
}

// Stage `rows` rows of k elements (row stride k) from src into dst as fp32
// with row stride dld, in 16-byte loads; rows past `valid` are zero.
template <typename T>
__device__ __forceinline__ void stage_rows(float* dst, int dld, const T* src, int rows,
                                           int valid, int k) {
  constexpr int kVec = 16 / sizeof(T);
  const int per_row = k / kVec;
  for (int v = threadIdx.x; v < rows * per_row; v += kThreads) {
    const int r = v / per_row, j0 = (v % per_row) * kVec;
    float tmp[kVec];
    if (r < valid) {
      widen16(src + (size_t)r * k + j0, tmp);
    } else {
#pragma unroll
      for (int e = 0; e < kVec; ++e) tmp[e] = 0.f;
    }
#pragma unroll
    for (int e = 0; e < kVec; ++e) dst[r * dld + j0 + e] = tmp[e];
  }
}

// Stage `rows` int8 rows of k codes (row stride k) from src into dst, raw,
// with row stride k + kQ8Pad bytes: 16-byte loads, 4-byte stores (the pad
// keeps the stride a whole number of words); rows past `valid` are zero.
__device__ __forceinline__ void stage_rows_q8(int8_t* dst, const int8_t* src, int rows,
                                              int valid, int k) {
  const int per_row = k / 16;
  const int dld = k + kQ8Pad;
  for (int v = threadIdx.x; v < rows * per_row; v += kThreads) {
    const int r = v / per_row, j0 = (v % per_row) * 16;
    uint4 raw = make_uint4(0u, 0u, 0u, 0u);
    if (r < valid) raw = *reinterpret_cast<const uint4*>(src + (size_t)r * k + j0);
    uint32_t* w = reinterpret_cast<uint32_t*>(dst + r * dld + j0);
    w[0] = raw.x; w[1] = raw.y; w[2] = raw.z; w[3] = raw.w;
  }
}

// Start copying U rows [r0, r0 + rows) (contiguous: row stride k) into a
// ring slot, as raw TF; commits one cp.async group, empty when rows <= 0.
template <typename TF>
__device__ __forceinline__ void issue_chunk(TF* slot, const TF* U, int r0, int rows, int k) {
  if (rows > 0) {
    const char* src = reinterpret_cast<const char*>(U + (size_t)r0 * k);
    char* dst = reinterpret_cast<char*>(slot);
    const int nvec = rows * k * (int)sizeof(TF) / 16;
    for (int v = threadIdx.x; v < nvec; v += kThreads) cp_async16(dst + v * 16, src + v * 16);
  }
  cp_async_commit();
}

template <typename T, typename TF, int BM>
__global__ void __launch_bounds__(kThreads)
spectral_matmul_kernel(const T* __restrict__ x, const TF* __restrict__ U,
                       const float* __restrict__ s, const TF* __restrict__ V,
                       T* __restrict__ y, int M, int m, int n, int k, int kp, int bn,
                       int mslice, int cr) {
  constexpr bool kQ8 = std::is_same<TF, int8_t>::value;
  cg::cluster_group cluster = cg::this_cluster();
  const int cl = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  constexpr int kXCols = kXFloats / BM;   // x columns staged per pass

  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* hpart = smem;                   // (BM, k) this block's partial h
  float* hs = hpart + BM * k;            // (BM, k) h * g rounded to T
  float* xs = hs + BM * k;               // (kXCols, BM) staged x, transposed
  float* stage = xs + kXFloats;          // U ring (kStages x cr rows, raw TF) / V tile
  TF* ring = reinterpret_cast<TF*>(stage);

  const int tid = threadIdx.x;
  const int row0 = blockIdx.x * BM;
  const int groups = kThreads / kp;
  const int j = tid % kp;  // rank column this thread accumulates
  const int g = tid / kp;  // its share of each chunk's rows

  // ---- phase 1: partial h over this block's slice of m ----
  float acc[BM];
#pragma unroll
  for (int r = 0; r < BM; ++r) acc[r] = 0.f;
  const int m_lo = min(m, rank * mslice);
  const int m_hi = min(m, m_lo + mslice);
  for (int x0 = m_lo; x0 < m_hi; x0 += kXCols) {
    const int xw = min(kXCols, m_hi - x0);
    const int nchunks = (xw + cr - 1) / cr;
    __syncthreads();  // previous pass done with xs and the ring
    for (int t = tid; t < BM * xw; t += kThreads) {
      const int r = t / xw, i = t % xw;
      const int row = row0 + r;
      xs[i * BM + r] = row < M ? sct::to_float(x[(size_t)row * m + x0 + i]) : 0.f;
    }
    for (int c = 0; c < kStages - 1; ++c)
      issue_chunk(ring + (c % kStages) * cr * k, U, x0 + c * cr, min(cr, xw - c * cr), k);
    for (int c = 0; c < nchunks; ++c) {
      TF* slot = ring + (c % kStages) * cr * k;
      const int cw = min(cr, xw - c * cr);
      const int ahead = c + kStages - 1;  // refills the slot consumed last pass
      issue_chunk(ring + (ahead % kStages) * cr * k, U, x0 + ahead * cr,
                  min(cr, xw - ahead * cr), k);
      cp_async_wait<kStages - 1>();       // chunk c has landed
      __syncthreads();
      if (j < k) {
        for (int i = g; i < cw; i += groups) {
          const float u = sct::to_float(slot[i * k + j]);
          const float4* xr = reinterpret_cast<const float4*>(xs + (c * cr + i) * BM);
#pragma unroll
          for (int q = 0; q < BM / 4; ++q) {
            const float4 xv = xr[q];
            acc[4 * q + 0] = fmaf(xv.x, u, acc[4 * q + 0]);
            acc[4 * q + 1] = fmaf(xv.y, u, acc[4 * q + 1]);
            acc[4 * q + 2] = fmaf(xv.z, u, acc[4 * q + 2]);
            acc[4 * q + 3] = fmaf(xv.w, u, acc[4 * q + 3]);
          }
        }
      }
      __syncthreads();  // slot free for the refill issued next pass
    }
    cp_async_wait<0>();                   // drain the empty tail groups
  }
  // fold the thread groups' sums in a fixed order (deterministic)
  for (int t = tid; t < BM * k; t += kThreads) hpart[t] = 0.f;
  for (int gg = 0; gg < groups; ++gg) {
    __syncthreads();
    if (g == gg && j < k) {
#pragma unroll
      for (int r = 0; r < BM; ++r) hpart[r * k + j] += acc[r];
    }
  }

  // ---- cluster reduction of the partials, through distributed smem ----
  cluster.sync();  // every partial written
  for (int t = tid; t < BM * k; t += kThreads) {
    float h = 0.f;
    for (int c = 0; c < cl; ++c) h += cluster.map_shared_rank(hpart, c)[t];
    hs[t] = sct::to_float(sct::from_float<T>(h * s[t % k]));
  }
  cluster.sync();  // every block done reading the others' partials

  // ---- phase 2: this block's output columns, 64 at a time ----
  constexpr int kRowGroups = kThreads / kTileCols;  // 8
  constexpr int kRowsPerThread = BM / kRowGroups;
  const int col_lo = blockIdx.y * bn;
  const int col_hi = min(n, col_lo + bn);
  const int tc = tid % kTileCols;   // column within the tile
  const int rg = tid / kTileCols;   // row group: rows rg, rg + 8, ...
  for (int t0 = col_lo; t0 < col_hi; t0 += kTileCols) {
    const int tw = min(kTileCols, col_hi - t0);
    __syncthreads();  // previous tile consumed
    float out[kRowsPerThread];
#pragma unroll
    for (int q = 0; q < kRowsPerThread; ++q) out[q] = 0.f;
    if constexpr (kQ8) {
      int8_t* vt = reinterpret_cast<int8_t*>(stage);
      stage_rows_q8(vt, V + (size_t)t0 * k, kTileCols, tw, k);
      __syncthreads();
      const int8_t* vrow = vt + tc * (k + kQ8Pad);
      for (int jj = 0; jj < k; jj += 4) {
        const char4 c4 = *reinterpret_cast<const char4*>(vrow + jj);
        const float v4[4] = {static_cast<float>(c4.x), static_cast<float>(c4.y),
                             static_cast<float>(c4.z), static_cast<float>(c4.w)};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
#pragma unroll
          for (int q = 0; q < kRowsPerThread; ++q)
            out[q] = fmaf(hs[(rg + kRowGroups * q) * k + jj + e], v4[e], out[q]);
        }
      }
    } else {
      stage_rows(stage, k + 1, V + (size_t)t0 * k, kTileCols, tw, k);
      __syncthreads();
      const float* vrow = stage + tc * (k + 1);
      for (int jj = 0; jj < k; ++jj) {
        const float v = vrow[jj];
#pragma unroll
        for (int q = 0; q < kRowsPerThread; ++q)
          out[q] = fmaf(hs[(rg + kRowGroups * q) * k + jj], v, out[q]);
      }
    }
    if (tc < tw) {
#pragma unroll
      for (int q = 0; q < kRowsPerThread; ++q) {
        const int row = row0 + rg + kRowGroups * q;
        if (row < M) y[(size_t)row * n + t0 + tc] = sct::from_float<T>(out[q]);
      }
    }
  }
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15u) == 0; }

// U and V are read in 16-byte vectors: a factor row must be a whole number
// of vectors (k a multiple of 16 / sizeof(TF)) and both factors 16-byte
// aligned. The wrappers check both before they launch.
template <typename T, typename TF, int BM>
cudaError_t launch(const void* x, const void* U, const void* s, const void* V, void* y,
                   int M, int m, int n, int k, int cl, int bn, cudaStream_t stream) {
  constexpr bool kQ8 = std::is_same<TF, int8_t>::value;
  int kp = 16;
  while (kp < k) kp <<= 1;
  const int row_bytes = k * (int)sizeof(TF);
  if (k > kMaxRank || bn <= 0 || cl < 1 || cl > 8 || row_bytes % 16 != 0 || !aligned16(U) ||
      !aligned16(V))
    return cudaErrorInvalidValue;
  int cr = 8;  // U rows per ring chunk: ~kStageBytes, a power of two (divides kXCols)
  while (cr < 128 && 2 * cr * row_bytes <= kStageBytes) cr <<= 1;
  const int per_block = (m + cl - 1) / cl;
  const int mslice = (per_block + cr - 1) / cr * cr;
  const size_t ring_bytes = (size_t)kStages * cr * row_bytes;
  const size_t tile_bytes = kQ8 ? (size_t)kTileCols * (k + kQ8Pad)
                                : sizeof(float) * kTileCols * (size_t)(k + 1);
  const size_t smem = sizeof(float) * ((size_t)2 * BM * k + kXFloats) +
                      (ring_bytes > tile_bytes ? ring_bytes : tile_bytes);
  auto kernel = spectral_matmul_kernel<T, TF, BM>;
  cudaError_t err = sct::allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;

  const int col_blocks = (n + bn - 1) / bn;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3((M + BM - 1) / BM, (col_blocks + cl - 1) / cl * cl, 1);
  config.blockDim = dim3(kThreads, 1, 1);
  config.dynamicSmemBytes = smem;
  config.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = cl;
  attr[0].val.clusterDim.z = 1;
  config.attrs = attr;
  config.numAttrs = 1;
  err = cudaLaunchKernelEx(&config, kernel, static_cast<const T*>(x),
                           static_cast<const TF*>(U), static_cast<const float*>(s),
                           static_cast<const TF*>(V), static_cast<T*>(y), M, m, n, k, kp, bn,
                           mslice, cr);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace
