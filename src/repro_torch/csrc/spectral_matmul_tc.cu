// Fused spectral matmul on the tensor cores, bf16 activations, over bf16
// factors or int8 codes: y = ((x @ U) * g) @ V^T.
//
// Replaces the TPU kernels kernels/spectral_matmul.py:spectral_matmul_pallas
// (bf16 factors, g = s; wrapper kernels/ops.py:spectral_matmul) and
// kernels/spectral_matmul_q8.py:spectral_matmul_q8_pallas (int8 codes,
// g = u_scale * s * v_scale; wrapper kernels/ops.py:spectral_matmul_q8) of
// the JAX package for bf16 activations; fp32 keeps the CUDA-core templates
// of spectral_matmul.cuh (a TF32 product would miss the fp32 rung).
//
// x (M, m), y (M, n) bf16; U (m, k), V (n, k) bf16 or int8; g (k,) fp32.
// Numerics follow kernels/ref.py: h = x @ U accumulated in fp32, scaled by
// g in fp32, rounded once to bf16; y = h_g @ V^T accumulated in fp32,
// rounded at the output. h never reaches device memory. int8 codes
// (|q| <= 127) are exact in bf16, so both storages run the same products.
//
// What bounds it: bytes. At the training shape (M 8192, 2048 -> 8192,
// rank 128, bf16) the job is 21.5 GFLOP (22 us at 989 TFLOP/s) against
// 170 MB (51 us at 3.35 TB/s), 79% of it y. At decode (M <= 8 serving
// slots) the bytes are the factors: ~2.6 MB a layer's MLP in bf16, under a
// microsecond; int8 codes halve them.
//
// What the design does about it:
//   * both products run on mma.sync m16n8k16 (bf16 in, fp32 accumulators in
//     registers) over raw tiles that a 3-stage cp.async ring brings in (x
//     and U in phase 1, V in phase 2), each step's fragments fetched while
//     the previous step's products issue. bf16 fragments come through
//     ldmatrix. int8 codes stay int8 in device and shared memory (half the
//     bytes copied); ldmatrix .trans has no 8-bit form, so each thread
//     gathers its fragments' codes from shared memory (phase 1: bytes of
//     four U rows; phase 2: 16-bit pairs adjacent along k) and widens them
//     exactly in registers with integer and fp32 operations, no conversion
//     instruction. Widening each staged U chunk in shared memory once, for
//     ldmatrix, measured slower at decode (one more barrier a stage);
//   * phase 2 keeps the warp's rows of h in registers as A fragments and
//     streams only V; y leaves through a double-buffered shared-memory tile
//     in 16-byte, coalesced stores that overlap the next tile's products;
//   * row tiles of 16 rows at decode, where the grid is split over output
//     columns so that about one block runs on every SM, and 64 above.
// The m-reduction is cut into CL slices (CL depends on m alone). At decode
// and mid-size M the slices run on the CL blocks of a thread-block cluster:
// block rank c reduces slice c into an fp32 partial h; block c then sums its
// 1/CL of the rows of every partial through distributed shared memory in
// rank order, scales and rounds them, and every block gathers the others'
// rounded rows. Once the 64-row tiles alone fill half the SMs (M 8192 in
// training), one block runs all CL slices itself, in the same order, and no
// cluster reduction is needed. Each block then emits its bn output columns.
//
// What still holds it (H100 80GB HBM3 at 700 W, PERF.md). bf16, the
// training shape: 0.15 ms, 3x its bound, 1.75x the three-GEMM chain; every
// 64-row tile reads all of U and V from L2 (128 tiles x 2.5 MB), and a
// block's loop is one stage deep in latency; sharing U and V loads across
// a cluster (TMA multicast) would cut the first. At decode both storages
// take ~15-20 us a launch for a microsecond of bytes: the chain of
// dependent steps (launch, stage copies, cluster barriers, the V tile's
// copy after the reduction), not the bytes, sets the time, so int8 gains
// little from halving them; its gathers cost ~3 us on a decode down
// projection (m 8192: 16 stages a block) and more in 64-row chunks, where
// two warps gather each code.
//
// Batch invariance: a row's sums run in an order fixed by (m, k, CL) and
// the instruction's k-step: each slice is walked in 16-wide steps from
// zero, the slices are summed in rank order from zero (on a cluster or in
// one block: the same operations), phase 2 walks the padded rank in 16-wide
// steps from zero. The row-tile height, M, the other rows and the choice of
// cluster or one block change none of it, and every M runs the same
// instruction, so a row of a batched call equals the row alone, bit for
// bit. Ragged M, m and n are masked; k is a multiple of 8 (bf16) or 16
// (int8) up to 256, padded with zero columns to 64, 128 or 256 inside the
// kernel; U and V 16-byte aligned.
#include <cooperative_groups.h>

#include <cstdint>
#include <type_traits>

#include "common.cuh"
#include "mma.cuh"

namespace cg = cooperative_groups;
using namespace sct::mma;

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMC = 64;      // m columns of x (rows of U) per phase-1 stage
constexpr int kBN = 64;      // output columns per phase-2 tile
constexpr int kPad = 8;      // bf16 pad per shared row: ldmatrix without bank conflicts
constexpr size_t kBudget = 200 * 1024;  // shared memory a block may take for its rings

constexpr size_t cmax(size_t a, size_t b) { return a > b ? a : b; }
constexpr size_t cmin(size_t a, size_t b) { return a < b ? a : b; }

// Tiling for a row tile of BM rows and a rank padded to KP, over factors
// stored as TF (bf16, or int8 codes). kSplit: the CL slices of m run on the
// CL blocks of a cluster (false: one block runs them all, in the same order,
// and needs no cluster).
template <int BM, int KP, bool kSplit, typename TF>
struct Tc {
  static constexpr bool kQ8 = std::is_same<TF, int8_t>::value;
  static constexpr int kWM = BM >= 64 ? 2 : 1;        // warps along rows
  static constexpr int kWN = kWarps / kWM;            // warps along columns
  static constexpr int kWRows = BM / kWM;             // rows a warp owns
  static constexpr int kMT = kWRows / 16;             // its m16 tiles
  static constexpr int kNT1 = KP / kWN / 8;           // its n8 tiles of h
  static constexpr int kNT2 = kBN / kWN / 8;          // its n8 tiles of a y tile
  static constexpr int kKS = KP / 16;                 // k16 steps over the rank
  static constexpr int kLdX = kMC + kPad, kLdK = KP + kPad, kLdY = kBN + kPad;
  // staged factor rows (U in phase 1, V in phase 2), in TF elements: bf16
  // padded for ldmatrix, int8 codes by 16 bytes, which spreads a fragment
  // gather's rows over distinct banks
  static constexpr int kLdF = kQ8 ? KP + 16 : kLdK;
  static constexpr int kVecF = 16 / static_cast<int>(sizeof(TF));   // factor elements a copy
  static constexpr size_t kHs = sizeof(bf16) * BM * kLdK;
  static constexpr size_t kXStage = sizeof(bf16) * BM * kLdX;
  static constexpr size_t kStage1 = kXStage + sizeof(TF) * kMC * kLdF;
  static constexpr size_t kStage2 = sizeof(TF) * kBN * kLdF;
  static constexpr size_t kYs = sizeof(bf16) * BM * kLdY;
  // ring depths: at large M (one block runs every slice) a block's copy
  // loop is bound by the bytes it has in flight, so as many stages as the
  // budget holds, up to 6; on a cluster (decode, mid-size M) 3 measure best
  static constexpr size_t kMaxStages = kSplit ? 3 : 6;
  static constexpr int kS1 = cmax(3, cmin(kMaxStages, (kBudget - kHs) / kStage1));
  static constexpr int kS2 = cmax(3, cmin(kMaxStages, (kBudget - kHs - 2 * kYs) / kStage2));
  static constexpr size_t kRegion =
      cmax(cmax(kS1 * kStage1, kSplit ? sizeof(float) * BM * KP : 0), kS2 * kStage2 + 2 * kYs);
  static constexpr size_t kBytes = kHs + kRegion;
  // on a cluster, two blocks an SM where shared memory allows (and the
  // 128 registers a thread that implies): measured faster at decode and
  // in prefill chunks
  static constexpr int kMinBlocks = (kSplit && KP <= 128 && kBytes <= 113 * 1024) ? 2 : 1;
  static_assert(kMT >= 1 && kNT1 >= 1 && kNT2 >= 1, "tile shape");
  static_assert(kBytes <= 232448, "shared memory");
};

// Phase-1 stage: x[row0 .. row0+BM, mm .. mm+kMC) and U[mm .. mm+kMC, 0 .. KP),
// zero outside [0, M) x [.., m_hi) and past rank k.
template <class C, typename TF>
__device__ __forceinline__ void load_stage1(unsigned char* stage, const bf16* x, const TF* U,
                                            int row0, int M, int m, int mm, int m_hi, int k,
                                            bool xvec) {
  constexpr int BM = C::kWRows * C::kWM, KP = C::kLdK - kPad;
  bf16* xs = reinterpret_cast<bf16*>(stage);
  TF* us = reinterpret_cast<TF*>(stage + C::kXStage);
  if (xvec) {
    for (int v = threadIdx.x; v < BM * (kMC / 8); v += kThreads) {
      const int r = v / (kMC / 8), c = (v % (kMC / 8)) * 8;
      const bool ok = row0 + r < M && mm + c < m_hi;
      cp_async16(xs + r * C::kLdX + c, ok ? x + (size_t)(row0 + r) * m + mm + c : x, ok);
    }
  } else {  // rows not 16-byte aligned (m % 8 != 0): element by element
    for (int v = threadIdx.x; v < BM * kMC; v += kThreads) {
      const int r = v / kMC, c = v % kMC;
      const bool ok = row0 + r < M && mm + c < m_hi;
      xs[r * C::kLdX + c] =
          ok ? x[(size_t)(row0 + r) * m + mm + c] : __float2bfloat16_rn(0.f);
    }
  }
  constexpr int kPerRow = KP / C::kVecF;
  for (int v = threadIdx.x; v < kMC * kPerRow; v += kThreads) {
    const int r = v / kPerRow, c = (v % kPerRow) * C::kVecF;
    const bool ok = mm + r < m_hi && c < k;
    cp_async16(us + r * C::kLdF + c, ok ? U + (size_t)(mm + r) * k + c : U, ok);
  }
}

// Phase-2 stage: V rows [c0, c0 + kBN) (output columns), zero past c_hi or k.
template <class C, typename TF>
__device__ __forceinline__ void load_stage2(unsigned char* stage, const TF* V, int c0,
                                            int c_hi, int k) {
  constexpr int KP = C::kLdK - kPad, kPerRow = KP / C::kVecF;
  TF* vs = reinterpret_cast<TF*>(stage);
  for (int v = threadIdx.x; v < kBN * kPerRow; v += kThreads) {
    const int r = v / kPerRow, c = (v % kPerRow) * C::kVecF;
    const bool ok = c0 + r < c_hi && c < k;
    cp_async16(vs + r * C::kLdF + c, ok ? V + (size_t)(c0 + r) * k + c : V, ok);
  }
}

// int8 codes widened to bf16 exactly, on the integer and fp32 pipes (no
// conversion instruction): a code c (its byte zero-extended) becomes the
// float 2^23 + 128 + c, less 2^23 + 128; |c| <= 128 needs 8 significant
// bits, so the float's top half is c in bf16.
__device__ __forceinline__ float code_to_float(uint32_t byte) {
  return __uint_as_float((byte ^ 0x80u) | 0x4B000000u) - 8388736.f;
}
// two such floats' bf16 halves, lo in the low half
__device__ __forceinline__ uint32_t pack_top(float lo, float hi) {
  return __byte_perm(__float_as_uint(lo), __float_as_uint(hi), 0x7632);
}
// the two codes of a 16-bit word (lo byte first) as a bf16 pair
__device__ __forceinline__ uint32_t widen_pair(uint32_t two) {
  return pack_top(code_to_float(two & 0xFFu), code_to_float(two >> 8));
}

// Store rows [row0, M) x columns [c0, c_hi) of a finished y tile (BM x kBN
// in shared memory) to y: 16-byte stores where rows are 16-byte aligned.
template <class C>
__device__ __forceinline__ void store_tile(bf16* y, const bf16* ys, int row0, int M, int n,
                                           int c0, int c_hi, bool yvec) {
  constexpr int BM = C::kWRows * C::kWM;
  for (int v = threadIdx.x; v < BM * (kBN / 8); v += kThreads) {
    const int r = v / (kBN / 8), c = (v % (kBN / 8)) * 8;
    const int row = row0 + r, col = c0 + c;
    if (row >= M || col >= c_hi) continue;
    const bf16* src = ys + r * C::kLdY + c;
    bf16* dst = y + (size_t)row * n + col;
    if (yvec) {
      *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
    } else {
      for (int e = 0; e < 8 && col + e < c_hi; ++e) dst[e] = src[e];
    }
  }
}

// 16-byte load from the shared memory of cluster block `rank` (mapa + ld).
__device__ __forceinline__ float4 ld_cluster(const float* local, int rank) {
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(remote)
               : "r"(smem_addr(local)), "r"(rank));
  float4 v;
  asm volatile("ld.shared::cluster.v4.f32 {%0,%1,%2,%3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(remote)
               : "memory");
  return v;
}
__device__ __forceinline__ uint4 ld_cluster(const bf16* local, int rank) {
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(remote)
               : "r"(smem_addr(local)), "r"(rank));
  uint4 v;
  asm volatile("ld.shared::cluster.v4.u32 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "r"(remote)
               : "memory");
  return v;
}

// s is the fp32 scale s (bf16 factors) or the gain u_scale * s * v_scale
// (int8 codes).
template <int BM, int KP, bool kSplit, typename TF>
__global__ void __launch_bounds__(kThreads, (Tc<BM, KP, kSplit, TF>::kMinBlocks))
spectral_tc_kernel(const bf16* __restrict__ x, const TF* __restrict__ U,
                   const float* __restrict__ s, const TF* __restrict__ V,
                   bf16* __restrict__ y, int M, int m, int n, int k, int cl, int bn,
                   int mslice, int xvec, int yvec) {
  using C = Tc<BM, KP, kSplit, TF>;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* hs = reinterpret_cast<bf16*>(smem);          // (BM, kLdK) rounded h * s
  unsigned char* region = smem + C::kHs;             // phase-1 ring | hpart | phase-2 ring

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, t = lane & 3;
  const int wr0 = (warp / C::kWN) * C::kWRows;       // warp's first row in the tile
  const int wn = warp % C::kWN;
  const int row0 = blockIdx.x * BM;
  // this block's slices of m: its cluster rank's, or all CL in rank order
  const int rank = kSplit ? static_cast<int>(cg::this_cluster().block_rank()) : 0;
  const int c_lo = kSplit ? rank : 0, c_hi = kSplit ? rank + 1 : cl;

  // ---- phase 1: h = 0 + p_0 + p_1 + ..., p_c the product over slice c ----
  float h[C::kMT][C::kNT1][4];
#pragma unroll
  for (int i = 0; i < C::kMT; ++i)
#pragma unroll
    for (int j = 0; j < C::kNT1; ++j) h[i][j][0] = h[i][j][1] = h[i][j][2] = h[i][j][3] = 0.f;
  const int wc1 = wn * (KP / C::kWN);
  for (int sl = c_lo; sl < c_hi; ++sl) {
    float acc[C::kMT][C::kNT1][4];
#pragma unroll
    for (int i = 0; i < C::kMT; ++i)
#pragma unroll
      for (int j = 0; j < C::kNT1; ++j)
        acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0.f;
    const int m_lo = min(m, sl * mslice);
    const int m_hi = min(m, m_lo + mslice);
    const int nch = (m_hi - m_lo + kMC - 1) / kMC;
#pragma unroll
    for (int c = 0; c < C::kS1 - 1; ++c) {
      if (c < nch)
        load_stage1<C>(region + c * C::kStage1, x, U, row0, M, m, m_lo + c * kMC, m_hi, k,
                       xvec);
      cp_async_commit();
    }
    for (int c = 0; c < nch; ++c) {
      cp_async_wait<C::kS1 - 2>();   // stage c has landed
      __syncthreads();               // and every warp is done with stage c - 1
      const int ahead = c + C::kS1 - 1;
      if (ahead < nch)
        load_stage1<C>(region + (ahead % C::kS1) * C::kStage1, x, U, row0, M, m,
                       m_lo + ahead * kMC, m_hi, k, xvec);
      cp_async_commit();
      const unsigned char* st = region + (c % C::kS1) * C::kStage1;
      const bf16* xs = reinterpret_cast<const bf16*>(st);
      const TF* us = reinterpret_cast<const TF*>(st + C::kXStage);
      // fragments of k16 step kk: A (x rows) and B (U columns: bf16 through
      // ldmatrix .trans, which has no 8-bit form; int8 gathered code by code
      // and widened in registers); the next step's are fetched before this
      // step's products issue
      uint32_t a[2][C::kMT][4], b[2][C::kNT1][2];
      auto fetch = [&](int buf, int kk) {
#pragma unroll
        for (int i = 0; i < C::kMT; ++i)
          ldsm_x4(a[buf][i], xs + (wr0 + i * 16 + (lane & 15)) * C::kLdX + kk + (lane >> 4) * 8);
        if constexpr (C::kQ8) {
          // b0 = U[kk + 2t, +1][col g], b1 = U[kk + 2t + 8, +9][col g]
          const uint8_t* col = reinterpret_cast<const uint8_t*>(us) +
                               (kk + 2 * t) * C::kLdF + wc1 + g;
#pragma unroll
          for (int j = 0; j < C::kNT1; ++j) {
            const uint8_t* c0 = col + j * 8;
            b[buf][j][0] = pack_top(code_to_float(c0[0]), code_to_float(c0[C::kLdF]));
            b[buf][j][1] = pack_top(code_to_float(c0[8 * C::kLdF]),
                                    code_to_float(c0[9 * C::kLdF]));
          }
        } else {
          const TF* urow = us + (kk + (lane & 7) + ((lane >> 3) & 1) * 8) * C::kLdF + wc1;
          if constexpr (C::kNT1 % 2 == 0) {
#pragma unroll
            for (int j = 0; j < C::kNT1; j += 2) {
              uint32_t q[4];
              ldsm_x4_t(q, urow + j * 8 + (lane >> 4) * 8);
              b[buf][j][0] = q[0];
              b[buf][j][1] = q[1];
              b[buf][j + 1][0] = q[2];
              b[buf][j + 1][1] = q[3];
            }
          } else {
#pragma unroll
            for (int j = 0; j < C::kNT1; ++j) ldsm_x2_t(b[buf][j], urow + j * 8);
          }
        }
      };
      fetch(0, 0);
#pragma unroll
      for (int ks = 0; ks < kMC / 16; ++ks) {
        if (ks + 1 < kMC / 16) fetch((ks + 1) & 1, (ks + 1) * 16);
#pragma unroll
        for (int j = 0; j < C::kNT1; ++j)
#pragma unroll
          for (int i = 0; i < C::kMT; ++i)
            mma_bf16(acc[i][j], a[ks & 1][i], b[ks & 1][j][0], b[ks & 1][j][1]);
      }
    }
    cp_async_wait<0>();
    __syncthreads();   // the ring is free for the next slice (or hpart)
#pragma unroll
    for (int i = 0; i < C::kMT; ++i)
#pragma unroll
      for (int j = 0; j < C::kNT1; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) h[i][j][e] += acc[i][j][e];
  }

  if constexpr (kSplit) {
    // ---- cluster reduction: block `rank` sums its rows of every partial in
    // rank order, scales, rounds; then every block gathers the others' rows ----
    cg::cluster_group cluster = cg::this_cluster();
    float* hpart = reinterpret_cast<float*>(region);   // (BM, KP) this block's partial h
#pragma unroll
    for (int i = 0; i < C::kMT; ++i)
#pragma unroll
      for (int j = 0; j < C::kNT1; ++j) {
        const int r = wr0 + i * 16 + g, cc = wc1 + j * 8 + 2 * t;
        *reinterpret_cast<float2*>(hpart + r * KP + cc) = make_float2(h[i][j][0], h[i][j][1]);
        *reinterpret_cast<float2*>(hpart + (r + 8) * KP + cc) =
            make_float2(h[i][j][2], h[i][j][3]);
      }
    cluster.sync();
    const int own = BM / cl;   // rows of h this block reduces
    for (int v = tid; v < own * (KP / 4); v += kThreads) {
      const int r = rank * own + v / (KP / 4), c = (v % (KP / 4)) * 4;
      float4 p[8];
#pragma unroll
      for (int q = 0; q < 8; ++q)   // every load in flight before the sum
        if (q < cl) p[q] = ld_cluster(hpart + r * KP + c, q);
      float4 hv = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        if (q < cl) {
          hv.x += p[q].x;
          hv.y += p[q].y;
          hv.z += p[q].z;
          hv.w += p[q].w;
        }
      }
      const float s0 = c < k ? s[c] : 0.f, s1 = c + 1 < k ? s[c + 1] : 0.f;
      const float s2 = c + 2 < k ? s[c + 2] : 0.f, s3 = c + 3 < k ? s[c + 3] : 0.f;
      uint2 packed;
      packed.x = pack_bf16(hv.x * s0, hv.y * s1);
      packed.y = pack_bf16(hv.z * s2, hv.w * s3);
      *reinterpret_cast<uint2*>(hs + r * C::kLdK + c) = packed;
    }
    cluster.sync();   // every block's rows are rounded; no partial is read again
    {
      constexpr int kPer = 4;   // gathered vectors in flight a thread
      for (int v0 = tid; v0 < BM * (KP / 8); v0 += kThreads * kPer) {
        uint4 buf[kPer];
#pragma unroll
        for (int e = 0; e < kPer; ++e) {
          const int v = v0 + e * kThreads;
          const int r = v / (KP / 8), c = (v % (KP / 8)) * 8;
          if (v < BM * (KP / 8) && r / own != rank)
            buf[e] = ld_cluster(hs + r * C::kLdK + c, r / own);
        }
#pragma unroll
        for (int e = 0; e < kPer; ++e) {
          const int v = v0 + e * kThreads;
          const int r = v / (KP / 8), c = (v % (KP / 8)) * 8;
          if (v < BM * (KP / 8) && r / own != rank)
            *reinterpret_cast<uint4*>(hs + r * C::kLdK + c) = buf[e];
        }
      }
    }
    cluster_arrive();   // done reading the others' h; waited for before exit
  } else {
#pragma unroll
    for (int i = 0; i < C::kMT; ++i)
#pragma unroll
      for (int j = 0; j < C::kNT1; ++j) {
        const int r = wr0 + i * 16 + g, cc = wc1 + j * 8 + 2 * t;
        const float s0 = cc < k ? s[cc] : 0.f, s1 = cc + 1 < k ? s[cc + 1] : 0.f;
        *reinterpret_cast<uint32_t*>(hs + r * C::kLdK + cc) =
            pack_bf16(h[i][j][0] * s0, h[i][j][1] * s1);
        *reinterpret_cast<uint32_t*>(hs + (r + 8) * C::kLdK + cc) =
            pack_bf16(h[i][j][2] * s0, h[i][j][3] * s1);
      }
  }
  __syncthreads();

  // ---- phase 2: this block's output columns, kBN at a time; the warp's
  // rows of h stay in registers as A fragments ----
  uint32_t ha[C::kMT][C::kKS][4];
#pragma unroll
  for (int i = 0; i < C::kMT; ++i)
#pragma unroll
    for (int kk = 0; kk < C::kKS; ++kk)
      ldsm_x4(ha[i][kk], hs + (wr0 + i * 16 + (lane & 15)) * C::kLdK + kk * 16 + (lane >> 4) * 8);
  const int col_lo = min(n, static_cast<int>(blockIdx.y) * bn);
  const int col_hi = min(n, col_lo + bn);
  const int ntiles = (col_hi - col_lo + kBN - 1) / kBN;
  bf16* ys0 = reinterpret_cast<bf16*>(region + C::kS2 * C::kStage2);   // 2 x (BM, kLdY)
  const int wc2 = wn * (kBN / C::kWN);
#pragma unroll
  for (int c = 0; c < C::kS2 - 1; ++c) {
    if (c < ntiles) load_stage2<C>(region + c * C::kStage2, V, col_lo + c * kBN, col_hi, k);
    cp_async_commit();
  }
  for (int tt = 0; tt < ntiles; ++tt) {
    cp_async_wait<C::kS2 - 2>();
    __syncthreads();   // tile tt landed, tile tt - 1 is in its y buffer, tile tt - 2 stored
    const int ahead = tt + C::kS2 - 1;
    if (ahead < ntiles)
      load_stage2<C>(region + (ahead % C::kS2) * C::kStage2, V, col_lo + ahead * kBN, col_hi,
                     k);
    cp_async_commit();
    if (tt > 0)   // the previous tile leaves while this one is computed
      store_tile<C>(y, ys0 + ((tt - 1) & 1) * (C::kYs / sizeof(bf16)), row0, M, n,
                    col_lo + (tt - 1) * kBN, col_hi, yvec);
    const TF* vs = reinterpret_cast<const TF*>(region + (tt % C::kS2) * C::kStage2);
    float o[C::kMT][C::kNT2][4];
#pragma unroll
    for (int i = 0; i < C::kMT; ++i)
#pragma unroll
      for (int j = 0; j < C::kNT2; ++j) o[i][j][0] = o[i][j][1] = o[i][j][2] = o[i][j][3] = 0.f;
    uint32_t b[2][C::kNT2][2];
    auto fetch = [&](int buf, int kk) {
      if constexpr (C::kQ8) {
        // b0 = V[col g][kk + 2t, +1], b1 = V[col g][kk + 2t + 8, +9]: code
        // pairs adjacent along k, one 16-bit load each
        const uint8_t* row = reinterpret_cast<const uint8_t*>(vs) + (wc2 + g) * C::kLdF + kk +
                             2 * t;
#pragma unroll
        for (int j = 0; j < C::kNT2; ++j) {
          const uint8_t* r0 = row + j * 8 * C::kLdF;
          b[buf][j][0] = widen_pair(*reinterpret_cast<const uint16_t*>(r0));
          b[buf][j][1] = widen_pair(*reinterpret_cast<const uint16_t*>(r0 + 8));
        }
      } else if constexpr (C::kNT2 % 2 == 0) {
#pragma unroll
        for (int j = 0; j < C::kNT2; j += 2) {
          uint32_t q[4];
          ldsm_x4(q, vs + (wc2 + j * 8 + (lane >> 4) * 8 + (lane & 7)) * C::kLdF + kk +
                         ((lane >> 3) & 1) * 8);
          b[buf][j][0] = q[0];
          b[buf][j][1] = q[1];
          b[buf][j + 1][0] = q[2];
          b[buf][j + 1][1] = q[3];
        }
      } else {
#pragma unroll
        for (int j = 0; j < C::kNT2; ++j)
          ldsm_x2(b[buf][j],
                  vs + (wc2 + j * 8 + (lane & 7)) * C::kLdF + kk + ((lane >> 3) & 1) * 8);
      }
    };
    fetch(0, 0);
#pragma unroll
    for (int kk = 0; kk < C::kKS; ++kk) {
      if (kk + 1 < C::kKS) fetch((kk + 1) & 1, (kk + 1) * 16);
#pragma unroll
      for (int j = 0; j < C::kNT2; ++j)
#pragma unroll
        for (int i = 0; i < C::kMT; ++i)
          mma_bf16(o[i][j], ha[i][kk], b[kk & 1][j][0], b[kk & 1][j][1]);
    }
    bf16* ys = ys0 + (tt & 1) * (C::kYs / sizeof(bf16));
#pragma unroll
    for (int i = 0; i < C::kMT; ++i)
#pragma unroll
      for (int j = 0; j < C::kNT2; ++j) {
        const int r = wr0 + i * 16 + g, cc = wc2 + j * 8 + 2 * t;
        *reinterpret_cast<uint32_t*>(ys + r * C::kLdY + cc) = pack_bf16(o[i][j][0], o[i][j][1]);
        *reinterpret_cast<uint32_t*>(ys + (r + 8) * C::kLdY + cc) =
            pack_bf16(o[i][j][2], o[i][j][3]);
      }
  }
  cp_async_wait<0>();
  __syncthreads();
  if (ntiles > 0)
    store_tile<C>(y, ys0 + ((ntiles - 1) & 1) * (C::kYs / sizeof(bf16)), row0, M, n,
                  col_lo + (ntiles - 1) * kBN, col_hi, yvec);
  if constexpr (kSplit) cluster_wait();   // no block leaves while another may read its h
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15u) == 0; }

template <int BM, int KP, bool kSplit, typename TF>
cudaError_t launch(const void* x, const void* U, const void* s, const void* V, void* y, int M,
                   int m, int n, int k, int cl, int bn, cudaStream_t stream) {
  using C = Tc<BM, KP, kSplit, TF>;
  if (BM % cl != 0) return cudaErrorInvalidValue;   // each block reduces BM / cl rows of h
  const int per_block = (m + cl - 1) / cl;
  const int mslice = (per_block + kMC - 1) / kMC * kMC;
  auto kernel = spectral_tc_kernel<BM, KP, kSplit, TF>;
  cudaError_t err = sct::allow_smem(kernel, C::kBytes);
  if (err != cudaSuccess) return err;
  const int split = kSplit ? cl : 1;   // blocks a cluster
  const int col_blocks = (n + bn - 1) / bn;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3((M + BM - 1) / BM, (col_blocks + split - 1) / split * split, 1);
  config.blockDim = dim3(kThreads, 1, 1);
  config.dynamicSmemBytes = C::kBytes;
  config.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = split;
  attr[0].val.clusterDim.z = 1;
  config.attrs = attr;
  config.numAttrs = kSplit ? 1 : 0;
  const int xvec = (m % 8 == 0 && aligned16(x)) ? 1 : 0;
  const int yvec = (n % 8 == 0 && bn % 8 == 0 && aligned16(y)) ? 1 : 0;
  err = cudaLaunchKernelEx(&config, kernel, static_cast<const bf16*>(x),
                           static_cast<const TF*>(U), static_cast<const float*>(s),
                           static_cast<const TF*>(V), static_cast<bf16*>(y), M, m, n, k, cl,
                           bn, mslice, xvec, yvec);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <typename TF, int KP>
cudaError_t launch_rank(const void* x, const void* U, const void* s, const void* V, void* y,
                        int M, int m, int n, int k, int bm, int cl, int split, int bn,
                        cudaStream_t st) {
  if (bm == 16 && split) return launch<16, KP, true, TF>(x, U, s, V, y, M, m, n, k, cl, bn, st);
  if (bm == 64 && split) return launch<64, KP, true, TF>(x, U, s, V, y, M, m, n, k, cl, bn, st);
  if (bm == 64 && !split)
    return launch<64, KP, false, TF>(x, U, s, V, y, M, m, n, k, cl, bn, st);
  return cudaErrorInvalidValue;
}

// The rank padded to 64, 128 or 256 inside the kernel.
template <typename TF>
int launch_factors(const void* x, const void* U, const void* s, const void* V, void* y, int M,
                   int m, int n, int k, int bm, int cl, int split, int bn, void* stream) {
  if (M <= 0 || n <= 0) return cudaSuccess;
  constexpr int kVec = 16 / static_cast<int>(sizeof(TF));   // whole 16-byte factor rows
  if (m <= 0 || k <= 0 || k > 256 || k % kVec != 0 || bn <= 0 || !aligned16(U) ||
      !aligned16(V))
    return cudaErrorInvalidValue;
  if (cl != 1 && cl != 2 && cl != 4 && cl != 8) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (k <= 64) return launch_rank<TF, 64>(x, U, s, V, y, M, m, n, k, bm, cl, split, bn, st);
  if (k <= 128) return launch_rank<TF, 128>(x, U, s, V, y, M, m, n, k, bm, cl, split, bn, st);
  return launch_rank<TF, 256>(x, U, s, V, y, M, m, n, k, bm, cl, split, bn, st);
}

}  // namespace

// bm: row-tile height (16 or 64); cl: the number of m slices (1, 2, 4 or
// 8), which fixes the summation order; split: the slices run on the cl
// blocks of a cluster (1) or one block runs them all in the same order (0,
// at large M: the same bits without the cluster reduction); bn: output
// columns per block. The wrappers pick all four
// (kernels/spectral_matmul.py:launch_geometry).
extern "C" int sct_spectral_matmul_tc(const void* x, const void* U, const void* s,
                                      const void* V, void* y, int M, int m, int n, int k,
                                      int bm, int cl, int split, int bn, void* stream) {
  return launch_factors<bf16>(x, U, s, V, y, M, m, n, k, bm, cl, split, bn, stream);
}

// The same over int8 codes U_q8 (m, k) and V_q8 (n, k), k a multiple of 16,
// with gain (k,) = u_scale * s * v_scale fp32 in place of s.
extern "C" int sct_spectral_matmul_q8_tc(const void* x, const void* U_q8, const void* gain,
                                         const void* V_q8, void* y, int M, int m, int n, int k,
                                         int bm, int cl, int split, int bn, void* stream) {
  return launch_factors<int8_t>(x, U_q8, gain, V_q8, y, M, m, n, k, bm, cl, split, bn, stream);
}
