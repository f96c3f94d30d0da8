// Causal flash attention for Hopper, forward and backward, over the model's
// grouped-query layout.
//
// The forward replaces the TPU kernel kernels/flash_attention.py:
// flash_attention_pallas of the JAX package (and its jnp twin
// nn/attention.py:_flash_fwd_impl, which the model runs); the backward is
// the JAX package's jnp nn/attention.py:_flash_bwd_impl, which has no
// Pallas kernel.
//
// q (b, sq, g, r, dk), k (b, skv, g, dk), v (b, skv, g, dv), out/dout
// (b, sq, g, r, dv), the softmax statistics m/l and the backward's delta
// (b, sq, g, r) fp32; T is fp32 or bf16, (dk, dv) is (64, 64), (128, 128) or
// MLA's (192, 128) (deepseek's q/k heads are 128 nope + 64 rope wide, its v
// heads 128; the scale is 1 / sqrt(dk)). The reference's casts, in order:
// Q.K^T and dO.V^T are summed in fp32 and rounded to T once (its einsums
// return T), then softmax, statistics and accumulators are fp32; p is
// rounded to T before P.V and ds before dQ/dK; every output is rounded
// once. (In bf16 the rounding of dO.V^T matters: dp - delta cancels.)
//
// What bounds it: operations. At the training shape (b 2, s 4096, 32 heads,
// d 64) the forward does 2 * 2 * b * h * s^2 * d / 2 = 137 GFLOP against
// 128 MB of q/k/v/out, ~1000 flops per byte (0.139 ms at 989 TFLOP/s); the
// backward 2.5 times the forward's flops. Beside the products, the forward
// takes one exp per score: 537 M at that shape, 0.2 ms on the SFU pipe that
// also converts p to bf16.
//
// Layout. A tile row is one (position, head of the group) pair: a 64-row
// query tile holds 64 / r positions times the r heads that share a kv head,
// so every staged K/V tile serves the whole group (the TPU kernel folds
// heads into its grid instead and reads K/V once per head). The TPU kernel
// carries its online-softmax state across a sequential grid axis in VMEM;
// here a loop inside the block walks the kv tiles. Causal tiles past the
// block's last position are skipped: they would add exactly zero.
//
// The fp32 kernels (flash_fwd_kernel, flash_bwd_dq_kernel,
// flash_bwd_dkdv_kernel; TF32 would miss the fp32 rung) keep that state in
// shared memory and run each tile product there with plain FMAs, the same
// sums as the plain version in another order. The backward is two kernels
// and needs no atomics: one block per query tile computes delta and dQ,
// then one block per kv tile walks the query tiles at or after it and sums
// dK and dV over the group's r heads.
//
// The bf16 forward (flash_fwd_tc_kernel): what the design does about the
// operations. Both products run on Hopper's warpgroup MMA (wgmma): each
// warpgroup owns one 64-row query tile and computes S = Q K^T into fp32
// registers (K read from shared memory as the K-major B operand), runs the
// online softmax on the accumulators (a row's max and sum by two quad
// shuffles, p = exp2 of the score with scale and log2(e) folded into one
// FMA), packs p to bf16 as the A operand of O += P V (V the MN-major B
// operand) and keeps O, m and l in registers across the kv loop. Four
// warpgroups at head dim 64 (one at 128, registers) share each K/V tile,
// which a cp.async ring copies two tiles ahead of the one computed; the
// tile groups with the most kv tiles launch first. What still holds it
// (0.80 ms at the training shape, H100 80GB HBM3 at 700 W, PERF.md): the
// loop is bound by issue and latency, not by the tensor cores. Each tile
// is a chain (barrier, S, its wait, the softmax's ~300 instructions a
// thread, P V, its wait) that the 16 warps of an SM overlap only in part;
// with S, P V and the copies all taken out, the loop still costs 0.33 ms.
// Overlapping the softmax with the products needs warp-specialised
// producer and consumer warpgroups (FlashAttention-3's ping-pong):
// software-pipelining P V behind the next tile's S inside one warpgroup
// took the registers of a second block an SM and measured slower.
//
// The bf16 backward (flash_bwd_dq_tc_kernel, flash_bwd_dkdv_tc_kernel) is
// bound by operations too: 343 GFLOP at the training shape, 0.35 ms at 989
// TFLOP/s; the two-kernel split recomputes S and dP in the dQ kernel, 480
// GFLOP in all. What its design does about it: every tile product runs on
// Hopper's warpgroup MMA (wgmma) with fp32 accumulators in registers, its
// B operand read from shared memory once a warpgroup, and S, dP, P and dS
// never leave registers: the dK/dV kernel computes S^T = K Q^T and
// dP^T = V dO^T, whose accumulators are, packed to bf16, the A operands of
// dV += P^T dO and dK += dS^T Q; the dQ kernel's S and dS feed dQ += dS K
// the same way. dQ, dK and dV stay in registers across the tile loop; the
// streamed tiles (K/V in the dQ kernel, Q/dO and the row statistics in the
// dK/dV kernel) come through a cp.async ring two or three tiles ahead of
// the one computed, and the blocks with the most tiles launch first. What
// still holds it (2.4 ms at the training shape on an H100, PERF.md): a
// warpgroup runs its products, its softmax-gradient pass and
// its next products one after the other, so the tensor cores idle while it
// computes p and ds (overlapping them needs warp-specialised producer and
// consumer warpgroups); and the dQ kernel costs ~1.1 ms whenever it streams
// K and V, whether or not it computes, for a reason not yet found
// (PERF.md). The fp32 backward keeps the shared-memory kernels above.
//
// At MLA's widths (q/k 192, v 128: deepseek's expanded attention, 128 heads,
// r 1) the same kernels run on two widths, DK for Q.K^T, dQ and dK and DV
// for P.V, O, dO, the delta and dV: the forward with two 64-row warpgroups
// a block (168 KB of shared memory, one block an SM); the dQ kernel loads
// Q's and dO's A fragments one product at a time (dQ takes 96 registers a
// thread); and the dK/dV kernel splits its two warpgroups by product
// (flash_bwd_dkdv_split_tc_kernel: one warpgroup cannot hold dK and dV).
// Right first: 7.2 ms forward and 28.9 backward at b 2, s 4096 against
// bounds of 1.39 and 3.61 (H100 80GB HBM3 at 700 W, PERF.md); the dQ and
// dK/dV kernels run at 255 registers with a few spills.
#include <cstdint>

#include "common.cuh"
#include "mma.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 64;           // query rows (position, head) per tile
constexpr float kNegInf = -1e30f;
constexpr size_t kMaxSmem = 232448;   // the shared memory one block can have (227 KB)

// x rounded to T and back: the rounding of a product the reference's
// einsum returns in T
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return sct::to_float(sct::from_float<T>(x));
}

// row strides in shared memory, padded against bank conflicts and kept at
// a multiple of 16 bytes for the vector loads
template <typename T>
__host__ __device__ constexpr int ld_of(int cols) {
  return cols + 16 / static_cast<int>(sizeof(T));
}
__host__ __device__ constexpr int ldf_of(int cols) { return cols + 4; }

// C[M x N] (fp32, shared, row stride ldc) = (acc ? C : 0) + sum_k A(m,k) B(k,n)
// with A(m,k) = A[m*am + k*ak] and B(k,n) = B[k*bk + n*bn] in shared memory
// (the fp32 kernels; bf16 runs on the wgmma kernels below): each thread owns
// a (M/16) x (N/8) micro-tile, rows tr + 16 i and columns tc + 8 j, and sums
// over k in order with FMAs.
template <int M, int N, int K>
__device__ __forceinline__ void tile_gemm(float* C, int ldc, const float* A, int am, int ak,
                                          const float* B, int bk, int bn, bool acc) {
  static_assert(M % 16 == 0 && N % 8 == 0, "micro-tile shape");
  constexpr int kRM = M / 16, kRN = N / 8;
  const int tr = threadIdx.x / 8, tc = threadIdx.x % 8;
  float c[kRM][kRN];
#pragma unroll
  for (int i = 0; i < kRM; ++i)
#pragma unroll
    for (int j = 0; j < kRN; ++j) c[i][j] = 0.f;
#pragma unroll 4
  for (int k = 0; k < K; ++k) {
    float a[kRM], b[kRN];
#pragma unroll
    for (int i = 0; i < kRM; ++i) a[i] = A[(tr + 16 * i) * am + k * ak];
#pragma unroll
    for (int j = 0; j < kRN; ++j) b[j] = B[k * bk + (tc + 8 * j) * bn];
#pragma unroll
    for (int i = 0; i < kRM; ++i)
#pragma unroll
      for (int j = 0; j < kRN; ++j) c[i][j] = fmaf(a[i], b[j], c[i][j]);
  }
#pragma unroll
  for (int i = 0; i < kRM; ++i)
#pragma unroll
    for (int j = 0; j < kRN; ++j) {
      float* dst = C + (tr + 16 * i) * ldc + tc + 8 * j;
      *dst = acc ? *dst + c[i][j] : c[i][j];
    }
}

// Copy `rows` rows of D elements (global row offsets from row_off(row), -1
// for a row that does not exist) into shared memory with row stride ld,
// 16 bytes at a time; missing rows are zero-filled.
template <typename T, int D, typename RowOff>
__device__ __forceinline__ void load_rows(T* dst, int ld, const T* src, int rows,
                                          RowOff row_off) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kPerRow = D / kVec;
  for (int i = threadIdx.x; i < rows * kPerRow; i += kThreads) {
    const int row = i / kPerRow, col = (i % kPerRow) * kVec;
    const long long off = row_off(row);
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (off >= 0) v = *reinterpret_cast<const uint4*>(src + off + col);
    *reinterpret_cast<uint4*>(dst + row * ld + col) = v;
  }
}

// The block's query tile: positions [q0, q0 + per) of batch bi, kv head gi;
// row rho is (position q0 + rho / r, head rho % r).
struct QTile {
  int bi, gi, q0, per, r, sq, G;
  __device__ int pos(int rho) const { return q0 + rho / r; }
  __device__ bool valid(int rho) const { return rho < per * r && pos(rho) < sq; }
  // index of the row's (b, s, g, r) statistic; its q row is stat(rho) * D
  __device__ long long stat(int rho) const {
    return ((static_cast<long long>(bi) * sq + pos(rho)) * G + gi) * r + rho % r;
  }
};

// The kv row (b, position, kv head) of position kp, or -1 past skv; its
// K row starts at row * DK, its V row at row * DV.
__device__ __forceinline__ long long kv_index(int bi, int kp, int skv, int G, int gi) {
  return kp < skv ? (static_cast<long long>(bi) * skv + kp) * G + gi : -1LL;
}

// DK: the width of q and k (Q.K^T's depth, dQ and dK); DV: the width of v,
// out and dout (P.V's, the delta's, dV's). DK == DV but at MLA's (192, 128).
template <typename T, int DK, int DV, int BK>
struct FwdSmem {
  static constexpr int kLdk = ld_of<T>(DK), kLdv = ld_of<T>(DV), kLds = ldf_of(BK),
                       kLdp = ld_of<T>(BK), kLdo = ldf_of(DV);
  static constexpr size_t kBytes =
      sizeof(T) * (size_t)(kRows * kLdk + BK * kLdk + BK * kLdv + kRows * kLdp) +
      sizeof(float) * (size_t)(kRows * kLds + kRows * kLdo + 2 * kRows);
  static_assert(kBytes <= kMaxSmem, "one block's shared memory");
};

template <typename T, int DK, int DV, int BK>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 T* __restrict__ out, float* __restrict__ m_out, float* __restrict__ l_out,
                 int sq, int skv, int G, int r, int causal, float scale) {
  using S = FwdSmem<T, DK, DV, BK>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* qs = reinterpret_cast<T*>(smem_raw);
  T* ks = qs + kRows * S::kLdk;
  T* vs = ks + BK * S::kLdk;
  T* ps = vs + BK * S::kLdv;
  float* sc = reinterpret_cast<float*>(ps + kRows * S::kLdp);
  float* o = sc + kRows * S::kLds;
  float* mrow = o + kRows * S::kLdo;
  float* lrow = mrow + kRows;

  const int per = kRows / r;
  const QTile t{static_cast<int>(blockIdx.y) / G, static_cast<int>(blockIdx.y) % G,
                static_cast<int>(blockIdx.x) * per, per, r, sq, G};
  const int tid = threadIdx.x;
  load_rows<T, DK>(qs, S::kLdk, q, kRows,
                   [&](int rho) { return t.valid(rho) ? t.stat(rho) * DK : -1LL; });
  for (int i = tid; i < kRows * DV; i += kThreads) o[(i / DV) * S::kLdo + i % DV] = 0.f;
  for (int i = tid; i < kRows; i += kThreads) {
    mrow[i] = kNegInf;
    lrow[i] = 0.f;
  }
  const int last = min(sq - 1, t.q0 + per - 1);
  const int kv_end = causal ? min(skv, last + 1) : skv;
  const int rho = tid >> 1, half = tid & 1;   // two threads per row in the softmax
  const int qpos = t.pos(rho);

  for (int k0 = 0; k0 < kv_end; k0 += BK) {
    __syncthreads();   // the previous tile's K/V/P are consumed
    auto kv = [&](int j) { return kv_index(t.bi, k0 + j, skv, G, t.gi); };
    load_rows<T, DK>(ks, S::kLdk, k, BK, [&](int j) { return kv(j) < 0 ? -1LL : kv(j) * DK; });
    load_rows<T, DV>(vs, S::kLdv, v, BK, [&](int j) { return kv(j) < 0 ? -1LL : kv(j) * DV; });
    __syncthreads();
    tile_gemm<kRows, BK, DK>(sc, S::kLds, qs, S::kLdk, 1, ks, 1, S::kLdk, false);
    __syncthreads();
    {
      float* srow = sc + rho * S::kLds;
      float mx = kNegInf;
      for (int c = half * (BK / 2); c < (half + 1) * (BK / 2); ++c) {
        const int kp = k0 + c;
        float sv = round_to<T>(srow[c]) * scale;
        if (kp >= skv || (causal && kp > qpos)) sv = kNegInf;
        srow[c] = sv;
        mx = fmaxf(mx, sv);
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      const float m_prev = mrow[rho];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
      for (int c = half * (BK / 2); c < (half + 1) * (BK / 2); ++c) {
        const float p = expf(srow[c] - m_new);
        sum += p;
        ps[rho * S::kLdp + c] = sct::from_float<T>(p);
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      // rescale this thread's half of the row's accumulator
      const float a = expf(m_prev - m_new);
      float* orow = o + rho * S::kLdo;
      for (int c = half * (DV / 2); c < (half + 1) * (DV / 2); ++c) orow[c] *= a;
      __syncwarp();
      if (half == 0) {
        lrow[rho] = lrow[rho] * a + sum;
        mrow[rho] = m_new;
      }
    }
    __syncthreads();
    tile_gemm<kRows, DV, BK>(o, S::kLdo, ps, S::kLdp, 1, vs, S::kLdv, 1, true);
  }
  __syncthreads();
  for (int i = tid; i < kRows * DV; i += kThreads) {
    const int row = i / DV, c = i % DV;
    if (t.valid(row))
      out[t.stat(row) * DV + c] =
          sct::from_float<T>(o[row * S::kLdo + c] / fmaxf(lrow[row], 1e-30f));
  }
  for (int i = tid; i < kRows; i += kThreads) {
    if (t.valid(i)) {
      m_out[t.stat(i)] = mrow[i];
      l_out[t.stat(i)] = lrow[i];
    }
  }
}

template <typename T, int DK, int DV, int BK>
struct DqSmem {
  static constexpr int kLdk = ld_of<T>(DK), kLdv = ld_of<T>(DV), kLds = ldf_of(BK),
                       kLdp = ld_of<T>(BK), kLdo = ldf_of(DK);
  static constexpr size_t kBytes =
      sizeof(T) * (size_t)(kRows * (kLdk + kLdv) + BK * (kLdk + kLdv) + kRows * kLdp) +
      sizeof(float) * (size_t)(2 * kRows * kLds + kRows * kLdo + 3 * kRows);
  static_assert(kBytes <= kMaxSmem, "one block's shared memory");
};

// delta and dQ for one query tile; delta goes to global memory for the
// dK/dV kernel, which runs after this one on the same stream.
template <typename T, int DK, int DV, int BK>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                    const T* __restrict__ out, const T* __restrict__ dout,
                    const float* __restrict__ m_in, const float* __restrict__ l_in,
                    float* __restrict__ delta_out, T* __restrict__ dq, int sq, int skv, int G,
                    int r, int causal, float scale) {
  using S = DqSmem<T, DK, DV, BK>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* qs = reinterpret_cast<T*>(smem_raw);
  T* dos = qs + kRows * S::kLdk;
  T* ks = dos + kRows * S::kLdv;
  T* vs = ks + BK * S::kLdk;
  T* dss = vs + BK * S::kLdv;
  float* sc = reinterpret_cast<float*>(dss + kRows * S::kLdp);
  float* dp = sc + kRows * S::kLds;
  float* dqa = dp + kRows * S::kLds;
  float* mrow = dqa + kRows * S::kLdo;
  float* lrow = mrow + kRows;
  float* drow = lrow + kRows;

  const int per = kRows / r;
  const QTile t{static_cast<int>(blockIdx.y) / G, static_cast<int>(blockIdx.y) % G,
                static_cast<int>(blockIdx.x) * per, per, r, sq, G};
  const int tid = threadIdx.x;
  auto q_row = [&](int rho) { return t.valid(rho) ? t.stat(rho) * DK : -1LL; };
  load_rows<T, DK>(qs, S::kLdk, q, kRows, q_row);
  load_rows<T, DV>(dos, S::kLdv, dout, kRows,
                   [&](int rho) { return t.valid(rho) ? t.stat(rho) * DV : -1LL; });
  for (int i = tid; i < kRows * DK; i += kThreads) dqa[(i / DK) * S::kLdo + i % DK] = 0.f;
  const int rho = tid >> 1, half = tid & 1;
  const int qpos = t.pos(rho);
  {
    // delta = rowsum(dO * O) in fp32, two threads a row
    float dsum = 0.f;
    if (t.valid(rho)) {
      const T* orow = out + t.stat(rho) * DV;
      const T* drow_g = dout + t.stat(rho) * DV;
      for (int c = half * (DV / 2); c < (half + 1) * (DV / 2); ++c)
        dsum = fmaf(sct::to_float(drow_g[c]), sct::to_float(orow[c]), dsum);
    }
    dsum += __shfl_xor_sync(0xffffffffu, dsum, 1);
    if (half == 0) {
      const bool ok = t.valid(rho);
      drow[rho] = dsum;
      mrow[rho] = ok ? m_in[t.stat(rho)] : 0.f;
      lrow[rho] = ok ? fmaxf(l_in[t.stat(rho)], 1e-30f) : 1.f;
      if (ok) delta_out[t.stat(rho)] = dsum;
    }
  }
  const int last = min(sq - 1, t.q0 + per - 1);
  const int kv_end = causal ? min(skv, last + 1) : skv;

  for (int k0 = 0; k0 < kv_end; k0 += BK) {
    __syncthreads();
    auto kv = [&](int j) { return kv_index(t.bi, k0 + j, skv, G, t.gi); };
    load_rows<T, DK>(ks, S::kLdk, k, BK, [&](int j) { return kv(j) < 0 ? -1LL : kv(j) * DK; });
    load_rows<T, DV>(vs, S::kLdv, v, BK, [&](int j) { return kv(j) < 0 ? -1LL : kv(j) * DV; });
    __syncthreads();
    tile_gemm<kRows, BK, DK>(sc, S::kLds, qs, S::kLdk, 1, ks, 1, S::kLdk, false);
    tile_gemm<kRows, BK, DV>(dp, S::kLds, dos, S::kLdv, 1, vs, 1, S::kLdv, false);
    __syncthreads();
    {
      const float m_r = mrow[rho], l_r = lrow[rho], d_r = drow[rho];
      for (int c = half * (BK / 2); c < (half + 1) * (BK / 2); ++c) {
        const int kp = k0 + c;
        float sv = round_to<T>(sc[rho * S::kLds + c]) * scale;
        if (kp >= skv || (causal && kp > qpos)) sv = kNegInf;
        const float p = expf(sv - m_r) / l_r;
        const float ds = p * (round_to<T>(dp[rho * S::kLds + c]) - d_r) * scale;
        dss[rho * S::kLdp + c] = sct::from_float<T>(ds);
      }
    }
    __syncthreads();
    tile_gemm<kRows, DK, BK>(dqa, S::kLdo, dss, S::kLdp, 1, ks, S::kLdk, 1, true);
  }
  __syncthreads();
  for (int i = tid; i < kRows * DK; i += kThreads) {
    const int row = i / DK, c = i % DK;
    if (t.valid(row)) dq[t.stat(row) * DK + c] = sct::from_float<T>(dqa[row * S::kLdo + c]);
  }
}

template <typename T, int DK, int DV, int BK>
struct DkvSmem {
  static constexpr int kLdk = ld_of<T>(DK), kLdv = ld_of<T>(DV), kLds = ldf_of(BK),
                       kLdp = ld_of<T>(BK), kLdok = ldf_of(DK), kLdov = ldf_of(DV);
  static constexpr size_t kBytes =
      sizeof(T) * (size_t)((BK + kRows) * (kLdk + kLdv) + 2 * kRows * kLdp) +
      sizeof(float) * (size_t)(BK * (kLdok + kLdov) + 2 * kRows * kLds + 3 * kRows);
  static_assert(kBytes <= kMaxSmem, "one block's shared memory");
};

// dK and dV for one kv tile, summed over every query tile at or after it
// and over the r heads of the group.
template <typename T, int DK, int DV, int BK>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const T* __restrict__ dout,
                      const float* __restrict__ m_in, const float* __restrict__ l_in,
                      const float* __restrict__ delta_in, T* __restrict__ dk,
                      T* __restrict__ dv, int sq, int skv, int G, int r, int causal,
                      float scale) {
  using S = DkvSmem<T, DK, DV, BK>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* ks = reinterpret_cast<T*>(smem_raw);
  T* vs = ks + BK * S::kLdk;
  T* qs = vs + BK * S::kLdv;
  T* dos = qs + kRows * S::kLdk;
  T* ps = dos + kRows * S::kLdv;
  T* dss = ps + kRows * S::kLdp;
  float* dka = reinterpret_cast<float*>(dss + kRows * S::kLdp);
  float* dva = dka + BK * S::kLdok;
  float* sc = dva + BK * S::kLdov;
  float* dp = sc + kRows * S::kLds;
  float* mrow = dp + kRows * S::kLds;
  float* lrow = mrow + kRows;
  float* drow = lrow + kRows;

  const int bi = static_cast<int>(blockIdx.y) / G, gi = static_cast<int>(blockIdx.y) % G;
  const int k0 = static_cast<int>(blockIdx.x) * BK;
  const int tid = threadIdx.x;
  auto kv = [&](int j) { return kv_index(bi, k0 + j, skv, G, gi); };
  load_rows<T, DK>(ks, S::kLdk, k, BK, [&](int j) { return kv(j) < 0 ? -1LL : kv(j) * DK; });
  load_rows<T, DV>(vs, S::kLdv, v, BK, [&](int j) { return kv(j) < 0 ? -1LL : kv(j) * DV; });
  for (int i = tid; i < BK * DK; i += kThreads) dka[(i / DK) * S::kLdok + i % DK] = 0.f;
  for (int i = tid; i < BK * DV; i += kThreads) dva[(i / DV) * S::kLdov + i % DV] = 0.f;
  const int per = kRows / r;
  const int rho = tid >> 1, half = tid & 1;
  // causal: query positions before k0 see none of this tile
  const int q_first = causal ? (k0 / per) * per : 0;

  for (int q0 = q_first; q0 < sq; q0 += per) {
    const QTile t{bi, gi, q0, per, r, sq, G};
    __syncthreads();   // the previous query tile is consumed
    load_rows<T, DK>(qs, S::kLdk, q, kRows,
                     [&](int row) { return t.valid(row) ? t.stat(row) * DK : -1LL; });
    load_rows<T, DV>(dos, S::kLdv, dout, kRows,
                     [&](int row) { return t.valid(row) ? t.stat(row) * DV : -1LL; });
    for (int i = tid; i < kRows; i += kThreads) {
      const bool ok = t.valid(i);
      mrow[i] = ok ? m_in[t.stat(i)] : 0.f;
      lrow[i] = ok ? fmaxf(l_in[t.stat(i)], 1e-30f) : 1.f;
      drow[i] = ok ? delta_in[t.stat(i)] : 0.f;
    }
    __syncthreads();
    tile_gemm<kRows, BK, DK>(sc, S::kLds, qs, S::kLdk, 1, ks, 1, S::kLdk, false);
    tile_gemm<kRows, BK, DV>(dp, S::kLds, dos, S::kLdv, 1, vs, 1, S::kLdv, false);
    __syncthreads();
    {
      const bool ok = t.valid(rho);
      const int qpos = t.pos(rho);
      const float m_r = mrow[rho], l_r = lrow[rho], d_r = drow[rho];
      for (int c = half * (BK / 2); c < (half + 1) * (BK / 2); ++c) {
        const int kp = k0 + c;
        float sv = round_to<T>(sc[rho * S::kLds + c]) * scale;
        if (kp >= skv || (causal && kp > qpos)) sv = kNegInf;
        const float p = ok ? expf(sv - m_r) / l_r : 0.f;
        ps[rho * S::kLdp + c] = sct::from_float<T>(p);
        dss[rho * S::kLdp + c] =
            sct::from_float<T>(p * (round_to<T>(dp[rho * S::kLds + c]) - d_r) * scale);
      }
    }
    __syncthreads();
    // dV += P^T dO and dK += dS^T Q: A(m = kv, k = query row) = P[k][m]
    tile_gemm<BK, DV, kRows>(dva, S::kLdov, ps, 1, S::kLdp, dos, S::kLdv, 1, true);
    tile_gemm<BK, DK, kRows>(dka, S::kLdok, dss, 1, S::kLdp, qs, S::kLdk, 1, true);
  }
  __syncthreads();
  for (int i = tid; i < BK * DK; i += kThreads) {
    const int row = i / DK, c = i % DK;
    if (kv(row) >= 0) dk[kv(row) * DK + c] = sct::from_float<T>(dka[row * S::kLdok + c]);
  }
  for (int i = tid; i < BK * DV; i += kThreads) {
    const int row = i / DV, c = i % DV;
    if (kv(row) >= 0) dv[kv(row) * DV + c] = sct::from_float<T>(dva[row * S::kLdov + c]);
  }
}

template <typename T, int DK, int DV, int BK>
cudaError_t launch_fwd(const void* q, const void* k, const void* v, void* out, void* m,
                       void* l, int b, int sq, int skv, int G, int r, int causal, float scale,
                       cudaStream_t stream) {
  using S = FwdSmem<T, DK, DV, BK>;
  auto kernel = flash_fwd_kernel<T, DK, DV, BK>;
  cudaError_t err = sct::allow_smem(kernel, S::kBytes);
  if (err != cudaSuccess) return err;
  const int per = kRows / r;
  const dim3 grid((sq + per - 1) / per, b * G);
  kernel<<<grid, kThreads, S::kBytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), static_cast<float*>(m), static_cast<float*>(l), sq, skv, G, r,
      causal, scale);
  return cudaGetLastError();
}

template <typename T, int DK, int DV, int BK>
cudaError_t launch_bwd(const void* q, const void* k, const void* v, const void* out,
                       const void* dout, const void* m, const void* l, void* delta, void* dq,
                       void* dk, void* dv, int b, int sq, int skv, int G, int r, int causal,
                       float scale, cudaStream_t stream) {
  using Sq = DqSmem<T, DK, DV, BK>;
  using Skv = DkvSmem<T, DK, DV, BK>;
  auto dq_kernel = flash_bwd_dq_kernel<T, DK, DV, BK>;
  auto dkdv_kernel = flash_bwd_dkdv_kernel<T, DK, DV, BK>;
  cudaError_t err = sct::allow_smem(dq_kernel, Sq::kBytes);
  if (err != cudaSuccess) return err;
  err = sct::allow_smem(dkdv_kernel, Skv::kBytes);
  if (err != cudaSuccess) return err;
  const int per = kRows / r;
  dq_kernel<<<dim3((sq + per - 1) / per, b * G), kThreads, Sq::kBytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(out), static_cast<const T*>(dout), static_cast<const float*>(m),
      static_cast<const float*>(l), static_cast<float*>(delta), static_cast<T*>(dq), sq, skv,
      G, r, causal, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  dkdv_kernel<<<dim3((skv + BK - 1) / BK, b * G), kThreads, Skv::kBytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), static_cast<const float*>(m), static_cast<const float*>(l),
      static_cast<const float*>(delta), static_cast<T*>(dk), static_cast<T*>(dv), sq, skv, G,
      r, causal, scale);
  return cudaGetLastError();
}

// ---- the bf16 backward on the tensor cores ----
//
// The FlashAttention-2 register scheme on Hopper's warpgroup MMA (wgmma,
// mma.cuh): A operands come from registers, B operands from shared memory
// through a descriptor, so a warpgroup of four warps reads each B tile once
// (mma.sync made every warp read it). Accumulators stay in registers, and
// the accumulator layout of S, dP (or their transposes), packed to bf16, is
// the A operand of the next product. Tiles are stored as 8 x 16-byte core
// matrices, so one Q (or dO, K) tile is the K-major B operand of one product
// and the MN-major B operand of another; they stream through a cp.async
// ring. Two kernels and no atomics, as before: every sum runs in a fixed
// order, so two calls give the same bits.
namespace tc = sct::mma;
using bf16 = __nv_bfloat16;
constexpr float kLog2e = 1.4426950408889634f;

// The dQ kernel is one warpgroup a block (kWgThreads) against 64-row kv
// tiles, so three blocks share an SM and overlap one another's phases; the
// dK/dV kernel takes 128 kv rows in two warpgroups at d 64 (each Q/dO tile
// it streams serves both), 64 in one at d 128 (registers). Tiles come
// through a ring of kAhead + 1 buffers: the tile being read and the next
// kAhead in flight (the dK/dV kernel is bound by the bytes it has in
// flight; three ahead measure best for it, two for the dQ kernel).
constexpr int kWgThreads = 128;
constexpr int kDqAhead = 2, kDkvAhead = 3;
template <int D>
struct TcTile {
  static constexpr int kBN = 64;                    // kv rows per dQ kv tile
  static constexpr int kBNK = D == 64 ? 128 : 64;   // kv rows per dK/dV block
  static constexpr int kKD = D / 16;                // k16 steps over d
  static constexpr int kKLead = (D / 8) * 128;      // bytes between core-matrix rows of 8
  static constexpr int kTile = kRows * D * 2;       // bytes of a 64-row tile
};

// x rounded to bf16 (nearest, ties to even) and back, on the integer pipe:
// the same bits as __float2bfloat16_rn for finite x, without a conversion
// instruction (16 a clock an SM, shared with ex2)
__device__ __forceinline__ float round_bf16(float x) {
  uint32_t u = __float_as_uint(x);
  u += 0x7FFFu + ((u >> 16) & 1u);
  return __uint_as_float(u & 0xFFFF0000u);
}
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Byte offset of row `row`, 16-byte chunk c8, in a tile of D-wide bf16 rows
// stored as core matrices: core (row / 8, c8) at ((row / 8) D / 8 + c8) 128.
template <int D>
__device__ __forceinline__ int cm_off(int row, int c8) {
  return (((row >> 3) * (D / 8) + c8) << 7) + ((row & 7) << 4);
}

// Chunk i of a core-matrix tile: consecutive i run down the 8 rows of a
// core matrix, so eight lanes fill 128 contiguous bytes (no bank conflict);
// the global side coalesces whatever the lane order.
template <int D>
__device__ __forceinline__ void cm_chunk(int i, int& row, int& c8) {
  row = (i / (8 * (D / 8))) * 8 + (i & 7);
  c8 = (i >> 3) % (D / 8);
}

// Start copying `rows` rows of D bf16 (global offsets from row_off, -1 for
// a missing row, zero-filled) into a core-matrix tile; rows is a multiple
// of 8.
template <int D, typename RowOff>
__device__ __forceinline__ void load_rows_cm(unsigned char* dst, const bf16* src, int rows,
                                             RowOff row_off) {
  for (int i = threadIdx.x; i < rows * (D / 8); i += blockDim.x) {
    int row, c8;
    cm_chunk<D>(i, row, c8);
    const long long off = row_off(row);
    tc::cp_async16(dst + cm_off<D>(row, c8), off >= 0 ? src + off + c8 * 8 : src, off >= 0);
  }
}

// Stage kBN kv rows (global rows base + row G, `rows` of them present) of
// K (DK wide) into ks and V (DV <= DK wide) into vs, kThr threads each
// copying its share: one loop over K's chunks, each with V's chunk of the
// same index beside it while V has one. At DK == DV that is the same row
// and column of V, so its address is K's.
template <int DK, int DV, int kBN, int kThr>
__device__ __forceinline__ void stage_kv(unsigned char* ks, unsigned char* vs,
                                         const bf16* k, const bf16* v, long long base,
                                         int rows, int G, int tid) {
  static_assert(DV <= DK && kBN * (DK / 8) % kThr == 0 && kBN * (DV / 8) % kThr == 0,
                "whole K/V chunks a thread");
#pragma unroll
  for (int u = 0; u < kBN * (DK / 8) / kThr; ++u) {
    int row, c8;
    cm_chunk<DK>(tid + u * kThr, row, c8);
    long long off = (base + static_cast<long long>(row) * G) * DK + c8 * 8;
    tc::cp_async16(ks + cm_off<DK>(row, c8), row < rows ? k + off : k, row < rows);
    if (u < kBN * (DV / 8) / kThr) {
      if (DK != DV) {
        cm_chunk<DV>(tid + u * kThr, row, c8);
        off = (base + static_cast<long long>(row) * G) * DV + c8 * 8;
      }
      tc::cp_async16(vs + cm_off<DV>(row, c8), row < rows ? v + off : v, row < rows);
    }
  }
}

// The chunks of a 64-row query tile a thread copies, mapped once a block:
// chunk u is row `row` (position pr = row / r, head rr = row % r of the
// group; ok if the tile has the row), 16-byte column c8, at shared offset
// soff. A tile's global offsets then take a few multiply-adds, not two
// divisions by r a chunk.
template <int kN>
struct QChunks {
  int pr[kN], rr[kN], c8[kN], soff[kN];
  bool ok[kN];
  template <int D>
  __device__ void init(int tid, int nthreads, int per, int r) {
#pragma unroll
    for (int u = 0; u < kN; ++u) {
      int row;
      cm_chunk<D>(tid + u * nthreads, row, c8[u]);
      pr[u] = row / r;
      rr[u] = row % r;
      ok[u] = row < per * r;
      soff[u] = cm_off<D>(row, c8[u]);
    }
  }
};

// Write `rows` rows of a core-matrix tile to the global rows row_off(row)
// (skipped where -1), 16 bytes at a time.
template <int D, typename RowOff>
__device__ __forceinline__ void store_rows_cm(bf16* dst, const unsigned char* src, int rows,
                                              RowOff row_off) {
  for (int i = threadIdx.x; i < rows * (D / 8); i += blockDim.x) {
    int row, c8;
    cm_chunk<D>(i, row, c8);
    const long long off = row_off(row);
    if (off >= 0)
      *reinterpret_cast<uint4*>(dst + off + c8 * 8) =
          *reinterpret_cast<const uint4*>(src + cm_off<D>(row, c8));
  }
}

// Two fp32 values rounded into a core-matrix tile at (row, col), col even.
template <int D>
__device__ __forceinline__ void put2(unsigned char* tile, int row, int col, float lo, float hi) {
  *reinterpret_cast<uint32_t*>(tile + cm_off<D>(row, col >> 3) + (col & 7) * 2) =
      tc::pack_bf16(lo, hi);
}

// A fragment (16 x 16) of a core-matrix tile at (r0, c0)
template <int D>
__device__ __forceinline__ void lda_cm(uint32_t* a, const unsigned char* tile, int r0, int c0) {
  const int lane = threadIdx.x % 32;
  tc::ldsm_x4(a, tile + cm_off<D>(r0 + (lane & 15), (c0 >> 3) + (lane >> 4)));
}

// Descriptors over a core-matrix tile: rows as N and d as K (K-major), from
// row n0 at k-step kk; or rows as K and d as N (MN-major), from row k0.
template <int D>
__device__ __forceinline__ uint64_t desc_kmajor(const unsigned char* tile, int n0, int kk) {
  return tc::wgmma_desc(tile + (n0 >> 3) * TcTile<D>::kKLead + kk * 256, 128, TcTile<D>::kKLead);
}
template <int D>
__device__ __forceinline__ uint64_t desc_mnmajor(const unsigned char* tile, int k0) {
  return tc::wgmma_desc(tile + (k0 >> 3) * TcTile<D>::kKLead, TcTile<D>::kKLead, 128);
}

// The A fragment of k-step kq from the accumulator's n8 tiles 2 kq, 2 kq + 1.
__device__ __forceinline__ void acc_to_a(uint32_t* a, const float* c, int kq) {
  a[0] = tc::pack_bf16(c[8 * kq + 0], c[8 * kq + 1]);
  a[1] = tc::pack_bf16(c[8 * kq + 2], c[8 * kq + 3]);
  a[2] = tc::pack_bf16(c[8 * kq + 4], c[8 * kq + 5]);
  a[3] = tc::pack_bf16(c[8 * kq + 6], c[8 * kq + 7]);
}

__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// acc (64 x N fp32) += A (64 x 16, registers) . rows k0 .. k0 + 15 of a
// core-matrix tile of N-wide rows as the MN-major B operand: one wgmma at N
// 64 or 128; at 192 one over columns 0-127 and one over 128-191 (16 core
// matrices, 2048 bytes, further along the row), whose n8 tiles 16-23 are
// acc[64 ..] in the accumulator layout.
template <int N>
__device__ __forceinline__ void wgmma_mn(float* acc, const uint32_t* a,
                                         const unsigned char* tile, int k0) {
  if constexpr (N == 192) {
    tc::wgmma_bf16<128, 1>(acc, a, desc_mnmajor<192>(tile, k0), 1);
    tc::wgmma_bf16<64, 1>(acc + 64, a, desc_mnmajor<192>(tile + 16 * 128, k0), 1);
  } else {
    tc::wgmma_bf16<N, 1>(acc, a, desc_mnmajor<N>(tile, k0), 1);
  }
}

// ---- the bf16 forward ----
//
// kWG warpgroups a block, each owning one 64-row query tile (the block's
// tiles are consecutive, so the positions run on); every K/V tile staged in
// shared memory serves all of them. Per kv tile a warpgroup computes
// S = Q K^T into registers (K the K-major B operand), runs the online
// softmax on the accumulators (thread (g, t) of warp w holds rows
// 16 w + g and + 8, so a row's max and sum take two quad shuffles), packs
// p to bf16 as the A operand and adds P V into O (V the MN-major B
// operand); O, m and l stay in registers across the kv loop.
constexpr int kFwdAhead = 2;   // K/V tiles in flight ahead of the one computed
template <int DK, int DV, int kWG>
struct FwdTc {
  static constexpr int kBN = 64;                                // kv rows a tile
  static constexpr int kThreads = kWG * kWgThreads;
  static constexpr size_t kK = (size_t)kBN * DK * 2, kV = (size_t)kBN * DV * 2;   // K, V tile
  static constexpr size_t kBytes = kWG * (size_t)TcTile<DK>::kTile + (kFwdAhead + 1) * (kK + kV);
  // registers: O (DV / 2 a thread), S (kBN / 2) and the A fragments; at
  // (192, 128) shared memory holds one block an SM
  static constexpr int kMinBlocks = DK == 64 ? 4 / kWG : DK == 128 ? 2 / kWG : 1;
  static_assert(kBytes <= kMaxSmem, "one block's shared memory");
};

// out, m and l for kWG consecutive 64-row query tiles of one (batch, kv
// head). Blocks are numbered heaviest first: block i takes the (b, g) pair
// i % (b G) of tile group n - 1 - i / (b G), so the groups with the most kv
// tiles start first and the light ones fill the tail.
template <int DK, int DV, int kWG>
__global__ void __launch_bounds__(FwdTc<DK, DV, kWG>::kThreads, FwdTc<DK, DV, kWG>::kMinBlocks)
flash_fwd_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, bf16* __restrict__ out,
                    float* __restrict__ m_out, float* __restrict__ l_out, int sq, int skv,
                    int G, int r, int causal, float scale, int n_pairs, int n_groups) {
  using B = TcTile<DK>;
  using F = FwdTc<DK, DV, kWG>;
  constexpr int kBN = F::kBN, kNS = kBN / 8, kRing = kFwdAhead + 1;
  extern __shared__ __align__(128) unsigned char smem_tc[];
  unsigned char* ring = smem_tc + kWG * B::kTile;   // kRing x (K tile, V tile)

  const int pair = static_cast<int>(blockIdx.x % n_pairs);
  const int group = n_groups - 1 - static_cast<int>(blockIdx.x / n_pairs);
  const int per = kRows / r;
  const int tid = threadIdx.x, wg = tid / kWgThreads, wtid = tid % kWgThreads;
  const int warp = wtid / 32, lane = tid % 32;
  const int g = lane >> 2, tq = lane & 3;
  const QTile t{pair / G, pair % G, (group * kWG + wg) * per, per, r, sq, G};
  unsigned char* qs = smem_tc + wg * B::kTile;   // this warpgroup's query tile

  for (int i = wtid; i < kRows * (DK / 8); i += kWgThreads) {
    int row, c8;
    cm_chunk<DK>(i, row, c8);
    const bool ok = t.valid(row);
    tc::cp_async16(qs + cm_off<DK>(row, c8), ok ? q + t.stat(row) * DK + c8 * 8 : q, ok);
  }
  tc::cp_async_commit();
  // the block walks the kv tiles its last query row sees; a warpgroup
  // computes those its own rows see
  auto kv_extent = [&](int first_pos, int n_pos) {
    if (first_pos >= sq) return 0;
    const int end = causal ? min(skv, min(sq - 1, first_pos + n_pos - 1) + 1) : skv;
    return (end + kBN - 1) / kBN;
  };
  const int ntiles = kv_extent(group * kWG * per, kWG * per);
  const int my_tiles = kv_extent(t.q0, per);
  auto issue_kv = [&](int j) {
    unsigned char* ks = ring + (j % kRing) * (F::kK + F::kV);
    stage_kv<DK, DV, kBN, F::kThreads>(ks, ks + F::kK, k, v,
                                       (static_cast<long long>(t.bi) * skv + j * kBN) * G + t.gi,
                                       skv - j * kBN, G, tid);
  };
#pragma unroll
  for (int j = 0; j < kFwdAhead; ++j) {
    if (j < ntiles) issue_kv(j);
    tc::cp_async_commit();
  }

  // this thread's two fragment rows (16 warp + g, + 8): running max of the
  // rounded scores (unscaled), running sum, position (-1: no such row)
  float mraw[2], lsum[2];
  int qpos[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = warp * 16 + g + 8 * h;
    mraw[h] = kNegInf;
    lsum[h] = 0.f;
    qpos[h] = t.valid(row) ? t.pos(row) : -1;
  }
  float o[DV / 2];
#pragma unroll
  for (int i = 0; i < DV / 2; ++i) o[i] = 0.f;
  const float sl2 = scale * kLog2e;

  for (int j = 0; j < ntiles; ++j) {
    tc::cp_async_wait<kFwdAhead - 1>();   // tile j (and Q) have landed
    fence_async_smem();                   // for the tensor cores' reads
    __syncthreads();                      // and every warp is done with tile j - 1
    if (j + kFwdAhead < ntiles) issue_kv(j + kFwdAhead);   // into tile j - 1's buffer
    tc::cp_async_commit();
    if (j >= my_tiles) continue;          // past this warpgroup's last row
    const unsigned char* ks = ring + (j % kRing) * (F::kK + F::kV);
    const unsigned char* vs = ks + F::kK;
    // S = Q K^T. Q's fragments are loaded for each tile and fenced after
    // the wait (fragments held in registers across tiles did not survive
    // the backward's loop).
    uint32_t qa[B::kKD][4];
#pragma unroll
    for (int kk = 0; kk < B::kKD; ++kk) lda_cm<DK>(qa[kk], qs, warp * 16, kk * 16);
    float sc[kBN / 2];
    tc::fence_regs<kBN / 2>(sc);
    tc::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < B::kKD; ++kk)
      tc::wgmma_bf16<kBN, 0>(sc, qa[kk], desc_kmajor<DK>(ks, 0, kk), kk > 0);
    tc::wgmma_commit();
    tc::wgmma_wait();
    tc::fence_regs<kBN / 2>(sc);
    tc::fence_regs<B::kKD>(qa);
    // online softmax: s = round(S) (its scale folded into the exponent),
    // masked to -1e30 where the tile crosses the diagonal or skv; a
    // masked p is ex2 of about -1e29, zero, once a row has seen key 0
    const int kbase = j * kBN;
    const bool edge = kbase + kBN > skv || (causal && kbase + kBN - 1 > t.q0);
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int n = 0; n < kNS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e >> 1;
        float s = round_bf16(sc[4 * n + e]);
        if (edge) {
          const int kp = kbase + n * 8 + 2 * tq + (e & 1);
          if (kp >= skv || (causal && kp > qpos[h])) s = kNegInf;
        }
        sc[4 * n + e] = s;
        mx[h] = fmaxf(mx[h], s);
      }
    float alpha[2], nm[2], ps[2] = {0.f, 0.f};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      const float m_new = fmaxf(mraw[h], mx[h]);
      alpha[h] = ex2((mraw[h] - m_new) * sl2);
      mraw[h] = m_new;
      nm[h] = -m_new * sl2;
    }
#pragma unroll
    for (int n = 0; n < kNS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = ex2(fmaf(sc[4 * n + e], sl2, nm[e >> 1]));
        sc[4 * n + e] = p;
        ps[e >> 1] += p;
      }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      ps[h] += __shfl_xor_sync(0xffffffffu, ps[h], 1);
      ps[h] += __shfl_xor_sync(0xffffffffu, ps[h], 2);
      lsum[h] = lsum[h] * alpha[h] + ps[h];
    }
#pragma unroll
    for (int n = 0; n < DV / 8; ++n) {
      o[4 * n] *= alpha[0];
      o[4 * n + 1] *= alpha[0];
      o[4 * n + 2] *= alpha[1];
      o[4 * n + 3] *= alpha[1];
    }
    // O += P V: p rounded to bf16 is the A operand, V the MN-major B operand
    uint32_t ap[kNS / 2][4];
#pragma unroll
    for (int kq = 0; kq < kNS / 2; ++kq) acc_to_a(ap[kq], sc, kq);
    tc::fence_regs<DV / 2>(o);
    tc::wgmma_fence();
#pragma unroll
    for (int kq = 0; kq < kNS / 2; ++kq) wgmma_mn<DV>(o, ap[kq], vs, kq * 16);
    tc::wgmma_commit();
    tc::wgmma_wait();
    tc::fence_regs<DV / 2>(o);
    tc::fence_regs<kNS / 2>(ap);
  }
  tc::cp_async_wait<0>();
  __syncthreads();   // every warp is done with Q: its tile stages out (DV wide)
  const float l_lo = fmaxf(lsum[0], 1e-30f), l_hi = fmaxf(lsum[1], 1e-30f);
#pragma unroll
  for (int n = 0; n < DV / 8; ++n) {
    const int row = warp * 16 + g, c = n * 8 + 2 * tq;
    put2<DV>(qs, row, c, o[4 * n] / l_lo, o[4 * n + 1] / l_lo);
    put2<DV>(qs, row + 8, c, o[4 * n + 2] / l_hi, o[4 * n + 3] / l_hi);
  }
  if (tq == 0) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = warp * 16 + g + 8 * h;
      if (t.valid(row)) {
        m_out[t.stat(row)] = mraw[h] * scale;
        l_out[t.stat(row)] = lsum[h];
      }
    }
  }
  __syncthreads();
  for (int i = wtid; i < kRows * (DV / 8); i += kWgThreads) {
    int row, c8;
    cm_chunk<DV>(i, row, c8);
    if (t.valid(row))
      *reinterpret_cast<uint4*>(out + t.stat(row) * DV + c8 * 8) =
          *reinterpret_cast<const uint4*>(qs + cm_off<DV>(row, c8));
  }
}

template <int DK, int DV, int kWG>
cudaError_t launch_fwd_tc(const void* q, const void* k, const void* v, void* out, void* m,
                          void* l, int b, int sq, int skv, int G, int r, int causal,
                          float scale, cudaStream_t stream) {
  using F = FwdTc<DK, DV, kWG>;
  auto kernel = flash_fwd_tc_kernel<DK, DV, kWG>;
  cudaError_t err = sct::allow_smem(kernel, F::kBytes);
  if (err != cudaSuccess) return err;
  const int per = kRows / r;
  const int n_groups = ((sq + per - 1) / per + kWG - 1) / kWG;
  const long long blocks = static_cast<long long>(n_groups) * b * G;
  if (blocks > 0x7FFFFFFFLL) return cudaErrorInvalidValue;
  kernel<<<static_cast<unsigned>(blocks), F::kThreads, F::kBytes, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(out), static_cast<float*>(m), static_cast<float*>(l), sq, skv, G, r,
      causal, scale, b * G, n_groups);
  return cudaGetLastError();
}

template <int DK, int DV>
struct DqTcSmem {
  static constexpr int kBN = 64;                          // kv rows a tile
  static constexpr size_t kK = (size_t)kBN * DK * 2, kV = (size_t)kBN * DV * 2;   // K, V tile
  static constexpr size_t kBytes = (size_t)TcTile<DK>::kTile + TcTile<DV>::kTile +
                                   (kDqAhead + 1) * (kK + kV) + sizeof(float) * kRows;
  static_assert(kBytes <= kMaxSmem, "one block's shared memory");
};

// delta and dQ for one 64-row query tile: warp w takes query rows
// 16 w .. + 16 against every kv tile. The row statistics the dK/dV kernel
// needs go to `stats` (3 x rows fp32: delta, m log2(e), 1 / l); that
// kernel runs after this one on the same stream. At (192, 128) S and dP
// run one after the other, each with its own A fragments (registers: dQ
// takes 96 a thread).
template <int DK, int DV>
__global__ void __launch_bounds__(kWgThreads, 2)
flash_bwd_dq_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                       const bf16* __restrict__ v, const bf16* __restrict__ out,
                       const bf16* __restrict__ dout, const float* __restrict__ m_in,
                       const float* __restrict__ l_in, float* __restrict__ stats,
                       bf16* __restrict__ dq, int sq, int skv, int G, int r, int causal,
                       float scale) {
  using Bk = TcTile<DK>;
  using Bv = TcTile<DV>;
  using S = DqTcSmem<DK, DV>;
  constexpr int kBN = S::kBN, kNS = kBN / 8;
  constexpr bool kOneBatch = DK + DV <= 256;   // Q and dO fragments in registers together
  extern __shared__ __align__(128) unsigned char smem_tc[];
  unsigned char* qs = smem_tc;
  unsigned char* dos = qs + Bk::kTile;
  constexpr int kRing = kDqAhead + 1;
  unsigned char* ring = dos + Bv::kTile;   // kRing x (K tile, V tile)
  float* dsm = reinterpret_cast<float*>(ring + kRing * (S::kK + S::kV));   // delta per row

  const int per = kRows / r;
  const int qt = static_cast<int>(gridDim.x - 1 - blockIdx.x);   // heaviest tiles first
  const QTile t{static_cast<int>(blockIdx.y) / G, static_cast<int>(blockIdx.y) % G, qt * per,
                per, r, sq, G};
  const long long n_stat = static_cast<long long>(gridDim.y) * sq * r;   // b sq g r
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, tq = lane & 3;
  const int rg = warp;

  auto q_row = [&](int rho) { return t.valid(rho) ? t.stat(rho) * DK : -1LL; };
  load_rows_cm<DK>(qs, q, kRows, q_row);
  load_rows_cm<DV>(dos, dout, kRows,
                   [&](int rho) { return t.valid(rho) ? t.stat(rho) * DV : -1LL; });
  tc::cp_async_commit();
  const int last = min(sq - 1, t.q0 + per - 1);
  const int kv_end = causal ? min(skv, last + 1) : skv;
  const int ntiles = (kv_end + kBN - 1) / kBN;
  auto issue_kv = [&](int j) {
    unsigned char* ks = ring + (j % kRing) * (S::kK + S::kV);
    stage_kv<DK, DV, kBN, kWgThreads>(ks, ks + S::kK, k, v,
                                      (static_cast<long long>(t.bi) * skv + j * kBN) * G + t.gi,
                                      skv - j * kBN, G, tid);
  };
#pragma unroll
  for (int j = 0; j < kDqAhead; ++j) {
    if (j < ntiles) issue_kv(j);
    tc::cp_async_commit();
  }

  // delta = rowsum(dO * O) in fp32, two threads a row, while the tiles land
  {
    const int rho = tid >> 1, part = tid & 1;
    float dsum = 0.f;
    if (t.valid(rho)) {
      const bf16* orow = out + t.stat(rho) * DV + part * (DV / 2);
      const bf16* drow = dout + t.stat(rho) * DV + part * (DV / 2);
#pragma unroll
      for (int c = 0; c < DV / 2; c += 8) {
        const uint4 ov = *reinterpret_cast<const uint4*>(orow + c);
        const uint4 dv = *reinterpret_cast<const uint4*>(drow + c);
        const __nv_bfloat162* o2 = reinterpret_cast<const __nv_bfloat162*>(&ov);
        const __nv_bfloat162* d2 = reinterpret_cast<const __nv_bfloat162*>(&dv);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 of = __bfloat1622float2(o2[e]), df = __bfloat1622float2(d2[e]);
          dsum = fmaf(df.x, of.x, dsum);
          dsum = fmaf(df.y, of.y, dsum);
        }
      }
    }
    dsum += __shfl_xor_sync(0xffffffffu, dsum, 1);
    if (part == 0) {
      dsm[rho] = dsum;
      if (t.valid(rho)) {
        const long long i = t.stat(rho);
        stats[i] = dsum;
        stats[n_stat + i] = m_in[i] * kLog2e;
        stats[2 * n_stat + i] = 1.f / fmaxf(l_in[i], 1e-30f);
      }
    }
  }
  // this thread's two fragment rows (16 rg + g, + 8): statistics in registers
  float mlog[2], invl[2], dlt[2];
  int qpos[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = rg * 16 + g + 8 * h;
    const bool ok = t.valid(row);
    mlog[h] = ok ? m_in[t.stat(row)] * kLog2e : 0.f;
    invl[h] = ok ? 1.f / fmaxf(l_in[t.stat(row)], 1e-30f) : 0.f;
    qpos[h] = ok ? t.pos(row) : -1;
  }
  tc::cp_async_wait<kDqAhead>();   // Q and dO have landed
  __syncthreads();
#pragma unroll
  for (int h = 0; h < 2; ++h) dlt[h] = dsm[rg * 16 + g + 8 * h];
  float dqa[DK / 2];
#pragma unroll
  for (int i = 0; i < DK / 2; ++i) dqa[i] = 0.f;
  const float sl2 = scale * kLog2e;

  for (int j = 0; j < ntiles; ++j) {
    tc::cp_async_wait<kDqAhead - 1>();   // tile j has landed
    fence_async_smem();                  // for the tensor cores' reads
    __syncthreads();                     // and every warp is done with tile j - 1
    if (j + kDqAhead < ntiles) issue_kv(j + kDqAhead);   // into tile j - 1's buffer
    tc::cp_async_commit();
    const unsigned char* ks = ring + (j % kRing) * (S::kK + S::kV);
    const unsigned char* vs = ks + S::kK;
    // S = Q K^T and dP = dO V^T over the kv tile.
    // A fragments are loaded for each batch and fenced after its wait: ones
    // held in registers across tiles do not survive the loop.
    float sc[kBN / 2], dp[kBN / 2];
    if constexpr (kOneBatch) {
      uint32_t qa[Bk::kKD][4], da[Bv::kKD][4];
#pragma unroll
      for (int kk = 0; kk < Bk::kKD; ++kk) {
        lda_cm<DK>(qa[kk], qs, rg * 16, kk * 16);
        lda_cm<DV>(da[kk], dos, rg * 16, kk * 16);
      }
      tc::fence_regs<kBN / 2>(sc);
      tc::fence_regs<kBN / 2>(dp);
      tc::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < Bk::kKD; ++kk)
        tc::wgmma_bf16<kBN, 0>(sc, qa[kk], desc_kmajor<DK>(ks, 0, kk), kk > 0);
#pragma unroll
      for (int kk = 0; kk < Bv::kKD; ++kk)
        tc::wgmma_bf16<kBN, 0>(dp, da[kk], desc_kmajor<DV>(vs, 0, kk), kk > 0);
      tc::wgmma_commit();
      tc::wgmma_wait();
      tc::fence_regs<kBN / 2>(sc);
      tc::fence_regs<kBN / 2>(dp);
      tc::fence_regs<Bk::kKD>(qa);
      tc::fence_regs<Bv::kKD>(da);
    } else {   // one operand's fragments at a time (registers)
      {
        uint32_t qa[Bk::kKD][4];
#pragma unroll
        for (int kk = 0; kk < Bk::kKD; ++kk) lda_cm<DK>(qa[kk], qs, rg * 16, kk * 16);
        tc::fence_regs<kBN / 2>(sc);
        tc::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < Bk::kKD; ++kk)
          tc::wgmma_bf16<kBN, 0>(sc, qa[kk], desc_kmajor<DK>(ks, 0, kk), kk > 0);
        tc::wgmma_commit();
        tc::wgmma_wait();
        tc::fence_regs<kBN / 2>(sc);
        tc::fence_regs<Bk::kKD>(qa);
      }
      uint32_t da[Bv::kKD][4];
#pragma unroll
      for (int kk = 0; kk < Bv::kKD; ++kk) lda_cm<DV>(da[kk], dos, rg * 16, kk * 16);
      tc::fence_regs<kBN / 2>(dp);
      tc::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < Bv::kKD; ++kk)
        tc::wgmma_bf16<kBN, 0>(dp, da[kk], desc_kmajor<DV>(vs, 0, kk), kk > 0);
      tc::wgmma_commit();
      tc::wgmma_wait();
      tc::fence_regs<kBN / 2>(dp);
      tc::fence_regs<Bv::kKD>(da);
    }
    // p = exp(round(S) scale - m) / l, ds = p (round(dP) - delta) scale
    const int kbase = j * kBN;
    const bool edge = kbase + kBN > skv || (causal && kbase + kBN - 1 > t.q0);
#pragma unroll
    for (int n = 0; n < kNS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e >> 1;
        const int kp = kbase + n * 8 + 2 * tq + (e & 1);
        float p = ex2(fmaf(round_bf16(sc[4 * n + e]), sl2, -mlog[h])) * invl[h];
        if (edge && (kp >= skv || (causal && kp > qpos[h]))) p = 0.f;
        dp[4 * n + e] = p * (round_bf16(dp[4 * n + e]) - dlt[h]) * scale;
      }
    // dQ += dS . K: K is the MN-major B operand (kv rows as K, d as N)
    uint32_t as[kNS / 2][4];
#pragma unroll
    for (int kq = 0; kq < kNS / 2; ++kq) acc_to_a(as[kq], dp, kq);
    tc::fence_regs<DK / 2>(dqa);
    tc::wgmma_fence();
#pragma unroll
    for (int kq = 0; kq < kNS / 2; ++kq) wgmma_mn<DK>(dqa, as[kq], ks, kq * 16);
    tc::wgmma_commit();
    tc::wgmma_wait();
    tc::fence_regs<DK / 2>(dqa);
    tc::fence_regs<kNS / 2>(as);
  }
  tc::cp_async_wait<0>();
  __syncthreads();   // every warp is done with Q: it stages dQ
#pragma unroll
  for (int n = 0; n < DK / 8; ++n) {
    const int row = rg * 16 + g, c = n * 8 + 2 * tq;
    put2<DK>(qs, row, c, dqa[4 * n], dqa[4 * n + 1]);
    put2<DK>(qs, row + 8, c, dqa[4 * n + 2], dqa[4 * n + 3]);
  }
  __syncthreads();
  store_rows_cm<DK>(dq, qs, kRows, q_row);
}

template <int D>
struct DkvTcSmem {
  using B = TcTile<D>;
  static constexpr size_t kKV = (size_t)B::kBNK * D * 2;                 // K or V tile
  static constexpr size_t kStage = 2 * (size_t)B::kTile + sizeof(float) * 3 * kRows;
  static constexpr size_t kBytes = 2 * kKV + (kDkvAhead + 1) * kStage;
  static_assert(kStage % 128 == 0, "stages keep the tiles 128-byte aligned");
};

// dK and dV for one kv tile, summed over every query tile at or after it
// and over the r heads of the group. Warp w takes kv rows 16 w .. + 16; its
// warpgroup computes S^T = K Q^T and dP^T = V dO^T for its 64 rows, so that
// P^T and dS^T come out of the accumulators as the A operands of
// dV += P^T dO and dK += dS^T Q.
template <int D>
__global__ void __launch_bounds__(2 * TcTile<D>::kBNK, 1)
flash_bwd_dkdv_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                         const bf16* __restrict__ v, const bf16* __restrict__ dout,
                         const float* __restrict__ stats, bf16* __restrict__ dk,
                         bf16* __restrict__ dv, int sq, int skv, int G, int r, int causal,
                         float scale) {
  using B = TcTile<D>;
  using S = DkvTcSmem<D>;
  constexpr int kBN = B::kBNK, kNQ = kRows / 8, kRing = kDkvAhead + 1;
  constexpr bool kOneBatch = D == 64;   // K and V fragments in registers together
  extern __shared__ __align__(128) unsigned char smem_tc[];
  unsigned char* ks = smem_tc;
  unsigned char* vs = ks + S::kKV;
  unsigned char* ring = vs + S::kKV;   // kRing x (Q, dO, delta, m log2 e, 1 / l)

  const int bi = static_cast<int>(blockIdx.y) / G, gi = static_cast<int>(blockIdx.y) % G;
  const int k0 = static_cast<int>(blockIdx.x) * kBN;   // tile 0, the heaviest, first
  const long long n_stat = static_cast<long long>(gridDim.y) * sq * r;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, tq = lane & 3;
  auto kv_row = [&](int j) {
    const int kp = k0 + j;
    return kp < skv ? ((static_cast<long long>(bi) * skv + kp) * G + gi) * D : -1LL;
  };
  load_rows_cm<D>(ks, k, kBN, kv_row);
  load_rows_cm<D>(vs, v, kBN, kv_row);
  tc::cp_async_commit();

  const int per = kRows / r;
  // causal: query positions before k0 see none of this tile
  const int q_first = causal ? (k0 / per) * per : 0;
  const int ntiles = q_first < sq ? (sq - q_first + per - 1) / per : 0;
  // this thread's Q/dO chunks and its statistics (of 3 x 64), mapped once
  constexpr int kThr = 2 * kBN, kQc = kRows * (D / 8) / kThr;
  constexpr int kSc = (3 * kRows + kThr - 1) / kThr;
  QChunks<kQc> qc;
  qc.template init<D>(tid, kThr, per, r);
  int st_pr[kSc], st_rr[kSc];
  bool st_ok[kSc];
#pragma unroll
  for (int u = 0; u < kSc; ++u) {
    const int i = tid + u * kThr, rho = i % kRows;
    st_pr[u] = rho / r;
    st_rr[u] = rho % r;
    st_ok[u] = i < 3 * kRows && rho < per * r;
  }
  auto issue_q = [&](int j) {
    unsigned char* st = ring + (j % kRing) * S::kStage;
    const int q0 = q_first + j * per;
    const long long head = static_cast<long long>(bi) * sq + q0;   // (bi, q0) position row
#pragma unroll
    for (int u = 0; u < kQc; ++u) {
      const bool ok = qc.ok[u] && q0 + qc.pr[u] < sq;
      const long long off = (((head + qc.pr[u]) * G + gi) * r + qc.rr[u]) * D + qc.c8[u] * 8;
      tc::cp_async16(st + qc.soff[u], ok ? q + off : q, ok);
      tc::cp_async16(st + B::kTile + qc.soff[u], ok ? dout + off : dout, ok);
    }
#pragma unroll
    for (int u = 0; u < kSc; ++u) {
      const int i = tid + u * kThr;
      if (i < 3 * kRows) {
        const bool ok = st_ok[u] && q0 + st_pr[u] < sq;
        const long long at = ((head + st_pr[u]) * G + gi) * r + st_rr[u];
        const float* src = stats + (i / kRows) * n_stat + (ok ? at : 0);
        tc::cp_async4(reinterpret_cast<float*>(st + 2 * B::kTile) + i, src, ok);
      }
    }
  };
#pragma unroll
  for (int j = 0; j < kDkvAhead; ++j) {
    if (j < ntiles) issue_q(j);
    tc::cp_async_commit();
  }

  const int w0 = warp * 16;        // this warp's kv rows in the tile
  const int kp_lo = k0 + w0 + g;   // the kv positions of its fragment rows: kp_lo, kp_lo + 8
  float dka[D / 2], dva[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dka[i] = dva[i] = 0.f;
  const float sl2 = scale * kLog2e;

  for (int j = 0; j < ntiles; ++j) {
    tc::cp_async_wait<kDkvAhead - 1>();   // tile j (and K, V) have landed
    fence_async_smem();
    __syncthreads();                      // every warp is done with tile j - 1
    if (j + kDkvAhead < ntiles) issue_q(j + kDkvAhead);   // into tile j - 1's buffer
    tc::cp_async_commit();
    const unsigned char* qs = ring + (j % kRing) * S::kStage;
    const unsigned char* dos = qs + B::kTile;
    const float* sts = reinterpret_cast<const float*>(dos + B::kTile);
    const int q0 = q_first + j * per;
    // S^T = K Q^T and dP^T = V dO^T for this warpgroup's 64 kv rows (the
    // K and V fragments loaded for each batch, as in the dQ kernel)
    float sc[kRows / 2], dp[kRows / 2];
    tc::fence_regs<kRows / 2>(sc);
    tc::fence_regs<kRows / 2>(dp);
    uint32_t ka[B::kKD][4], va[kOneBatch ? B::kKD : 1][4];
    if constexpr (kOneBatch) {
#pragma unroll
      for (int kk = 0; kk < B::kKD; ++kk) {
        lda_cm<D>(ka[kk], ks, w0, kk * 16);
        lda_cm<D>(va[kk], vs, w0, kk * 16);
      }
      tc::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < B::kKD; ++kk)
        tc::wgmma_bf16<kRows, 0>(sc, ka[kk], desc_kmajor<D>(qs, 0, kk), kk > 0);
#pragma unroll
      for (int kk = 0; kk < B::kKD; ++kk)
        tc::wgmma_bf16<kRows, 0>(dp, va[kk], desc_kmajor<D>(dos, 0, kk), kk > 0);
      tc::wgmma_commit();
      tc::wgmma_wait();
      tc::fence_regs<B::kKD>(ka);
      tc::fence_regs<B::kKD>(va);
    } else {   // one operand's fragments at a time (registers)
#pragma unroll
      for (int kk = 0; kk < B::kKD; ++kk) lda_cm<D>(ka[kk], ks, w0, kk * 16);
      tc::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < B::kKD; ++kk)
        tc::wgmma_bf16<kRows, 0>(sc, ka[kk], desc_kmajor<D>(qs, 0, kk), kk > 0);
      tc::wgmma_commit();
      tc::wgmma_wait();
      tc::fence_regs<kRows / 2>(sc);
      tc::fence_regs<B::kKD>(ka);
#pragma unroll
      for (int kk = 0; kk < B::kKD; ++kk) lda_cm<D>(ka[kk], vs, w0, kk * 16);
      tc::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < B::kKD; ++kk)
        tc::wgmma_bf16<kRows, 0>(dp, ka[kk], desc_kmajor<D>(dos, 0, kk), kk > 0);
      tc::wgmma_commit();
      tc::wgmma_wait();
      tc::fence_regs<B::kKD>(ka);
    }
    tc::fence_regs<kRows / 2>(sc);
    tc::fence_regs<kRows / 2>(dp);
    // column c of the accumulators is query row c of the tile
    const bool edge = (causal && k0 + kBN - 1 > q0) || q0 + per > sq || per * r < kRows;
#pragma unroll
    for (int n = 0; n < kNQ; ++n)
#pragma unroll
      for (int e2 = 0; e2 < 2; ++e2) {
        const int c = n * 8 + 2 * tq + e2;
        const float dlt = sts[c], mlog = sts[kRows + c], invl = sts[2 * kRows + c];
        int pos = q0;
        bool ok = true;
        if (edge) {
          pos = q0 + c / r;
          ok = c < per * r && pos < sq;
        }
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int e = 4 * n + 2 * h + e2;
          float p = ex2(fmaf(round_bf16(sc[e]), sl2, -mlog)) * invl;
          if (edge && (!ok || (causal && kp_lo + 8 * h > pos))) p = 0.f;
          sc[e] = p;
          dp[e] = p * (round_bf16(dp[e]) - dlt) * scale;
        }
      }
    // dV += P^T dO and dK += dS^T Q: dO and Q are the MN-major B operands
    uint32_t ap[kNQ / 2][4], ads[kNQ / 2][4];
#pragma unroll
    for (int kq = 0; kq < kNQ / 2; ++kq) {
      acc_to_a(ap[kq], sc, kq);
      acc_to_a(ads[kq], dp, kq);
    }
    tc::fence_regs<D / 2>(dva);
    tc::fence_regs<D / 2>(dka);
    tc::wgmma_fence();
#pragma unroll
    for (int kq = 0; kq < kNQ / 2; ++kq)
      tc::wgmma_bf16<D, 1>(dva, ap[kq], desc_mnmajor<D>(dos, kq * 16), 1);
#pragma unroll
    for (int kq = 0; kq < kNQ / 2; ++kq)
      tc::wgmma_bf16<D, 1>(dka, ads[kq], desc_mnmajor<D>(qs, kq * 16), 1);
    tc::wgmma_commit();
    tc::wgmma_wait();
    tc::fence_regs<D / 2>(dva);
    tc::fence_regs<D / 2>(dka);
    tc::fence_regs<kNQ / 2>(ap);
    tc::fence_regs<kNQ / 2>(ads);
  }
  tc::cp_async_wait<0>();
  __syncthreads();   // K and V tiles are free: they stage dK and dV
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    const int row = w0 + g, c = n * 8 + 2 * tq;
    put2<D>(ks, row, c, dka[4 * n], dka[4 * n + 1]);
    put2<D>(ks, row + 8, c, dka[4 * n + 2], dka[4 * n + 3]);
    put2<D>(vs, row, c, dva[4 * n], dva[4 * n + 1]);
    put2<D>(vs, row + 8, c, dva[4 * n + 2], dva[4 * n + 3]);
  }
  __syncthreads();
  store_rows_cm<D>(dk, ks, kBN, kv_row);
  store_rows_cm<D>(dv, vs, kBN, kv_row);
}

// ---- the dK/dV kernel at MLA's widths (DK 192, DV 128) ----
//
// One warpgroup cannot hold both sums for 64 kv rows here: dK (64 x 192) and
// dV (64 x 128) in fp32 take 160 registers a thread before S and dP. So the
// block's two warpgroups take the same 64 kv rows and split the work by
// product: warpgroup 0 computes S^T = K Q^T, p and dV += P^T dO; warpgroup 1
// computes dP^T = V dO^T, then ds from the p that warpgroup 0 hands over
// through shared memory (fp32, a thread's 32 values in its own slots: the
// two warpgroups' accumulator layouts agree thread for thread, so the
// hand-over is the identity), and dK += dS^T Q. Each product runs once, as
// in the one-warpgroup kernel, and each warpgroup holds one sum (dV's 64
// registers or dK's 96). A named barrier orders the hand-over; the block's
// barrier at the top of the loop keeps the next tile's p from overwriting
// one still being read.
template <int DK, int DV>
struct DkvSplitSmem {
  static constexpr int kBN = 64;                          // kv rows a block
  static constexpr size_t kK = (size_t)kBN * DK * 2, kV = (size_t)kBN * DV * 2;
  static constexpr size_t kP = sizeof(float) * kBN * kRows;   // p handed over
  static constexpr size_t kStage =
      (size_t)TcTile<DK>::kTile + TcTile<DV>::kTile + sizeof(float) * 3 * kRows;
  static constexpr size_t kBytes = kK + kV + kP + (kDkvAhead + 1) * kStage;
  static_assert(kStage % 128 == 0, "stages keep the tiles 128-byte aligned");
  static_assert(kBytes <= kMaxSmem, "one block's shared memory");
};

__device__ __forceinline__ void bar_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}
__device__ __forceinline__ void bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

template <int DK, int DV>
__global__ void __launch_bounds__(2 * kWgThreads, 1)
flash_bwd_dkdv_split_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                               const bf16* __restrict__ v, const bf16* __restrict__ dout,
                               const float* __restrict__ stats, bf16* __restrict__ dk,
                               bf16* __restrict__ dv, int sq, int skv, int G, int r, int causal,
                               float scale) {
  using S = DkvSplitSmem<DK, DV>;
  using Bk = TcTile<DK>;
  using Bv = TcTile<DV>;
  constexpr int kBN = S::kBN, kNQ = kRows / 8, kRing = kDkvAhead + 1, kThr = 2 * kWgThreads;
  constexpr int kHandOff = 1;   // the named barrier of the hand-over
  extern __shared__ __align__(128) unsigned char smem_tc[];
  unsigned char* ks = smem_tc;
  unsigned char* vs = ks + S::kK;
  float* pbuf = reinterpret_cast<float*>(vs + S::kV);
  unsigned char* ring = vs + S::kV + S::kP;   // kRing x (Q, dO, delta, m log2 e, 1 / l)

  const int bi = static_cast<int>(blockIdx.y) / G, gi = static_cast<int>(blockIdx.y) % G;
  const int k0 = static_cast<int>(blockIdx.x) * kBN;   // tile 0, the heaviest, first
  const long long n_stat = static_cast<long long>(gridDim.y) * sq * r;
  const int tid = threadIdx.x, wg = tid / kWgThreads, wtid = tid % kWgThreads;
  const int warp = wtid / 32, lane = tid % 32;
  const int g = lane >> 2, tq = lane & 3;
  auto kv = [&](int j) { return kv_index(bi, k0 + j, skv, G, gi); };
  auto k_row = [&](int j) { return kv(j) < 0 ? -1LL : kv(j) * DK; };
  auto v_row = [&](int j) { return kv(j) < 0 ? -1LL : kv(j) * DV; };
  load_rows_cm<DK>(ks, k, kBN, k_row);
  load_rows_cm<DV>(vs, v, kBN, v_row);
  tc::cp_async_commit();

  const int per = kRows / r;
  // causal: query positions before k0 see none of this tile
  const int q_first = causal ? (k0 / per) * per : 0;
  const int ntiles = q_first < sq ? (sq - q_first + per - 1) / per : 0;
  // this thread's Q and dO chunks and its statistic (3 x 64 <= kThr), mapped once
  constexpr int kQk = kRows * (DK / 8) / kThr, kQv = kRows * (DV / 8) / kThr;
  static_assert(kRows * (DK / 8) % kThr == 0 && kRows * (DV / 8) % kThr == 0 &&
                3 * kRows <= kThr, "whole chunks a thread");
  QChunks<kQk> qk;
  qk.template init<DK>(tid, kThr, per, r);
  QChunks<kQv> qv;
  qv.template init<DV>(tid, kThr, per, r);
  const int st_rho = tid % kRows, st_pr = st_rho / r, st_rr = st_rho % r;
  const bool st_has = tid < 3 * kRows, st_ok = st_has && st_rho < per * r;
  auto issue_q = [&](int j) {
    unsigned char* st = ring + (j % kRing) * S::kStage;
    const int q0 = q_first + j * per;
    const long long head = static_cast<long long>(bi) * sq + q0;   // (bi, q0) position row
#pragma unroll
    for (int u = 0; u < kQk; ++u) {
      const bool ok = qk.ok[u] && q0 + qk.pr[u] < sq;
      const long long off = (((head + qk.pr[u]) * G + gi) * r + qk.rr[u]) * DK + qk.c8[u] * 8;
      tc::cp_async16(st + qk.soff[u], ok ? q + off : q, ok);
    }
#pragma unroll
    for (int u = 0; u < kQv; ++u) {
      const bool ok = qv.ok[u] && q0 + qv.pr[u] < sq;
      const long long off = (((head + qv.pr[u]) * G + gi) * r + qv.rr[u]) * DV + qv.c8[u] * 8;
      tc::cp_async16(st + Bk::kTile + qv.soff[u], ok ? dout + off : dout, ok);
    }
    if (st_has) {
      const bool ok = st_ok && q0 + st_pr < sq;
      const long long at = ((head + st_pr) * G + gi) * r + st_rr;
      const float* src = stats + (tid / kRows) * n_stat + (ok ? at : 0);
      tc::cp_async4(reinterpret_cast<float*>(st + Bk::kTile + Bv::kTile) + tid, src, ok);
    }
  };
#pragma unroll
  for (int j = 0; j < kDkvAhead; ++j) {
    if (j < ntiles) issue_q(j);
    tc::cp_async_commit();
  }

  const int w0 = warp * 16;        // this warp's kv rows in the tile
  const int kp_lo = k0 + w0 + g;   // the kv positions of its fragment rows: kp_lo, kp_lo + 8
  float acc[DK / 2];               // warpgroup 0: dV (its first DV / 2); 1: dK
#pragma unroll
  for (int i = 0; i < DK / 2; ++i) acc[i] = 0.f;
  const float sl2 = scale * kLog2e;

  for (int j = 0; j < ntiles; ++j) {
    tc::cp_async_wait<kDkvAhead - 1>();   // tile j (and K, V) have landed
    fence_async_smem();
    __syncthreads();                      // every warp is done with tile j - 1 and its p
    if (j + kDkvAhead < ntiles) issue_q(j + kDkvAhead);   // into tile j - 1's buffer
    tc::cp_async_commit();
    const unsigned char* qs = ring + (j % kRing) * S::kStage;
    const unsigned char* dos = qs + Bk::kTile;
    const float* sts = reinterpret_cast<const float*>(dos + Bv::kTile);
    const int q0 = q_first + j * per;
    // column c of the accumulators is query row c of the tile
    const bool edge = (causal && k0 + kBN - 1 > q0) || q0 + per > sq || per * r < kRows;
    float sd[kRows / 2];
    if (wg == 0) {
      // S^T = K Q^T for the tile's 64 kv rows (K's fragments loaded each tile)
      {
        uint32_t ka[Bk::kKD][4];
#pragma unroll
        for (int kk = 0; kk < Bk::kKD; ++kk) lda_cm<DK>(ka[kk], ks, w0, kk * 16);
        tc::fence_regs<kRows / 2>(sd);
        tc::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < Bk::kKD; ++kk)
          tc::wgmma_bf16<kRows, 0>(sd, ka[kk], desc_kmajor<DK>(qs, 0, kk), kk > 0);
        tc::wgmma_commit();
        tc::wgmma_wait();
        tc::fence_regs<kRows / 2>(sd);
        tc::fence_regs<Bk::kKD>(ka);
      }
#pragma unroll
      for (int n = 0; n < kNQ; ++n)
#pragma unroll
        for (int e2 = 0; e2 < 2; ++e2) {
          const int c = n * 8 + 2 * tq + e2;
          const float mlog = sts[kRows + c], invl = sts[2 * kRows + c];
          int pos = q0;
          bool ok = true;
          if (edge) {
            pos = q0 + c / r;
            ok = c < per * r && pos < sq;
          }
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int e = 4 * n + 2 * h + e2;
            float p = ex2(fmaf(round_bf16(sd[e]), sl2, -mlog)) * invl;
            if (edge && (!ok || (causal && kp_lo + 8 * h > pos))) p = 0.f;
            sd[e] = p;
            pbuf[e * kWgThreads + wtid] = p;
          }
        }
      bar_arrive(kHandOff, kThr);
      // dV += P^T dO: dO is the MN-major B operand
      uint32_t ap[kNQ / 2][4];
#pragma unroll
      for (int kq = 0; kq < kNQ / 2; ++kq) acc_to_a(ap[kq], sd, kq);
      tc::fence_regs<DV / 2>(acc);
      tc::wgmma_fence();
#pragma unroll
      for (int kq = 0; kq < kNQ / 2; ++kq) wgmma_mn<DV>(acc, ap[kq], dos, kq * 16);
      tc::wgmma_commit();
      tc::wgmma_wait();
      tc::fence_regs<DV / 2>(acc);
      tc::fence_regs<kNQ / 2>(ap);
    } else {
      // dP^T = V dO^T for the same rows
      {
        uint32_t va[Bv::kKD][4];
#pragma unroll
        for (int kk = 0; kk < Bv::kKD; ++kk) lda_cm<DV>(va[kk], vs, w0, kk * 16);
        tc::fence_regs<kRows / 2>(sd);
        tc::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < Bv::kKD; ++kk)
          tc::wgmma_bf16<kRows, 0>(sd, va[kk], desc_kmajor<DV>(dos, 0, kk), kk > 0);
        tc::wgmma_commit();
        tc::wgmma_wait();
        tc::fence_regs<kRows / 2>(sd);
        tc::fence_regs<Bv::kKD>(va);
      }
      bar_sync(kHandOff, kThr);   // warpgroup 0's p of this tile is in pbuf
#pragma unroll
      for (int n = 0; n < kNQ; ++n)
#pragma unroll
        for (int e2 = 0; e2 < 2; ++e2) {
          const float dlt = sts[n * 8 + 2 * tq + e2];
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int e = 4 * n + 2 * h + e2;
            sd[e] = pbuf[e * kWgThreads + wtid] * (round_bf16(sd[e]) - dlt) * scale;
          }
        }
      // dK += dS^T Q: Q is the MN-major B operand
      uint32_t ads[kNQ / 2][4];
#pragma unroll
      for (int kq = 0; kq < kNQ / 2; ++kq) acc_to_a(ads[kq], sd, kq);
      tc::fence_regs<DK / 2>(acc);
      tc::wgmma_fence();
#pragma unroll
      for (int kq = 0; kq < kNQ / 2; ++kq) wgmma_mn<DK>(acc, ads[kq], qs, kq * 16);
      tc::wgmma_commit();
      tc::wgmma_wait();
      tc::fence_regs<DK / 2>(acc);
      tc::fence_regs<kNQ / 2>(ads);
    }
  }
  tc::cp_async_wait<0>();
  __syncthreads();   // K and V tiles are free: they stage dK and dV
  if (wg == 0) {
#pragma unroll
    for (int n = 0; n < DV / 8; ++n) {
      const int row = w0 + g, c = n * 8 + 2 * tq;
      put2<DV>(vs, row, c, acc[4 * n], acc[4 * n + 1]);
      put2<DV>(vs, row + 8, c, acc[4 * n + 2], acc[4 * n + 3]);
    }
  } else {
#pragma unroll
    for (int n = 0; n < DK / 8; ++n) {
      const int row = w0 + g, c = n * 8 + 2 * tq;
      put2<DK>(ks, row, c, acc[4 * n], acc[4 * n + 1]);
      put2<DK>(ks, row + 8, c, acc[4 * n + 2], acc[4 * n + 3]);
    }
  }
  __syncthreads();
  store_rows_cm<DK>(dk, ks, kBN, k_row);
  store_rows_cm<DV>(dv, vs, kBN, v_row);
}

// stats: scratch of 3 x (b, sq, g, r) fp32 from the wrapper.
template <int DK, int DV>
cudaError_t launch_bwd_tc(const void* q, const void* k, const void* v, const void* out,
                          const void* dout, const void* m, const void* l, void* stats,
                          void* dq, void* dk, void* dv, int b, int sq, int skv, int G, int r,
                          int causal, float scale, cudaStream_t stream) {
  auto dq_kernel = flash_bwd_dq_tc_kernel<DK, DV>;
  cudaError_t err = sct::allow_smem(dq_kernel, DqTcSmem<DK, DV>::kBytes);
  if (err != cudaSuccess) return err;
  const int per = kRows / r;
  dq_kernel<<<dim3((sq + per - 1) / per, b * G), kWgThreads, DqTcSmem<DK, DV>::kBytes,
              stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(out), static_cast<const bf16*>(dout),
      static_cast<const float*>(m), static_cast<const float*>(l), static_cast<float*>(stats),
      static_cast<bf16*>(dq), sq, skv, G, r, causal, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  if constexpr (DK == DV) {
    auto dkdv_kernel = flash_bwd_dkdv_tc_kernel<DK>;
    err = sct::allow_smem(dkdv_kernel, DkvTcSmem<DK>::kBytes);
    if (err != cudaSuccess) return err;
    const int kBN = TcTile<DK>::kBNK;
    dkdv_kernel<<<dim3((skv + kBN - 1) / kBN, b * G), 2 * kBN, DkvTcSmem<DK>::kBytes,
                  stream>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
        static_cast<const bf16*>(dout), static_cast<const float*>(stats),
        static_cast<bf16*>(dk), static_cast<bf16*>(dv), sq, skv, G, r, causal, scale);
  } else {
    using Sp = DkvSplitSmem<DK, DV>;
    auto dkdv_kernel = flash_bwd_dkdv_split_tc_kernel<DK, DV>;
    err = sct::allow_smem(dkdv_kernel, Sp::kBytes);
    if (err != cudaSuccess) return err;
    dkdv_kernel<<<dim3((skv + Sp::kBN - 1) / Sp::kBN, b * G), 2 * kWgThreads, Sp::kBytes,
                  stream>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
        static_cast<const bf16*>(dout), static_cast<const float*>(stats),
        static_cast<bf16*>(dk), static_cast<bf16*>(dv), sq, skv, G, r, causal, scale);
  }
  return cudaGetLastError();
}

// (q/k width, v width): (64, 64), (128, 128) and MLA's (192, 128)
bool shape_ok(int b, int sq, int skv, int G, int r, int dk, int dv) {
  const bool widths = (dk == 64 && dv == 64) || (dk == 128 && dv == 128) ||
                      (dk == 192 && dv == 128);
  return b > 0 && sq > 0 && skv > 0 && G > 0 && r > 0 && r <= kRows && widths;
}

}  // namespace

// fp32: 64-row kv tiles at (64, 64), 32-row at (128, 128) and (192, 128)
// (shared memory); bf16: four 64-row query tiles a block at (64, 64), one
// at (128, 128), two at (192, 128).
extern "C" int sct_flash_attention_fwd(const void* q, const void* k, const void* v, void* out,
                                       void* m, void* l, int b, int sq, int skv, int G, int r,
                                       int dk, int dv, int causal, int dtype, float scale,
                                       void* stream) {
  if (!shape_ok(b, sq, skv, G, r, dk, dv)) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == sct::kBFloat16) {   // the tensor-core kernel
    if (dk == 64)
      return launch_fwd_tc<64, 64, 4>(q, k, v, out, m, l, b, sq, skv, G, r, causal, scale, st);
    if (dk == 128)
      return launch_fwd_tc<128, 128, 1>(q, k, v, out, m, l, b, sq, skv, G, r, causal, scale,
                                        st);
    return launch_fwd_tc<192, 128, 2>(q, k, v, out, m, l, b, sq, skv, G, r, causal, scale, st);
  }
  if (dtype == sct::kFloat32) {
    if (dk == 64)
      return launch_fwd<float, 64, 64, 64>(q, k, v, out, m, l, b, sq, skv, G, r, causal, scale,
                                           st);
    if (dk == 128)
      return launch_fwd<float, 128, 128, 32>(q, k, v, out, m, l, b, sq, skv, G, r, causal,
                                             scale, st);
    return launch_fwd<float, 192, 128, 32>(q, k, v, out, m, l, b, sq, skv, G, r, causal,
                                           scale, st);
  }
  return cudaErrorInvalidValue;
}

// delta: scratch from the wrapper, 3 x (b, sq, g, r) fp32 (the fp32 kernels use
// the first (b, sq, g, r): delta; the bf16 ones all three, kernels/flash_attention.py).
extern "C" int sct_flash_attention_bwd(const void* q, const void* k, const void* v,
                                       const void* out, const void* dout, const void* m,
                                       const void* l, void* delta, void* dq, void* dk,
                                       void* dv, int b, int sq, int skv, int G, int r, int dkw,
                                       int dvw, int causal, int dtype, float scale,
                                       void* stream) {
  if (!shape_ok(b, sq, skv, G, r, dkw, dvw)) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == sct::kBFloat16) {   // the tensor-core kernels
    if (dkw == 64)
      return launch_bwd_tc<64, 64>(q, k, v, out, dout, m, l, delta, dq, dk, dv, b, sq, skv, G,
                                   r, causal, scale, st);
    if (dkw == 128)
      return launch_bwd_tc<128, 128>(q, k, v, out, dout, m, l, delta, dq, dk, dv, b, sq, skv,
                                     G, r, causal, scale, st);
    return launch_bwd_tc<192, 128>(q, k, v, out, dout, m, l, delta, dq, dk, dv, b, sq, skv, G,
                                   r, causal, scale, st);
  }
  if (dtype == sct::kFloat32) {
    if (dkw == 64)
      return launch_bwd<float, 64, 64, 64>(q, k, v, out, dout, m, l, delta, dq, dk, dv, b, sq,
                                           skv, G, r, causal, scale, st);
    if (dkw == 128)
      return launch_bwd<float, 128, 128, 32>(q, k, v, out, dout, m, l, delta, dq, dk, dv, b,
                                             sq, skv, G, r, causal, scale, st);
    return launch_bwd<float, 192, 128, 32>(q, k, v, out, dout, m, l, delta, dq, dk, dv, b, sq,
                                           skv, G, r, causal, scale, st);
  }
  return cudaErrorInvalidValue;
}
