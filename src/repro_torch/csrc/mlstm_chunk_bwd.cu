// Backward of the chunkwise stabilised mLSTM (csrc/mlstm_chunk.cu) for
// Hopper: the gradients of q, k, v, the gate pre-activations and the
// initial state, given those of y and of the final state (C, n, m).
//
// The TPU side has no kernel to replace here: the JAX package
// differentiates the lax.scan of its jnp chunk body (nn/xlstm.py:59-136,
// the body nn/xlstm.py:_mlstm_chunk_body), and its Pallas forward
// (kernels/mlstm_chunk.py:mlstm_chunk_pallas) has no backward. This kernel
// is added so that training never runs the plain version on the card; the
// plain version is kernels/mlstm_ref.py:mlstm_chunk_bwd_ref, which runs
// the same algorithm in torch ops.
//
// Per chunk of T tokens (the forward's chunks: 256, the last one ragged),
// with b the log-forget prefix sums, logD_tj = b_t - b_j + i_j (j <= t),
// inter_t = b_t + m0, M_t = max(inter_t, max_j logD_tj), w = exp(logD - M),
// e = exp(inter - M), S = q k^T, P = w S, den_raw = sum_j P + e q.n0,
// den = max(|den_raw|, exp(-M)), y = num / den:
//   dnum_t = dy_t / den_t, dden_t = -(dy_t . y_t) / den_t, split between
//   |den_raw| and exp(-M) as autograd splits max (half each at a tie);
//   dP_tj = dnum_t . v_j + dden_raw_t, computed as (dy_t . v_j - dy_t . y_t)
//   / den_t with both dots summed in fp64 and rounded once (they cancel
//   where a row's weight sits on one token); dS = dP w, G = dP P;
//   dq = dS k + e (C0 dnum + dden_raw n0), dk = dS^T q + wa (dC1 v + dn1),
//   dv = P^T dnum + wa (dC1^T k), dC0 = decay0 dC1 + sum_t e_t q_t dnum_t^T;
//   e's gradient times e is q_t . (dq's carried-state term); M's gradient
//   (the clamp's, minus G's row sum and e's) and the end state's m's
//   (dm1 - sum_j da_j - ddecay0 decay0) go to their argmax, split evenly
//   among ties, as autograd does; the log-forget gradient is summed back
//   over the chunk in fp64, as the forward sums it.
// Every sum runs in a fixed order (no atomics): two calls give the same bits.
//
// Launches, in order on the caller's stream (one call, counted once):
//   1. states: the forward's state kernel (csrc/mlstm_chunk.cu,
//      sct_mlstm_states) records every chunk's starting (C, n, m): the
//      reverse sweep needs them, and recomputing them costs one state pass
//      (T dh^2 a chunk and head) where keeping them from the forward would
//      hold B nc dh^2 floats a layer until its backward (512 MB at xlstm's
//      training shape, 3.6 GB for a remat period's seven layers); here they
//      live only during this call;
//   2. scores: S = q k^T and dy v^T for every chunk's lower triangle, 64 x 64
//      tiles with the whole dh reduction in the block, summed in fp64 on the
//      fp64 tensor cores (mma.m16n8k8);
//   3. rows: four blocks a chunk, a warp a row: the stabilisers, den, and
//      the rows of dS and P / den written over S and dy v^T (zeros above the
//      diagonal), G's row sums and the blocks' shares of its column sums;
//   4. dstate: the reverse sweep of dC over the chunks, a block a 128 x 128
//      tile held in wgmma accumulators, recording every chunk's dC1 and dn1
//      and <dC1, C0> + <dn1, n0>; the update q dnum^T on the tensor cores;
//   5. inputs: dq, dk and dv, 128 x 128 tiles, each the carried state's
//      product and then the chunk's triangle product in one chain of stages
//      on the tensor cores, with the per-row dots the gates need;
//   6. gates: one block a head, walking the chunks in reverse: the argmax
//      routing, the m chain, the fp64 suffix sums, di and df.
//
// What bounds it: operations. Per chunk and head, with T tokens and the
// causal pairs p = T (T + 1) / 2: the two score products (S, dy v^T: 2 p
// dh multiply-adds), the three triangle products (dS k, dS^T q, P^T dnum: 3
// p dh), the carried state's four (q dnum^T into dC, C0 dnum, dC1 v, dC1^T
// k: 4 T dh^2, where C0 and dC1 are not empty) and the state pass's one (T
// dh^2, all chunks but the last). At xlstm-1.3b's training shape (B = 2 x 4
// heads, S = 4096, dh = 1024, the empty state, no gradient of the final
// state) that is 3.7e11 flops: 5.45 ms at the fp32 rate of 67 TFLOP/s, and
// 2.37 ms at the rates of the passes this kernel makes (every product but
// the scores as three tf32 products at 495 TFLOP/s, the scores in fp64 at
// 67); the bytes (q, k, v, y, dy in, dq, dk, dv out) take 0.32 ms.
//
// Which unit runs what, and why:
//   * tensor cores in tf32, three products (3xTF32): the state pass (#9's
//     kernel), the dC update and all six products of the input gradients.
//     Each fp32 operand is split into a tf32 big and small part (22 of its
//     24 bits; the split on the integer pipe, which the conversion
//     instruction's rate would bound), and big . big + big . small + small
//     . big carry every product to ~2^-21. The tensor cores' own sums
//     truncate, so every 32-deep stage is summed from zero and added to the
//     fp32 tile once: the products' error stays that of fp32 arithmetic
//     (tests/test_torch_mlstm_bwd_geometry.py emulates both).
//   * wgmma (sm_90a), not mma.sync: a warpgroup takes 64 rows x 128 columns
//     (m64n128k8), A's parts from registers (each warp loads and splits its
//     own rows), B's from shared memory, split once a stage into the K-major
//     core layout that tf32 wgmma needs whatever the operand's orientation
//     in memory (the six products read A and B along k, m or n). The raw
//     rows of stage s + 3 are in flight (cp.async) and stage s + 1's B is
//     split between the k-steps of stage s's products.
//   * fp64 tensor cores: the two score products, summed exactly enough to be
//     rounded once, as the plain version sums them.
//   * CUDA cores: the rows, the gates, dn and the per-row dots, in fp32 (the
//     gates' suffix sums in fp64).
// A carried-state product whose factor is zero by construction is skipped
// (kernels/mlstm_chunk.py:bwd_plan, tested on the CPU): chunk 0's C0 without
// a state (dq's dy C0^T and the update only dC0 reads), the last chunk's dC1
// without a gradient of the final C (dk's v dC1^T, dv's k dC1); it would add
// exact zeros.
#include <type_traits>

#include "common.cuh"
#include "mlstm.cuh"
#include "mma.cuh"

extern "C" int sct_mlstm_states(const void* k, const void* v, const void* i_pre,
                                const void* f_pre, const void* C0, const void* n0,
                                const void* m0, void* C_hist, void* n_hist, void* mprev, int B,
                                int S, int dh, void* stream);

namespace {

using sct::mlstm::block_max;
using sct::mlstm::chunk_stats;
using sct::mlstm::split_tf32_int;
using sct::mlstm::wgmma_tf32_n128;
using sct::mma::cp_async16;
using sct::mma::cp_async_commit;
using sct::mma::cp_async_wait;
using sct::mma::fence_regs;
using sct::mma::wgmma_commit;
using sct::mma::wgmma_desc;
using sct::mma::wgmma_fence;
using sct::mma::wgmma_wait;

constexpr int kT = 256;         // chunk length (the forward's)
constexpr int kThreads = 256;   // every kernel: a token of a chunk a thread in the statistics
constexpr int kST = 64;         // score tile
constexpr int kSK = 32;         // dims a score stage holds
constexpr int kCT = 128;        // dC tile: dh rows and value columns
constexpr int kGT = 128;        // gradient tile: rows and columns
constexpr int kKS = 32;         // reduction depth a tensor-core stage holds
constexpr int kRowSplit = 4;    // blocks that share a chunk's rows in the rows pass
constexpr int kMaxDh = 1024;
constexpr float kNegInit = -1e30f;

// -inf: where a row's max starts
__device__ __forceinline__ float neg_inf() { return __int_as_float(0xff800000); }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// sum over the block of v (every thread passes one value), in a fixed
// order; fsc: kThreads / 32 floats
__device__ __forceinline__ float block_sum(float v, float* fsc) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  v = warp_sum(v);
  if (lane == 0) fsc[warp] = v;
  __syncthreads();
  float s = fsc[0];
  for (int w = 1; w < kThreads / 32; ++w) s += fsc[w];
  __syncthreads();
  return s;
}

// autograd's split of max(x, y)'s gradient: the share that goes to x
__device__ __forceinline__ float share_of(float x, float y) {
  return x > y ? 1.f : (x == y ? 0.5f : 0.f);
}

// ---------------------------------------------------------------- scores --
// c (16 x 8 fp64) += a (16 x 8, row) . b (8 x 8, col) on the fp64 tensor
// cores (sm_90's m16n8k8: twice m8n8k4's rate); lane 4 g + t holds a =
// {A[g][t], A[g+8][t], A[g][t+4], A[g+8][t+4]}, b = {B[t][g], B[t+4][g]}, c
// = {C[g][2t], C[g][2t+1], C[g+8][2t], C[g+8][2t+1]}
__device__ __forceinline__ void mma_f64(double* c, const double* a, double b0, double b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f64.f64.f64.f64 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+d"(c[0]), "+d"(c[1]), "+d"(c[2]), "+d"(c[3])
      : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(b0), "d"(b1));
}

// buf[b][c][t][j] = sum over dh of a[t] . bm[j] for the 64 x 64 tiles (ti >=
// tj) of chunk c's lower triangle: blockIdx.y 0 takes (q, k) into sbuf, 1
// takes (dy, v) into pbuf. The sums run in fp64 (mma.m16n8k8 on the fp64
// tensor cores) and are rounded once: the products of fp32 values are
// exact there, so any order of the sum rounds to the same fp32 value (dP =
// (dy . v - dy . y) / den cancels where a row's weight sits on one token,
// and then takes no error from the order). grid (chunks * 10, 2, B); a block
// past its chunk's rows returns. Rows of both operands stream through two
// cp.async stages of 32 dims (rows 36 floats apart: a warp's fragment reads
// fall on 32 distinct banks); warp (wm, wn) holds rows 32 wm .. + 32 and
// columns 16 wn .. + 16 as 2 x 2 accumulator tiles.
__global__ void __launch_bounds__(kThreads)
bwd_scores_kernel(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ dy, const float* __restrict__ v,
                  float* __restrict__ sbuf, float* __restrict__ pbuf, int S, int dh, int nc) {
  __shared__ __align__(16) float as[2][kST][kSK + 4];
  __shared__ __align__(16) float bs[2][kST][kSK + 4];
  const int c = blockIdx.x / 10, which = blockIdx.y, b = blockIdx.z, tid = threadIdx.x;
  int ti = 0, rest = blockIdx.x % 10;
  while (rest > ti) rest -= ++ti;
  const int tj = rest;
  const int t0 = c * kT, tc = min(kT, S - t0);
  if (ti * kST >= tc) return;
  const float* A = which ? dy : q;
  const float* Bm = which ? v : k;
  const int lane = tid & 31, warp = tid >> 5, g = lane >> 2, t4 = lane & 3;
  const int wm = warp >> 2, wn = warp & 3;
  const int rq = ti * kST, rk = tj * kST;
  const size_t row0 = (size_t)b * S + t0;
  auto stage = [&](int d0, int buf) {
    for (int e = tid; e < 2 * kST * kSK / 4; e += kThreads) {
      const bool is_b = e >= kST * kSK / 4;
      const int f = is_b ? e - kST * kSK / 4 : e;
      const int r = f / (kSK / 4), d4 = 4 * (f % (kSK / 4));
      const int row = (is_b ? rk : rq) + r;
      const bool ok = row < tc;
      const float* src = (is_b ? Bm : A) + (ok ? (row0 + row) * dh + d0 + d4 : 0);
      cp_async16(is_b ? &bs[buf][r][d4] : &as[buf][r][d4], src, ok);
    }
  };
  double acc[2][2][4] = {};
  const int nst = dh / kSK;                    // dh is a multiple of 32
  stage(0, 0);
  cp_async_commit();
  for (int st = 0; st < nst; ++st) {
    const int buf = st & 1;
    if (st + 1 < nst) stage((st + 1) * kSK, buf ^ 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kSK; kk += 8) {
      double bv[2][2];
#pragma unroll
      for (int ni = 0; ni < 2; ++ni) {
        const int n = 16 * wn + 8 * ni + g;
        bv[ni][0] = bs[buf][n][kk + t4];
        bv[ni][1] = bs[buf][n][kk + t4 + 4];
      }
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        const int m = 32 * wm + 16 * mi + g;
        const double av[4] = {as[buf][m][kk + t4], as[buf][m + 8][kk + t4],
                              as[buf][m][kk + t4 + 4], as[buf][m + 8][kk + t4 + 4]};
#pragma unroll
        for (int ni = 0; ni < 2; ++ni) mma_f64(acc[mi][ni], av, bv[ni][0], bv[ni][1]);
      }
    }
    __syncthreads();
  }
  float* out = (which ? pbuf : sbuf) + ((size_t)b * nc + c) * kT * kT;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 2; ++ni)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        *reinterpret_cast<float2*>(out + (size_t)(rq + 32 * wm + 16 * mi + g + 8 * h) * kT + rk +
                                   16 * wn + 8 * ni + 2 * t4) =
            make_float2(static_cast<float>(acc[mi][ni][2 * h]),
                        static_cast<float>(acc[mi][ni][2 * h + 1]));
}

// ------------------------------------------------------------------ rows --
// grid (chunks, B, kRowSplit): block (c, b, r) takes the rows t = r mod
// kRowSplit of chunk c, warp w the rows r + kRowSplit (w + 8 i). In: sbuf
// = q k^T, pbuf = dy v^T. Out: sbuf = dS, pbuf = P / den (both 0 for j >
// t), and per token ce = e / den, ud = e dden_raw, rowg = sum_j G, dmf =
// the clamp's share of M's gradient, gi[r] = the block's share of sum_t G
// (the column sums: the gates kernel adds the kRowSplit shares in order);
// by the blocks r = 0, wa (the end state's weights) and per chunk decay0.
__global__ void __launch_bounds__(kThreads)
bwd_rows_kernel(const float* __restrict__ q, const float* __restrict__ y,
                const float* __restrict__ dy, const float* __restrict__ i_pre,
                const float* __restrict__ f_pre, const float* __restrict__ n_hist,
                const float* __restrict__ mprev, float* __restrict__ sbuf,
                float* __restrict__ pbuf, float* __restrict__ ce, float* __restrict__ ud,
                float* __restrict__ rowg, float* __restrict__ dmf, float* __restrict__ gi,
                float* __restrict__ wa, float* __restrict__ decay, int S, int dh) {
  __shared__ float bc[kT], ii[kT];
  __shared__ double dsc[kThreads / 32];
  __shared__ float fsc[kThreads / 32];
  __shared__ float ns[kMaxDh];
  __shared__ float colp[kThreads / 32][kT];
  const int c = blockIdx.x, b = blockIdx.y, r = blockIdx.z, tid = threadIdx.x, lane = tid & 31;
  const int warp = tid >> 5, nc = gridDim.x;
  const int t0 = c * kT, tc = min(kT, S - t0);
  const size_t row0 = (size_t)b * S + t0, hist = (size_t)b * nc + c;
  for (int d = tid; d < dh; d += kThreads) ns[d] = n_hist[hist * dh + d];
#pragma unroll
  for (int w = 0; w < kThreads / 32; ++w) colp[w][tid] = 0.f;
  const float btot = chunk_stats(i_pre, f_pre, row0, tc, bc, ii, dsc);
  const float m0 = mprev[hist];
  // the end state's weights, as the forward's state pass computes them
  const float a_j = tid < tc ? (btot - bc[tid]) + ii[tid] : kNegInit;
  const float m_new = fmaxf(btot + m0, block_max(a_j, fsc));
  if (r == 0 && tid < tc) wa[row0 + tid] = expf(a_j - m_new);
  if (r == 0 && tid == 0) decay[hist] = expf((btot + m0) - m_new);

  float* sb = sbuf + hist * kT * kT;
  float* pb = pbuf + hist * kT * kT;
  for (int t = r + kRowSplit * warp; t < tc; t += kRowSplit * (kThreads / 32)) {
    const float bt = bc[t], inter = bt + m0;
    float* srow = sb + (size_t)t * kT;
    float* prow = pb + (size_t)t * kT;
    float mx = neg_inf();
    for (int j = lane; j <= t; j += 32) mx = fmaxf(mx, (bt - bc[j]) + ii[j]);
    const float M = fmaxf(inter, warp_max(mx));
    const float e = expf(inter - M), floor_m = expf(-M);
    const float* qr = q + (row0 + t) * dh;
    const float* yr = y + (row0 + t) * dh;
    const float* gr = dy + (row0 + t) * dh;
    double qn64 = 0.0, D64 = 0.0;         // rounded once, as the scores
    for (int d = lane; d < dh; d += 32) {
      qn64 = fma(static_cast<double>(qr[d]), static_cast<double>(ns[d]), qn64);
      D64 = fma(static_cast<double>(gr[d]), static_cast<double>(yr[d]), D64);
    }
    float ps = 0.f;
    for (int j = lane; j <= t; j += 32) ps += expf(((bt - bc[j]) + ii[j]) - M) * srow[j];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      qn64 += __shfl_xor_sync(0xffffffffu, qn64, o);
      D64 += __shfl_xor_sync(0xffffffffu, D64, o);
    }
    const float qn = static_cast<float>(qn64), D = static_cast<float>(D64);
    const float den_raw = warp_sum(ps) + e * qn;
    const float ad = fabsf(den_raw);
    const float den = fmaxf(ad, floor_m);
    const float dden = -D / den;
    const float to_abs = share_of(ad, floor_m);
    const float sgn = den_raw > 0.f ? 1.f : (den_raw < 0.f ? -1.f : 0.f);
    const float D_abs = D * to_abs * sgn;  // dP = sc (dy . v - D_abs)
    const float dden_raw = dden * to_abs * sgn;
    const float sc = 1.f / den;
    float rg = 0.f;
    for (int j = lane; j < kT; j += 32) {
      float ds = 0.f, pv = 0.f;
      if (j <= t) {
        const float w = expf(((bt - bc[j]) + ii[j]) - M);
        const float P = w * srow[j];
        const float dP = sc * (prow[j] - D_abs);
        const float G = dP * P;
        ds = dP * w;
        pv = P * sc;
        rg += G;
        colp[warp][j] += G;
      }
      srow[j] = ds;
      prow[j] = pv;
    }
    rg = warp_sum(rg);
    if (lane == 0) {
      ce[row0 + t] = e * sc;
      ud[row0 + t] = e * dden_raw;
      rowg[row0 + t] = rg;
      dmf[row0 + t] = -dden * (1.f - to_abs) * floor_m;
    }
  }
  __syncthreads();
  if (tid < tc) {
    float cg = colp[0][tid];
    for (int w = 1; w < kThreads / 32; ++w) cg += colp[w][tid];
    gi[(size_t)r * gridDim.y * S + row0 + tid] = cg;
  }
}

// ------------------------------------------------- 3xTF32 tiles, shared --
// A raw stage holds kKS depths of a 128-wide tile of one operand X, indexed
// (r, k) with r the tile's row (A's m, B's n) and k the reduction. kK: X(r,
// k) = X[r * ld + k] (k contiguous), staged s[r * kStrK + k - k0]; else X(r,
// k) = X[k * ld + r], staged s[(k - k0) * kStrMN + r]. A 16-byte piece is
// copied (cp.async) when its r < rvalid and its k < kvalid (at the piece's
// first element), else zero-filled. The strides put a warp's reads of (r0 +
// r % 8, k0 + k % 4) on 32 distinct banks in either layout: r * 36 + k = 4
// (r % 8) + k % 4, k * 136 + r = 8 (k % 4) + r % 8 (mod 32).
constexpr int kStrK = kKS + 4;
constexpr int kStrMN = kGT + 8;
constexpr int kStageFloats = kGT * kStrK > kKS * kStrMN ? kGT * kStrK : kKS * kStrMN;
constexpr int kRaw = 4;         // raw stages: s + 3 in flight while s, s + 1 and s + 2 wait
// B's split stage: the tf32 big or small parts of a raw stage, K-major for
// the tensor cores: core matrix (n / 8, k / 4), 8 rows x 4 k (16 bytes), at
// float 32 (16 (k / 4) + n / 8), its element (n % 8, k % 4) at + 4 (n % 8)
// + k % 4: k-neighbour cores kCoreLbo bytes apart, n-neighbours kCoreSbo; a
// k-step of 8 is two cores along k, 1024 floats
constexpr int kSplitFloats = kGT * kKS;
constexpr int kCoreLbo = 2048, kCoreSbo = 128;

template <bool kK>
__device__ __forceinline__ void stage_tile(float* s, const float* __restrict__ X, size_t ld,
                                           int rvalid, int k0, int kvalid) {
  for (int e = threadIdx.x; e < kGT * kKS / 4; e += kThreads) {
    const int r = kK ? e / (kKS / 4) : 4 * (e % (kGT / 4));
    const int kk = kK ? 4 * (e % (kKS / 4)) : e / (kGT / 4);
    const int k = k0 + kk;
    const bool ok = r < rvalid && k < kvalid;
    const float* src = ok ? X + (kK ? (size_t)r * ld + k : (size_t)k * ld + r) : X;
    cp_async16(kK ? s + r * kStrK + kk : s + kk * kStrMN + r, src, ok);
  }
}

template <bool kK>
__device__ __forceinline__ float staged(const float* s, int r, int k) {
  return kK ? s[r * kStrK + k] : s[k * kStrMN + r];
}

// A quarter of B's raw stage (orientation kK) split into its big and small
// tf32 parts in the K-major core layout: warp w takes cores 16 w + 4 q ..
// + 4, a lane an element of each (the writes on 128 contiguous bytes a
// core). The caller fences the writes for the tensor cores' reads
// (fence_async) before the barrier that hands the stage over.
template <bool kK>
__device__ __forceinline__ void split_b(float* big, float* small, const float* raw, int q) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, rn = lane >> 2, rk = lane & 3;
  constexpr int kCores = kGT * kKS / 32 / (kThreads / 32);
#pragma unroll
  for (int i = 0; i < kCores / 4; ++i) {
    const int core = warp * kCores + q * (kCores / 4) + i;
    uint32_t hi, lo;
    split_tf32_int(staged<kK>(raw, 8 * (core & 15) + rn, 4 * (core >> 4) + rk), hi, lo);
    big[32 * core + lane] = __uint_as_float(hi);
    small[32 * core + lane] = __uint_as_float(lo);
  }
}

__device__ __forceinline__ void fence_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// A stage's product for this warpgroup's 64 rows and all 128 columns, in
// part (from zero), per k-step small . big, big . small and big . big
// (3xTF32); A's parts in registers (a k-step a row of ab / as), B's in
// shared memory. wg_begin fences the registers, wg_step issues k-step
// kk's three products, wg_end commits and waits. The caller puts the next
// stage's loads and split between the steps (on the H100 that measured
// faster than issuing all twelve products first).
__device__ __forceinline__ void wg_begin(float* part, uint32_t (&ab)[kKS / 8][4],
                                         uint32_t (&as)[kKS / 8][4]) {
  fence_regs<64>(part);
  fence_regs<kKS / 8>(ab);
  fence_regs<kKS / 8>(as);
  wgmma_fence();
}

__device__ __forceinline__ void wg_step(float* part, const uint32_t* ab, const uint32_t* as,
                                        const float* big, const float* small, int kk) {
  const uint64_t db = wgmma_desc(big + 1024 * kk, kCoreLbo, kCoreSbo);
  const uint64_t ds = wgmma_desc(small + 1024 * kk, kCoreLbo, kCoreSbo);
  wgmma_tf32_n128(part, as, db, kk > 0);
  wgmma_tf32_n128(part, ab, ds, 1);
  wgmma_tf32_n128(part, ab, db, 1);
}

__device__ __forceinline__ void wg_end(float* part, uint32_t (&ab)[kKS / 8][4],
                                       uint32_t (&as)[kKS / 8][4]) {
  wgmma_commit();
  wgmma_wait();
  fence_regs<64>(part);
  fence_regs<kKS / 8>(ab);
  fence_regs<kKS / 8>(as);
}

// ---------------------------------------------------------------- dstate --
// grid (column tiles, row tiles, B): block (et, dt, b) owns dC[b][dt*128 ..
// +128, et*128 .. +128] and walks the chunks in reverse; warpgroup wg holds
// rows 64 wg .. + 64 and all 128 columns in the wgmma accumulator layout
// (element 4 j + e of warp w, lane 4 g + t: row 64 wg + 16 w + g + 8 (e /
// 2), column 8 j + 2 t + e % 2). Before chunk c's update the block records
// dC1 (dC_hist), dn1 (dn_hist) and its share of <dC1, C_c> + <dn1, n_c>
// (dd_part[b][c][dt * nd + et]). The update dC = decay0 dC + sum_t (ce_t
// q_t) dy_t^T runs on the tensor cores (wgmma, 3xTF32), a 32-token stage at
// a time into a partial tile that is added to dC in fp32 (the tensor cores'
// own sums truncate, and dC is carried over every chunk). The stages run
// across the chunks' boundaries: stage s + 3's q and dy rows are in flight
// (cp.async) and stage s + 1's dy is split for the tensor cores while they
// run stage s; each warp takes its q fragments (times ce) into registers.
// The blocks of the first column tile carry dn (fp32, a thread a dim, in
// token order). Chunk 0's update runs only for dC0.
struct alignas(128) DStateSmem {
  float big[2][kSplitFloats];         // dy split for the tensor cores
  float small[2][kSplitFloats];
  float qs[kRaw][kKS][kStrMN];        // q rows of a stage, this tile's dims
  float ys[kRaw][kKS][kStrMN];        // dy rows, this tile's columns
  float ce[kT];
  float ud[kT];
  float dns[kCT];
  float red[kThreads / 32];
};

__global__ void __launch_bounds__(kThreads, 1)
bwd_dstate_kernel(const float* __restrict__ q, const float* __restrict__ dy,
                  const float* __restrict__ ce, const float* __restrict__ ud,
                  const float* __restrict__ decay, const float* __restrict__ C_hist,
                  const float* __restrict__ n_hist, const float* __restrict__ dC_in,
                  const float* __restrict__ dn_in, float* __restrict__ dC_hist,
                  float* __restrict__ dn_hist, float* __restrict__ dd_part,
                  float* __restrict__ dC0, float* __restrict__ dn0, int S, int dh) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  DStateSmem& sm = *reinterpret_cast<DStateSmem*>(smem_raw);
  const int et = blockIdx.x, dt = blockIdx.y, b = blockIdx.z, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5, g = lane >> 2, t4 = lane & 3;
  const int m0 = 64 * (warp >> 2) + 16 * (warp & 3);     // this warp's first row
  const int nd = gridDim.x, nc = (S + kT - 1) / kT;
  const int d0 = dt * kCT, e0 = et * kCT;
  const bool keeps_n = et == 0;
  // the stages: chunk nc - 1's first, down to chunk c_lo's last
  const int c_lo = dC0 != nullptr ? 0 : 1;
  const int ns_last = (S - (nc - 1) * kT + kKS - 1) / kKS;
  const int n_stages = nc - 1 >= c_lo ? ns_last + (nc - 1 - c_lo) * (kT / kKS) : 0;
  auto issue = [&](int s) {
    const int c = s < ns_last ? nc - 1 : nc - 2 - (s - ns_last) / (kT / kKS);
    const int st = s < ns_last ? s : (s - ns_last) % (kT / kKS);
    const size_t row = (size_t)b * S + c * kT + st * kKS;
    const int tn = min(kT, S - c * kT) - st * kKS;
    stage_tile<false>(&sm.qs[s % kRaw][0][0], q + row * dh + d0, dh, dh - d0, 0, tn);
    stage_tile<false>(&sm.ys[s % kRaw][0][0], dy + row * dh + e0, dh, dh - e0, 0, tn);
  };
#pragma unroll
  for (int i = 0; i < kRaw - 1; ++i) {
    if (i < n_stages) issue(i);
    cp_async_commit();
  }

  float acc[64], part[64];
#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int d = d0 + m0 + g + 8 * (e >> 1), col = e0 + 8 * j + 2 * t4 + (e & 1);
      acc[4 * j + e] =
          dC_in && d < dh && col < dh ? dC_in[((size_t)b * dh + d) * dh + col] : 0.f;
    }
  if (keeps_n && tid < kCT)
    sm.dns[tid] = dn_in && d0 + tid < dh ? dn_in[(size_t)b * dh + d0 + tid] : 0.f;
  cp_async_wait<kRaw - 3>();                 // stages 0 and 1 in
  __syncthreads();
  if (n_stages > 0)
    for (int q4 = 0; q4 < 4; ++q4) split_b<false>(sm.big[0], sm.small[0], &sm.ys[0][0][0], q4);
  fence_async();
  __syncthreads();
  int s = 0;
  for (int c = nc - 1; c >= 0; --c) {
    const int t0 = c * kT, tc = min(kT, S - t0);
    const size_t row0 = (size_t)b * S + t0, hist = (size_t)b * nc + c;
    float dpart = 0.f;
#pragma unroll
    for (int j = 0; j < 16; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int d = d0 + m0 + g + 8 * h, col = e0 + 8 * j + 2 * t4;
        if (d < dh && col < dh) {
          const size_t o = (hist * dh + d) * dh + col;
          *reinterpret_cast<float2*>(dC_hist + o) =
              make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
          const float2 cv = *reinterpret_cast<const float2*>(C_hist + o);
          dpart = fmaf(acc[4 * j + 2 * h], cv.x, dpart);
          dpart = fmaf(acc[4 * j + 2 * h + 1], cv.y, dpart);
        }
      }
    if (keeps_n && tid < kCT && d0 + tid < dh) {
      dn_hist[hist * dh + d0 + tid] = sm.dns[tid];
      dpart = fmaf(sm.dns[tid], n_hist[hist * dh + d0 + tid], dpart);
    }
    dpart = warp_sum(dpart);
    if (lane == 0) sm.red[warp] = dpart;
    sm.ce[tid] = tid < tc ? ce[row0 + tid] : 0.f;
    sm.ud[tid] = tid < tc ? ud[row0 + tid] : 0.f;
    __syncthreads();
    if (tid == 0) {
      float x = sm.red[0];
      for (int w = 1; w < kThreads / 32; ++w) x += sm.red[w];
      dd_part[hist * nd * nd + dt * nd + et] = x;
    }
    if (c < c_lo) break;
    const float dec = decay[hist];
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] *= dec;
    float nacc = 0.f;
    for (int st = 0; st * kKS < tc; ++st, ++s) {
      // stage s: its q fragments (times ce) to registers; its products issued a
      // k-step at a time, stage s + kRaw - 1's rows sent for and stage s + 1's
      // dy split between them
      const float(*qs)[kStrMN] = sm.qs[s % kRaw];
      uint32_t ab[kKS / 8][4], as[kKS / 8][4];
#pragma unroll
      for (int kk = 0; kk < kKS / 8; ++kk) {
        const int k = 8 * kk + t4;
        const float c0 = sm.ce[st * kKS + k], c1 = sm.ce[st * kKS + k + 4];
        split_tf32_int(c0 * qs[k][m0 + g], ab[kk][0], as[kk][0]);
        split_tf32_int(c0 * qs[k][m0 + g + 8], ab[kk][1], as[kk][1]);
        split_tf32_int(c1 * qs[k + 4][m0 + g], ab[kk][2], as[kk][2]);
        split_tf32_int(c1 * qs[k + 4][m0 + g + 8], ab[kk][3], as[kk][3]);
      }
      wg_begin(part, ab, as);
#pragma unroll
      for (int kk = 0; kk < kKS / 8; ++kk) {
        wg_step(part, ab[kk], as[kk], sm.big[s & 1], sm.small[s & 1], kk);
        if (kk == 0 && s + kRaw - 1 < n_stages) issue(s + kRaw - 1);   // into stage s - 1's
        if (s + 1 < n_stages)
          split_b<false>(sm.big[(s + 1) & 1], sm.small[(s + 1) & 1], &sm.ys[(s + 1) % kRaw][0][0],
                         kk);
      }
      cp_async_commit();
      if (keeps_n && tid < kCT) {
        const int jn = min(kKS, tc - st * kKS);
        for (int j = 0; j < jn; ++j) nacc = fmaf(sm.ud[st * kKS + j], qs[j][tid], nacc);
      }
      wg_end(part, ab, as);
      fence_async();
#pragma unroll
      for (int i = 0; i < 64; ++i) acc[i] += part[i];
      cp_async_wait<kRaw - 3>();             // stage s + 2's rows are in
      __syncthreads();                       // stage s + 1 split; stage s's buffers read
    }
    if (keeps_n && tid < kCT) sm.dns[tid] = dec * sm.dns[tid] + nacc;
    __syncthreads();
  }
  if (dC0 != nullptr) {
#pragma unroll
    for (int j = 0; j < 16; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int d = d0 + m0 + g + 8 * h, col = e0 + 8 * j + 2 * t4;
        if (d < dh && col < dh)
          *reinterpret_cast<float2*>(dC0 + ((size_t)b * dh + d) * dh + col) =
              make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
      }
  }
  if (dn0 != nullptr && keeps_n && tid < kCT && d0 + tid < dh)
    dn0[(size_t)b * dh + d0 + tid] = sm.dns[tid];
}

// ---------------------------------------------------------------- inputs --
// grid (chunks * 2 row tiles * column tiles, 3, B): blockIdx.y 0 writes a
// 128 x 128 tile of dq (rows t, columns d), 1 of dk (rows j, columns d), 2
// of dv (rows j, columns e). Each tile is the carried state's product
// followed by the chunk's triangle product, one chain of kKS-deep stages,
// each operand staged in its own orientation:
//   dq: dy C0^T (A k-contiguous, B k-contiguous), then dS k over j < the
//       tile's last row (A k-, B n-contiguous);
//   dk: v dC1^T (k-, k-), then dS^T q over t >= the tile's first row (m-,
//       n-contiguous);
//   dv: k dC1 (k-, n-), then (P / den)^T dy over t >= the first row (m-,
//       n-).
// Every stage runs on the tensor cores (wgmma, 3xTF32): stage s + 3's rows
// are in flight (cp.async) and stage s + 1's B is split into the tensor
// cores' K-major layout while they run stage s; each warp takes its A
// fragments into registers. Warpgroup wg takes rows 64 wg .. + 64 and all
// 128 columns into a partial tile, added to the tile in fp32 (the tensor
// cores' own sums truncate). After the state product the tile becomes the
// carried state's term (dq: ce_t (dy C0^T) + ud_t n0; dk: wa_j (v dC1^T +
// dn1); dv: wa_j (k dC1)), and dq and dk write, for each row, the tile's
// share of q_t . (that term) (dint_part) and of k_j . (dk's) (da_part), one
// slot per column tile; the triangle's stages are added after. A state
// product whose factor is zero by construction (chunk 0's C0 without a
// state; the last chunk's dC1 without a gradient of the final C) is
// skipped: it would add exact zeros.
struct alignas(128) InputsSmem {
  float big[2][kSplitFloats];         // B split for the tensor cores
  float small[2][kSplitFloats];
  float a[kRaw][kStageFloats];        // raw stages
  float b[kRaw][kStageFloats];
};

struct InputsArgs {
  const float *q, *k, *v, *dy, *sbuf, *pbuf, *C_hist, *n_hist, *dC_hist, *dn_hist, *ce, *ud,
      *wa;
  float *dq, *dk, *dv, *dint_part, *da_part;
  int S, dh, has_state, has_dC;
};

// this warp's A fragments of a raw stage (rows m0 + g, m0 + g + 8), split
template <bool kK>
__device__ __forceinline__ void load_a(uint32_t (&ab)[kKS / 8][4], uint32_t (&as)[kKS / 8][4],
                                       const float* raw, int m0, int g, int t4) {
#pragma unroll
  for (int kk = 0; kk < kKS / 8; ++kk) {
    split_tf32_int(staged<kK>(raw, m0 + g, 8 * kk + t4), ab[kk][0], as[kk][0]);
    split_tf32_int(staged<kK>(raw, m0 + g + 8, 8 * kk + t4), ab[kk][1], as[kk][1]);
    split_tf32_int(staged<kK>(raw, m0 + g, 8 * kk + t4 + 4), ab[kk][2], as[kk][2]);
    split_tf32_int(staged<kK>(raw, m0 + g + 8, 8 * kk + t4 + 4), ab[kk][3], as[kk][3]);
  }
}

// kSA / kSB: the state product's A / B k-contiguous; kTA / kTB the triangle's
template <int kWhich, bool kSA, bool kSB, bool kTA, bool kTB>
__device__ __forceinline__ void inputs_tile(const InputsArgs& p, InputsSmem& sm) {
  const int dh = p.dh, S = p.S;
  const int ndt = (dh + kGT - 1) / kGT, nc = (S + kT - 1) / kT, nrt = kT / kGT;
  const int ct = blockIdx.x % ndt, rt = (blockIdx.x / ndt) % nrt, c = blockIdx.x / (ndt * nrt);
  const int b = blockIdx.z, tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3, m0 = 64 * (warp >> 2) + 16 * (warp & 3);
  const int t0 = c * kT, tc = min(kT, S - t0), r0 = rt * kGT, c0 = ct * kGT;
  if (r0 >= tc) return;
  const int mvalid = min(kGT, tc - r0), nvalid = dh - c0;
  const size_t row0 = (size_t)b * S + t0, hist = (size_t)b * nc + c;
  // the state product over dh, then the triangle: dq over j in [0, min(tc,
  // r0 + 128)), dk and dv over t in [r0, tc)
  const bool live = kWhich == 0 ? (p.has_state || c > 0) : (p.has_dC || c < nc - 1);
  const int tk0 = kWhich == 0 ? 0 : r0, tk1 = kWhich == 0 ? min(tc, r0 + kGT) : tc;
  const int ns = live ? dh / kKS : 0;
  const int ntot = ns + (tk1 - tk0 + kKS - 1) / kKS;
  // (the operands' addresses are rebuilt from p at each use: fewer live registers)
  auto issue = [&](int s) {
    float* as = sm.a[s % kRaw];
    float* bs = sm.b[s % kRaw];
    if (s < ns) {
      const float* sa = (kWhich == 0 ? p.dy : kWhich == 1 ? p.v : p.k) + (row0 + r0) * dh;
      const float* sb = kWhich == 0 ? p.C_hist + (hist * dh + c0) * dh
                      : kWhich == 1 ? p.dC_hist + (hist * dh + c0) * dh
                                    : p.dC_hist + hist * dh * dh + c0;
      stage_tile<kSA>(as, sa, dh, mvalid, s * kKS, dh);
      stage_tile<kSB>(bs, sb, dh, nvalid, s * kKS, dh);
    } else {
      const float* scores = (kWhich == 2 ? p.pbuf : p.sbuf) + hist * kT * kT;
      const float* ta = kWhich == 0 ? scores + (size_t)r0 * kT : scores + r0;
      const float* tb = (kWhich == 0 ? p.k : kWhich == 1 ? p.q : p.dy) + row0 * dh + c0;
      const int k0 = tk0 + (s - ns) * kKS;
      // dS's rows hold zeros past the diagonal up to kT: dq's A reads them
      stage_tile<kTA>(as, ta, kT, mvalid, k0, kWhich == 0 ? kT : tk1);
      stage_tile<kTB>(bs, tb, dh, nvalid, k0, tk1);
    }
  };
  auto split = [&](int s, int q4) {
    if (s < ns) split_b<kSB>(sm.big[s & 1], sm.small[s & 1], sm.b[s % kRaw], q4);
    else split_b<kTB>(sm.big[s & 1], sm.small[s & 1], sm.b[s % kRaw], q4);
  };
#pragma unroll
  for (int i = 0; i < kRaw - 1; ++i) {
    if (i < ntot) issue(i);
    cp_async_commit();
  }
  float acc[64], part[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;

  // the carried state's term over the tile, and the rows' dots for the gates
  // (a warp holds all 128 columns of its rows: four lanes a row)
  auto state_term = [&]() {
    const float* nvec = (kWhich == 0 ? p.n_hist : p.dn_hist) + hist * dh + c0;
    const float* x = (kWhich == 0 ? p.q : p.k) + (row0 + r0) * dh + c0;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = m0 + g + 8 * h;
      const bool row_ok = m < mvalid;
      const size_t tok = row0 + r0 + m;
      const float sr = row_ok ? (kWhich == 0 ? p.ce[tok] : p.wa[tok]) : 0.f;
      const float ur = row_ok && kWhich == 0 ? p.ud[tok] : 0.f;
      float dot = 0.f;
#pragma unroll
      for (int j = 0; j < 16; ++j)
#pragma unroll
        for (int x2 = 0; x2 < 2; ++x2) {
          const int n = 8 * j + 2 * t4 + x2;
          float& a = acc[4 * j + 2 * h + x2];
          if (!row_ok || n >= nvalid) {
            a = 0.f;
            continue;
          }
          if (kWhich == 0) a = sr * a + ur * nvec[n];
          else if (kWhich == 1) a = sr * (a + nvec[n]);
          else a = sr * a;
          if (kWhich < 2) dot = fmaf(x[(size_t)m * dh + n], a, dot);
        }
      if (kWhich < 2) {
        dot += __shfl_xor_sync(0xffffffffu, dot, 1);
        dot += __shfl_xor_sync(0xffffffffu, dot, 2);
        if (t4 == 0 && row_ok) (kWhich == 0 ? p.dint_part : p.da_part)[tok * ndt + ct] = dot;
      }
    }
  };
  cp_async_wait<kRaw - 3>();                 // stages 0 and 1 in
  __syncthreads();
  for (int q4 = 0; q4 < 4; ++q4) split(0, q4);
  fence_async();
  __syncthreads();
  // stage s: its A fragments to registers; its products issued a k-step at a
  // time, stage s + kRaw - 1's rows sent for and stage s + 1's B split
  // between them; the partial added in fp32 at the end of each stage
  auto stage = [&](int s, auto tri) {
    constexpr bool kTri = decltype(tri)::value;
    uint32_t ab[kKS / 8][4], as[kKS / 8][4];
    load_a<kTri ? kTA : kSA>(ab, as, sm.a[s % kRaw], m0, g, t4);
    wg_begin(part, ab, as);
#pragma unroll
    for (int kk = 0; kk < kKS / 8; ++kk) {
      wg_step(part, ab[kk], as[kk], sm.big[s & 1], sm.small[s & 1], kk);
      if (kk == 0 && s + kRaw - 1 < ntot) issue(s + kRaw - 1);   // into stage s - 1's buffers
      if (s + 1 < ntot) split(s + 1, kk);
    }
    cp_async_commit();
    wg_end(part, ab, as);
    fence_async();
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] += part[i];
    cp_async_wait<kRaw - 3>();               // stage s + 2's rows are in
    __syncthreads();                         // stage s + 1 split; stage s's buffers read
  };
  for (int s = 0; s < ns; ++s) stage(s, std::false_type{});
  state_term();
  for (int s = ns; s < ntot; ++s) stage(s, std::true_type{});
  float* out = (kWhich == 0 ? p.dq : kWhich == 1 ? p.dk : p.dv) + (row0 + r0) * dh + c0;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int m = m0 + g + 8 * h;
    if (m >= mvalid) continue;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int n = 8 * j + 2 * t4;
      if (n < nvalid)
        *reinterpret_cast<float2*>(out + (size_t)m * dh + n) =
            make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
    }
  }
}

__global__ void __launch_bounds__(kThreads, 1) bwd_inputs_kernel(const InputsArgs p) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  InputsSmem& sm = *reinterpret_cast<InputsSmem*>(smem_raw);
  if (blockIdx.y == 0) inputs_tile<0, true, true, true, false>(p, sm);
  else if (blockIdx.y == 1) inputs_tile<1, true, true, false, false>(p, sm);
  else inputs_tile<2, true, false, false, false>(p, sm);
}

// ----------------------------------------------------------------- gates --
// grid (B): one block a head walks the chunks in reverse, carrying the
// gradient of the chunk's starting m. Thread t takes row t (m_loc's argmax)
// and then column j = t (the argmax shares, the end state's weights).
__global__ void __launch_bounds__(kThreads)
bwd_gates_kernel(const float* __restrict__ i_pre, const float* __restrict__ f_pre,
                 const float* __restrict__ mprev, const float* __restrict__ rowg,
                 const float* __restrict__ gi, const float* __restrict__ dmf,
                 const float* __restrict__ dint_part, const float* __restrict__ da_part,
                 const float* __restrict__ dd_part, const float* __restrict__ dm_in,
                 float* __restrict__ di, float* __restrict__ df, float* __restrict__ dm0_out,
                 int S, int dh) {
  __shared__ float bc[kT], ii[kT], rmax[kT], rshare[kT], dbs[kT];
  __shared__ double dsc[kThreads / 32];
  __shared__ float fsc[kThreads / 32];
  const int b = blockIdx.x, tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nc = (S + kT - 1) / kT, ndt = (dh + kGT - 1) / kGT, nd = (dh + kCT - 1) / kCT;
  float dm1 = dm_in != nullptr ? dm_in[b] : 0.f;
  for (int c = nc - 1; c >= 0; --c) {
    const int t0 = c * kT, tc = min(kT, S - t0);
    const size_t row0 = (size_t)b * S + t0, hist = (size_t)b * nc + c;
    const float btot = chunk_stats(i_pre, f_pre, row0, tc, bc, ii, dsc);
    const float m0 = mprev[hist];
    // row t: M_t = max(inter_t, max_j logD_tj) takes dm_floor - rowG - e de
    float dinter = 0.f, rowsum = 0.f;
    if (tid < tc) {
      const float bt = bc[tid], inter = bt + m0;
      float R = neg_inf();
      for (int j = 0; j <= tid; ++j) R = fmaxf(R, (bt - bc[j]) + ii[j]);
      int cnt = 0;
      for (int j = 0; j <= tid; ++j) cnt += ((bt - bc[j]) + ii[j]) == R;
      float dint = 0.f;
      for (int x = 0; x < ndt; ++x) dint += dint_part[(row0 + tid) * ndt + x];
      const float rg = rowg[row0 + tid];
      const float dM = dmf[row0 + tid] - rg - dint;
      const float to_inter = share_of(inter, R);
      const float dR = dM * (1.f - to_inter);
      dinter = dint + dM * to_inter;
      rmax[tid] = R;
      rshare[tid] = dR / static_cast<float>(cnt);
      rowsum = rg + dR;                    // logD's row sum (G's and the argmax share)
    }
    __syncthreads();
    // column j: logD's column sum, and the end state's m
    float dcol = 0.f, da = 0.f, a_j = kNegInit;
    if (tid < tc) {
      const int j = tid;
      float cs = 0.f;
      for (int t = j; t < tc; ++t)
        if ((bc[t] - bc[j]) + ii[j] == rmax[t]) cs += rshare[t];
      float gs = gi[row0 + j];              // the row blocks' shares, in order
      for (int x = 1; x < kRowSplit; ++x) gs += gi[(size_t)x * gridDim.x * S + row0 + j];
      dcol = gs + cs;
      for (int x = 0; x < ndt; ++x) da += da_part[(row0 + j) * ndt + x];
      a_j = (btot - bc[j]) + ii[j];
    }
    const float amax = block_max(a_j, fsc);
    const float x0 = btot + m0, m1 = fmaxf(x0, amax);
    const float dec = expf(x0 - m1);
    float ddec = 0.f;
    for (int x = 0; x < nd * nd; ++x) ddec += dd_part[hist * nd * nd + x];
    const float dm1_all = dm1 - block_sum(da, fsc) - ddec * dec;
    const float to_x0 = share_of(x0, amax);
    const float dx0 = ddec * dec + dm1_all * to_x0;
    const float hit = tid < tc && a_j == amax ? 1.f : 0.f;
    const float n_hit = block_sum(hit, fsc);
    da += hit * (dm1_all * (1.f - to_x0) / n_hit);
    const float dbtot = block_sum(da, fsc) + dx0;
    dm1 = block_sum(dinter, fsc) + dx0;    // the gradient of this chunk's starting m
    // logD's row sum less its column sum first, as the plain version sums
    // them: at one token they cancel exactly and dinter keeps its bits
    float db = (rowsum - dcol) + dinter - da;
    if (tid == tc - 1) db += dbtot;
    if (tid < tc) {
      dbs[tid] = db;
      di[row0 + tid] = dcol + da;
    }
    __syncthreads();
    // d log f: suffix sums of db over the chunk, in fp64 (a prefix scan of
    // the reversed chunk), then log sigmoid's derivative sigmoid(-f)
    double x = tid < tc ? static_cast<double>(dbs[tc - 1 - tid]) : 0.0;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const double u = __shfl_up_sync(0xffffffffu, x, o);
      if (lane >= o) x += u;
    }
    if (lane == 31) dsc[warp] = x;
    __syncthreads();
    double base = 0.0;
    for (int w = 0; w < warp; ++w) base += dsc[w];
    if (tid < tc) {
      const size_t tok = row0 + tc - 1 - tid;
      df[tok] = static_cast<float>(base + x) * (1.f / (1.f + expf(f_pre[tok])));
    }
    __syncthreads();
  }
  if (dm0_out != nullptr && tid == 0) dm0_out[b] = dm1;
}

// floats of each scratch array (rounded up to 64, so every array starts
// 256-byte aligned)
inline size_t round64(size_t n) { return (n + 63) / 64 * 64; }

struct Workspace {
  float *C_hist, *dC_hist, *n_hist, *dn_hist, *mprev, *decay, *sbuf, *pbuf;
  float *ce, *ud, *rowg, *dmf, *gi, *wa, *dint_part, *da_part, *dd_part;
  size_t floats;
};

inline Workspace carve(float* base, int B, int S, int dh) {
  const size_t nc = (S + kT - 1) / kT, ndt = (dh + kGT - 1) / kGT, nd = (dh + kCT - 1) / kCT;
  const size_t Bs = B, tok = Bs * S;
  Workspace w;
  size_t off = 0;
  auto take = [&](size_t n) {
    float* p = base != nullptr ? base + off : nullptr;
    off += round64(n);
    return p;
  };
  w.C_hist = take(Bs * nc * dh * dh);
  w.dC_hist = take(Bs * nc * dh * dh);
  w.n_hist = take(Bs * nc * dh);
  w.dn_hist = take(Bs * nc * dh);
  w.mprev = take(Bs * nc);
  w.decay = take(Bs * nc);
  w.sbuf = take(Bs * nc * kT * kT);
  w.pbuf = take(Bs * nc * kT * kT);
  w.ce = take(tok);
  w.ud = take(tok);
  w.rowg = take(tok);
  w.dmf = take(tok);
  w.gi = take(tok * kRowSplit);
  w.wa = take(tok);
  w.dint_part = take(tok * ndt);
  w.da_part = take(tok * ndt);
  w.dd_part = take(Bs * nc * nd * nd);
  w.floats = off;
  return w;
}

}  // namespace

// Floats of scratch sct_mlstm_chunk_bwd needs for (B, S, dh).
extern "C" long long sct_mlstm_chunk_bwd_workspace(int B, int S, int dh) {
  if (B <= 0 || S <= 0 || dh <= 0) return 0;
  return static_cast<long long>(carve(nullptr, B, S, dh).floats);
}

// q, k, v, y, dy (B, S, dh); i_pre, f_pre (B, S); optional C0 (B, dh, dh),
// n0 (B, dh), m0 (B,) (all three or none) and optional dC, dn, dm of the
// final state (null: zero); all fp32, contiguous, q/k/v/dy/C0 16-byte
// aligned; dh a multiple of 32, at most 1024. Out: dq, dk, dv, di, df and,
// when C0 is given, dC0, dn0, dm0. ws: sct_mlstm_chunk_bwd_workspace floats.
extern "C" int sct_mlstm_chunk_bwd(const void* q, const void* k, const void* v,
                                   const void* i_pre, const void* f_pre, const void* C0,
                                   const void* n0, const void* m0, const void* y, const void* dy,
                                   const void* dC, const void* dn, const void* dm, void* ws,
                                   void* dq, void* dk, void* dv, void* di, void* df, void* dC0,
                                   void* dn0, void* dm0, int B, int S, int dh, void* stream) {
  if (B <= 0) return cudaSuccess;
  if (S <= 0 || dh <= 0 || dh % 32 != 0 || dh > kMaxDh) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int nc = (S + kT - 1) / kT, nd = (dh + kCT - 1) / kCT, ndt = (dh + kGT - 1) / kGT;
  const Workspace w = carve(static_cast<float*>(ws), B, S, dh);
  const float* qf = static_cast<const float*>(q);
  const float* kf = static_cast<const float*>(k);
  const float* vf = static_cast<const float*>(v);
  const float* ip = static_cast<const float*>(i_pre);
  const float* fp = static_cast<const float*>(f_pre);
  const float* yf = static_cast<const float*>(y);
  const float* gf = static_cast<const float*>(dy);
  cudaError_t err = static_cast<cudaError_t>(
      sct_mlstm_states(k, v, i_pre, f_pre, C0, n0, m0, w.C_hist, w.n_hist, w.mprev, B, S, dh,
                       stream));
  if (err != cudaSuccess) return err;
  bwd_scores_kernel<<<dim3(nc * 10, 2, B), kThreads, 0, st>>>(qf, kf, gf, vf, w.sbuf, w.pbuf,
                                                              S, dh, nc);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  bwd_rows_kernel<<<dim3(nc, B, kRowSplit), kThreads, 0, st>>>(
      qf, yf, gf, ip, fp, w.n_hist, w.mprev, w.sbuf, w.pbuf, w.ce, w.ud, w.rowg, w.dmf, w.gi, w.wa,
      w.decay, S, dh);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  err = sct::allow_smem(bwd_dstate_kernel, sizeof(DStateSmem));
  if (err != cudaSuccess) return err;
  bwd_dstate_kernel<<<dim3(nd, nd, B), kThreads, sizeof(DStateSmem), st>>>(
      qf, gf, w.ce, w.ud, w.decay, w.C_hist, w.n_hist, static_cast<const float*>(dC),
      static_cast<const float*>(dn), w.dC_hist, w.dn_hist, w.dd_part, static_cast<float*>(dC0),
      static_cast<float*>(dn0), S, dh);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const InputsArgs args{qf, kf, vf, gf, w.sbuf, w.pbuf, w.C_hist, w.n_hist, w.dC_hist,
                        w.dn_hist, w.ce, w.ud, w.wa, static_cast<float*>(dq),
                        static_cast<float*>(dk), static_cast<float*>(dv), w.dint_part,
                        w.da_part, S, dh, C0 != nullptr, dC != nullptr};
  err = sct::allow_smem(bwd_inputs_kernel, sizeof(InputsSmem));
  if (err != cudaSuccess) return err;
  bwd_inputs_kernel<<<dim3(nc * (kT / kGT) * ndt, 3, B), kThreads, sizeof(InputsSmem), st>>>(
      args);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  bwd_gates_kernel<<<B, kThreads, 0, st>>>(ip, fp, w.mprev, w.rowg, w.gi, w.dmf, w.dint_part,
                                           w.da_part, w.dd_part, static_cast<const float*>(dm),
                                           static_cast<float*>(di), static_cast<float*>(df),
                                           static_cast<float*>(dm0), S, dh);
  return cudaGetLastError();
}
