// Chunkwise stabilised mLSTM (xLSTM's matrix-memory cell) for Hopper: the
// prefill of every mLSTM layer, returning the outputs and the final
// recurrent state (C, n, m) the decode step continues from.
//
// Replaces the TPU kernel kernels/mlstm_chunk.py:mlstm_chunk_pallas of the
// JAX package, whose jnp twin is nn/xlstm.py:_mlstm_chunk_body; the plain
// version is kernels/mlstm_ref.py.
//
// q, k, v (B, S, dh) fp32 with B = batch * heads and k pre-scaled by
// 1/sqrt(dh); i_pre, f_pre (B, S) fp32 gate pre-activations; an optional
// initial state C0 (B, dh, dh), n0 (B, dh), m0 (B,) (null: C = 0, n = 0,
// m = -1e30). Out: y (B, S, dh), C, n, m. Everything is fp32 with the
// reference's stabiliser: per chunk of T tokens, log-forget prefix sums b,
// intra-chunk weights w_tj = exp(b_t - b_j + i_j - m_t) for j <= t, the
// carried state decayed by exp(b_t + m0 - m_t), den = max(|q.n|, exp(-m_t)).
// The chunk length is this kernel's choice: T = min(256, S), the
// reference's, with a ragged last chunk past 256 (the reference takes one
// chunk of S when 256 does not divide S). The function does not depend on it
// in exact arithmetic, since m is a running max; the kernel is held to its
// plain version cut into the same chunks at the fp32 rung. A prompt of up to
// 256 tokens from the empty state (the engine's prefill) is one chunk with
// no carried state: no q @ C0 product runs.
//
// What bounds it: operations. Per head and chunk, the scores q k^T
// (T^2 dh / 2 multiply-adds that count), w.S @ v (the same) and the state
// update C += (wa k)^T v (T dh^2); with a carried state also q @ C0 (T dh^2).
// At the xlstm-1.3b prefill (dh = 1024, S <= 160, B = 4) the update
// dominates and the bytes (q, k, v, y, C) are a few MB: in fp32 at 67
// TFLOP/s, 23 us; with the update as three tf32 products at 495 TFLOP/s
// (as this kernel runs it) and the rest in fp32, ~10 us.
//
// Design: three launches, each spread over the card; the second and third
// are programmatic dependent launches, so the state pass runs beside the
// scores pass and the output pass starts its statistics while they finish.
//   * scores: S = q k^T of every chunk's lower triangle, 64 x 64 tiles with
//     4 x 4 outputs a thread, the dh reduction cut into slices of 128 that
//     run as blocks of their own (partial tiles to scratch, summed in slice
//     order by the output pass);
//   * state: C tiled over (128 dh rows x 128 value columns): one block a tile
//     and head (64 blocks a head at dh = 1024), which walks the chunks in
//     order holding its tile in registers and stages its k and v slices once
//     a chunk (32-token cp.async stages, two in flight; k scaled by wa once a
//     stage) for C = decay0 C + (wa k)^T v on the tensor cores: mma.sync
//     m16n8k8 in tf32, each fp32 operand split into a tf32 high and low part
//     and three products summed in fp32 (3xTF32, products to ~2^-21). With a carried state it first
//     takes q @ C over its tile (the tile through shared memory) and writes
//     that partial product of y, and q . n, to scratch, one slice per row
//     tile of C; the output pass sums the slices in order. The blocks of the
//     first column tile keep n, the block of the first tile writes m;
//   * output: y for 16 rows x 256 value columns a block: the chunk's
//     statistics, the rows' stabiliser m_t (16 lanes a row), the gated scores
//     w.S (the slices summed in order) and their row sums, then (w.S) @ v on
//     the tensor cores (3xTF32, as the state), and
//     y = (w.S @ v + e q @ C0) / den.
// Each block rebuilds the chunk's gate statistics itself: the log-forget
// prefix sums by a block scan in fp64, rounded once (the plain version sums
// in fp64 too: the fp64 partial sums of fp32 values are exact or within an
// fp64 ulp in any order, so both start from the same fp32 values), and the
// running maxima by block and lane reductions, which are exact. Accurate
// expf / log1pf (no fast-math flags in kernels/build.py).
#include "common.cuh"
#include "mlstm.cuh"
#include "mma.cuh"

using namespace sct::mma;

namespace {

constexpr int kT = 256;         // chunk length
constexpr int kThreads = 256;   // one token of a chunk a thread in the statistics
constexpr int kCT = 128;        // C tile: dh rows and value columns
constexpr int kJS = 32;         // tokens a state stage holds
constexpr int kSD = 128;        // dims of a score slice
constexpr int kMaxSlices = 1024 / kSD;
constexpr int kST = 64;         // score tile
constexpr int kSK = 32;         // dims a score stage holds
constexpr int kYR = 16;         // output rows a block
constexpr int kYC = 256;        // output columns a block
constexpr int kYJ = 32;         // tokens of v an output stage holds
constexpr float kNegInit = -1e30f;

using sct::mlstm::block_max;
using sct::mlstm::chunk_stats;
using sct::mlstm::mma_tf32;
using sct::mlstm::split_tf32;

// ---------------------------------------------------------------- scores --
// part[b][s][c][t][j] = sum over dims of slice s of q[t] . k[j], chunk c, for
// the 64 x 64 tiles (ti >= tj) of the chunk's lower triangle. grid
// (chunks * 10, slices, B); a block past its chunk's tiles returns. Rows of
// q and k stream through two cp.async stages of 32 dims; thread (tx, ty)
// takes rows ty + 16 r and columns tx + 16 s (r, s < 4), so the k rows a
// warp reads fall on distinct banks.
__global__ void __launch_bounds__(kThreads)
mlstm_scores_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    float* __restrict__ part, int S, int dh, int nc) {
  __shared__ __align__(16) float qs[2][kST][kSK + 4];
  __shared__ __align__(16) float ks[2][kST][kSK + 4];
  const int c = blockIdx.x / 10, sl = blockIdx.y, b = blockIdx.z, tid = threadIdx.x;
  sct::allow_dependents();                     // the state pass runs beside this one
  int ti = 0, rest = blockIdx.x % 10;          // lower-triangle tile (ti, tj), tj <= ti
  while (rest > ti) rest -= ++ti;
  const int tj = rest;
  const int t0 = c * kT, tc = min(kT, S - t0);
  if (ti * kST >= tc) return;
  const int tx = tid & 15, ty = tid >> 4;
  const int rq = ti * kST, rk = tj * kST;
  const int d_lo = sl * kSD, d_hi = min(dh, d_lo + kSD);
  auto stage = [&](int d0, int buf) {
    for (int e = tid; e < 2 * kST * kSK / 4; e += kThreads) {
      const bool is_k = e >= kST * kSK / 4;
      const int f = is_k ? e - kST * kSK / 4 : e;
      const int r = f / (kSK / 4), d4 = 4 * (f % (kSK / 4));
      const int row = (is_k ? rk : rq) + r;
      const bool ok = row < tc;
      const float* src = (is_k ? k : q) + (ok ? ((size_t)b * S + t0 + row) * dh + d0 + d4 : 0);
      cp_async16(is_k ? &ks[buf][r][d4] : &qs[buf][r][d4], src, ok);
    }
  };
  float acc[4][4] = {};
  const int nst = (d_hi - d_lo) / kSK;         // dh is a multiple of 32
  stage(d_lo, 0);
  cp_async_commit();
  for (int st = 0; st < nst; ++st) {
    const int buf = st & 1;
    if (st + 1 < nst) stage(d_lo + (st + 1) * kSK, buf ^ 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
#pragma unroll
    for (int dd = 0; dd < kSK; dd += 4) {
      float4 a[4], bb[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        a[r] = *reinterpret_cast<const float4*>(&qs[buf][ty + 16 * r][dd]);
        bb[r] = *reinterpret_cast<const float4*>(&ks[buf][tx + 16 * r][dd]);
      }
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int s = 0; s < 4; ++s) {
          acc[r][s] = fmaf(a[r].x, bb[s].x, acc[r][s]);
          acc[r][s] = fmaf(a[r].y, bb[s].y, acc[r][s]);
          acc[r][s] = fmaf(a[r].z, bb[s].z, acc[r][s]);
          acc[r][s] = fmaf(a[r].w, bb[s].w, acc[r][s]);
        }
    }
    __syncthreads();
  }
  const int slices = gridDim.y;
  float* out = part + (((size_t)b * slices + sl) * nc + c) * kT * kT;
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int s = 0; s < 4; ++s)
      out[(size_t)(rq + ty + 16 * r) * kT + rk + tx + 16 * s] = acc[r][s];
}

// ----------------------------------------------------------------- state --
// grid (column tiles, row tiles, B): block (et, dt, b) owns
// C[b][dt*128 .. +128, et*128 .. +128]. Thread (tx, ty) holds rows
// {4ty..4ty+3, 64+4ty..}, columns {4tx.., 64+4tx..}: 8 x 8 in registers.
struct alignas(16) StateSmem {
  float ks[2][kJS][kCT + 8];      // k rows of the stage, this tile's dims (then wa k)
  float vs[2][kJS][kCT + 8];      // v rows, this tile's columns
  float wa[kT];
  float bcum[kT];
  float ii[kT];
  float ns[kCT];
  float npart[2][kCT];
  double dsc[kThreads / 32];
  float fsc[kThreads / 32];
};
// the carried-state product q @ C: the tile and a 64-row block of q^T
struct alignas(16) CarrySmem {
  float cs[kCT][kCT + 4];
  float qT[kCT][64 + 4];
};

// grid (column tiles, row tiles, B): block (et, dt, b) owns
// C[b][dt*128 .. +128, et*128 .. +128]; warp (wm, wn) holds rows
// 32 wm .. + 32 and columns 64 wn .. + 64 as 2 x 8 mma.m16n8k8 accumulator
// tiles (fragment e of tile (mi, nt) is row 32 wm + 16 mi + g + 8 (e / 2),
// column 64 wn + 8 nt + 2 t + e % 2, for lane 4 g + t).
__global__ void __launch_bounds__(kThreads, 2)
mlstm_state_kernel(const float* __restrict__ q, const float* __restrict__ k,
                   const float* __restrict__ v, const float* __restrict__ i_pre,
                   const float* __restrict__ f_pre, const float* __restrict__ C0,
                   const float* __restrict__ n0, const float* __restrict__ m0_in,
                   float* __restrict__ yq, float* __restrict__ qn, float* __restrict__ mprev,
                   float* __restrict__ C_out, float* __restrict__ n_out,
                   float* __restrict__ m_out, float* __restrict__ C_hist,
                   float* __restrict__ n_hist, int S, int dh) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  StateSmem& sm = *reinterpret_cast<StateSmem*>(smem_raw);
  CarrySmem& cm = *reinterpret_cast<CarrySmem*>(smem_raw + sizeof(StateSmem));
  const int et = blockIdx.x, dt = blockIdx.y, b = blockIdx.z, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5, g = lane >> 2, t4 = lane & 3;
  const int wm = warp >> 1, wn = warp & 1;
  const int d0 = dt * kCT, e0 = et * kCT;
  const int nd = gridDim.y, nc = (S + kT - 1) / kT;
  const bool carry = C0 != nullptr || nc > 1;
  const bool keeps_n = et == 0;
  sct::allow_dependents();                     // the output pass may launch and wait

  auto row_of = [&](int mi, int e) { return 32 * wm + 16 * mi + g + 8 * (e >> 1); };
  auto col_of = [&](int nt, int e) { return 64 * wn + 8 * nt + 2 * t4 + (e & 1); };
  float creg[2][8][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int d = d0 + row_of(mi, e), col = e0 + col_of(nt, e);
        creg[mi][nt][e] = C0 && d < dh && col < dh ? C0[((size_t)b * dh + d) * dh + col] : 0.f;
      }
  if (keeps_n && tid < kCT)
    sm.ns[tid] = n0 && d0 + tid < dh ? n0[(size_t)b * dh + d0 + tid] : 0.f;
  float m0 = m0_in ? m0_in[b] : kNegInit;

  for (int c = 0; c < nc; ++c) {
    const int t0 = c * kT, tc = min(kT, S - t0);
    const size_t row0 = (size_t)b * S + t0;
    if (dt == 0 && et == 0 && tid == 0) mprev[(size_t)b * nc + c] = m0;
    if (C_hist != nullptr) {                   // the backward's record: the chunk's start
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int nt = 0; nt < 8; ++nt)
#pragma unroll
          for (int e = 0; e < 4; e += 2) {
            const int d = d0 + row_of(mi, e), col = e0 + col_of(nt, e);
            if (d < dh && col < dh)
              *reinterpret_cast<float2*>(C_hist + (((size_t)b * nc + c) * dh + d) * dh + col) =
                  make_float2(creg[mi][nt][e], creg[mi][nt][e + 1]);
          }
      if (keeps_n && tid < kCT && d0 + tid < dh)
        n_hist[((size_t)b * nc + c) * dh + d0 + tid] = sm.ns[tid];
    }
    // the chunk's first k / v stage is in flight while its statistics build
    const int nst = (tc + kJS - 1) / kJS;
    auto stage = [&](int st, int buf) {
      for (int e = tid; e < 2 * kJS * kCT / 4; e += kThreads) {
        const bool is_v = e >= kJS * kCT / 4;
        const int f = is_v ? e - kJS * kCT / 4 : e;
        const int j = f / (kCT / 4), c4 = 4 * (f % (kCT / 4));
        const int t = st * kJS + j, col = (is_v ? e0 : d0) + c4;
        const bool ok = t < tc && col < dh;
        const float* src = (is_v ? v : k) + (ok ? (row0 + t) * dh + col : 0);
        cp_async16(is_v ? &sm.vs[buf][j][c4] : &sm.ks[buf][j][c4], src, ok);
      }
    };
    stage(0, 0);
    cp_async_commit();
    const float btot = chunk_stats(i_pre, f_pre, row0, tc, sm.bcum, sm.ii, sm.dsc);
    const float a_j = tid < tc ? (btot - sm.bcum[tid]) + sm.ii[tid] : kNegInit;
    const float m_new = fmaxf(btot + m0, block_max(a_j, sm.fsc));
    const float decay0 = expf((btot + m0) - m_new);
    sm.wa[tid] = tid < tc ? expf(a_j - m_new) : 0.f;

    // ---- the carried state's share of y: q @ C and q . n over this tile ----
    if (carry && yq != nullptr && (c > 0 || C0 != nullptr)) {
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int nt = 0; nt < 8; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) cm.cs[row_of(mi, e)][col_of(nt, e)] = creg[mi][nt][e];
      for (int rb = 0; rb < tc; rb += 64) {
        __syncthreads();                   // the tile written; the previous q block read
        for (int e = tid; e < 64 * kCT / 4; e += kThreads) {
          const int r = e / (kCT / 4), d4 = 4 * (e % (kCT / 4));
          float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
          if (rb + r < tc && d0 + d4 < dh)
            a = *reinterpret_cast<const float4*>(q + (row0 + rb + r) * dh + d0 + d4);
          cm.qT[d4][r] = a.x; cm.qT[d4 + 1][r] = a.y; cm.qT[d4 + 2][r] = a.z;
          cm.qT[d4 + 3][r] = a.w;
        }
        __syncthreads();
        // rows 4 (tid / 32) .. + 3 and 32 + the same, columns 4 (tid % 32) .. + 3
        const int rr = 4 * (tid >> 5), cc = 4 * (tid & 31);
        float o[8][4] = {};
        for (int d = 0; d < kCT; ++d) {
          const float4 qa = *reinterpret_cast<const float4*>(&cm.qT[d][rr]);
          const float4 qb = *reinterpret_cast<const float4*>(&cm.qT[d][32 + rr]);
          const float4 cv = *reinterpret_cast<const float4*>(&cm.cs[d][cc]);
          const float qv[8] = {qa.x, qa.y, qa.z, qa.w, qb.x, qb.y, qb.z, qb.w};
          const float cw[4] = {cv.x, cv.y, cv.z, cv.w};
#pragma unroll
          for (int r = 0; r < 8; ++r)
#pragma unroll
            for (int s = 0; s < 4; ++s) o[r][s] = fmaf(qv[r], cw[s], o[r][s]);
        }
#pragma unroll
        for (int r = 0; r < 8; ++r) {
          const int t = rb + (r < 4 ? rr + r : 32 + rr + r - 4);
          if (t < tc && e0 + cc < dh)
            *reinterpret_cast<float4*>(yq + (((size_t)b * nd + dt) * S + t0 + t) * dh + e0 + cc) =
                make_float4(o[r][0], o[r][1], o[r][2], o[r][3]);
        }
        if (keeps_n && tid < 64 && rb + tid < tc) {
          float s = 0.f;
          for (int d = 0; d < kCT; ++d) s = fmaf(cm.qT[d][tid], sm.ns[d], s);
          qn[((size_t)b * nd + dt) * S + t0 + rb + tid] = s;
        }
      }
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)       // the tile back (not held across the product)
#pragma unroll
        for (int nt = 0; nt < 8; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) creg[mi][nt][e] = cm.cs[row_of(mi, e)][col_of(nt, e)];
    }

    // ---- C = decay0 C + (wa k)^T v over the chunk's tokens, 3xTF32 ----
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) creg[mi][nt][e] *= decay0;
    float nacc = 0.f;
    __syncthreads();                       // wa visible
    for (int st = 0; st < nst; ++st) {
      const int buf = st & 1;
      if (st + 1 < nst) stage(st + 1, buf ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
      __syncthreads();
      for (int e = tid; e < kJS * kCT / 4; e += kThreads) {   // wa_j k_j, once a stage
        const int j = e / (kCT / 4), c4 = 4 * (e % (kCT / 4));
        float4* x = reinterpret_cast<float4*>(&sm.ks[buf][j][c4]);
        const float w = sm.wa[st * kJS + j];
        *x = make_float4(w * x->x, w * x->y, w * x->z, w * x->w);
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < kJS; kk += 8) {
        uint32_t ab[2][4], as[2][4];
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
          const int r = 32 * wm + 16 * mi + g;
          split_tf32(sm.ks[buf][kk + t4][r], ab[mi][0], as[mi][0]);
          split_tf32(sm.ks[buf][kk + t4][r + 8], ab[mi][1], as[mi][1]);
          split_tf32(sm.ks[buf][kk + t4 + 4][r], ab[mi][2], as[mi][2]);
          split_tf32(sm.ks[buf][kk + t4 + 4][r + 8], ab[mi][3], as[mi][3]);
        }
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
          const int cb = 64 * wn + 8 * nt + g;
          uint32_t bb0, bs0, bb1, bs1;
          split_tf32(sm.vs[buf][kk + t4][cb], bb0, bs0);
          split_tf32(sm.vs[buf][kk + t4 + 4][cb], bb1, bs1);
#pragma unroll
          for (int mi = 0; mi < 2; ++mi) {
            mma_tf32(creg[mi][nt], as[mi], bb0, bb1);
            mma_tf32(creg[mi][nt], ab[mi], bs0, bs1);
            mma_tf32(creg[mi][nt], ab[mi], bb0, bb1);
          }
        }
      }
      if (keeps_n) {                       // n's sum: two threads a dim, 16 tokens each
        const int dd = tid & (kCT - 1), hf = tid >> 7;
        for (int jj = hf * (kJS / 2); jj < (hf + 1) * (kJS / 2); ++jj)
          nacc += sm.ks[buf][jj][dd];
      }
      __syncthreads();                     // the stage is free again
    }
    if (keeps_n) {
      sm.npart[tid >> 7][tid & (kCT - 1)] = nacc;
      __syncthreads();
      if (tid < kCT) sm.ns[tid] = decay0 * sm.ns[tid] + (sm.npart[0][tid] + sm.npart[1][tid]);
      __syncthreads();
    }
    m0 = m_new;
  }

  if (C_out != nullptr) {
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; e += 2) {
          const int d = d0 + row_of(mi, e), col = e0 + col_of(nt, e);
          if (d < dh && col < dh)
            *reinterpret_cast<float2*>(C_out + ((size_t)b * dh + d) * dh + col) =
                make_float2(creg[mi][nt][e], creg[mi][nt][e + 1]);
        }
    if (keeps_n && tid < kCT && d0 + tid < dh) n_out[(size_t)b * dh + d0 + tid] = sm.ns[tid];
    if (et == 0 && dt == 0 && tid == 0) m_out[b] = m0;
  }
  sct::grid_dependency_wait();                 // complete only after the scores pass
}

// ---------------------------------------------------------------- output --
// grid (chunks * 16 row tiles, column tiles, B): y for 16 rows of a chunk x
// 256 value columns; a block past its chunk's rows returns.
struct alignas(16) OutSmem {
  float bcum[kT];
  float ii[kT];
  float wT[kT][kYR + 8];          // (w * S)^T: tokens x rows
  float vs[2][kYJ][kYC + 8];
  float mloc[kYR], isc[kYR], den[kYR];
  double dsc[kThreads / 32];
};

__global__ void __launch_bounds__(kThreads)
mlstm_out_kernel(const float* __restrict__ v, const float* __restrict__ i_pre,
                 const float* __restrict__ f_pre, const float* __restrict__ m0_in,
                 const float* part, const float* yq, const float* qn, const float* mprev,
                 float* __restrict__ y, int S, int dh, int slices, int nd, int has_state) {
  // part, yq, qn and mprev come from the grids this one may overlap: read
  // through L2 (__ldcg), after grid_dependency_wait
  extern __shared__ __align__(16) unsigned char smem_raw[];
  OutSmem& sm = *reinterpret_cast<OutSmem*>(smem_raw);
  const int c = blockIdx.x / (kT / kYR), rt = blockIdx.x % (kT / kYR);
  const int ct = blockIdx.y, b = blockIdx.z, tid = threadIdx.x;
  const int nc = (S + kT - 1) / kT;
  const int t0 = c * kT, tc = min(kT, S - t0);
  const int r_lo = rt * kYR;
  if (r_lo >= tc) {
    sct::grid_dependency_wait();
    return;
  }
  const int nr = min(kYR, tc - r_lo);
  const int jmax = r_lo + nr;                // tokens j <= the tile's last row
  const int jpad = (jmax + 7) / 8 * 8;
  const size_t row0 = (size_t)b * S + t0;
  // v's first stage is in flight while the statistics and w * S are built
  const int e0 = ct * kYC;
  const int nst = (jmax + kYJ - 1) / kYJ;
  auto stage = [&](int st, int buf) {
    for (int e = tid; e < kYJ * kYC / 4; e += kThreads) {
      const int j = e / (kYC / 4), c4 = 4 * (e % (kYC / 4));
      const int t = st * kYJ + j, col = e0 + c4;
      const bool ok = t < jmax && col < dh;
      cp_async16(&sm.vs[buf][j][c4], v + (ok ? (row0 + t) * dh + col : 0), ok);
    }
  };
  stage(0, 0);
  cp_async_commit();
  chunk_stats(i_pre, f_pre, row0, tc, sm.bcum, sm.ii, sm.dsc);
  sct::grid_dependency_wait();               // the scores and the state pass are done
  const float m0 = c == 0 ? (m0_in ? m0_in[b] : kNegInit) : __ldcg(mprev + (size_t)b * nc + c);

  // the rows' stabiliser: 16 lanes a row, an exact max
  {
    const int r = tid >> 4, l16 = tid & 15, t = r_lo + r;
    float mx = kNegInit;
    if (r < nr)
      for (int j = l16; j <= t; j += 16) mx = fmaxf(mx, (sm.bcum[t] - sm.bcum[j]) + sm.ii[j]);
#pragma unroll
    for (int o = 8; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    if (l16 == 0 && r < nr) {
      const float inter = sm.bcum[t] + m0;
      const float ml = fmaxf(inter, mx);
      sm.mloc[r] = ml;
      sm.isc[r] = expf(inter - ml);
    }
  }
  __syncthreads();
  // w * S, transposed, and its row sums: 16 lanes a row, every slice's load
  // of a score in flight together, the slices summed in order
  {
    const size_t cstride = (size_t)kT * kT;
    const int r = tid >> 4, l16 = tid & 15, t = r_lo + r;
    const float* prow = part + ((size_t)b * slices * nc + c) * cstride + (size_t)t * kT;
    float dsum = 0.f;
#pragma unroll 4
    for (int j = l16; j < jpad; j += 16) {       // zeros past jmax: whole 8-token steps
      float w = 0.f;
      if (r < nr && j <= t) {
        float sv[kMaxSlices];
#pragma unroll
        for (int sl = 0; sl < kMaxSlices; ++sl)
          sv[sl] = sl < slices ? __ldcg(prow + (size_t)sl * nc * cstride + j) : 0.f;
        float s = sv[0];
#pragma unroll
        for (int sl = 1; sl < kMaxSlices; ++sl)
          if (sl < slices) s += sv[sl];
        w = expf(((sm.bcum[t] - sm.bcum[j]) + sm.ii[j]) - sm.mloc[r]) * s;
      }
      sm.wT[j][r] = w;
      dsum += w;
    }
#pragma unroll
    for (int o = 8; o > 0; o >>= 1) dsum += __shfl_xor_sync(0xffffffffu, dsum, o);
    if (l16 == 0) sm.den[r] = dsum;
  }
  __syncthreads();

  // (w * S) @ v on the tensor cores, 3xTF32: the 16 rows are one m16 tile;
  // warp w takes columns 32 w .. + 32 of the block's 256 (4 n8 tiles)
  const int lane = tid & 31, warp = tid >> 5, g = lane >> 2, t4 = lane & 3;
  float acc[4][4] = {};
  for (int st = 0; st < nst; ++st) {
    const int buf = st & 1;
    if (st + 1 < nst) stage(st + 1, buf ^ 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const int jn = min(kYJ, jmax - st * kYJ);
    for (int kk = 0; kk < jn; kk += 8) {
      const int j = st * kYJ + kk;
      uint32_t ab[4], as[4];
      split_tf32(sm.wT[j + t4][g], ab[0], as[0]);
      split_tf32(sm.wT[j + t4][g + 8], ab[1], as[1]);
      split_tf32(sm.wT[j + t4 + 4][g], ab[2], as[2]);
      split_tf32(sm.wT[j + t4 + 4][g + 8], ab[3], as[3]);
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int cb = 32 * warp + 8 * nt + g;
        uint32_t bb0, bs0, bb1, bs1;
        split_tf32(sm.vs[buf][kk + t4][cb], bb0, bs0);
        split_tf32(sm.vs[buf][kk + t4 + 4][cb], bb1, bs1);
        mma_tf32(acc[nt], as, bb0, bb1);
        mma_tf32(acc[nt], ab, bs0, bs1);
        mma_tf32(acc[nt], ab, bb0, bb1);
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int rr = g + 8 * hf;
    if (rr >= nr) continue;
    const int t = r_lo + rr;
    const float isc = sm.isc[rr];
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const int col = e0 + 32 * warp + 8 * nt + 2 * t4;
      if (col >= dh) continue;
      float2 inter = make_float2(0.f, 0.f);
      float qnv = 0.f;
      if (has_state || c > 0) {              // the carried state's slices, in order
        for (int s = 0; s < nd; ++s) {
          const float2 p = __ldcg(reinterpret_cast<const float2*>(
              yq + (((size_t)b * nd + s) * S + t0 + t) * dh + col));
          inter.x += p.x;
          inter.y += p.y;
          qnv += __ldcg(qn + ((size_t)b * nd + s) * S + t0 + t);
        }
      }
      const float den = fmaxf(fabsf(sm.den[rr] + isc * qnv), expf(-sm.mloc[rr]));
      *reinterpret_cast<float2*>(y + (row0 + t) * dh + col) =
          make_float2((acc[nt][2 * hf] + isc * inter.x) / den,
                      (acc[nt][2 * hf + 1] + isc * inter.y) / den);
    }
  }
}

}  // namespace

// dh a multiple of 32 and at most 1024; q, k, v, C0 and C 16-byte aligned
// (the wrapper checks all three). Scratch: part B * ceil(dh / 128) *
// ceil(S / 256) * 256 * 256 floats; with a carried state (C0 given or S >
// 256) yq B * ceil(dh / 128) * S * dh floats and qn B * ceil(dh / 128) * S
// floats (else unused); mprev B * ceil(S / 256) floats.
extern "C" int sct_mlstm_chunk(const void* q, const void* k, const void* v, const void* i_pre,
                               const void* f_pre, const void* C0, const void* n0,
                               const void* m0, void* part, void* yq, void* qn, void* mprev,
                               void* y, void* C, void* n, void* m, int B, int S, int dh,
                               void* stream) {
  if (B <= 0) return cudaSuccess;
  if (S <= 0 || dh <= 0 || dh % 32 != 0 || dh > 1024) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int nc = (S + kT - 1) / kT, nd = (dh + kCT - 1) / kCT, slices = (dh + kSD - 1) / kSD;
  const bool carry = C0 != nullptr || nc > 1;
  const float* qf = static_cast<const float*>(q);
  const float* kf = static_cast<const float*>(k);
  const float* vf = static_cast<const float*>(v);
  const float* ip = static_cast<const float*>(i_pre);
  const float* fp = static_cast<const float*>(f_pre);
  mlstm_scores_kernel<<<dim3(nc * 10, slices, B), kThreads, 0, st>>>(
      qf, kf, static_cast<float*>(part), S, dh, nc);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const size_t state_smem = sizeof(StateSmem) + (carry ? sizeof(CarrySmem) : 0);
  err = sct::allow_smem(mlstm_state_kernel, state_smem);
  if (err != cudaSuccess) return err;
  err = sct::launch_dependent(
      mlstm_state_kernel, dim3(nd, nd, B), dim3(kThreads), state_smem, st, qf, kf, vf, ip, fp,
      static_cast<const float*>(C0), static_cast<const float*>(n0),
      static_cast<const float*>(m0), static_cast<float*>(yq), static_cast<float*>(qn),
      static_cast<float*>(mprev), static_cast<float*>(C), static_cast<float*>(n),
      static_cast<float*>(m), static_cast<float*>(nullptr), static_cast<float*>(nullptr), S, dh);
  if (err != cudaSuccess) return err;
  err = sct::allow_smem(mlstm_out_kernel, sizeof(OutSmem));
  if (err != cudaSuccess) return err;
  err = sct::launch_dependent(
      mlstm_out_kernel, dim3(nc * (kT / kYR), (dh + kYC - 1) / kYC, B), dim3(kThreads),
      sizeof(OutSmem), st, vf, ip, fp, static_cast<const float*>(m0),
      static_cast<const float*>(part), static_cast<const float*>(yq),
      static_cast<const float*>(qn), static_cast<const float*>(mprev), static_cast<float*>(y),
      S, dh, slices, nd, C0 != nullptr ? 1 : 0);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// The backward's state pass (csrc/mlstm_chunk_bwd.cu): the state kernel
// alone, without the carried state's share of y, recording every chunk's
// starting state: C_hist (B, nc, dh, dh), n_hist (B, nc, dh) and mprev
// (B, nc), nc = ceil(S / 256). k, v and C0 16-byte aligned.
extern "C" int sct_mlstm_states(const void* k, const void* v, const void* i_pre,
                                const void* f_pre, const void* C0, const void* n0,
                                const void* m0, void* C_hist, void* n_hist, void* mprev, int B,
                                int S, int dh, void* stream) {
  if (B <= 0) return cudaSuccess;
  if (S <= 0 || dh <= 0 || dh % 32 != 0 || dh > 1024) return cudaErrorInvalidValue;
  const int nd = (dh + kCT - 1) / kCT;
  const size_t smem = sizeof(StateSmem);
  cudaError_t err = sct::allow_smem(mlstm_state_kernel, smem);
  if (err != cudaSuccess) return err;
  mlstm_state_kernel<<<dim3(nd, nd, B), kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      nullptr, static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const float*>(i_pre), static_cast<const float*>(f_pre),
      static_cast<const float*>(C0), static_cast<const float*>(n0),
      static_cast<const float*>(m0), nullptr, nullptr, static_cast<float*>(mprev), nullptr,
      nullptr, nullptr, static_cast<float*>(C_hist), static_cast<float*>(n_hist), S, dh);
  return cudaGetLastError();
}
