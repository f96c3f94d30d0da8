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
//      tiles with the whole dh reduction in the block;
//   3. rows: one block a chunk, a warp a row: the stabilisers, den, and
//      the rows of dS and P / den written over S and dy v^T (zeros above the
//      diagonal), G's row and column sums;
//   4. dstate: the reverse sweep of dC over the chunks, a block a 128 x 128
//      tile holding its tile in registers (8 x 8 a thread, fp32 FMA),
//      recording every chunk's dC1 and dn1 and <dC1, C0> + <dn1, n0>;
//   5. inputs: dq, dk and dv, 64 x 64 output tiles, each the chunk's
//      triangle product plus the carried state's product (fp32 FMA, 16-deep
//      shared-memory stages), with the per-tile dots the gates need;
//   6. gates: one block a head, walking the chunks in reverse: the argmax
//      routing, the m chain, the fp64 suffix sums, di and df.
//
// What bounds it: operations. Per chunk and head, with T tokens and the
// causal pairs p = T (T + 1) / 2: the five triangle products (S, dy v^T, dS
// k, dS^T q, P^T dnum: 5 p dh multiply-adds), the carried state's four (q
// dnum^T into dC, C0 dnum, dC1 v, dC1^T k: 4 T dh^2, where C0 and dC1 are
// not empty) and the state pass's one (T dh^2, all chunks but the last);
// at xlstm-1.3b's training shape (B = 2 x 4 heads, S = 4096, dh = 1024,
// the empty state, no gradient of the final state) 3.7e11 flops, 5.5 ms at
// the fp32 rate of 67 TFLOP/s; the bytes (q, k, v, y, dy in, dq, dk, dv
// out) take 0.32 ms. This
// first version runs the state pass as the forward does (3xTF32 on the
// tensor cores), the two score products in fp64 and the rest in fp32, all
// outside the tensor cores but the state pass.
#include "common.cuh"
#include "mlstm.cuh"

extern "C" int sct_mlstm_states(const void* k, const void* v, const void* i_pre,
                                const void* f_pre, const void* C0, const void* n0,
                                const void* m0, void* C_hist, void* n_hist, void* mprev, int B,
                                int S, int dh, void* stream);

namespace {

using sct::mlstm::block_max;
using sct::mlstm::chunk_stats;

constexpr int kT = 256;         // chunk length (the forward's)
constexpr int kThreads = 256;   // every kernel: a token of a chunk a thread in the statistics
constexpr int kST = 64;         // score tile
constexpr int kSK = 32;         // dims a score stage holds
constexpr int kCT = 128;        // dC tile: dh rows and value columns
constexpr int kJS = 32;         // tokens a dC stage holds
constexpr int kGT = 64;         // gradient tile: rows and columns
constexpr int kGK = 16;         // reduction depth a gradient stage holds
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
// buf[b][c][t][j] = sum over dh of a[t] . bm[j] for the 64 x 64 tiles (ti >=
// tj) of chunk c's lower triangle: blockIdx.y 0 takes (q, k) into sbuf, 1
// takes (dy, v) into pbuf. The sums run in fp64 and are rounded once: the
// products of fp32 values are exact there, so any order of the sum rounds
// to the same fp32 value (dP = (dy . v - dy . y) / den cancels where a
// row's weight sits on one token, and then takes no error from the order).
// grid (chunks * 10, 2, B); a block past its chunk's rows returns. Thread
// (tx, ty) takes rows ty + 16 r and columns tx + 16 s (r, s < 4).
__global__ void __launch_bounds__(kThreads)
bwd_scores_kernel(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ dy, const float* __restrict__ v,
                  float* __restrict__ sbuf, float* __restrict__ pbuf, int S, int dh, int nc) {
  __shared__ __align__(16) float as[kST][kSK + 4];
  __shared__ __align__(16) float bs[kST][kSK + 4];
  const int c = blockIdx.x / 10, which = blockIdx.y, b = blockIdx.z, tid = threadIdx.x;
  int ti = 0, rest = blockIdx.x % 10;
  while (rest > ti) rest -= ++ti;
  const int tj = rest;
  const int t0 = c * kT, tc = min(kT, S - t0);
  if (ti * kST >= tc) return;
  const float* A = which ? dy : q;
  const float* Bm = which ? v : k;
  const int tx = tid & 15, ty = tid >> 4;
  const int rq = ti * kST, rk = tj * kST;
  const size_t row0 = (size_t)b * S + t0;
  double acc[4][4] = {};
  for (int d0 = 0; d0 < dh; d0 += kSK) {     // dh is a multiple of 32
    for (int e = tid; e < 2 * kST * kSK / 4; e += kThreads) {
      const bool is_b = e >= kST * kSK / 4;
      const int f = is_b ? e - kST * kSK / 4 : e;
      const int r = f / (kSK / 4), d4 = 4 * (f % (kSK / 4));
      const int row = (is_b ? rk : rq) + r;
      float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
      if (row < tc)
        x = *reinterpret_cast<const float4*>((is_b ? Bm : A) + (row0 + row) * dh + d0 + d4);
      *reinterpret_cast<float4*>(is_b ? &bs[r][d4] : &as[r][d4]) = x;
    }
    __syncthreads();
#pragma unroll
    for (int dd = 0; dd < kSK; dd += 4) {
      float4 a[4], bb[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        a[r] = *reinterpret_cast<const float4*>(&as[ty + 16 * r][dd]);
        bb[r] = *reinterpret_cast<const float4*>(&bs[tx + 16 * r][dd]);
      }
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int s = 0; s < 4; ++s) {
          acc[r][s] = fma(static_cast<double>(a[r].x), static_cast<double>(bb[s].x), acc[r][s]);
          acc[r][s] = fma(static_cast<double>(a[r].y), static_cast<double>(bb[s].y), acc[r][s]);
          acc[r][s] = fma(static_cast<double>(a[r].z), static_cast<double>(bb[s].z), acc[r][s]);
          acc[r][s] = fma(static_cast<double>(a[r].w), static_cast<double>(bb[s].w), acc[r][s]);
        }
    }
    __syncthreads();
  }
  float* out = (which ? pbuf : sbuf) + ((size_t)b * nc + c) * kT * kT;
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int s = 0; s < 4; ++s)
      out[(size_t)(rq + ty + 16 * r) * kT + rk + tx + 16 * s] = static_cast<float>(acc[r][s]);
}

// ------------------------------------------------------------------ rows --
// grid (chunks, B): warp w takes the rows t = w, w + 8, ... of the chunk.
// In: sbuf = q k^T, pbuf = dy v^T. Out: sbuf = dS, pbuf = P / den (both 0
// for j > t), and per token ce = e / den, ud = e dden_raw, rowg = sum_j G,
// dmf = the clamp's share of M's gradient, gi = sum_t G (the column sums),
// wa (the end state's weights); per chunk decay0.
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
  const int c = blockIdx.x, b = blockIdx.y, tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nc = gridDim.x;
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
  if (tid < tc) wa[row0 + tid] = expf(a_j - m_new);
  if (tid == 0) decay[hist] = expf((btot + m0) - m_new);

  float* sb = sbuf + hist * kT * kT;
  float* pb = pbuf + hist * kT * kT;
  for (int t = warp; t < tc; t += kThreads / 32) {
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
    gi[row0 + tid] = cg;
  }
}

// ---------------------------------------------------------------- dstate --
// grid (column tiles, row tiles, B): block (et, dt, b) owns dC[b][dt*128 ..
// +128, et*128 .. +128] and walks the chunks in reverse. Thread (tx, ty)
// holds rows {4ty .. +3, 64 + 4ty .. +3} and columns {4tx .. +3, 64 + 4tx ..
// +3}; the blocks of the first column tile carry dn. Before chunk c's
// update the block records dC1 (dC_hist), dn1 (dn_hist) and its share of
// <dC1, C_c> + <dn1, n_c> (dd_part[b][c][dt * nd + et]).
struct alignas(16) DStateSmem {
  float qs[kJS][kCT + 4];
  float ys[kJS][kCT + 4];
  float ce[kT];
  float ud[kT];
  float dns[kCT];
  float red[kThreads / 32];
};

__global__ void __launch_bounds__(kThreads)
bwd_dstate_kernel(const float* __restrict__ q, const float* __restrict__ dy,
                  const float* __restrict__ ce, const float* __restrict__ ud,
                  const float* __restrict__ decay, const float* __restrict__ C_hist,
                  const float* __restrict__ n_hist, const float* __restrict__ dC_in,
                  const float* __restrict__ dn_in, float* __restrict__ dC_hist,
                  float* __restrict__ dn_hist, float* __restrict__ dd_part,
                  float* __restrict__ dC0, float* __restrict__ dn0, int S, int dh) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  DStateSmem& sm = *reinterpret_cast<DStateSmem*>(smem_raw);
  const int et = blockIdx.x, dt = blockIdx.y, b = blockIdx.z, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5, tx = tid & 15, ty = tid >> 4;
  const int nd = gridDim.x, nc = (S + kT - 1) / kT;
  const int d0 = dt * kCT, e0 = et * kCT;
  const bool keeps_n = et == 0;
  auto row_of = [&](int i) { return i < 4 ? 4 * ty + i : 64 + 4 * ty + i - 4; };
  auto col_of = [&](int j) { return j < 4 ? 4 * tx + j : 64 + 4 * tx + j - 4; };
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int d = d0 + row_of(i), col = e0 + col_of(j);
      acc[i][j] = dC_in && d < dh && col < dh ? dC_in[((size_t)b * dh + d) * dh + col] : 0.f;
    }
  if (keeps_n && tid < kCT)
    sm.dns[tid] = dn_in && d0 + tid < dh ? dn_in[(size_t)b * dh + d0 + tid] : 0.f;
  __syncthreads();
  for (int c = nc - 1; c >= 0; --c) {
    const int t0 = c * kT, tc = min(kT, S - t0);
    const size_t row0 = (size_t)b * S + t0, hist = (size_t)b * nc + c;
    float part = 0.f;
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int d = d0 + row_of(i), col = e0 + col_of(j);
        if (d < dh && col < dh) {
          const size_t o = (hist * dh + d) * dh + col;
          dC_hist[o] = acc[i][j];
          part = fmaf(acc[i][j], C_hist[o], part);
        }
      }
    if (keeps_n && tid < kCT && d0 + tid < dh) {
      dn_hist[hist * dh + d0 + tid] = sm.dns[tid];
      part = fmaf(sm.dns[tid], n_hist[hist * dh + d0 + tid], part);
    }
    part = warp_sum(part);
    if (lane == 0) sm.red[warp] = part;
    if (tid < tc) {
      sm.ce[tid] = ce[row0 + tid];
      sm.ud[tid] = ud[row0 + tid];
    }
    __syncthreads();
    if (tid == 0) {
      float s = sm.red[0];
      for (int w = 1; w < kThreads / 32; ++w) s += sm.red[w];
      dd_part[hist * nd * nd + dt * nd + et] = s;
    }
    const float dec = decay[hist];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] *= dec;
    float nacc = 0.f;
    for (int j0 = 0; j0 < tc; j0 += kJS) {
      for (int e = tid; e < 2 * kJS * kCT / 4; e += kThreads) {
        const bool is_y = e >= kJS * kCT / 4;
        const int f = is_y ? e - kJS * kCT / 4 : e;
        const int j = f / (kCT / 4), c4 = 4 * (f % (kCT / 4));
        const int t = j0 + j, col = (is_y ? e0 : d0) + c4;
        float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
        if (t < tc && col < dh)
          x = *reinterpret_cast<const float4*>((is_y ? dy : q) + (row0 + t) * dh + col);
        *reinterpret_cast<float4*>(is_y ? &sm.ys[j][c4] : &sm.qs[j][c4]) = x;
      }
      __syncthreads();
      const int jn = min(kJS, tc - j0);
      for (int j = 0; j < jn; ++j) {
        const float cj = sm.ce[j0 + j];
        const float4 a0 = *reinterpret_cast<const float4*>(&sm.qs[j][4 * ty]);
        const float4 a1 = *reinterpret_cast<const float4*>(&sm.qs[j][64 + 4 * ty]);
        const float4 b0 = *reinterpret_cast<const float4*>(&sm.ys[j][4 * tx]);
        const float4 b1 = *reinterpret_cast<const float4*>(&sm.ys[j][64 + 4 * tx]);
        const float a[8] = {cj * a0.x, cj * a0.y, cj * a0.z, cj * a0.w,
                            cj * a1.x, cj * a1.y, cj * a1.z, cj * a1.w};
        const float bb[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int jj = 0; jj < 8; ++jj) acc[i][jj] = fmaf(a[i], bb[jj], acc[i][jj]);
      }
      if (keeps_n && tid < kCT)
        for (int j = 0; j < jn; ++j) nacc = fmaf(sm.ud[j0 + j], sm.qs[j][tid], nacc);
      __syncthreads();
    }
    if (keeps_n && tid < kCT) sm.dns[tid] = dec * sm.dns[tid] + nacc;
    __syncthreads();
  }
  if (dC0 != nullptr) {
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int d = d0 + row_of(i), col = e0 + col_of(j);
        if (d < dh && col < dh) dC0[((size_t)b * dh + d) * dh + col] = acc[i][j];
      }
  }
  if (dn0 != nullptr && keeps_n && tid < kCT && d0 + tid < dh)
    dn0[(size_t)b * dh + d0 + tid] = sm.dns[tid];
}

// ---------------------------------------------------------------- inputs --
// acc[r][s] += sum over kk in [k0, k1) of A(4ty + r, kk) B(kk, 4tx + s) for
// one 64 x 64 tile; A(m, kk) is A[m * lda + kk] with kARC (the reduction
// runs along A's rows in memory), else A[kk * lda + m]; B(kk, n) is
// B[n * ldb + kk] with kBRC, else B[kk * ldb + n]. Rows m >= mvalid,
// columns n >= nvalid and depths kk >= k1 read as 0.
template <bool kARC, bool kBRC>
__device__ __forceinline__ void tile_product(float (&acc)[4][4], const float* __restrict__ A,
                                             int lda, int mvalid, const float* __restrict__ Bm,
                                             int ldb, int nvalid, int k0, int k1,
                                             float (*As)[kGT + 4], float (*Bs)[kGT + 4]) {
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  for (int kb = k0; kb < k1; kb += kGK) {
    for (int e = tid; e < kGK * kGT; e += kThreads) {
      const int am = kARC ? e / kGK : e % kGT, ak = kARC ? e % kGK : e / kGT;
      const int bn = kBRC ? e / kGK : e % kGT, bk = kBRC ? e % kGK : e / kGT;
      float x = 0.f, z = 0.f;
      if (am < mvalid && kb + ak < k1)
        x = kARC ? A[(size_t)am * lda + kb + ak] : A[(size_t)(kb + ak) * lda + am];
      if (bn < nvalid && kb + bk < k1)
        z = kBRC ? Bm[(size_t)bn * ldb + kb + bk] : Bm[(size_t)(kb + bk) * ldb + bn];
      As[ak][am] = x;
      Bs[bk][bn] = z;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kGK; ++kk) {
      const float4 a = *reinterpret_cast<const float4*>(&As[kk][4 * ty]);
      const float4 bb = *reinterpret_cast<const float4*>(&Bs[kk][4 * tx]);
      const float av[4] = {a.x, a.y, a.z, a.w}, bv[4] = {bb.x, bb.y, bb.z, bb.w};
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int s = 0; s < 4; ++s) acc[r][s] = fmaf(av[r], bv[s], acc[r][s]);
    }
    __syncthreads();
  }
}

// grid (chunks * 4 row tiles * column tiles, 3, B): blockIdx.y 0 writes a
// tile of dq (rows t, columns d), 1 of dk (rows j, columns d), 2 of dv
// (rows j, columns e). dq and dk also write, for each row, the tile's share
// of q_t . (dq's carried-state term) (dint_part) and of k_j . (dk's) (da_part),
// one slot per column tile.
__global__ void __launch_bounds__(kThreads)
bwd_inputs_kernel(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, const float* __restrict__ dy,
                  const float* __restrict__ sbuf, const float* __restrict__ pbuf,
                  const float* __restrict__ C_hist, const float* __restrict__ n_hist,
                  const float* __restrict__ dC_hist, const float* __restrict__ dn_hist,
                  const float* __restrict__ ce, const float* __restrict__ ud,
                  const float* __restrict__ wa, float* __restrict__ dq, float* __restrict__ dk,
                  float* __restrict__ dv, float* __restrict__ dint_part,
                  float* __restrict__ da_part, int S, int dh) {
  __shared__ __align__(16) float As[kGK][kGT + 4];
  __shared__ __align__(16) float Bs[kGK][kGT + 4];
  const int ndt = (dh + kGT - 1) / kGT, nc = (S + kT - 1) / kT, nrt = kT / kGT;
  const int ct = blockIdx.x % ndt, rt = (blockIdx.x / ndt) % nrt, c = blockIdx.x / (ndt * nrt);
  const int which = blockIdx.y, b = blockIdx.z, tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int t0 = c * kT, tc = min(kT, S - t0), r0 = rt * kGT, c0 = ct * kGT;
  if (r0 >= tc) return;
  const int mvalid = min(kGT, tc - r0), nvalid = min(kGT, dh - c0);
  const size_t row0 = (size_t)b * S + t0, hist = (size_t)b * nc + c;
  const float* sb = sbuf + hist * kT * kT;
  const float* pb = pbuf + hist * kT * kT;
  float acc[4][4] = {}, st[4][4] = {};
  if (which == 0) {            // dS k over j < the tile's last row; dy C0^T
    tile_product<true, false>(acc, sb + (size_t)r0 * kT, kT, mvalid, k + row0 * dh + c0, dh,
                              nvalid, 0, min(tc, r0 + kGT), As, Bs);
    tile_product<true, true>(st, dy + (row0 + r0) * dh, dh, mvalid,
                             C_hist + (hist * dh + c0) * dh, dh, nvalid, 0, dh, As, Bs);
  } else if (which == 1) {     // dS^T q over t >= the tile's first row; v dC1^T
    tile_product<false, false>(acc, sb + r0, kT, mvalid, q + row0 * dh + c0, dh, nvalid, r0,
                               tc, As, Bs);
    tile_product<true, true>(st, v + (row0 + r0) * dh, dh, mvalid,
                             dC_hist + (hist * dh + c0) * dh, dh, nvalid, 0, dh, As, Bs);
  } else {                     // (P / den)^T dy over t >= the tile's first row; k dC1
    tile_product<false, false>(acc, pb + r0, kT, mvalid, dy + row0 * dh + c0, dh, nvalid, r0,
                               tc, As, Bs);
    tile_product<true, false>(st, k + (row0 + r0) * dh, dh, mvalid,
                              dC_hist + hist * dh * dh + c0, dh, nvalid, 0, dh, As, Bs);
  }
  float* out = which == 0 ? dq : (which == 1 ? dk : dv);
  const float* x = which == 0 ? q : k;
  const float* nvec = (which == 0 ? n_hist : dn_hist) + hist * dh;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int m = 4 * ty + r;
    const bool live = m < mvalid;
    const size_t tok = row0 + r0 + m;
    const float sr = live ? (which == 0 ? ce[tok] : wa[tok]) : 0.f;
    const float ur = live && which == 0 ? ud[tok] : 0.f;
    float part = 0.f;
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      const int n = 4 * tx + s;
      if (!live || n >= nvalid) continue;
      const int col = c0 + n;
      float sv;
      if (which == 0) sv = sr * st[r][s] + ur * nvec[col];
      else if (which == 1) sv = sr * (st[r][s] + nvec[col]);
      else sv = sr * st[r][s];
      out[tok * dh + col] = acc[r][s] + sv;
      if (which < 2) part = fmaf(x[tok * dh + col], sv, part);
    }
    if (which < 2) {           // the 16 lanes of a row: tx is the lane's low four bits
#pragma unroll
      for (int o = 8; o > 0; o >>= 1) part += __shfl_xor_sync(0xffffffffu, part, o);
      if (tx == 0 && live) (which == 0 ? dint_part : da_part)[tok * ndt + ct] = part;
    }
  }
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
      dcol = gi[row0 + j] + cs;
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
  w.gi = take(tok);
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
  bwd_rows_kernel<<<dim3(nc, B), kThreads, 0, st>>>(qf, yf, gf, ip, fp, w.n_hist, w.mprev,
                                                     w.sbuf, w.pbuf, w.ce, w.ud, w.rowg, w.dmf,
                                                     w.gi, w.wa, w.decay, S, dh);
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
  bwd_inputs_kernel<<<dim3(nc * (kT / kGT) * ndt, 3, B), kThreads, 0, st>>>(
      qf, kf, vf, gf, w.sbuf, w.pbuf, w.C_hist, w.n_hist, w.dC_hist, w.dn_hist, w.ce, w.ud, w.wa,
      static_cast<float*>(dq), static_cast<float*>(dk), static_cast<float*>(dv), w.dint_part,
      w.da_part, S, dh);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  bwd_gates_kernel<<<B, kThreads, 0, st>>>(ip, fp, w.mprev, w.rowg, w.gi, w.dmf, w.dint_part,
                                           w.da_part, w.dd_part, static_cast<const float*>(dm),
                                           static_cast<float*>(di), static_cast<float*>(df),
                                           static_cast<float*>(dm0), S, dh);
  return cudaGetLastError();
}
