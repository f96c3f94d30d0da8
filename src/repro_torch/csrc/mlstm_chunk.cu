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
// The chunk length is this kernel's choice (kT = 64, a ragged last chunk
// masked): the function does not depend on it in exact arithmetic, since m
// is a running max, so the kernel is held to its plain version (which
// chunks as the reference does) at the fp32 rung, not to its bits.
//
// What bounds it: operations. Per head and chunk, the scores q k^T
// (T^2 dh / 2 multiply-adds that count), w.S @ v (the same) and the two
// products with the carried state, q @ C0 and the update C += (wa k)^T v
// (T dh^2 each); at the xlstm-1.3b prefill (dh = 1024, S <= 160, B = 4) the
// dh^2 terms dominate and the bytes (q, k, v, y, C) are a few MB.
//
// Design. The TPU kernel keeps C (dh x dh) in one core's VMEM across a
// sequential chunk grid. At dh = 1024 C is 4 MB a head, far past a Hopper
// SM's 227 KB, and blocks run in parallel with nothing carried between
// them. So two launches:
//   * scores: the chunk's causal T x T q k^T in fp32 into a scratch
//     tensor, one 16 x 16 tile of the lower triangle a block (smem tiles of
//     64 dims); it depends on no state, so every chunk runs at once;
//   * state: C is split by value columns. One block per (head, 32-column
//     slice) owns C[:, slice] in shared memory (dh x 32 fp32, 128 KB at
//     dh = 1024) and walks the chunks in order: it rebuilds the chunk's
//     gate statistics and w.S from the scores (cheap, T^2), computes its
//     slice of y = (w.S @ v + e q @ C0) / den, then updates its slice of C,
//     dims in tiles of 64 staged in shared memory. Every block keeps the
//     whole of n (dh floats) because den reads all of it; block 0 writes
//     n and m. Register tiles of 4 rows x 2 columns per thread, float4 and
//     float2 shared-memory reads; q, k, v and C move as float4, and the next
//     tile of q and k is loaded into registers while the current one
//     computes.
// The chunk's log-forget prefix sums are accumulated in fp64 and rounded
// once (the plain version does the same): exact or within an fp64 ulp in
// any order, so kernel and plain version start from the same fp32 values
// even where a strongly forgetting gate makes the sums large. Accurate
// expf / log1pf (no fast-math flags in kernels/build.py).
#include "common.cuh"

namespace {

constexpr int kT = 64;          // chunk length
constexpr int kThreads = 256;
constexpr int kDv = 32;         // value columns of C a state block owns
constexpr int kDK = 64;         // dims staged per tile in the state pass
constexpr int kSK = 64;         // dims staged per tile in the scores pass
constexpr int kTP = kT + 4;     // padded row stride of the (., T) tiles
constexpr float kNegInit = -1e30f;
static_assert(kThreads == 4 * kT && kDK == kT, "the four-way partial sums");

__device__ __forceinline__ float log_sigmoid(float x) {
  return fminf(x, 0.f) - log1pf(expf(-fabsf(x)));
}

// scores[b][c][t][j] = q[b, c*kT + t] . k[b, c*kT + j] for the lower
// triangle of 16 x 16 tiles of each chunk (tiles above the diagonal are
// never read; rows past the chunk's length come out zero). grid
// (chunks * kTiles, B): one tile a block, one output a thread, so a short
// prompt's few chunks still spread over many SMs.
constexpr int kTile = 16;
constexpr int kTiles = (kT / kTile) * (kT / kTile + 1) / 2;   // 10

__global__ void __launch_bounds__(kThreads)
mlstm_scores_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    float* __restrict__ scores, int S, int dh) {
  __shared__ float qs[kTile][kSK + 1];
  __shared__ float ks[kTile][kSK + 1];
  const int c = blockIdx.x / kTiles, b = blockIdx.y, tid = threadIdx.x;
  int ti = 0, rest = blockIdx.x % kTiles;      // lower-triangle tile (ti, tj), tj <= ti
  while (rest > ti) rest -= ++ti;
  const int tj = rest;
  const int t0 = c * kT;
  const int tc = min(kT, S - t0);
  const int tx = tid % kTile, ty = tid / kTile;
  const int rq = ti * kTile, rk = tj * kTile;  // first row of each tile in the chunk
  const float* qb = q + ((size_t)b * S + t0 + rq) * dh;
  const float* kb = k + ((size_t)b * S + t0 + rk) * dh;
  float acc = 0.f;
  for (int d0 = 0; d0 < dh; d0 += kSK) {
    __syncthreads();
    for (int e = tid; e < kTile * kSK; e += kThreads) {
      const int r = e / kSK, dd = e % kSK;
      const bool in_d = d0 + dd < dh;            // dh is a multiple of 32, not of kSK
      qs[r][dd] = in_d && rq + r < tc ? qb[(size_t)r * dh + d0 + dd] : 0.f;
      ks[r][dd] = in_d && rk + r < tc ? kb[(size_t)r * dh + d0 + dd] : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int dd = 0; dd < kSK; ++dd) acc = fmaf(qs[ty][dd], ks[tx][dd], acc);
  }
  scores[(((size_t)b * (gridDim.x / kTiles) + c) * kT + rq + ty) * kT + rk + tx] = acc;
}

// A tile of q and k for the state pass: rows < kT of dims [d0, d0 + dk), read
// as float4 (dh a multiple of 32 and 16-byte aligned tensors keep every row
// aligned; the wrapper checks both), kVecs vectors of each a thread. Held in
// registers, so the next tile's loads are in flight while this one computes.
constexpr int kVecs = kT * kDK / 4 / kThreads;   // 4
struct TileRegs {
  float4 q[kVecs], k[kVecs];
};

__device__ __forceinline__ void load_tile(TileRegs& r, const float* __restrict__ q,
                                          const float* __restrict__ k, size_t row0, int tc,
                                          int dh, int d0, int dk) {
#pragma unroll
  for (int u = 0; u < kVecs; ++u) {
    const int e = threadIdx.x + u * kThreads;
    const int t = e / (kDK / 4), c4 = e % (kDK / 4);
    const bool ok = t < tc && 4 * c4 < dk;
    const size_t g = (row0 + t) * dh + d0 + 4 * c4;
    r.q[u] = ok ? *reinterpret_cast<const float4*>(q + g) : make_float4(0.f, 0.f, 0.f, 0.f);
    r.k[u] = ok ? *reinterpret_cast<const float4*>(k + g) : make_float4(0.f, 0.f, 0.f, 0.f);
  }
}

// q tile transposed into qT (dims x rows), k tile scaled by wa_j into kt.
__device__ __forceinline__ void store_tile(const TileRegs& r, float* qT, float* kt,
                                           const float* wa) {
#pragma unroll
  for (int u = 0; u < kVecs; ++u) {
    const int e = threadIdx.x + u * kThreads;
    const int t = e / (kDK / 4), c4 = e % (kDK / 4);
    qT[(4 * c4 + 0) * kTP + t] = r.q[u].x;
    qT[(4 * c4 + 1) * kTP + t] = r.q[u].y;
    qT[(4 * c4 + 2) * kTP + t] = r.q[u].z;
    qT[(4 * c4 + 3) * kTP + t] = r.q[u].w;
    const float w = wa[t];
    *reinterpret_cast<float4*>(kt + t * kTP + 4 * c4) =
        make_float4(w * r.k[u].x, w * r.k[u].y, w * r.k[u].z, w * r.k[u].w);
  }
}

// grid (dh / kDv, B): block (cb, b) owns C[b][:, cb*kDv : (cb+1)*kDv].
__global__ void __launch_bounds__(kThreads, 1)
mlstm_state_kernel(const float* __restrict__ q, const float* __restrict__ k,
                   const float* __restrict__ v, const float* __restrict__ i_pre,
                   const float* __restrict__ f_pre, const float* __restrict__ C0,
                   const float* __restrict__ n0, const float* __restrict__ m0_in,
                   const float* __restrict__ scores, float* __restrict__ y,
                   float* __restrict__ C_out, float* __restrict__ n_out,
                   float* __restrict__ m_out, int S, int dh) {
  extern __shared__ float4 smem4[];
  float* Cs = reinterpret_cast<float*>(smem4);   // (dh, kDv)
  float* ns = Cs + (size_t)dh * kDv;             // (dh,)
  float* qT = ns + dh;                           // (kDK, kTP): q tile, transposed
  float* kt = qT + kDK * kTP;                    // (kT, kTP): wa_j * k tile
  float* vs = kt + kT * kTP;                     // (kT, kDv): v, this block's columns
  float* wsT = vs + kT * kDv;                    // (kT, kTP): (w * scores)^T
  float* bcum = wsT + kT * kTP;                  // (kT,) each
  float* ii = bcum + kT;
  float* wa = ii + kT;
  float* mloc = wa + kT;
  float* isc = mloc + kT;
  float* deni = isc + kT;
  float* qnp = deni + kT;                        // (4, kT): partial q . n0
  float* npart = qnp + 4 * kT;                   // (4, kDK): partial sums of wa_j k_j
  float* scal = npart + 4 * kDK;                 // m_new, decay0

  const int cb = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  const int col0 = cb * kDv;
  const int px = tid % 16, ty = tid / 16;        // columns 2px, 2px+1; rows 4ty..4ty+3
  const int nc = (S + kT - 1) / kT;

#pragma unroll 8
  for (int e = tid; e < dh * kDv / 4; e += kThreads) {
    const int d = e / (kDv / 4), c4 = e % (kDv / 4);
    reinterpret_cast<float4*>(Cs)[e] =
        C0 ? *reinterpret_cast<const float4*>(C0 + ((size_t)b * dh + d) * dh + col0 + 4 * c4)
           : make_float4(0.f, 0.f, 0.f, 0.f);
  }
  for (int d = tid; d < dh; d += kThreads) ns[d] = n0 ? n0[(size_t)b * dh + d] : 0.f;
  float m0 = m0_in ? m0_in[b] : kNegInit;
  // q . n0 and sum_j wa_j k_j split four ways over all threads: (row or
  // dim) = tid % 64, part = tid / 64 takes every fourth term; the parts
  // add in a fixed order
  const int lane64 = tid % kT, part = tid / kT;

  for (int c = 0; c < nc; ++c) {
    const int t0 = c * kT;
    const int tc = min(kT, S - t0);
    const size_t row0 = (size_t)b * S + t0;
    TileRegs regs;                               // the first tile's loads start now
    load_tile(regs, q, k, row0, tc, dh, 0, min(kDK, dh));
    __syncthreads();
    // ---- gate statistics of the chunk ----
    if (tid < kT) {
      bcum[tid] = tid < tc ? log_sigmoid(f_pre[row0 + tid]) : 0.f;
      ii[tid] = tid < tc ? i_pre[row0 + tid] : 0.f;
    }
    __syncthreads();
    if (tid == 0) {                              // prefix sums in fp64, one rounding
      double acc = 0.0;
      for (int j = 0; j < tc; ++j) {
        acc += static_cast<double>(bcum[j]);
        bcum[j] = static_cast<float>(acc);
      }
    }
    __syncthreads();
    const float btot = bcum[tc - 1];
    if (tid < tc) {
      const int t = tid;
      float mx = ii[t];                          // j = t: b_t - b_t + i_t
      for (int j = 0; j < t; ++j) mx = fmaxf(mx, bcum[t] - bcum[j] + ii[j]);
      const float inter = bcum[t] + m0;
      mloc[t] = fmaxf(inter, mx);
      isc[t] = expf(inter - mloc[t]);
      wa[t] = btot - bcum[t] + ii[t];            // a_j, exponentiated below
    }
    __syncthreads();
    if (tid == 0) {
      float mn = btot + m0;
      for (int j = 0; j < tc; ++j) mn = fmaxf(mn, wa[j]);
      scal[0] = mn;
      scal[1] = expf(btot + m0 - mn);
    }
    __syncthreads();
    const float m_new = scal[0], decay0 = scal[1];
    if (tid < kT) wa[tid] = tid < tc ? expf(wa[tid] - m_new) : 0.f;
    // ---- w * scores (transposed), v slice ----
    const float* sc = scores + ((size_t)b * nc + c) * kT * kT;
    constexpr int kPer = kT * kT / kThreads;      // scores a thread
    float scv[kPer];
#pragma unroll
    for (int u = 0; u < kPer; ++u) scv[u] = sc[tid + u * kThreads];
#pragma unroll
    for (int u = 0; u < kT * kDv / 4 / kThreads; ++u) {
      const int e = tid + u * kThreads;
      const int j = e / (kDv / 4), c4 = e % (kDv / 4);
      reinterpret_cast<float4*>(vs)[e] =
          j < tc ? *reinterpret_cast<const float4*>(v + (row0 + j) * dh + col0 + 4 * c4)
                 : make_float4(0.f, 0.f, 0.f, 0.f);
    }
#pragma unroll
    for (int u = 0; u < kPer; ++u) {
      const int e = tid + u * kThreads;
      const int t = e / kT, j = e % kT;
      wsT[j * kTP + t] = t < tc && j <= t
          ? expf(bcum[t] - bcum[j] + ii[j] - mloc[t]) * scv[u] : 0.f;
    }
    __syncthreads();
    if (tid < kT) {
      float s = 0.f;
      for (int j = 0; j < tc; ++j) s += wsT[j * kTP + tid];
      deni[tid] = s;
    }
    // ---- intra-chunk numerator: (w * scores) @ v ----
    float yi[4][2] = {}, yq[4][2] = {};
    for (int j = 0; j < tc; ++j) {
      const float4 w4 = *reinterpret_cast<const float4*>(wsT + j * kTP + 4 * ty);
      const float2 v2 = *reinterpret_cast<const float2*>(vs + j * kDv + 2 * px);
      const float w[4] = {w4.x, w4.y, w4.z, w4.w};
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        yi[a][0] = fmaf(w[a], v2.x, yi[a][0]);
        yi[a][1] = fmaf(w[a], v2.y, yi[a][1]);
      }
    }
    // ---- the carried state, a tile of dims at a time ----
    float qn_part = 0.f;
    for (int d0 = 0; d0 < dh; d0 += kDK) {
      const int dk = min(kDK, dh - d0);
      __syncthreads();                           // previous tile consumed
      store_tile(regs, qT, kt, wa);
      __syncthreads();
      if (d0 + kDK < dh) load_tile(regs, q, k, row0, tc, dh, d0 + kDK, min(kDK, dh - d0 - kDK));
      // y's inter term q @ C0 and den's q . n0, with the state before this chunk
      for (int dd = 0; dd < dk; ++dd) {
        const float4 q4 = *reinterpret_cast<const float4*>(qT + dd * kTP + 4 * ty);
        const float2 c2 = *reinterpret_cast<const float2*>(Cs + (size_t)(d0 + dd) * kDv + 2 * px);
        const float qq[4] = {q4.x, q4.y, q4.z, q4.w};
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          yq[a][0] = fmaf(qq[a], c2.x, yq[a][0]);
          yq[a][1] = fmaf(qq[a], c2.y, yq[a][1]);
        }
      }
      for (int dd = part; dd < dk; dd += 4)
        qn_part = fmaf(qT[dd * kTP + lane64], ns[d0 + dd], qn_part);
      __syncthreads();                           // old C and n of this tile read
      // C[d, :] = decay0 * C[d, :] + sum_j (wa_j k_j[d]) v_j[:]
      if (4 * ty < dk) {
        float cu[4][2] = {};
        for (int j = 0; j < tc; ++j) {
          const float4 k4 = *reinterpret_cast<const float4*>(kt + j * kTP + 4 * ty);
          const float2 v2 = *reinterpret_cast<const float2*>(vs + j * kDv + 2 * px);
          const float kk[4] = {k4.x, k4.y, k4.z, k4.w};
#pragma unroll
          for (int a = 0; a < 4; ++a) {
            cu[a][0] = fmaf(kk[a], v2.x, cu[a][0]);
            cu[a][1] = fmaf(kk[a], v2.y, cu[a][1]);
          }
        }
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          float* cr = Cs + (size_t)(d0 + 4 * ty + a) * kDv + 2 * px;
          cr[0] = decay0 * cr[0] + cu[a][0];
          cr[1] = decay0 * cr[1] + cu[a][1];
        }
      }
      {
        float s = 0.f;
        if (lane64 < dk)
          for (int j = part; j < tc; j += 4) s += kt[j * kTP + lane64];
        npart[part * kDK + lane64] = s;
      }
      __syncthreads();
      if (tid < dk)
        ns[d0 + tid] = decay0 * ns[d0 + tid] +
                       ((npart[tid] + npart[kDK + tid]) + (npart[2 * kDK + tid] + npart[3 * kDK + tid]));
    }
    qnp[part * kT + lane64] = qn_part;
    __syncthreads();
    // ---- outputs of the chunk ----
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int t = 4 * ty + a;
      if (t < tc) {
        const float qn = (qnp[t] + qnp[kT + t]) + (qnp[2 * kT + t] + qnp[3 * kT + t]);
        const float den = fmaxf(fabsf(deni[t] + isc[t] * qn), expf(-mloc[t]));
        float* yr = y + (row0 + t) * dh + col0 + 2 * px;
        yr[0] = (yi[a][0] + isc[t] * yq[a][0]) / den;
        yr[1] = (yi[a][1] + isc[t] * yq[a][1]) / den;
      }
    }
    m0 = m_new;
  }

  __syncthreads();
  for (int e = tid; e < dh * kDv / 4; e += kThreads) {
    const int d = e / (kDv / 4), c4 = e % (kDv / 4);
    *reinterpret_cast<float4*>(C_out + ((size_t)b * dh + d) * dh + col0 + 4 * c4) =
        reinterpret_cast<const float4*>(Cs)[e];
  }
  if (cb == 0) {
    for (int d = tid; d < dh; d += kThreads) n_out[(size_t)b * dh + d] = ns[d];
    if (tid == 0) m_out[b] = m0;
  }
}

size_t state_smem_bytes(int dh) {
  return sizeof(float) * ((size_t)dh * kDv + dh + kDK * kTP + 2 * kT * kTP + kT * kDv +
                          10 * kT + 4 * kDK + 4);
}

}  // namespace

// dh a multiple of kDv and at most 1024 (C's slice must fit shared memory),
// q, k, v, C0 and C 16-byte aligned; the wrapper checks all three.
// scores: scratch of B * ceil(S / 64) * 64 * 64 floats.
extern "C" int sct_mlstm_chunk(const void* q, const void* k, const void* v, const void* i_pre,
                               const void* f_pre, const void* C0, const void* n0,
                               const void* m0, void* scores, void* y, void* C, void* n,
                               void* m, int B, int S, int dh, void* stream) {
  if (B <= 0) return cudaSuccess;
  if (S <= 0 || dh <= 0 || dh % kDv != 0 || dh > 1024) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int nc = (S + kT - 1) / kT;
  mlstm_scores_kernel<<<dim3(nc * kTiles, B), kThreads, 0, st>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<float*>(scores), S, dh);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const size_t smem = state_smem_bytes(dh);
  err = sct::allow_smem(mlstm_state_kernel, smem);
  if (err != cudaSuccess) return err;
  mlstm_state_kernel<<<dim3(dh / kDv, B), kThreads, smem, st>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const float*>(i_pre), static_cast<const float*>(f_pre),
      static_cast<const float*>(C0), static_cast<const float*>(n0),
      static_cast<const float*>(m0), static_cast<const float*>(scores),
      static_cast<float*>(y), static_cast<float*>(C), static_cast<float*>(n),
      static_cast<float*>(m), S, dh);
  return cudaGetLastError();
}
