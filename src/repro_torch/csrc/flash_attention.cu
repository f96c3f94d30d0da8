// Causal flash attention for Hopper, forward and backward, over the model's
// grouped-query layout.
//
// The forward replaces the TPU kernel kernels/flash_attention.py:
// flash_attention_pallas of the JAX package (and its jnp twin
// nn/attention.py:_flash_fwd_impl, which the model runs); the backward is
// the JAX package's jnp nn/attention.py:_flash_bwd_impl, which has no
// Pallas kernel.
//
// q (b, sq, g, r, d), k/v (b, skv, g, d), out/dout like q, the softmax
// statistics m/l and the backward's delta (b, sq, g, r) fp32; T is fp32 or
// bf16, d is 64 or 128. The reference's casts, in order: Q.K^T and dO.V^T
// are summed in fp32 and rounded to T once (its einsums return T), then
// softmax, statistics and accumulators are fp32; p is rounded to T before
// P.V and ds before dQ/dK; every output is rounded once. (In bf16 the
// rounding of dO.V^T matters: dp - delta cancels.)
//
// What bounds it: operations. At the training shape (b 2, s 4096, 32 heads,
// d 64) the forward does 2 * 2 * b * h * s^2 * d / 2 = 137 GFLOP against
// 128 MB of q/k/v/out, ~1000 flops per byte; the backward 2.5 times the
// forward's flops.
//
// Design. A block of 128 threads owns a tile of 64 query rows, where a row
// is one (position, head of the group) pair: 64 / r positions times the r
// heads that share a kv head, so every staged K/V tile serves the whole
// group (the TPU kernel folds heads into its grid instead and reads K/V
// once per head). The TPU kernel carries its online-softmax state across a
// sequential grid axis in VMEM; here a loop inside the block walks the kv
// tiles and the state lives in shared memory. Causal tiles past the
// block's last position are skipped: they would add exactly zero. Each tile
// product runs from shared memory: mma.sync m16n8k16 on the tensor cores
// for bf16 (fp32 accumulate), plain fp32 FMAs for fp32, so the fp32
// kernel computes the same sums as the plain version in another order.
// The backward is two kernels and needs no atomics: one block per query
// tile computes delta and dQ, then one block per kv tile walks the query
// tiles at or after it and sums dK and dV over the group's r heads.
#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 64;           // query rows (position, head) per tile
constexpr float kNegInf = -1e30f;

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

__device__ __forceinline__ uint32_t pack_bf16(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  __nv_bfloat162 v;
  v.x = lo;
  v.y = hi;
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// C[M x N] (fp32, shared, row stride ldc) = (acc ? C : 0) + sum_k A(m,k) B(k,n)
// with A(m,k) = A[m*am + k*ak] and B(k,n) = B[k*bk + n*bn] in shared memory.
// bf16: the 4 warps take 16-row strips of C (and, for N > 64, 64-column
// groups) and run mma.sync on fragments gathered with the given strides.
template <int M, int N, int K>
__device__ __forceinline__ void tile_gemm(float* C, int ldc, const __nv_bfloat16* A, int am,
                                          int ak, const __nv_bfloat16* B, int bk, int bn,
                                          bool acc) {
  static_assert(M % 16 == 0 && N % 8 == 0 && K % 16 == 0, "mma tile shape");
  constexpr int kNT = N / 8;
  constexpr int kPerUnit = kNT < 8 ? kNT : 8;
  constexpr int kGroups = kNT / kPerUnit;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gq = lane >> 2, tq = lane & 3;
  for (int u = warp; u < (M / 16) * kGroups; u += kWarps) {
    const int r0 = (u / kGroups) * 16;
    const int n0 = (u % kGroups) * kPerUnit * 8;
    float c[kPerUnit][4];
#pragma unroll
    for (int j = 0; j < kPerUnit; ++j) c[j][0] = c[j][1] = c[j][2] = c[j][3] = 0.f;
    const __nv_bfloat16* a_lo = A + (r0 + gq) * am;
    const __nv_bfloat16* a_hi = a_lo + 8 * am;
#pragma unroll 2
    for (int k0 = 0; k0 < K; k0 += 16) {
      const int ka = k0 + 2 * tq;
      uint32_t a[4];
      a[0] = pack_bf16(a_lo[ka * ak], a_lo[(ka + 1) * ak]);
      a[1] = pack_bf16(a_hi[ka * ak], a_hi[(ka + 1) * ak]);
      a[2] = pack_bf16(a_lo[(ka + 8) * ak], a_lo[(ka + 9) * ak]);
      a[3] = pack_bf16(a_hi[(ka + 8) * ak], a_hi[(ka + 9) * ak]);
#pragma unroll
      for (int j = 0; j < kPerUnit; ++j) {
        const __nv_bfloat16* bcol = B + (n0 + j * 8 + gq) * bn;
        uint32_t b[2];
        b[0] = pack_bf16(bcol[ka * bk], bcol[(ka + 1) * bk]);
        b[1] = pack_bf16(bcol[(ka + 8) * bk], bcol[(ka + 9) * bk]);
        mma_bf16(c[j], a, b);
      }
    }
#pragma unroll
    for (int j = 0; j < kPerUnit; ++j) {
      float* c_lo = C + (r0 + gq) * ldc + n0 + j * 8 + 2 * tq;
      float* c_hi = c_lo + 8 * ldc;
      if (acc) {
        c_lo[0] += c[j][0];
        c_lo[1] += c[j][1];
        c_hi[0] += c[j][2];
        c_hi[1] += c[j][3];
      } else {
        c_lo[0] = c[j][0];
        c_lo[1] = c[j][1];
        c_hi[0] = c[j][2];
        c_hi[1] = c[j][3];
      }
    }
  }
}

// fp32: each thread owns a (M/16) x (N/8) micro-tile, rows tr + 16 i and
// columns tc + 8 j, and sums over k in order with FMAs.
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

template <typename T, int D, int BK>
struct FwdSmem {
  static constexpr int kLd = ld_of<T>(D), kLds = ldf_of(BK), kLdp = ld_of<T>(BK),
                       kLdo = ldf_of(D);
  static constexpr size_t kBytes =
      sizeof(T) * (size_t)(kRows * kLd + 2 * BK * kLd + kRows * kLdp) +
      sizeof(float) * (size_t)(kRows * kLds + kRows * kLdo + 2 * kRows);
};

template <typename T, int D, int BK>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 T* __restrict__ out, float* __restrict__ m_out, float* __restrict__ l_out,
                 int sq, int skv, int G, int r, int causal, float scale) {
  using S = FwdSmem<T, D, BK>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* qs = reinterpret_cast<T*>(smem_raw);
  T* ks = qs + kRows * S::kLd;
  T* vs = ks + BK * S::kLd;
  T* ps = vs + BK * S::kLd;
  float* sc = reinterpret_cast<float*>(ps + kRows * S::kLdp);
  float* o = sc + kRows * S::kLds;
  float* mrow = o + kRows * S::kLdo;
  float* lrow = mrow + kRows;

  const int per = kRows / r;
  const QTile t{static_cast<int>(blockIdx.y) / G, static_cast<int>(blockIdx.y) % G,
                static_cast<int>(blockIdx.x) * per, per, r, sq, G};
  const int tid = threadIdx.x;
  load_rows<T, D>(qs, S::kLd, q, kRows,
                  [&](int rho) { return t.valid(rho) ? t.stat(rho) * D : -1LL; });
  for (int i = tid; i < kRows * D; i += kThreads) o[(i / D) * S::kLdo + i % D] = 0.f;
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
    auto kv_row = [&](int j) {
      const int kp = k0 + j;
      return kp < skv ? ((static_cast<long long>(t.bi) * skv + kp) * G + t.gi) * D : -1LL;
    };
    load_rows<T, D>(ks, S::kLd, k, BK, kv_row);
    load_rows<T, D>(vs, S::kLd, v, BK, kv_row);
    __syncthreads();
    tile_gemm<kRows, BK, D>(sc, S::kLds, qs, S::kLd, 1, ks, 1, S::kLd, false);
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
      for (int c = half * (D / 2); c < (half + 1) * (D / 2); ++c) orow[c] *= a;
      __syncwarp();
      if (half == 0) {
        lrow[rho] = lrow[rho] * a + sum;
        mrow[rho] = m_new;
      }
    }
    __syncthreads();
    tile_gemm<kRows, D, BK>(o, S::kLdo, ps, S::kLdp, 1, vs, S::kLd, 1, true);
  }
  __syncthreads();
  for (int i = tid; i < kRows * D; i += kThreads) {
    const int row = i / D, c = i % D;
    if (t.valid(row))
      out[t.stat(row) * D + c] =
          sct::from_float<T>(o[row * S::kLdo + c] / fmaxf(lrow[row], 1e-30f));
  }
  for (int i = tid; i < kRows; i += kThreads) {
    if (t.valid(i)) {
      m_out[t.stat(i)] = mrow[i];
      l_out[t.stat(i)] = lrow[i];
    }
  }
}

template <typename T, int D, int BK>
struct DqSmem {
  static constexpr int kLd = ld_of<T>(D), kLds = ldf_of(BK), kLdp = ld_of<T>(BK),
                       kLdo = ldf_of(D);
  static constexpr size_t kBytes =
      sizeof(T) * (size_t)(2 * kRows * kLd + 2 * BK * kLd + kRows * kLdp) +
      sizeof(float) * (size_t)(2 * kRows * kLds + kRows * kLdo + 3 * kRows);
};

// delta and dQ for one query tile; delta goes to global memory for the
// dK/dV kernel, which runs after this one on the same stream.
template <typename T, int D, int BK>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                    const T* __restrict__ out, const T* __restrict__ dout,
                    const float* __restrict__ m_in, const float* __restrict__ l_in,
                    float* __restrict__ delta_out, T* __restrict__ dq, int sq, int skv, int G,
                    int r, int causal, float scale) {
  using S = DqSmem<T, D, BK>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* qs = reinterpret_cast<T*>(smem_raw);
  T* dos = qs + kRows * S::kLd;
  T* ks = dos + kRows * S::kLd;
  T* vs = ks + BK * S::kLd;
  T* dss = vs + BK * S::kLd;
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
  auto q_row = [&](int rho) { return t.valid(rho) ? t.stat(rho) * D : -1LL; };
  load_rows<T, D>(qs, S::kLd, q, kRows, q_row);
  load_rows<T, D>(dos, S::kLd, dout, kRows, q_row);
  for (int i = tid; i < kRows * D; i += kThreads) dqa[(i / D) * S::kLdo + i % D] = 0.f;
  const int rho = tid >> 1, half = tid & 1;
  const int qpos = t.pos(rho);
  {
    // delta = rowsum(dO * O) in fp32, two threads a row
    float dsum = 0.f;
    if (t.valid(rho)) {
      const T* orow = out + t.stat(rho) * D;
      const T* drow_g = dout + t.stat(rho) * D;
      for (int c = half * (D / 2); c < (half + 1) * (D / 2); ++c)
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
    auto kv_row = [&](int j) {
      const int kp = k0 + j;
      return kp < skv ? ((static_cast<long long>(t.bi) * skv + kp) * G + t.gi) * D : -1LL;
    };
    load_rows<T, D>(ks, S::kLd, k, BK, kv_row);
    load_rows<T, D>(vs, S::kLd, v, BK, kv_row);
    __syncthreads();
    tile_gemm<kRows, BK, D>(sc, S::kLds, qs, S::kLd, 1, ks, 1, S::kLd, false);
    tile_gemm<kRows, BK, D>(dp, S::kLds, dos, S::kLd, 1, vs, 1, S::kLd, false);
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
    tile_gemm<kRows, D, BK>(dqa, S::kLdo, dss, S::kLdp, 1, ks, S::kLd, 1, true);
  }
  __syncthreads();
  for (int i = tid; i < kRows * D; i += kThreads) {
    const int row = i / D, c = i % D;
    if (t.valid(row)) dq[t.stat(row) * D + c] = sct::from_float<T>(dqa[row * S::kLdo + c]);
  }
}

template <typename T, int D, int BK>
struct DkvSmem {
  static constexpr int kLd = ld_of<T>(D), kLds = ldf_of(BK), kLdp = ld_of<T>(BK),
                       kLdo = ldf_of(D);
  static constexpr size_t kBytes =
      sizeof(T) * (size_t)(2 * BK * kLd + 2 * kRows * kLd + 2 * kRows * kLdp) +
      sizeof(float) * (size_t)(2 * BK * kLdo + 2 * kRows * kLds + 3 * kRows);
};

// dK and dV for one kv tile, summed over every query tile at or after it
// and over the r heads of the group.
template <typename T, int D, int BK>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const T* __restrict__ dout,
                      const float* __restrict__ m_in, const float* __restrict__ l_in,
                      const float* __restrict__ delta_in, T* __restrict__ dk,
                      T* __restrict__ dv, int sq, int skv, int G, int r, int causal,
                      float scale) {
  using S = DkvSmem<T, D, BK>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* ks = reinterpret_cast<T*>(smem_raw);
  T* vs = ks + BK * S::kLd;
  T* qs = vs + BK * S::kLd;
  T* dos = qs + kRows * S::kLd;
  T* ps = dos + kRows * S::kLd;
  T* dss = ps + kRows * S::kLdp;
  float* dka = reinterpret_cast<float*>(dss + kRows * S::kLdp);
  float* dva = dka + BK * S::kLdo;
  float* sc = dva + BK * S::kLdo;
  float* dp = sc + kRows * S::kLds;
  float* mrow = dp + kRows * S::kLds;
  float* lrow = mrow + kRows;
  float* drow = lrow + kRows;

  const int bi = static_cast<int>(blockIdx.y) / G, gi = static_cast<int>(blockIdx.y) % G;
  const int k0 = static_cast<int>(blockIdx.x) * BK;
  const int tid = threadIdx.x;
  auto kv_row = [&](int j) {
    const int kp = k0 + j;
    return kp < skv ? ((static_cast<long long>(bi) * skv + kp) * G + gi) * D : -1LL;
  };
  load_rows<T, D>(ks, S::kLd, k, BK, kv_row);
  load_rows<T, D>(vs, S::kLd, v, BK, kv_row);
  for (int i = tid; i < BK * D; i += kThreads) {
    dka[(i / D) * S::kLdo + i % D] = 0.f;
    dva[(i / D) * S::kLdo + i % D] = 0.f;
  }
  const int per = kRows / r;
  const int rho = tid >> 1, half = tid & 1;
  // causal: query positions before k0 see none of this tile
  const int q_first = causal ? (k0 / per) * per : 0;

  for (int q0 = q_first; q0 < sq; q0 += per) {
    const QTile t{bi, gi, q0, per, r, sq, G};
    __syncthreads();   // the previous query tile is consumed
    auto q_row = [&](int row) { return t.valid(row) ? t.stat(row) * D : -1LL; };
    load_rows<T, D>(qs, S::kLd, q, kRows, q_row);
    load_rows<T, D>(dos, S::kLd, dout, kRows, q_row);
    for (int i = tid; i < kRows; i += kThreads) {
      const bool ok = t.valid(i);
      mrow[i] = ok ? m_in[t.stat(i)] : 0.f;
      lrow[i] = ok ? fmaxf(l_in[t.stat(i)], 1e-30f) : 1.f;
      drow[i] = ok ? delta_in[t.stat(i)] : 0.f;
    }
    __syncthreads();
    tile_gemm<kRows, BK, D>(sc, S::kLds, qs, S::kLd, 1, ks, 1, S::kLd, false);
    tile_gemm<kRows, BK, D>(dp, S::kLds, dos, S::kLd, 1, vs, 1, S::kLd, false);
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
    tile_gemm<BK, D, kRows>(dva, S::kLdo, ps, 1, S::kLdp, dos, S::kLd, 1, true);
    tile_gemm<BK, D, kRows>(dka, S::kLdo, dss, 1, S::kLdp, qs, S::kLd, 1, true);
  }
  __syncthreads();
  for (int i = tid; i < BK * D; i += kThreads) {
    const int row = i / D, c = i % D;
    const long long off = kv_row(row);
    if (off >= 0) {
      dk[off + c] = sct::from_float<T>(dka[row * S::kLdo + c]);
      dv[off + c] = sct::from_float<T>(dva[row * S::kLdo + c]);
    }
  }
}

template <typename T, int D, int BK>
cudaError_t launch_fwd(const void* q, const void* k, const void* v, void* out, void* m,
                       void* l, int b, int sq, int skv, int G, int r, int causal, float scale,
                       cudaStream_t stream) {
  using S = FwdSmem<T, D, BK>;
  auto kernel = flash_fwd_kernel<T, D, BK>;
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

template <typename T, int D, int BK>
cudaError_t launch_bwd(const void* q, const void* k, const void* v, const void* out,
                       const void* dout, const void* m, const void* l, void* delta, void* dq,
                       void* dk, void* dv, int b, int sq, int skv, int G, int r, int causal,
                       float scale, cudaStream_t stream) {
  auto dq_kernel = flash_bwd_dq_kernel<T, D, BK>;
  auto dkdv_kernel = flash_bwd_dkdv_kernel<T, D, BK>;
  cudaError_t err = sct::allow_smem(dq_kernel, DqSmem<T, D, BK>::kBytes);
  if (err != cudaSuccess) return err;
  err = sct::allow_smem(dkdv_kernel, DkvSmem<T, D, BK>::kBytes);
  if (err != cudaSuccess) return err;
  const int per = kRows / r;
  dq_kernel<<<dim3((sq + per - 1) / per, b * G), kThreads, DqSmem<T, D, BK>::kBytes,
              stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(out), static_cast<const T*>(dout), static_cast<const float*>(m),
      static_cast<const float*>(l), static_cast<float*>(delta), static_cast<T*>(dq), sq, skv,
      G, r, causal, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  dkdv_kernel<<<dim3((skv + BK - 1) / BK, b * G), kThreads, DkvSmem<T, D, BK>::kBytes,
                stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), static_cast<const float*>(m), static_cast<const float*>(l),
      static_cast<const float*>(delta), static_cast<T*>(dk), static_cast<T*>(dv), sq, skv, G,
      r, causal, scale);
  return cudaGetLastError();
}

bool shape_ok(int b, int sq, int skv, int G, int r, int d) {
  return b > 0 && sq > 0 && skv > 0 && G > 0 && r > 0 && r <= kRows && (d == 64 || d == 128);
}

}  // namespace

// Head dim 64 runs 64-row kv tiles, 128 runs 32-row kv tiles (shared memory).
extern "C" int sct_flash_attention_fwd(const void* q, const void* k, const void* v, void* out,
                                       void* m, void* l, int b, int sq, int skv, int G, int r,
                                       int d, int causal, int dtype, float scale,
                                       void* stream) {
  if (!shape_ok(b, sq, skv, G, r, d)) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == sct::kBFloat16) {
    if (d == 64)
      return launch_fwd<__nv_bfloat16, 64, 64>(q, k, v, out, m, l, b, sq, skv, G, r, causal,
                                               scale, st);
    return launch_fwd<__nv_bfloat16, 128, 32>(q, k, v, out, m, l, b, sq, skv, G, r, causal,
                                              scale, st);
  }
  if (dtype == sct::kFloat32) {
    if (d == 64)
      return launch_fwd<float, 64, 64>(q, k, v, out, m, l, b, sq, skv, G, r, causal, scale,
                                       st);
    return launch_fwd<float, 128, 32>(q, k, v, out, m, l, b, sq, skv, G, r, causal, scale,
                                      st);
  }
  return cudaErrorInvalidValue;
}

// delta (b, sq, g, r) fp32 is scratch from the wrapper.
extern "C" int sct_flash_attention_bwd(const void* q, const void* k, const void* v,
                                       const void* out, const void* dout, const void* m,
                                       const void* l, void* delta, void* dq, void* dk,
                                       void* dv, int b, int sq, int skv, int G, int r, int d,
                                       int causal, int dtype, float scale, void* stream) {
  if (!shape_ok(b, sq, skv, G, r, d)) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == sct::kBFloat16) {
    if (d == 64)
      return launch_bwd<__nv_bfloat16, 64, 64>(q, k, v, out, dout, m, l, delta, dq, dk, dv, b,
                                               sq, skv, G, r, causal, scale, st);
    return launch_bwd<__nv_bfloat16, 128, 32>(q, k, v, out, dout, m, l, delta, dq, dk, dv, b,
                                              sq, skv, G, r, causal, scale, st);
  }
  if (dtype == sct::kFloat32) {
    if (d == 64)
      return launch_bwd<float, 64, 64>(q, k, v, out, dout, m, l, delta, dq, dk, dv, b, sq,
                                       skv, G, r, causal, scale, st);
    return launch_bwd<float, 128, 32>(q, k, v, out, dout, m, l, delta, dq, dk, dv, b, sq, skv,
                                      G, r, causal, scale, st);
  }
  return cudaErrorInvalidValue;
}
