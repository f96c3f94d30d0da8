// Absorbed-MLA paged flash-decode for Hopper: one-token attention of every
// query head straight against the paged latent pools, walking each slot's
// block table inside the kernel.
//
// Replaces the TPU kernels kernels/paged_decode.py:paged_mla_decode_pallas
// and paged_mla_decode_cold_pallas of the JAX package.
//
// q_lat (b, h, L) is q_nope already absorbed through W_uk, q_rope (b, h, R),
// both in TQ (fp32 on the serving path, or bf16); the latent pools ckv
// (P+1, page, L) and kr (P+1, page, R) are bf16; block_table (b, n_pages)
// int32; seq_lens (b,) int32; out o_lat (b, h, L) in TQ. Position pos of
// slot i is valid when pos <= seq_lens[i]. The score is
// (q_lat . ckv + q_rope . kr) * scale, with scale = 1/sqrt(qk_nope + qk_rope)
// passed in (the pre-absorption head dim, not L); the latent rows ckv are
// also the values, so o_lat = softmax(scores) . ckv. Scores, softmax and the
// accumulator are fp32 with one rounding at the output (the fp32 decode
// contract of nn/attention.py).
//
// What bounds it: operations. All h heads read the same latent rows, so a
// 4-slot step at ~100 tokens a slot moves ~2 MB (q_lat in, o_lat out, the
// live pages) but does 2 * b * h * len * (2L + R) ~ 0.1 GFLOP of fp32 math.
//
// Design. Work items, not clusters: each slot's table is cut into items of
// `ppi` pages, and block (i * items a slot + k) takes item k of slot i. The
// host picks ppi (kernels/paged_decode.py:mla_geometry) from b, h and the
// table width alone, so that the grid about covers the SMs once. A block
// loads its slot's length and its first page id together; an item past the
// live pages (those up to the one holding position seq_lens[i]) returns at
// once, before any barrier, so every block that stays has live pages to
// walk. grid.y cuts the heads into groups of 64.
//
// A block stages each 16-row tile of its pages once, for its 64 heads, into
// a two-tile ring of shared memory with 16-byte cp.async copies (8-byte
// where L or R is not a multiple of 8), the next tile in flight while the
// current one computes. Both products run on the tensor cores, mma.sync
// m16n8k16 in bf16 with fp32 accumulators. The keys and values are bf16, so
// exact in the instruction; every fp32 operand on the other side (q, and the
// probabilities p) is split into three bf16 parts, x = hi + mid + lo (24 of
// its 24 significand bits), and the three products are summed in fp32, lo
// first. Scores: 8 warps, 4 row tiles of 16 heads x 2 halves of the L + R
// depth; the halves meet in shared memory. Softmax: four threads a head,
// quad shuffles, an online update of the running max m and sum l. p . v:
// each warp owns 32 heads x 128 latent columns of the accumulator in
// registers, its B fragments through ldmatrix.trans.
//
// A slot with one item writes o_lat directly. Otherwise every block writes
// its partial state (accumulator, m, l) to scratch, and a second, small
// kernel combines a slot's items in item order: it reads each item's m and l
// once per head row, then sums the accumulators with those weights. The
// order is fixed, so two calls give the same bits.
//
// The cold variant (the streaming cold tier) adds int8 shadow pools ckv_q8 /
// kr_q8 (the pools' shapes), their per-page fp32 scales (P+1, L) / (P+1, R)
// and cold_flags (P+1,) int32. A page's flag loads while its bf16 rows are
// already being copied; a flagged page's codes are copied too (16-byte
// cp.async) and widened over those rows in shared memory to bf16, exact for
// |q8| <= 127, and its scales are staged beside them. The scale is a per-column factor, so
// it moves off the bf16 operand: the score of a cold tile splits
// (q * scale) into its parts, and its p . v product is accumulated apart and
// added times the column's scale. Each is the reference's q8 * scale
// product in another order (one fp32 rounding apart). Hot tiles run the hot
// kernel's instructions; it is the same template with kCold set, so with no
// page flagged its output is bit-identical to the hot kernel's by
// construction.
#include <cstdint>

#include "common.cuh"
#include "mma.cuh"

using namespace sct::mma;

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;   // 8 warps
constexpr int kHeads = 64;      // query heads a block serves from one staged tile
constexpr int kRows = 16;       // token rows a staged tile holds: one k-step of p . v
constexpr int kSPad = 24;       // row stride (floats) of the score and probability tiles
constexpr int kWarpCols = 128;  // latent columns of the accumulator a warp owns
constexpr size_t kMaxSmem = 232448;
constexpr float kNegInf = -1e30f;

// The cold tier's inputs; null pointers in the hot kernel.
struct ColdPools {
  const int8_t* ckv_q8;
  const float* ckv_scale;
  const int8_t* kr_q8;
  const float* kr_scale;
  const int* flags;
};

// Shared-memory layout: q (kHeads, qs) fp32 rows [q_lat | 0 | q_rope | 0];
// the ring (2, kRows, ks) of bf16 key rows [ckv | 0 | kr | 0]; cold only,
// the codes (2, kRows, kd) int8 and the scales (2, kd) fp32; the partial
// scores (2, kHeads, kSPad) (p overwrites half 0); m, l, alpha.
struct Layout {
  int lp, kd, qs, ks;
  size_t q, ring, raw, scale, sp, stats, total;
};

__host__ __device__ inline Layout make_layout(int lat, int rope, bool cold) {
  Layout L;
  L.lp = (lat + 15) / 16 * 16;
  L.kd = L.lp + (rope + 15) / 16 * 16;
  L.qs = L.kd + 8;   // = 8 or 24 mod 32 floats: the A-fragment loads hit no bank twice
  L.ks = L.kd + 8;   // an odd multiple of 16 bytes: ldmatrix rows hit distinct banks
  size_t off = 0;
  L.q = off;
  off += sizeof(float) * kHeads * L.qs;
  L.ring = off;
  off += sizeof(bf16) * 2 * kRows * L.ks;
  L.raw = off;
  if (cold) off += 2 * kRows * L.kd;
  L.scale = off;
  if (cold) off += sizeof(float) * 2 * L.kd;
  L.sp = off;
  off += sizeof(float) * 2 * kHeads * kSPad;
  L.stats = off;
  off += sizeof(float) * 3 * kHeads;
  L.total = off;
  return L;
}

__device__ __forceinline__ void cp_async8(void* smem, const void* gmem, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(smem_addr(smem)),
               "l"(gmem), "r"(valid ? 8 : 0));
}

// four q values into shared fp32: fp32 by cp.async, bf16 widened in registers
__device__ __forceinline__ void load4(float* dst, const float* src) {
  cp_async16(dst, src, true);
}
__device__ __forceinline__ void load4(float* dst, const bf16* src) {
  const uint2 u = *reinterpret_cast<const uint2*>(src);
  const __nv_bfloat162 a = *reinterpret_cast<const __nv_bfloat162*>(&u.x);
  const __nv_bfloat162 c = *reinterpret_cast<const __nv_bfloat162*>(&u.y);
  *reinterpret_cast<float4*>(dst) =
      make_float4(__low2float(a), __high2float(a), __low2float(c), __high2float(c));
}

// (x0, x1) = hi + mid + lo, each part a packed bf16 pair (one paired
// conversion a part): x - hi and (x - hi) - mid are exact in fp32, so the
// parts carry all 24 bits
__device__ __forceinline__ void split3(float x0, float x1, uint32_t& hi, uint32_t& mid,
                                      uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float r0 = x0 - __low2float(h), r1 = x1 - __high2float(h);
  const __nv_bfloat162 m = __floats2bfloat162_rn(r0, r1);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  mid = *reinterpret_cast<const uint32_t*>(&m);
  lo = pack_bf16(r0 - __low2float(m), r1 - __high2float(m));
}

template <typename T>
__device__ __forceinline__ void store2(T* dst, float a, float b);
template <>
__device__ __forceinline__ void store2<float>(float* dst, float a, float b) {
  *reinterpret_cast<float2*>(dst) = make_float2(a, b);
}
template <>
__device__ __forceinline__ void store2<bf16>(bf16* dst, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(a, b);
}

template <typename TQ, bool kCold>
__global__ void __launch_bounds__(kThreads, 1)
mla_decode_kernel(const TQ* __restrict__ q_lat, const TQ* __restrict__ q_rope,
                  const bf16* __restrict__ ckv_pool, const bf16* __restrict__ kr_pool,
                  const int* __restrict__ block_table, const int* __restrict__ seq_lens,
                  TQ* __restrict__ out, float* __restrict__ part_o, float* __restrict__ part_ml,
                  int b, int h, int lat, int rope, int page, int n_pages, int ppi, float scale,
                  ColdPools cold) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout L = make_layout(lat, rope, kCold);
  float* qs = reinterpret_cast<float*>(smem + L.q);
  bf16* ring = reinterpret_cast<bf16*>(smem + L.ring);
  int8_t* raw = reinterpret_cast<int8_t*>(smem + L.raw);
  float* scs = reinterpret_cast<float*>(smem + L.scale);
  float* sp = reinterpret_cast<float*>(smem + L.sp);
  float* mrow = reinterpret_cast<float*>(smem + L.stats);
  float* lrow = mrow + kHeads;
  float* alpha = lrow + kHeads;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int z = blockIdx.x, h0 = blockIdx.y * kHeads;
  const int per_slot = gridDim.x / b;
  const int i = z / per_slot, pa = (z % per_slot) * ppi;
  sct::allow_dependents();            // the combine pass may launch and wait
  // the slot's length and the item's first page id load together
  const int len = seq_lens[i];
  const int phys0 = block_table[(size_t)i * n_pages + pa];
  const int live = min(n_pages, len / page + 1);   // pages up to the one holding len
  if (pa >= live) return;             // past the slot's live pages: nothing to walk
  const int pe = min(live, pa + ppi), n_items = (live + ppi - 1) / ppi;
  const int nh = min(kHeads, h - h0);
  const int nsub = (page + kRows - 1) / kRows;   // tiles a page
  // tiles of the item whose first position is live (a prefix of its tiles)
  const int ntiles = (pe - pa - 1) * nsub + min(nsub, (len - (pe - 1) * page) / kRows + 1);

  // q rows (zero past h and in the pads), a warp a row; pads of the ring and
  // the scales (never staged)
  for (int r = warp; r < kHeads; r += kThreads / 32) {
    float* qrow = qs + r * L.qs;
    const size_t row = (size_t)i * h + h0 + r;
    for (int c = 4 * lane; c < L.kd; c += 128) {
      const bool lat_part = c < L.lp;
      const int cc = lat_part ? c : c - L.lp;
      if (r < nh && cc < (lat_part ? lat : rope))
        load4(qrow + c, lat_part ? q_lat + row * lat + cc : q_rope + row * rope + cc);
      else
        *reinterpret_cast<float4*>(qrow + c) = make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }
  const int lpad = L.lp - lat, npad = lpad + L.kd - L.lp - rope;
  for (int r = warp; r < 2 * kRows + (kCold ? 2 : 0); r += kThreads / 32) {
    for (int c = lane; c < npad; c += 32) {
      const int col = c < lpad ? lat + c : L.lp + rope + c - lpad;
      if (r < 2 * kRows) ring[r * L.ks + col] = __float2bfloat16_rn(0.f);
      else scs[(r - 2 * kRows) * L.kd + col] = 0.f;
    }
  }
  if (tid < kHeads) {
    mrow[tid] = kNegInf;
    lrow[tid] = 0.f;
  }

  // copies of tile tau into ring slot buf; returns whether its page is cold
  const bool vec16 = lat % 8 == 0 && rope % 8 == 0;
  const bool code16 = lat % 16 == 0 && rope % 16 == 0;
  auto stage = [&](int tau, int buf) -> bool {
    const int j = pa + tau / nsub, r0 = (tau % nsub) * kRows;
    const int nrows = min(kRows, page - r0);
    const size_t phys = tau == 0 ? (size_t)phys0 : (size_t)block_table[(size_t)i * n_pages + j];
    const int flag = kCold ? cold.flags[phys] : 0;   // in flight beside the bf16 copies
    {                                 // the bf16 rows (a cold page's are overwritten)
      const int w = vec16 ? 8 : 4;    // bf16 elements a copy
      const int nl = lat / w, per = nl + rope / w;
      for (int r = warp; r < kRows; r += kThreads / 32) {
        const bool ok = r < nrows;
        const size_t src = phys * page + r0 + (ok ? r : 0);
        bf16* dst = ring + (buf * kRows + r) * L.ks;
        for (int c = lane; c < per; c += 32) {
          const bf16* from = c < nl ? ckv_pool + src * lat + c * w
                                    : kr_pool + src * rope + (c - nl) * w;
          bf16* to = dst + (c < nl ? c * w : L.lp + (c - nl) * w);
          if (vec16) cp_async16(to, from, ok);
          else cp_async8(to, from, ok);
        }
      }
    }
    const bool is_cold = kCold && flag != 0;
    if (is_cold) {                    // codes and scales; widened over the rows after the wait
      const int w = code16 ? 16 : 4;
      const int nl = lat / w, per = nl + rope / w;
      for (int r = warp; r < kRows; r += kThreads / 32) {
        const bool ok = r < nrows;
        const size_t src = phys * page + r0 + (ok ? r : 0);
        int8_t* dst = raw + (buf * kRows + r) * L.kd;
        for (int c = lane; c < per; c += 32) {
          const int8_t* from = c < nl ? cold.ckv_q8 + src * lat + c * w
                                      : cold.kr_q8 + src * rope + (c - nl) * w;
          int8_t* to = dst + (c < nl ? c * w : L.lp + (c - nl) * w);
          if (code16) cp_async16(to, from, ok);
          else cp_async4(to, from, ok);
        }
      }
      for (int e = tid; e < (lat + rope) / 4; e += kThreads) {
        const int c = 4 * e;
        const float* from = c < lat ? cold.ckv_scale + phys * lat + c
                                    : cold.kr_scale + phys * rope + (c - lat);
        cp_async16(scs + buf * L.kd + (c < lat ? c : L.lp + c - lat), from, true);
      }
    }
    return is_cold;
  };

  float acc[2][kWarpCols / 8][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int nt = 0; nt < kWarpCols / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][nt][e] = 0.f;

  bool cold_now = stage(0, 0);
  cp_async_commit();
  for (int tau = 0; tau < ntiles; ++tau) {
    const int buf = tau & 1;
    bool cold_next = false;
    if (tau + 1 < ntiles) cold_next = stage(tau + 1, buf ^ 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const bf16* kt = ring + buf * kRows * L.ks;
    const float* sc = scs + buf * L.kd;
    if (kCold && cold_now) {          // widen the codes: exact in bf16
      const int8_t* rb = raw + buf * kRows * L.kd;
      const int nl = lat / 4, per = nl + rope / 4;
      for (int r = warp; r < kRows; r += kThreads / 32) {
        for (int c = lane; c < per; c += 32) {
          const int col = c < nl ? 4 * c : L.lp + 4 * (c - nl);
          const char4 v = *reinterpret_cast<const char4*>(rb + r * L.kd + col);
          bf16* dst = ring + (buf * kRows + r) * L.ks + col;
          *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(v.x, v.y);
          *reinterpret_cast<__nv_bfloat162*>(dst + 2) = __floats2bfloat162_rn(v.z, v.w);
        }
      }
      __syncthreads();
    }
    const int sub = tau % nsub;
    const int pos0 = (pa + tau / nsub) * page + sub * kRows;
    const int nrows = min(kRows, page - sub * kRows);

    // ---- scores: warp (row tile mt, depth half kh), 2 n8 tiles of tokens ----
    {
      const int mt = warp & 3, kh = warp >> 2;
      const int nks = L.kd / 16, half = (nks + 1) / 2;
      const int k_lo = kh ? half : 0, k_hi = kh ? nks : half;
      float sacc[3][2][4];
#pragma unroll
      for (int p = 0; p < 3; ++p)
#pragma unroll
        for (int n = 0; n < 2; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) sacc[p][n][e] = 0.f;
      const float* q0 = qs + (mt * 16 + g) * L.qs + 2 * t4;
      const float* q1 = q0 + 8 * L.qs;
      const bf16* krow = kt + ((lane & 7) + 8 * (lane >> 4)) * L.ks + 8 * ((lane >> 3) & 1);
      for (int kk = k_lo; kk < k_hi; ++kk) {
        const int c = kk * 16;
        float2 x0 = *reinterpret_cast<const float2*>(q0 + c);
        float2 x1 = *reinterpret_cast<const float2*>(q1 + c);
        float2 x2 = *reinterpret_cast<const float2*>(q0 + c + 8);
        float2 x3 = *reinterpret_cast<const float2*>(q1 + c + 8);
        if (kCold && cold_now) {      // a cold tile: (q * scale) . q8
          const float2 s0 = *reinterpret_cast<const float2*>(sc + c + 2 * t4);
          const float2 s1 = *reinterpret_cast<const float2*>(sc + c + 8 + 2 * t4);
          x0.x *= s0.x; x0.y *= s0.y; x1.x *= s0.x; x1.y *= s0.y;
          x2.x *= s1.x; x2.y *= s1.y; x3.x *= s1.x; x3.y *= s1.y;
        }
        uint32_t a[3][4];
        split3(x0.x, x0.y, a[0][0], a[1][0], a[2][0]);
        split3(x1.x, x1.y, a[0][1], a[1][1], a[2][1]);
        split3(x2.x, x2.y, a[0][2], a[1][2], a[2][2]);
        split3(x3.x, x3.y, a[0][3], a[1][3], a[2][3]);
        uint32_t bk[4];
        ldsm_x4(bk, krow + c);
#pragma unroll
        for (int p = 0; p < 3; ++p) {
          mma_bf16(sacc[p][0], a[p], bk[0], bk[1]);
          mma_bf16(sacc[p][1], a[p], bk[2], bk[3]);
        }
      }
      float* spw = sp + kh * kHeads * kSPad + (mt * 16 + g) * kSPad + 2 * t4;
#pragma unroll
      for (int n = 0; n < 2; ++n) {
        float v[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) v[e] = (sacc[2][n][e] + sacc[1][n][e]) + sacc[0][n][e];
        *reinterpret_cast<float2*>(spw + 8 * n) = make_float2(v[0], v[1]);
        *reinterpret_cast<float2*>(spw + 8 * kSPad + 8 * n) = make_float2(v[2], v[3]);
      }
    }
    __syncthreads();

    // ---- online softmax: four threads a head, four tokens each ----
    {
      const int r = tid >> 2, qd = tid & 3;
      float s[4];
      float mx = kNegInf;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int t = 4 * qd + e;
        const float v = (sp[r * kSPad + t] + sp[(kHeads + r) * kSPad + t]) * scale;
        s[e] = (t < nrows && pos0 + t <= len) ? v : kNegInf;
        mx = fmaxf(mx, s[e]);
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_prev = mrow[r];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = expf(s[e] - m_new);
        sp[r * kSPad + 4 * qd + e] = p;
        sum += p;
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      __syncwarp();
      if (qd == 0) {
        const float a = expf(m_prev - m_new);
        alpha[r] = a;
        lrow[r] = lrow[r] * a + sum;
        mrow[r] = m_new;
      }
    }
    __syncthreads();

    // ---- p . v: warp (32 heads wm, 128 latent columns wn) ----
    {
      const int wm = warp & 1, wn = warp >> 1;
      uint32_t a[2][3][4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        const int r0 = (2 * wm + mi) * 16 + g;
        const float al0 = alpha[r0], al1 = alpha[r0 + 8];
#pragma unroll
        for (int nt = 0; nt < kWarpCols / 8; ++nt) {
          acc[mi][nt][0] *= al0;
          acc[mi][nt][1] *= al0;
          acc[mi][nt][2] *= al1;
          acc[mi][nt][3] *= al1;
        }
        const float* p0 = sp + r0 * kSPad + 2 * t4;
        const float* p1 = p0 + 8 * kSPad;
        const float2 x0 = *reinterpret_cast<const float2*>(p0);
        const float2 x1 = *reinterpret_cast<const float2*>(p1);
        const float2 x2 = *reinterpret_cast<const float2*>(p0 + 8);
        const float2 x3 = *reinterpret_cast<const float2*>(p1 + 8);
        split3(x0.x, x0.y, a[mi][0][0], a[mi][1][0], a[mi][2][0]);
        split3(x1.x, x1.y, a[mi][0][1], a[mi][1][1], a[mi][2][1]);
        split3(x2.x, x2.y, a[mi][0][2], a[mi][1][2], a[mi][2][2]);
        split3(x3.x, x3.y, a[mi][0][3], a[mi][1][3], a[mi][2][3]);
      }
      const bf16* vrow = kt + ((lane & 7) + 8 * ((lane >> 3) & 1)) * L.ks + 8 * (lane >> 4);
#pragma unroll
      for (int np = 0; np < kWarpCols / 16; ++np) {
        const int col = wn * kWarpCols + np * 16;
        if (col < L.lp) {
          uint32_t bv[4];
          ldsm_x4_t(bv, vrow + col);
#pragma unroll
          for (int hf = 0; hf < 2; ++hf) {
            const int nt = 2 * np + hf;
#pragma unroll
            for (int mi = 0; mi < 2; ++mi) {
              if (kCold && cold_now) {  // q8 values: the column's scale after the sum
                float tmp[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
                for (int p = 2; p >= 0; --p) mma_bf16(tmp, a[mi][p], bv[2 * hf], bv[2 * hf + 1]);
                const float2 s = *reinterpret_cast<const float2*>(sc + col + 8 * hf + 2 * t4);
                acc[mi][nt][0] = fmaf(tmp[0], s.x, acc[mi][nt][0]);
                acc[mi][nt][1] = fmaf(tmp[1], s.y, acc[mi][nt][1]);
                acc[mi][nt][2] = fmaf(tmp[2], s.x, acc[mi][nt][2]);
                acc[mi][nt][3] = fmaf(tmp[3], s.y, acc[mi][nt][3]);
              } else {
#pragma unroll
                for (int p = 2; p >= 0; --p)
                  mma_bf16(acc[mi][nt], a[mi][p], bv[2 * hf], bv[2 * hf + 1]);
              }
            }
          }
        }
      }
    }
    __syncthreads();                  // the ring slot and the tiles are free again
    cold_now = cold_next;
  }

  // ---- out: o_lat itself when the slot has one item, else the partial state ----
  const int wm = warp & 1, wn = warp >> 1;
  const bool direct = n_items == 1;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int r = (2 * wm + mi) * 16 + g + 8 * hf;
      if (r >= nh) continue;
      const float inv_l = 1.f / fmaxf(lrow[r], 1e-30f);
#pragma unroll
      for (int nt = 0; nt < kWarpCols / 8; ++nt) {
        const int col = wn * kWarpCols + nt * 8 + 2 * t4;
        if (col >= lat) continue;
        const float v0 = acc[mi][nt][2 * hf], v1 = acc[mi][nt][2 * hf + 1];
        if (direct)
          store2<TQ>(out + ((size_t)i * h + h0 + r) * lat + col, v0 * inv_l, v1 * inv_l);
        else
          store2<float>(part_o + ((size_t)z * h + h0 + r) * lat + col, v0, v1);
      }
    }
  }
  if (!direct && tid < nh) {
    part_ml[((size_t)z * h + h0 + tid) * 2] = mrow[tid];
    part_ml[((size_t)z * h + h0 + tid) * 2 + 1] = lrow[tid];
  }
}

// Combines the items of slot blockIdx.x for head blockIdx.y: each item's m
// and l are read once, weights w = exp(m - max m) in item order, then
// o = sum_items w acc / sum_items w l, every sum in item order; a thread a
// float4 of the latent row.
template <typename TQ>
__global__ void __launch_bounds__(128)
mla_combine_kernel(const float* part_o, const float* part_ml, const int* __restrict__ seq_lens,
                   TQ* __restrict__ out, int h, int lat, int page, int n_pages, int ppi) {
  // part_o and part_ml come from the grid this one overlaps: read through L2
  // (__ldcg), after grid_dependency_wait
  extern __shared__ float wts[];      // (items) weights, m, l
  __shared__ float inv_l;
  const int i = blockIdx.x, hh = blockIdx.y, tid = threadIdx.x;
  const int per_slot = (n_pages + ppi - 1) / ppi;
  const int first = i * per_slot, n = (min(n_pages, seq_lens[i] / page + 1) + ppi - 1) / ppi;
  sct::grid_dependency_wait();        // the main pass's partial states are written
  if (n <= 1) return;                 // the main kernel wrote o_lat itself
  float* ms = wts + n;
  float* ls = ms + n;
  for (int j = tid; j < n; j += blockDim.x) {   // every item's m and l at once
    const float2 ml =
        __ldcg(reinterpret_cast<const float2*>(part_ml + ((size_t)(first + j) * h + hh) * 2));
    ms[j] = ml.x;
    ls[j] = ml.y;
  }
  __syncthreads();
  float mx = kNegInf;                 // every thread: the same max, in item order
  for (int j = 0; j < n; ++j) mx = fmaxf(mx, ms[j]);
  for (int j = tid; j < n; j += blockDim.x) wts[j] = expf(ms[j] - mx);
  __syncthreads();
  if (tid == 0) {
    float l = 0.f;
    for (int j = 0; j < n; ++j) l = fmaf(ls[j], wts[j], l);
    inv_l = 1.f / fmaxf(l, 1e-30f);
  }
  __syncthreads();
  const float* src = part_o + ((size_t)first * h + hh) * lat;
  for (int c = 4 * tid; c < lat; c += 4 * blockDim.x) {
    float4 o = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 8
    for (int j = 0; j < n; ++j) {
      const float w = wts[j];
      const float4 v = __ldcg(reinterpret_cast<const float4*>(src + (size_t)j * h * lat + c));
      o.x = fmaf(v.x, w, o.x);
      o.y = fmaf(v.y, w, o.y);
      o.z = fmaf(v.z, w, o.z);
      o.w = fmaf(v.w, w, o.w);
    }
    TQ* dst = out + ((size_t)i * h + hh) * lat + c;
    store2<TQ>(dst, o.x * inv_l, o.y * inv_l);
    store2<TQ>(dst + 2, o.z * inv_l, o.w * inv_l);
  }
}

template <typename TQ, bool kCold>
cudaError_t launch(const void* q_lat, const void* q_rope, const void* ckv_pool,
                   const void* kr_pool, const int* bt, const int* seq_lens, void* out,
                   void* part_o, void* part_ml, int b, int h, int lat, int rope, int page,
                   int n_pages, int ppi, float scale, ColdPools cold, cudaStream_t stream) {
  const Layout L = make_layout(lat, rope, kCold);
  if (L.total > kMaxSmem) return cudaErrorInvalidValue;
  auto kernel = mla_decode_kernel<TQ, kCold>;
  cudaError_t err = sct::allow_smem(kernel, L.total);
  if (err != cudaSuccess) return err;
  const int per_slot = (n_pages + ppi - 1) / ppi;   // items a slot can have, at most
  const dim3 grid(b * per_slot, (h + kHeads - 1) / kHeads);
  kernel<<<grid, kThreads, L.total, stream>>>(
      static_cast<const TQ*>(q_lat), static_cast<const TQ*>(q_rope),
      static_cast<const bf16*>(ckv_pool), static_cast<const bf16*>(kr_pool), bt, seq_lens,
      static_cast<TQ*>(out), static_cast<float*>(part_o), static_cast<float*>(part_ml), b, h,
      lat, rope, page, n_pages, ppi, scale, cold);
  err = cudaGetLastError();
  if (err != cudaSuccess || per_slot == 1) return err;
  const size_t wbytes = sizeof(float) * 3 * per_slot;
  err = sct::allow_smem(mla_combine_kernel<TQ>, wbytes);
  if (err != cudaSuccess) return err;
  err = sct::launch_dependent(mla_combine_kernel<TQ>, dim3(b, h), dim3(128), wbytes, stream,
                              static_cast<const float*>(part_o),
                              static_cast<const float*>(part_ml), seq_lens,
                              static_cast<TQ*>(out), h, lat, page, n_pages, ppi);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <bool kCold>
int launch_dtype(const void* q_lat, const void* q_rope, const void* ckv_pool,
                 const void* kr_pool, const void* block_table, const void* seq_lens, void* out,
                 void* part_o, void* part_ml, int b, int h, int lat, int rope, int page,
                 int n_pages, int ppi, int q_dtype, float scale, ColdPools cold, void* stream) {
  if (b <= 0 || h <= 0) return cudaSuccess;
  if (lat <= 0 || lat > 4 * kWarpCols || lat % 4 != 0 || rope < 0 || rope % 4 != 0 ||
      page <= 0 || n_pages <= 0 || ppi <= 0)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* bt = static_cast<const int*>(block_table);
  const int* sl = static_cast<const int*>(seq_lens);
  if (q_dtype == sct::kBFloat16)
    return launch<__nv_bfloat16, kCold>(q_lat, q_rope, ckv_pool, kr_pool, bt, sl, out, part_o,
                                        part_ml, b, h, lat, rope, page, n_pages, ppi, scale,
                                        cold, st);
  if (q_dtype == sct::kFloat32)
    return launch<float, kCold>(q_lat, q_rope, ckv_pool, kr_pool, bt, sl, out, part_o,
                                part_ml, b, h, lat, rope, page, n_pages, ppi, scale, cold, st);
  return cudaErrorInvalidValue;
}

}  // namespace

// ckv_pool/kr_pool are bf16; q_lat, q_rope and out are in q_dtype. The latent
// width lat is a multiple of 4 up to 512, rope a multiple of 4. part_o
// (b * ceil(n_pages / ppi), h, lat) and part_ml (the same, 2) fp32 are
// scratch for the partial states.
extern "C" int sct_paged_mla_decode(const void* q_lat, const void* q_rope, const void* ckv_pool,
                                    const void* kr_pool, const void* block_table,
                                    const void* seq_lens, void* out, void* part_o,
                                    void* part_ml, int b, int h, int lat, int rope, int page,
                                    int n_pages, int ppi, int q_dtype, float scale,
                                    void* stream) {
  return launch_dtype<false>(q_lat, q_rope, ckv_pool, kr_pool, block_table, seq_lens, out,
                             part_o, part_ml, b, h, lat, rope, page, n_pages, ppi, q_dtype,
                             scale, ColdPools{}, stream);
}

// As sct_paged_mla_decode, plus the int8 shadow pools ckv_q8/kr_q8 (the pools'
// shapes), their fp32 scales (P+1, lat) / (P+1, rope) and cold_flags (P+1,)
// int32.
extern "C" int sct_paged_mla_decode_cold(const void* q_lat, const void* q_rope,
                                         const void* ckv_pool, const void* kr_pool,
                                         const void* ckv_q8, const void* ckv_scale,
                                         const void* kr_q8, const void* kr_scale,
                                         const void* cold_flags, const void* block_table,
                                         const void* seq_lens, void* out, void* part_o,
                                         void* part_ml, int b, int h, int lat, int rope,
                                         int page, int n_pages, int ppi, int q_dtype,
                                         float scale, void* stream) {
  const ColdPools cold{static_cast<const int8_t*>(ckv_q8), static_cast<const float*>(ckv_scale),
                       static_cast<const int8_t*>(kr_q8), static_cast<const float*>(kr_scale),
                       static_cast<const int*>(cold_flags)};
  return launch_dtype<true>(q_lat, q_rope, ckv_pool, kr_pool, block_table, seq_lens, out,
                            part_o, part_ml, b, h, lat, rope, page, n_pages, ppi, q_dtype,
                            scale, cold, stream);
}
