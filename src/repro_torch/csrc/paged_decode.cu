// Paged GQA flash-decode for Hopper: one-token attention straight from the
// paged KV pools, walking each slot's block table inside the kernel.
//
// Replaces the TPU kernels kernels/paged_decode.py:paged_gqa_decode_pallas
// and paged_gqa_decode_cold_pallas of the JAX package.
//
// q (b, kvh, rep, hd) in TQ (fp32 or bf16); k/v pools (P+1, page, kvh, hd)
// in bf16 (the port keeps KV pools in bf16 whatever the compute dtype);
// block_table (b, n_pages) int32; seq_lens (b,) int32; out (b, kvh, rep, hd)
// in TQ. Position pos of slot i is valid when pos <= seq_lens[i] (the token
// appended this step sits at seq_lens[i]). Scores, softmax and the
// accumulator are fp32 with one rounding at the output: the fp32 decode
// contract of nn/attention.py that keeps bf16 greedy decode token-identical
// across the decode paths.
//
// What bounds it. The work is the bytes of the live K/V pages (2 * len *
// kvh * hd * 2 bytes a slot, 4 flops a byte), but a decode step holds a few
// hundred tokens a slot: at llama3.2-1b's 4 slots x 8 kv heads that is under
// 1 MB, a quarter of a microsecond of HBM time. What the card spends is a
// chain of dependent latencies (launch; the slot's length and block-table
// row; the rows those name; the reductions and the write) and the
// instructions of the softmax, which at decode's few blocks run on few SMs
// with few warps each to hide their latency. The design keeps the chain to
// two rounds of loads (three in the cold kernel: the page flags are one)
// and spreads the instructions over as many SMs as the step has query
// heads.
//
// Design: one block per (slot, query head), with kWarps warps and no barrier
// until the end. The rep heads of a kv head read the same pages in rep
// blocks (from L2 after the first): at decode that costs no HBM time and
// splits the math rep ways. A slot's live rows are cut into units of up to
// kPasses x (32 / LP) rows of one page (a whole 16-row page at hd 64, half
// of one at hd 128), and warp w walks units w, w + W, ... Each row is read
// by LP lanes, E elements (16, 8, 4 or 2 bytes) a lane: E is the widest
// vector that divides the row (hd * 2 bytes) and the pools' alignment, LP
// the power of two that covers hd / E; the rest of the warp's lanes read the
// unit's other rows, so one warp-wide load covers 32 / LP rows. A warp
// first loads, in one round, the slot's length, the block-table entries of
// its first 32 units and its lanes' q (fp32 in registers); then it issues
// all the loads of its first two units before it uses any, and each unit's
// successor-but-one right after the unit is consumed: two units in flight,
// in registers. A unit's scores are a per-lane partial dot over its dims,
// completed by xor shuffles across the row's LP lanes; masked rows (past
// seq_lens[i], or past the page) score -1e30 and weigh 0. The online softmax
// runs in registers per warp: the unit's max is reduced across the warp's
// row groups by shuffles, each lane keeps the running sum and accumulator
// of its own rows and dims, and those are reduced across the row groups
// once, when the walk ends. Each warp then leaves (m, l, acc) in shared
// memory and, after the block's one barrier, the block's threads finish the
// row, combining the warps in warp order. Every warp walks the same number
// of units (from the table width, a unit past the live ones a no-op), so all
// control flow is uniform and no shuffle needs a divergence guard. Every
// order is fixed and depends on the table width, never on the slot's length
// or the batch: two calls give the same bits and a slot's row is the same
// served alone. Pages past the one holding position seq_lens[i] are never
// read.
//
// No cluster and no second pass, at any table width: b x h blocks fill the
// SMs at serving batches, and a long table is walked by the same 8 warps
// (measured faster at 256 pages than splitting it over a cluster of 4,
// whose 512 blocks ran in waves).
//
// The cold variant (the streaming cold tier) adds int8 shadow pools k_q8 /
// v_q8 (P+1, page, kvh, hd), their per-page fp32 scales (P+1, kvh, hd) and
// cold_flags (P+1,) int32. A flagged page reads q8 * scale, widened and
// multiplied in fp32 in registers (the reference's arithmetic). The flag
// depends on the page id, so knowing it costs a round trip: a warp loads
// the flags of its first 32 units as soon as their page ids arrive, and
// each unit then reads its tier alone. (Issuing both tiers' rows with the
// flag and selecting in registers saves the round trip but moves 1.5x the
// bytes, and measured slower.) It stays bound by bytes. The kernel is the
// same template with kCold set; with no page flagged it reads the hot
// kernel's rows into the same geometry and computes with the same
// instructions, so its output is bit-identical to the hot kernel's. All
// arithmetic is written with explicit roundings (fmaf, __fmul_rn,
// __fadd_rn) so that no instantiation contracts differently.
#include "common.cuh"

namespace {

constexpr int kWarps = 8;           // warps a block, each walking its own units
constexpr int kPasses = 4;          // warp-wide row loads a unit holds, K and V each
constexpr float kNegInf = -1e30f;
__host__ __device__ constexpr int log2i(int x) { return x <= 1 ? 0 : 1 + log2i(x / 2); }
constexpr unsigned kAll = 0xffffffffu;

// The cold tier's inputs; null pointers in the hot kernel.
struct ColdPools {
  const int8_t* k_q8;
  const float* k_scale;
  const int8_t* v_q8;
  const float* v_scale;
  const int* flags;
};

// The launch geometry (see launch()).
struct Geo {
  int kvh, rep, hd, page, n_pages;
  int lp_log;  // log2 of the lanes a row
  int chunk;   // rows a unit: kPasses * (32 >> lp_log)
  int cpp;     // units a page
  int iters;   // units a warp walks: ceil(n_pages * cpp / kWarps)
  float scale;  // 1/sqrt(hd) times log2(e): scores in base-2 units
};

// A lane's E elements of a row, raw: bf16 and int8.
template <int E>
struct Raw;
template <>
struct Raw<8> {
  using bf = uint4;
  using i8 = uint2;
};
template <>
struct Raw<4> {
  using bf = uint2;
  using i8 = unsigned int;
};
template <>
struct Raw<2> {
  using bf = unsigned int;
  using i8 = unsigned short;
};
template <>
struct Raw<1> {
  using bf = unsigned short;
  using i8 = unsigned char;
};

// bf16 halves of a 32-bit word, exact
__device__ __forceinline__ float bf_lo(unsigned w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float bf_hi(unsigned w) { return __uint_as_float(w & 0xffff0000u); }
__device__ __forceinline__ void widen2(unsigned w, float* x) {
  x[0] = bf_lo(w);
  x[1] = bf_hi(w);
}
__device__ __forceinline__ void widen(const uint4& r, float (&x)[8]) {
  widen2(r.x, x), widen2(r.y, x + 2), widen2(r.z, x + 4), widen2(r.w, x + 6);
}
__device__ __forceinline__ void widen(const uint2& r, float (&x)[4]) {
  widen2(r.x, x), widen2(r.y, x + 2);
}
__device__ __forceinline__ void widen(unsigned r, float (&x)[2]) { widen2(r, x); }
__device__ __forceinline__ void widen(unsigned short r, float (&x)[1]) {
  x[0] = bf_lo(r);
}

// int8 codes of a word, times their scales, in fp32: q8 * scale as the
// reference computes it
__device__ __forceinline__ float code(unsigned w, int k) {
  return static_cast<float>(static_cast<int8_t>((w >> (8 * k)) & 0xffu));
}
__device__ __forceinline__ void dequant4(unsigned w, const float* s, float* x) {
#pragma unroll
  for (int k = 0; k < 4; ++k) x[k] = __fmul_rn(code(w, k), s[k]);
}
__device__ __forceinline__ void dequant(const uint2& r, const float (&s)[8], float (&x)[8]) {
  dequant4(r.x, s, x), dequant4(r.y, s + 4, x + 4);
}
__device__ __forceinline__ void dequant(unsigned r, const float (&s)[4], float (&x)[4]) {
  dequant4(r, s, x);
}
__device__ __forceinline__ void dequant(unsigned short r, const float (&s)[2], float (&x)[2]) {
  x[0] = __fmul_rn(code(r, 0), s[0]);
  x[1] = __fmul_rn(code(r, 1), s[1]);
}
__device__ __forceinline__ void dequant(unsigned char r, const float (&s)[1], float (&x)[1]) {
  x[0] = __fmul_rn(code(r, 0), s[0]);
}

// Reductions across a warp by xor shuffles: a sum over the LP lanes of a
// row (the lanes whose index differs in the low bits), and a sum or max
// over the row groups (the high bits). Where LP is a template constant
// (kLp, the common head dims) the levels fold at compile time. Otherwise
// LP is a runtime power of two, and every level's shuffle runs and its
// result is taken or not: a shuffle under a runtime branch would make the
// compiler guard it against a diverged warp, at a cost larger than the
// shuffle. Each level combines commutatively, so every lane of a group
// ends with the same bits, and both forms give the same bits for one LP.
template <int kLp, bool kRow, typename Op>
__device__ __forceinline__ float reduce(float x, int lp, Op op) {
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    if constexpr (kLp != 0) {
      if ((o < kLp) == kRow) x = op(x, __shfl_xor_sync(kAll, x, o));
    } else {
      const float t = __shfl_xor_sync(kAll, x, o);
      if ((o < lp) == kRow) x = op(x, t);
    }
  }
  return x;
}
struct Add {
  __device__ float operator()(float a, float b) const { return __fadd_rn(a, b); }
};
struct Max {
  __device__ float operator()(float a, float b) const { return fmaxf(a, b); }
};

template <typename T>
__device__ __forceinline__ T load(const void* p) {
  return __ldg(static_cast<const T*>(p));
}

// A lane's E scales of a page (zeros where ok is false): 16-, 8- or 4-byte
// loads (the launcher checks the scales' alignment).
template <int E>
__device__ __forceinline__ void load_scales(const float* p, bool ok, float (&s)[E]) {
  if constexpr (E >= 4) {
#pragma unroll
    for (int c = 0; c < E; c += 4) {
      const float4 v = ok ? load<float4>(p + c) : float4{};
      s[c] = v.x, s[c + 1] = v.y, s[c + 2] = v.z, s[c + 3] = v.w;
    }
  } else if constexpr (E == 2) {
    const float2 v = ok ? load<float2>(p) : float2{};
    s[0] = v.x, s[1] = v.y;
  } else {
    s[0] = ok ? load<float>(p) : 0.f;
  }
}

// One unit in flight: its rows (K and V, a pass a register group), and in
// the cold kernel their int8 shadows, the page's scales and its flag (the
// hot kernel never touches those, and they take no registers there).
template <int E>
struct Unit {
  typename Raw<E>::bf k[kPasses], v[kPasses];
  typename Raw<E>::i8 kq[kPasses], vq[kPasses];
  float ks[E], vs[E];
  int flag = 0;
};

// A lane's E values of one row in fp32: the bf16 row, or in the cold
// kernel on a flagged page the codes times the page's scales.
template <bool kCold, int E>
__device__ __forceinline__ void row(const typename Raw<E>::bf& r, const typename Raw<E>::i8& c,
                                    const float (&s)[E], int flag, float (&x)[E]) {
  if constexpr (kCold) {
    if (flag != 0) {
      dequant(c, s, x);
      return;
    }
  }
  widen(r, x);
}

template <typename TQ, int E, int kLp, bool kCold>
__global__ void __launch_bounds__(kWarps * 32, 1)
paged_gqa_decode_kernel(const TQ* __restrict__ q, const __nv_bfloat16* __restrict__ k_pool,
                        const __nv_bfloat16* __restrict__ v_pool,
                        const int* __restrict__ block_table, const int* __restrict__ seq_lens,
                        TQ* __restrict__ out, Geo G, ColdPools cold) {
  using BF = typename Raw<E>::bf;
  using I8 = typename Raw<E>::i8;
  extern __shared__ float smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int i = blockIdx.x, hh = blockIdx.y, g = hh / G.rep;  // slot, query head, kv head
  const int lp_log = kLp != 0 ? log2i(kLp) : G.lp_log;
  const int LP = 1 << lp_log;
  const int row_lane = lane >> lp_log;     // the lane's row within a warp-wide load
  const int rpw = 32 >> lp_log;            // rows a warp-wide load covers
  const int hdp = E << lp_log;             // a warp's row of dims, padded
  float* s_acc = smem;                     // (kWarps, hdp) partial accumulators
  float* s_m = s_acc + kWarps * hdp;       // (kWarps,) running maxima
  float* s_l = s_m + kWarps;               // (kWarps,) running sums
  const int d0 = (lane & (LP - 1)) * E;    // the lane's first dim
  const bool dims = d0 < G.hd;
  const size_t rstride = (size_t)G.kvh * G.hd;

  // prologue, one round of loads: the slot's length, the table entries of
  // this warp's first 32 units (lane k holds its k-th unit's page id) and q
  const int* bt_row = block_table + (size_t)i * G.n_pages;
  auto entry = [&](int k) {
    const int pg = (warp + k * kWarps) / G.cpp;
    return pg < G.n_pages ? __ldg(bt_row + pg) : 0;
  };
  int tb = entry(lane);
  const int len = __ldg(seq_lens + i);
  const size_t row_off = ((size_t)i * G.kvh * G.rep + hh) * G.hd;  // q's and out's row
  float qv[E];
#pragma unroll
  for (int e = 0; e < E; ++e) qv[e] = dims ? sct::to_float(q[row_off + d0 + e]) : 0.f;

  // live units: those whose first row is at or before position len
  const int last = len / G.page;
  const int nu = last >= G.n_pages ? G.n_pages * G.cpp
                                   : last * G.cpp + (len - last * G.page) / G.chunk + 1;
  // cold: lane k also holds its k-th unit's flag (a round trip more: each
  // unit then reads one tier only)
  int fl = 0;
  if (kCold && warp + lane * kWarps < nu) fl = __ldg(cold.flags + tb);

  // Every warp walks the same G.iters units (from the table width), the
  // k-th being u = warp + k * kWarps: all control flow is uniform, so no
  // shuffle sits where the compiler must guard it against a diverged warp.
  // A unit past the live ones loads nothing and changes nothing.
  auto issue = [&](Unit<E>& U, int k) {
    if (k >= G.iters) return;
    if (k > 0 && (k & 31) == 0) {  // past 32 units: the next 32 table entries
      tb = entry(k + lane);
      if (kCold && warp + (k + lane) * kWarps < nu) fl = __ldg(cold.flags + tb);
    }
    const size_t phys = (size_t)__shfl_sync(kAll, tb, k & 31);
    const int u = warp + k * kWarps;
    const bool live = u < nu;
    const int pg = u / G.cpp, row0 = (u - pg * G.cpp) * G.chunk;
    const int rows = min(G.chunk, G.page - row0), pos0 = pg * G.page + row0;
    const size_t base = ((phys * G.page + row0) * G.kvh + g) * G.hd + d0;
    if constexpr (kCold) U.flag = __shfl_sync(kAll, fl, k & 31);
    const bool hot = U.flag == 0;
#pragma unroll
    for (int s = 0; s < kPasses; ++s) {
      const int rr = s * rpw + row_lane;
      const bool ok = live && dims && rr < rows && pos0 + rr <= len;
      const size_t off = base + rr * rstride;
      U.k[s] = ok && hot ? load<BF>(k_pool + off) : BF{};
      U.v[s] = ok && hot ? load<BF>(v_pool + off) : BF{};
      if constexpr (kCold) {
        U.kq[s] = ok && !hot ? load<I8>(cold.k_q8 + off) : I8{};
        U.vq[s] = ok && !hot ? load<I8>(cold.v_q8 + off) : I8{};
      }
    }
    if constexpr (kCold) {
      const size_t soff = (phys * G.kvh + g) * G.hd + d0;
      load_scales(cold.k_scale + soff, live && dims && !hot, U.ks);
      load_scales(cold.v_scale + soff, live && dims && !hot, U.vs);
    }
  };

  float m = kNegInf, l = 0.f, acc[E];
#pragma unroll
  for (int e = 0; e < E; ++e) acc[e] = 0.f;

  // one unit's online-softmax update, in registers
  auto consume = [&](const Unit<E>& U, int k) {
    const int u = warp + k * kWarps;
    const int pg = u / G.cpp, row0 = (u - pg * G.cpp) * G.chunk;
    const int rows = min(G.chunk, G.page - row0), pos0 = pg * G.page + row0;
    float sc[kPasses];
    bool valid[kPasses];
#pragma unroll
    for (int s = 0; s < kPasses; ++s) {
      float kf[E];
      row<kCold, E>(U.k[s], U.kq[s], U.ks, U.flag, kf);
      const int rr = s * rpw + row_lane;
      valid[s] = u < nu && rr < rows && pos0 + rr <= len;
      float dot = 0.f;
#pragma unroll
      for (int e = 0; e < E; ++e) dot = fmaf(qv[e], kf[e], dot);
      dot = reduce<kLp, true>(dot, LP, Add{});
      sc[s] = valid[s] ? __fmul_rn(dot, G.scale) : kNegInf;
    }
    float mx = sc[0];
#pragma unroll
    for (int s = 1; s < kPasses; ++s) mx = fmaxf(mx, sc[s]);
    mx = reduce<kLp, false>(mx, LP, Max{});
    const float m_new = fmaxf(m, mx);
    const float alpha = exp2f(__fsub_rn(m, m_new));
    float psum = 0.f;
#pragma unroll
    for (int s = 0; s < kPasses; ++s) {
      sc[s] = valid[s] ? exp2f(__fsub_rn(sc[s], m_new)) : 0.f;
      psum = __fadd_rn(psum, sc[s]);
    }
    l = fmaf(l, alpha, psum);
    m = m_new;
#pragma unroll
    for (int e = 0; e < E; ++e) acc[e] = __fmul_rn(acc[e], alpha);
#pragma unroll
    for (int s = 0; s < kPasses; ++s) {
      float vf[E];
      row<kCold, E>(U.v[s], U.vq[s], U.vs, U.flag, vf);
#pragma unroll
      for (int e = 0; e < E; ++e) acc[e] = fmaf(sc[s], vf[e], acc[e]);
    }
  };

  // the walk: two units in flight, the next issued before the current is used
  {
    Unit<E> A, B;
    issue(A, 0);
    issue(B, 1);
    for (int k = 0; k < G.iters; k += 2) {
      consume(A, k);
      issue(A, k + 2);
      if (k + 1 >= G.iters) break;
      consume(B, k + 1);
      issue(B, k + 3);
    }
  }

  // the warp's state: reduce the running sum and accumulator across its row
  // groups, then leave it in shared memory
  l = reduce<kLp, false>(l, LP, Add{});
#pragma unroll
  for (int e = 0; e < E; ++e) acc[e] = reduce<kLp, false>(acc[e], LP, Add{});
  if (row_lane == 0) {
#pragma unroll
    for (int e = 0; e < E; ++e) s_acc[warp * hdp + d0 + e] = acc[e];
  }
  if (lane == 0) {
    s_m[warp] = m;
    s_l[warp] = l;
  }
  __syncthreads();

  // combine the warps in warp order (warp 0 walks unit 0, so the slot's max
  // is finite; a warp with no live unit has m = -1e30 and weight 0)
  for (int d = threadIdx.x; d < G.hd; d += kWarps * 32) {
    float mx = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, s_m[w]);
    float lsum = 0.f, o = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float wt = exp2f(__fsub_rn(s_m[w], mx));
      lsum = fmaf(s_l[w], wt, lsum);
      o = fmaf(s_acc[w * hdp + d], wt, o);
    }
    out[row_off + d] = sct::from_float<TQ>(__fdiv_rn(o, fmaxf(lsum, 1e-30f)));
  }
}

inline bool aligned(const void* p, size_t bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

template <typename TQ, bool kCold, int E, int kLp>
cudaError_t launch_e(const void* q, const void* k_pool, const void* v_pool, const int* bt,
                     const int* seq_lens, void* out, int b, Geo G, ColdPools cold,
                     cudaStream_t stream) {
  const size_t smem = sizeof(float) * kWarps * ((E << G.lp_log) + 2);
  auto kernel = paged_gqa_decode_kernel<TQ, E, kLp, kCold>;
  kernel<<<dim3(b, G.kvh * G.rep), kWarps * 32, smem, stream>>>(
      static_cast<const TQ*>(q), static_cast<const __nv_bfloat16*>(k_pool),
      static_cast<const __nv_bfloat16*>(v_pool), bt, seq_lens, static_cast<TQ*>(out), G, cold);
  return cudaGetLastError();
}

// The geometry: E, the widest vector (in bf16 elements, at most 8) that
// divides hd and the bf16 pools' alignment (the hot and cold kernels on the
// same pools pick the same E, and so the same sums); LP = 2^lp_log lanes a
// row, the power of two that covers hd / E (at most 32: hd <= 256); units of
// kPasses x 32 / LP rows of a page, G.iters of them a warp.
template <typename TQ, bool kCold>
cudaError_t launch(const void* q, const void* k_pool, const void* v_pool, const int* bt,
                   const int* seq_lens, void* out, int b, int kvh, int rep, int hd, int page,
                   int n_pages, float scale, ColdPools cold, cudaStream_t stream) {
  int E = 8;
  while (E > 1 && (hd % E != 0 || !aligned(k_pool, 2 * E) || !aligned(v_pool, 2 * E))) E >>= 1;
  if (kCold && (!aligned(cold.k_q8, E) || !aligned(cold.v_q8, E) ||
                !aligned(cold.k_scale, 4 * min(E, 4)) || !aligned(cold.v_scale, 4 * min(E, 4))))
    return cudaErrorMisalignedAddress;
  Geo G{kvh, rep, hd, page, n_pages, 0, 0, 0, 0, scale * 1.4426950408889634f};
  while ((E << G.lp_log) < hd) ++G.lp_log;
  if (G.lp_log > 5) return cudaErrorInvalidValue;
  G.chunk = kPasses * (32 >> G.lp_log);
  G.cpp = (page + G.chunk - 1) / G.chunk;
  G.iters = (n_pages * G.cpp + kWarps - 1) / kWarps;
  // llama-like head dims (64, 128) fold their reductions at compile time
  if (E == 8 && G.lp_log == 3)
    return launch_e<TQ, kCold, 8, 8>(q, k_pool, v_pool, bt, seq_lens, out, b, G, cold, stream);
  if (E == 8 && G.lp_log == 4)
    return launch_e<TQ, kCold, 8, 16>(q, k_pool, v_pool, bt, seq_lens, out, b, G, cold, stream);
  switch (E) {
    case 8:
      return launch_e<TQ, kCold, 8, 0>(q, k_pool, v_pool, bt, seq_lens, out, b, G, cold, stream);
    case 4:
      return launch_e<TQ, kCold, 4, 0>(q, k_pool, v_pool, bt, seq_lens, out, b, G, cold, stream);
    case 2:
      return launch_e<TQ, kCold, 2, 0>(q, k_pool, v_pool, bt, seq_lens, out, b, G, cold, stream);
    default:
      return launch_e<TQ, kCold, 1, 0>(q, k_pool, v_pool, bt, seq_lens, out, b, G, cold, stream);
  }
}

template <bool kCold>
int launch_dtype(const void* q, const void* k_pool, const void* v_pool, const void* block_table,
                 const void* seq_lens, void* out, int b, int kvh, int rep, int hd, int page,
                 int n_pages, int q_dtype, float scale, ColdPools cold, void* stream) {
  if (b <= 0 || kvh <= 0) return cudaSuccess;
  if (rep <= 0 || hd <= 0 || page <= 0 || n_pages <= 0) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* bt = static_cast<const int*>(block_table);
  const int* sl = static_cast<const int*>(seq_lens);
  if (q_dtype == sct::kBFloat16)
    return launch<__nv_bfloat16, kCold>(q, k_pool, v_pool, bt, sl, out, b, kvh, rep, hd,
                                        page, n_pages, scale, cold, st);
  if (q_dtype == sct::kFloat32)
    return launch<float, kCold>(q, k_pool, v_pool, bt, sl, out, b, kvh, rep, hd, page,
                                n_pages, scale, cold, st);
  return cudaErrorInvalidValue;
}

}  // namespace

// k_pool/v_pool are bf16; q and out are in q_dtype.
extern "C" int sct_paged_gqa_decode(const void* q, const void* k_pool, const void* v_pool,
                                    const void* block_table, const void* seq_lens, void* out,
                                    int b, int kvh, int rep, int hd, int page, int n_pages,
                                    int q_dtype, float scale, void* stream) {
  return launch_dtype<false>(q, k_pool, v_pool, block_table, seq_lens, out, b, kvh, rep, hd,
                             page, n_pages, q_dtype, scale, ColdPools{}, stream);
}

// As sct_paged_gqa_decode, plus the int8 shadow pools k_q8/v_q8 (the pools'
// shape), their fp32 scales (P+1, kvh, hd) and cold_flags (P+1,) int32.
extern "C" int sct_paged_gqa_decode_cold(const void* q, const void* k_pool, const void* v_pool,
                                         const void* k_q8, const void* k_scale,
                                         const void* v_q8, const void* v_scale,
                                         const void* block_table, const void* seq_lens,
                                         const void* cold_flags, void* out, int b, int kvh,
                                         int rep, int hd, int page, int n_pages, int q_dtype,
                                         float scale, void* stream) {
  const ColdPools cold{static_cast<const int8_t*>(k_q8), static_cast<const float*>(k_scale),
                       static_cast<const int8_t*>(v_q8), static_cast<const float*>(v_scale),
                       static_cast<const int*>(cold_flags)};
  return launch_dtype<true>(q, k_pool, v_pool, block_table, seq_lens, out, b, kvh, rep, hd,
                            page, n_pages, q_dtype, scale, cold, stream);
}
