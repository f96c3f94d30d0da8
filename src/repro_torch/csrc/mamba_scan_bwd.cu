// Backward of the selective scan (mamba_scan.cu) for Hopper: the gradients
// of every mamba layer of the hybrid family (jamba) in training.
//
// Replaces no TPU kernel: the JAX package's Pallas scan
// (kernels/mamba_scan.py:mamba_scan_pallas) has no backward, and its model
// trains by differentiating the scan's jnp twin (nn/mamba.py:_ssm_scan, a
// lax.scan) under jax.grad. The plain version is
// kernels/mamba_ref.py:mamba_scan_bwd_ref.
//
// In: the forward's u, dt (b, S, di) contiguous and B, C (b, S, ds) with any
// batch and row stride, in T (fp32 or bf16); A (di, ds) and D (di,) in fp32 or
// T; the states the forward recorded, hs (b, ceil(S / kRec), di, ds) fp32 (h
// before every kRec-th step); dy (b, S, di) in T contiguous and, or null
// (zero), the final state's gradient dhT (b, di, ds) fp32. Out: du, ddt (b,
// S, di) in T, dB, dC (b, S, ds) in T contiguous, dA, dD in A's dtype. With
// g_t = dL/dh_t, all in fp32:
//   g_t   = dy_t C_t + exp(dt_{t+1} A) g_{t+1}        (g_{S-1}: + dhT)
//   du_t  = dt_t sum_j g_t B_t + dy_t D
//   ddt_t = sum_j g_t (A exp(dt_t A) h_{t-1}) + u_t sum_j g_t B_t
//   dB_t  = sum_d g_t dt_t u_t,   dC_t = sum_d dy_t h_t
//   dA    = sum_{b,t} g_t dt_t exp(dt_t A) h_{t-1},   dD = sum_{b,t} dy_t u_t
//
// What bounds it. At jamba's training shape (b 2, S 4096, di 8192, ds 16,
// bf16) the bytes are u, dt, dy read (403 MB), the recorded states (134 MB),
// du and ddt written (268 MB) and the per-block partials of dB and dC (268
// MB, written and read back): 0.40 ms at 3.35 TB/s. The operations are b S
// di ds = 1.07e9 elements, 18 rounded products and sums an element and 6 a
// (b, t, d) once each, and an exp an element. Counted as the card's 67
// TFLOP/s peak counts them (a fused multiply-add as two) that is 0.2945 ms;
// but no product here may fuse with a sum (the plain version's bits), so
// each operation takes a lane-clock of its own: 132 SMs x 128 lanes x 1.98
// GHz, 0.590 ms. The exp unit's 16 a clock an SM take 0.2568 ms a pass of
// exps. The kernel issues more than the bound counts: the stretch's states
// and exps 1.75 times (the accurate expf is ~8 instructions), loads,
// conversions and the sums' exchanges through shared memory, ~40
// instructions an element. It takes 2.24 ms on an H100 (700 W), the walk
// 2.14 and the reduction 0.10; taking out the exps saves 0.43 ms, the
// recompute 0.30, the sums over the channels 0.19 and over the states 0.17
// (tools/tc_probe.py --mamba-bwd, tools/flash_bwd_ablate.py --mamba-bwd).
//
// Design. A block takes the forward's 32 channels of one batch row, a
// channel's ds states over ds / kStates neighbouring lanes (a warp 32 /
// (ds / kStates) channels), and walks the recorded stretches of kRec steps
// from the last. A stretch is staged once: cp.async copies its u, dt, dy, B
// and C (16-byte pieces where di, the strides and the pointers allow) into
// a raw buffer while the stretch before it computes, and after the
// stretch's barrier the block converts them to fp32 ([channel][step] for u,
// dt, dy: a thread reads several steps of its channel in one load). A
// thread walks the stretch in groups of kU = 32 / kStates steps, the
// forward's group: a forward pass from the recorded state through the
// whole stretch keeps each group's start in shared memory and the last
// group's exps and products e h in registers (32 of each); then from the
// last group back it runs the group's reverse steps, and recomputes the
// group before it from its kept start (the forward's operations: the same
// bits). Only r = e (dy C + r) and the running sums of dA and dD carry from
// step to step. The sums are batched, kSub steps at a time, through shared
// memory off the chain: over the channels, the forward pass forms dy h and
// the reverse steps g du, each lane stores its states' products, and after
// a warp barrier each lane sums kPer (step, state) outputs over the warp's
// channels as a tree into a stretch-wide buffer of the warps' sums; after
// the next block barrier (one after the forward pass for dC, one at the
// next stretch for dB) the block adds the warps' sums as a tree and writes
// its partial. Over the states, each lane sums its states as a tree and
// stores the sum; after the warp barrier a lane adds the channel's lanes
// for one (step, channel) and writes du and ddt. dA and dD accumulate in
// registers over the whole walk, one partial a batch row. A second launch
// adds the partials in a fixed order (block after block, batch row after
// batch row) and rounds to the outputs' dtypes. No atomics: two calls give
// the same bits. With its states out of shared memory a block takes 53,760
// bytes at d_state 16 in bf16 and 127 registers a thread, no spill, so 4
// blocks an SM (16 warps) hold the whole grid of the training shape (512
// blocks) at once; 3 blocks an SM (168 registers) take 15% longer. The
// work done once a stretch or a batch (the copies' addresses, the outputs'
// offsets) takes its sizes through an empty asm, so that the compiler
// computes it anew there rather than holding it in registers across the
// walk, where they would spill.
//
// Arithmetic. Every product and sum is its own rounded operation (__fmul_rn,
// __fadd_rn) and exp the accurate expf, in the plain version's order: the
// sum over a channel's states is the forward's tree (a lane's states, then
// the lanes: kernels/mamba_ref.py:tree_sum over neighbouring pairs); the
// sum over a block's 32 channels is _block_sum's tree (a warp's channels,
// then the warps); dA and dD add their terms step after step from the last,
// then batch row after batch row; dB and dC add the blocks' partials in
// block order. So kernel and plain version agree bit for bit.
#include <algorithm>

#include "mamba.cuh"
#include "mma.cuh"

using namespace sct::mamba;

namespace {

// The launch plan, by input type, d_state and states a thread
// (kernels/mamba_scan.py:bwd_plan mirrors it).
template <typename T, int kDs, int kStates>
struct Plan {
  static constexpr int kDState = kDs;
  static constexpr int kG = kDs / kStates;          // lanes a channel
  static constexpr int kThreads = kChannels * kG;
  static constexpr int kWarps = kThreads / 32;
  static constexpr int kCW = kChannels / kWarps;    // channels a warp
  static constexpr int kRec = rec_steps(kDs);       // steps a stretch
  static constexpr int kU = 32 / kStates;           // steps a group: 32 (h, e) pairs a thread
  static constexpr int kNG = kRec / kU;             // groups a stretch
  static constexpr int kSub = kDs >= 8 ? 4 : 8;     // steps a batch of the sums
  static constexpr int kPer = kSub * kDs / 32;      // a lane's outputs of a batch's channel sums
  static constexpr int kCol = kRec + 4;             // a channel's row of u, dt, dy (fp32 words)
  static constexpr int kSubRow = kCW * kDs + 16;    // a step's row of a warp's batch of products
  // fp32 words: u, dt, dy [32][kCol] and B, C [kRec][kDs]; each warp's
  // batch of products [kSub][kSubRow] and its lanes' state sums [2][kSub][32];
  // the warps' channel sums of the stretch, dC and then dB [kWarps][kRec][kDs];
  // each thread's kept group starts [kNG - 1][kThreads][kStates]; then the
  // raw stretch in T: u, dt, dy [kRec][32] and B, C [kRec][kDs]
  static constexpr int kIn = 3 * kChannels * kCol + 2 * kRec * kDs;
  static constexpr int kWarpWords = kSub * kSubRow + 2 * kSub * 32;
  static constexpr int kCross = kWarps * kRec * kDs;
  static constexpr int kStarts = (kNG - 1) * kThreads * kStates;
  static constexpr int kSmem = 4 * (kIn + kWarps * kWarpWords + kCross + kStarts) +
                               (3 * kRec * kChannels + 2 * kRec * kDs) * (int)sizeof(T);
  // resident blocks an SM the registers must allow: at 4 states a thread
  // 4 (16 warps: the training shape's 512 blocks in one wave) where the
  // SM's 228 KB of shared memory hold them (1 KB more a block), else 2
  static constexpr int kSmemBlocks = 233472 / (kSmem + 1024);
  static constexpr int kMinBlocks = kStates != 4 ? 2 : kSmemBlocks < 4 ? kSmemBlocks : 4;
  static_assert(kNG * kU == kRec && kRec % kSub == 0, "groups and batches must tile a stretch");
  static_assert(kPer >= 1 && 32 % kCW == 0, "a batch's channel sums must cover the warp");
};

// the cap on the reduce launch's 256-thread blocks an SM: twice the 8 that
// fill an SM's 2048 threads; the grid-stride loop takes the rest
constexpr int kReduceBlocksPerSm = 16;

__device__ __forceinline__ void store_param(void* p, size_t i, float v, bool bf16) {
  if (bf16)
    static_cast<__nv_bfloat16*>(p)[i] = __float2bfloat16_rn(v);
  else
    static_cast<float*>(p)[i] = v;
}

// kN contiguous fp32 words from shared memory, in the widest vectors that fit.
template <int kN>
__device__ __forceinline__ void lds(const float* p, float* out) {
  if constexpr (kN % 4 == 0) {
#pragma unroll
    for (int i = 0; i < kN; i += 4) {
      const float4 v = *reinterpret_cast<const float4*>(p + i);
      out[i] = v.x, out[i + 1] = v.y, out[i + 2] = v.z, out[i + 3] = v.w;
    }
  } else if constexpr (kN % 2 == 0) {
#pragma unroll
    for (int i = 0; i < kN; i += 2) {
      const float2 v = *reinterpret_cast<const float2*>(p + i);
      out[i] = v.x, out[i + 1] = v.y;
    }
  } else {
#pragma unroll
    for (int i = 0; i < kN; ++i) out[i] = p[i];
  }
}
template <int kN>
__device__ __forceinline__ void sts(float* p, const float* v) {
  if constexpr (kN % 4 == 0) {
#pragma unroll
    for (int i = 0; i < kN; i += 4)
      *reinterpret_cast<float4*>(p + i) = make_float4(v[i], v[i + 1], v[i + 2], v[i + 3]);
  } else if constexpr (kN % 2 == 0) {
#pragma unroll
    for (int i = 0; i < kN; i += 2) *reinterpret_cast<float2*>(p + i) = make_float2(v[i], v[i + 1]);
  } else {
#pragma unroll
    for (int i = 0; i < kN; ++i) p[i] = v[i];
  }
}

// 8 values of T (16 or 32 bytes, aligned) from shared memory, as fp32.
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float* v) {
  const uint4 q = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    v[2 * i] = __uint_as_float(w[i] << 16);
    v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}
__device__ __forceinline__ void load8(const float* p, float* v) { lds<8>(p, v); }

// Where a thread of the walk finds its data: shared memory, its place in
// the block, and the launch's sizes and outputs.
template <typename T>
struct Walker {
  float *sU, *sDt, *sDy, *sB, *sC;  // the stretch in fp32
  float* sBatch;                    // the warp's batch of products
  float* sSums;                     // the warp's lanes' sums over their states
  float* sCross;                    // the warps' sums over their channels
  float* sStarts;                   // the thread's kept group starts
  int lane, w, cl, cw, g, c0, S, di;
  size_t row0;
  float d_out;                      // D of the channel whose du the lane writes
  T* du;
  T* ddt;
};

// The sum of kN rows of kPer words, kStride words apart, as a binary tree
// over neighbouring rows: each subtree's rows are loaded as it is summed,
// so that few registers hold rows at once.
template <int kN, int kPer, int kStride>
__device__ __forceinline__ void row_tree(const float* p, float* out) {
  if constexpr (kN == 1) {
    lds<kPer>(p, out);
  } else {
    float hi[kPer];
    row_tree<kN / 2, kPer, kStride>(p, out);
    row_tree<kN / 2, kPer, kStride>(p + kN / 2 * kStride, hi);
#pragma unroll
    for (int i = 0; i < kPer; ++i) out[i] = __fadd_rn(out[i], hi[i]);
  }
}

// A batch's sums over the warp's channels: the products of steps t .. t +
// kSub - 1 of the stretch (dy h for dC in the forward pass, g du for dB in
// the reverse steps) summed as a tree over the warp's kCW channels, kPer
// outputs a lane, into the warps' buffer. The caller brackets it with warp
// barriers.
template <typename P, typename T>
__device__ __forceinline__ void channel_sums(const Walker<T>& x, int t) {
  constexpr int kDs = P::kDState, kPer = P::kPer;
  constexpr int kLanesAStep = kDs / kPer;
  const int j = x.lane / kLanesAStep, sq = (x.lane % kLanesAStep) * kPer;
  float v[kPer];
  row_tree<P::kCW, kPer, kDs>(x.sBatch + j * P::kSubRow + sq, v);
  sts<kPer>(x.sCross + (x.w * P::kRec + t + j) * kDs + sq, v);
}

// A batch's sums over the states: each (step, channel) of the warp adds its
// channel's lanes' sums as a tree and writes du and ddt of step t + j of
// stretch k. The caller brackets it with warp barriers. (The outputs'
// offsets are computed anew each batch: see the staging.)
template <typename P, typename T>
__device__ __forceinline__ void state_sums(const Walker<T>& x, int k, int t) {
  constexpr int kG = P::kG, kCW = P::kCW, kSub = P::kSub, kCol = P::kCol;
  int di = x.di, lane = threadIdx.x % 32;
  size_t row0 = x.row0;
  asm volatile("" : "+r"(di), "+l"(row0), "+r"(lane));
  for (int e = lane; e < kSub * kCW; e += 32) {
    const int j = e / kCW, ch = x.w * kCW + e % kCW, tt = t + j;
    float sb[kG], sa[kG];
    lds<kG>(x.sSums + (j * kCW + e % kCW) * kG, sb);
    lds<kG>(x.sSums + kSub * 32 + (j * kCW + e % kCW) * kG, sa);
    tree_sum<kG>(sb);
    tree_sum<kG>(sa);
    const float dtv = x.sDt[ch * kCol + tt], uv = x.sU[ch * kCol + tt];
    const float dyv = x.sDy[ch * kCol + tt];
    const int tg = k * P::kRec + tt;
    if (tg < x.S && x.c0 + ch < di) {
      const size_t off = (row0 + tg) * di + x.c0 + ch;
      x.du[off] = sct::from_float<T>(__fadd_rn(__fmul_rn(dtv, sb[0]), __fmul_rn(dyv, x.d_out)));
      x.ddt[off] = sct::from_float<T>(__fadd_rn(sa[0], __fmul_rn(uv, sb[0])));
    }
  }
}

// Steps t0 .. t0 + kU - 1 of the stretch forward from h, with the forward's
// operations, kQ steps at a time: their exps first, then the chain. kKeep:
// keep each step's exp and e h for the reverse steps; kProducts: store dy h
// and sum each finished batch over the channels (the forward pass).
template <typename P, bool kKeep, bool kProducts, typename T, int kStates>
__device__ __forceinline__ void forward_group(const Walker<T>& x, int t0,
                                              const float (&a)[kStates], float (&h)[kStates],
                                              float (&e)[P::kU][kStates],
                                              float (&eh)[P::kU][kStates]) {
  constexpr int kU = P::kU, kSub = P::kSub, kDs = P::kDState;
  constexpr int kQ = kU < 4 ? kU : 4;  // steps of dt, u, dy a load
  const int s0 = x.g * kStates, col = x.cl * P::kCol + t0;
#pragma unroll
  for (int j0 = 0; j0 < kU; j0 += kQ) {
    float dtv[kQ], uv[kQ], dyv[kQ];
    lds<kQ>(x.sDt + col + j0, dtv);
    lds<kQ>(x.sU + col + j0, uv);
    if constexpr (kProducts) lds<kQ>(x.sDy + col + j0, dyv);
    float ex[kQ][kStates];
#pragma unroll
    for (int jj = 0; jj < kQ; ++jj)
#pragma unroll
      for (int i = 0; i < kStates; ++i) ex[jj][i] = expf(__fmul_rn(dtv[jj], a[i]));
#pragma unroll
    for (int jj = 0; jj < kQ; ++jj) {
      const int j = j0 + jj;
      float bv[kStates];
      lds<kStates>(x.sB + (t0 + j) * kDs + s0, bv);
      const float duj = __fmul_rn(dtv[jj], uv[jj]);
#pragma unroll
      for (int i = 0; i < kStates; ++i) {
        const float p = __fmul_rn(ex[jj][i], h[i]);
        h[i] = __fadd_rn(p, __fmul_rn(duj, bv[i]));
        if constexpr (kKeep) {
          e[j][i] = ex[jj][i];
          eh[j][i] = p;
        }
      }
      if constexpr (kProducts) {
        // (a group starts a batch where the batch divides it: j's slot is static)
        const int t = t0 + j, slot = kU % kSub == 0 ? j % kSub : t % kSub;
        float pc[kStates];
#pragma unroll
        for (int i = 0; i < kStates; ++i) pc[i] = __fmul_rn(dyv[jj], h[i]);
        sts<kStates>(x.sBatch + slot * P::kSubRow + x.cw * kDs + s0, pc);
        if (slot == kSub - 1) {
          __syncwarp();
          channel_sums<P>(x, t + 1 - kSub);
          __syncwarp();
        }
      }
    }
  }
}

// Steps t0 + kU - 1 .. t0 of stretch k backward: g = dy C + r, r = e g, the
// products of dA, du, ddt and dB; each finished batch summed over the
// states (du, ddt out) and over the channels.
template <typename P, typename T, int kStates>
__device__ __forceinline__ void reverse_group(const Walker<T>& x, int k, int t0,
                                              const float (&a)[kStates], float (&r)[kStates],
                                              float (&dA)[kStates], float& dD,
                                              const float (&e)[P::kU][kStates],
                                              const float (&eh)[P::kU][kStates]) {
  constexpr int kU = P::kU, kSub = P::kSub, kG = P::kG, kCW = P::kCW, kDs = P::kDState;
  constexpr int kQ = kU < 2 ? kU : 2;  // steps of dt, u, dy a load
  const int s0 = x.g * kStates;
  float qdt[kQ], qu[kQ], qdy[kQ];
#pragma unroll
  for (int j = kU - 1; j >= 0; --j) {
    const int t = t0 + j, slot = kU % kSub == 0 ? j % kSub : t % kSub;
    if (j % kQ == kQ - 1) {
      const int at = x.cl * P::kCol + t + 1 - kQ;
      lds<kQ>(x.sDt + at, qdt);
      lds<kQ>(x.sU + at, qu);
      lds<kQ>(x.sDy + at, qdy);
    }
    const float dtj = qdt[j % kQ], uj = qu[j % kQ], dyj = qdy[j % kQ];
    float bv[kStates], cv[kStates];
    lds<kStates>(x.sB + t * kDs + s0, bv);
    lds<kStates>(x.sC + t * kDs + s0, cv);
    const float duj = __fmul_rn(dtj, uj);
    float pb[kStates], pa[kStates], pd[kStates];
#pragma unroll
    for (int i = 0; i < kStates; ++i) {
      const float gt = __fadd_rn(__fmul_rn(dyj, cv[i]), r[i]);
      r[i] = __fmul_rn(e[j][i], gt);
      const float q = __fmul_rn(gt, eh[j][i]);
      pb[i] = __fmul_rn(gt, bv[i]);
      pa[i] = __fmul_rn(q, a[i]);
      dA[i] = __fadd_rn(dA[i], __fmul_rn(q, dtj));
      pd[i] = __fmul_rn(gt, duj);
    }
    dD = __fadd_rn(dD, __fmul_rn(dyj, uj));
    tree_sum<kStates>(pb);
    tree_sum<kStates>(pa);
    sts<kStates>(x.sBatch + slot * P::kSubRow + x.cw * kDs + s0, pd);
    x.sSums[(slot * kCW + x.cw) * kG + x.g] = pb[0];
    x.sSums[kSub * 32 + (slot * kCW + x.cw) * kG + x.g] = pa[0];
    if (slot == 0) {
      __syncwarp();
      state_sums<P>(x, k, t);
      channel_sums<P>(x, t);
      __syncwarp();
    }
  }
}

template <typename T, int kDs, int kStates>
__global__ void __launch_bounds__(Plan<T, kDs, kStates>::kThreads,
                                  Plan<T, kDs, kStates>::kMinBlocks)
mamba_scan_bwd_kernel(const T* __restrict__ u, const T* __restrict__ dt,
                      const T* __restrict__ B, const T* __restrict__ C,
                      const void* __restrict__ A, const void* __restrict__ D, bool ad_bf16,
                      const float* __restrict__ hs, const T* __restrict__ dy,
                      const float* __restrict__ dhT, T* __restrict__ du, T* __restrict__ ddt,
                      float* __restrict__ part_b, float* __restrict__ part_c,
                      float* __restrict__ part_a, float* __restrict__ part_d, int S, int di,
                      Strides st) {
  using P = Plan<T, kDs, kStates>;
  constexpr int kG = P::kG, kThreads = P::kThreads, kWarps = P::kWarps;
  constexpr int kRec = P::kRec, kU = P::kU, kNG = P::kNG, kCol = P::kCol;
  constexpr int kVec = 16 / sizeof(T);   // values a 16-byte piece
  extern __shared__ float4 smem_raw[];
  const int tid = threadIdx.x;
  Walker<T> x;
  x.sU = reinterpret_cast<float*>(smem_raw);   // [32][kCol]
  x.sDt = x.sU + kChannels * kCol;
  x.sDy = x.sDt + kChannels * kCol;
  x.sB = x.sDy + kChannels * kCol;             // [kRec][kDs]
  x.sC = x.sB + kRec * kDs;
  x.lane = tid % 32;
  x.w = tid / 32;
  x.sBatch = x.sC + kRec * kDs + x.w * P::kWarpWords;
  x.sSums = x.sBatch + P::kSub * P::kSubRow;
  x.sCross = x.sC + kRec * kDs + kWarps * P::kWarpWords;
  x.sStarts = x.sCross + P::kCross + tid * kStates;
  T* const rU = reinterpret_cast<T*>(x.sCross + P::kCross + P::kStarts);  // [3][kRec][32]
  T* const rB = rU + 3 * kRec * kChannels;                   // [2][kRec][kDs]
  x.cl = tid / kG;
  x.g = tid % kG;
  x.cw = x.lane / kG;
  x.c0 = blockIdx.x * kChannels;
  x.S = S;
  x.di = di;
  x.du = du;
  x.ddt = ddt;
  const int blk = blockIdx.x, nblk = gridDim.x, c0 = x.c0, c = c0 + x.cl;
  const int bb = blockIdx.y;
  const bool live = c < di;
  const int nrec = (S + kRec - 1) / kRec;
  const size_t row0 = (size_t)bb * S;
  x.row0 = row0;
  const int s0 = x.g * kStates;  // the thread's first state
  const T zero = sct::from_float<T>(0.f);

  float a[kStates], r[kStates], dA[kStates];
#pragma unroll
  for (int i = 0; i < kStates; ++i) {
    a[i] = live ? load_param(A, (size_t)c * kDs + s0 + i, ad_bf16) : 0.f;
    r[i] = live && dhT != nullptr ? dhT[((size_t)bb * di + c) * kDs + s0 + i] : 0.f;
    dA[i] = 0.f;
  }
  float dD = 0.f;
  const int c_out = c0 + x.w * P::kCW + x.lane % P::kCW;
  x.d_out = c_out < di ? load_param(D, c_out, ad_bf16) : 0.f;

  // Stretch k into the raw buffer: cp.async (committed as one group), or
  // plain loads where the pieces cannot be 16-byte copies. Steps past S
  // and channels past di are zeros: such a step leaves every carried value
  // as it was (e = 1, no product adds anything) and its outputs are not
  // written. The sizes and strides pass through an empty asm first, so
  // that the compiler computes the copies' addresses anew each stretch and
  // keeps none of them in the registers the walk needs.
  auto stage = [&](int k) {
    int tid = threadIdx.x, n_di = di;
    long long s_row = (long long)bb * S, b_batch = st.b_batch, b_row = st.b_row;
    long long c_batch = st.c_batch, c_row = st.c_row;
    asm volatile("" : "+r"(tid), "+r"(n_di), "+l"(s_row), "+l"(b_batch), "+l"(b_row),
                 "+l"(c_batch), "+l"(c_row));
    const int t0 = k * kRec, nt = min(kRec, S - t0);
    // 16-byte pieces where di, the strides and the pointers allow
    const bool vec = n_di % kVec == 0 && reinterpret_cast<uintptr_t>(u) % 16 == 0 &&
                     reinterpret_cast<uintptr_t>(dt) % 16 == 0 &&
                     reinterpret_cast<uintptr_t>(dy) % 16 == 0;
    const bool vec_bc = kDs % kVec == 0 && b_batch % kVec == 0 && b_row % kVec == 0 &&
                        c_batch % kVec == 0 && c_row % kVec == 0 &&
                        reinterpret_cast<uintptr_t>(B) % 16 == 0 &&
                        reinterpret_cast<uintptr_t>(C) % 16 == 0;
    constexpr int kRowPieces = kChannels / kVec, kArr = kRec * kRowPieces;
    for (int e = tid; e < 3 * kArr; e += kThreads) {
      const int arr = e / kArr, rr = (e % kArr) / kRowPieces, cc = c0 + kVec * (e % kRowPieces);
      const T* const src = arr == 0 ? u : arr == 1 ? dt : dy;
      T* const dst = rU + (arr * kRec + rr) * kChannels + (cc - c0);
      const size_t off = (size_t)(s_row + t0 + rr) * n_di + cc;
      if (vec) {
        const bool ok = rr < nt && cc < n_di;
        sct::mma::cp_async16(dst, ok ? src + off : src, ok);
      } else {
#pragma unroll
        for (int m = 0; m < kVec; ++m) dst[m] = rr < nt && cc + m < n_di ? src[off + m] : zero;
      }
    }
    if (vec_bc) {
      constexpr int kPieces = kRec * kDs / kVec;
      for (int e = tid; e < 2 * kPieces; e += kThreads) {
        const int arr = e / kPieces, rr = (e % kPieces) / (kDs / kVec);
        const int j = kVec * (e % (kDs / kVec));
        const T* const src = arr == 0 ? B + bb * b_batch + (t0 + rr) * b_row
                                      : C + bb * c_batch + (t0 + rr) * c_row;
        sct::mma::cp_async16(rB + (arr * kRec + rr) * kDs + j, rr < nt ? src + j : B, rr < nt);
      }
    } else {
      for (int e = tid; e < 2 * kRec * kDs; e += kThreads) {
        const int arr = e / (kRec * kDs), rr = (e % (kRec * kDs)) / kDs, j = e % kDs;
        rB[e] = rr >= nt ? zero
                : arr == 0 ? B[bb * b_batch + (t0 + rr) * b_row + j]
                           : C[bb * c_batch + (t0 + rr) * c_row + j];
      }
    }
    sct::mma::cp_async_commit();
  };

  // the raw stretch to fp32: u, dt, dy transposed to [channel][step]
  // (consecutive lanes take consecutive steps of one 8-channel piece), B
  // and C as they are
  auto convert = [&]() {
    int tid = threadIdx.x;  // (offsets computed anew each stretch: see the staging)
    asm volatile("" : "+r"(tid));
    constexpr int kPieces = kRec * (kChannels / 8);
    for (int e = tid; e < 3 * kPieces; e += kThreads) {
      const int arr = e / kPieces, rr = e % kRec, cc = 8 * ((e % kPieces) / kRec);
      float v[8];
      load8(rU + (arr * kRec + rr) * kChannels + cc, v);
      float* const out = x.sU + arr * kChannels * kCol + cc * kCol + rr;
#pragma unroll
      for (int m = 0; m < 8; ++m) out[m * kCol] = v[m];
    }
    for (int e = tid; e < 2 * kRec * kDs; e += kThreads) x.sB[e] = sct::to_float(rB[e]);
  };

  // the block's partial sums over its channels of stretch k into part
  // (dC after the forward pass, dB after the reverse steps): the warps' sums
  // added as a tree, 16-byte pieces
  auto write_partials = [&](int k, float* __restrict__ part) {
    int tid = threadIdx.x;  // (offsets computed anew each stretch: see the staging)
    asm volatile("" : "+r"(tid));
    const int t0 = k * kRec, nt = min(kRec, S - t0);
    constexpr int kQuads = kRec * kDs / 4;
    for (int e = tid; e < kQuads; e += kThreads) {
      if (e / (kDs / 4) >= nt) continue;
      float v[kWarps][4];
#pragma unroll
      for (int m = 0; m < kWarps; ++m) lds<4>(x.sCross + m * kRec * kDs + 4 * e, v[m]);
#pragma unroll
      for (int d = 1; d < kWarps; d *= 2)
#pragma unroll
        for (int m = 0; m + d < kWarps; m += 2 * d)
#pragma unroll
          for (int i = 0; i < 4; ++i) v[m][i] = __fadd_rn(v[m][i], v[m + d][i]);
      float* const out = part + (((size_t)bb * nblk + blk) * S + t0) * kDs + 4 * e;
      *reinterpret_cast<float4*>(out) = make_float4(v[0][0], v[0][1], v[0][2], v[0][3]);
    }
  };

  stage(nrec - 1);
  for (int k = nrec - 1; k >= 0; --k) {
    float h[kStates], e[kU][kStates], eh[kU][kStates];
    int n_di = di;  // (the offset computed anew each stretch: see the staging)
    asm volatile("" : "+r"(n_di));
    const float* const rec = hs + (((size_t)bb * nrec + k) * n_di + c) * kDs + s0;
#pragma unroll
    for (int i = 0; i < kStates; ++i) h[i] = live ? rec[i] : 0.f;
    sct::mma::cp_async_wait<0>();
    __syncthreads();  // stretch k is staged; stretch k + 1's dB sums are in
    convert();
    if (k + 1 < nrec) write_partials(k + 1, part_b);
    __syncthreads();  // stretch k is in fp32; the raw buffer and the warps' sums are free
    if (k > 0) stage(k - 1);

    // the forward pass from the recorded state, each group's start kept in
    // shared memory, the last group's exps and e h in registers
#pragma unroll 1
    for (int grp = 0; grp < kNG - 1; ++grp) {
      sts<kStates>(x.sStarts + grp * kThreads * kStates, h);
      forward_group<P, false, true>(x, grp * kU, a, h, e, eh);
    }
    forward_group<P, true, true>(x, (kNG - 1) * kU, a, h, e, eh);
    __syncthreads();  // the stretch's dC sums are in
    write_partials(k, part_c);
    __syncthreads();  // the warps' sums are free for dB
    // the groups from the last back, each but the last recomputed from its
    // kept start
    reverse_group<P>(x, k, (kNG - 1) * kU, a, r, dA, dD, e, eh);
#pragma unroll 1
    for (int grp = kNG - 2; grp >= 0; --grp) {
      lds<kStates>(x.sStarts + grp * kThreads * kStates, h);
      forward_group<P, true, false>(x, grp * kU, a, h, e, eh);
      reverse_group<P>(x, k, grp * kU, a, r, dA, dD, e, eh);
    }
  }
  __syncthreads();
  write_partials(0, part_b);
  if (live) {
    float* const pa = part_a + ((size_t)bb * di + c) * kDs + s0;
#pragma unroll
    for (int i = 0; i < kStates; ++i) pa[i] = dA[i];
    if (x.g == 0) part_d[(size_t)bb * di + c] = dD;
  }
}

// dB, dC (b, S, ds): the blocks' partials in block order; dA (di, ds), dD
// (di): the batch rows' in row order. One thread an output.
template <typename T>
__global__ void __launch_bounds__(256)
mamba_scan_bwd_reduce(const float* __restrict__ part_b, const float* __restrict__ part_c,
                      const float* __restrict__ part_a, const float* __restrict__ part_d,
                      T* __restrict__ dB, T* __restrict__ dC, void* __restrict__ dA,
                      void* __restrict__ dD, bool ad_bf16, int b, int S, int di, int ds,
                      int nblk) {
  const size_t plane = (size_t)S * ds, nbc = (size_t)b * plane;
  const size_t na = (size_t)di * ds, total = nbc + na + di;
  for (size_t e = (size_t)blockIdx.x * blockDim.x + threadIdx.x; e < total;
       e += (size_t)gridDim.x * blockDim.x) {
    if (e < nbc) {
      const size_t bb = e / plane, rest = e % plane;
      const float* const pb = part_b + bb * nblk * plane + rest;
      const float* const pc = part_c + bb * nblk * plane + rest;
      float sb = pb[0], sc = pc[0];
      for (int k = 1; k < nblk; ++k) {
        sb = __fadd_rn(sb, pb[k * plane]);
        sc = __fadd_rn(sc, pc[k * plane]);
      }
      dB[e] = sct::from_float<T>(sb);
      dC[e] = sct::from_float<T>(sc);
    } else if (e < nbc + na) {
      const size_t i = e - nbc;
      float s = part_a[i];
      for (int bb = 1; bb < b; ++bb) s = __fadd_rn(s, part_a[bb * na + i]);
      store_param(dA, i, s, ad_bf16);
    } else {
      const size_t i = e - nbc - na;
      float s = part_d[i];
      for (int bb = 1; bb < b; ++bb) s = __fadd_rn(s, part_d[(size_t)bb * di + i]);
      store_param(dD, i, s, ad_bf16);
    }
  }
}

// The walk kernel's instance, allowed its shared memory and the largest
// carveout of the SM's (several blocks an SM).
template <typename T, int kDs, int kStates>
cudaError_t prepare(int smem) {
  auto kernel = mamba_scan_bwd_kernel<T, kDs, kStates>;
  cudaError_t err = sct::allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                              cudaSharedmemCarveoutMaxShared);
}

template <typename T, int kDs, int kStates>
cudaError_t launch_one(const void* u, const void* dt, const void* B, const void* C,
                       const void* A, const void* D, bool ad_bf16, const void* hs,
                       const void* dy, const void* dhT, void* du, void* ddt, void* part_b,
                       void* part_c, void* part_a, void* part_d, int b, int S, int di,
                       const Strides& st, int smem, cudaStream_t stream) {
  using P = Plan<T, kDs, kStates>;
  if (smem != P::kSmem) return cudaErrorInvalidValue;
  auto kernel = mamba_scan_bwd_kernel<T, kDs, kStates>;
  cudaError_t err = prepare<T, kDs, kStates>(smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((di + kChannels - 1) / kChannels, b);
  kernel<<<grid, P::kThreads, smem, stream>>>(
      static_cast<const T*>(u), static_cast<const T*>(dt), static_cast<const T*>(B),
      static_cast<const T*>(C), A, D, ad_bf16, static_cast<const float*>(hs),
      static_cast<const T*>(dy), static_cast<const float*>(dhT), static_cast<T*>(du),
      static_cast<T*>(ddt), static_cast<float*>(part_b), static_cast<float*>(part_c),
      static_cast<float*>(part_a), static_cast<float*>(part_d), S, di, st);
  return cudaGetLastError();
}

// The (d_state, states a thread) pairs the kernel is built for: the plan's
// (kernels/mamba_scan.py:BWD_STATES).
#define SCT_SCAN_BWD_INSTANCES(X) X(4, 4) X(8, 4) X(16, 4) X(32, 8) X(64, 16)

template <typename T>
cudaError_t launch(const void* u, const void* dt, const void* B, const void* C, const void* A,
                   const void* D, bool ad_bf16, const void* hs, const void* dy, const void* dhT,
                   void* du, void* ddt, void* dB, void* dC, void* dA, void* dD, void* part_b,
                   void* part_c, void* part_a, void* part_d, int b, int S, int di, int ds,
                   int states, const Strides& st, int smem, cudaStream_t stream) {
  cudaError_t err = cudaErrorInvalidValue;
#define SCT_SCAN_BWD(DS, NS)                                                                 \
  if (ds == DS && states == NS)                                                              \
    err = launch_one<T, DS, NS>(u, dt, B, C, A, D, ad_bf16, hs, dy, dhT, du, ddt, part_b,    \
                                part_c, part_a, part_d, b, S, di, st, smem, stream);
  SCT_SCAN_BWD_INSTANCES(SCT_SCAN_BWD)
#undef SCT_SCAN_BWD
  if (err != cudaSuccess) return err;
  const int nblk = (di + kChannels - 1) / kChannels;
  const size_t total = (size_t)b * S * ds + (size_t)di * ds + di;
  // a grid-stride loop: one thread an output, up to kReduceBlocksPerSm
  // resident blocks on every SM of the device
  int dev = 0, sms = 0;
  err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const int blocks =
      (int)std::min<size_t>((total + 255) / 256, (size_t)sms * kReduceBlocksPerSm);
  mamba_scan_bwd_reduce<T><<<blocks, 256, 0, stream>>>(
      static_cast<const float*>(part_b), static_cast<const float*>(part_c),
      static_cast<const float*>(part_a), static_cast<const float*>(part_d), static_cast<T*>(dB),
      static_cast<T*>(dC), dA, dD, ad_bf16, b, S, di, ds, nblk);
  return cudaGetLastError();
}

template <typename T>
cudaError_t occupancy(int ds, int states, int* blocks) {
  cudaError_t err = cudaErrorInvalidValue;
#define SCT_SCAN_BWD(DS, NS)                                                                 \
  if (ds == DS && states == NS) {                                                            \
    using P = Plan<T, DS, NS>;                                                               \
    const int smem = P::kSmem;                                                               \
    err = prepare<T, DS, NS>(smem);                                                          \
    if (err == cudaSuccess)                                                                  \
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(                                   \
          blocks, mamba_scan_bwd_kernel<T, DS, NS>, P::kThreads, smem);                      \
  }
  SCT_SCAN_BWD_INSTANCES(SCT_SCAN_BWD)
#undef SCT_SCAN_BWD
  return err;
}

}  // namespace

// The walk kernel's resident blocks an SM (cudaOccupancyMaxActiveBlocksPer
// Multiprocessor) at a d_state and states a thread, for inputs of dtype;
// a negative CUDA error code where that instance is not built.
extern "C" int sct_mamba_scan_bwd_occupancy(int ds, int states, int dtype) {
  int blocks = 0;
  const cudaError_t err = dtype == sct::kFloat32      ? occupancy<float>(ds, states, &blocks)
                          : dtype == sct::kBFloat16 ? occupancy<__nv_bfloat16>(ds, states, &blocks)
                                                    : cudaErrorInvalidValue;
  return err == cudaSuccess ? blocks : -static_cast<int>(err);
}

// Two launches: the reverse walk (partials) and the reduction. dhT may be
// null (zero). part_b, part_c: (b, ceil(di / 32), S, ds) fp32; part_a (b, di,
// ds), part_d (b, di) fp32: scratch from the wrapper. rec and smem are the
// caller's plan (steps between recorded states, a block's shared memory),
// checked against the kernel's.
extern "C" int sct_mamba_scan_bwd(const void* u, const void* dt, const void* B, const void* C,
                                  const void* A, const void* D, const void* hs, const void* dy,
                                  const void* dhT, void* du, void* ddt, void* dB, void* dC,
                                  void* dA, void* dD, void* part_b, void* part_c, void* part_a,
                                  void* part_d, int b, int S, int di, int ds, int states,
                                  int rec, int dtype, int ad_dtype, long long b_batch,
                                  long long b_row, long long c_batch, long long c_row, int smem,
                                  void* stream) {
  if (b <= 0 || di <= 0) return cudaSuccess;
  if (S <= 0 || (ad_dtype != sct::kFloat32 && ad_dtype != dtype) || rec != rec_steps(ds))
    return cudaErrorInvalidValue;
  cudaStream_t stm = static_cast<cudaStream_t>(stream);
  const Strides strides{b_batch, b_row, c_batch, c_row};
  const bool ad_bf16 = ad_dtype == sct::kBFloat16;
  if (dtype == sct::kFloat32)
    return launch<float>(u, dt, B, C, A, D, ad_bf16, hs, dy, dhT, du, ddt, dB, dC, dA, dD,
                         part_b, part_c, part_a, part_d, b, S, di, ds, states, strides, smem,
                         stm);
  if (dtype == sct::kBFloat16)
    return launch<__nv_bfloat16>(u, dt, B, C, A, D, ad_bf16, hs, dy, dhT, du, ddt, dB, dC, dA,
                                 dD, part_b, part_c, part_a, part_d, b, S, di, ds, states,
                                 strides, smem, stm);
  return cudaErrorInvalidValue;
}
