// Selective scan (Mamba's SSM) for Hopper: the prefill of every mamba layer
// of the hybrid family (jamba), returning the outputs and the final state
// the decode step continues from.
//
// Replaces the TPU kernel kernels/mamba_scan.py:mamba_scan_pallas of the JAX
// package (whose jnp twin is nn/mamba.py:_ssm_scan); the plain version is
// kernels/mamba_ref.py.
//
// u, dt (b, S, di) contiguous and B, C (b, S, ds) in T (fp32 or bf16), B and
// C with any batch and row stride (the model hands over column views of
// x_proj's output); A (di, ds) and D (di,) in fp32 or in T, converted in
// registers. Out: y (b, S, di) in T and the final state hT (b, di, ds) fp32;
// in training also, given a non-null hs, the state before every kRec-th step,
// hs (b, ceil(S / kRec), di, ds) fp32, from which the backward
// (mamba_scan_bwd.cu) recomputes the states it needs (kRec = 32 up to ds 16,
// 512 / ds above: kernels/mamba_ref.py:record_steps). Recording writes and
// computes nothing else: y and hT keep their bits, with or without it.
// With h from zero:
//   h_t = exp(dt_t * A) * h_{t-1} + (dt_t * u_t) * B_t
//   y_t = sum_j h_t[., j] C_t[j] + u_t * D
// all in fp32, y rounded once a step: the Pallas kernel's arithmetic (its
// twin carries h in u's dtype instead; the two agree in fp32). Three things
// the TPU kernel does not do: it returns y only (the prefill needs hT), and
// it asserts that the chunk sizes divide S and di (the prompts are ragged:
// here any S >= 1 and any di, the edges masked).
//
// What bounds it. Bytes are few: at jamba's prefill (b 1, S 160, di 8192,
// ds 16, bf16) u, dt and y are 3 S di bf16 values and hT di ds fp32, ~8.7 MB,
// 2.6 us at 3.35 TB/s. The work is S di ds elements (21 M there, 537 M at S
// 4096), each an exp and five rounded products and sums: dt a, the accurate
// expf (one MUFU.EX2 among eight instructions), dA h, du B, their sum, h C
// and its share of the sum over the states. That is ~14 instruction slots an
// element, which at one warp instruction a clock on each of the 132 x 4
// schedulers bounds the scan well above the bytes and above the exp unit
// alone (16 exps a clock an SM). On an H100 (700 W) the exps of dt a alone
// take 0.013 ms at jamba's prefill and 0.19 ms at S 4096 on a full card;
// this kernel takes 0.023 and 0.42 ms (tools/tc_probe.py --mamba).
//
// Design. The scan is sequential in t and independent over (batch, channel,
// state); only h = dA h + du B is carried from step to step. A channel's ds
// states are split over G = ds / kStates neighbouring lanes, kStates
// contiguous states each (h and the row of A in registers), and a block
// takes 32 channels: at jamba's width 4 warps of 8 channels on each of 256
// blocks. A thread walks a tile in groups of kU steps: it first reads the
// group's (u, dt) pairs and its states' B and C (16-byte vectors) from
// shared memory, then computes the group's kU x kStates exps, all
// independent, then runs the carried chain through the group and sums each
// step's h C products as a tree, then combines the G lanes' sums of all kU
// steps at once (shuffles, off the chain) and adds u D, each lane a share of
// the steps: nothing waits on the chain but the chain. A tile of kTile
// steps is staged in shared memory in fp32, once for all warps: each thread
// loads its share of the tile after next into registers (16-byte pieces of
// u and dt rows where di and the pointers allow) while the current one
// computes, and stores it into the other of two buffers after. The tile's y
// goes to shared memory too and is written out after the tile's barrier,
// 16 bytes a thread, while the next tile computes: one barrier a tile.
//
// Arithmetic. Every product and sum is its own rounded operation (__fmul_rn,
// __fadd_rn: no fused multiply-add) and exp is the accurate expf. The sum
// over the states is a binary tree over neighbouring pairs (a lane's states
// form its subtrees, the shuffles over 1, 2, .. lanes the rest), which the
// plain version takes in the same order, so kernel and plain version agree
// bit for bit where their exp does, and a bf16 y rounds from the same fp32
// value.
#include "mamba.cuh"

using namespace sct::mamba;

namespace {

// A thread's kN contiguous fp32 words from shared memory, as 16- or 8-byte
// vectors.
template <int kN>
__device__ __forceinline__ void load_words(const float* p, float (&out)[kN]) {
  if constexpr (kN % 4 == 0) {
#pragma unroll
    for (int i = 0; i < kN; i += 4) {
      const float4 v = *reinterpret_cast<const float4*>(p + i);
      out[i] = v.x, out[i + 1] = v.y, out[i + 2] = v.z, out[i + 3] = v.w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < kN; i += 2) {
      const float2 v = *reinterpret_cast<const float2*>(p + i);
      out[i] = v.x, out[i + 1] = v.y;
    }
  }
}

// The dynamic shared memory of a block: two input buffers of kTile steps,
// each the (u, dt) pairs of the 32 channels, then the B and C rows; then
// two buffers of the tile's y, fp32.
__host__ __device__ constexpr int in_words(int ds) {
  return kTile * (2 * kChannels + 2 * ds);
}
__host__ __device__ constexpr int smem_bytes(int ds) {
  return 4 * 2 * (in_words(ds) + kTile * kChannels);
}

// kN = 16 / sizeof(T) values rounded to T and stored as one 16-byte vector.
template <typename T, int kN>
__device__ __forceinline__ void store16(T* p, const float (&v)[kN]) {
  static_assert(kN * sizeof(T) == 16, "16 bytes");
  T w[kN];
#pragma unroll
  for (int m = 0; m < kN; ++m) w[m] = sct::from_float<T>(v[m]);
  uint4 q;
  memcpy(&q, w, 16);
  *reinterpret_cast<uint4*>(p) = q;
}

// Steps r0 .. r0 + kU - 1 of a thread's states: the loads, then the exps,
// then the chain and each step's tree of h C products, then the sums over
// the channel's kGroups lanes and the lane's share of y (to shared memory).
template <int kU, int kStates, int kGroups, int kDs>
__device__ __forceinline__ void scan_steps(const float2* uv, const float* Bs, const float* Cs,
                                           const float (&a)[kStates], float (&h)[kStates],
                                           float dd, float* ys, int r0, int cl, int g) {
  float2 ud[kU];
  float bv[kU][kStates], cv[kU][kStates], dA[kU][kStates], ps[kU];
#pragma unroll
  for (int s = 0; s < kU; ++s) {
    ud[s] = uv[(r0 + s) * kChannels + cl];
    load_words<kStates>(Bs + (r0 + s) * kDs, bv[s]);
    load_words<kStates>(Cs + (r0 + s) * kDs, cv[s]);
  }
#pragma unroll
  for (int s = 0; s < kU; ++s)
#pragma unroll
    for (int i = 0; i < kStates; ++i) dA[s][i] = expf(__fmul_rn(ud[s].y, a[i]));
#pragma unroll
  for (int s = 0; s < kU; ++s) {
    const float du = __fmul_rn(ud[s].y, ud[s].x);
    float p[kStates];
#pragma unroll
    for (int i = 0; i < kStates; ++i) {
      h[i] = __fadd_rn(__fmul_rn(dA[s][i], h[i]), __fmul_rn(du, bv[s][i]));
      p[i] = __fmul_rn(h[i], cv[s][i]);
    }
    tree_sum<kStates>(p);
    ps[s] = p[0];
  }
  // lanes g ^ 1, g ^ 2, ..: the tree's upper levels, every lane gets the sum
#pragma unroll
  for (int w = 1; w < kGroups; w *= 2)
#pragma unroll
    for (int s = 0; s < kU; ++s) ps[s] = __fadd_rn(ps[s], __shfl_xor_sync(0xffffffffu, ps[s], w));
#pragma unroll
  for (int s = 0; s < kU; ++s)
    if (s % kGroups == g) ys[(r0 + s) * kChannels + cl] = __fadd_rn(ps[s], __fmul_rn(ud[s].x, dd));
}

// kRecord: write the state before every kRec-th step into hs (training);
// serving's build leaves the step loop as it was without it
template <typename T, int kDs, int kStates, bool kRecord>
__global__ void __launch_bounds__(kChannels * (kDs / kStates))
mamba_scan_kernel(const T* __restrict__ u, const T* __restrict__ dt, const T* __restrict__ B,
                  const T* __restrict__ C, const void* __restrict__ A,
                  const void* __restrict__ D, bool ad_bf16, T* __restrict__ y,
                  float* __restrict__ hT, float* __restrict__ hs, int S, int di, Strides st) {
  constexpr int kGroups = kDs / kStates;                 // lanes a channel
  constexpr int kThreads = kChannels * kGroups;
  constexpr int kU = kStates >= 32 ? 1 : 32 / kStates;   // steps a group
  constexpr int kVec = 16 / sizeof(T);                   // channels a 16-byte row piece
  constexpr int kPieces = kChannels / kVec;              // pieces a step's row
  constexpr int kPiecesTile = kTile * kPieces;
  constexpr int kLd = (kPiecesTile + kThreads - 1) / kThreads;  // u, dt pieces a thread stages
  constexpr int kBC = kTile * kDs / kThreads;            // B and C values a thread stages
  constexpr int kIn = in_words(kDs);
  constexpr int kRec = rec_steps(kDs);
  static_assert(kBC * kThreads == kTile * kDs, "B and C words must split evenly");
  static_assert(kTile % kRec == 0 && kRec % kU == 0, "recorded steps must start groups");
  extern __shared__ float4 smem_raw[];
  float* const sm = reinterpret_cast<float*>(smem_raw);
  float* const ys = sm + 2 * kIn;                          // [2][kTile][kChannels]

  const int cl = threadIdx.x / kGroups, g = threadIdx.x % kGroups;
  const int c0 = blockIdx.x * kChannels, c = c0 + cl;
  const int bb = blockIdx.y;
  const bool live = c < di;
  const int ntiles = (S + kTile - 1) / kTile;
  const size_t row0 = (size_t)bb * S;
  // 16-byte pieces of u and dt rows where di and the pointers allow
  const bool vec = di % kVec == 0 && reinterpret_cast<uintptr_t>(u) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(dt) % 16 == 0;
  const bool vec_y = di % kVec == 0 && reinterpret_cast<uintptr_t>(y) % 16 == 0;

  float a[kStates], h[kStates];
#pragma unroll
  for (int i = 0; i < kStates; ++i) {
    a[i] = live ? load_param(A, (size_t)c * kDs + g * kStates + i, ad_bf16) : 0.f;
    h[i] = 0.f;
  }
  const float dd = live ? load_param(D, c, ad_bf16) : 0.f;

  // the inputs of the tile after next, in flight in registers: piece e =
  // threadIdx.x + kThreads i of the tile's u and dt rows (step e / kPieces,
  // channels kVec (e % kPieces) ..), and B and C words threadIdx.x +
  // kThreads i of the tile's kTile x kDs
  T ur[kLd][kVec], dr[kLd][kVec], br[kBC], cr[kBC];
  const T zero = sct::from_float<T>(0.f);
  auto fetch = [&](int k) {
    const int t0 = k * kTile, nt = min(kTile, S - t0);
#pragma unroll
    for (int i = 0; i < kLd; ++i) {
      const int e = threadIdx.x + kThreads * i, r = e / kPieces;
      const int cc = c0 + kVec * (e % kPieces);
      const bool ok = e < kPiecesTile && r < nt;
      const size_t off = (row0 + t0 + r) * di + cc;
      if (ok && vec) {
        const uint4 pu = *reinterpret_cast<const uint4*>(u + off);
        const uint4 pd = *reinterpret_cast<const uint4*>(dt + off);
        memcpy(ur[i], &pu, 16);
        memcpy(dr[i], &pd, 16);
      } else {
#pragma unroll
        for (int m = 0; m < kVec; ++m) {
          const bool in = ok && cc + m < di;
          ur[i][m] = in ? u[off + m] : zero;
          dr[i][m] = in ? dt[off + m] : zero;
        }
      }
    }
#pragma unroll
    for (int i = 0; i < kBC; ++i) {
      const int e = threadIdx.x + kThreads * i, r = e / kDs, j = e % kDs;
      const bool ok = r < nt;
      br[i] = ok ? B[bb * st.b_batch + (t0 + r) * st.b_row + j] : zero;
      cr[i] = ok ? C[bb * st.c_batch + (t0 + r) * st.c_row + j] : zero;
    }
  };
  auto stash = [&](int k) {
    float* const buf = sm + (k & 1) * kIn;
#pragma unroll
    for (int i = 0; i < kLd; ++i) {
      const int e = threadIdx.x + kThreads * i;
      if (e >= kPiecesTile) break;
      float4* const dst = reinterpret_cast<float4*>(
          buf + 2 * ((e / kPieces) * kChannels + kVec * (e % kPieces)));
#pragma unroll
      for (int m = 0; m < kVec; m += 2)
        dst[m / 2] = make_float4(sct::to_float(ur[i][m]), sct::to_float(dr[i][m]),
                                 sct::to_float(ur[i][m + 1]), sct::to_float(dr[i][m + 1]));
    }
#pragma unroll
    for (int i = 0; i < kBC; ++i) {
      const int e = threadIdx.x + kThreads * i;
      buf[2 * kTile * kChannels + e] = sct::to_float(br[i]);
      buf[2 * kTile * kChannels + kTile * kDs + e] = sct::to_float(cr[i]);
    }
  };

  // tile k's y, from shared memory, in 16-byte pieces (the staging's
  // mapping)
  auto write_y = [&](int k) {
    const float* const yk = ys + (k & 1) * kTile * kChannels;
    const int t0 = k * kTile, nt = min(kTile, S - t0);
#pragma unroll
    for (int i = 0; i < kLd; ++i) {
      const int e = threadIdx.x + kThreads * i, r = e / kPieces, cc = kVec * (e % kPieces);
      if (e >= kPiecesTile || r >= nt) break;
      float v[kVec];
      load_words<kVec>(yk + r * kChannels + cc, v);
      T* const out = y + (row0 + t0 + r) * di + c0 + cc;
      if (vec_y && c0 + cc + kVec <= di) {
        store16<T, kVec>(out, v);
      } else {
#pragma unroll
        for (int m = 0; m < kVec; ++m)
          if (c0 + cc + m < di) out[m] = sct::from_float<T>(v[m]);
      }
    }
  };

  // the state before step t into hs (training only)
  const int nrec = (S + kRec - 1) / kRec;
  auto record = [&](int t) {
    if (!live) return;
    float* const out = hs + (((size_t)bb * nrec + t / kRec) * di + c) * kDs + g * kStates;
#pragma unroll
    for (int i = 0; i < kStates; ++i) out[i] = h[i];
  };

  fetch(0);
  stash(0);
  if (ntiles > 1) fetch(1);
  __syncthreads();

  for (int k = 0; k < ntiles; ++k) {
    if (k > 0) write_y(k - 1);
    const int nt = min(kTile, S - k * kTile);
    const float* const buf = sm + (k & 1) * kIn;
    const float2* const uv = reinterpret_cast<const float2*>(buf);
    const float* const Bs = buf + 2 * kTile * kChannels + g * kStates;
    const float* const Cs = Bs + kTile * kDs;
    float* const yk = ys + (k & 1) * kTile * kChannels;
    int r = 0;
    for (; r + kU <= nt; r += kU) {
      if (kRecord && r % kRec == 0) record(k * kTile + r);
      scan_steps<kU, kStates, kGroups, kDs>(uv, Bs, Cs, a, h, dd, yk, r, cl, g);
    }
    for (; r < nt; ++r) {
      if (kRecord && r % kRec == 0) record(k * kTile + r);
      scan_steps<1, kStates, kGroups, kDs>(uv, Bs, Cs, a, h, dd, yk, r, cl, g);
    }
    if (k + 1 < ntiles) {
      stash(k + 1);
      if (k + 2 < ntiles) fetch(k + 2);
    }
    __syncthreads();
  }
  write_y(ntiles - 1);
  if (live) {
    float* const out = hT + ((size_t)bb * di + c) * kDs + g * kStates;
    if constexpr (kStates % 4 == 0) {
#pragma unroll
      for (int i = 0; i < kStates; i += 4)
        reinterpret_cast<float4*>(out)[i / 4] = make_float4(h[i], h[i + 1], h[i + 2], h[i + 3]);
    } else {
#pragma unroll
      for (int i = 0; i < kStates; ++i) out[i] = h[i];
    }
  }
}

template <typename T, int kDs, int kStates>
cudaError_t launch_one(const void* u, const void* dt, const void* B, const void* C,
                       const void* A, const void* D, bool ad_bf16, void* y, void* hT,
                       void* hs, int b, int S, int di, const Strides& st, int smem,
                       cudaStream_t stream) {
  constexpr int kGroups = kDs / kStates;
  if (smem != smem_bytes(kDs)) return cudaErrorInvalidValue;
  auto kernel = hs != nullptr ? mamba_scan_kernel<T, kDs, kStates, true>
                              : mamba_scan_kernel<T, kDs, kStates, false>;
  cudaError_t err = sct::allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((di + kChannels - 1) / kChannels, b);
  kernel<<<grid, kChannels * kGroups, smem, stream>>>(
      static_cast<const T*>(u), static_cast<const T*>(dt), static_cast<const T*>(B),
      static_cast<const T*>(C), A, D, ad_bf16, static_cast<T*>(y), static_cast<float*>(hT),
      static_cast<float*>(hs), S, di, st);
  return cudaGetLastError();
}

// The (d_state, states a thread) pairs the kernel is built for: the plan's
// (kernels/mamba_scan.py:STATES).
template <typename T>
cudaError_t launch(const void* u, const void* dt, const void* B, const void* C, const void* A,
                   const void* D, bool ad_bf16, void* y, void* hT, void* hs, int b, int S,
                   int di, int ds, int states, const Strides& st, int smem,
                   cudaStream_t stream) {
#define SCT_SCAN(DS, NS)                                                                      \
  if (ds == DS && states == NS)                                                               \
    return launch_one<T, DS, NS>(u, dt, B, C, A, D, ad_bf16, y, hT, hs, b, S, di, st, smem,   \
                                 stream);
  SCT_SCAN(4, 4)
  SCT_SCAN(8, 4)
  SCT_SCAN(16, 4)
  SCT_SCAN(32, 8)
  SCT_SCAN(64, 16)
#undef SCT_SCAN
  return cudaErrorInvalidValue;
}

}  // namespace

// hs may be null (serving); rec is the caller's steps between recorded
// states, checked against the kernel's.
extern "C" int sct_mamba_scan(const void* u, const void* dt, const void* B, const void* C,
                              const void* A, const void* D, void* y, void* hT, void* hs, int b,
                              int S, int di, int ds, int states, int rec, int dtype,
                              int ad_dtype, long long b_batch, long long b_row,
                              long long c_batch, long long c_row, int smem, void* stream) {
  if (b <= 0 || di <= 0) return cudaSuccess;
  if (S <= 0 || (ad_dtype != sct::kFloat32 && ad_dtype != dtype) || rec != rec_steps(ds))
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Strides strides{b_batch, b_row, c_batch, c_row};
  const bool ad_bf16 = ad_dtype == sct::kBFloat16;
  if (dtype == sct::kFloat32)
    return launch<float>(u, dt, B, C, A, D, ad_bf16, y, hT, hs, b, S, di, ds, states, strides,
                         smem, st);
  if (dtype == sct::kBFloat16)
    return launch<__nv_bfloat16>(u, dt, B, C, A, D, ad_bf16, y, hT, hs, b, S, di, ds, states,
                                 strides, smem, st);
  return cudaErrorInvalidValue;
}
