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
// bf16) the bytes are u, dt, dy read (three (b, S, di) bf16 tensors, 403 MB),
// the recorded states (134 MB), du and ddt written (268 MB), and the
// per-block partials of dB and dC (b, di / 32, S, ds fp32 each, 268 MB
// together) written and read back: ~1.34 GB, 0.40 ms at 3.35 TB/s. The
// operations are b S di ds elements (1.07e9), each an exp, the recomputed
// state (three products and a sum) and the reverse step (eight products and
// sums, e h taken from the recompute), and a share of the sums over the
// states and the channels: no tensor-core work.
//
// Design. A block takes the forward's 32 channels of one batch row, a
// channel's ds states over ds / kStates neighbouring lanes (the forward's
// layout, kernels/mamba_scan.py:STATES), and walks the recorded stretches of
// kRec steps from the last. For each it stages u, dt, dy, B and C in fp32
// in shared memory, recomputes the stretch's states from the recorded one
// (the forward's operations: the same bits) into shared memory with their
// exps, then runs the reverse recurrence step by step: g and the carried
// exp(dt A) g stay in registers, the sums over a channel's states are the
// forward's tree (a lane's states, then shuffles), and g overwrites the exp
// it no longer needs. After the stretch's barrier the block sums its 32
// channels' dy h and g du for every (step, state) as a tree over the
// channels into a partial of its own, and writes du and ddt from shared
// memory a row at a time. dA and dD accumulate in registers over the whole
// walk, one partial a batch row. A second launch adds the partials in a
// fixed order (block after block, batch row after batch row) and rounds to
// the outputs' dtypes. No atomics: two calls give the same bits. Every
// product and sum is its own rounded operation (__fmul_rn, __fadd_rn) and
// exp the accurate expf, as in the plain version, which takes the same
// order. Shared memory: 2 kRec x 32 x ds fp32 for the states and exps (64
// KB each at ds 16) and 5 kRec x 32 + 2 kRec ds for the rest, 152 KB at ds
// 16: one block an SM.
#include <algorithm>

#include "mamba.cuh"

using namespace sct::mamba;

namespace {

// fp32 words of a block's dynamic shared memory: u, dt, dy, du, ddt [kRec][32];
// B, C [kRec][ds]; the states and the exps (then g) [kRec][32][ds]
__host__ __device__ constexpr int bwd_words(int ds) {
  return rec_steps(ds) * (5 * kChannels + 2 * ds + 2 * kChannels * ds);
}

// the cap on the reduce launch's 256-thread blocks an SM: twice the 8 that
// fill an SM's 2048 threads; the grid-stride loop takes the rest
constexpr int kReduceBlocksPerSm = 16;

__device__ __forceinline__ void store_param(void* p, size_t i, float v, bool bf16) {
  if (bf16)
    static_cast<__nv_bfloat16*>(p)[i] = __float2bfloat16_rn(v);
  else
    static_cast<float*>(p)[i] = v;
}

template <typename T, int kDs, int kStates>
__global__ void __launch_bounds__(kChannels * (kDs / kStates))
mamba_scan_bwd_kernel(const T* __restrict__ u, const T* __restrict__ dt,
                      const T* __restrict__ B, const T* __restrict__ C,
                      const void* __restrict__ A, const void* __restrict__ D, bool ad_bf16,
                      const float* __restrict__ hs, const T* __restrict__ dy,
                      const float* __restrict__ dhT, T* __restrict__ du, T* __restrict__ ddt,
                      float* __restrict__ part_b, float* __restrict__ part_c,
                      float* __restrict__ part_a, float* __restrict__ part_d, int S, int di,
                      Strides st) {
  constexpr int kGroups = kDs / kStates;  // lanes a channel
  constexpr int kThreads = kChannels * kGroups;
  constexpr int kRec = rec_steps(kDs);
  constexpr int kRow = kRec * kChannels;
  extern __shared__ float4 smem_raw[];
  float* const su = reinterpret_cast<float*>(smem_raw);  // [kRec][32]
  float* const sdt = su + kRow;
  float* const sdy = sdt + kRow;
  float* const sdu = sdy + kRow;                          // du, then ddt, out
  float* const sddt = sdu + kRow;
  float* const sB = sddt + kRow;                          // [kRec][kDs]
  float* const sC = sB + kRec * kDs;
  float* const sH = sC + kRec * kDs;                      // [kRec][32][kDs]
  float* const sG = sH + kRow * kDs;                      // the exps, then g

  const int cl = threadIdx.x / kGroups, g = threadIdx.x % kGroups;
  const int blk = blockIdx.x, nblk = gridDim.x;
  const int c0 = blk * kChannels, c = c0 + cl;
  const int bb = blockIdx.y;
  const bool live = c < di;
  const int nrec = (S + kRec - 1) / kRec;
  const size_t row0 = (size_t)bb * S;
  const int s0 = g * kStates;  // the thread's first state

  float a[kStates], r[kStates], dA[kStates];
#pragma unroll
  for (int i = 0; i < kStates; ++i) {
    a[i] = live ? load_param(A, (size_t)c * kDs + s0 + i, ad_bf16) : 0.f;
    r[i] = live && dhT != nullptr ? dhT[((size_t)bb * di + c) * kDs + s0 + i] : 0.f;
    dA[i] = 0.f;
  }
  const float dd = live ? load_param(D, c, ad_bf16) : 0.f;
  float dD = 0.f;

  for (int k = nrec - 1; k >= 0; --k) {
    const int t0 = k * kRec, nt = min(kRec, S - t0);
    __syncthreads();  // the last stretch's readers are done with shared memory
    for (int e = threadIdx.x; e < kRow; e += kThreads) {
      const int rr = e / kChannels, cc = c0 + e % kChannels;
      const bool ok = rr < nt && cc < di;
      const size_t off = (row0 + t0 + rr) * di + cc;
      su[e] = ok ? sct::to_float(u[off]) : 0.f;
      sdt[e] = ok ? sct::to_float(dt[off]) : 0.f;
      sdy[e] = ok ? sct::to_float(dy[off]) : 0.f;
    }
    for (int e = threadIdx.x; e < kRec * kDs; e += kThreads) {
      const int rr = e / kDs, j = e % kDs;
      const bool ok = rr < nt;
      sB[e] = ok ? sct::to_float(B[bb * st.b_batch + (t0 + rr) * st.b_row + j]) : 0.f;
      sC[e] = ok ? sct::to_float(C[bb * st.c_batch + (t0 + rr) * st.c_row + j]) : 0.f;
    }
    float h0[kStates];
    const float* const rec = hs + (((size_t)bb * nrec + k) * di + c) * kDs + s0;
#pragma unroll
    for (int i = 0; i < kStates; ++i) h0[i] = live ? rec[i] : 0.f;
    __syncthreads();

    // the stretch's states and exps, as the forward computes them
    {
      float h[kStates];
#pragma unroll
      for (int i = 0; i < kStates; ++i) h[i] = h0[i];
      for (int j = 0; j < nt; ++j) {
        const float dtj = sdt[j * kChannels + cl];
        const float duj = __fmul_rn(dtj, su[j * kChannels + cl]);
        float* const hp = sH + (j * kChannels + cl) * kDs + s0;
        float* const ep = sG + (j * kChannels + cl) * kDs + s0;
#pragma unroll
        for (int i = 0; i < kStates; ++i) {
          const float e = expf(__fmul_rn(dtj, a[i]));
          h[i] = __fadd_rn(__fmul_rn(e, h[i]), __fmul_rn(duj, sB[j * kDs + s0 + i]));
          hp[i] = h[i];
          ep[i] = e;
        }
      }
    }

    // the reverse recurrence; g replaces the exp of its step
    for (int j = nt - 1; j >= 0; --j) {
      const float uj = su[j * kChannels + cl], dtj = sdt[j * kChannels + cl];
      const float dyj = sdy[j * kChannels + cl];
      float* const gp = sG + (j * kChannels + cl) * kDs + s0;
      float pb[kStates], pa[kStates];
#pragma unroll
      for (int i = 0; i < kStates; ++i) {
        const float e = gp[i];
        const float hprev = j > 0 ? sH[((j - 1) * kChannels + cl) * kDs + s0 + i] : h0[i];
        const float gt = __fadd_rn(__fmul_rn(dyj, sC[j * kDs + s0 + i]), r[i]);
        r[i] = __fmul_rn(e, gt);
        const float q = __fmul_rn(gt, __fmul_rn(e, hprev));
        pb[i] = __fmul_rn(gt, sB[j * kDs + s0 + i]);
        pa[i] = __fmul_rn(q, a[i]);
        dA[i] = __fadd_rn(dA[i], __fmul_rn(q, dtj));
        gp[i] = gt;
      }
      tree_sum<kStates>(pb);
      tree_sum<kStates>(pa);
      float sb = pb[0], sa = pa[0];
#pragma unroll
      for (int w = 1; w < kGroups; w *= 2) {
        sb = __fadd_rn(sb, __shfl_xor_sync(0xffffffffu, sb, w));
        sa = __fadd_rn(sa, __shfl_xor_sync(0xffffffffu, sa, w));
      }
      if (g == j % kGroups) {
        sdu[j * kChannels + cl] = __fadd_rn(__fmul_rn(dtj, sb), __fmul_rn(dyj, dd));
        sddt[j * kChannels + cl] = __fadd_rn(sa, __fmul_rn(uj, sb));
      }
      if (g == 0) dD = __fadd_rn(dD, __fmul_rn(dyj, uj));
    }
    __syncthreads();

    // the block's partial sums over its channels: dC_t = sum dy h_t, dB_t =
    // sum g du, a tree over the 32 channels
    for (int e = threadIdx.x; e < nt * kDs; e += kThreads) {
      const int j = e / kDs, s = e % kDs;
      float vc[kChannels], vb[kChannels];
#pragma unroll
      for (int cc = 0; cc < kChannels; ++cc) {
        const int w = j * kChannels + cc;
        vc[cc] = __fmul_rn(sdy[w], sH[w * kDs + s]);
        vb[cc] = __fmul_rn(sG[w * kDs + s], __fmul_rn(sdt[w], su[w]));
      }
      tree_sum<kChannels>(vc);
      tree_sum<kChannels>(vb);
      const size_t o = (((size_t)bb * nblk + blk) * S + t0 + j) * kDs + s;
      part_c[o] = vc[0];
      part_b[o] = vb[0];
    }
    for (int e = threadIdx.x; e < nt * kChannels; e += kThreads) {
      const int j = e / kChannels, cc = c0 + e % kChannels;
      if (cc < di) {
        const size_t off = (row0 + t0 + j) * di + cc;
        du[off] = sct::from_float<T>(sdu[e]);
        ddt[off] = sct::from_float<T>(sddt[e]);
      }
    }
  }
  if (live) {
    float* const pa = part_a + ((size_t)bb * di + c) * kDs + s0;
#pragma unroll
    for (int i = 0; i < kStates; ++i) pa[i] = dA[i];
    if (g == 0) part_d[(size_t)bb * di + c] = dD;
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

template <typename T, int kDs, int kStates>
cudaError_t launch_one(const void* u, const void* dt, const void* B, const void* C,
                       const void* A, const void* D, bool ad_bf16, const void* hs,
                       const void* dy, const void* dhT, void* du, void* ddt, void* part_b,
                       void* part_c, void* part_a, void* part_d, int b, int S, int di,
                       const Strides& st, int smem, cudaStream_t stream) {
  constexpr int kGroups = kDs / kStates;
  if (smem != 4 * bwd_words(kDs)) return cudaErrorInvalidValue;
  auto kernel = mamba_scan_bwd_kernel<T, kDs, kStates>;
  cudaError_t err = sct::allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((di + kChannels - 1) / kChannels, b);
  kernel<<<grid, kChannels * kGroups, smem, stream>>>(
      static_cast<const T*>(u), static_cast<const T*>(dt), static_cast<const T*>(B),
      static_cast<const T*>(C), A, D, ad_bf16, static_cast<const float*>(hs),
      static_cast<const T*>(dy), static_cast<const float*>(dhT), static_cast<T*>(du),
      static_cast<T*>(ddt), static_cast<float*>(part_b), static_cast<float*>(part_c),
      static_cast<float*>(part_a), static_cast<float*>(part_d), S, di, st);
  return cudaGetLastError();
}

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
  SCT_SCAN_BWD(4, 4)
  SCT_SCAN_BWD(8, 4)
  SCT_SCAN_BWD(16, 4)
  SCT_SCAN_BWD(32, 8)
  SCT_SCAN_BWD(64, 16)
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

}  // namespace

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
