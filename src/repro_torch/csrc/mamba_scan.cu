// Selective scan (Mamba's SSM) for Hopper: the prefill of every mamba layer
// of the hybrid family (jamba), returning the outputs and the final state
// the decode step continues from.
//
// Replaces the TPU kernel kernels/mamba_scan.py:mamba_scan_pallas of the JAX
// package (whose jnp twin is nn/mamba.py:_ssm_scan); the plain version is
// kernels/mamba_ref.py.
//
// u, dt (b, S, di) and B, C (b, S, ds) in T (fp32 or bf16); A (di, ds) and
// D (di,) fp32. Out: y (b, S, di) in T and the final state hT (b, di, ds)
// fp32. With h from zero:
//   h_t = exp(dt_t * A) * h_{t-1} + (dt_t * u_t) * B_t
//   y_t = sum_j h_t[., j] C_t[j] + u_t * D
// all in fp32, y rounded once a step: the Pallas kernel's arithmetic (its
// twin carries h in u's dtype instead; the two agree in fp32). Three things
// the TPU kernel does not do: it returns y only (the prefill needs hT), and
// it asserts that the chunk sizes divide S and di (the prompts are ragged:
// here any S >= 1 and any di, the edges masked).
//
// What bounds it: bytes. At the jamba-v0.1-52b prefill (b = 1, S <= 160,
// di = 8192, ds = 16, bf16) u, dt and y are 3 S di bf16 values and hT is
// di ds fp32: ~8.7 MB, 0.0026 ms at 3.35 TB/s; the ~6 ds flops and ds exps a
// (step, channel) are less.
//
// Design. The scan is sequential in t and independent over (batch,
// channel), so nothing carries between blocks. A channel's ds states are
// split over kLanes = 4 neighbouring threads (ds / 4 states and the matching
// row of A each, in registers), so a block of 128 threads holds 32 channels
// and the jamba prefill has 256 blocks for 132 SMs; the lanes sum their
// products of h and C and meet through two shuffles. A block stages a tile
// of kTT time steps at a time in shared memory: u and dt for its channels
// (neighbouring threads load neighbouring channels, coalesced), B and C
// (shared by every channel of the batch row), and y, written back coalesced
// after the tile.
// Every product and sum is its own rounded operation (__fmul_rn,
// __fadd_rn: no fused multiply-add) in the plain version's order, and exp is
// the accurate expf, so kernel and plain version agree bit for bit where
// their exp does, and a bf16 y rounds from the same fp32 value.
#include "common.cuh"

namespace {

constexpr int kLanes = 4;                     // threads a channel
constexpr int kChannels = 32;                 // channels a block
constexpr int kThreads = kLanes * kChannels;  // 128
constexpr int kTT = 32;                       // time steps a staged tile

template <typename T, int NS>
__global__ void __launch_bounds__(kThreads)
mamba_scan_kernel(const T* __restrict__ u, const T* __restrict__ dt,
                  const T* __restrict__ B, const T* __restrict__ C,
                  const float* __restrict__ A, const float* __restrict__ D,
                  T* __restrict__ y, float* __restrict__ hT, int S, int di) {
  constexpr int ds = NS * kLanes;
  __shared__ float us[kTT][kChannels];
  __shared__ float dts[kTT][kChannels];
  __shared__ float ys[kTT][kChannels];
  __shared__ float Bs[kTT][ds];
  __shared__ float Cs[kTT][ds];

  const int tid = threadIdx.x;
  const int cl = tid / kLanes, lane = tid % kLanes;
  const int c0 = blockIdx.x * kChannels, c = c0 + cl;
  const int b = blockIdx.y;
  const bool live = c < di;

  // lane holds states j = lane + kLanes * i (neighbouring lanes, neighbouring
  // banks when they read B and C)
  float a[NS], h[NS];
#pragma unroll
  for (int i = 0; i < NS; ++i) {
    a[i] = live ? A[(size_t)c * ds + lane + kLanes * i] : 0.f;
    h[i] = 0.f;
  }
  const float dd = live ? D[c] : 0.f;
  const size_t row0 = (size_t)b * S;

  for (int t0 = 0; t0 < S; t0 += kTT) {
    const int nt = min(kTT, S - t0);
    for (int e = tid; e < kTT * kChannels; e += kThreads) {
      const int r = e / kChannels, col = e % kChannels;
      const bool ok = r < nt && c0 + col < di;
      const size_t off = (row0 + t0 + r) * di + c0 + col;
      us[r][col] = ok ? sct::to_float(u[off]) : 0.f;
      dts[r][col] = ok ? sct::to_float(dt[off]) : 0.f;
    }
    for (int e = tid; e < kTT * ds; e += kThreads) {
      const int r = e / ds, j = e % ds;
      const size_t off = (row0 + t0 + r) * ds + j;
      Bs[r][j] = r < nt ? sct::to_float(B[off]) : 0.f;
      Cs[r][j] = r < nt ? sct::to_float(C[off]) : 0.f;
    }
    __syncthreads();
    for (int r = 0; r < nt; ++r) {
      const float uu = us[r][cl], dtt = dts[r][cl];
      const float du = __fmul_rn(dtt, uu);
      float acc = 0.f;
#pragma unroll
      for (int i = 0; i < NS; ++i) {
        const int j = lane + kLanes * i;
        const float dA = expf(__fmul_rn(dtt, a[i]));
        h[i] = __fadd_rn(__fmul_rn(dA, h[i]), __fmul_rn(du, Bs[r][j]));
        const float p = __fmul_rn(h[i], Cs[r][j]);
        acc = i == 0 ? p : __fadd_rn(acc, p);
      }
      // lanes (0 + 1) + (2 + 3): the plain version's pairing
      acc = __fadd_rn(acc, __shfl_xor_sync(0xffffffffu, acc, 1));
      acc = __fadd_rn(acc, __shfl_xor_sync(0xffffffffu, acc, 2));
      if (lane == 0) ys[r][cl] = __fadd_rn(acc, __fmul_rn(uu, dd));
    }
    __syncthreads();
    for (int e = tid; e < kTT * kChannels; e += kThreads) {
      const int r = e / kChannels, col = e % kChannels;
      if (r < nt && c0 + col < di)
        y[(row0 + t0 + r) * di + c0 + col] = sct::from_float<T>(ys[r][col]);
    }
  }
  if (live) {
#pragma unroll
    for (int i = 0; i < NS; ++i) hT[((size_t)b * di + c) * ds + lane + kLanes * i] = h[i];
  }
}

template <typename T>
cudaError_t launch(const void* u, const void* dt, const void* B, const void* C,
                   const void* A, const void* D, void* y, void* hT, int b, int S, int di,
                   int ds, cudaStream_t st) {
  const dim3 grid((di + kChannels - 1) / kChannels, b);
  const T* uu = static_cast<const T*>(u);
  const T* dtt = static_cast<const T*>(dt);
  const T* BB = static_cast<const T*>(B);
  const T* CC = static_cast<const T*>(C);
  const float* AA = static_cast<const float*>(A);
  const float* DD = static_cast<const float*>(D);
  T* yy = static_cast<T*>(y);
  float* hh = static_cast<float*>(hT);
  switch (ds) {
    case 4:
      mamba_scan_kernel<T, 1><<<grid, kThreads, 0, st>>>(uu, dtt, BB, CC, AA, DD, yy, hh, S, di);
      break;
    case 8:
      mamba_scan_kernel<T, 2><<<grid, kThreads, 0, st>>>(uu, dtt, BB, CC, AA, DD, yy, hh, S, di);
      break;
    case 16:
      mamba_scan_kernel<T, 4><<<grid, kThreads, 0, st>>>(uu, dtt, BB, CC, AA, DD, yy, hh, S, di);
      break;
    case 32:
      mamba_scan_kernel<T, 8><<<grid, kThreads, 0, st>>>(uu, dtt, BB, CC, AA, DD, yy, hh, S, di);
      break;
    case 64:
      mamba_scan_kernel<T, 16><<<grid, kThreads, 0, st>>>(uu, dtt, BB, CC, AA, DD, yy, hh, S,
                                                          di);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" int sct_mamba_scan(const void* u, const void* dt, const void* B, const void* C,
                              const void* A, const void* D, void* y, void* hT, int b, int S,
                              int di, int ds, int dtype, void* stream) {
  if (b <= 0 || di <= 0) return cudaSuccess;
  if (S <= 0) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == sct::kFloat32) return launch<float>(u, dt, B, C, A, D, y, hT, b, S, di, ds, st);
  if (dtype == sct::kBFloat16)
    return launch<__nv_bfloat16>(u, dt, B, C, A, D, y, hT, b, S, di, ds, st);
  return cudaErrorInvalidValue;
}
