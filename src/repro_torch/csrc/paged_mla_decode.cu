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
// 4-slot step at ~190 tokens a slot moves ~3 MB (q_lat in, o_lat out, the
// live pages) but does 2 * b * h * len * (2L + R) ~ 0.2 GFLOP of fp32 math.
//
// Design: a thread-block cluster of S blocks per (slot, group of 16 heads).
// Block z of the cluster reads its slot's block-table row itself and walks
// the live pages z, z + S, ...: it stages each page's ckv and kr rows once,
// in fp32, in shared memory, and updates its 16 heads from them: the scores
// (16 x page dot products of length L + R, one or more per thread, float4
// reads of rows padded by 4 floats against bank conflicts), an online
// softmax update per head, and the accumulator o_lat (16 heads x L), held in
// registers: each thread owns two adjacent latent columns of every head
// (L <= 512). Pages past the one holding position seq_lens[i] are fully
// masked and would contribute exactly zero, so the walk stops there. The S
// partial states (running max, running sum, accumulator) are then combined
// through distributed shared memory in rank order, each block finishing a
// share of the outputs. Inactive slots point at the null page with
// seq_len 0 and attend over one harmless position; head groups past h carry
// zero queries and write nothing.
//
// The cold variant (the streaming cold tier) adds int8 shadow pools ckv_q8 /
// kr_q8 (the pools' shapes), their per-page fp32 scales (P+1, L) / (P+1, R)
// and cold_flags (P+1,) int32. A flagged page stages q8 * scale, dequantized
// in fp32 (the reference's arithmetic), for the keys and the values both;
// every later instruction is shared with the hot kernel. It is the same
// template with kCold set, so with no page flagged its output is
// bit-identical to the hot kernel's by construction.
#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kHeads = 16;    // query heads a block updates from one staged page
constexpr int kCols = 2;      // adjacent latent columns a thread accumulates
constexpr int kPad = 4;       // floats of padding per staged row
constexpr float kNegInf = -1e30f;

// The cold tier's inputs; null pointers in the hot kernel.
struct ColdPools {
  const int8_t* ckv_q8;
  const float* ckv_scale;
  const int8_t* kr_q8;
  const float* kr_scale;
  const int* flags;
};

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

template <typename TQ, bool kCold>
__global__ void __launch_bounds__(kThreads)
paged_mla_decode_kernel(const TQ* __restrict__ q_lat, const TQ* __restrict__ q_rope,
                        const __nv_bfloat16* __restrict__ ckv_pool,
                        const __nv_bfloat16* __restrict__ kr_pool,
                        const int* __restrict__ block_table, const int* __restrict__ seq_lens,
                        TQ* __restrict__ out, int h, int lat, int rope, int page, int n_pages,
                        float scale, ColdPools cold) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int latp = lat + kPad, ropep = rope + kPad;
  float* qs = smem;                  // (kHeads, latp) q_lat; after the walk, o_lat
  float* qrs = qs + kHeads * latp;   // (kHeads, ropep) q_rope
  float* ks = qrs + kHeads * ropep;  // (page, latp) this page's latent rows
  float* krs = ks + page * latp;     // (page, ropep) this page's rope keys
  float* ps = krs + page * ropep;    // (kHeads, page) scores, then probabilities
  float* mrow = ps + kHeads * page;  // (kHeads,) running max
  float* lrow = mrow + kHeads;       // (kHeads,) running sum
  float* alpha = lrow + kHeads;      // (kHeads,) rescale of this page

  cg::cluster_group cluster = cg::this_cluster();
  const int splits = static_cast<int>(cluster.num_blocks());
  const int z = static_cast<int>(cluster.block_rank());
  const int i = blockIdx.x;          // slot
  const int h0 = blockIdx.y * kHeads;
  const int nh = min(kHeads, h - h0);
  const int tid = threadIdx.x;
  const int len = seq_lens[i];

  for (int t = tid; t < kHeads * lat; t += kThreads) {
    const int r = t / lat, d = t % lat;
    qs[r * latp + d] = r < nh ? sct::to_float(q_lat[((size_t)i * h + h0 + r) * lat + d]) : 0.f;
  }
  for (int t = tid; t < kHeads * rope; t += kThreads) {
    const int r = t / rope, d = t % rope;
    qrs[r * ropep + d] = r < nh ? sct::to_float(q_rope[((size_t)i * h + h0 + r) * rope + d]) : 0.f;
  }
  for (int t = tid; t < kHeads; t += kThreads) {
    mrow[t] = kNegInf;
    lrow[t] = 0.f;
  }
  const int c0 = tid * kCols;        // this thread's latent columns c0, c0 + 1
  const bool owns = c0 < lat;
  float acc[kHeads][kCols];
#pragma unroll
  for (int r = 0; r < kHeads; ++r) {
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[r][c] = 0.f;
  }

  const int last = min(n_pages - 1, len / page);
  for (int j = z; j <= last; j += splits) {
    const size_t phys = (size_t)block_table[(size_t)i * n_pages + j];
    __syncthreads();  // previous page fully consumed (and init visible)
    if (kCold && cold.flags[phys] != 0) {
      for (int t = tid; t < page * lat; t += kThreads) {
        const int p = t / lat, d = t % lat;
        ks[p * latp + d] = sct::to_float(cold.ckv_q8[(phys * page + p) * lat + d]) *
                           cold.ckv_scale[phys * lat + d];
      }
      for (int t = tid; t < page * rope; t += kThreads) {
        const int p = t / rope, d = t % rope;
        krs[p * ropep + d] = sct::to_float(cold.kr_q8[(phys * page + p) * rope + d]) *
                             cold.kr_scale[phys * rope + d];
      }
    } else {
      for (int t = tid; t < page * lat; t += kThreads) {
        const int p = t / lat, d = t % lat;
        ks[p * latp + d] = sct::to_float(ckv_pool[(phys * page + p) * lat + d]);
      }
      for (int t = tid; t < page * rope; t += kThreads) {
        const int p = t / rope, d = t % rope;
        krs[p * ropep + d] = sct::to_float(kr_pool[(phys * page + p) * rope + d]);
      }
    }
    __syncthreads();
    for (int t = tid; t < kHeads * page; t += kThreads) {
      const int r = t / page, p = t % page;
      const float4* qa = reinterpret_cast<const float4*>(qs + r * latp);
      const float4* ka = reinterpret_cast<const float4*>(ks + p * latp);
      float dl = 0.f;
      for (int d = 0; d < lat / 4; ++d) dl = dot4(qa[d], ka[d], dl);
      const float4* qb = reinterpret_cast<const float4*>(qrs + r * ropep);
      const float4* kb = reinterpret_cast<const float4*>(krs + p * ropep);
      float dr = 0.f;
      for (int d = 0; d < rope / 4; ++d) dr = dot4(qb[d], kb[d], dr);
      ps[t] = (j * page + p <= len) ? (dl + dr) * scale : kNegInf;
    }
    __syncthreads();
    for (int r = tid; r < kHeads; r += kThreads) {
      const float m_prev = mrow[r];
      float mx = m_prev;
      for (int p = 0; p < page; ++p) mx = fmaxf(mx, ps[r * page + p]);
      float sum = 0.f;
      for (int p = 0; p < page; ++p) {
        const float e = expf(ps[r * page + p] - mx);
        ps[r * page + p] = e;
        sum += e;
      }
      const float a = expf(m_prev - mx);
      lrow[r] = lrow[r] * a + sum;
      mrow[r] = mx;
      alpha[r] = a;
    }
    __syncthreads();
    if (owns) {
#pragma unroll
      for (int r = 0; r < kHeads; ++r) {
        const float a = alpha[r];
#pragma unroll
        for (int c = 0; c < kCols; ++c) acc[r][c] *= a;
      }
      for (int p = 0; p < page; ++p) {
        const float2 v = *reinterpret_cast<const float2*>(ks + p * latp + c0);
#pragma unroll
        for (int r = 0; r < kHeads; ++r) {
          const float w = ps[r * page + p];
          acc[r][0] = fmaf(w, v.x, acc[r][0]);
          acc[r][1] = fmaf(w, v.y, acc[r][1]);
        }
      }
    }
  }

  // the walk no longer reads q_lat: its rows take this block's accumulator
  if (owns) {
#pragma unroll
    for (int r = 0; r < kHeads; ++r) {
      qs[r * latp + c0] = acc[r][0];
      qs[r * latp + c0 + 1] = acc[r][1];
    }
  }
  // combine the cluster's partial states (page 0, always live, is rank 0's,
  // so the max is finite; a rank with no pages has m = -1e30 and weight 0)
  cluster.sync();
  const int total = nh * lat;
  const int share = (total + splits - 1) / splits;
  const int t_hi = min(total, (z + 1) * share);
  for (int t = z * share + tid; t < t_hi; t += kThreads) {
    const int r = t / lat, d = t % lat;
    float mx = kNegInf;
    for (int c = 0; c < splits; ++c) mx = fmaxf(mx, cluster.map_shared_rank(mrow, c)[r]);
    float l = 0.f, o = 0.f;
    for (int c = 0; c < splits; ++c) {
      const float w = expf(cluster.map_shared_rank(mrow, c)[r] - mx);
      l = fmaf(cluster.map_shared_rank(lrow, c)[r], w, l);
      o = fmaf(cluster.map_shared_rank(qs, c)[r * latp + d], w, o);
    }
    out[((size_t)i * h + h0 + r) * lat + d] = sct::from_float<TQ>(o / fmaxf(l, 1e-30f));
  }
  cluster.sync();  // partials stay alive until every rank has read them
}

template <typename TQ, bool kCold>
cudaError_t launch(const void* q_lat, const void* q_rope, const void* ckv_pool,
                   const void* kr_pool, const int* bt, const int* seq_lens, void* out, int b,
                   int h, int lat, int rope, int page, int n_pages, float scale,
                   ColdPools cold, cudaStream_t stream) {
  int splits = 1;  // cluster size: up to 8 blocks walk one sequence's pages
  while (splits < 8 && 2 * splits <= n_pages) splits <<= 1;
  const size_t floats = (size_t)(kHeads + page) * (lat + kPad + rope + kPad) +
                        (size_t)kHeads * page + 3 * (size_t)kHeads;
  const size_t smem = floats * sizeof(float);
  auto kernel = paged_mla_decode_kernel<TQ, kCold>;
  cudaError_t err = sct::allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(b, (h + kHeads - 1) / kHeads, splits);
  config.blockDim = dim3(kThreads, 1, 1);
  config.dynamicSmemBytes = smem;
  config.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = splits;
  config.attrs = attr;
  config.numAttrs = 1;
  err = cudaLaunchKernelEx(&config, kernel, static_cast<const TQ*>(q_lat),
                           static_cast<const TQ*>(q_rope),
                           static_cast<const __nv_bfloat16*>(ckv_pool),
                           static_cast<const __nv_bfloat16*>(kr_pool), bt, seq_lens,
                           static_cast<TQ*>(out), h, lat, rope, page, n_pages, scale, cold);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <bool kCold>
int launch_dtype(const void* q_lat, const void* q_rope, const void* ckv_pool,
                 const void* kr_pool, const void* block_table, const void* seq_lens, void* out,
                 int b, int h, int lat, int rope, int page, int n_pages, int q_dtype,
                 float scale, ColdPools cold, void* stream) {
  if (b <= 0 || h <= 0) return cudaSuccess;
  if (lat <= 0 || lat > kThreads * kCols || lat % 4 != 0 || rope < 0 || rope % 4 != 0 ||
      page <= 0 || n_pages <= 0)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* bt = static_cast<const int*>(block_table);
  const int* sl = static_cast<const int*>(seq_lens);
  if (q_dtype == sct::kBFloat16)
    return launch<__nv_bfloat16, kCold>(q_lat, q_rope, ckv_pool, kr_pool, bt, sl, out, b, h,
                                        lat, rope, page, n_pages, scale, cold, st);
  if (q_dtype == sct::kFloat32)
    return launch<float, kCold>(q_lat, q_rope, ckv_pool, kr_pool, bt, sl, out, b, h, lat,
                                rope, page, n_pages, scale, cold, st);
  return cudaErrorInvalidValue;
}

}  // namespace

// ckv_pool/kr_pool are bf16; q_lat, q_rope and out are in q_dtype. The latent
// width lat is a multiple of 4 up to 512, rope a multiple of 4.
extern "C" int sct_paged_mla_decode(const void* q_lat, const void* q_rope, const void* ckv_pool,
                                    const void* kr_pool, const void* block_table,
                                    const void* seq_lens, void* out, int b, int h, int lat,
                                    int rope, int page, int n_pages, int q_dtype, float scale,
                                    void* stream) {
  return launch_dtype<false>(q_lat, q_rope, ckv_pool, kr_pool, block_table, seq_lens, out, b,
                             h, lat, rope, page, n_pages, q_dtype, scale, ColdPools{}, stream);
}

// As sct_paged_mla_decode, plus the int8 shadow pools ckv_q8/kr_q8 (the pools'
// shapes), their fp32 scales (P+1, lat) / (P+1, rope) and cold_flags (P+1,)
// int32.
extern "C" int sct_paged_mla_decode_cold(const void* q_lat, const void* q_rope,
                                         const void* ckv_pool, const void* kr_pool,
                                         const void* ckv_q8, const void* ckv_scale,
                                         const void* kr_q8, const void* kr_scale,
                                         const void* cold_flags, const void* block_table,
                                         const void* seq_lens, void* out, int b, int h, int lat,
                                         int rope, int page, int n_pages, int q_dtype,
                                         float scale, void* stream) {
  const ColdPools cold{static_cast<const int8_t*>(ckv_q8), static_cast<const float*>(ckv_scale),
                       static_cast<const int8_t*>(kr_q8), static_cast<const float*>(kr_scale),
                       static_cast<const int*>(cold_flags)};
  return launch_dtype<true>(q_lat, q_rope, ckv_pool, kr_pool, block_table, seq_lens, out, b, h,
                            lat, rope, page, n_pages, q_dtype, scale, cold, stream);
}
