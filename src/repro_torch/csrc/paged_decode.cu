// Paged GQA flash-decode for Hopper: one-token attention straight from the
// paged KV pools, walking each slot's block table inside the kernel.
//
// Replaces the TPU kernels kernels/paged_decode.py:paged_gqa_decode_pallas
// and paged_gqa_decode_cold_pallas of the JAX package.
//
// q (b, kvh, rep, hd) in TQ (fp32 or bf16); k/v pools (P+1, page, kvh, hd)
// in bf16 (the port keeps KV pools in bf16 whatever the compute dtype);
// block_table (b, n_pages) int32; seq_lens (b,)
// int32; out (b, kvh, rep, hd) in TQ. Position pos of slot i is valid when
// pos <= seq_lens[i] (the token appended this step sits at seq_lens[i]).
// Scores, softmax and the accumulator are fp32 with one rounding at the
// output: the fp32 decode contract of nn/attention.py that keeps bf16
// greedy decode token-identical across the decode paths.
//
// What bounds it: the bytes of the live K/V pages (2 * len * kvh * hd * 2
// bytes per slot); the arithmetic is 4 flops per byte. Memory-bound.
//
// Design: a thread-block cluster of S blocks per (slot, kv head). The TPU
// kernel walks the pages along a sequential grid axis and gets physical
// page ids by scalar prefetch into its BlockSpec index map. Here block z of
// the cluster reads its slot's block-table row itself and walks the live
// pages z, z + S, ...: it stages each page's K/V rows for its head in
// shared memory and runs an online-softmax update for the rep query heads
// that share the kv head (K/V are read once for the whole group). Pages
// past the one holding position seq_lens[i] are fully masked and would
// contribute exactly zero, so the walk stops there. The S partial states
// (running max, running sum, accumulator) are then combined through
// distributed shared memory, in rank order, each block finishing a share
// of the outputs. S spreads one sequence's pages over up to 8 SMs: at
// decode there are only slots x kv heads (32) sequences of work. Inactive
// slots point at the null page with seq_len 0 and attend over one harmless
// position.
//
// The cold variant (the streaming cold tier) adds int8 shadow pools k_q8 /
// v_q8 (P+1, page, kvh, hd), their per-page fp32 scales (P+1, kvh, hd) and
// cold_flags (P+1,) int32. Each block reads the flag of the physical page it
// is about to stage, once per page; a flagged page stages q8 * scale,
// dequantized in registers in fp32 (the reference's arithmetic), and the
// rest of the walk is unchanged. It stays bound by bytes: a cold row costs
// one byte an element in place of two, plus the page's scales, and the
// flags one int a page. The kernel is the same template with kCold set, so
// with no page flagged its staging stores the same values and every later
// instruction is shared: its output is bit-identical to the hot kernel's by
// construction.
#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 128;
constexpr float kNegInf = -1e30f;

// The cold tier's inputs; null pointers in the hot kernel.
struct ColdPools {
  const int8_t* k_q8;
  const float* k_scale;
  const int8_t* v_q8;
  const float* v_scale;
  const int* flags;
};

template <typename TQ, bool kCold>
__global__ void __launch_bounds__(kThreads)
paged_gqa_decode_kernel(const TQ* __restrict__ q, const __nv_bfloat16* __restrict__ k_pool,
                        const __nv_bfloat16* __restrict__ v_pool, const int* __restrict__ block_table,
                        const int* __restrict__ seq_lens, TQ* __restrict__ out, int kvh,
                        int rep, int hd, int page, int n_pages, float scale, ColdPools cold) {
  extern __shared__ float smem[];
  const int hdp = hd + 1;            // padded K row stride (bank conflicts)
  float* qs = smem;                  // (rep, hd)
  float* acc = qs + rep * hd;        // (rep, hd)
  float* ks = acc + rep * hd;        // (page, hdp)
  float* vs = ks + page * hdp;       // (page, hd)
  float* ps = vs + page * hd;        // (rep, page) scores, then probabilities
  float* mrow = ps + rep * page;     // (rep,) running max
  float* lrow = mrow + rep;          // (rep,) running sum
  float* alpha = lrow + rep;         // (rep,) rescale of this page

  cg::cluster_group cluster = cg::this_cluster();
  const int splits = static_cast<int>(cluster.num_blocks());
  const int z = static_cast<int>(cluster.block_rank());
  const int i = blockIdx.x;          // slot
  const int g = blockIdx.y;          // kv head
  const int tid = threadIdx.x;
  const int len = seq_lens[i];
  const size_t head_off = ((size_t)i * kvh + g) * rep * hd;

  for (int t = tid; t < rep * hd; t += kThreads) {
    qs[t] = sct::to_float(q[head_off + t]);
    acc[t] = 0.f;
  }
  for (int t = tid; t < rep; t += kThreads) {
    mrow[t] = kNegInf;
    lrow[t] = 0.f;
  }
  const int last = min(n_pages - 1, len / page);
  for (int j = z; j <= last; j += splits) {
    const size_t phys = (size_t)block_table[(size_t)i * n_pages + j];
    __syncthreads();  // previous page fully consumed (and init visible)
    if (kCold && cold.flags[phys] != 0) {
      const float* ksc = cold.k_scale + (phys * kvh + g) * hd;
      const float* vsc = cold.v_scale + (phys * kvh + g) * hd;
      for (int t = tid; t < page * hd; t += kThreads) {
        const int p = t / hd, d = t % hd;
        const size_t off = ((phys * page + p) * kvh + g) * hd + d;
        ks[p * hdp + d] = sct::to_float(cold.k_q8[off]) * ksc[d];
        vs[p * hd + d] = sct::to_float(cold.v_q8[off]) * vsc[d];
      }
    } else {
      for (int t = tid; t < page * hd; t += kThreads) {
        const int p = t / hd, d = t % hd;
        const size_t off = ((phys * page + p) * kvh + g) * hd + d;
        ks[p * hdp + d] = sct::to_float(k_pool[off]);
        vs[p * hd + d] = sct::to_float(v_pool[off]);
      }
    }
    __syncthreads();
    for (int t = tid; t < rep * page; t += kThreads) {
      const int r = t / page, p = t % page;
      float dot = 0.f;
      for (int d = 0; d < hd; ++d) dot = fmaf(qs[r * hd + d], ks[p * hdp + d], dot);
      ps[t] = (j * page + p <= len) ? dot * scale : kNegInf;
    }
    __syncthreads();
    for (int r = tid; r < rep; r += kThreads) {
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
    for (int t = tid; t < rep * hd; t += kThreads) {
      const int r = t / hd, d = t % hd;
      float o = acc[t] * alpha[r];
      for (int p = 0; p < page; ++p) o = fmaf(ps[r * page + p], vs[p * hd + d], o);
      acc[t] = o;
    }
  }

  // combine the cluster's partial states (page 0, always live, is rank 0's,
  // so the max is finite; a rank with no pages has m = -1e30 and weight 0)
  cluster.sync();
  const int share = (rep * hd + splits - 1) / splits;
  const int t_hi = min(rep * hd, (z + 1) * share);
  for (int t = z * share + tid; t < t_hi; t += kThreads) {
    const int r = t / hd;
    float mx = kNegInf;
    for (int c = 0; c < splits; ++c) mx = fmaxf(mx, cluster.map_shared_rank(mrow, c)[r]);
    float l = 0.f, o = 0.f;
    for (int c = 0; c < splits; ++c) {
      const float w = expf(cluster.map_shared_rank(mrow, c)[r] - mx);
      l = fmaf(cluster.map_shared_rank(lrow, c)[r], w, l);
      o = fmaf(cluster.map_shared_rank(acc, c)[t], w, o);
    }
    out[head_off + t] = sct::from_float<TQ>(o / fmaxf(l, 1e-30f));
  }
  cluster.sync();  // partials stay alive until every rank has read them
}

template <typename TQ, bool kCold>
cudaError_t launch(const void* q, const void* k_pool, const void* v_pool, const int* bt,
                   const int* seq_lens, void* out, int b, int kvh, int rep, int hd, int page,
                   int n_pages, float scale, ColdPools cold, cudaStream_t stream) {
  int splits = 1;  // cluster size: up to 8 blocks walk one sequence's pages
  while (splits < 8 && 2 * splits <= n_pages) splits <<= 1;
  const size_t floats = (size_t)2 * rep * hd + (size_t)page * (2 * hd + 1) +
                        (size_t)rep * page + 3 * (size_t)rep;
  const size_t smem = floats * sizeof(float);
  auto kernel = paged_gqa_decode_kernel<TQ, kCold>;
  cudaError_t err = sct::allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(b, kvh, splits);
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
  err = cudaLaunchKernelEx(&config, kernel, static_cast<const TQ*>(q),
                           static_cast<const __nv_bfloat16*>(k_pool),
                           static_cast<const __nv_bfloat16*>(v_pool), bt,
                           seq_lens, static_cast<TQ*>(out), kvh, rep, hd, page, n_pages, scale,
                           cold);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
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
