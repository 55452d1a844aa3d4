// Cluster-sparse attention backward with int8 bias buckets, for Hopper
// (sm_90a), in fp32 on CUDA cores: the dQ kernel and the dK/dV kernel.
//
// Replace the TPU kernels `_dq_kernel_biased` and `_dkv_kernel_biased` in
// src/repro/kernels/cluster_attention_bwd.py for fp32 inputs; bf16
// inputs run on the tensor cores (cluster_attention_bwd_dq_sm90.cu and
// cluster_attention_bwd_dkv_sm90.cu). The FlashAttention-style
// recomputation backward of the forward in cluster_attention_fwd.cu. Each
// kernel rebuilds a visited block's scores exactly as the forward built
// them (`(q . k) * Dh^-0.5`, then `+ bias[h, min(bucket, nb-1)]`, bucket
// -1 -> the finite sentinel -1e30), and with the forward's per-row
// logsumexp `lse` and `delta = rowsum(dO * O)` (both fp32, computed by
// the caller) forms
//   p  = exp(s - lse)          (dead rows carry lse = 0, so p = 0 there)
//   dp = dO . v
//   ds = p * (dp - delta)
// and accumulates, in fp32:
//   dQ kernel,  one CTA per (graph, head, q-block), walking the forward
//               layout `block_idx[b, qi, :]` (-1 slots skipped):
//               dq += scale * ds @ k, and the row's bucket sums of ds,
//               written as (B, H, nq, nb) fp32 partials that the caller
//               sums over graphs and q-rows into the bias_table gradient
//               (two stages, no float atomics: the result is
//               deterministic);
//   dK/dV kernel, one CTA per (graph, head, k-block), walking the
//               transposed layout `block_idx_t[b, ki, :]` of (q-row,
//               forward slot) pairs: dv += p^T @ dO,
//               dk += scale * ds^T @ q, per q-head (the GQA group sum is
//               the caller's).
//
// The forward's rewrites are template flags here too, so the scores are
// rebuilt exactly as the forward built them: under `hoist_scale` the q
// tile is staged times Dh^-0.5 (and dK, contracting that tile, takes no
// second scale); under `fuse_bias` the table carries the sentinel column
// and every bucket is looked up in it (biased_score). The bucket sums of
// dS stay at the table's own nb columns: a masked entry's dS is 0.
//
// What bounds them on the card. At the serve shape (32768-node SBM,
// S=32800, H=KV=32, Dh=24, bq=bk=32, 13125 active blocks) the dQ kernel
// does 6 * 13125 * 32 * 32 * 24 * 32 = 61.9 GFLOP and the dK/dV kernel
// 82.6 GFLOP: 0.92 and 1.23 ms at the 67 TFLOP/s CUDA-core rate, against
// ~0.5 GB of fp32 operands (~0.15 ms at 3.35 TB/s). In fp32 both are
// bound by operations (TF32 on the tensor cores would miss the fp32
// tolerances).
//
// What this design does about it: little; these are the simple, correct
// versions, kept for fp32 (bf16, the dtype the model paths run, takes the
// tensor-core kernels). 128 threads a CTA, all arithmetic on CUDA cores,
// tiles staged through shared memory with plain loads, heads fastest in
// the grid so the H CTAs of one block row share k/v rows in L2. The
// global token makes one heavy row (its q-block visits 755 of 1025
// k-blocks at the serve shape, 59x the mean) and one heavy column (674
// q-rows visit k-block 0, 53x the mean); their CTAs run that much longer
// while the grid drains.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr float kNegInf = -1e30f;  // finite sentinel, as the forward

__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// The forward's score of one entry, biased or masked: `dot` already
// scaled under HOIST; under FUSE `sBias` holds nb + 1 columns, the last
// the sentinel that bucket -1 lands on.
template <bool HOIST, bool FUSE>
__device__ __forceinline__ float biased_score(float dot, float sm_scale,
                                              int bkt, const float* sBias,
                                              int nb) {
  const float s = HOIST ? dot : dot * sm_scale;
  if (FUSE) return s + sBias[min((unsigned)bkt, (unsigned)nb)];
  return bkt >= 0 ? s + sBias[min(bkt, nb - 1)] : kNegInf;
}

// ------------------------------------------------------------- dQ kernel
//
// Shared-memory plan (floats, then the int8 bucket tile):
//   sQ, sDO   bq x Dh        this q-block's q (times Dh^-0.5 under HOIST)
//                            and dO, fp32
//   sK, sV    bk x (Dh + 1)  the visited k-block (padded rows)
//   sS        bq x (bk + 1)  ds of the visited block
//   sAcc      bq x Dh        dq accumulator
//   sLse, sDl bq             lse and delta of the rows
//   sBias     nbo            this head's row of the bias table (nb + FUSE)
//   sDb       kWarps x nb    per-warp bucket sums of ds
//   sBkt      bq x bk int8   bucket tile
__host__ __device__ inline size_t dq_smem_floats(int bq, int bk, int dh,
                                                 int nb, int nbo) {
  return (size_t)bq * dh * 3 + (size_t)bk * (dh + 1) * 2 +
         (size_t)bq * (bk + 1) + (size_t)bq * 2 + (size_t)nbo +
         (size_t)kWarps * nb;
}

template <bool HOIST, bool FUSE>
__global__ void __launch_bounds__(kThreads)
cluster_attn_dq_kernel(const float* __restrict__ q,
                       const float* __restrict__ k,
                       const float* __restrict__ v,
                       const float* __restrict__ dout,
                       const float* __restrict__ lse,
                       const float* __restrict__ delta,
                       const int32_t* __restrict__ block_idx,
                       const int8_t* __restrict__ buckets,
                       const float* __restrict__ bias,
                       float* __restrict__ dq,
                       float* __restrict__ dbias_part, int S, int H, int KV,
                       int dh, int nq, int mb, int bq, int bk, int nb,
                       int per_graph, float sm_scale) {
  extern __shared__ float smem[];
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int h = blockIdx.x % H;
  const int qi = (blockIdx.x / H) % nq;
  const int b = blockIdx.x / (H * nq);
  const int kvh = h / (H / KV);
  const int dhp = dh + 1, bkp = bk + 1;
  const int nbo = nb + FUSE;  // the bias operand's columns

  float* sQ = smem;
  float* sDO = sQ + bq * dh;
  float* sK = sDO + bq * dh;
  float* sV = sK + bk * dhp;
  float* sS = sV + bk * dhp;
  float* sAcc = sS + bq * bkp;
  float* sLse = sAcc + bq * dh;
  float* sDl = sLse + bq;
  float* sBias = sDl + bq;
  float* sDb = sBias + nbo;
  int8_t* sBkt = reinterpret_cast<int8_t*>(sDb + kWarps * nb);

  const int gl = per_graph ? b : 0;
  const int32_t* idx_row = block_idx + ((size_t)gl * nq + qi) * mb;
  const int8_t* bkt_row = buckets + ((size_t)gl * nq + qi) * mb * bq * bk;
  const size_t row0 = ((size_t)b * H + h) * S + (size_t)qi * bq;

  for (int e = tid; e < bq * dh; e += kThreads) {
    const int r = e / dh, d = e - r * dh;
    const size_t s_pos = (size_t)b * S + (size_t)qi * bq + r;
    const size_t off = (s_pos * H + h) * dh + d;
    sQ[e] = HOIST ? q[off] * sm_scale : q[off];
    sDO[e] = dout[off];
    sAcc[e] = 0.f;
  }
  for (int r = tid; r < bq; r += kThreads) {
    sLse[r] = lse[row0 + r];
    sDl[r] = delta[row0 + r];
  }
  for (int e = tid; e < nbo; e += kThreads) sBias[e] = bias[h * nbo + e];
  for (int e = tid; e < kWarps * nb; e += kThreads) sDb[e] = 0.f;

  const int n_el = bq * bk;
  const int per_thread = (n_el + kThreads - 1) / kThreads;
  for (int m = 0; m < mb; ++m) {
    const int blk = idx_row[m];  // uniform across the CTA
    if (blk < 0) continue;
    __syncthreads();  // the previous block's readers are done
    for (int e = tid; e < bk * dh; e += kThreads) {
      const int c = e / dh, d = e - c * dh;
      const size_t s_pos = (size_t)b * S + (size_t)blk * bk + c;
      const size_t off = (s_pos * KV + kvh) * dh + d;
      sK[c * dhp + d] = k[off];
      sV[c * dhp + d] = v[off];
    }
    const int8_t* tile = bkt_row + (size_t)m * bq * bk;
    for (int e = tid; e < n_el; e += kThreads) sBkt[e] = tile[e];
    __syncthreads();

    // ds of every entry; each thread owns entries tid + i * kThreads
    for (int e = tid; e < n_el; e += kThreads) {
      const int r = e / bk, c = e - r * bk;
      const float* qr = sQ + r * dh;
      const float* dor = sDO + r * dh;
      const float* kc = sK + c * dhp;
      const float* vc = sV + c * dhp;
      float qk = 0.f, dp = 0.f;
      for (int d = 0; d < dh; ++d) {
        qk = fmaf(qr[d], kc[d], qk);
        dp = fmaf(dor[d], vc[d], dp);
      }
      const float s =
          biased_score<HOIST, FUSE>(qk, sm_scale, sBkt[e], sBias, nb);
      const float p = expf(s - sLse[r]);
      sS[r * bkp + c] = p * (dp - sDl[r]);
    }
    // bucket sums of ds over the thread's own entries (no barrier needed:
    // each thread reads back what it wrote), then over the warp. Masked
    // entries have p = 0, so ds = 0, and clip onto bucket 0 harmlessly.
    for (int j = 0; j < nb; ++j) {
      float x = 0.f;
      for (int i = 0; i < per_thread; ++i) {
        const int e = tid + i * kThreads;
        if (e < n_el) {
          const int bc = min(max((int)sBkt[e], 0), nb - 1);
          const int r = e / bk, c = e - r * bk;
          if (bc == j) x += sS[r * bkp + c];
        }
      }
      x = warp_sum(x);
      if (lane == 0) sDb[warp * nb + j] += x;
    }
    __syncthreads();

    // dq += scale * ds @ k
    for (int e = tid; e < bq * dh; e += kThreads) {
      const int r = e / dh, d = e - r * dh;
      const float* sr = sS + r * bkp;
      float a = 0.f;
      for (int c = 0; c < bk; ++c) a = fmaf(sr[c], sK[c * dhp + d], a);
      sAcc[e] += sm_scale * a;
    }
  }
  __syncthreads();

  for (int e = tid; e < bq * dh; e += kThreads) {
    const int r = e / dh, d = e - r * dh;
    const size_t s_pos = (size_t)b * S + (size_t)qi * bq + r;
    dq[(s_pos * H + h) * dh + d] = sAcc[e];
  }
  float* db = dbias_part + (((size_t)b * H + h) * nq + qi) * nb;
  for (int j = tid; j < nb; j += kThreads) {
    float x = 0.f;
    for (int w = 0; w < kWarps; ++w) x += sDb[w * nb + j];
    db[j] = x;
  }
}

// ---------------------------------------------------------- dK/dV kernel
//
// Shared-memory plan (floats, then the int8 bucket tile):
//   sK, sV    bk x (Dh + 1)  this k-block's k and v, fp32
//   sQ, sDO   bq x Dh        the visiting q-block's q (times Dh^-0.5
//                            under HOIST) and dO
//   sP, sDS   bq x (bk + 1)  p and ds of the visited block
//   sDK, sDV  bk x Dh        accumulators
//   sLse, sDl bq
//   sBias     nbo            (nb + FUSE)
//   sBkt      bq x bk int8
__host__ __device__ inline size_t dkv_smem_floats(int bq, int bk, int dh,
                                                  int nbo) {
  return (size_t)bk * (dh + 1) * 2 + (size_t)bq * dh * 2 +
         (size_t)bq * (bk + 1) * 2 + (size_t)bk * dh * 2 + (size_t)bq * 2 +
         (size_t)nbo;
}

template <bool HOIST, bool FUSE>
__global__ void __launch_bounds__(kThreads)
cluster_attn_dkv_kernel(const float* __restrict__ q,
                        const float* __restrict__ k,
                        const float* __restrict__ v,
                        const float* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta,
                        const int32_t* __restrict__ block_idx_t,
                        const int8_t* __restrict__ buckets,
                        const float* __restrict__ bias, float* __restrict__ dk,
                        float* __restrict__ dv, int S, int H, int KV, int dh,
                        int nq, int mb, int nk, int mt, int bq, int bk,
                        int nb, int per_graph, int per_graph_t,
                        float sm_scale) {
  extern __shared__ float smem[];
  const int tid = threadIdx.x;
  const int h = blockIdx.x % H;
  const int ki = (blockIdx.x / H) % nk;
  const int b = blockIdx.x / (H * nk);
  const int kvh = h / (H / KV);
  const int dhp = dh + 1, bkp = bk + 1;
  const int nbo = nb + FUSE;  // the bias operand's columns

  float* sK = smem;
  float* sV = sK + bk * dhp;
  float* sQ = sV + bk * dhp;
  float* sDO = sQ + bq * dh;
  float* sP = sDO + bq * dh;
  float* sDS = sP + bq * bkp;
  float* sDK = sDS + bq * bkp;
  float* sDV = sDK + bk * dh;
  float* sLse = sDV + bk * dh;
  float* sDl = sLse + bq;
  float* sBias = sDl + bq;
  int8_t* sBkt = reinterpret_cast<int8_t*>(sBias + nbo);

  const int gl = per_graph ? b : 0;
  const int glt = per_graph_t ? b : 0;
  const int32_t* idxt_row = block_idx_t + ((size_t)glt * nk + ki) * mt * 2;
  const int8_t* bkt_graph = buckets + (size_t)gl * nq * mb * bq * bk;

  for (int e = tid; e < bk * dh; e += kThreads) {
    const int c = e / dh, d = e - c * dh;
    const size_t s_pos = (size_t)b * S + (size_t)ki * bk + c;
    const size_t off = (s_pos * KV + kvh) * dh + d;
    sK[c * dhp + d] = k[off];
    sV[c * dhp + d] = v[off];
    sDK[e] = 0.f;
    sDV[e] = 0.f;
  }
  for (int e = tid; e < nbo; e += kThreads) sBias[e] = bias[h * nbo + e];

  const int n_el = bq * bk;
  for (int t = 0; t < mt; ++t) {
    const int qrow = idxt_row[2 * t];  // uniform across the CTA
    const int slot = idxt_row[2 * t + 1];
    if (qrow < 0) continue;
    __syncthreads();  // the previous pair's readers are done
    for (int e = tid; e < bq * dh; e += kThreads) {
      const int r = e / dh, d = e - r * dh;
      const size_t s_pos = (size_t)b * S + (size_t)qrow * bq + r;
      const size_t off = (s_pos * H + h) * dh + d;
      sQ[e] = HOIST ? q[off] * sm_scale : q[off];
      sDO[e] = dout[off];
    }
    const size_t row0 = ((size_t)b * H + h) * S + (size_t)qrow * bq;
    for (int r = tid; r < bq; r += kThreads) {
      sLse[r] = lse[row0 + r];
      sDl[r] = delta[row0 + r];
    }
    const int8_t* tile =
        bkt_graph + ((size_t)qrow * mb + slot) * bq * bk;
    for (int e = tid; e < n_el; e += kThreads) sBkt[e] = tile[e];
    __syncthreads();

    for (int e = tid; e < n_el; e += kThreads) {
      const int r = e / bk, c = e - r * bk;
      const float* qr = sQ + r * dh;
      const float* dor = sDO + r * dh;
      const float* kc = sK + c * dhp;
      const float* vc = sV + c * dhp;
      float qk = 0.f, dp = 0.f;
      for (int d = 0; d < dh; ++d) {
        qk = fmaf(qr[d], kc[d], qk);
        dp = fmaf(dor[d], vc[d], dp);
      }
      const float s =
          biased_score<HOIST, FUSE>(qk, sm_scale, sBkt[e], sBias, nb);
      const float p = expf(s - sLse[r]);
      sP[r * bkp + c] = p;
      sDS[r * bkp + c] = p * (dp - sDl[r]);
    }
    __syncthreads();

    // dv += p^T @ dO, dk += scale * ds^T @ q (under HOIST sQ already
    // carries the scale)
    for (int e = tid; e < bk * dh; e += kThreads) {
      const int c = e / dh, d = e - c * dh;
      float av = 0.f, ak = 0.f;
      for (int r = 0; r < bq; ++r) {
        av = fmaf(sP[r * bkp + c], sDO[r * dh + d], av);
        ak = fmaf(sDS[r * bkp + c], sQ[r * dh + d], ak);
      }
      sDV[e] += av;
      sDK[e] += HOIST ? ak : sm_scale * ak;
    }
  }
  __syncthreads();

  for (int e = tid; e < bk * dh; e += kThreads) {
    const int c = e / dh, d = e - c * dh;
    const size_t s_pos = (size_t)b * S + (size_t)ki * bk + c;
    const size_t off = (s_pos * H + h) * dh + d;
    dk[off] = sDK[e];
    dv[off] = sDV[e];
  }
}

template <bool HOIST, bool FUSE>
int launch_dq(const void* q, const void* k, const void* v, const void* dout,
              const void* lse, const void* delta, const void* block_idx,
              const void* buckets, const void* bias, void* dq,
              void* dbias_part, int B, int S, int H, int KV, int dh, int nq,
              int mb, int bq, int bk, int nb, int per_graph, float sm_scale,
              cudaStream_t stream) {
  const size_t smem = dq_smem_floats(bq, bk, dh, nb, nb + FUSE) *
                          sizeof(float) +
                      (size_t)bq * bk;
  cudaError_t err = cudaFuncSetAttribute(
      cluster_attn_dq_kernel<HOIST, FUSE>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const unsigned grid = (unsigned)B * nq * H;
  cluster_attn_dq_kernel<HOIST, FUSE><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<const int32_t*>(block_idx),
      static_cast<const int8_t*>(buckets), static_cast<const float*>(bias),
      static_cast<float*>(dq), static_cast<float*>(dbias_part), S, H, KV, dh,
      nq, mb, bq, bk, nb, per_graph, sm_scale);
  return (int)cudaGetLastError();
}

template <bool HOIST, bool FUSE>
int launch_dkv(const void* q, const void* k, const void* v,
               const void* dout, const void* lse, const void* delta,
               const void* block_idx_t, const void* buckets,
               const void* bias, void* dk, void* dv, int B, int S, int H,
               int KV, int dh, int nq, int mb, int nk, int mt, int bq,
               int bk, int nb, int per_graph, int per_graph_t,
               float sm_scale, cudaStream_t stream) {
  const size_t smem = dkv_smem_floats(bq, bk, dh, nb + FUSE) * sizeof(float) +
                      (size_t)bq * bk;
  cudaError_t err = cudaFuncSetAttribute(
      cluster_attn_dkv_kernel<HOIST, FUSE>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const unsigned grid = (unsigned)B * nk * H;
  cluster_attn_dkv_kernel<HOIST, FUSE><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<const int32_t*>(block_idx_t),
      static_cast<const int8_t*>(buckets), static_cast<const float*>(bias),
      static_cast<float*>(dk), static_cast<float*>(dv), S, H, KV, dh, nq, mb,
      nk, mt,
      bq, bk, nb, per_graph, per_graph_t, sm_scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32 (bfloat16, 1, has its own source,
// cluster_attention_bwd_dq_sm90.cu, and returns cudaErrorInvalidValue
// here). q, dout and dq (B,S,H,Dh); k/v (B,S,KV,Dh); lse, delta (B*H,S)
// fp32; block_idx (nq,mb) or (B,nq,mb) int32 (per_graph selects),
// buckets the matching (...,bq,bk) int8; bias (H,nb) fp32, (H,nb+1) with
// the sentinel column when fuse; dbias_part (B,H,nq,nb) fp32. hoist and
// fuse are the forward's rewrites (0 or 1). Returns the CUDA error code
// of the launch (0 = launched).
int cluster_attention_bwd_dq(const void* q, const void* k, const void* v,
                             const void* dout, const void* lse,
                             const void* delta, const void* block_idx,
                             const void* buckets, const void* bias,
                             void* dq, void* dbias_part, int dtype, int B,
                             int S, int H, int KV, int dh, int nq, int mb,
                             int bq, int bk, int nb, int per_graph,
                             int hoist, int fuse, float sm_scale,
                             void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype != 0) return (int)cudaErrorInvalidValue;
#define DQ_LAUNCH(HO, FU)                                                  \
  return launch_dq<HO, FU>(q, k, v, dout, lse, delta, block_idx, buckets,  \
                           bias, dq, dbias_part, B, S, H, KV, dh, nq, mb,  \
                           bq, bk, nb, per_graph, sm_scale, st)
  if (hoist) {
    if (fuse) DQ_LAUNCH(true, true);
    DQ_LAUNCH(true, false);
  }
  if (fuse) DQ_LAUNCH(false, true);
  DQ_LAUNCH(false, false);
#undef DQ_LAUNCH
}

// As above (bfloat16 has its own source,
// cluster_attention_bwd_dkv_sm90.cu); block_idx_t (nk,mt,2) or
// (B,nk,mt,2) int32 (per_graph_t selects) lists (q-row, forward slot)
// pairs, -1 padded; dk/dv (B,S,H,Dh) fp32, per q-head.
int cluster_attention_bwd_dkv(const void* q, const void* k, const void* v,
                              const void* dout, const void* lse,
                              const void* delta, const void* block_idx_t,
                              const void* buckets, const void* bias,
                              void* dk, void* dv, int dtype, int B, int S,
                              int H, int KV, int dh, int nq, int mb, int nk,
                              int mt, int bq, int bk, int nb, int per_graph,
                              int per_graph_t, int hoist, int fuse,
                              float sm_scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype != 0) return (int)cudaErrorInvalidValue;
#define DKV_LAUNCH(HO, FU)                                                 \
  return launch_dkv<HO, FU>(q, k, v, dout, lse, delta, block_idx_t,        \
                            buckets, bias, dk, dv, B, S, H, KV, dh, nq,    \
                            mb, nk, mt, bq, bk, nb, per_graph,             \
                            per_graph_t, sm_scale, st)
  if (hoist) {
    if (fuse) DKV_LAUNCH(true, true);
    DKV_LAUNCH(true, false);
  }
  if (fuse) DKV_LAUNCH(false, true);
  DKV_LAUNCH(false, false);
#undef DKV_LAUNCH
}

}  // extern "C"
