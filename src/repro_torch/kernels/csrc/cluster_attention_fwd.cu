// Cluster-sparse attention forward with int8 bias buckets, for Hopper
// (sm_90a), in fp32 on CUDA cores.
//
// Replaces the TPU kernel `_cluster_kernel_biased` in
// src/repro/kernels/cluster_attention.py for fp32 inputs; bf16 inputs
// run on the tensor cores (cluster_attention_fwd_sm90.cu). The Elastic
// Computation Reformation kernel (paper §III-D) on the graph
// transformer's path. Same function: for each q-block row the layout
// lists the k-blocks to visit (`block_idx`, -1 padded); inside a visited
// block every score is `(q . k) * Dh^-0.5 + bias[h, bucket]`, bucket -1
// masks the position, and an online softmax in fp32 accumulates O. Rows
// with no unmasked entry write O = 0 and lse = 0.
//
// The reference's two dataflow rewrites are template flags, picked at
// launch from the schedule: `hoist_scale` multiplies the fp32 q tile by
// Dh^-0.5 once as it is staged, so a score is the bare dot; `fuse_bias`
// takes the bias table with one trailing sentinel column (-1e30, the
// wrapper's `extend_bias_table`) and looks every bucket up in it, the
// masked -1 landing on the sentinel (an unsigned min onto the last
// column), so `s + bias` replaces the select between the biased score
// and the mask. Both agree with the unfused lookup on buckets in {-1} U
// [0, nb), all that core/reformation.py emits. A row the sentinel masks
// entirely has a running max at or below -1e30 and stays dead.
//
// What bounds it on the card. At the serve shape (32768-node SBM,
// S=32800, H=KV=32, Dh=24, bq=bk=32, 13125 active blocks) q, k, v and O
// are about 100 MB each in fp32 and the active bucket tiles 13.4 MB:
// ~0.4 GB, 0.12 ms at 3.35 TB/s; the arithmetic (4 * 13125 * 32 * 32 *
// 24 * 32 = 41 GFLOP) is 0.62 ms at the 67 TFLOP/s CUDA-core rate, so
// in fp32 the function is bound by operations (TF32 on the tensor cores
// would miss the fp32 tolerances).
//
// What this design does about it: little; it is the simple, correct
// version, kept for fp32 (bf16, the dtype the model paths run, takes the
// tensor-core kernel). One CTA of 128 threads per (graph, head,
// q-block); all arithmetic on CUDA cores in fp32; tiles staged through
// shared memory with plain loads. The grid puts the heads of one q-block
// next to each other so they share the k/v rows and bucket tiles in L2.
// The row of the global token visits nearly every k-block while the
// other rows visit ~13, so a few CTAs run ~60x longer than the rest.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr float kNegInf = -1e30f;  // finite sentinel, as the TPU kernel

__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Shared-memory plan (floats, then the int8 bucket tile):
//   sQ   bq x Dh          the q tile, fp32 (times Dh^-0.5 under HOIST)
//   sK   bk x (Dh + 1)    k tile (padded row: conflict-free column reads)
//   sV   bk x (Dh + 1)
//   sS   bq x (bk + 1)    scores, then probabilities
//   sAcc bq x Dh          output accumulator
//   sM, sL, sC  bq        running max, running sum, correction
//   sBias nb (+1 FUSE)    this head's row of the bias table
//   sBkt bq x bk int8     bucket tile
__host__ __device__ inline size_t smem_floats(int bq, int bk, int dh,
                                              int nb) {
  return (size_t)bq * dh * 2 + (size_t)bk * (dh + 1) * 2 +
         (size_t)bq * (bk + 1) + (size_t)bq * 3 + (size_t)nb;
}

template <bool HOIST, bool FUSE>
__global__ void __launch_bounds__(kThreads)
cluster_attn_fwd_kernel(const float* __restrict__ q,
                        const float* __restrict__ k,
                        const float* __restrict__ v,
                        const int32_t* __restrict__ block_idx,
                        const int8_t* __restrict__ buckets,
                        const float* __restrict__ bias, float* __restrict__ out,
                        float* __restrict__ lse, int S, int H, int KV,
                        int dh, int nq, int mb, int bq, int bk, int nb,
                        int per_graph, float sm_scale) {
  extern __shared__ float smem[];
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  // heads vary fastest: the H CTAs of one q-block read the same k/v rows
  // and bucket tiles, back to back
  const int h = blockIdx.x % H;
  const int qi = (blockIdx.x / H) % nq;
  const int b = blockIdx.x / (H * nq);
  const int kvh = h / (H / KV);
  const int dhp = dh + 1, bkp = bk + 1;
  const int nbo = nb + FUSE;  // the operand's columns

  float* sQ = smem;
  float* sK = sQ + bq * dh;
  float* sV = sK + bk * dhp;
  float* sS = sV + bk * dhp;
  float* sAcc = sS + bq * bkp;
  float* sM = sAcc + bq * dh;
  float* sL = sM + bq;
  float* sC = sL + bq;
  float* sBias = sC + bq;
  int8_t* sBkt = reinterpret_cast<int8_t*>(sBias + nbo);

  const int gl = per_graph ? b : 0;
  const int32_t* idx_row = block_idx + ((size_t)gl * nq + qi) * mb;
  const int8_t* bkt_row = buckets + ((size_t)gl * nq + qi) * mb * bq * bk;

  for (int e = tid; e < bq * dh; e += kThreads) {
    const int r = e / dh, d = e - r * dh;
    const size_t s_pos = (size_t)b * S + (size_t)qi * bq + r;
    const float x = q[(s_pos * H + h) * dh + d];
    sQ[e] = HOIST ? x * sm_scale : x;
    sAcc[e] = 0.f;
  }
  for (int e = tid; e < bq; e += kThreads) {
    sM[e] = kNegInf;
    sL[e] = 0.f;
  }
  for (int e = tid; e < nbo; e += kThreads) sBias[e] = bias[h * nbo + e];

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
    for (int e = tid; e < bq * bk; e += kThreads) sBkt[e] = tile[e];
    __syncthreads();

    // scores: s = (q . k) * scale, then bias or mask
    for (int e = tid; e < bq * bk; e += kThreads) {
      const int r = e / bk, c = e - r * bk;
      const float* qr = sQ + r * dh;
      const float* kc = sK + c * dhp;
      float acc = 0.f;
      for (int d = 0; d < dh; ++d) acc = fmaf(qr[d], kc[d], acc);
      float s = HOIST ? acc : acc * sm_scale;
      const int bkt = sBkt[e];
      if (FUSE) {
        s += sBias[min((unsigned)bkt, (unsigned)nb)];  // -1 -> sentinel
      } else if (bkt >= 0) {
        s += sBias[min(bkt, nb - 1)];
      } else {
        s = kNegInf;
      }
      sS[r * bkp + c] = s;
    }
    __syncthreads();

    // online softmax, one warp per row
    for (int r = warp; r < bq; r += kThreads / 32) {
      float* sr = sS + r * bkp;
      float mx = kNegInf;
      for (int c = lane; c < bk; c += 32) mx = fmaxf(mx, sr[c]);
      mx = warp_max(mx);
      const float m_prev = sM[r];
      const float m_new = fmaxf(fmaxf(m_prev, mx), kNegInf);
      float sum = 0.f;
      for (int c = lane; c < bk; c += 32) {
        const float p = (m_new <= kNegInf) ? 0.f : expf(sr[c] - m_new);
        sr[c] = p;
        sum += p;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float corr = expf(fmaxf(m_prev, kNegInf) - m_new);
        sL[r] = sL[r] * corr + sum;
        sM[r] = m_new;
        sC[r] = corr;
      }
    }
    __syncthreads();

    // acc = acc * corr + p @ v
    for (int e = tid; e < bq * dh; e += kThreads) {
      const int r = e / dh, d = e - r * dh;
      const float* pr = sS + r * bkp;
      float a = sAcc[e] * sC[r];
      for (int c = 0; c < bk; ++c) a = fmaf(pr[c], sV[c * dhp + d], a);
      sAcc[e] = a;
    }
  }
  __syncthreads();

  for (int e = tid; e < bq * dh; e += kThreads) {
    const int r = e / dh, d = e - r * dh;
    const size_t s_pos = (size_t)b * S + (size_t)qi * bq + r;
    out[(s_pos * H + h) * dh + d] = sAcc[e] / fmaxf(sL[r], 1e-30f);
  }
  if (lse != nullptr) {
    for (int r = tid; r < bq; r += kThreads) {
      const float l = sL[r];
      lse[((size_t)b * H + h) * S + (size_t)qi * bq + r] =
          l > 0.f ? sM[r] + logf(fmaxf(l, 1e-30f)) : 0.f;
    }
  }
}

template <bool HOIST, bool FUSE>
int launch(const void* q, const void* k, const void* v, const void* block_idx,
           const void* buckets, const void* bias, void* out, void* lse,
           int B, int S, int H, int KV, int dh, int nq, int mb, int bq,
           int bk, int nb, int per_graph, float sm_scale,
           cudaStream_t stream) {
  const size_t smem = smem_floats(bq, bk, dh, nb + FUSE) * sizeof(float) +
                      (size_t)bq * bk;
  cudaError_t err = cudaFuncSetAttribute(
      cluster_attn_fwd_kernel<HOIST, FUSE>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const unsigned grid = (unsigned)B * nq * H;
  cluster_attn_fwd_kernel<HOIST, FUSE><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const int32_t*>(block_idx),
      static_cast<const int8_t*>(buckets), static_cast<const float*>(bias),
      static_cast<float*>(out), static_cast<float*>(lse), S, H, KV, dh, nq, mb,
      bq, bk, nb, per_graph, sm_scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32 (bfloat16, 1, has its own source and returns
// cudaErrorInvalidValue here). q (B,S,H,Dh), k/v (B,S,KV,Dh), out like
// q; block_idx (nq,mb) or (B,nq,mb) int32 (per_graph selects), buckets the
// matching (...,bq,bk) int8; bias (H,nb) fp32, (H,nb+1) with the sentinel
// column when fuse; lse (B*H,S) fp32 or NULL. hoist and fuse are the
// schedule's rewrites (0 or 1). Returns the CUDA error code of the launch
// (0 = launched); a tile set that needs more shared memory than the card
// allows fails as invalid value.
int cluster_attention_fwd(const void* q, const void* k, const void* v,
                          const void* block_idx, const void* buckets,
                          const void* bias, void* out, void* lse, int dtype,
                          int B, int S, int H, int KV, int dh, int nq, int mb,
                          int bq, int bk, int nb, int per_graph, int hoist,
                          int fuse, float sm_scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype != 0) return (int)cudaErrorInvalidValue;
#define FWD_LAUNCH(HO, FU)                                                 \
  return launch<HO, FU>(q, k, v, block_idx, buckets, bias, out, lse, B, S, \
                        H, KV, dh, nq, mb, bq, bk, nb, per_graph, sm_scale, \
                        st)
  if (hoist) {
    if (fuse) FWD_LAUNCH(true, true);
    FWD_LAUNCH(true, false);
  }
  if (fuse) FWD_LAUNCH(false, true);
  FWD_LAUNCH(false, false);
#undef FWD_LAUNCH
}

}  // extern "C"
