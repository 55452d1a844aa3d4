// Cluster-sparse attention forward with int8 bias buckets, for Hopper (sm_90a).
//
// Replaces the TPU kernel `_cluster_kernel_biased` in
// src/repro/kernels/cluster_attention.py: the Elastic Computation
// Reformation kernel (paper §III-D) on the graph transformer's path. Same
// function: for each q-block row the layout lists the k-blocks to visit
// (`block_idx`, -1 padded); inside a visited block every score is
// `(q . k) * Dh^-0.5 + bias[h, bucket]`, bucket -1 masks the position, and
// an online softmax in fp32 accumulates O. Rows with no unmasked entry
// write O = 0 and lse = 0.
//
// What bounds it on the card. At the serve shape (32768-node SBM, S=32800,
// H=KV=32, Dh=24, bq=bk=32, 13125 active blocks) q, k, v and O are about
// 50 MB each in bf16 and the active bucket tiles 13.4 MB: ~215 MB moved,
// ~64 us at 3.35 TB/s. The arithmetic (4 * 13125 * 32 * 32 * 24 * 32 = 41
// GFLOP) is ~42 us at the bf16 tensor-core peak, so the function is
// memory-bound.
//
// What this design does about it: nothing yet. It is the simple, correct
// version: one CTA of 128 threads per (graph, head, q-block); all
// arithmetic on CUDA cores in fp32; tiles staged through shared memory
// with plain loads (no TMA, no wgmma, no double buffering). The grid puts
// the heads of one q-block next to each other so they share the k/v rows
// and bucket tiles in L2. The row of the global token visits nearly every
// k-block while the other rows visit ~13, so a few CTAs run ~60x longer
// than the rest; splitting heavy rows across CTAs is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr float kNegInf = -1e30f;  // finite sentinel, as the TPU kernel

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16
from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as torch's cast
}

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
//   sQ   bq x Dh          the q tile, fp32
//   sK   bk x (Dh + 1)    k tile (padded row: conflict-free column reads)
//   sV   bk x (Dh + 1)
//   sS   bq x (bk + 1)    scores, then probabilities
//   sAcc bq x Dh          output accumulator
//   sM, sL, sC  bq        running max, running sum, correction
//   sBias nb              this head's row of the bias table
//   sBkt bq x bk int8     bucket tile
__host__ __device__ inline size_t smem_floats(int bq, int bk, int dh,
                                              int nb) {
  return (size_t)bq * dh * 2 + (size_t)bk * (dh + 1) * 2 +
         (size_t)bq * (bk + 1) + (size_t)bq * 3 + (size_t)nb;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
cluster_attn_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v,
                        const int32_t* __restrict__ block_idx,
                        const int8_t* __restrict__ buckets,
                        const float* __restrict__ bias, T* __restrict__ out,
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

  float* sQ = smem;
  float* sK = sQ + bq * dh;
  float* sV = sK + bk * dhp;
  float* sS = sV + bk * dhp;
  float* sAcc = sS + bq * bkp;
  float* sM = sAcc + bq * dh;
  float* sL = sM + bq;
  float* sC = sL + bq;
  float* sBias = sC + bq;
  int8_t* sBkt = reinterpret_cast<int8_t*>(sBias + nb);

  const int gl = per_graph ? b : 0;
  const int32_t* idx_row = block_idx + ((size_t)gl * nq + qi) * mb;
  const int8_t* bkt_row = buckets + ((size_t)gl * nq + qi) * mb * bq * bk;

  for (int e = tid; e < bq * dh; e += kThreads) {
    const int r = e / dh, d = e - r * dh;
    const size_t s_pos = (size_t)b * S + (size_t)qi * bq + r;
    sQ[e] = to_f32(q[(s_pos * H + h) * dh + d]);
    sAcc[e] = 0.f;
  }
  for (int e = tid; e < bq; e += kThreads) {
    sM[e] = kNegInf;
    sL[e] = 0.f;
  }
  for (int e = tid; e < nb; e += kThreads) sBias[e] = bias[h * nb + e];

  for (int m = 0; m < mb; ++m) {
    const int blk = idx_row[m];  // uniform across the CTA
    if (blk < 0) continue;
    __syncthreads();  // the previous block's readers are done
    for (int e = tid; e < bk * dh; e += kThreads) {
      const int c = e / dh, d = e - c * dh;
      const size_t s_pos = (size_t)b * S + (size_t)blk * bk + c;
      const size_t off = (s_pos * KV + kvh) * dh + d;
      sK[c * dhp + d] = to_f32(k[off]);
      sV[c * dhp + d] = to_f32(v[off]);
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
      float s = acc * sm_scale;
      const int bkt = sBkt[e];
      if (bkt >= 0) {
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
    out[(s_pos * H + h) * dh + d] =
        from_f32<T>(sAcc[e] / fmaxf(sL[r], 1e-30f));
  }
  if (lse != nullptr) {
    for (int r = tid; r < bq; r += kThreads) {
      const float l = sL[r];
      lse[((size_t)b * H + h) * S + (size_t)qi * bq + r] =
          l > 0.f ? sM[r] + logf(fmaxf(l, 1e-30f)) : 0.f;
    }
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* block_idx,
           const void* buckets, const void* bias, void* out, void* lse,
           int B, int S, int H, int KV, int dh, int nq, int mb, int bq,
           int bk, int nb, int per_graph, float sm_scale,
           cudaStream_t stream) {
  const size_t smem = smem_floats(bq, bk, dh, nb) * sizeof(float) +
                      (size_t)bq * bk;
  cudaError_t err = cudaFuncSetAttribute(
      cluster_attn_fwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const unsigned grid = (unsigned)B * nq * H;
  cluster_attn_fwd_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int32_t*>(block_idx),
      static_cast<const int8_t*>(buckets), static_cast<const float*>(bias),
      static_cast<T*>(out), static_cast<float*>(lse), S, H, KV, dh, nq, mb,
      bq, bk, nb, per_graph, sm_scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. q (B,S,H,Dh), k/v (B,S,KV,Dh), out like
// q; block_idx (nq,mb) or (B,nq,mb) int32 (per_graph selects), buckets the
// matching (...,bq,bk) int8; bias (H,nb) fp32; lse (B*H,S) fp32 or NULL.
// Returns the CUDA error code of the launch (0 = launched); a tile set
// that needs more shared memory than the card allows fails as invalid value.
int cluster_attention_fwd(const void* q, const void* k, const void* v,
                          const void* block_idx, const void* buckets,
                          const void* bias, void* out, void* lse, int dtype,
                          int B, int S, int H, int KV, int dh, int nq, int mb,
                          int bq, int bk, int nb, int per_graph,
                          float sm_scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(q, k, v, block_idx, buckets, bias, out, lse, B, S,
                         H, KV, dh, nq, mb, bq, bk, nb, per_graph, sm_scale,
                         st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k, v, block_idx, buckets, bias, out, lse,
                                 B, S, H, KV, dh, nq, mb, bq, bk, nb,
                                 per_graph, sm_scale, st);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
