// Unbiased cluster-sparse attention forward, optional positional causal
// mask, for Hopper (sm_90a), for fp32 inputs.
//
// Replaces the TPU kernel `_cluster_kernel` in
// src/repro/kernels/cluster_attention.py for fp32 q, k and v: the token
// LM's local+global layout (core/reformation.lm_local_global_layout,
// bq = bk = 128) and the mask-free graph batch (launch/graph_dryrun.py,
// bq = bk = 128, one layout per graph); bf16 inputs go to the
// tensor-core kernel of cluster_attention_unbiased_fwd_sm90.cu. For
// each q-block row the layout lists the k-blocks to visit (`block_idx`,
// -1 padded; shared by the batch, or one per sequence `idx_stride`
// entries apart); inside a visited block every score is `(q . k) * Dh^-0.5`
// in fp32, masked to the finite sentinel -1e30 where `qpos < kpos` when
// causal, and an online softmax in fp32 accumulates O. Rows with no
// unmasked entry write O = 0 and lse = 0. No buckets, no bias.
//
// The reference's `hoist_scale` rewrite is a template flag, picked at
// launch from the schedule: the q tile is staged times Dh^-0.5 once, so
// a score is the bare dot product.
//
// What bounds it on the card. At the Qwen3-0.6B training shape (S=16384,
// H=16 over KV=8, Dh=128, window 4096 + one global block: 3696 visited
// blocks of 128 x 128, the causal diagonal blocks half full) the score
// and PV products are ~488 GFLOP, 7.3 ms at the fp32 CUDA-core peak of
// 67 TFLOP/s, against ~0.4 GB of fp32 q, k, v, O and lse (0.12 ms at
// 3.35 TB/s): bound by operations.
//
// Head dims. Dh a multiple of 8 up to 64 (the graph models': Slim 8,
// GT 16, Large 24) or 128: a tile row holds DP = Dh rounded up to 16
// columns (unbiased_tiles.cuh), so the thread layout stays 16 threads a
// row; the pad columns are cleared once and never stored.
//
// What this design does about it. The slice-1/2 kernels keep a whole
// block's fp32 tiles in shared memory, which at bq = bk = Dh = 128 would
// need 330 KB, more than a CTA may have (227 KB). Here a CTA of 256
// threads owns 64 q-rows of one q-block for one head (two CTAs per
// q-block) and streams the visited k-blocks through in 64-column chunks:
// q tile, k and v chunks (64 x (Dh + 4) fp32 each) and the 64 x 68
// probability tile, 118,784 bytes at Dh = 128, so one CTA per SM (ptxas
// -v for sm_90a: 144 registers a thread at Dh 128, 128 at 64, no
// spills). Each thread holds a 4 x 4 block of scores and a 4 x Dh/16
// block of the output accumulator in registers (unbiased_tiles.cuh), so
// a float4 read from shared memory feeds four multiply-adds instead of
// one. All arithmetic is fp32 on CUDA cores: TF32 on the tensor cores
// would miss the fp32 tolerances.
// Chunks that the causal mask empties for all 64 rows are skipped. Heads
// vary fastest in the grid, so the CTAs of one q-block read the same k/v
// rows through L2.

#include "unbiased_tiles.cuh"

namespace unbiased {
namespace {

template <int DH>
constexpr size_t fwd_smem_bytes() {
  return (size_t)(3 * kTile * Shape<DH>::LD + kTile * kLP) * sizeof(float);
}

template <typename T, int DH, bool HOIST>
__global__ void __launch_bounds__(kThreads, 1)
cluster_attn_fwd_unbiased_kernel(const T* __restrict__ q,
                                 const T* __restrict__ k,
                                 const T* __restrict__ v,
                                 const int32_t* __restrict__ block_idx,
                                 T* __restrict__ out,
                                 float* __restrict__ lse, int S, int H,
                                 int KV, int nq, int mb, int idx_stride,
                                 int bq, int bk, int causal,
                                 float sm_scale) {
  using Sh = Shape<DH>;
  constexpr int LD = Sh::LD, NG = Sh::NG, VW = Sh::VW;
  extern __shared__ float4 smem4[];
  float* sQ = reinterpret_cast<float*>(smem4);
  float* sK = sQ + kTile * LD;
  float* sV = sK + kTile * LD;
  float* sP = sV + kTile * LD;

  const int tid = threadIdx.x, tr = tid >> 4, tc = tid & 15;
  const int subs = bq / kTile;
  int x = blockIdx.x;
  const int h = x % H;
  x /= H;
  const int sub = x % subs;
  x /= subs;
  const int qi = x % nq;
  const int b = x / nq;
  const int kvh = h / (H / KV);
  const int q0 = qi * bq + sub * kTile;  // first q position of the tile
  const size_t qs = (size_t)H * DH, ks = (size_t)KV * DH;

  if constexpr (DH != Sh::DP) clear_smem(sQ, 3 * kTile * LD);
  load_rows_upto<DH>(sQ, q + ((size_t)b * S + q0) * qs + (size_t)h * DH, qs,
                     kTile, kTile, HOIST ? sm_scale : 1.f);
  float acc[4][NG][VW];
  float m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int g = 0; g < NG; ++g)
#pragma unroll
      for (int e = 0; e < VW; ++e) acc[i][g][e] = 0.f;
  }

  // this sequence's row: idx_stride 0 for a layout shared by the batch
  const int32_t* row = block_idx + (size_t)b * idx_stride + (size_t)qi * mb;
  const int chunks = bk / kTile;
  for (int s = 0; s < mb; ++s) {
    const int blk = row[s];  // uniform across the CTA
    if (blk < 0) continue;
    for (int ch = 0; ch < chunks; ++ch) {
      const int k0 = blk * bk + ch * kTile;
      if (causal && k0 > q0 + kTile - 1) continue;  // every entry masked
      __syncthreads();  // the previous chunk's readers are done
      const size_t koff = ((size_t)b * S + k0) * ks + (size_t)kvh * DH;
      load_rows<DH>(sK, k + koff, ks, kTile);
      load_rows<DH>(sV, v + koff, ks, kTile);
      __syncthreads();

      float sc[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) sc[i][j] = 0.f;
      dot_tile<DH>(sQ, tr, sK, tc, sc);

      const bool partial = causal && k0 + kTile - 1 > q0;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int qp = q0 + tr + 16 * i;
        float mx = kNegInf;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float sv = HOIST ? sc[i][j] : sc[i][j] * sm_scale;
          if (partial && qp < k0 + tc + 16 * j) sv = kNegInf;
          sc[i][j] = sv;
          mx = fmaxf(mx, sv);
        }
        mx = row_max(mx);
        const float m_new = fmaxf(m[i], mx);
        float sum = 0.f;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float p = m_new <= kNegInf ? 0.f : expf(sc[i][j] - m_new);
          sP[(tr + 16 * i) * kLP + tc + 16 * j] = p;
          sum += p;
        }
        sum = row_sum(sum);
        const float corr = expf(m[i] - m_new);
        l[i] = l[i] * corr + sum;
        m[i] = m_new;
#pragma unroll
        for (int g = 0; g < NG; ++g)
#pragma unroll
          for (int e = 0; e < VW; ++e) acc[i][g][e] *= corr;
      }
      __syncthreads();
      acc_tile<DH>(sP, tr, sV, tc, acc);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + tr + 16 * i;
    const float den = fmaxf(l[i], 1e-30f);
    T* orow = out + ((size_t)b * S + r) * qs + (size_t)h * DH;
#pragma unroll
    for (int g = 0; g < NG; ++g)
#pragma unroll
      for (int e = 0; e < VW; ++e)
        if (Sh::live(Sh::col(g, tc) + e))
          orow[Sh::col(g, tc) + e] = from_f32<T>(acc[i][g][e] / den);
    if (lse != nullptr && tc == 0)
      lse[((size_t)b * H + h) * S + r] =
          l[i] > 0.f ? m[i] + logf(fmaxf(l[i], 1e-30f)) : 0.f;
  }
}

template <typename T, int DH, bool HOIST>
int launch(const void* q, const void* k, const void* v,
           const void* block_idx, void* out, void* lse, int B, int S, int H,
           int KV, int nq, int mb, int idx_stride, int bq, int bk,
           int causal, float sm_scale, cudaStream_t stream) {
  const size_t smem = fwd_smem_bytes<DH>();
  cudaError_t err = cudaFuncSetAttribute(
      cluster_attn_fwd_unbiased_kernel<T, DH, HOIST>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const unsigned grid = (unsigned)B * nq * (bq / kTile) * H;
  cluster_attn_fwd_unbiased_kernel<T, DH, HOIST>
      <<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int32_t*>(block_idx),
      static_cast<T*>(out), static_cast<float*>(lse), S, H, KV, nq, mb,
      idx_stride, bq, bk, causal, sm_scale);
  return (int)cudaGetLastError();
}

template <typename T, bool HOIST>
int launch_dh(int dh, const void* q, const void* k, const void* v,
              const void* block_idx, void* out, void* lse, int B, int S,
              int H, int KV, int nq, int mb, int idx_stride, int bq, int bk,
              int causal, float sm_scale, cudaStream_t st) {
#define UNBIASED_FWD_CASE(D)                                                \
  case D:                                                                   \
    return launch<T, D, HOIST>(q, k, v, block_idx, out, lse, B, S, H, KV,   \
                               nq, mb, idx_stride, bq, bk, causal,          \
                               sm_scale, st);
  switch (dh) {
    UNBIASED_FWD_CASE(8)
    UNBIASED_FWD_CASE(16)
    UNBIASED_FWD_CASE(24)
    UNBIASED_FWD_CASE(32)
    UNBIASED_FWD_CASE(40)
    UNBIASED_FWD_CASE(48)
    UNBIASED_FWD_CASE(56)
    UNBIASED_FWD_CASE(64)
    UNBIASED_FWD_CASE(128)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef UNBIASED_FWD_CASE
}

}  // namespace
}  // namespace unbiased

extern "C" {

// dtype: 0 = float32 (bfloat16 is cluster_attention_fwd_unbiased_sm90's).
// q (B,S,H,Dh), k/v (B,S,KV,Dh), out like q, all contiguous and 16-byte
// aligned; block_idx (nq,mb) int32 shared by the batch (idx_stride 0) or
// (B,nq,mb) (idx_stride nq*mb); lse (B*H,S) fp32 or NULL; hoist the
// schedule's rewrite (0 or 1). Takes Dh a multiple of 8 up to 64, or 128,
// bq = bk a multiple of 64. Returns the CUDA error code of the launch (0
// = launched).
int cluster_attention_fwd_unbiased(const void* q, const void* k,
                                   const void* v, const void* block_idx,
                                   void* out, void* lse, int dtype, int B,
                                   int S, int H, int KV, int dh, int nq,
                                   int mb, int idx_stride, int bq, int bk,
                                   int causal, int hoist, float sm_scale,
                                   void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bq % unbiased::kTile || bk % unbiased::kTile || dtype != 0)
    return (int)cudaErrorInvalidValue;
  if (hoist)
    return unbiased::launch_dh<float, true>(dh, q, k, v, block_idx, out, lse,
                                            B, S, H, KV, nq, mb, idx_stride,
                                            bq, bk, causal, sm_scale, st);
  return unbiased::launch_dh<float, false>(dh, q, k, v, block_idx, out, lse,
                                           B, S, H, KV, nq, mb, idx_stride,
                                           bq, bk, causal, sm_scale, st);
}

}  // extern "C"
