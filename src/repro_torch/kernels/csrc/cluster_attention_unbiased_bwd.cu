// Unbiased cluster-sparse attention backward, optional positional causal
// mask, for Hopper (sm_90a), for fp32 inputs: the dQ kernel and the dK/dV
// kernel.
//
// Replace the TPU kernels `_dq_kernel` and `_dkv_kernel` in
// src/repro/kernels/cluster_attention_bwd.py for fp32 q, k, v and dO: the
// recomputation backward of cluster_attention_unbiased_fwd.cu; bf16
// inputs go to the tensor-core kernels of
// cluster_attention_unbiased_bwd_sm90.cu. Each kernel rebuilds a visited
// block's scores exactly as the forward built them (`(q . k) * Dh^-0.5`
// in fp32, -1e30 where `qpos < kpos` when causal) and, with the forward's
// per-row logsumexp `lse` and `delta = rowsum(dO * O)` (both fp32,
// computed by the caller), forms
//   p  = exp(s - lse)          (dead rows carry lse = 0, so p = 0 there)
//   dp = dO . v
//   ds = p * (dp - delta)
// and accumulates, in fp32:
//   dQ kernel,   64 q-rows of one q-block and one head per CTA, walking
//                the forward layout `block_idx[b, qi, :]` in 64-column
//                chunks: dq += scale * ds @ k;
//   dK/dV kernel, 64 k-columns of one k-block and one head per CTA,
//                walking the transposed layout `block_idx_t[b, ki, :]`
//                of (q-row, forward slot) pairs, each visiting q-block in
//                64-row chunks: dv += p^T @ dO, dk += scale * ds^T @ q,
//                per q-head (the GQA group sum is the caller's).
// Each layout is shared by the batch (a stride of 0) or one per sequence
// (`idx_stride` and `t_stride` entries apart: the graph path's per-graph
// layout). Dh is a multiple of 8 up to 64, or 128, in tiles of DP = Dh
// rounded up to 16 columns (unbiased_tiles.cuh): the pad columns are
// cleared once and never stored.
//
// The forward's `hoist_scale` is a template flag here too, so the scores
// are rebuilt as the forward built them: the q tile is staged times
// Dh^-0.5, and dK, contracting that tile, takes no second scale.
//
// What bounds them on the card. At the Qwen3-0.6B training shape
// (S=16384, H=16 over KV=8, Dh=128, 3696 visited 128 x 128 blocks, the
// causal diagonal blocks half full) dQ does ~732 GFLOP (10.9 ms at the
// fp32 CUDA-core peak of 67 TFLOP/s) and dK/dV ~976 GFLOP (14.6 ms),
// against ~0.6 GB of fp32 operands each: bound by operations.
//
// What this design does about it. As in the forward: tiles of 64 rows
// and 64 columns inside the 128 x 128 block, fp32 in shared memory with
// padded rows, and 4 x 4 register blocks of scores per thread
// (unbiased_tiles.cuh). Shared memory at Dh = 128: dQ holds q, dO, k, v
// (64 x 132 fp32 each) and the 64 x 68 ds tile, 152,576 bytes; dK/dV
// holds k, v, q, dO, the transposed p and ds tiles and 64 lse/delta
// pairs, 170,496 bytes: one CTA per SM. ptxas -v for sm_90a: dQ 168
// registers a thread at Dh 128 (160 at 64), dK/dV 200 (166), no
// spills. Chunks the causal mask empties are skipped. All arithmetic is
// fp32 on CUDA cores: TF32 on the tensor cores would miss the fp32
// tolerances. The global k-block 0 is visited by
// every q-row, so the dK/dV CTAs of that column walk `nq` pairs against
// ~29 elsewhere; heads vary fastest and k-block 0 comes first in the
// grid, so they start first.

#include "unbiased_tiles.cuh"

namespace unbiased {
namespace {

template <int DH>
constexpr size_t dq_smem_bytes() {
  return (size_t)(4 * kTile * Shape<DH>::LD + kTile * kLP) * sizeof(float);
}

template <int DH>
constexpr size_t dkv_smem_bytes() {
  return (size_t)(4 * kTile * Shape<DH>::LD + 2 * kTile * kLP + 2 * kTile) *
         sizeof(float);
}

// ------------------------------------------------------------- dQ kernel

template <typename T, int DH, bool HOIST>
__global__ void __launch_bounds__(kThreads, 1)
cluster_attn_dq_unbiased_kernel(const T* __restrict__ q,
                                const T* __restrict__ k,
                                const T* __restrict__ v,
                                const T* __restrict__ dout,
                                const float* __restrict__ lse,
                                const float* __restrict__ delta,
                                const int32_t* __restrict__ block_idx,
                                T* __restrict__ dq, int S, int H, int KV,
                                int nq, int mb, int idx_stride, int bq,
                                int bk, int causal, float sm_scale) {
  using Sh = Shape<DH>;
  constexpr int LD = Sh::LD, NG = Sh::NG, VW = Sh::VW;
  extern __shared__ float4 smem4[];
  float* sQ = reinterpret_cast<float*>(smem4);
  float* sDO = sQ + kTile * LD;
  float* sK = sDO + kTile * LD;
  float* sV = sK + kTile * LD;
  float* sDS = sV + kTile * LD;

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
  const int q0 = qi * bq + sub * kTile;
  const size_t qs = (size_t)H * DH, ks = (size_t)KV * DH;
  const size_t qoff = ((size_t)b * S + q0) * qs + (size_t)h * DH;

  if constexpr (DH != Sh::DP) clear_smem(sQ, 4 * kTile * LD);
  load_rows_upto<DH>(sQ, q + qoff, qs, kTile, kTile,
                     HOIST ? sm_scale : 1.f);
  load_rows<DH>(sDO, dout + qoff, qs, kTile);
  float rl[4], rd[4];  // lse and delta of the thread's rows
  const size_t row0 = ((size_t)b * H + h) * S + q0;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    rl[i] = lse[row0 + tr + 16 * i];
    rd[i] = delta[row0 + tr + 16 * i];
  }
  float acc[4][NG][VW];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int g = 0; g < NG; ++g)
#pragma unroll
      for (int e = 0; e < VW; ++e) acc[i][g][e] = 0.f;

  // this sequence's row: idx_stride 0 for a layout shared by the batch
  const int32_t* row = block_idx + (size_t)b * idx_stride + (size_t)qi * mb;
  const int chunks = bk / kTile;
  for (int s = 0; s < mb; ++s) {
    const int blk = row[s];  // uniform across the CTA
    if (blk < 0) continue;
    for (int ch = 0; ch < chunks; ++ch) {
      const int k0 = blk * bk + ch * kTile;
      if (causal && k0 > q0 + kTile - 1) continue;
      __syncthreads();  // the previous chunk's readers are done
      const size_t koff = ((size_t)b * S + k0) * ks + (size_t)kvh * DH;
      load_rows<DH>(sK, k + koff, ks, kTile);
      load_rows<DH>(sV, v + koff, ks, kTile);
      __syncthreads();

      float sc[4][4], dp[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) sc[i][j] = dp[i][j] = 0.f;
      dot_tile<DH>(sQ, tr, sK, tc, sc);
      dot_tile<DH>(sDO, tr, sV, tc, dp);

      const bool partial = causal && k0 + kTile - 1 > q0;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int qp = q0 + tr + 16 * i;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float sv = HOIST ? sc[i][j] : sc[i][j] * sm_scale;
          if (partial && qp < k0 + tc + 16 * j) sv = kNegInf;
          const float p = expf(sv - rl[i]);
          sDS[(tr + 16 * i) * kLP + tc + 16 * j] = p * (dp[i][j] - rd[i]);
        }
      }
      __syncthreads();
      acc_tile<DH>(sDS, tr, sK, tc, acc);
    }
  }
  store_rows<DH>(dq + qoff, qs, tr, tc, acc, sm_scale);
}

// ---------------------------------------------------------- dK/dV kernel

template <typename T, int DH, bool HOIST>
__global__ void __launch_bounds__(kThreads, 1)
cluster_attn_dkv_unbiased_kernel(const T* __restrict__ q,
                                 const T* __restrict__ k,
                                 const T* __restrict__ v,
                                 const T* __restrict__ dout,
                                 const float* __restrict__ lse,
                                 const float* __restrict__ delta,
                                 const int32_t* __restrict__ block_idx_t,
                                 T* __restrict__ dk, T* __restrict__ dv,
                                 int S, int H, int KV, int nk, int mt,
                                 int t_stride, int bq, int bk, int causal,
                                 float sm_scale) {
  using Sh = Shape<DH>;
  constexpr int LD = Sh::LD, NG = Sh::NG, VW = Sh::VW;
  extern __shared__ float4 smem4[];
  float* sK = reinterpret_cast<float*>(smem4);
  float* sV = sK + kTile * LD;
  float* sQ = sV + kTile * LD;
  float* sDO = sQ + kTile * LD;
  float* sPT = sDO + kTile * LD;   // p^T: row = k column, col = q row
  float* sDST = sPT + kTile * kLP;  // ds^T
  float* sLse = sDST + kTile * kLP;
  float* sDl = sLse + kTile;

  const int tid = threadIdx.x, tr = tid >> 4, tc = tid & 15;
  const int subs = bk / kTile;
  int x = blockIdx.x;
  const int h = x % H;
  x /= H;
  const int sub = x % subs;
  x /= subs;
  const int ki = x % nk;
  const int b = x / nk;
  const int kvh = h / (H / KV);
  const int k0 = ki * bk + sub * kTile;  // first k position of the tile
  const size_t qs = (size_t)H * DH, ks = (size_t)KV * DH;
  const size_t koff = ((size_t)b * S + k0) * ks + (size_t)kvh * DH;

  if constexpr (DH != Sh::DP) clear_smem(sK, 4 * kTile * LD);
  load_rows<DH>(sK, k + koff, ks, kTile);
  load_rows<DH>(sV, v + koff, ks, kTile);
  float acc_k[4][NG][VW], acc_v[4][NG][VW];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int g = 0; g < NG; ++g)
#pragma unroll
      for (int e = 0; e < VW; ++e) acc_k[i][g][e] = acc_v[i][g][e] = 0.f;

  // this sequence's pairs: t_stride 0 for a layout shared by the batch
  const int32_t* pairs =
      block_idx_t + (size_t)b * t_stride + (size_t)ki * mt * 2;
  const int chunks = bq / kTile;
  for (int t = 0; t < mt; ++t) {
    const int qrow = pairs[2 * t];  // uniform across the CTA
    if (qrow < 0) continue;
    for (int ch = 0; ch < chunks; ++ch) {
      const int q0 = qrow * bq + ch * kTile;
      if (causal && q0 + kTile - 1 < k0) continue;  // every entry masked
      __syncthreads();  // the previous chunk's readers are done
      const size_t qoff = ((size_t)b * S + q0) * qs + (size_t)h * DH;
      load_rows_upto<DH>(sQ, q + qoff, qs, kTile, kTile,
                         HOIST ? sm_scale : 1.f);
      load_rows<DH>(sDO, dout + qoff, qs, kTile);
      if (tid < kTile) {
        const size_t r = ((size_t)b * H + h) * S + q0 + tid;
        sLse[tid] = lse[r];
        sDl[tid] = delta[r];
      }
      __syncthreads();

      // transposed scores: st[i][j] = k[k0 + tr + 16 i] . q[q0 + tc + 16 j]
      float st[4][4], dpt[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) st[i][j] = dpt[i][j] = 0.f;
      dot_tile<DH>(sK, tr, sQ, tc, st);
      dot_tile<DH>(sV, tr, sDO, tc, dpt);

      const bool partial = causal && k0 + kTile - 1 > q0;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int kp = k0 + tr + 16 * i;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int r = tc + 16 * j;
          float sv = HOIST ? st[i][j] : st[i][j] * sm_scale;
          if (partial && q0 + r < kp) sv = kNegInf;
          const float p = expf(sv - sLse[r]);
          sPT[(tr + 16 * i) * kLP + r] = p;
          sDST[(tr + 16 * i) * kLP + r] = p * (dpt[i][j] - sDl[r]);
        }
      }
      __syncthreads();
      acc_tile<DH>(sPT, tr, sDO, tc, acc_v);
      acc_tile<DH>(sDST, tr, sQ, tc, acc_k);
    }
  }
  const size_t hoff = ((size_t)b * S + k0) * qs + (size_t)h * DH;
  // under HOIST sQ held q * scale, so ds^T @ sQ already carries it
  store_rows<DH>(dk + hoff, qs, tr, tc, acc_k, HOIST ? 1.f : sm_scale);
  store_rows<DH>(dv + hoff, qs, tr, tc, acc_v, 1.f);
}

template <typename T, int DH, bool HOIST>
int launch_dq(const void* q, const void* k, const void* v, const void* dout,
              const void* lse, const void* delta, const void* block_idx,
              void* dq, int B, int S, int H, int KV, int nq, int mb,
              int idx_stride, int bq, int bk, int causal, float sm_scale,
              cudaStream_t stream) {
  const size_t smem = dq_smem_bytes<DH>();
  cudaError_t err = cudaFuncSetAttribute(
      cluster_attn_dq_unbiased_kernel<T, DH, HOIST>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const unsigned grid = (unsigned)B * nq * (bq / kTile) * H;
  cluster_attn_dq_unbiased_kernel<T, DH, HOIST>
      <<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<const int32_t*>(block_idx), static_cast<T*>(dq), S, H, KV,
      nq, mb, idx_stride, bq, bk, causal, sm_scale);
  return (int)cudaGetLastError();
}

template <typename T, int DH, bool HOIST>
int launch_dkv(const void* q, const void* k, const void* v,
               const void* dout, const void* lse, const void* delta,
               const void* block_idx_t, void* dk, void* dv, int B, int S,
               int H, int KV, int nk, int mt, int t_stride, int bq, int bk,
               int causal, float sm_scale, cudaStream_t stream) {
  const size_t smem = dkv_smem_bytes<DH>();
  cudaError_t err = cudaFuncSetAttribute(
      cluster_attn_dkv_unbiased_kernel<T, DH, HOIST>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const unsigned grid = (unsigned)B * nk * (bk / kTile) * H;
  cluster_attn_dkv_unbiased_kernel<T, DH, HOIST>
      <<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<const int32_t*>(block_idx_t), static_cast<T*>(dk),
      static_cast<T*>(dv), S, H, KV, nk, mt, t_stride, bq, bk, causal,
      sm_scale);
  return (int)cudaGetLastError();
}

#define UNBIASED_DH_CASES(X) \
  X(8) X(16) X(24) X(32) X(40) X(48) X(56) X(64) X(128)

template <typename T, bool HOIST>
int dq_dh(int dh, const void* q, const void* k, const void* v,
          const void* dout, const void* lse, const void* delta,
          const void* block_idx, void* dq, int B, int S, int H, int KV,
          int nq, int mb, int idx_stride, int bq, int bk, int causal,
          float sm_scale, cudaStream_t st) {
#define DQ_CASE(D)                                                          \
  case D:                                                                   \
    return launch_dq<T, D, HOIST>(q, k, v, dout, lse, delta, block_idx, dq, \
                                  B, S, H, KV, nq, mb, idx_stride, bq, bk,  \
                                  causal, sm_scale, st);
  switch (dh) {
    UNBIASED_DH_CASES(DQ_CASE)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef DQ_CASE
}

template <typename T, bool HOIST>
int dkv_dh(int dh, const void* q, const void* k, const void* v,
           const void* dout, const void* lse, const void* delta,
           const void* block_idx_t, void* dk, void* dv, int B, int S, int H,
           int KV, int nk, int mt, int t_stride, int bq, int bk, int causal,
           float sm_scale, cudaStream_t st) {
#define DKV_CASE(D)                                                         \
  case D:                                                                   \
    return launch_dkv<T, D, HOIST>(q, k, v, dout, lse, delta, block_idx_t,  \
                                   dk, dv, B, S, H, KV, nk, mt, t_stride,   \
                                   bq, bk, causal, sm_scale, st);
  switch (dh) {
    UNBIASED_DH_CASES(DKV_CASE)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef DKV_CASE
}

#undef UNBIASED_DH_CASES

}  // namespace
}  // namespace unbiased

extern "C" {

// dtype: 0 = float32 (bfloat16 is cluster_attention_bwd_dq_unbiased_sm90's).
// q, dout and dq (B,S,H,Dh); k/v (B,S,KV,Dh), all contiguous and 16-byte
// aligned; lse, delta (B*H,S) fp32; block_idx (nq,mb) int32 shared by
// the batch (idx_stride 0) or (B,nq,mb) (idx_stride nq*mb); hoist the
// forward's rewrite (0 or 1). Takes Dh a multiple of 8 up to 64, or 128,
// bq = bk a multiple of 64. Returns the CUDA error code of the launch (0
// = launched).
int cluster_attention_bwd_dq_unbiased(const void* q, const void* k,
                                      const void* v, const void* dout,
                                      const void* lse, const void* delta,
                                      const void* block_idx, void* dq,
                                      int dtype, int B, int S, int H, int KV,
                                      int dh, int nq, int mb, int idx_stride,
                                      int bq, int bk, int causal, int hoist,
                                      float sm_scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bq % unbiased::kTile || bk % unbiased::kTile || dtype != 0)
    return (int)cudaErrorInvalidValue;
  if (hoist)
    return unbiased::dq_dh<float, true>(dh, q, k, v, dout, lse, delta,
                                        block_idx, dq, B, S, H, KV, nq, mb,
                                        idx_stride, bq, bk, causal, sm_scale,
                                        st);
  return unbiased::dq_dh<float, false>(dh, q, k, v, dout, lse, delta,
                                       block_idx, dq, B, S, H, KV, nq, mb,
                                       idx_stride, bq, bk, causal, sm_scale,
                                       st);
}

// As above (fp32 only); block_idx_t (nk,mt,2) int32 shared by the batch
// (t_stride 0) or (B,nk,mt,2) (t_stride nk*mt*2), lists (q-row, forward
// slot) pairs, -1 padded; dk/dv (B,S,H,Dh) fp32 per q-head.
int cluster_attention_bwd_dkv_unbiased(const void* q, const void* k,
                                       const void* v, const void* dout,
                                       const void* lse, const void* delta,
                                       const void* block_idx_t, void* dk,
                                       void* dv, int dtype, int B, int S,
                                       int H, int KV, int dh, int nk, int mt,
                                       int t_stride, int bq, int bk,
                                       int causal, int hoist, float sm_scale,
                                       void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bq % unbiased::kTile || bk % unbiased::kTile || dtype != 0)
    return (int)cudaErrorInvalidValue;
  if (hoist)
    return unbiased::dkv_dh<float, true>(dh, q, k, v, dout, lse, delta,
                                         block_idx_t, dk, dv, B, S, H, KV, nk,
                                         mt, t_stride, bq, bk, causal,
                                         sm_scale, st);
  return unbiased::dkv_dh<float, false>(dh, q, k, v, dout, lse, delta,
                                        block_idx_t, dk, dv, B, S, H, KV, nk,
                                        mt, t_stride, bq, bk, causal,
                                        sm_scale, st);
}

}  // extern "C"
