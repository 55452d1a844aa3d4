// Dense flash attention backward for Hopper (sm_90a), for fp32 inputs:
// the dQ and dK/dV kernels.
//
// Replace the TPU kernels `_flash_dq_kernel` and `_flash_dkv_kernel` in
// src/repro/kernels/flash_attention.py for fp32 q, k, v and dO, as the
// autotuner runs them: the recomputation backward of
// flash_attention_fwd.cu. bf16 inputs go to the tensor-core kernels of
// flash_attention_bwd_dq_sm90.cu and flash_attention_bwd_dkv_sm90.cu,
// which rebuild the scores as flash_attention_fwd_sm90.cu does. Each
// kernel here rebuilds a tile's scores exactly as the fp32 forward built
// them (`(q . k) * Dh^-0.5`, or `(q * Dh^-0.5) . k` under the
// `hoist_scale` rewrite, in fp32; -1e30 where `kpos >= Sk` or, when
// causal, `qpos < kpos`) and, with the forward's per-row logsumexp `lse`
// and `delta = rowsum(dO * O)` (both fp32, computed by the caller), forms
//   p  = exp(s - lse)   (0 on the ragged tail's q rows, which add nothing)
//   dp = dO . v
//   ds = p * (dp - delta)
// and accumulates, in fp32:
//   dQ kernel,    64 q rows of one head per CTA, streaming k and v in
//                 64-row chunks: dq += scale * ds @ k;
//   dK/dV kernel, 64 k rows of one q head per CTA, streaming q, dO, lse
//                 and delta in 64-row chunks: dv += p^T @ dO,
//                 dk += scale * ds^T @ q, per q head (the GQA group sum is
//                 the caller's, as the reference's epilogue).
//
// What bounds them on the card. At the Qwen3-0.6B training shape (S=16384,
// 16 q heads over 8, Dh 128, causal: 1.342e8 score entries a head) dQ does
// 6 * 1.342e8 * 128 * 16 = 1.65 TFLOP (24.6 ms at the fp32 CUDA-core
// peak of 67 TFLOP/s) and dK/dV 8 * ... = 2.20 TFLOP (32.8 ms), against
// ~0.5-0.7 GB of fp32 operands each: bound by operations.
//
// What this design does about it. The tiles of the unbiased cluster
// backward (unbiased_tiles.cuh): fp32 operand tiles in shared memory
// with padded rows, 4 x 4 register blocks of scores per thread. Shared
// memory at Dh 128: dQ 152,576 bytes (q, dO, k, v and the ds tile), dK/dV
// 170,496 (k, v, q, dO, the transposed p and ds tiles, 64 lse/delta
// pairs); one CTA per SM. The tiles are fixed at 64 x 64 whatever the
// forward's schedule: only `hoist_scale` changes what these kernels
// compute. Chunks the causal mask empties are skipped: dQ stops at the
// diagonal and runs its q-blocks heaviest first, dK/dV starts at it (its
// heaviest k-blocks come first in the grid). All arithmetic is fp32 on
// CUDA cores (TF32 would miss the fp32 tolerances).

#include "unbiased_tiles.cuh"

namespace flash {
namespace {

using unbiased::acc_tile;
using unbiased::dot_tile;
using unbiased::kLP;
using unbiased::kNegInf;
using unbiased::kThreads;
using unbiased::kTile;
using unbiased::load_rows_upto;
using unbiased::Shape;
using unbiased::store_rows_upto;

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
flash_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                const T* __restrict__ v, const T* __restrict__ dout,
                const float* __restrict__ lse,
                const float* __restrict__ delta, T* __restrict__ dq, int Sq,
                int Sk, int H, int KV, int nqb, int causal, float sm_scale) {
  using Sh = Shape<DH>;
  constexpr int LD = Sh::LD, NG = Sh::NG, VW = Sh::VW;
  extern __shared__ float4 smem4[];
  float* sQ = reinterpret_cast<float*>(smem4);
  float* sDO = sQ + kTile * LD;
  float* sK = sDO + kTile * LD;
  float* sV = sK + kTile * LD;
  float* sDS = sV + kTile * LD;

  const int tid = threadIdx.x, tr = tid >> 4, tc = tid & 15;
  int x = blockIdx.x;
  const int h = x % H;
  x /= H;
  const int qb = nqb - 1 - x % nqb;  // the longest causal rows first
  const int b = x / nqb;
  const int kvh = h / (H / KV);
  const int q0 = qb * kTile;
  const size_t qs = (size_t)H * DH, ks = (size_t)KV * DH;
  const size_t qoff = ((size_t)b * Sq + q0) * qs + (size_t)h * DH;

  load_rows_upto<DH>(sQ, q + qoff, qs, kTile, Sq - q0,
                     HOIST ? sm_scale : 1.f);
  load_rows_upto<DH>(sDO, dout + qoff, qs, kTile, Sq - q0, 1.f);
  float rl[4], rd[4];  // lse and delta of the thread's rows
  const size_t row0 = ((size_t)b * H + h) * Sq + q0;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const bool live = q0 + tr + 16 * i < Sq;
    rl[i] = live ? lse[row0 + tr + 16 * i] : 0.f;
    rd[i] = live ? delta[row0 + tr + 16 * i] : 0.f;
  }
  float acc[4][NG][VW];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int g = 0; g < NG; ++g)
#pragma unroll
      for (int e = 0; e < VW; ++e) acc[i][g][e] = 0.f;

  const int k_end = causal ? min(Sk, min(q0 + kTile, Sq)) : Sk;
  for (int k0 = 0; k0 < k_end; k0 += kTile) {
    __syncthreads();  // the previous chunk's readers are done
    const size_t koff = ((size_t)b * Sk + k0) * ks + (size_t)kvh * DH;
    load_rows_upto<DH>(sK, k + koff, ks, kTile, Sk - k0, 1.f);
    load_rows_upto<DH>(sV, v + koff, ks, kTile, Sk - k0, 1.f);
    __syncthreads();

    float sc[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[i][j] = dp[i][j] = 0.f;
    dot_tile<DH>(sQ, tr, sK, tc, sc);
    dot_tile<DH>(sDO, tr, sV, tc, dp);

    const bool edge = k0 + kTile > Sk || (causal && k0 + kTile - 1 > q0);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qp = q0 + tr + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kp = k0 + tc + 16 * j;
        float sv = HOIST ? sc[i][j] : sc[i][j] * sm_scale;
        if (edge && (kp >= Sk || (causal && qp < kp))) sv = kNegInf;
        const float p = qp < Sq ? expf(sv - rl[i]) : 0.f;
        sDS[(tr + 16 * i) * kLP + tc + 16 * j] = p * (dp[i][j] - rd[i]);
      }
    }
    __syncthreads();
    acc_tile<DH>(sDS, tr, sK, tc, acc);
  }
  store_rows_upto<DH>(dq + qoff, qs, tr, tc, acc, sm_scale, Sq - q0);
}

// ---------------------------------------------------------- dK/dV kernel

template <typename T, int DH, bool HOIST>
__global__ void __launch_bounds__(kThreads, 1)
flash_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const T* __restrict__ dout,
                 const float* __restrict__ lse,
                 const float* __restrict__ delta, T* __restrict__ dk,
                 T* __restrict__ dv, int Sq, int Sk, int H, int KV, int nkb,
                 int causal, float sm_scale) {
  using Sh = Shape<DH>;
  constexpr int LD = Sh::LD, NG = Sh::NG, VW = Sh::VW;
  extern __shared__ float4 smem4[];
  float* sK = reinterpret_cast<float*>(smem4);
  float* sV = sK + kTile * LD;
  float* sQ = sV + kTile * LD;
  float* sDO = sQ + kTile * LD;
  float* sPT = sDO + kTile * LD;   // p^T: row = k row, col = q row
  float* sDST = sPT + kTile * kLP;  // ds^T
  float* sLse = sDST + kTile * kLP;
  float* sDl = sLse + kTile;

  const int tid = threadIdx.x, tr = tid >> 4, tc = tid & 15;
  int x = blockIdx.x;
  const int h = x % H;
  x /= H;
  const int kb = x % nkb;  // the longest causal columns (kb = 0) first
  const int b = x / nkb;
  const int kvh = h / (H / KV);
  const int k0 = kb * kTile;
  const size_t qs = (size_t)H * DH, ks = (size_t)KV * DH;
  const size_t koff = ((size_t)b * Sk + k0) * ks + (size_t)kvh * DH;

  load_rows_upto<DH>(sK, k + koff, ks, kTile, Sk - k0, 1.f);
  load_rows_upto<DH>(sV, v + koff, ks, kTile, Sk - k0, 1.f);
  float acc_k[4][NG][VW], acc_v[4][NG][VW];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int g = 0; g < NG; ++g)
#pragma unroll
      for (int e = 0; e < VW; ++e) acc_k[i][g][e] = acc_v[i][g][e] = 0.f;

  // q rows before k0 see none of these keys when causal
  for (int q0 = causal ? k0 : 0; q0 < Sq; q0 += kTile) {
    __syncthreads();  // the previous chunk's readers are done
    const size_t qoff = ((size_t)b * Sq + q0) * qs + (size_t)h * DH;
    load_rows_upto<DH>(sQ, q + qoff, qs, kTile, Sq - q0,
                       HOIST ? sm_scale : 1.f);
    load_rows_upto<DH>(sDO, dout + qoff, qs, kTile, Sq - q0, 1.f);
    if (tid < kTile) {
      const bool live = q0 + tid < Sq;
      const size_t r = ((size_t)b * H + h) * Sq + q0 + tid;
      sLse[tid] = live ? lse[r] : 0.f;
      sDl[tid] = live ? delta[r] : 0.f;
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

    const bool edge = q0 + kTile > Sq || (causal && k0 + kTile - 1 > q0);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int kp = k0 + tr + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tc + 16 * j, qp = q0 + c;
        float sv = HOIST ? st[i][j] : st[i][j] * sm_scale;
        if (edge && causal && qp < kp) sv = kNegInf;
        // a padded q row carries lse = 0, dO = 0 and delta = 0, but
        // exp(s - 0) is not small: it is masked here, not by the numbers
        const float p = edge && qp >= Sq ? 0.f : expf(sv - sLse[c]);
        sPT[(tr + 16 * i) * kLP + c] = p;
        sDST[(tr + 16 * i) * kLP + c] = p * (dpt[i][j] - sDl[c]);
      }
    }
    __syncthreads();
    acc_tile<DH>(sPT, tr, sDO, tc, acc_v);
    acc_tile<DH>(sDST, tr, sQ, tc, acc_k);
  }
  // under hoist_scale sQ held q * scale, so ds^T @ sQ already carries it
  const size_t hoff = ((size_t)b * Sk + k0) * qs + (size_t)h * DH;
  store_rows_upto<DH>(dk + hoff, qs, tr, tc, acc_k, HOIST ? 1.f : sm_scale,
                      Sk - k0);
  store_rows_upto<DH>(dv + hoff, qs, tr, tc, acc_v, 1.f, Sk - k0);
}

template <typename T, int DH, bool HOIST>
int launch_dq(const void* q, const void* k, const void* v, const void* dout,
              const void* lse, const void* delta, void* dq, int B, int Sq,
              int Sk, int H, int KV, int causal, float sm_scale,
              cudaStream_t stream) {
  const size_t smem = dq_smem_bytes<DH>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_dq_kernel<T, DH, HOIST>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int nqb = (Sq + kTile - 1) / kTile;
  const unsigned grid = (unsigned)B * nqb * H;
  flash_dq_kernel<T, DH, HOIST><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<T*>(dq), Sq, Sk, H, KV, nqb, causal, sm_scale);
  return (int)cudaGetLastError();
}

template <typename T, int DH, bool HOIST>
int launch_dkv(const void* q, const void* k, const void* v,
               const void* dout, const void* lse, const void* delta,
               void* dk, void* dv, int B, int Sq, int Sk, int H, int KV,
               int causal, float sm_scale, cudaStream_t stream) {
  const size_t smem = dkv_smem_bytes<DH>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_dkv_kernel<T, DH, HOIST>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int nkb = (Sk + kTile - 1) / kTile;
  const unsigned grid = (unsigned)B * nkb * H;
  flash_dkv_kernel<T, DH, HOIST><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<T*>(dk), static_cast<T*>(dv), Sq, Sk, H, KV, nkb, causal,
      sm_scale);
  return (int)cudaGetLastError();
}

// One entry per Dh: `which` 0 = dQ, 1 = dK/dV.
template <typename T, int DH>
int launch_hoist(int which, int hoist, const void* q, const void* k,
                 const void* v, const void* dout, const void* lse,
                 const void* delta, void* d0, void* d1, int B, int Sq,
                 int Sk, int H, int KV, int causal, float sm_scale,
                 cudaStream_t st) {
  if (which == 0)
    return hoist ? launch_dq<T, DH, true>(q, k, v, dout, lse, delta, d0, B,
                                          Sq, Sk, H, KV, causal, sm_scale, st)
                 : launch_dq<T, DH, false>(q, k, v, dout, lse, delta, d0, B,
                                           Sq, Sk, H, KV, causal, sm_scale,
                                           st);
  return hoist ? launch_dkv<T, DH, true>(q, k, v, dout, lse, delta, d0, d1,
                                         B, Sq, Sk, H, KV, causal, sm_scale,
                                         st)
               : launch_dkv<T, DH, false>(q, k, v, dout, lse, delta, d0, d1,
                                          B, Sq, Sk, H, KV, causal, sm_scale,
                                          st);
}

template <typename T>
int launch_dh(int which, int dh, int hoist, const void* q, const void* k,
              const void* v, const void* dout, const void* lse,
              const void* delta, void* d0, void* d1, int B, int Sq, int Sk,
              int H, int KV, int causal, float sm_scale, cudaStream_t st) {
  switch (dh) {
    case 32:
      return launch_hoist<T, 32>(which, hoist, q, k, v, dout, lse, delta, d0,
                                 d1, B, Sq, Sk, H, KV, causal, sm_scale, st);
    case 64:
      return launch_hoist<T, 64>(which, hoist, q, k, v, dout, lse, delta, d0,
                                 d1, B, Sq, Sk, H, KV, causal, sm_scale, st);
    case 128:
      return launch_hoist<T, 128>(which, hoist, q, k, v, dout, lse, delta,
                                  d0, d1, B, Sq, Sk, H, KV, causal, sm_scale,
                                  st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

int dispatch(int which, int dtype, int dh, int hoist, const void* q,
             const void* k, const void* v, const void* dout, const void* lse,
             const void* delta, void* d0, void* d1, int B, int Sq, int Sk,
             int H, int KV, int causal, float sm_scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (Sq <= 0 || Sk <= 0 || dtype != 0) return (int)cudaErrorInvalidValue;
  return launch_dh<float>(which, dh, hoist, q, k, v, dout, lse, delta, d0,
                          d1, B, Sq, Sk, H, KV, causal, sm_scale, st);
}

}  // namespace
}  // namespace flash

extern "C" {

// dtype: 0 = float32 (bfloat16 is flash_attention_bwd_dq_sm90's). q, dout
// and dq (B,Sq,H,Dh); k/v (B,Sk,KV,Dh), all contiguous and 16-byte
// aligned; lse, delta (B*H,Sq) fp32. Takes Dh in {32, 64, 128}. Returns
// the CUDA error code of the launch (0 = launched).
int flash_attention_bwd_dq(const void* q, const void* k, const void* v,
                           const void* dout, const void* lse,
                           const void* delta, void* dq, int dtype, int B,
                           int Sq, int Sk, int H, int KV, int dh, int causal,
                           int hoist, float sm_scale, void* stream) {
  return flash::dispatch(0, dtype, dh, hoist, q, k, v, dout, lse, delta, dq,
                         nullptr, B, Sq, Sk, H, KV, causal, sm_scale, stream);
}

// As above (bfloat16 is flash_attention_bwd_dkv_sm90's); dk/dv
// (B,Sk,H,Dh) per q-head.
int flash_attention_bwd_dkv(const void* q, const void* k, const void* v,
                            const void* dout, const void* lse,
                            const void* delta, void* dk, void* dv, int dtype,
                            int B, int Sq, int Sk, int H, int KV, int dh,
                            int causal, int hoist, float sm_scale,
                            void* stream) {
  return flash::dispatch(1, dtype, dh, hoist, q, k, v, dout, lse, delta, dk,
                         dv, B, Sq, Sk, H, KV, causal, sm_scale, stream);
}

}  // extern "C"
