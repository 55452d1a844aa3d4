// Dense flash attention forward (online softmax, optional causal mask,
// GQA, ragged sequence tails) for Hopper (sm_90a), for fp32 inputs.
//
// Replaces the TPU kernel `_flash_kernel` in
// src/repro/kernels/flash_attention.py, the GP-FLASH baseline, for fp32
// q, k and v, as the autotuner runs it; bf16 inputs go to the
// tensor-core kernel of flash_attention_fwd_sm90.cu. Every
// score is `(q . k) * Dh^-0.5` in fp32 (or, with the `hoist_scale`
// rewrite, `(q * Dh^-0.5) . k`: the scale multiplied onto the q tile once
// as it is loaded), set to the finite sentinel -1e30 where `kpos >= Sk`
// (the ragged tail) or, when causal, where `qpos < kpos`. An online
// softmax in fp32 accumulates O; a row with no unmasked entry writes
// O = 0 and lse = 0. lse is (B*H, Sq) fp32, written only when asked for
// (the training path's residual).
//
// What bounds it on the card. At the Qwen3-0.6B training shape (S=16384,
// 16 q heads over 8 KV heads, Dh 128, causal) the causal score entries
// are 1.342e8 per head: 4 * 1.342e8 * 128 * 16 = 1.10 TFLOP, 1.11 ms at
// the bf16 tensor-core peak, against ~0.2 GB of q, k, v, O and lse
// (0.06 ms at 3.35 TB/s): bound by operations.
//
// What this design does about it. The building blocks of the unbiased
// cluster kernels (unbiased_tiles.cuh): a CTA of 256 threads holds
// `block_q` q rows (one or two 64-row tiles) of one head in fp32 shared
// memory and streams k and v through in stages of `block_k` rows, each
// stage consumed as 64-column chunks; each thread keeps a 4 x 4 block of
// scores and a 4 x Dh/16 block of each q tile's O accumulator in
// registers, so a float4 read from shared memory feeds four multiply-adds.
// The schedule's two block sizes are what the autotuner varies: two q
// tiles a CTA share each k/v stage (half the k/v traffic per q row, twice
// the accumulator registers), and a wider stage amortises its two
// barriers over more chunks at the cost of shared memory. Shared memory
// is (block_q + 2 block_k) (Dh + 4) + 64 x 68 floats: 186,368 bytes at
// Dh 128, block_q 64, block_k 128; 220,160 at block_q = block_k = 128
// (kernels/flash_attention.py `check_launch` states what fits). Chunks
// the causal mask empties are skipped, stages past the last live q row
// are never loaded, and the q-blocks run heaviest first. All arithmetic
// is fp32 on CUDA cores: TF32 on the tensor cores keeps about three
// decimal digits, short of the fp32 tolerances (2e-5 on O).

#include "unbiased_tiles.cuh"

namespace flash {
namespace {

using unbiased::acc_tile;
using unbiased::dot_tile;
using unbiased::from_f32;
using unbiased::kLP;
using unbiased::kNegInf;
using unbiased::kThreads;
using unbiased::kTile;
using unbiased::load_rows_upto;
using unbiased::row_max;
using unbiased::row_sum;
using unbiased::Shape;

template <int DH>
size_t fwd_smem_bytes(int block_q, int block_k) {
  return (size_t)((block_q + 2 * block_k) * Shape<DH>::LD + kTile * kLP) *
         sizeof(float);
}

// RQ: q tiles of 64 rows a CTA holds (block_q = 64 RQ).
template <typename T, int DH, int RQ, bool HOIST>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ out,
                 float* __restrict__ lse, int Sq, int Sk, int H, int KV,
                 int nqb, int block_k, int causal, float sm_scale) {
  using Sh = Shape<DH>;
  constexpr int LD = Sh::LD, NG = Sh::NG, VW = Sh::VW;
  extern __shared__ float4 smem4[];
  float* sQ = reinterpret_cast<float*>(smem4);
  float* sK = sQ + RQ * kTile * LD;
  float* sV = sK + block_k * LD;
  float* sP = sV + block_k * LD;

  const int tid = threadIdx.x, tr = tid >> 4, tc = tid & 15;
  int x = blockIdx.x;
  const int h = x % H;
  x /= H;
  const int qb = nqb - 1 - x % nqb;  // the longest causal rows first
  const int b = x / nqb;
  const int kvh = h / (H / KV);
  const int q0 = qb * RQ * kTile;
  const size_t qs = (size_t)H * DH, ks = (size_t)KV * DH;

  load_rows_upto<DH>(sQ, q + ((size_t)b * Sq + q0) * qs + (size_t)h * DH,
                     qs, RQ * kTile, Sq - q0, HOIST ? sm_scale : 1.f);
  float acc[RQ][4][NG][VW];
  float m[RQ][4], l[RQ][4];
#pragma unroll
  for (int r = 0; r < RQ; ++r)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      m[r][i] = kNegInf;
      l[r][i] = 0.f;
#pragma unroll
      for (int g = 0; g < NG; ++g)
#pragma unroll
        for (int e = 0; e < VW; ++e) acc[r][i][g][e] = 0.f;
    }

  // keys past the CTA's last live q row are all masked when causal
  const int q_end = min(q0 + RQ * kTile, Sq);
  const int k_end = causal ? min(Sk, q_end) : Sk;
  for (int s0 = 0; s0 < k_end; s0 += block_k) {
    const int rows = min(block_k, (k_end - s0 + kTile - 1) / kTile * kTile);
    __syncthreads();  // the previous stage's readers are done
    const size_t koff = ((size_t)b * Sk + s0) * ks + (size_t)kvh * DH;
    load_rows_upto<DH>(sK, k + koff, ks, rows, Sk - s0, 1.f);
    load_rows_upto<DH>(sV, v + koff, ks, rows, Sk - s0, 1.f);
    __syncthreads();
    for (int c0 = 0; c0 < rows; c0 += kTile) {
      const int k0 = s0 + c0;
#pragma unroll
      for (int r = 0; r < RQ; ++r) {
        const int qr = q0 + r * kTile;
        // uniform across the CTA: a dead q tile, or one the mask empties
        if (qr >= Sq || (causal && k0 > qr + kTile - 1)) continue;
        float sc[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) sc[i][j] = 0.f;
        dot_tile<DH>(sQ + r * kTile * LD, tr, sK + c0 * LD, tc, sc);

        const bool edge = k0 + kTile > Sk || (causal && k0 + kTile - 1 > qr);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int qp = qr + tr + 16 * i;
          float mx = kNegInf;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int kp = k0 + tc + 16 * j;
            float sv = HOIST ? sc[i][j] : sc[i][j] * sm_scale;
            if (edge && (kp >= Sk || (causal && qp < kp))) sv = kNegInf;
            sc[i][j] = sv;
            mx = fmaxf(mx, sv);
          }
          mx = row_max(mx);
          const float m_new = fmaxf(m[r][i], mx);
          float sum = 0.f;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const float p = m_new <= kNegInf ? 0.f : expf(sc[i][j] - m_new);
            sP[(tr + 16 * i) * kLP + tc + 16 * j] = p;
            sum += p;
          }
          sum = row_sum(sum);
          const float corr = expf(m[r][i] - m_new);
          l[r][i] = l[r][i] * corr + sum;
          m[r][i] = m_new;
#pragma unroll
          for (int g = 0; g < NG; ++g)
#pragma unroll
            for (int e = 0; e < VW; ++e) acc[r][i][g][e] *= corr;
        }
        __syncthreads();  // the probability tile is written
        acc_tile<DH>(sP, tr, sV + c0 * LD, tc, acc[r]);
        __syncthreads();  // and read, before the next tile overwrites it
      }
    }
  }

#pragma unroll
  for (int r = 0; r < RQ; ++r)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + r * kTile + tr + 16 * i;
      if (row >= Sq) continue;
      const float den = fmaxf(l[r][i], 1e-30f);
      T* orow = out + ((size_t)b * Sq + row) * qs + (size_t)h * DH;
#pragma unroll
      for (int g = 0; g < NG; ++g)
#pragma unroll
        for (int e = 0; e < VW; ++e)
          orow[Sh::col(g, tc) + e] = from_f32<T>(acc[r][i][g][e] / den);
      if (lse != nullptr && tc == 0)
        lse[((size_t)b * H + h) * Sq + row] =
            l[r][i] > 0.f ? m[r][i] + logf(fmaxf(l[r][i], 1e-30f)) : 0.f;
    }
}

template <typename T, int DH, int RQ, bool HOIST>
int launch(const void* q, const void* k, const void* v, void* out, void* lse,
           int B, int Sq, int Sk, int H, int KV, int block_k, int causal,
           float sm_scale, cudaStream_t stream) {
  const size_t smem = fwd_smem_bytes<DH>(RQ * kTile, block_k);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, DH, RQ, HOIST>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int nqb = (Sq + RQ * kTile - 1) / (RQ * kTile);
  const unsigned grid = (unsigned)B * nqb * H;
  flash_fwd_kernel<T, DH, RQ, HOIST><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out),
      static_cast<float*>(lse), Sq, Sk, H, KV, nqb, block_k, causal,
      sm_scale);
  return (int)cudaGetLastError();
}

template <typename T, int DH>
int launch_rq(int block_q, int hoist, const void* q, const void* k,
              const void* v, void* out, void* lse, int B, int Sq, int Sk,
              int H, int KV, int block_k, int causal, float sm_scale,
              cudaStream_t st) {
  if (block_q == kTile)
    return hoist ? launch<T, DH, 1, true>(q, k, v, out, lse, B, Sq, Sk, H,
                                          KV, block_k, causal, sm_scale, st)
                 : launch<T, DH, 1, false>(q, k, v, out, lse, B, Sq, Sk, H,
                                           KV, block_k, causal, sm_scale, st);
  if (block_q == 2 * kTile)
    return hoist ? launch<T, DH, 2, true>(q, k, v, out, lse, B, Sq, Sk, H,
                                          KV, block_k, causal, sm_scale, st)
                 : launch<T, DH, 2, false>(q, k, v, out, lse, B, Sq, Sk, H,
                                           KV, block_k, causal, sm_scale, st);
  return (int)cudaErrorInvalidValue;
}

template <typename T>
int launch_dh(int dh, int block_q, int hoist, const void* q, const void* k,
              const void* v, void* out, void* lse, int B, int Sq, int Sk,
              int H, int KV, int block_k, int causal, float sm_scale,
              cudaStream_t st) {
  switch (dh) {
    case 32:
      return launch_rq<T, 32>(block_q, hoist, q, k, v, out, lse, B, Sq, Sk,
                              H, KV, block_k, causal, sm_scale, st);
    case 64:
      return launch_rq<T, 64>(block_q, hoist, q, k, v, out, lse, B, Sq, Sk,
                              H, KV, block_k, causal, sm_scale, st);
    case 128:
      return launch_rq<T, 128>(block_q, hoist, q, k, v, out, lse, B, Sq, Sk,
                               H, KV, block_k, causal, sm_scale, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace
}  // namespace flash

extern "C" {

// dtype: 0 = float32 (bfloat16 is flash_attention_fwd_sm90's). q
// (B,Sq,H,Dh), k/v (B,Sk,KV,Dh), out like q, all contiguous and 16-byte
// aligned; lse (B*H,Sq) fp32 or NULL.
// Takes Dh in {32, 64, 128}, block_q in {64, 128}, block_k a positive
// multiple of 64 whose tiles fit shared memory. Returns the CUDA error
// code of the launch (0 = launched).
int flash_attention_fwd(const void* q, const void* k, const void* v,
                        void* out, void* lse, int dtype, int B, int Sq,
                        int Sk, int H, int KV, int dh, int block_q,
                        int block_k, int causal, int hoist, float sm_scale,
                        void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (block_k <= 0 || block_k % flash::kTile || Sq <= 0 || Sk <= 0)
    return (int)cudaErrorInvalidValue;
  if (dtype != 0) return (int)cudaErrorInvalidValue;
  return flash::launch_dh<float>(dh, block_q, hoist, q, k, v, out, lse, B,
                                 Sq, Sk, H, KV, block_k, causal, sm_scale,
                                 st);
}

}  // extern "C"
