// Dense flash attention forward on Hopper's tensor cores (sm_90a), for
// bf16 q, k and v: the online softmax, the optional causal mask, GQA and
// ragged sequence tails.
//
// Replaces the TPU kernel `_flash_kernel` in
// src/repro/kernels/flash_attention.py (the GP-FLASH baseline) for bf16
// inputs; fp32 inputs stay on flash_attention_fwd.cu, on CUDA cores,
// because TF32 would not meet their tolerances. It computes the same
// function as that kernel and `kernels/ref.py` `flash_fwd`: scores
// `(q . k) Dh^-0.5` in fp32, -inf where `kpos >= Sk` or, when causal,
// where `qpos < kpos`, an online softmax in fp32, O in bf16 and the
// logsumexp `lse` (B*H, Sq) in fp32; a row with no unmasked key writes
// O = 0 and lse = 0.
//
// `hoist_scale`. The reference rewrite multiplies q by Dh^-0.5 before the
// product. q Dh^-0.5 is no bf16 value, so the tensor cores cannot take
// the scaled tile; this kernel applies the scale to the fp32 scores
// instead, folded with log2(e) into the one exp2 argument. That differs
// from the plain `(q * scale) . k` by fp32 rounding alone, so both values
// of the flag launch this kernel and compute the same thing.
//
// What bounds it on the card. At the Qwen3-0.6B training shape (S=16384,
// 16 q heads over 8 KV heads, Dh 128, causal) the causal score entries
// are 1.342e8 per head: 4 * 1.342e8 * 128 * 16 = 1.10 TFLOP, 1.11 ms at
// the bf16 tensor-core peak, against ~0.2 GB of q, k, v, O and lse
// (0.06 ms at 3.35 TB/s): bound by operations.
//
// What this design does about it.
// * One CTA per (b, h, q-block of block_q = 64 x NWG rows), NWG = 1 or 2
//   consumer warpgroups of 64 q rows each, plus one producer warpgroup
//   whose first thread issues every copy. The q-blocks run heaviest
//   first (the causal rows that see the most keys).
// * Copies are TMA: q once, then k and v in stages of block_k rows
//   through a ring of two stages in shared memory, each with its own
//   full barriers (k and v apart, so the scores start before v lands)
//   and an empty barrier the consumers arrive on. Stages past the CTA's
//   diagonal are never loaded.
// * Per stage and consumer warpgroup, in chunks of BN = min(block_k, 128)
//   keys: S = Q K^T by `wgmma` m64nBNk16 from shared memory (bf16 in,
//   fp32 accumulate; registers do not grow with block_k); the online
//   softmax on the accumulator's register layout (the four threads of a
//   row reduce with two shuffles; scale * log2 e folds into one exp2
//   argument); O += P V by `wgmma` with P from registers. The softmax,
//   P V and the epilogue are sm90_tiles.cuh's, shared with the cluster
//   forward (cluster_attention_unbiased_fwd_sm90.cu).
// * The P split. The port's check holds bf16 O element by element within
//   1e-5 + 2^-7 |O| of the plain version, which a P rounded once to bf16
//   misses where O cancels near 0. So P = P_hi + P_lo and two
//   register-operand `wgmma`s accumulate into the same O
//   (`sm90::softmax_chunk`): 1.5x the tensor-core work of the function,
//   an error near 2^-17.
// * Only the chunks on the causal diagonal or the ragged tail are masked.
//   Shared memory: 64 NWG Dh + 2 stages x 2 block_k Dh bf16 values, e.g.
//   160 KB at Dh 128, block_q = block_k = 128
//   (kernels/flash_attention.py `check_launch` states what fits).

#include "sm90_tiles.cuh"

namespace flash_sm90 {
namespace {

using bf16 = __nv_bfloat16;

constexpr int kRows = 64;    // q rows of one consumer warpgroup
constexpr int kStages = 2;   // k/v stages in the ring

template <int DH, int NWG, int BK>
struct Cfg : sm90::Atom<DH> {
  static constexpr int BQ = kRows * NWG;
  static constexpr int BN = BK < 128 ? BK : 128;   // keys a score chunk
  static constexpr int Q_BYTES = BQ * DH * 2;
  static constexpr int KV_BYTES = BK * DH * 2;     // k (or v) of a stage
  static constexpr int THREADS = 128 * (NWG + 1);
  // q, the ring, 1 + 3 kStages barriers, and slack to align to 1024
  static constexpr int SMEM =
      Q_BYTES + 2 * kStages * KV_BYTES + 1024 + 1024;
};

template <int DH, int NWG, int BK>
__global__ void __launch_bounds__(Cfg<DH, NWG, BK>::THREADS, 1)
fwd_kernel(const __grid_constant__ CUtensorMap tq,
           const __grid_constant__ CUtensorMap tk,
           const __grid_constant__ CUtensorMap tv, bf16* __restrict__ out,
           float* __restrict__ lse, int Sq, int Sk, int H, int KV, int nqb,
           int causal, float c2) {
  using C = Cfg<DH, NWG, BK>;
  constexpr int SWB = C::SWB, BN = C::BN;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sQ = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* sKV = sQ + C::Q_BYTES;  // stage s: k, then v
  uint64_t* bars = reinterpret_cast<uint64_t*>(sKV + 2 * kStages *
                                               C::KV_BYTES);
  uint64_t* full_q = bars;
  uint64_t* full_k = bars + 1;
  uint64_t* full_v = full_k + kStages;
  uint64_t* empty = full_v + kStages;

  int x = blockIdx.x;
  const int h = x % H;
  x /= H;
  const int qb = nqb - 1 - x % nqb;  // the longest causal rows first
  const int b = x / nqb;
  const int kvh = h / (H / KV);
  const int q0 = qb * C::BQ;
  const int q_end = min(q0 + C::BQ, Sq);
  // keys past the CTA's last live q row are all masked when causal
  const int k_end = causal ? min(Sk, q_end) : Sk;
  const int n_stages = (k_end + BK - 1) / BK;

  const int tid = threadIdx.x, wg = tid / 128;
  if (tid == 0) {
    sm90::mbar_init(full_q, 1);
    for (int s = 0; s < kStages; ++s) {
      sm90::mbar_init(full_k + s, 1);
      sm90::mbar_init(full_v + s, 1);
      sm90::mbar_init(empty + s, NWG * 4);  // one arrival per warp
    }
    sm90::fence_barrier_init();
  }
  __syncthreads();

  if (wg == NWG) {
    // ------------------------------------------------------- producer
    if constexpr (NWG == 2) sm90::regs_dealloc<24>();
    if (tid == NWG * 128) {
      sm90::mbar_expect_tx(full_q, C::Q_BYTES);
      for (int a = 0; a < C::NATOM; ++a)
        sm90::tma_load_4d(sQ + a * C::BQ * SWB, &tq, full_q, a * C::SWE, h,
                          q0, b);
      for (int n = 0; n < n_stages; ++n) {
        const int s = n % kStages;
        if (n >= kStages) sm90::mbar_wait(empty + s, (n / kStages - 1) & 1);
        uint8_t* sk = sKV + 2 * s * C::KV_BYTES;
        uint8_t* sv = sk + C::KV_BYTES;
        sm90::mbar_expect_tx(full_k + s, C::KV_BYTES);
        for (int a = 0; a < C::NATOM; ++a)
          sm90::tma_load_4d(sk + a * BK * SWB, &tk, full_k + s, a * C::SWE,
                            kvh, n * BK, b);
        sm90::mbar_expect_tx(full_v + s, C::KV_BYTES);
        for (int a = 0; a < C::NATOM; ++a)
          sm90::tma_load_4d(sv + a * BK * SWB, &tv, full_v + s, a * C::SWE,
                            kvh, n * BK, b);
      }
    }
  } else {
    // ------------------------------------------------------- consumers
    if constexpr (NWG == 2) sm90::regs_alloc<240>();
    const int t = tid % 128, warp = t / 32, lane = t % 32;
    const int r0 = q0 + wg * kRows;                 // the warpgroup's rows
    const int row = r0 + warp * 16 + lane / 4;      // and this thread's:
    const int col = 2 * (lane % 4);                 // row, row + 8
    const bool live = r0 < Sq;
    const int wk_end = causal ? min(Sk, min(r0 + kRows, Sq)) : Sk;
    const uint8_t* myq = sQ + wg * kRows * SWB;

    float o[DH / 2];
#pragma unroll
    for (int i = 0; i < DH / 2; ++i) o[i] = 0.f;
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

    sm90::mbar_wait(full_q, 0);
    for (int n = 0; n < n_stages; ++n) {
      const int s = n % kStages;
      const uint32_t par = (n / kStages) & 1;
      const uint8_t* sk = sKV + 2 * s * C::KV_BYTES;
      const uint8_t* sv = sk + C::KV_BYTES;
      // every consumer waits for every copy of the stage before it hands
      // the stage back, even one it skips: an arrival on `empty` then
      // never counts toward an earlier use of the slot
      sm90::mbar_wait(full_k + s, par);
      bool have_v = false;
      for (int c = 0; c < BK / BN; ++c) {
        const int k0 = n * BK + c * BN;
        if (!live || k0 >= wk_end) continue;  // uniform over the group

        // S = Q K^T over Dh, fp32
        float sc[BN / 2];
        sm90::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < DH / 16; ++kk)
          sm90::ss<BN>(sc, sm90::desc_k<SWB>(myq, C::BQ, kk * 16),
                       sm90::desc_k<SWB>(sk + c * BN * SWB, BK, kk * 16),
                       kk > 0);
        sm90::wgmma_commit();
        sm90::wgmma_wait<0>();
        sm90::fence_acc(sc);

        // masks on the diagonal and the ragged tail; the online softmax
        const bool edge = k0 + BN > Sk || (causal && k0 + BN - 1 > r0);
        uint32_t phi[BN / 16][4], plo[BN / 16][4];
        sm90::softmax_chunk<BN, DH>(
            sc, o, m, l, c2, col, edge,
            [&](int kc, int i) {
              return k0 + kc >= Sk || (causal && k0 + kc > row + 8 * i);
            },
            phi, plo);

        // O += P_hi V + P_lo V
        if (!have_v) {
          sm90::mbar_wait(full_v + s, par);
          have_v = true;
        }
        sm90::pv_split<BN, DH, SWB>(o, phi, plo, sv, BK, c * BN);
      }
      if (!have_v) sm90::mbar_wait(full_v + s, par);
      // the stage's k and v are read: hand it back to the producer
      __syncwarp();
      if (lane == 0) sm90::mbar_arrive(empty + s);
    }

    sm90::store_rows<DH>(o, m, l, out, lse, b, h, H, Sq, row, col);
  }
}

template <int DH, int NWG, int BK>
int launch(const void* q, const void* k, const void* v, void* out, void* lse,
           int B, int Sq, int Sk, int H, int KV, int causal, float sm_scale,
           cudaStream_t stream) {
  using C = Cfg<DH, NWG, BK>;
  CUtensorMap tq, tk, tv;
  int err = sm90::encode_rows(&tq, q, B, Sq, H, DH, C::BQ, C::SWB);
  if (!err) err = sm90::encode_rows(&tk, k, B, Sk, KV, DH, BK, C::SWB);
  if (!err) err = sm90::encode_rows(&tv, v, B, Sk, KV, DH, BK, C::SWB);
  if (err) return err;
  cudaError_t e = cudaFuncSetAttribute(
      fwd_kernel<DH, NWG, BK>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      C::SMEM);
  if (e != cudaSuccess) return (int)e;
  const int nqb = (Sq + C::BQ - 1) / C::BQ;
  const unsigned grid = (unsigned)B * nqb * H;
  fwd_kernel<DH, NWG, BK><<<grid, C::THREADS, C::SMEM, stream>>>(
      tq, tk, tv, static_cast<bf16*>(out), static_cast<float*>(lse), Sq, Sk,
      H, KV, nqb, causal, sm_scale * sm90::kLog2e);
  return (int)cudaGetLastError();
}

template <int DH, int NWG>
int launch_bk(int block_k, const void* q, const void* k, const void* v,
              void* out, void* lse, int B, int Sq, int Sk, int H, int KV,
              int causal, float sm_scale, cudaStream_t st) {
  switch (block_k) {
    case 64:
      return launch<DH, NWG, 64>(q, k, v, out, lse, B, Sq, Sk, H, KV,
                                 causal, sm_scale, st);
    case 128:
      return launch<DH, NWG, 128>(q, k, v, out, lse, B, Sq, Sk, H, KV,
                                  causal, sm_scale, st);
    case 256:
      // two stages of 256 k and v rows do not fit at Dh 128
      if constexpr (DH < 128)
        return launch<DH, NWG, 256>(q, k, v, out, lse, B, Sq, Sk, H, KV,
                                    causal, sm_scale, st);
      return (int)cudaErrorInvalidValue;
    default:
      return (int)cudaErrorInvalidValue;
  }
}

template <int DH>
int launch_bq(int block_q, int block_k, const void* q, const void* k,
              const void* v, void* out, void* lse, int B, int Sq, int Sk,
              int H, int KV, int causal, float sm_scale, cudaStream_t st) {
  if (block_q == kRows)
    return launch_bk<DH, 1>(block_k, q, k, v, out, lse, B, Sq, Sk, H, KV,
                            causal, sm_scale, st);
  if (block_q == 2 * kRows)
    return launch_bk<DH, 2>(block_k, q, k, v, out, lse, B, Sq, Sk, H, KV,
                            causal, sm_scale, st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace
}  // namespace flash_sm90

extern "C" {

// The bf16 forward: q (B,Sq,H,Dh), k/v (B,Sk,KV,Dh), out like q, all
// bf16, contiguous and 16-byte aligned; lse (B*H,Sq) fp32 or NULL. Takes
// Dh in {32, 64, 128}, block_q in {64, 128}, block_k in {64, 128, 256}
// (not 256 at Dh 128). It takes no `hoist` flag: both values compute the
// same thing here (see the header). Returns the CUDA error code of the
// launch (0 = launched).
int flash_attention_fwd_sm90(const void* q, const void* k, const void* v,
                             void* out, void* lse, int B, int Sq, int Sk,
                             int H, int KV, int dh, int block_q, int block_k,
                             int causal, float sm_scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (Sq <= 0 || Sk <= 0) return (int)cudaErrorInvalidValue;
  switch (dh) {
    case 32:
      return flash_sm90::launch_bq<32>(block_q, block_k, q, k, v, out, lse,
                                       B, Sq, Sk, H, KV, causal, sm_scale,
                                       st);
    case 64:
      return flash_sm90::launch_bq<64>(block_q, block_k, q, k, v, out, lse,
                                       B, Sq, Sk, H, KV, causal, sm_scale,
                                       st);
    case 128:
      return flash_sm90::launch_bq<128>(block_q, block_k, q, k, v, out,
                                        lse, B, Sq, Sk, H, KV, causal,
                                        sm_scale, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
