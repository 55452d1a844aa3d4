// Dense flash attention dQ on Hopper's tensor cores (sm_90a), for bf16 q,
// k, v and dO.
//
// Replaces the TPU kernel `_flash_dq_kernel` in
// src/repro/kernels/flash_attention.py for bf16 inputs; fp32 inputs stay
// on `flash_dq_kernel` in flash_attention_bwd.cu, on CUDA cores (TF32
// would not meet their tolerances). It computes that kernel's function
// and `kernels/ref.py` `flash_bwd_dq`: with the forward's logsumexp `lse`
// and `delta = rowsum(dO * O)` (both (B*H, Sq) fp32, from the caller),
// for every q row of one q head
//   p  = exp(s - lse),  s = (q . k) Dh^-0.5,
//   ds = p (dO . v - delta),  dq = Dh^-0.5 sum over keys of ds k,
// with p = 0 on the ragged k tail and, when causal, where qpos < kpos.
// dQ is (B, Sq, H, Dh) bf16; k and v are read through GQA (kv head
// h / (H / KV)).
//
// The scores are rebuilt as flash_attention_fwd_sm90.cu built them, whose
// lse is their reference: the fp32 product times Dh^-0.5 log2(e) inside
// one exp2 argument, for both values of `hoist_scale` (q Dh^-0.5 is no
// bf16 value, so the scale never goes onto the q tile; it differs from
// the plain `(q * scale) . k` by fp32 rounding alone). dQ is multiplied
// by the scale in fp32 before its one rounding to bf16.
//
// What bounds it on the card. At the Qwen3-0.6B training shape (S=16384,
// 16 q heads over 8, Dh 128, causal: 1.342e8 score entries a head) it does
// 6 * 1.342e8 * 128 * 16 = 1.65 TFLOP (1.67 ms at the bf16 tensor-core
// peak) against ~0.2 GB of operands: bound by operations.
//
// What this design does about it. flash_attention_bwd_dkv_sm90.cu turned
// around:
// * One CTA per (b, q head h, q-block of 128 rows): two consumer
//   warpgroups own 64 q rows each, with Q and dO resident in shared
//   memory and each thread's lse and delta (two rows) in registers, read
//   by plain loads (a row of (B*H, Sq) starts on no 16-byte boundary when
//   Sq % 4 != 0, which TMA does not take); a producer warp streams k and
//   v by TMA through a ring of two stages of 64 key rows, each stage with
//   a full and an empty barrier.
// * Per stage and consumer warpgroup: S = Q K^T and dP = dO V^T by
//   `wgmma` m64n64k16 from shared memory (K-major, fp32 accumulators); P
//   and dS = P (dP - delta) on the accumulators' register layout; then
//   dQ += dS K by `wgmma` with A = dS from registers in bf16 and K read
//   MN-major from the same tile, as the forward reads V for P V. dQ is
//   held norm-relative to 1e-2, which a bf16 dS meets: no split here.
//   The stage body and the epilogue are sm90_tiles.cuh's `dq_stage` and
//   `store_scaled`, shared with the sparse dQ of
//   cluster_attention_unbiased_bwd_sm90.cu.
// * When causal, each warpgroup stops at its diagonal stage and the
//   heaviest q-blocks come first in the grid; only stages on the diagonal
//   or the ragged k tail are masked.
// * Registers: the 64 x Dh fp32 dQ and the 64 x 64 S and dP, 128 a
//   thread at Dh 128: the producer gives registers up (`setmaxnreg` 24)
//   and the consumers take 240. Shared memory at Dh 128: Q and dO 64 KB,
//   two stages of 32 KB.

#include "sm90_tiles.cuh"

namespace flash_sm90 {
namespace {

using bf16 = __nv_bfloat16;

constexpr int kRows = 64;     // q rows of one consumer warpgroup
constexpr int kBlock = 128;   // q rows of one CTA
constexpr int kKRows = sm90::kStage;  // k rows of one stage
constexpr int kStages = 2;
constexpr int kThreads = 384;

template <int DH>
struct DqCfg : sm90::Atom<DH> {
  static constexpr int Q_BYTES = kBlock * DH * 2;    // resident q (or dO)
  static constexpr int TILE = kKRows * DH * 2;       // a stage's k (or v)
  static constexpr int STAGE = 2 * TILE;             // k, then v
  // q, dO, the ring, 1 + 2 kStages barriers, and slack to align to 1024
  static constexpr int SMEM = 2 * Q_BYTES + kStages * STAGE + 1024 + 1024;
};

template <int DH>
__global__ void __launch_bounds__(kThreads, 1)
dq_kernel(const __grid_constant__ CUtensorMap tq,
          const __grid_constant__ CUtensorMap tk,
          const __grid_constant__ CUtensorMap tv,
          const __grid_constant__ CUtensorMap tdo,
          const float* __restrict__ lse, const float* __restrict__ delta,
          bf16* __restrict__ dq, int Sq, int Sk, int H, int KV, int nqb,
          int causal, float c2, float sm_scale) {
  using C = DqCfg<DH>;
  constexpr int SWB = C::SWB;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sQ = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* sDO = sQ + C::Q_BYTES;
  uint8_t* sStage = sDO + C::Q_BYTES;
  uint64_t* bars =
      reinterpret_cast<uint64_t*>(sStage + kStages * C::STAGE);
  uint64_t* full_q = bars;
  uint64_t* full = bars + 1;
  uint64_t* empty = full + kStages;

  int x = blockIdx.x;
  const int h = x % H;
  x /= H;
  const int qb = nqb - 1 - x % nqb;  // the longest causal rows first
  const int b = x / nqb;
  const int kvh = h / (H / KV);
  const int q0 = qb * kBlock;
  // keys past the CTA's last live q row are all masked when causal
  const int k_end = causal ? min(Sk, min(q0 + kBlock, Sq)) : Sk;
  const int n_stages = (k_end + kKRows - 1) / kKRows;

  const int tid = threadIdx.x, wg = tid / 128;
  if (tid == 0) {
    sm90::mbar_init(full_q, 1);
    for (int s = 0; s < kStages; ++s) {
      sm90::mbar_init(full + s, 1);
      sm90::mbar_init(empty + s, 8);  // one arrival per consumer warp
    }
    sm90::fence_barrier_init();
  }
  __syncthreads();

  if (wg == 2) {
    // ------------------------------------------------------- producer
    sm90::regs_dealloc<24>();
    if (tid == 256) {
      sm90::mbar_expect_tx(full_q, 2 * C::Q_BYTES);
      for (int a = 0; a < C::NATOM; ++a) {
        sm90::tma_load_4d(sQ + a * kBlock * SWB, &tq, full_q, a * C::SWE, h,
                          q0, b);
        sm90::tma_load_4d(sDO + a * kBlock * SWB, &tdo, full_q, a * C::SWE,
                          h, q0, b);
      }
      for (int n = 0; n < n_stages; ++n) {
        const int s = n % kStages;
        if (n >= kStages) sm90::mbar_wait(empty + s, (n / kStages - 1) & 1);
        uint8_t* st = sStage + s * C::STAGE;
        sm90::mbar_expect_tx(full + s, C::STAGE);
        for (int a = 0; a < C::NATOM; ++a) {
          sm90::tma_load_4d(st + a * kKRows * SWB, &tk, full + s, a * C::SWE,
                            kvh, n * kKRows, b);
          sm90::tma_load_4d(st + C::TILE + a * kKRows * SWB, &tv, full + s,
                            a * C::SWE, kvh, n * kKRows, b);
        }
      }
    }
  } else {
    // ------------------------------------------------------- consumers
    sm90::regs_alloc<240>();
    const int t = tid % 128, warp = t / 32, lane = t % 32;
    const int r0 = q0 + wg * kRows;                 // the warpgroup's rows
    const int row = r0 + warp * 16 + lane / 4;      // and this thread's:
    const int col = 2 * (lane % 4);                 // row, row + 8
    const bool live = r0 < Sq;
    const int wk_end = causal ? min(Sk, min(r0 + kRows, Sq)) : Sk;
    const uint8_t* myq = sQ + wg * kRows * SWB;
    const uint8_t* mydo = sDO + wg * kRows * SWB;

    // lse (base 2) and delta of the thread's rows; a padded row's p is
    // exp2(0) against zero dO and delta, so its dS is 0
    float lse2[2], dl[2];
    const size_t row0 = ((size_t)b * H + h) * Sq;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = row + 8 * i;
      lse2[i] = r < Sq ? lse[row0 + r] * sm90::kLog2e : 0.f;
      dl[i] = r < Sq ? delta[row0 + r] : 0.f;
    }
    float acc[DH / 2];
#pragma unroll
    for (int i = 0; i < DH / 2; ++i) acc[i] = 0.f;

    sm90::mbar_wait(full_q, 0);
    for (int n = 0; n < n_stages; ++n) {
      const int s = n % kStages, k0 = n * kKRows;
      const uint8_t* sk = sStage + s * C::STAGE;
      const uint8_t* sv = sk + C::TILE;
      // every consumer waits for the stage before it hands it back, even
      // one it skips (see flash_attention_fwd_sm90.cu)
      sm90::mbar_wait(full + s, (n / kStages) & 1);
      if (live && k0 < wk_end)  // uniform over the warpgroup
        sm90::dq_stage<DH, SWB>(
            acc, myq, mydo, kBlock, sk, sv, lse2, dl, c2, col,
            k0 + kKRows > Sk || (causal && k0 + kKRows - 1 > r0),
            [&](int kc, int i) {
              const int kp = k0 + kc;
              return kp >= Sk || (causal && kp > row + 8 * i);
            });
      __syncwarp();
      if (lane == 0) sm90::mbar_arrive(empty + s);
    }

    sm90::store_scaled<DH>(acc, dq, b, h, H, Sq, row, col, sm_scale);
  }
}

template <int DH>
int launch(const void* q, const void* k, const void* v, const void* dout,
           const void* lse, const void* delta, void* dq, int B, int Sq,
           int Sk, int H, int KV, int causal, float sm_scale,
           cudaStream_t stream) {
  using C = DqCfg<DH>;
  CUtensorMap tq, tk, tv, tdo;
  int err = sm90::encode_rows(&tq, q, B, Sq, H, DH, kBlock, C::SWB);
  if (!err) err = sm90::encode_rows(&tdo, dout, B, Sq, H, DH, kBlock, C::SWB);
  if (!err) err = sm90::encode_rows(&tk, k, B, Sk, KV, DH, kKRows, C::SWB);
  if (!err) err = sm90::encode_rows(&tv, v, B, Sk, KV, DH, kKRows, C::SWB);
  if (err) return err;
  cudaError_t e = cudaFuncSetAttribute(
      dq_kernel<DH>, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (e != cudaSuccess) return (int)e;
  const int nqb = (Sq + kBlock - 1) / kBlock;
  const unsigned grid = (unsigned)B * nqb * H;
  dq_kernel<DH><<<grid, kThreads, C::SMEM, stream>>>(
      tq, tk, tv, tdo, static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<bf16*>(dq), Sq, Sk, H,
      KV, nqb, causal, sm_scale * sm90::kLog2e, sm_scale);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace flash_sm90

extern "C" {

// The bf16 dQ: q, dout, dq (B,Sq,H,Dh); k/v (B,Sk,KV,Dh), all bf16,
// contiguous and 16-byte aligned; lse, delta (B*H,Sq) fp32. Takes Dh in
// {32, 64, 128}. It takes no `hoist` flag: both values compute the same
// thing here (see the header). Returns the CUDA error code of the launch
// (0 = launched).
int flash_attention_bwd_dq_sm90(const void* q, const void* k, const void* v,
                                const void* dout, const void* lse,
                                const void* delta, void* dq, int B, int Sq,
                                int Sk, int H, int KV, int dh, int causal,
                                float sm_scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (Sq <= 0 || Sk <= 0) return (int)cudaErrorInvalidValue;
  switch (dh) {
    case 32:
      return flash_sm90::launch<32>(q, k, v, dout, lse, delta, dq, B, Sq, Sk,
                                    H, KV, causal, sm_scale, st);
    case 64:
      return flash_sm90::launch<64>(q, k, v, dout, lse, delta, dq, B, Sq, Sk,
                                    H, KV, causal, sm_scale, st);
    case 128:
      return flash_sm90::launch<128>(q, k, v, dout, lse, delta, dq, B, Sq,
                                     Sk, H, KV, causal, sm_scale, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
