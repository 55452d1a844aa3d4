// Dense flash attention dK/dV on Hopper's tensor cores (sm_90a), for
// bf16 q, k, v and dO.
//
// Replaces the TPU kernel `_flash_dkv_kernel` in
// src/repro/kernels/flash_attention.py for bf16 inputs; fp32 inputs stay
// on `flash_dkv_kernel` in flash_attention_bwd.cu, on CUDA cores (TF32
// would not meet their tolerances). It computes that kernel's function
// and `kernels/ref.py` `flash_bwd_dkv`: with the forward's logsumexp
// `lse` and `delta = rowsum(dO * O)` (both (B*H, Sq) fp32, from the
// caller), for every key row of one q head
//   p  = exp(s - lse),  s = (q . k) Dh^-0.5,
//   dv = sum over q rows of p dO,  dk = Dh^-0.5 sum of p (dO . v - delta) q,
// with p = 0 on q rows past Sq, on the ragged k tail and, when causal,
// where qpos < kpos. dK and dV are per q head, (B, Sk, H, Dh) bf16; the
// GQA group sum is the caller's.
//
// The scores are rebuilt as flash_attention_fwd_sm90.cu built them, whose
// lse is their reference: the fp32 product times Dh^-0.5 log2(e) inside
// one exp2 argument, for both values of `hoist_scale` (q Dh^-0.5 is no
// bf16 value, so the scale never goes onto the q tile; it differs from
// the plain `(q * scale) . k` by fp32 rounding alone). dK is multiplied
// by the scale in fp32 before its one rounding to bf16.
//
// What bounds it on the card. At the Qwen3-0.6B training shape (S=16384,
// 16 q heads over 8, Dh 128, causal: 1.342e8 score entries a head) it does
// 8 * 1.342e8 * 128 * 16 = 2.20 TFLOP (2.22 ms at the bf16 tensor-core
// peak) against ~0.3 GB of operands: bound by operations.
//
// What this design does about it.
// * One CTA per (b, q head h, k-block of 128 rows): two consumer
//   warpgroups own 64 k rows each, with K and V resident in shared memory;
//   a producer warp streams q and dO by TMA (its first thread) and lse
//   and delta by plain loads (a row of (B*H, Sq) starts on no 16-byte
//   boundary when Sq % 4 != 0, which TMA does not take) through a ring of
//   two stages of 64 q rows, each stage with a full and an empty
//   barrier.
// * Per stage and consumer warpgroup: S^T = K Q^T and dP^T = V dO^T by
//   `wgmma` m64n64k16 from shared memory (fp32 accumulators); P^T and
//   dS^T = P^T (dP^T - delta) on the accumulators' register layout; then
//   dV += P^T dO and dK += dS^T Q by `wgmma` with A from registers in bf16
//   (q and dO read MN-major from the same tiles). The gradients are held
//   norm-relative to 1e-2, which a bf16 P^T and dS^T meet: no split here.
//   The stage body and the epilogue are sm90_tiles.cuh's `dkv_stage` and
//   `store_scaled`, shared with the sparse dK/dV of
//   cluster_attention_unbiased_bwd_sm90.cu.
// * When causal, a k-block starts at its diagonal stage and the
//   heaviest k-blocks come first in the grid; only stages on the diagonal
//   or a ragged edge are masked.
// * Registers: two 64 x Dh fp32 accumulators (dK, dV) and the 64 x 64
//   S^T and dP^T, 192 a thread at Dh 128: the producer gives registers up
//   (`setmaxnreg` 24) and the consumers take 240. Shared memory at
//   Dh 128: K and V 64 KB, two stages of 33 KB.

#include "sm90_tiles.cuh"

namespace flash_sm90 {
namespace {

using bf16 = __nv_bfloat16;

constexpr int kRows = 64;     // k rows of one consumer warpgroup
constexpr int kBlock = 128;   // k rows of one CTA
constexpr int kQRows = sm90::kStage;  // q rows of one stage
constexpr int kStages = 2;
constexpr int kThreads = 384;

template <int DH>
struct DkvCfg : sm90::Atom<DH> {
  static constexpr int KV_BYTES = kBlock * DH * 2;   // resident k (or v)
  static constexpr int TILE = kQRows * DH * 2;       // a stage's q (or dO)
  static constexpr int STAGE = 2 * TILE + 1024;      // q, dO, lse, delta
  static constexpr int TX = 2 * TILE;                // bytes TMA lands
  // k, v, the ring, 1 + 2 kStages barriers, and slack to align to 1024
  static constexpr int SMEM =
      2 * KV_BYTES + kStages * STAGE + 1024 + 1024;
};

template <int DH>
__global__ void __launch_bounds__(kThreads, 1)
dkv_kernel(const __grid_constant__ CUtensorMap tq,
           const __grid_constant__ CUtensorMap tk,
           const __grid_constant__ CUtensorMap tv,
           const __grid_constant__ CUtensorMap tdo,
           const float* __restrict__ lse, const float* __restrict__ delta,
           bf16* __restrict__ dk, bf16* __restrict__ dv, int Sq, int Sk,
           int H, int KV, int nkb, int causal, float c2, float sm_scale) {
  using C = DkvCfg<DH>;
  constexpr int SWB = C::SWB;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sK = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* sV = sK + C::KV_BYTES;
  uint8_t* sStage = sV + C::KV_BYTES;
  uint64_t* bars =
      reinterpret_cast<uint64_t*>(sStage + kStages * C::STAGE);
  uint64_t* full_kv = bars;
  uint64_t* full = bars + 1;
  uint64_t* empty = full + kStages;

  int x = blockIdx.x;
  const int h = x % H;
  x /= H;
  const int kb = x % nkb;  // the longest causal columns (kb = 0) first
  const int b = x / nkb;
  const int kvh = h / (H / KV);
  const int k0 = kb * kBlock;
  // q rows before k0 see none of these keys when causal
  const int q_first = causal ? k0 : 0;
  const int n_stages = q_first < Sq ? (Sq - q_first + kQRows - 1) / kQRows
                                    : 0;

  const int tid = threadIdx.x, wg = tid / 128;
  if (tid == 0) {
    sm90::mbar_init(full_kv, 1);
    for (int s = 0; s < kStages; ++s) {
      // TMA's bytes, then every producer lane after its lse/delta stores
      sm90::mbar_init(full + s, 1 + 32);
      sm90::mbar_init(empty + s, 8);  // one arrival per consumer warp
    }
    sm90::fence_barrier_init();
  }
  __syncthreads();

  if (wg == 2) {
    // ------------------------------------------------------- producer
    sm90::regs_dealloc<24>();
    if (tid < 256 + 32) {
      const int lane = tid % 32;
      if (lane == 0) {
        sm90::mbar_expect_tx(full_kv, 2 * C::KV_BYTES);
        for (int a = 0; a < C::NATOM; ++a) {
          sm90::tma_load_4d(sK + a * kBlock * SWB, &tk, full_kv, a * C::SWE,
                            kvh, k0, b);
          sm90::tma_load_4d(sV + a * kBlock * SWB, &tv, full_kv, a * C::SWE,
                            kvh, k0, b);
        }
      }
      const size_t row0 = ((size_t)b * H + h) * Sq;  // of lse and delta
      for (int n = 0; n < n_stages; ++n) {
        const int s = n % kStages, q0 = q_first + n * kQRows;
        if (n >= kStages) sm90::mbar_wait(empty + s, (n / kStages - 1) & 1);
        uint8_t* st = sStage + s * C::STAGE;
        if (lane == 0) {
          sm90::mbar_expect_tx(full + s, C::TX);
          for (int a = 0; a < C::NATOM; ++a) {
            sm90::tma_load_4d(st + a * kQRows * SWB, &tq, full + s,
                              a * C::SWE, h, q0, b);
            sm90::tma_load_4d(st + C::TILE + a * kQRows * SWB, &tdo,
                              full + s, a * C::SWE, h, q0, b);
          }
        }
        float* sl = reinterpret_cast<float*>(st + 2 * C::TILE);
        for (int r = lane; r < kQRows; r += 32) {
          const bool in = q0 + r < Sq;
          sl[r] = in ? lse[row0 + q0 + r] : 0.f;
          sl[kQRows + r] = in ? delta[row0 + q0 + r] : 0.f;
        }
        sm90::mbar_arrive(full + s);  // releases this lane's stores
      }
    }
  } else {
    // ------------------------------------------------------- consumers
    sm90::regs_alloc<240>();
    const int t = tid % 128, warp = t / 32, lane = t % 32;
    const int kr0 = k0 + wg * kRows;              // the warpgroup's rows
    const int krow = kr0 + warp * 16 + lane / 4;  // and this thread's:
    const int col = 2 * (lane % 4);               // krow, krow + 8
    const uint8_t* myk = sK + wg * kRows * SWB;
    const uint8_t* myv = sV + wg * kRows * SWB;

    float acc_k[DH / 2], acc_v[DH / 2];
#pragma unroll
    for (int i = 0; i < DH / 2; ++i) acc_k[i] = acc_v[i] = 0.f;

    sm90::mbar_wait(full_kv, 0);
    for (int n = 0; n < n_stages; ++n) {
      const int s = n % kStages, q0 = q_first + n * kQRows;
      const uint8_t* sq = sStage + s * C::STAGE;
      const uint8_t* sdo = sq + C::TILE;
      const float* slse = reinterpret_cast<const float*>(sq + 2 * C::TILE);
      const float* sdl = slse + kQRows;
      // every consumer waits for the stage before it hands it back, even
      // one it skips (see flash_attention_fwd_sm90.cu)
      sm90::mbar_wait(full + s, (n / kStages) & 1);
      // a dead warpgroup (past Sk) or a stage wholly above the diagonal
      const bool skip = kr0 >= Sk || (causal && q0 + kQRows - 1 < kr0);
      if (!skip)
        // a padded q row carries lse = 0: masked here, not by the numbers
        sm90::dkv_stage<DH, SWB>(
            acc_k, acc_v, myk, myv, kBlock, sq, sdo, slse, sdl, c2, col,
            q0 + kQRows > Sq || kr0 + kRows > Sk ||
                (causal && q0 < kr0 + kRows - 1),
            [&](int qc, int i) {
              const int qp = q0 + qc, kp = krow + 8 * i;
              return qp >= Sq || kp >= Sk || (causal && qp < kp);
            });
      __syncwarp();
      if (lane == 0) sm90::mbar_arrive(empty + s);
    }

    // keys no q row sees (causal, k0 >= Sq) write dK = dV = 0
    sm90::store_scaled<DH>(acc_k, dk, b, h, H, Sk, krow, col, sm_scale);
    sm90::store_scaled<DH>(acc_v, dv, b, h, H, Sk, krow, col, 1.f);
  }
}

template <int DH>
int launch(const void* q, const void* k, const void* v, const void* dout,
           const void* lse, const void* delta, void* dk, void* dv, int B,
           int Sq, int Sk, int H, int KV, int causal, float sm_scale,
           cudaStream_t stream) {
  using C = DkvCfg<DH>;
  CUtensorMap tq, tk, tv, tdo;
  int err = sm90::encode_rows(&tq, q, B, Sq, H, DH, kQRows, C::SWB);
  if (!err) err = sm90::encode_rows(&tdo, dout, B, Sq, H, DH, kQRows, C::SWB);
  if (!err) err = sm90::encode_rows(&tk, k, B, Sk, KV, DH, kBlock, C::SWB);
  if (!err) err = sm90::encode_rows(&tv, v, B, Sk, KV, DH, kBlock, C::SWB);
  if (err) return err;
  cudaError_t e = cudaFuncSetAttribute(
      dkv_kernel<DH>, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (e != cudaSuccess) return (int)e;
  const int nkb = (Sk + kBlock - 1) / kBlock;
  const unsigned grid = (unsigned)B * nkb * H;
  dkv_kernel<DH><<<grid, kThreads, C::SMEM, stream>>>(
      tq, tk, tv, tdo, static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<bf16*>(dk),
      static_cast<bf16*>(dv), Sq, Sk, H, KV, nkb, causal,
      sm_scale * sm90::kLog2e, sm_scale);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace flash_sm90

extern "C" {

// The bf16 dK/dV: q, dout (B,Sq,H,Dh); k/v (B,Sk,KV,Dh), all bf16,
// contiguous and 16-byte aligned; lse, delta (B*H,Sq) fp32; dk/dv
// (B,Sk,H,Dh) bf16 per q head. Takes Dh in {32, 64, 128}. It takes no
// `hoist` flag: both values compute the same thing here (see the header).
// Returns the CUDA error code of the launch (0 = launched).
int flash_attention_bwd_dkv_sm90(const void* q, const void* k, const void* v,
                                 const void* dout, const void* lse,
                                 const void* delta, void* dk, void* dv,
                                 int B, int Sq, int Sk, int H, int KV, int dh,
                                 int causal, float sm_scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (Sq <= 0 || Sk <= 0) return (int)cudaErrorInvalidValue;
  switch (dh) {
    case 32:
      return flash_sm90::launch<32>(q, k, v, dout, lse, delta, dk, dv, B, Sq,
                                    Sk, H, KV, causal, sm_scale, st);
    case 64:
      return flash_sm90::launch<64>(q, k, v, dout, lse, delta, dk, dv, B, Sq,
                                    Sk, H, KV, causal, sm_scale, st);
    case 128:
      return flash_sm90::launch<128>(q, k, v, dout, lse, delta, dk, dv, B,
                                     Sq, Sk, H, KV, causal, sm_scale, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
