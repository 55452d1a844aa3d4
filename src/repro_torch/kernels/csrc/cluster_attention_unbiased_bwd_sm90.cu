// Unbiased cluster-sparse attention backward on Hopper's tensor cores
// (sm_90a), for bf16 q, k, v and dO, with the optional positional causal
// mask: the dQ kernel and the dK/dV kernel.
//
// Replace the TPU kernels `_dq_kernel` and `_dkv_kernel` in
// src/repro/kernels/cluster_attention_bwd.py for bf16 inputs: the token
// LM's local+global layout (core/reformation.lm_local_global_layout,
// bq = bk = 128) and the mask-free graph batch of the paper's scale run
// (launch/graph_dryrun.py: one layout per graph, Dh 8 or 24); fp32
// inputs stay on cluster_attention_unbiased_bwd.cu,
// on CUDA cores (TF32 would not meet their tolerances). They compute that
// kernel pair's function and `kernels/ref.py` `bwd_dq` / `bwd_dkv`: with
// the natural logsumexp `lse` of cluster_attention_unbiased_fwd_sm90.cu
// and `delta = rowsum(dO * O)` (both (B*H, S) fp32, from the caller),
// over the visited blocks
//   p  = exp(s - lse),  s = (q . k) Dh^-0.5 in fp32,
//   ds = p (dO . v - delta),
//   dq = Dh^-0.5 sum ds k,  dv = sum p^T dO,  dk = Dh^-0.5 sum ds^T q,
// with p = 0 where qpos < kpos when causal. The dQ kernel walks the
// forward layout `block_idx` (nq, mb), the dK/dV kernel the transposed
// one, `block_idx_t` (nk, mt, 2) of (q-row, forward slot) pairs; each is
// shared by the batch or one per sequence ((B, nq, mb), (B, nk, mt, 2);
// `idx_stride`, `t_stride` entries apart), and a -1 entry is skipped
// wherever it stands. Head dims as the forward's
// (cluster_attention_unbiased_fwd_sm90.cu): Dh 32, 64, 128 as they are,
// any other multiple of 8 up to 64 in tiles of DHP = Dh rounded up to 16
// columns whose pad TMA zero-fills; the accumulators run at DHP and the
// stores write the first Dh columns. dK
// and dV are per q head, (B, S, H, Dh) bf16; the GQA group sum is the
// caller's. A q-block row with no entry writes dq = 0, a k-block no row
// visits dk = dv = 0.
//
// `hoist_scale`. The reference rewrite multiplies q by Dh^-0.5 before the
// product. q Dh^-0.5 is no bf16 value, so the tensor cores cannot take
// the scaled tile; this source applies the scale to the fp32 scores
// instead, folded with log2(e) into the one exp2 argument. That differs
// from the plain `(q * scale) . k` by fp32 rounding alone, so both values
// of the flag launch these kernels and compute the same thing (the entry
// points take no flag).
//
// What bounds them on the card. At the Qwen3-0.6B training shape
// (S=16384, H=16 over KV=8, Dh=128, window 4096 + one global block: 3696
// visited blocks of 128 x 128, the causal diagonal blocks half full) dQ
// does 6 flop per score entry per Dh, ~732 GFLOP (0.74 ms at the bf16
// tensor-core peak), and dK/dV 8, ~976 GFLOP (0.99 ms), against ~0.3 GB
// of operands each: bound by operations.
//
// What this design does about it. The dense bf16 backwards
// (flash_attention_bwd_{dq,dkv}_sm90.cu) walking the layout's lists
// instead of the dense range, as cluster_attention_unbiased_fwd_sm90.cu
// walks `block_idx`:
// * dQ: one CTA per (b, head h, 128-row q-block qi), heads fastest in the
//   grid, the q-blocks last in the sequence first. Two consumer
//   warpgroups own 64 q rows each, with Q and dO resident in shared
//   memory and each thread's lse and delta (two rows) in registers; a
//   producer warp's first thread copies, by TMA, k and v of each entry
//   of `block_idx[qi, :]` that is not -1 and, when causal, not above the
//   diagonal (blk <= qi), as two stages of 64 key rows each, through a
//   ring of two stages.
// * dK/dV: one CTA per (b, q head h, 128-row k-block ki), heads fastest,
//   k-block 0 first: the global block, which every q-row visits (128
//   visitors at S=16384 against at most 32 elsewhere), so its CTAs start
//   first and their long walk overlaps the rest of the grid. K and V are
//   resident; the producer warp copies q and dO of each visitor
//   `block_idx_t[ki, :, 0]` that is not -1 and, when causal, not below
//   the diagonal (qrow >= ki), as two stages of 64 q rows, by TMA (its
//   first thread), and their lse and delta by plain loads (its 32 lanes).
// * Producer and consumers walk the same list with the same test, so
//   their stage counts agree without a shared list. Each stage is
//   sm90_tiles.cuh's `dq_stage` or `dkv_stage`, the per-stage bodies of
//   the dense kernels: S and dP by `wgmma` from shared memory, P and dS
//   on the accumulators' register layout, then dQ += dS K, or dV += P^T
//   dO and dK += dS^T Q, with A from registers in bf16. Only the
//   diagonal block (blk == qi, qrow == ki) is masked, and there a
//   warpgroup skips the 64-row stage that lies wholly above it.
// * Registers and shared memory as the dense kernels': the producer gives
//   registers up (`setmaxnreg` 24) and the consumers take 240. Shared
//   memory at Dh 128: 64 KB resident, two stages of 32 KB (dQ) or 33 KB
//   (dK/dV, with the stage's lse and delta).

#include "sm90_tiles.cuh"

namespace cluster_bwd_sm90 {
namespace {

using bf16 = __nv_bfloat16;

constexpr int kRows = 64;            // rows of one consumer warpgroup
constexpr int kBlock = 128;          // bq = bk: resident rows of a CTA
constexpr int kHalf = sm90::kStage;  // streamed rows of one stage
constexpr int kStages = 2;
constexpr int kThreads = 384;

template <int DH>
struct Cfg : sm90::Atom<DH> {
  static constexpr int DP = sm90::Atom<DH>::DHP;  // columns a tile row holds
  static constexpr int RES = kBlock * DP * 2;     // a resident tile
  static constexpr int TILE = kHalf * DP * 2;     // a stage's tile
  // dQ: k, then v; dK/dV: q, dO, then 64 lse and 64 delta
  static constexpr int DQ_STAGE = 2 * TILE;
  static constexpr int DKV_STAGE = 2 * TILE + 1024;
  // two resident tiles, the ring, 1 + 2 kStages barriers, and slack to
  // align to 1024
  static constexpr int DQ_SMEM = 2 * RES + kStages * DQ_STAGE + 1024 + 1024;
  static constexpr int DKV_SMEM = 2 * RES + kStages * DKV_STAGE + 1024 + 1024;
};

// ------------------------------------------------------------- dQ kernel

template <int DH>
__global__ void __launch_bounds__(kThreads, 1)
dq_kernel(const __grid_constant__ CUtensorMap tq,
          const __grid_constant__ CUtensorMap tk,
          const __grid_constant__ CUtensorMap tv,
          const __grid_constant__ CUtensorMap tdo,
          const float* __restrict__ lse, const float* __restrict__ delta,
          const int32_t* __restrict__ block_idx, bf16* __restrict__ dq,
          int S, int H, int KV, int nq, int mb, int idx_stride, int causal,
          float c2, float sm_scale) {
  using C = Cfg<DH>;
  constexpr int SWB = C::SWB, DP = C::DP;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sQ = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* sDO = sQ + C::RES;
  uint8_t* sStage = sDO + C::RES;
  uint64_t* bars =
      reinterpret_cast<uint64_t*>(sStage + kStages * C::DQ_STAGE);
  uint64_t* full_q = bars;
  uint64_t* full = bars + 1;
  uint64_t* empty = full + kStages;

  int x = blockIdx.x;
  const int h = x % H;
  x /= H;
  const int qi = nq - 1 - x % nq;  // the longest causal rows first
  const int b = x / nq;
  const int kvh = h / (H / KV);
  const int q0 = qi * kBlock;
  // this sequence's row: idx_stride 0 for a layout shared by the batch
  const int32_t* entries =
      block_idx + (size_t)b * idx_stride + (size_t)qi * mb;
  // a listed block is visited unless the causal mask empties it for
  // every row of the q-block (bq = bk: it lies past the diagonal)
  auto visited = [&](int blk) { return blk >= 0 && !(causal && blk > qi); };

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
      sm90::mbar_expect_tx(full_q, 2 * C::RES);
      for (int a = 0; a < C::NATOM; ++a) {
        sm90::tma_load_4d(sQ + a * kBlock * SWB, &tq, full_q, a * C::SWE, h,
                          q0, b);
        sm90::tma_load_4d(sDO + a * kBlock * SWB, &tdo, full_q, a * C::SWE,
                          h, q0, b);
      }
      int n = 0;
      for (int e = 0; e < mb; ++e) {
        const int blk = entries[e];
        if (!visited(blk)) continue;
        for (int half = 0; half < 2; ++half, ++n) {
          const int s = n % kStages;
          if (n >= kStages) sm90::mbar_wait(empty + s, (n / kStages - 1) & 1);
          uint8_t* st = sStage + s * C::DQ_STAGE;
          const int k0 = blk * kBlock + half * kHalf;
          sm90::mbar_expect_tx(full + s, C::DQ_STAGE);
          for (int a = 0; a < C::NATOM; ++a) {
            sm90::tma_load_4d(st + a * kHalf * SWB, &tk, full + s, a * C::SWE,
                              kvh, k0, b);
            sm90::tma_load_4d(st + C::TILE + a * kHalf * SWB, &tv, full + s,
                              a * C::SWE, kvh, k0, b);
          }
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
    const uint8_t* myq = sQ + wg * kRows * SWB;
    const uint8_t* mydo = sDO + wg * kRows * SWB;

    // lse (base 2) and delta of the thread's rows (S = nq bq: all live)
    float lse2[2], dl[2];
    const size_t row0 = ((size_t)b * H + h) * S;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      lse2[i] = lse[row0 + row + 8 * i] * sm90::kLog2e;
      dl[i] = delta[row0 + row + 8 * i];
    }
    float acc[DP / 2];
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) acc[i] = 0.f;

    sm90::mbar_wait(full_q, 0);
    int n = 0;
    for (int e = 0; e < mb; ++e) {
      const int blk = entries[e];  // uniform across the CTA
      if (!visited(blk)) continue;
      const bool diag = causal && blk == qi;
      for (int half = 0; half < 2; ++half, ++n) {
        const int s = n % kStages;
        const int k0 = blk * kBlock + half * kHalf;
        const uint8_t* sk = sStage + s * C::DQ_STAGE;
        // every consumer waits for the stage before it hands it back, even
        // one it skips (see flash_attention_fwd_sm90.cu)
        sm90::mbar_wait(full + s, (n / kStages) & 1);
        // on the diagonal, keys past the warpgroup's last row are masked
        if (!(diag && k0 >= r0 + kRows))  // uniform over the warpgroup
          sm90::dq_stage<DP, SWB>(
              acc, myq, mydo, kBlock, sk, sk + C::TILE, lse2, dl, c2, col,
              diag && k0 + kHalf - 1 > r0,
              [&](int kc, int i) { return k0 + kc > row + 8 * i; });
        __syncwarp();
        if (lane == 0) sm90::mbar_arrive(empty + s);
      }
    }

    sm90::store_scaled<DH, DP>(acc, dq, b, h, H, S, row, col, sm_scale);
  }
}

// ---------------------------------------------------------- dK/dV kernel

template <int DH>
__global__ void __launch_bounds__(kThreads, 1)
dkv_kernel(const __grid_constant__ CUtensorMap tq,
           const __grid_constant__ CUtensorMap tk,
           const __grid_constant__ CUtensorMap tv,
           const __grid_constant__ CUtensorMap tdo,
           const float* __restrict__ lse, const float* __restrict__ delta,
           const int32_t* __restrict__ block_idx_t, bf16* __restrict__ dk,
           bf16* __restrict__ dv, int S, int H, int KV, int nk, int mt,
           int t_stride, int causal, float c2, float sm_scale) {
  using C = Cfg<DH>;
  constexpr int SWB = C::SWB, DP = C::DP;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sK = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* sV = sK + C::RES;
  uint8_t* sStage = sV + C::RES;
  uint64_t* bars =
      reinterpret_cast<uint64_t*>(sStage + kStages * C::DKV_STAGE);
  uint64_t* full_kv = bars;
  uint64_t* full = bars + 1;
  uint64_t* empty = full + kStages;

  int x = blockIdx.x;
  const int h = x % H;
  x /= H;
  const int ki = x % nk;  // k-block 0, the global block's column, first
  const int b = x / nk;
  const int kvh = h / (H / KV);
  const int k0 = ki * kBlock;
  // the (q-row, forward slot) pairs of this k-block in this sequence's
  // layout: t_stride 0 for a layout shared by the batch
  const int32_t* pairs =
      block_idx_t + (size_t)b * t_stride + (size_t)ki * mt * 2;
  // a visiting q-block counts unless the causal mask empties it for every
  // key of the k-block (it lies before the diagonal)
  auto visited = [&](int qrow) {
    return qrow >= 0 && !(causal && qrow < ki);
  };

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
        sm90::mbar_expect_tx(full_kv, 2 * C::RES);
        for (int a = 0; a < C::NATOM; ++a) {
          sm90::tma_load_4d(sK + a * kBlock * SWB, &tk, full_kv, a * C::SWE,
                            kvh, k0, b);
          sm90::tma_load_4d(sV + a * kBlock * SWB, &tv, full_kv, a * C::SWE,
                            kvh, k0, b);
        }
      }
      const size_t row0 = ((size_t)b * H + h) * S;  // of lse and delta
      int n = 0;
      for (int t = 0; t < mt; ++t) {
        const int qrow = pairs[2 * t];
        if (!visited(qrow)) continue;
        for (int half = 0; half < 2; ++half, ++n) {
          const int s = n % kStages, q0 = qrow * kBlock + half * kHalf;
          if (n >= kStages) sm90::mbar_wait(empty + s, (n / kStages - 1) & 1);
          uint8_t* st = sStage + s * C::DKV_STAGE;
          if (lane == 0) {
            sm90::mbar_expect_tx(full + s, 2 * C::TILE);
            for (int a = 0; a < C::NATOM; ++a) {
              sm90::tma_load_4d(st + a * kHalf * SWB, &tq, full + s,
                                a * C::SWE, h, q0, b);
              sm90::tma_load_4d(st + C::TILE + a * kHalf * SWB, &tdo,
                                full + s, a * C::SWE, h, q0, b);
            }
          }
          float* sl = reinterpret_cast<float*>(st + 2 * C::TILE);
          for (int r = lane; r < kHalf; r += 32) {
            sl[r] = lse[row0 + q0 + r];
            sl[kHalf + r] = delta[row0 + q0 + r];
          }
          sm90::mbar_arrive(full + s);  // releases this lane's stores
        }
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

    float acc_k[DP / 2], acc_v[DP / 2];
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) acc_k[i] = acc_v[i] = 0.f;

    sm90::mbar_wait(full_kv, 0);
    int n = 0;
    for (int u = 0; u < mt; ++u) {
      const int qrow = pairs[2 * u];  // uniform across the CTA
      if (!visited(qrow)) continue;
      const bool diag = causal && qrow == ki;
      for (int half = 0; half < 2; ++half, ++n) {
        const int s = n % kStages, q0 = qrow * kBlock + half * kHalf;
        const uint8_t* sq = sStage + s * C::DKV_STAGE;
        const float* slse = reinterpret_cast<const float*>(sq + 2 * C::TILE);
        // every consumer waits for the stage before it hands it back, even
        // one it skips (see flash_attention_fwd_sm90.cu)
        sm90::mbar_wait(full + s, (n / kStages) & 1);
        // on the diagonal, q rows before the warpgroup's first key see none
        // of its keys
        if (!(diag && q0 + kHalf - 1 < kr0))  // uniform over the warpgroup
          sm90::dkv_stage<DP, SWB>(
              acc_k, acc_v, myk, myv, kBlock, sq, sq + C::TILE, slse,
              slse + kHalf, c2, col, diag && q0 < kr0 + kRows - 1,
              [&](int qc, int i) { return q0 + qc < krow + 8 * i; });
        __syncwarp();
        if (lane == 0) sm90::mbar_arrive(empty + s);
      }
    }

    sm90::store_scaled<DH, DP>(acc_k, dk, b, h, H, S, krow, col, sm_scale);
    sm90::store_scaled<DH, DP>(acc_v, dv, b, h, H, S, krow, col, 1.f);
  }
}

// the four (B, S, heads, Dh) maps: q and dO boxes of `q_rows` rows, k and
// v boxes of `kv_rows`
template <int DH>
int encode_maps(CUtensorMap* tq, CUtensorMap* tk, CUtensorMap* tv,
                CUtensorMap* tdo, const void* q, const void* k,
                const void* v, const void* dout, int B, int S, int H,
                int KV, int q_rows, int kv_rows) {
  constexpr int SWB = Cfg<DH>::SWB;
  int err = sm90::encode_rows(tq, q, B, S, H, DH, q_rows, SWB);
  if (!err) err = sm90::encode_rows(tdo, dout, B, S, H, DH, q_rows, SWB);
  if (!err) err = sm90::encode_rows(tk, k, B, S, KV, DH, kv_rows, SWB);
  if (!err) err = sm90::encode_rows(tv, v, B, S, KV, DH, kv_rows, SWB);
  return err;
}

template <int DH>
int launch_dq(const void* q, const void* k, const void* v, const void* dout,
              const void* lse, const void* delta, const void* block_idx,
              void* dq, int B, int S, int H, int KV, int nq, int mb,
              int idx_stride, int causal, float sm_scale,
              cudaStream_t stream) {
  using C = Cfg<DH>;
  CUtensorMap tq, tk, tv, tdo;
  int err = encode_maps<DH>(&tq, &tk, &tv, &tdo, q, k, v, dout, B, S, H, KV,
                            kBlock, kHalf);
  if (err) return err;
  cudaError_t e = cudaFuncSetAttribute(
      dq_kernel<DH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      C::DQ_SMEM);
  if (e != cudaSuccess) return (int)e;
  const unsigned grid = (unsigned)B * nq * H;
  dq_kernel<DH><<<grid, kThreads, C::DQ_SMEM, stream>>>(
      tq, tk, tv, tdo, static_cast<const float*>(lse),
      static_cast<const float*>(delta),
      static_cast<const int32_t*>(block_idx), static_cast<bf16*>(dq), S, H,
      KV, nq, mb, idx_stride, causal, sm_scale * sm90::kLog2e, sm_scale);
  return (int)cudaGetLastError();
}

template <int DH>
int launch_dkv(const void* q, const void* k, const void* v,
               const void* dout, const void* lse, const void* delta,
               const void* block_idx_t, void* dk, void* dv, int B, int S,
               int H, int KV, int nk, int mt, int t_stride, int causal,
               float sm_scale, cudaStream_t stream) {
  using C = Cfg<DH>;
  CUtensorMap tq, tk, tv, tdo;
  int err = encode_maps<DH>(&tq, &tk, &tv, &tdo, q, k, v, dout, B, S, H, KV,
                            kHalf, kBlock);
  if (err) return err;
  cudaError_t e = cudaFuncSetAttribute(
      dkv_kernel<DH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      C::DKV_SMEM);
  if (e != cudaSuccess) return (int)e;
  const unsigned grid = (unsigned)B * nk * H;
  dkv_kernel<DH><<<grid, kThreads, C::DKV_SMEM, stream>>>(
      tq, tk, tv, tdo, static_cast<const float*>(lse),
      static_cast<const float*>(delta),
      static_cast<const int32_t*>(block_idx_t), static_cast<bf16*>(dk),
      static_cast<bf16*>(dv), S, H, KV, nk, mt, t_stride, causal,
      sm_scale * sm90::kLog2e, sm_scale);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace cluster_bwd_sm90

#define UNBIASED_SM90_DH_CASES(X) \
  X(8) X(16) X(24) X(32) X(40) X(48) X(56) X(64) X(128)

extern "C" {

// The bf16 unbiased dQ: q, dout, dq (B,S,H,Dh); k/v (B,S,KV,Dh), all
// bf16, contiguous and 16-byte aligned; lse, delta (B*H,S) fp32;
// block_idx (nq,mb) int32 shared by the batch (idx_stride 0) or
// (B,nq,mb) (idx_stride nq*mb), with S = 128 nq (bq = bk = 128). Takes Dh
// a multiple of 8 up to 64, or 128. Returns the CUDA error code of the
// launch (0 = launched).
int cluster_attention_bwd_dq_unbiased_sm90(const void* q, const void* k,
                                           const void* v, const void* dout,
                                           const void* lse, const void* delta,
                                           const void* block_idx, void* dq,
                                           int B, int S, int H, int KV,
                                           int dh, int nq, int mb,
                                           int idx_stride, int causal,
                                           float sm_scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (nq <= 0 || S != nq * cluster_bwd_sm90::kBlock)
    return (int)cudaErrorInvalidValue;
#define DQ_CASE(D)                                                          \
  case D:                                                                   \
    return cluster_bwd_sm90::launch_dq<D>(q, k, v, dout, lse, delta,        \
                                          block_idx, dq, B, S, H, KV, nq,   \
                                          mb, idx_stride, causal, sm_scale, \
                                          st);
  switch (dh) {
    UNBIASED_SM90_DH_CASES(DQ_CASE)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef DQ_CASE
}

// The bf16 unbiased dK/dV, as above; block_idx_t (nk,mt,2) int32 shared
// by the batch (t_stride 0) or (B,nk,mt,2) (t_stride nk*mt*2) lists
// (q-row, forward slot) pairs, -1 padded, with S = 128 nk; dk/dv
// (B,S,H,Dh) bf16 per q head.
int cluster_attention_bwd_dkv_unbiased_sm90(const void* q, const void* k,
                                            const void* v, const void* dout,
                                            const void* lse,
                                            const void* delta,
                                            const void* block_idx_t,
                                            void* dk, void* dv, int B, int S,
                                            int H, int KV, int dh, int nk,
                                            int mt, int t_stride, int causal,
                                            float sm_scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (nk <= 0 || S != nk * cluster_bwd_sm90::kBlock)
    return (int)cudaErrorInvalidValue;
#define DKV_CASE(D)                                                         \
  case D:                                                                   \
    return cluster_bwd_sm90::launch_dkv<D>(q, k, v, dout, lse, delta,       \
                                           block_idx_t, dk, dv, B, S, H,    \
                                           KV, nk, mt, t_stride, causal,    \
                                           sm_scale, st);
  switch (dh) {
    UNBIASED_SM90_DH_CASES(DKV_CASE)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef DKV_CASE
}

}  // extern "C"

#undef UNBIASED_SM90_DH_CASES
