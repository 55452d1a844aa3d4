// Unbiased cluster-sparse attention forward on Hopper's tensor cores
// (sm_90a), for bf16 q, k and v, with the optional positional causal mask.
//
// Replaces the TPU kernel `_cluster_kernel` in
// src/repro/kernels/cluster_attention.py for bf16 inputs: the token LM's
// local+global layout (core/reformation.lm_local_global_layout,
// bq = bk = 128) and the mask-free graph batch of the paper's scale run
// (launch/graph_dryrun.py: bq = bk = 128, one layout per graph, Dh 8 or
// 24); fp32 inputs stay on cluster_attention_unbiased_fwd.cu,
// on CUDA cores (TF32 would not meet their tolerances). It computes the
// same function as that kernel and `kernels/ref.py`
// `cluster_sparse_attention`: for each q-block row an online softmax over
// the k-blocks that `block_idx` (nq, mb) lists (shared by the batch, or
// (B, nq, mb), one per sequence, `idx_stride` entries apart; a -1 entry,
// wherever it stands, is skipped), scores `(q . k) Dh^-0.5` in
// fp32, -inf where `qpos < kpos` when causal, O in bf16 and the natural
// logsumexp `lse` (B*H, S) in fp32 that the backward kernels
// (cluster_attention_unbiased_bwd.cu) rebuild `exp(s - lse)` against. A
// row with no unmasked entry writes O = 0 and lse = 0.
//
// `hoist_scale`. The reference rewrite multiplies q by Dh^-0.5 before the
// product. q Dh^-0.5 is no bf16 value, so the tensor cores cannot take
// the scaled tile; this source applies the scale to the fp32 scores
// instead, folded with log2(e) into the one exp2 argument. That differs
// from the plain `(q * scale) . k` by fp32 rounding alone, so both values
// of the flag launch these kernels and compute the same thing (the entry
// points take no flag).
//
// What bounds it on the card. At the Qwen3-0.6B training shape (S=16384,
// H=16 over KV=8, Dh=128, window 4096 + one global block: 3696 visited
// blocks of 128 x 128, the causal diagonal blocks half full) the score
// and PV products are ~488 GFLOP, 0.49 ms at the bf16 tensor-core peak,
// against ~202 MB of q, k, v, O and lse (0.06 ms at 3.35 TB/s): bound by
// operations.
//
// What this design does about it. flash_attention_fwd_sm90.cu at its
// 128 x 128 schedule, walking the layout's block list instead of the
// dense ring:
// * One CTA per (b, head h, 128-row q-block), heads fastest in the grid
//   so that the CTAs of one q-block read the same k and v rows through
//   L2, the q-blocks last in the sequence first. Two consumer warpgroups
//   own 64 q rows each; a producer warpgroup's first thread copies q once
//   and, for each entry of the q-block's `block_idx` row that is not -1
//   (and, when causal, not wholly above the diagonal), that k-block's k
//   and v rows as one 128-row TMA box each into a ring of two stages,
//   with full barriers for k and v apart and an empty barrier. The
//   consumers walk the same row with the same test, so both sides count
//   the same stages.
// * Per stage and consumer warpgroup: S = Q K^T by `wgmma` m64n128k16
//   from shared memory (fp32 accumulators); the online softmax on the
//   accumulator's register layout in the exp2 domain (scale * log2 e
//   folded into one exp2 argument; lse converted back to the natural log
//   on the way out); O += P V by `wgmma` with P from registers. The
//   causal mask is applied only on the diagonal block. The softmax, P V
//   and the epilogue are sm90_tiles.cuh's, shared with the flash forward.
// * The P split, as the flash forward: the port's check holds bf16 O
//   element by element within 1e-5 + 2^-7 |O| of the plain version, and
//   the rows of this layout average thousands of keys, so O cancels near
//   0, where a P rounded once to bf16 misses 1e-5. P = P_hi + P_lo, two
//   register-operand `wgmma`s into the same O: 1.5x the tensor-core work
//   of the function, an error near 2^-17.
// * Head dims: Dh 32, 64 and 128 are copied as they are; any other
//   multiple of 8 up to 64 is held as DHP = Dh rounded up to 16 columns,
//   in 16-column atoms with a 32-byte swizzle whose last TMA box reaches
//   past Dh and is zero-filled there (sm90_tiles.cuh). The products run
//   at DHP: S = Q K^T over DHP / 16 steps of 16, O = P V at n = DHP. q, k
//   and v are never padded in device memory: at S = 1048576 with
//   Graphormer-Large that would copy three 1.6 GB tensors a layer.
// * Registers: the 64 x Dh fp32 O and the 64 x 128 S, with P's two bf16
//   halves: the producer gives registers up (`setmaxnreg` 24) and the
//   consumers take 240. Shared memory at Dh 128: q 32 KB, two stages of
//   64 KB.

#include "sm90_tiles.cuh"

namespace cluster_sm90 {
namespace {

using bf16 = __nv_bfloat16;

constexpr int kRows = 64;     // q rows of one consumer warpgroup
constexpr int kBlock = 128;   // bq = bk: q rows of a CTA, k rows of a stage
constexpr int kStages = 2;
constexpr int kThreads = 384;

template <int DH>
struct Cfg : sm90::Atom<DH> {
  // q, or a stage's k or v: DHP columns a row
  static constexpr int TILE = kBlock * sm90::Atom<DH>::DHP * 2;
  // q, the ring, 1 + 3 kStages barriers, and slack to align to 1024
  static constexpr int SMEM = TILE + 2 * kStages * TILE + 1024 + 1024;
};

template <int DH>
__global__ void __launch_bounds__(kThreads, 1)
fwd_kernel(const __grid_constant__ CUtensorMap tq,
           const __grid_constant__ CUtensorMap tk,
           const __grid_constant__ CUtensorMap tv,
           const int32_t* __restrict__ block_idx, bf16* __restrict__ out,
           float* __restrict__ lse, int S, int H, int KV, int nq, int mb,
           int idx_stride, int causal, float c2) {
  using C = Cfg<DH>;
  constexpr int SWB = C::SWB, DP = C::DHP;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sQ = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* sKV = sQ + C::TILE;  // stage s: k, then v
  uint64_t* bars =
      reinterpret_cast<uint64_t*>(sKV + 2 * kStages * C::TILE);
  uint64_t* full_q = bars;
  uint64_t* full_k = bars + 1;
  uint64_t* full_v = full_k + kStages;
  uint64_t* empty = full_v + kStages;

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
      sm90::mbar_init(full_k + s, 1);
      sm90::mbar_init(full_v + s, 1);
      sm90::mbar_init(empty + s, 8);  // one arrival per consumer warp
    }
    sm90::fence_barrier_init();
  }
  __syncthreads();

  if (wg == 2) {
    // ------------------------------------------------------- producer
    sm90::regs_dealloc<24>();
    if (tid == 256) {
      sm90::mbar_expect_tx(full_q, C::TILE);
      for (int a = 0; a < C::NATOM; ++a)
        sm90::tma_load_4d(sQ + a * kBlock * SWB, &tq, full_q, a * C::SWE, h,
                          q0, b);
      int n = 0;
      for (int e = 0; e < mb; ++e) {
        const int blk = entries[e];
        if (!visited(blk)) continue;
        const int s = n % kStages;
        if (n >= kStages) sm90::mbar_wait(empty + s, (n / kStages - 1) & 1);
        uint8_t* sk = sKV + 2 * s * C::TILE;
        uint8_t* sv = sk + C::TILE;
        sm90::mbar_expect_tx(full_k + s, C::TILE);
        for (int a = 0; a < C::NATOM; ++a)
          sm90::tma_load_4d(sk + a * kBlock * SWB, &tk, full_k + s,
                            a * C::SWE, kvh, blk * kBlock, b);
        sm90::mbar_expect_tx(full_v + s, C::TILE);
        for (int a = 0; a < C::NATOM; ++a)
          sm90::tma_load_4d(sv + a * kBlock * SWB, &tv, full_v + s,
                            a * C::SWE, kvh, blk * kBlock, b);
        ++n;
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

    float o[DP / 2];
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) o[i] = 0.f;
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

    sm90::mbar_wait(full_q, 0);
    int n = 0;
    for (int e = 0; e < mb; ++e) {
      const int blk = entries[e];  // uniform across the CTA
      if (!visited(blk)) continue;
      const int s = n % kStages;
      const uint32_t par = (n / kStages) & 1;
      ++n;
      const int k0 = blk * kBlock;
      const uint8_t* sk = sKV + 2 * s * C::TILE;
      const uint8_t* sv = sk + C::TILE;
      sm90::mbar_wait(full_k + s, par);

      // S = Q K^T over Dh (the pad columns are zero), fp32
      float sc[kBlock / 2];
      sm90::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk)
        sm90::ss<kBlock>(sc, sm90::desc_k<SWB>(myq, kBlock, kk * 16),
                         sm90::desc_k<SWB>(sk, kBlock, kk * 16), kk > 0);
      sm90::wgmma_commit();
      sm90::wgmma_wait<0>();
      sm90::fence_acc(sc);

      // the causal mask on the diagonal block; the online softmax
      uint32_t phi[kBlock / 16][4], plo[kBlock / 16][4];
      sm90::softmax_chunk<kBlock, DP>(
          sc, o, m, l, c2, col, causal && k0 + kBlock - 1 > r0,
          [&](int kc, int i) { return k0 + kc > row + 8 * i; }, phi, plo);

      // O += P_hi V + P_lo V
      sm90::mbar_wait(full_v + s, par);
      sm90::pv_split<kBlock, DP, SWB>(o, phi, plo, sv, kBlock, 0);
      // the stage's k and v are read: hand it back to the producer
      __syncwarp();
      if (lane == 0) sm90::mbar_arrive(empty + s);
    }

    sm90::store_rows<DH, DP>(o, m, l, out, lse, b, h, H, S, row, col);
  }
}

template <int DH>
int launch(const void* q, const void* k, const void* v,
           const void* block_idx, void* out, void* lse, int B, int S, int H,
           int KV, int nq, int mb, int idx_stride, int causal,
           float sm_scale, cudaStream_t stream) {
  using C = Cfg<DH>;
  CUtensorMap tq, tk, tv;
  int err = sm90::encode_rows(&tq, q, B, S, H, DH, kBlock, C::SWB);
  if (!err) err = sm90::encode_rows(&tk, k, B, S, KV, DH, kBlock, C::SWB);
  if (!err) err = sm90::encode_rows(&tv, v, B, S, KV, DH, kBlock, C::SWB);
  if (err) return err;
  cudaError_t e = cudaFuncSetAttribute(
      fwd_kernel<DH>, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (e != cudaSuccess) return (int)e;
  const unsigned grid = (unsigned)B * nq * H;
  fwd_kernel<DH><<<grid, kThreads, C::SMEM, stream>>>(
      tq, tk, tv, static_cast<const int32_t*>(block_idx),
      static_cast<bf16*>(out), static_cast<float*>(lse), S, H, KV, nq, mb,
      idx_stride, causal, sm_scale * sm90::kLog2e);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace cluster_sm90

extern "C" {

// The bf16 unbiased forward: q (B,S,H,Dh), k/v (B,S,KV,Dh), out like q,
// all bf16, contiguous and 16-byte aligned; block_idx (nq,mb) int32
// shared by the batch (idx_stride 0) or (B,nq,mb) (idx_stride nq*mb),
// with S = 128 nq (bq = bk = 128); lse (B*H,S) fp32 or NULL. Takes Dh a
// multiple of 8 up to 64, or 128. Returns the CUDA error code of the
// launch (0 = launched).
int cluster_attention_fwd_unbiased_sm90(const void* q, const void* k,
                                        const void* v, const void* block_idx,
                                        void* out, void* lse, int B, int S,
                                        int H, int KV, int dh, int nq, int mb,
                                        int idx_stride, int causal,
                                        float sm_scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (nq <= 0 || S != nq * cluster_sm90::kBlock)
    return (int)cudaErrorInvalidValue;
#define FWD_CASE(D)                                                         \
  case D:                                                                   \
    return cluster_sm90::launch<D>(q, k, v, block_idx, out, lse, B, S, H,   \
                                   KV, nq, mb, idx_stride, causal,          \
                                   sm_scale, st);
  switch (dh) {
    FWD_CASE(8)
    FWD_CASE(16)
    FWD_CASE(24)
    FWD_CASE(32)
    FWD_CASE(40)
    FWD_CASE(48)
    FWD_CASE(56)
    FWD_CASE(64)
    FWD_CASE(128)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef FWD_CASE
}

}  // extern "C"
