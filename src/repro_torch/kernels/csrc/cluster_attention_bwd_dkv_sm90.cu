// Cluster-sparse attention dK/dV backward with int8 bias buckets on
// Hopper's tensor cores (sm_90a), for bf16 operands.
//
// Replaces the TPU kernel `_dkv_kernel_biased` in
// src/repro/kernels/cluster_attention_bwd.py for bf16 inputs: the
// graph transformer's training path; fp32 stays on the CUDA-core kernel
// of cluster_attention_bwd.cu. The bf16 dQ is its mirror image,
// cluster_attention_bwd_dq_sm90.cu. The forward's rewrites as there:
// `hoist_scale` launches this same kernel (the scale rides the one fp32
// FMA of each rebuilt score; a scaled q is no bf16 value), `fuse_bias` is
// the `fuse` argument, which picks the kernel's FUSE instantiation (the
// table nb + 1 wide, biased_tiles.cuh `score2_fused`).
// Same function as that kernel and `kernels/ref.py` `bwd_dkv`: for each
// k-block, over the (q-row, forward slot) pairs that the transposed
// layout `block_idx_t` lists (-1 pairs, wherever they stand, skipped), it
// rebuilds the forward's scores `(q . k) Dh^-0.5 + bias[h, min(bucket,
// nb-1)]` (bucket -1 -> the finite sentinel -1e30) and with the forward's
// fp32 lse and the caller's fp32 `delta = rowsum(dO * O)` accumulates, in
// fp32,
//   P^T  = exp(S^T - lse)        (dead rows carry lse = 0, so P = 0)
//   dV  += P^T dO
//   dS^T = P^T o (V dO^T - delta)
//   dK  += Dh^-0.5 dS^T Q
// per q-head (the GQA group sum is the caller's). No float atomics: each
// CTA owns its output rows, so the result is deterministic.
//
// What bounds it on the card. At the nearly dense training rung of the
// 8192-node graph (S=8224, Graphormer-Large: H=KV=32, Dh=24, 64729
// visited 32 x 32 blocks) the four products are 8 * 64729 * 32 * 32 * 24
// * 32 = 407 GFLOP, 0.41 ms at the bf16 tensor-core peak, against ~40 MB
// of q, k, v, dO, lse, delta, dk and dv plus 66 MB of bucket tiles (0.03
// ms at 3.35 TB/s); one exp2 per score and head, 2.1 G, is ~0.5 ms at
// 16 a clock per SM.
//
// What this design does about it.
// * Tensor cores by `mma.sync.m16n8k16` (biased_tiles.cuh), all four
//   products per visitor: S^T = K Q^T and dP^T = V dO^T read K, V (A) and
//   the visitor's Q, dO (B) from shared memory by `ldmatrix`; P^T and dS^T
//   go from the accumulator registers into the A fragments of dV += P^T
//   dO and dK += dS^T Q (bf16 P and dS: the gradients are held
//   norm-relative, as the unbiased bf16 backward holds them).
// * One CTA per (graph, k-block, group of G heads), G <= 4, one warp per
//   head owning its BLK x Dh dK and dV accumulators (BLK = bq = bk, 16 or
//   32, a template parameter picked at launch). K and V stay resident
//   in shared memory (shared by the q-heads of one kv-head under GQA);
//   the visitor list and each visitor's bucket tile are read once per
//   group, the tile read transposed (`bucket[q][k]` at k-row, q-column).
// * A ring of two shared-memory stages filled by `cp.async`: each
//   visitor's Q and dO rows, lse and delta of the group's heads and its
//   bucket tile, the next one in flight while the warps compute the
//   current one. No thread spins on a barrier.
// * Registers: at BLK = 32 the four 32 x 32 products keep S^T, dP^T and
//   the 32 x Dh dK and dV accumulators live (half as many at 16). At Dh
//   <= 24 the launch bounds ask for three CTAs an SM (at most 168
//   registers, no spills), 17% faster on the training rung than two
//   (tools/ab_biased.py); wider heads get two.
// * The heavy column (k-block 0, which the global token's row makes
//   visited by nearly every q-row) stays one CTA per head group; its
//   CTAs are the first of the grid. At the serve shape it costs ~23%
//   (`chip_smoke.py`, the column cut to one visitor), a shape no main
//   path runs dK/dV at; splitting it as the forward splits its heavy row
//   is later work.

#include "biased_tiles.cuh"

namespace {

using bf16 = __nv_bfloat16;
using namespace biased;

// Shared memory: the nkv K and nkv V tiles, then kStages stages of (G q
// tiles, G dO tiles), the stages' bucket tiles, their lse and delta rows
// (G x BLK fp32 each), the compacted visitors (q-row, slot), kMaxWarps
// ints of scratch, the G bias rows.
template <int DH, int BLK>
size_t dkv_smem_bytes(int G, int nkv, int mt, int nbo) {
  using D = Dims<DH, BLK>;
  return (size_t)(2 * nkv + kStages * 2 * G) * D::TILE * sizeof(bf16) +
         (size_t)kStages * (D::BKT + 2 * G * BLK * sizeof(float)) +
         (size_t)mt * sizeof(int2) + kMaxWarps * sizeof(int) +
         (size_t)G * nbo * sizeof(float);
}

template <int DH, int BLK, bool FUSE>
__global__ void __launch_bounds__(kMaxWarps * 32, DH <= 24 ? 3 : 2)
cluster_biased_dkv_sm90(const bf16* __restrict__ q,
                        const bf16* __restrict__ k,
                        const bf16* __restrict__ v,
                        const bf16* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta,
                        const int32_t* __restrict__ block_idx_t,
                        const int8_t* __restrict__ buckets,
                        const float* __restrict__ bias,
                        bf16* __restrict__ dk, bf16* __restrict__ dv, int S,
                        int H, int KV, int nq, int mb, int nk, int mt,
                        int nb, int per_graph, int per_graph_t, int G,
                        int nkv, float scale2, float sm_scale) {
  using D = Dims<DH, BLK>;
  constexpr int MT = D::MT, NS = D::NS;
  extern __shared__ __align__(16) uint8_t smem[];
  const int tid = threadIdx.x, nthr = blockDim.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int ngrp = H / G;
  const int grp = blockIdx.x % ngrp;
  const int ki = (blockIdx.x / ngrp) % nk;
  const int b = blockIdx.x / (ngrp * nk);
  const int rep = H / KV;
  const int h0 = grp * G, kv0 = h0 / rep;
  const int h = h0 + warp, kvt = h / rep - kv0;

  bf16* sK = reinterpret_cast<bf16*>(smem);  // nkv K tiles, then nkv V
  bf16* sStage = sK + 2 * nkv * D::TILE;
  int8_t* sBkt = reinterpret_cast<int8_t*>(sStage + kStages * 2 * G *
                                                        D::TILE);
  float* sLse = reinterpret_cast<float*>(sBkt + kStages * D::BKT);
  float* sDl = sLse + kStages * G * BLK;
  int2* sList = reinterpret_cast<int2*>(sDl + kStages * G * BLK);
  int* sCnt = reinterpret_cast<int*>(sList + mt);
  float* sBias = reinterpret_cast<float*>(sCnt + kMaxWarps);

  const int gl = per_graph ? b : 0;
  const int glt = per_graph_t ? b : 0;
  const int2* idxt_row = reinterpret_cast<const int2*>(
      block_idx_t + ((size_t)glt * nk + ki) * mt * 2);
  const int8_t* bkt_graph =
      buckets + (size_t)gl * nq * mb * (size_t)D::BKT;
  const size_t k_row0 = (size_t)b * S + (size_t)ki * BLK;

  clear_pad<DH, BLK>(sK, 2 * nkv + kStages * 2 * G, tid, nthr);
  for (int t = 0; t < nkv; ++t) {
    const size_t off = (k_row0 * KV + kv0 + t) * DH;
    load_tile<DH, BLK>(sK + t * D::TILE, k + off, (size_t)KV * DH, tid,
                       nthr);
    load_tile<DH, BLK>(sK + (nkv + t) * D::TILE, v + off, (size_t)KV * DH,
                       tid, nthr);
  }
  const int nbo = nb + FUSE;  // the bias operand's columns
  for (int e = tid; e < G * nbo; e += nthr)
    sBias[e] = bias[(size_t)h0 * nbo + e] * kLog2e;
  const int nvis = compact(mt, [&](int t) { return idxt_row[t]; }, sList,
                           sCnt);

  // visitor i into stage i % kStages: the group's q and dO rows of the
  // visiting q-block, their lse and delta, and the forward's bucket tile
  auto fetch = [&](int i) {
    const int st = i % kStages;
    const int2 e = sList[i];  // (q-row, forward slot)
    bf16* sQ = sStage + st * 2 * G * D::TILE;
    const size_t q_row0 = (size_t)b * S + (size_t)e.x * BLK;
    for (int w = 0; w < G; ++w) {
      const size_t off = (q_row0 * H + h0 + w) * DH;
      load_tile<DH, BLK>(sQ + w * D::TILE, q + off, (size_t)H * DH, tid,
                         nthr);
      load_tile<DH, BLK>(sQ + (G + w) * D::TILE, dout + off,
                         (size_t)H * DH, tid, nthr);
      const size_t r0 = ((size_t)b * H + h0 + w) * S + (size_t)e.x * BLK;
      load_bytes(sLse + (st * G + w) * BLK, lse + r0, BLK / 4, tid, nthr);
      load_bytes(sDl + (st * G + w) * BLK, delta + r0, BLK / 4, tid, nthr);
    }
    load_bytes(sBkt + st * D::BKT,
               bkt_graph + ((size_t)e.x * mb + e.y) * D::BKT, D::BKT / 16,
               tid, nthr);
  };
  // group 0: K, V and visitor 0; then one group per visitor
  for (int i = 0; i < kStages - 1; ++i) {
    if (i < nvis) fetch(i);
    cp_async_commit();
  }

  float dka[MT][D::NT][4], dva[MT][D::NT][4];
#pragma unroll
  for (int m2 = 0; m2 < MT; ++m2)
#pragma unroll
    for (int nt = 0; nt < D::NT; ++nt)
#pragma unroll
      for (int r = 0; r < 4; ++r) dka[m2][nt][r] = dva[m2][nt][r] = 0.f;
  const float* bias2 = sBias + warp * nbo;
  const bf16* sKw = sK + kvt * D::TILE;
  const bf16* sVw = sK + (nkv + kvt) * D::TILE;
  const int g = lane >> 2, c = lane & 3;

  for (int i = 0; i < nvis; ++i) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // visitor i landed; visitor i - 1's stage is free
    if (i + kStages - 1 < nvis) fetch(i + kStages - 1);
    cp_async_commit();
    const int st = i % kStages;
    const bf16* sQw = sStage + (st * 2 * G + warp) * D::TILE;
    const bf16* sDOw = sQw + G * D::TILE;
    const int8_t* bkt = sBkt + st * D::BKT;
    const float* lrow = sLse + (st * G + warp) * BLK;
    const float* drow = sDl + (st * G + warp) * BLK;

    // S^T (k rows x q columns), then P^T = exp2(S^T - lse) in place
    ScoreAcc<BLK> p, dp;
    zero<BLK>(p);
    zero<BLK>(dp);
    product_abt<DH, BLK>(p, sKw, sQw);
    product_abt<DH, BLK>(dp, sVw, sDOw);  // dP^T = V dO^T
#pragma unroll
    for (int nt = 0; nt < NS; ++nt)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int qc = nt * 8 + 2 * c + j;  // the q row of this column
        const float lse2 = lrow[qc] * kLog2e, dl = drow[qc];
        const int8_t* bcol = bkt + qc * BLK;
#pragma unroll
        for (int m2 = 0; m2 < MT; ++m2)
#pragma unroll
          for (int i2 = 0; i2 < 2; ++i2) {
            const int r = 2 * i2 + j;
            const float x =
                score2_sched(FUSE, p[m2][nt][r], scale2,
                             bcol[m2 * 16 + g + 8 * i2], bias2, nb);
            const float pv = ex2(x - lse2);
            p[m2][nt][r] = pv;
            dp[m2][nt][r] = pv * (dp[m2][nt][r] - dl);  // dS^T
          }
      }
    ScoreFrag<BLK> fa;
    to_a_frag<BLK>(p, fa);
    product_pb<DH, BLK>(dva, fa, sDOw);  // dV += P^T dO
    to_a_frag<BLK>(dp, fa);
    product_pb<DH, BLK>(dka, fa, sQw);   // dK += dS^T Q (scaled at the end)
  }
  cp_async_wait<0>();

  const size_t off = (k_row0 * H + h) * DH;
  store_rows(dka, RowMul<MT>(sm_scale).v, dk + off, (size_t)H * DH);
  store_rows(dva, RowMul<MT>(1.f).v, dv + off, (size_t)H * DH);
}

template <int DH, int BLK, bool FUSE>
int launch(const void* q, const void* k, const void* v, const void* dout,
           const void* lse, const void* delta, const void* block_idx_t,
           const void* buckets, const void* bias, void* dk, void* dv, int B,
           int S, int H, int KV, int nq, int mb, int nk, int mt, int nb,
           int per_graph, int per_graph_t, float sm_scale,
           cudaStream_t stream) {
  const int G = heads_per_cta(H, KV), nkv = kv_per_cta(G, H, KV);
  const size_t smem = dkv_smem_bytes<DH, BLK>(G, nkv, mt, nb + FUSE);
  cudaError_t err = cudaFuncSetAttribute(
      cluster_biased_dkv_sm90<DH, BLK, FUSE>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const unsigned grid = (unsigned)B * nk * (H / G);
  cluster_biased_dkv_sm90<DH, BLK, FUSE><<<grid, 32 * G, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<const int32_t*>(block_idx_t),
      static_cast<const int8_t*>(buckets), static_cast<const float*>(bias),
      static_cast<bf16*>(dk), static_cast<bf16*>(dv), S, H, KV, nq, mb, nk,
      mt, nb, per_graph, per_graph_t, G, nkv, sm_scale * kLog2e, sm_scale);
  return (int)cudaGetLastError();
}

// the instantiation of block BLK for head dim dh, or invalid value
template <int BLK>
int launch_dh(int dh, const void* q, const void* k, const void* v,
              const void* dout, const void* lse, const void* delta,
              const void* block_idx_t, const void* buckets, const void* bias,
              void* dk, void* dv, int B, int S, int H, int KV, int nq,
              int mb, int nk, int mt, int nb, int per_graph, int per_graph_t,
              int fuse, float sm_scale, cudaStream_t st) {
#define DKV_CASE(D)                                                        \
  case D:                                                                  \
    return (fuse ? launch<D, BLK, true> : launch<D, BLK, false>)(          \
        q, k, v, dout, lse, delta, block_idx_t, buckets, bias, dk, dv, B, S, \
        H, KV, nq, mb, nk, mt, nb, per_graph, per_graph_t, sm_scale, st);
  switch (dh) {
    DKV_CASE(8)
    DKV_CASE(16)
    DKV_CASE(24)
    DKV_CASE(32)
    DKV_CASE(40)
    DKV_CASE(48)
    DKV_CASE(56)
    DKV_CASE(64)
  }
#undef DKV_CASE
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// bf16 q, dout (B,S,H,Dh) and k/v (B,S,KV,Dh), all 16-byte aligned; lse,
// delta (B*H,S) fp32; block_idx_t (nk,mt,2) or (B,nk,mt,2) int32
// (per_graph_t selects) lists (q-row, forward slot) pairs, -1 padded;
// buckets (nq,mb,bq,bk) or (B,nq,mb,bq,bk) int8 (per_graph selects);
// bias (H,nb) fp32, (H,nb+1) with the sentinel column when fuse (0 or 1;
// no hoist argument, see the header); dk/dv (B,S,H,Dh) bf16, per q-head.
// Takes bq = bk in
// {16, 32} and Dh a multiple of 8 from 8 to 64; anything else returns
// cudaErrorInvalidValue. Returns the CUDA error code of the launch (0 =
// launched).
int cluster_attention_bwd_dkv_sm90(const void* q, const void* k,
                                   const void* v, const void* dout,
                                   const void* lse, const void* delta,
                                   const void* block_idx_t,
                                   const void* buckets, const void* bias,
                                   void* dk, void* dv, int B, int S, int H,
                                   int KV, int dh, int nq, int mb, int nk,
                                   int mt, int bq, int bk, int nb,
                                   int per_graph, int per_graph_t, int fuse,
                                   float sm_scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bq != bk || nq * bq != S || nk * bk != S)
    return (int)cudaErrorInvalidValue;
  if (bq == 16)
    return launch_dh<16>(dh, q, k, v, dout, lse, delta, block_idx_t,
                         buckets, bias, dk, dv, B, S, H, KV, nq, mb, nk, mt,
                         nb, per_graph, per_graph_t, fuse, sm_scale, st);
  if (bq == 32)
    return launch_dh<32>(dh, q, k, v, dout, lse, delta, block_idx_t,
                         buckets, bias, dk, dv, B, S, H, KV, nq, mb, nk, mt,
                         nb, per_graph, per_graph_t, fuse, sm_scale, st);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
