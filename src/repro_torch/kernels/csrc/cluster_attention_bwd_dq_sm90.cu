// Cluster-sparse attention dQ backward with int8 bias buckets on Hopper's
// tensor cores (sm_90a), for bf16 operands.
//
// Replaces the TPU kernel `_dq_kernel_biased` in
// src/repro/kernels/cluster_attention_bwd.py for bf16 inputs: the graph
// transformer's training path; fp32 stays on the CUDA-core kernel of
// cluster_attention_bwd.cu. Same function as that kernel and
// `kernels/ref.py` `bwd_dq`: for each q-block, over the k-blocks its
// forward row `block_idx[b, qi, :]` lists (-1 slots, wherever they stand,
// skipped), it rebuilds the forward's scores `(q . k) Dh^-0.5 + bias[h,
// min(bucket, nb-1)]` (bucket -1 -> the finite sentinel -1e30) and with
// the forward's fp32 lse and the caller's fp32 `delta = rowsum(dO * O)`
// accumulates, in fp32,
//   P   = exp(S - lse)             (dead rows carry lse = 0, so P = 0)
//   dS  = P o (dO V^T - delta)
//   dQ += Dh^-0.5 dS K
// and the row's bucket sums of dS, written as (B, H, nq, nb) fp32
// partials that the caller sums over graphs and q-rows into the
// bias_table gradient. No float atomics: each CTA owns its output rows and
// its partials, so the result is deterministic.
//
// The forward's rewrites: `hoist_scale` launches this same kernel (the
// scale rides the one fp32 FMA of each rebuilt score for both values of
// the flag; a scaled q is no bf16 value); `fuse_bias` is the `fuse`
// argument, which picks the kernel's FUSE instantiation: the table then
// nb + 1 wide with the sentinel column that the masked bucket looks up
// (biased_tiles.cuh `score2_fused`). The bucket
// sums stay nb wide: a masked entry's dS is 0.
//
// What bounds it on the card. At the nearly dense training rung of the
// 8192-node graph (S=8224, Graphormer-Large: H=KV=32, Dh=24, 64729
// visited 32 x 32 blocks) the three products are 6 * 64729 * 32 * 32 *
// 24 * 32 = 305 GFLOP, 0.31 ms at the bf16 tensor-core peak, against ~40
// MB of q, k, v, dO, lse, delta and dq plus 66 MB of bucket tiles (0.03
// ms at 3.35 TB/s); one exp2 per score and head, 2.1 G, is ~0.5 ms at 16
// a clock per SM. Beside them each score costs a few CUDA-core
// instructions for its bias, its dS and its bucket sum.
//
// What this design does about it (the mirror of the dK/dV kernel,
// cluster_attention_bwd_dkv_sm90.cu, with rows and columns turned round).
// * Tensor cores by `mma.sync.m16n8k16` (biased_tiles.cuh): S = Q K^T and
//   dP = dO V^T read the resident Q, dO (A) and the visited K, V (B) by
//   `ldmatrix`; dS goes from the accumulator registers into the A
//   fragments of dQ += dS K, K read with `ldmatrix.trans` (bf16 dS: the
//   gradients are held norm-relative, as the other bf16 backwards hold
//   them). Dh^-0.5 is applied once, at the store.
// * One CTA per (graph, q-block, group of G heads), G <= 4, one warp per
//   head owning its BLK x Dh dQ accumulator (BLK = bq = bk, 16 or 32, a
//   template parameter picked at launch) and its rows' lse and delta in
//   registers. The group's Q and dO tiles stay resident for the whole
//   walk; the visit list and each visited bucket tile are read once per
//   group and K, V once per kv-head (shared by the q-heads of one kv-head
//   under GQA).
// * A ring of two shared-memory stages filled by `cp.async`: the next
//   visit's K, V and bucket tile are in flight while the warps compute the
//   current one. No thread spins on a barrier.
// * The bias gradient sums the fp32 dS of the accumulators, not the bf16
//   A fragment (the bias gradient cancels over whole rows, and is the
//   most rounding-sensitive output). Each lane adds its entries into
//   kBucketRegs registers by a select on the bucket, one group of buckets
//   at a time, then into its own shared-memory slot of each bucket
//   (bucket-major, so a warp's 32 slots lie on 32 banks); at the end a
//   fixed-order butterfly over the warp and one write per (graph, head,
//   q-block). Any nb the forward takes works.
// * The heavy row. The global token's q-block visits every k-block (755
//   at the serve shape, 257 on the sparse training rung, against a mean
//   of ~13 and ~10). The wrapper cuts such rows as the bf16 forward cuts
//   them (kernels/cluster_attention.py `fwd_plan`): each piece writes its
//   fp32 partial dQ and bucket sums to its own slot, and
//   `cluster_biased_dq_combine` sums a row's slots in slot order.

#include "biased_tiles.cuh"

namespace {

using bf16 = __nv_bfloat16;
using namespace biased;

constexpr int kBucketRegs = 4;  // bucket sums a lane keeps in registers

// Shared memory: the G q tiles and G dO tiles, then kStages stages of (nkv
// K tiles, nkv V tiles), the stages' bucket tiles, the compacted visits
// (slot, block), kMaxWarps ints of scratch, the G bias rows, and each
// thread's sum of every bucket (nb x 32 G).
template <int DH, int BLK>
size_t dq_smem_bytes(int G, int nkv, int mb, int nb, int nbo) {
  using D = Dims<DH, BLK>;
  return (size_t)(2 * G + kStages * 2 * nkv) * D::TILE * sizeof(bf16) +
         (size_t)kStages * D::BKT + (size_t)mb * sizeof(int2) +
         kMaxWarps * sizeof(int) + (size_t)G * nbo * sizeof(float) +
         (size_t)nb * 32 * G * sizeof(float);
}

template <int DH, int BLK, bool FUSE>
__global__ void __launch_bounds__(kMaxWarps * 32, DH <= 24 ? 3 : 2)
cluster_biased_dq_sm90(const bf16* __restrict__ q,
                       const bf16* __restrict__ k,
                       const bf16* __restrict__ v,
                       const bf16* __restrict__ dout,
                       const float* __restrict__ lse,
                       const float* __restrict__ delta,
                       const int32_t* __restrict__ block_idx,
                       const int8_t* __restrict__ buckets,
                       const float* __restrict__ bias,
                       const int4* __restrict__ pieces,
                       bf16* __restrict__ dq, float* __restrict__ db_part,
                       float* __restrict__ part_dq,
                       float* __restrict__ part_db, int S, int H, int KV,
                       int nq, int mb, int nb, int per_graph, int G, int nkv,
                       float scale2, float sm_scale) {
  using D = Dims<DH, BLK>;
  constexpr int MT = D::MT, NS = D::NS;
  extern __shared__ __align__(16) uint8_t smem[];
  const int tid = threadIdx.x, nthr = blockDim.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int ngrp = H / G;
  const int grp = blockIdx.x % ngrp;
  // the whole row of the plain grid, or the split grid's work item:
  // (b * nq + qi, first visit, end visit, partial slot or -1 for a whole
  // row written directly)
  const int4 item = pieces != nullptr
                        ? pieces[blockIdx.x / ngrp]
                        : make_int4(blockIdx.x / ngrp, 0, mb, -1);
  const int qi = item.x % nq;
  const int b = item.x / nq;
  const int rep = H / KV;
  const int h0 = grp * G, kv0 = h0 / rep;
  const int h = h0 + warp, kvt = h / rep - kv0;

  bf16* sQ = reinterpret_cast<bf16*>(smem);  // G q tiles, then G dO tiles
  bf16* sStage = sQ + 2 * G * D::TILE;
  int8_t* sBkt = reinterpret_cast<int8_t*>(sStage + kStages * 2 * nkv *
                                                        D::TILE);
  int2* sList = reinterpret_cast<int2*>(sBkt + kStages * D::BKT);
  int* sCnt = reinterpret_cast<int*>(sList + mb);
  const int nbo = nb + FUSE;  // the bias operand's columns
  float* sBias = reinterpret_cast<float*>(sCnt + kMaxWarps);
  float* sDb = sBias + G * nbo;

  const int gl = per_graph ? b : 0;
  const int32_t* idx_row = block_idx + ((size_t)gl * nq + qi) * mb;
  const int8_t* bkt_row =
      buckets + ((size_t)gl * nq + qi) * mb * (size_t)D::BKT;
  const size_t q_row0 = (size_t)b * S + (size_t)qi * BLK;

  clear_pad<DH, BLK>(sQ, 2 * G + kStages * 2 * nkv, tid, nthr);
  for (int w = 0; w < G; ++w) {
    const size_t off = (q_row0 * H + h0 + w) * DH;
    load_tile<DH, BLK>(sQ + w * D::TILE, q + off, (size_t)H * DH, tid,
                       nthr);
    load_tile<DH, BLK>(sQ + (G + w) * D::TILE, dout + off, (size_t)H * DH,
                       tid, nthr);
  }
  for (int e = tid; e < G * nbo; e += nthr)
    sBias[e] = bias[(size_t)h0 * nbo + e] * kLog2e;
  for (int e = tid; e < nb * nthr; e += nthr) sDb[e] = 0.f;
  const int nvis = compact(
      mb, [&](int m) { return make_int2(idx_row[m] >= 0 ? m : -1,
                                        idx_row[m]); },
      sList, sCnt);

  // visit i into stage i % kStages: the group's K and V rows of the
  // visited k-block and its bucket tile
  auto fetch = [&](int i) {
    const int st = i % kStages;
    const int2 e = sList[i];
    bf16* sK = sStage + st * 2 * nkv * D::TILE;
    const size_t k_row0 = (size_t)b * S + (size_t)e.y * BLK;
    for (int t = 0; t < nkv; ++t) {
      const size_t off = (k_row0 * KV + kv0 + t) * DH;
      load_tile<DH, BLK>(sK + t * D::TILE, k + off, (size_t)KV * DH, tid,
                         nthr);
      load_tile<DH, BLK>(sK + (nkv + t) * D::TILE, v + off,
                         (size_t)KV * DH, tid, nthr);
    }
    load_bytes(sBkt + st * D::BKT, bkt_row + (size_t)e.x * D::BKT,
               D::BKT / 16, tid, nthr);
  };
  // this item's visits v0..v1-1 of the compacted row
  const int v0 = item.y, nit = max(min(nvis, item.z) - v0, 0);
  // group 0: q, dO and visit v0; then one group per visit
  for (int i = 0; i < kStages - 1; ++i) {
    if (i < nit) fetch(v0 + i);
    cp_async_commit();
  }

  // the lse (base 2) and delta of the 2 MT rows the thread holds, row
  // 16 mt + g + 8 i in [mt][i]
  const int g = lane >> 2, c = lane & 3;
  float lse2[MT][2], dl[MT][2];
  const size_t r0 = ((size_t)b * H + h) * S + (size_t)qi * BLK;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int i2 = 0; i2 < 2; ++i2) {
      lse2[mt][i2] = lse[r0 + mt * 16 + g + 8 * i2] * kLog2e;
      dl[mt][i2] = delta[r0 + mt * 16 + g + 8 * i2];
    }
  float dqa[MT][D::NT][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < D::NT; ++nt)
#pragma unroll
      for (int r = 0; r < 4; ++r) dqa[mt][nt][r] = 0.f;
  const float* bias2 = sBias + warp * nbo;
  const bf16* sQw = sQ + warp * D::TILE;
  const bf16* sDOw = sQ + (G + warp) * D::TILE;
  float* db_own = sDb + tid;  // this thread's bucket sums, nthr apart

  for (int i = 0; i < nit; ++i) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // visit i landed; visit i - 1's stage is free
    if (i + kStages - 1 < nit) fetch(v0 + i + kStages - 1);
    cp_async_commit();
    const int st = (v0 + i) % kStages;
    const bf16* sK = sStage + (st * 2 * nkv + kvt) * D::TILE;
    const bf16* sV = sK + nkv * D::TILE;
    const int8_t* bkt = sBkt + st * D::BKT;

    // S (q rows x k columns) and dP = dO V^T, then dS in place of S
    ScoreAcc<BLK> s, dp;
    zero<BLK>(s);
    zero<BLK>(dp);
    product_abt<DH, BLK>(s, sQw, sK);
    product_abt<DH, BLK>(dp, sDOw, sV);
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int i2 = 0; i2 < 2; ++i2) {
        const int8_t* brow = bkt + (mt * 16 + g + 8 * i2) * BLK + 2 * c;
#pragma unroll
        for (int nt = 0; nt < NS; ++nt) {
          const char2 bb = *reinterpret_cast<const char2*>(brow + nt * 8);
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const float x = score2_sched(FUSE, s[mt][nt][2 * i2 + j],
                                         scale2, j ? bb.y : bb.x, bias2,
                                         nb);
            s[mt][nt][2 * i2 + j] = ex2(x - lse2[mt][i2]) *
                                    (dp[mt][nt][2 * i2 + j] - dl[mt][i2]);
          }
        }
      }
    // the visit's bucket sums of the fp32 dS, kBucketRegs buckets a pass
    // (masked entries have dS = 0 and a negative bucket: they match none)
    for (int j0 = 0; j0 < nb; j0 += kBucketRegs) {
      float part[kBucketRegs];
#pragma unroll
      for (int jj = 0; jj < kBucketRegs; ++jj) part[jj] = 0.f;
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int i2 = 0; i2 < 2; ++i2) {
          const int8_t* brow = bkt + (mt * 16 + g + 8 * i2) * BLK + 2 * c;
#pragma unroll
          for (int nt = 0; nt < NS; ++nt) {
            const char2 bb = *reinterpret_cast<const char2*>(brow + nt * 8);
#pragma unroll
            for (int j = 0; j < 2; ++j) {
              const int rel = min((int)(j ? bb.y : bb.x), nb - 1) - j0;
#pragma unroll
              for (int jj = 0; jj < kBucketRegs; ++jj)
                if (rel == jj) part[jj] += s[mt][nt][2 * i2 + j];
            }
          }
        }
#pragma unroll
      for (int jj = 0; jj < kBucketRegs; ++jj)
        if (j0 + jj < nb) db_own[(j0 + jj) * nthr] += part[jj];
    }
    ScoreFrag<BLK> fa;
    to_a_frag<BLK>(s, fa);
    product_pb<DH, BLK>(dqa, fa, sK);  // dQ += dS K (scaled at the store)
  }
  cp_async_wait<0>();

  // the head's bucket sums: each lane's own slots, then a fixed-order
  // butterfly over the warp; one write per bucket
  float* db_row = item.w >= 0
                      ? part_db + ((size_t)item.w * H + h) * nb
                      : db_part + (((size_t)b * H + h) * nq + qi) * nb;
  for (int j = 0; j < nb; ++j) {
    float x = db_own[j * nthr];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      x += __shfl_xor_sync(0xffffffffu, x, o);
    if (lane == 0) db_row[j] = x;
  }
  if (item.w >= 0)  // a piece of a split row: fp32 partial dQ in its slot
    store_rows(dqa, RowMul<MT>(sm_scale).v,
               part_dq + ((size_t)item.w * H + h) * BLK * DH, DH);
  else
    store_rows(dqa, RowMul<MT>(sm_scale).v, dq + (q_row0 * H + h) * DH,
               (size_t)H * DH);
}

// The split rows: one CTA per (split row, head) sums the row's partial
// slots first..first+n-1 in that order into dQ and the bucket partials.
// `splits` holds (b * nq + qi, first slot, n, 0); a partial slot holds bq
// rows of dh.
__global__ void __launch_bounds__(128)
cluster_biased_dq_combine(const int4* __restrict__ splits,
                          const float* __restrict__ part_dq,
                          const float* __restrict__ part_db,
                          bf16* __restrict__ dq, float* __restrict__ db_part,
                          int S, int H, int nq, int bq, int dh, int nb) {
  const int h = blockIdx.x % H;
  const int4 sp = splits[blockIdx.x / H];
  const int qi = sp.x % nq, b = sp.x / nq;
  const size_t q_row0 = (size_t)b * S + (size_t)qi * bq;
  for (int e = threadIdx.x; e < bq * dh; e += blockDim.x) {
    const int r = e / dh, d = e - r * dh;
    float x = 0.f;
    for (int p = 0; p < sp.z; ++p)
      x += part_dq[((size_t)(sp.y + p) * H + h) * bq * dh + e];
    dq[((q_row0 + r) * H + h) * dh + d] = __float2bfloat16(x);
  }
  for (int j = threadIdx.x; j < nb; j += blockDim.x) {
    float x = 0.f;
    for (int p = 0; p < sp.z; ++p)
      x += part_db[((size_t)(sp.y + p) * H + h) * nb + j];
    db_part[(((size_t)b * H + h) * nq + qi) * nb + j] = x;
  }
}

template <int DH, int BLK, bool FUSE>
int launch(const void* q, const void* k, const void* v, const void* dout,
           const void* lse, const void* delta, const void* block_idx,
           const void* buckets, const void* bias, const void* pieces,
           const void* splits, void* dq, void* db_part, void* part_dq,
           void* part_db, int B, int S, int H, int KV, int nq, int mb,
           int nb, int per_graph, int n_pieces, int n_splits,
           float sm_scale, cudaStream_t stream) {
  const int G = heads_per_cta(H, KV), nkv = kv_per_cta(G, H, KV);
  const size_t smem = dq_smem_bytes<DH, BLK>(G, nkv, mb, nb, nb + FUSE);
  cudaError_t err = cudaFuncSetAttribute(
      cluster_biased_dq_sm90<DH, BLK, FUSE>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const unsigned rows = pieces != nullptr ? (unsigned)n_pieces
                                          : (unsigned)B * nq;
  cluster_biased_dq_sm90<DH, BLK, FUSE>
      <<<rows * (H / G), 32 * G, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<const int32_t*>(block_idx),
      static_cast<const int8_t*>(buckets), static_cast<const float*>(bias),
      static_cast<const int4*>(pieces), static_cast<bf16*>(dq),
      static_cast<float*>(db_part), static_cast<float*>(part_dq),
      static_cast<float*>(part_db), S, H, KV, nq, mb, nb, per_graph, G, nkv,
      sm_scale * kLog2e, sm_scale);
  err = cudaGetLastError();
  if (err != cudaSuccess || n_splits == 0) return (int)err;
  cluster_biased_dq_combine<<<(unsigned)n_splits * H, 128, 0, stream>>>(
      static_cast<const int4*>(splits), static_cast<const float*>(part_dq),
      static_cast<const float*>(part_db), static_cast<bf16*>(dq),
      static_cast<float*>(db_part), S, H, nq, BLK, DH, nb);
  return (int)cudaGetLastError();
}

// the instantiation of block BLK for head dim dh, or invalid value
template <int BLK>
int launch_dh(int dh, const void* q, const void* k, const void* v,
              const void* dout, const void* lse, const void* delta,
              const void* block_idx, const void* buckets, const void* bias,
              const void* pieces, const void* splits, void* dq,
              void* db_part, void* part_dq, void* part_db, int B, int S,
              int H, int KV, int nq, int mb, int nb, int per_graph,
              int n_pieces, int n_splits, int fuse, float sm_scale,
              cudaStream_t st) {
#define DQ_CASE(D)                                                          \
  case D:                                                                   \
    return (fuse ? launch<D, BLK, true> : launch<D, BLK, false>)(           \
        q, k, v, dout, lse, delta, block_idx, buckets, bias, pieces, splits, \
        dq, db_part, part_dq, part_db, B, S, H, KV, nq, mb, nb, per_graph,  \
        n_pieces, n_splits, sm_scale, st);
  switch (dh) {
    DQ_CASE(8)
    DQ_CASE(16)
    DQ_CASE(24)
    DQ_CASE(32)
    DQ_CASE(40)
    DQ_CASE(48)
    DQ_CASE(56)
    DQ_CASE(64)
  }
#undef DQ_CASE
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// bf16 q, dout and dq (B,S,H,Dh), k/v (B,S,KV,Dh), all 16-byte aligned;
// lse, delta (B*H,S) fp32; block_idx (nq,mb) or (B,nq,mb) int32
// (per_graph selects), buckets the matching (...,bq,bk) int8; bias (H,nb)
// fp32, (H,nb+1) with the sentinel column when fuse (0 or 1; no hoist
// argument, see the header); db_part (B,H,nq,nb) fp32. pieces NULL runs
// one CTA group per
// q-block row; else it lists n_pieces int4 work items (b*nq+qi, v0, v1,
// slot or -1), and splits the n_splits int4 rows (b*nq+qi, first slot, n,
// 0) to sum from part_dq (slots,H,bq,Dh) and part_db (slots,H,nb) fp32
// scratch. Takes bq = bk in {16, 32} and Dh a multiple of 8 from 8 to 64;
// anything else returns cudaErrorInvalidValue. Returns the CUDA error
// code of the launches (0 = launched).
int cluster_attention_bwd_dq_sm90(const void* q, const void* k,
                                  const void* v, const void* dout,
                                  const void* lse, const void* delta,
                                  const void* block_idx, const void* buckets,
                                  const void* bias, const void* pieces,
                                  const void* splits, void* dq,
                                  void* db_part, void* part_dq,
                                  void* part_db, int B, int S, int H, int KV,
                                  int dh, int nq, int mb, int bq, int bk,
                                  int nb, int per_graph, int n_pieces,
                                  int n_splits, int fuse, float sm_scale,
                                  void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bq != bk || nq * bq != S) return (int)cudaErrorInvalidValue;
  if (bq == 16)
    return launch_dh<16>(dh, q, k, v, dout, lse, delta, block_idx, buckets,
                         bias, pieces, splits, dq, db_part, part_dq, part_db,
                         B, S, H, KV, nq, mb, nb, per_graph, n_pieces,
                         n_splits, fuse, sm_scale, st);
  if (bq == 32)
    return launch_dh<32>(dh, q, k, v, dout, lse, delta, block_idx, buckets,
                         bias, pieces, splits, dq, db_part, part_dq, part_db,
                         B, S, H, KV, nq, mb, nb, per_graph, n_pieces,
                         n_splits, fuse, sm_scale, st);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
