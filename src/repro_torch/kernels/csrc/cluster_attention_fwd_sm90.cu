// Cluster-sparse attention forward with int8 bias buckets on Hopper's
// tensor cores (sm_90a), for bf16 q, k and v.
//
// Replaces the TPU kernel `_cluster_kernel_biased` in
// src/repro/kernels/cluster_attention.py for bf16 inputs: the graph
// transformer's path (serving, and every sparse training step); fp32
// inputs stay on cluster_attention_fwd.cu, on CUDA cores (TF32 would not
// meet their tolerances). Same function as that kernel and
// `kernels/ref.py` `cluster_sparse_attention`: for each q-block row an
// online softmax over the k-blocks its `block_idx` row lists (-1 slots,
// wherever they stand, skipped), scores `(q . k) Dh^-0.5 +
// bias[h, min(bucket, nb-1)]` in fp32, bucket -1 -> the finite sentinel
// -1e30; O in bf16 and the natural logsumexp lse (B*H, S) in fp32. Rows
// with no unmasked entry write O = 0 and lse = 0.
//
// `hoist_scale` launches this same kernel: q Dh^-0.5 is no bf16 value,
// so the scale rides the one fp32 FMA of each score (with log2 e) for
// both values of the flag, which differ by fp32 rounding alone.
// `fuse_bias` is the `fuse` argument, which picks the kernel's FUSE
// instantiation: the table comes with the sentinel column (nb + 1 wide)
// and the scores look the bucket up in it (biased_tiles.cuh
// `score2_fused`) instead of selecting the mask.
//
// What bounds it on the card. At the nearly dense training rung of the
// 8192-node graph (S=8224, Graphormer-Large: H=KV=32, Dh=24, 64729 of
// 66049 32 x 32 blocks visited) the products are 4 * 64729 * 32 * 32 *
// 24 * 32 = 204 GFLOP, 0.21 ms at the bf16 tensor-core peak, against
// ~25 MB of q, k, v and O plus 66 MB of bucket tiles (0.03 ms at 3.35
// TB/s). The exponentials are not free at Dh 24: one exp2 per score and
// head is 2.1 G, ~0.5 ms at 16 a clock per SM, above the tensor bound.
// At the serve shape (S=32800, 13125 blocks) the products are 41 GFLOP.
// The graph-level task's packed mini-graphs (GT: 128 graphs of S=128,
// H=8, Dh=16, 16 x 16 blocks) are small: a few MB of q, k, v and O, read
// once, bound the kernel by bytes.
//
// What this design does about it.
// * Tensor cores by `mma.sync.m16n8k16` (biased_tiles.cuh): one warp per
//   head owns the BLK x Dh O tile of its q-block (BLK = bq = bk, 16 or
//   32, a template parameter picked at launch), S = Q K^T and O += P V
//   with P repacked from the accumulator registers into the next
//   product's A fragments. Dh is padded with zeros to a multiple of 16
//   for the q.k depth only.
// * One CTA per (graph, q-block, group of G heads), G <= 4 (heads fastest
//   in the grid, so the groups of one q-block share L2). The q-block's
//   `block_idx` row and each visited bucket tile are read once per group,
//   not once per head; under GQA the q-heads of one kv-head share its K
//   and V tiles in shared memory.
// * A ring of two shared-memory stages filled by `cp.async`: while the
//   warps compute one visited block, the next one's K, V and bucket tile
//   are in flight. The visits are compacted once per CTA, so -1 slots
//   cost nothing in the loop. No thread spins on a barrier: each waits
//   in `cp.async.wait_group` and `__syncthreads`.
// * The bias row of each head sits in shared memory scaled by log2 e, so
//   a score is one FMA and one exp2.
// * O += P V runs as P_hi V + P_lo V (biased_tiles.cuh
//   `to_a_frag_split`): with P rounded once to bf16, O's error fed the
//   backward's delta = rowsum(dO * O), and the bias gradient, a sum of
//   ds over whole rows that cancels, missed its tolerance on the nearly
//   dense training rung.
// * The heavy row. The global token's q-block visits 755 of 1025
//   k-blocks at the serve shape, and one CTA walking it serially cost the
//   kernel 41% of its time. The wrapper (kernels/cluster_attention.py
//   `fwd_plan`, derived once per layout tensor) cuts a row with more
//   visits than max(64, 4 x the mean) into pieces: `pieces` lists the
//   work items (row, visits v0..v1, partial slot), split rows first.
//   A piece writes its fp32 running max, sum and unnormalized O to a
//   partial slot, and `cluster_biased_fwd_combine` merges the slots of a
//   row in a fixed order, so the result stays deterministic. Layouts
//   without such a row (the training rungs) keep the plain grid.

#include "biased_tiles.cuh"

namespace {

using bf16 = __nv_bfloat16;
using namespace biased;

// Shared memory: the G q tiles, then kStages stages of (nkv K tiles, nkv
// V tiles), the stages' bucket tiles, the compacted visits (slot, block),
// kMaxWarps ints of scratch, the G bias rows.
template <int DH, int BLK>
size_t fwd_smem_bytes(int G, int nkv, int mb, int nb) {
  using D = Dims<DH, BLK>;
  return (size_t)(G + kStages * 2 * nkv) * D::TILE * sizeof(bf16) +
         (size_t)kStages * D::BKT + (size_t)mb * sizeof(int2) +
         kMaxWarps * sizeof(int) + (size_t)G * nb * sizeof(float);
}

template <int DH, int BLK, bool FUSE>
__global__ void __launch_bounds__(kMaxWarps * 32, 2)
cluster_biased_fwd_sm90(const bf16* __restrict__ q,
                        const bf16* __restrict__ k,
                        const bf16* __restrict__ v,
                        const int32_t* __restrict__ block_idx,
                        const int8_t* __restrict__ buckets,
                        const float* __restrict__ bias,
                        const int4* __restrict__ pieces,
                        bf16* __restrict__ out, float* __restrict__ lse,
                        float* __restrict__ part_o,
                        float* __restrict__ part_ml, int S, int H, int KV,
                        int nq, int mb, int nb, int per_graph, int G,
                        int nkv, float scale2) {
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

  bf16* sQ = reinterpret_cast<bf16*>(smem);
  bf16* sStage = sQ + G * D::TILE;
  int8_t* sBkt = reinterpret_cast<int8_t*>(sStage + kStages * 2 * nkv *
                                                        D::TILE);
  int2* sList = reinterpret_cast<int2*>(sBkt + kStages * D::BKT);
  int* sCnt = reinterpret_cast<int*>(sList + mb);
  float* sBias = reinterpret_cast<float*>(sCnt + kMaxWarps);

  const int gl = per_graph ? b : 0;
  const int32_t* idx_row = block_idx + ((size_t)gl * nq + qi) * mb;
  const int8_t* bkt_row =
      buckets + ((size_t)gl * nq + qi) * mb * (size_t)D::BKT;
  const size_t q_row0 = (size_t)b * S + (size_t)qi * BLK;

  clear_pad<DH, BLK>(sQ, G + kStages * 2 * nkv, tid, nthr);
  for (int w = 0; w < G; ++w)
    load_tile<DH, BLK>(sQ + w * D::TILE, q + (q_row0 * H + h0 + w) * DH,
                       (size_t)H * DH, tid, nthr);
  const int nbo = nb + FUSE;  // the bias operand's columns
  for (int e = tid; e < G * nbo; e += nthr)
    sBias[e] = bias[(size_t)h0 * nbo + e] * kLog2e;
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
  // group 0: q and visit v0; then one group per visit
  for (int i = 0; i < kStages - 1; ++i) {
    if (i < nit) fetch(v0 + i);
    cp_async_commit();
  }

  float o[MT][D::NT][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < D::NT; ++nt)
#pragma unroll
      for (int r = 0; r < 4; ++r) o[mt][nt][r] = 0.f;
  OnlineSoftmax<BLK> sm;
  const float* bias2 = sBias + warp * nbo;
  const int g = lane >> 2, c = lane & 3;

  for (int i = 0; i < nit; ++i) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // visit i landed; visit i - 1's stage is free
    if (i + kStages - 1 < nit) fetch(v0 + i + kStages - 1);
    cp_async_commit();
    const int st = (v0 + i) % kStages;
    const bf16* sK = sStage + (st * 2 * nkv + kvt) * D::TILE;
    const bf16* sV = sK + nkv * D::TILE;
    const int8_t* bkt = sBkt + st * D::BKT;

    ScoreAcc<BLK> s;
    zero<BLK>(s);
    product_abt<DH, BLK>(s, sQ + warp * D::TILE, sK);
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int i2 = 0; i2 < 2; ++i2) {
        const int8_t* brow = bkt + (mt * 16 + g + 8 * i2) * BLK + 2 * c;
#pragma unroll
        for (int nt = 0; nt < NS; ++nt) {
          const char2 bb = *reinterpret_cast<const char2*>(brow + nt * 8);
          s[mt][nt][2 * i2] = score2_sched(FUSE, s[mt][nt][2 * i2], scale2,
                                           bb.x, bias2, nb);
          s[mt][nt][2 * i2 + 1] = score2_sched(
              FUSE, s[mt][nt][2 * i2 + 1], scale2, bb.y, bias2, nb);
        }
      }
    sm.update(s, o);
    ScoreFrag<BLK> hi, lo;
    to_a_frag_split<BLK>(s, hi, lo);
    product_pb<DH, BLK>(o, hi, sV);
    product_pb<DH, BLK>(o, lo, sV);
  }
  cp_async_wait<0>();

  sm.finish();
  if (item.w >= 0) {
    // a piece of a split row: its running max (base 2), sum and
    // unnormalized O into partial slot item.w
    const size_t slot = (size_t)item.w * H + h;
    store_rows(o, RowMul<MT>(1.f).v, part_o + slot * BLK * DH, DH);
    if (c == 0) {
      float* ml = part_ml + slot * 2 * BLK;
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int i2 = 0; i2 < 2; ++i2) {
          ml[mt * 16 + g + 8 * i2] = sm.m[mt][i2];
          ml[BLK + mt * 16 + g + 8 * i2] = sm.l[mt][i2];
        }
    }
    return;
  }
  float inv[MT][2];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int i2 = 0; i2 < 2; ++i2)
      inv[mt][i2] = __fdividef(1.f, fmaxf(sm.l[mt][i2], 1e-30f));
  store_rows(o, inv, out + (q_row0 * H + h) * DH, (size_t)H * DH);
  if (lse != nullptr && c == 0) {
    float* lrow = lse + ((size_t)b * H + h) * S + (size_t)qi * BLK;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int i2 = 0; i2 < 2; ++i2)
        lrow[mt * 16 + g + 8 * i2] = sm.lse(mt, i2);
  }
}

// The split rows: one CTA per (split row, head) merges the row's partial
// slots first..first+n-1 in that order into O and lse. `splits` holds
// (b * nq + qi, first slot, n, 0).
template <int DH, int BLK>
__global__ void __launch_bounds__(128)
cluster_biased_fwd_combine(const int4* __restrict__ splits,
                           const float* __restrict__ part_o,
                           const float* __restrict__ part_ml,
                           bf16* __restrict__ out, float* __restrict__ lse,
                           int S, int H, int nq) {
  const int h = blockIdx.x % H;
  const int4 sp = splits[blockIdx.x / H];
  const int qi = sp.x % nq, b = sp.x / nq;
  const size_t q_row0 = (size_t)b * S + (size_t)qi * BLK;
  for (int e = threadIdx.x; e < BLK * DH; e += blockDim.x) {
    const int r = e / DH, d = e - r * DH;
    float mx = kNegInf;
    for (int p = 0; p < sp.z; ++p)
      mx = fmaxf(mx, part_ml[((size_t)(sp.y + p) * H + h) * 2 * BLK + r]);
    float l = 0.f, o = 0.f;
    for (int p = 0; p < sp.z; ++p) {
      const size_t slot = (size_t)(sp.y + p) * H + h;
      const float w = ex2(part_ml[slot * 2 * BLK + r] - mx);
      l += part_ml[slot * 2 * BLK + BLK + r] * w;
      o += part_o[(slot * BLK + r) * DH + d] * w;
    }
    out[((q_row0 + r) * H + h) * DH + d] =
        __float2bfloat16(o / fmaxf(l, 1e-30f));
    if (lse != nullptr && d == 0)
      lse[((size_t)b * H + h) * S + (size_t)qi * BLK + r] =
          l > 0.f ? (mx + log2f(l)) * kLn2 : 0.f;
  }
}

template <int DH, int BLK, bool FUSE>
int launch(const void* q, const void* k, const void* v, const void* block_idx,
           const void* buckets, const void* bias, const void* pieces,
           const void* splits, void* out, void* lse, void* part_o,
           void* part_ml, int B, int S, int H, int KV, int nq, int mb,
           int nb, int per_graph, int n_pieces, int n_splits,
           float sm_scale, cudaStream_t stream) {
  const int G = heads_per_cta(H, KV), nkv = kv_per_cta(G, H, KV);
  const size_t smem = fwd_smem_bytes<DH, BLK>(G, nkv, mb, nb + FUSE);
  cudaError_t err = cudaFuncSetAttribute(
      cluster_biased_fwd_sm90<DH, BLK, FUSE>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const unsigned rows = pieces != nullptr ? (unsigned)n_pieces
                                          : (unsigned)B * nq;
  cluster_biased_fwd_sm90<DH, BLK, FUSE><<<rows * (H / G), 32 * G, smem,
                                           stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const int32_t*>(block_idx),
      static_cast<const int8_t*>(buckets), static_cast<const float*>(bias),
      static_cast<const int4*>(pieces), static_cast<bf16*>(out),
      static_cast<float*>(lse), static_cast<float*>(part_o),
      static_cast<float*>(part_ml), S, H, KV, nq, mb, nb, per_graph, G, nkv,
      sm_scale * kLog2e);
  err = cudaGetLastError();
  if (err != cudaSuccess || n_splits == 0) return (int)err;
  cluster_biased_fwd_combine<DH, BLK>
      <<<(unsigned)n_splits * H, 128, 0, stream>>>(
          static_cast<const int4*>(splits),
          static_cast<const float*>(part_o),
          static_cast<const float*>(part_ml), static_cast<bf16*>(out),
          static_cast<float*>(lse), S, H, nq);
  return (int)cudaGetLastError();
}

// the instantiation of block BLK for head dim dh, or invalid value
template <int BLK>
int launch_dh(int dh, const void* q, const void* k, const void* v,
              const void* block_idx, const void* buckets, const void* bias,
              const void* pieces, const void* splits, void* out, void* lse,
              void* part_o, void* part_ml, int B, int S, int H, int KV,
              int nq, int mb, int nb, int per_graph, int n_pieces,
              int n_splits, int fuse, float sm_scale, cudaStream_t st) {
#define FWD_CASE(D)                                                        \
  case D:                                                                  \
    return (fuse ? launch<D, BLK, true> : launch<D, BLK, false>)(          \
        q, k, v, block_idx, buckets, bias, pieces, splits, out, lse, part_o, \
        part_ml, B, S, H, KV, nq, mb, nb, per_graph, n_pieces, n_splits,   \
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
  }
#undef FWD_CASE
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// bf16 q (B,S,H,Dh), k/v (B,S,KV,Dh), out like q, all 16-byte aligned;
// block_idx (nq,mb) or (B,nq,mb) int32 (per_graph selects), buckets the
// matching (...,bq,bk) int8; bias (H,nb) fp32, (H,nb+1) with the sentinel
// column when fuse (0 or 1); lse (B*H,S) fp32 or NULL. No hoist argument:
// both values compute the same thing here (see the header).
// pieces NULL runs one CTA group per q-block row; else it lists n_pieces
// int4 work items (b*nq+qi, v0, v1, slot or -1), and splits the n_splits
// int4 rows (b*nq+qi, first slot, n, 0) to combine from part_o
// (slots,H,bq,Dh) and part_ml (slots,H,2,bq) fp32 scratch. Takes bq = bk
// in {16, 32} and Dh a multiple of 8 from 8 to 64; anything else returns
// cudaErrorInvalidValue. Returns the CUDA error code of the launches (0
// = launched).
int cluster_attention_fwd_sm90(const void* q, const void* k, const void* v,
                               const void* block_idx, const void* buckets,
                               const void* bias, const void* pieces,
                               const void* splits, void* out, void* lse,
                               void* part_o, void* part_ml, int B, int S,
                               int H, int KV, int dh, int nq, int mb, int bq,
                               int bk, int nb, int per_graph, int n_pieces,
                               int n_splits, int fuse, float sm_scale,
                               void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bq != bk || nq * bq != S) return (int)cudaErrorInvalidValue;
  if (bq == 16)
    return launch_dh<16>(dh, q, k, v, block_idx, buckets, bias, pieces,
                         splits, out, lse, part_o, part_ml, B, S, H, KV, nq,
                         mb, nb, per_graph, n_pieces, n_splits, fuse,
                         sm_scale, st);
  if (bq == 32)
    return launch_dh<32>(dh, q, k, v, block_idx, buckets, bias, pieces,
                         splits, out, lse, part_o, part_ml, B, S, H, KV, nq,
                         mb, nb, per_graph, n_pieces, n_splits, fuse,
                         sm_scale, st);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
