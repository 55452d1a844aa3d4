// Tensor-core building blocks of the bf16 biased cluster-sparse kernels
// (cluster_attention_fwd_sm90.cu, cluster_attention_bwd_dq_sm90.cu,
// cluster_attention_bwd_dkv_sm90.cu):
// warp-level `mma.sync.m16n8k16` products (bf16 in, fp32 accumulate) on
// BLK-row tiles fed by `ldmatrix`, the `cp.async` copies that fill a ring
// of shared-memory stages, the bucket-to-bias lookup, the register online
// softmax and the accumulator-to-A-fragment repacking that keeps P (and
// dS) out of shared memory, with the split P = P_hi + P_lo of the
// forward.
//
// Blocks. The graph layouts use bq = bk = BLK in {16, 32}: 32 for the
// node and link tasks' one large graph, 16 for the graph-level task's
// packed mini-graphs (tasks/graph_level.py). Every piece below is a
// template on BLK: a block is MT = BLK / 16 `m16` row tiles, and a BLK x
// BLK score block is NS = BLK / 8 `n8` column tiles (two at BLK = 16).
//
// Why `mma.sync` and not `wgmma`: the blocks are 16 or 32 rows and head
// dims 8-64 (Graphormer-Slim 8, GT 16, Graphormer-Large 24). `wgmma`
// wants 64-row A tiles sharing one B, but two q-blocks visit different
// k-blocks and two heads have different K, so the natural tile is one
// warp's BLK x BLK score block of one head.
//
// Tiles. A (BLK x Dh) bf16 tile of q, k, v or dO sits in shared memory
// row by row with a stride of LD = DHP + 8 elements, DHP = Dh rounded up
// to a multiple of 16 (the q.k product's depth). The columns Dh..DHP-1
// are zero (the kernels clear them once; `cp.async` writes only the
// first Dh) and the 8 extra columns put the 8 rows an `ldmatrix` reads on
// distinct banks. Scores are kept in base-2 units (s * log2 e): the bias
// table is scaled by log2 e as it is staged, the q.k dot by scale *
// log2 e, so one `exp2` per entry remains; lse leaves and enters in
// natural units.
//
// The schedule's rewrites. `hoist_scale` needs no code here: a q tile
// times Dh^-0.5 is no bf16 value, so the tensor cores could not take it,
// and the scale already rides the one fp32 FMA of each score (folded
// with log2 e into `scale2`); both values of the flag launch the same
// kernels and compute the same thing. `fuse_bias` is the kernels' FUSE
// template flag (their `fuse` argument picks the instantiation): the
// table carries a sentinel column and the scores take `score2_fused`.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace biased {

constexpr int kMaxWarps = 4;    // heads a CTA serves, one warp each
constexpr int kStages = 2;      // ring depth: one block in flight
constexpr float kNegInf = -1e30f;  // finite sentinel, as the TPU kernel
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// A block of BLK rows: MT `m16` row tiles, a BLK x BLK score block of NS
// `n8` column tiles, whose keys are MT `k16` steps of the P (or dS)
// product, and an int8 bucket tile of BKT bytes.
template <int BLK>
struct Blk {
  static_assert(BLK == 16 || BLK == 32, "bq = bk in 16, 32");
  static constexpr int MT = BLK / 16;
  static constexpr int NS = BLK / 8;
  static constexpr int BKT = BLK * BLK;
};

template <int DH, int BLK>
struct Dims : Blk<BLK> {
  static_assert(DH % 8 == 0 && DH >= 8 && DH <= 64, "Dh in 8, 16, ..., 64");
  static constexpr int DHP = (DH + 15) / 16 * 16;
  static constexpr int LD = DHP + 8;
  static constexpr int TILE = BLK * LD;        // elements of one tile
  static constexpr int KSTEPS = DHP / 16;      // depth steps of q.k
  static constexpr int NT = DH / 8;            // n-tiles of a BLK x Dh sum
};

// Heads a CTA serves: at most kMaxWarps, a divisor of H, and either a
// divisor or a multiple of the GQA group H / KV, so that the CTA's heads
// read nkv = max(1, G / (H / KV)) whole kv heads. One warp serves one
// head's block at either BLK.
__host__ __device__ inline int heads_per_cta(int H, int KV) {
  const int rep = H / KV;
  for (int g = kMaxWarps; g > 1; g >>= 1)
    if (H % g == 0 && (rep % g == 0 || g % rep == 0)) return g;
  return 1;
}
__host__ __device__ inline int kv_per_cta(int G, int H, int KV) {
  const int rep = H / KV;
  return G > rep ? G / rep : 1;
}

// ------------------------------------------------------------- copies

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// a BLK x DH tile whose rows lie `ld` elements apart in device memory
// into a tile of stride LD, 16 bytes a copy, by the CTA's `nthr` threads
template <int DH, int BLK>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst,
                                          const __nv_bfloat16* src,
                                          size_t ld, int tid, int nthr) {
  constexpr int kChunks = DH / 8;  // 16-byte pieces of a row
  for (int e = tid; e < BLK * kChunks; e += nthr) {
    const int r = e / kChunks, c = e - r * kChunks;
    cp_async16(dst + r * Dims<DH, BLK>::LD + c * 8, src + r * ld + c * 8);
  }
}

// `n16` contiguous 16-byte pieces (a bucket tile, BLK lse values)
__device__ __forceinline__ void load_bytes(void* dst, const void* src,
                                           int n16, int tid, int nthr) {
  for (int e = tid; e < n16; e += nthr)
    cp_async16(static_cast<uint8_t*>(dst) + e * 16,
               static_cast<const uint8_t*>(src) + e * 16);
}

// zero the pad columns Dh..DHP-1 of `n` consecutive tiles
template <int DH, int BLK>
__device__ __forceinline__ void clear_pad(__nv_bfloat16* tiles, int n,
                                          int tid, int nthr) {
  using D = Dims<DH, BLK>;
  constexpr int kPad = D::DHP - DH;
  if constexpr (kPad > 0) {
    for (int e = tid; e < n * BLK * kPad; e += nthr) {
      const int row = e / kPad;  // over all n tiles
      tiles[row * D::LD + DH + (e - row * kPad)] = __float2bfloat16(0.f);
    }
  }
}

// The entries of a block_idx row (or of a block_idx_t row of pairs) that
// are not -1, compacted in order into `list` as (slot, block) or (q-row,
// slot) pairs; returns their count. `ent(m)` gives entry m as an int2
// whose x < 0 marks it empty. Every thread of the CTA calls it; `cnt`
// holds kMaxWarps ints of scratch.
template <typename Entry>
__device__ __forceinline__ int compact(int n, Entry ent, int2* list,
                                       int* cnt) {
  const int tid = threadIdx.x, nthr = blockDim.x;
  const int warp = tid >> 5, lane = tid & 31;
  int total = 0;
  for (int base = 0; base < n; base += nthr) {
    const int m = base + tid;
    const int2 e = m < n ? ent(m) : make_int2(-1, -1);
    const bool keep = e.x >= 0;
    const unsigned ball = __ballot_sync(0xffffffffu, keep);
    if (lane == 0) cnt[warp] = __popc(ball);
    __syncthreads();
    int off = total;
    for (int w = 0; w < nthr / 32; ++w) {
      if (w < warp) off += cnt[w];
      total += cnt[w];
    }
    if (keep) list[off + __popc(ball & ((1u << lane) - 1u))] = e;
    __syncthreads();
  }
  return total;
}

// ---------------------------------------------------- mma.sync fragments
//
// m16n8k16 (row.col), lane t, g = t / 4, c = t % 4:
//   A (16 x 16): a0 (g, 2c..2c+1), a1 (g+8, 2c..), a2 (g, 2c+8..),
//                a3 (g+8, 2c+8..);
//   B (16 x 8):  b0 (k 2c..2c+1, n g), b1 (k 2c+8.., n g);
//   C (16 x 8):  c0, c1 (g, 2c..2c+1), c2, c3 (g+8, 2c..2c+1).
// A BLK x N accumulator is acc[mt][nt][4], mt < MT: rows 16 mt + g + 8 i,
// columns 8 nt + 2 c + j in acc[mt][nt][2 i + j]. A lane holds the same
// rows at either BLK; at BLK = 16 there is no second row tile.

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, "
               "[%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 "
               "{%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldsm_x2_t(uint32_t (&r)[2], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, "
               "[%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// BLK x BLK fp32 score-shaped accumulators and their bf16 A fragments
template <int BLK>
using ScoreAcc = float[Blk<BLK>::MT][Blk<BLK>::NS][4];
template <int BLK>
using ScoreFrag = uint32_t[Blk<BLK>::MT][Blk<BLK>::MT][4];

template <int BLK>
__device__ __forceinline__ void zero(ScoreAcc<BLK>& s) {
#pragma unroll
  for (int mt = 0; mt < Blk<BLK>::MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < Blk<BLK>::NS; ++nt)
#pragma unroll
      for (int r = 0; r < 4; ++r) s[mt][nt][r] = 0.f;
}

// acc[mt][nt] += A B^T over the DHP columns: A and B are BLK-row tiles
// (rows mt*16.. of A, rows nt*8.. of B), so acc is the BLK x BLK block of
// row-by-row dot products: S = Q K^T (forward, dQ), dP = dO V^T (dQ),
// S^T = K Q^T and dP^T = V dO^T (dK/dV). One `ldmatrix.x4` of B feeds two
// n-tiles, so a 16-row B takes one and a 32-row B two per depth step.
template <int DH, int BLK>
__device__ __forceinline__ void product_abt(ScoreAcc<BLK>& acc,
                                            const __nv_bfloat16* sa,
                                            const __nv_bfloat16* sb) {
  using D = Dims<DH, BLK>;
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int kk = 0; kk < D::KSTEPS; ++kk) {
    uint32_t a[D::MT][4];
#pragma unroll
    for (int mt = 0; mt < D::MT; ++mt)
      ldsm_x4(a[mt], sa + (mt * 16 + (lane & 15)) * D::LD + kk * 16 +
                         (lane >> 4) * 8);
#pragma unroll
    for (int np = 0; np < D::NS / 2; ++np) {  // n-tiles 2 np and 2 np + 1
      uint32_t b[4];
      ldsm_x4(b, sb + (np * 16 + (lane & 7) + (lane >> 4) * 8) * D::LD +
                     kk * 16 + ((lane >> 3) & 1) * 8);
#pragma unroll
      for (int mt = 0; mt < D::MT; ++mt) {
        mma(acc[mt][2 * np], a[mt], b[0], b[1]);
        mma(acc[mt][2 * np + 1], a[mt], b[2], b[3]);
      }
    }
  }
}

// acc[mt][nt] += P B: P a BLK x BLK block held as A fragments (pa[mt][kk],
// keys 16 kk..16 kk + 15), B a BLK x DH tile whose rows are the keys:
// O += P V (forward), dQ += dS K (dQ), dV += P^T dO and dK += dS^T Q
// (dK/dV)
template <int DH, int BLK>
__device__ __forceinline__ void product_pb(
    float (&acc)[Blk<BLK>::MT][Dims<DH, BLK>::NT][4],
    const ScoreFrag<BLK>& pa, const __nv_bfloat16* sb) {
  using D = Dims<DH, BLK>;
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int kk = 0; kk < D::MT; ++kk) {
    const __nv_bfloat16* row = sb + (kk * 16 + (lane & 15)) * D::LD;
#pragma unroll
    for (int np = 0; np < D::NT / 2; ++np) {
      uint32_t b[4];
      ldsm_x4_t(b, row + np * 16 + (lane >> 4) * 8);
#pragma unroll
      for (int mt = 0; mt < D::MT; ++mt) {
        mma(acc[mt][2 * np], pa[mt][kk], b[0], b[1]);
        mma(acc[mt][2 * np + 1], pa[mt][kk], b[2], b[3]);
      }
    }
    if constexpr (D::NT % 2) {
      uint32_t b[2];
      ldsm_x2_t(b, row + (D::NT - 1) * 8);
#pragma unroll
      for (int mt = 0; mt < D::MT; ++mt)
        mma(acc[mt][D::NT - 1], pa[mt][kk], b[0], b[1]);
    }
  }
}

// two fp32 values as a bf16 pair (x low)
__device__ __forceinline__ uint32_t pack_bf16(float x, float y) {
  __nv_bfloat162 v = __floats2bfloat162_rn(x, y);
  return *reinterpret_cast<uint32_t*>(&v);
}

// a BLK x BLK fp32 accumulator as the A fragments of the next product:
// keys 16 kk.. are the accumulator's n-tiles 2 kk and 2 kk + 1, so no
// shared-memory round trip
template <int BLK>
__device__ __forceinline__ void to_a_frag(const ScoreAcc<BLK>& s,
                                          ScoreFrag<BLK>& pa) {
#pragma unroll
  for (int mt = 0; mt < Blk<BLK>::MT; ++mt)
#pragma unroll
    for (int kk = 0; kk < Blk<BLK>::MT; ++kk) {
      pa[mt][kk][0] = pack_bf16(s[mt][2 * kk][0], s[mt][2 * kk][1]);
      pa[mt][kk][1] = pack_bf16(s[mt][2 * kk][2], s[mt][2 * kk][3]);
      pa[mt][kk][2] = pack_bf16(s[mt][2 * kk + 1][0], s[mt][2 * kk + 1][1]);
      pa[mt][kk][3] = pack_bf16(s[mt][2 * kk + 1][2], s[mt][2 * kk + 1][3]);
    }
}

// the same accumulator split as P = P_hi + P_lo, both bf16 A fragments
// (P_lo = P - P_hi rounded): O += P_hi V + P_lo V carries P to ~2^-17,
// so O is as exact as an fp32 sum before its one rounding to bf16, and
// the backward's delta = rowsum(dO * O) cancels as it does against the
// plain version
template <int BLK>
__device__ __forceinline__ void to_a_frag_split(const ScoreAcc<BLK>& s,
                                                ScoreFrag<BLK>& hi,
                                                ScoreFrag<BLK>& lo) {
  ScoreAcc<BLK> rest;
#pragma unroll
  for (int mt = 0; mt < Blk<BLK>::MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < Blk<BLK>::NS; ++nt)
#pragma unroll
      for (int r = 0; r < 4; ++r)
        rest[mt][nt][r] = s[mt][nt][r] -
                          __bfloat162float(__float2bfloat16(s[mt][nt][r]));
  to_a_frag<BLK>(s, hi);
  to_a_frag<BLK>(rest, lo);
}

// 2^x by one `ex2.approx.ftz`: `exp2f` adds a scaling for results below
// 2^-126, which no p of the softmax needs (they flush to 0); 7-9% of the
// forward's time and 1-3% of dK/dV's on the card (tools/ab_biased.py)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// ---------------------------------------------------------------- scores

// One score in base-2 units: the q.k dot times scale2 = Dh^-0.5 log2 e
// plus the bucket's bias (`bias2`: the head's row of the table times
// log2 e), the bucket clipped to nb - 1 as the TPU kernel clips it; a
// negative bucket masks the entry with the finite sentinel.
__device__ __forceinline__ float score2(float dot, float scale2, int bkt,
                                        const float* bias2, int nb) {
  return bkt >= 0 ? fmaf(dot, scale2, bias2[min(bkt, nb - 1)]) : kNegInf;
}

// The same score under the `fuse_bias` rewrite: `bias2` holds nb + 1
// columns, the last the sentinel -1e30 (times log2 e as staged, about
// -1.44e30), and every bucket is looked up in it: -1, as an unsigned the
// largest, lands on the sentinel, so one FMA replaces the select. It
// agrees with `score2` on buckets in {-1} U [0, nb), all that
// core/reformation.py emits; a row the sentinel masks entirely keeps its
// running max at the -1e30 floor, which the dead-row tests (m <= kNegInf)
// read.
__device__ __forceinline__ float score2_fused(float dot, float scale2,
                                              int bkt, const float* bias2,
                                              int nb) {
  return fmaf(dot, scale2, bias2[min((unsigned)bkt, (unsigned)nb)]);
}

// `score2` or, under the FUSE instantiation, `score2_fused`
__device__ __forceinline__ float score2_sched(bool fuse, float dot,
                                              float scale2, int bkt,
                                              const float* bias2, int nb) {
  return fuse ? score2_fused(dot, scale2, bkt, bias2, nb)
              : score2(dot, scale2, bkt, bias2, nb);
}

// ------------------------------------------------------ online softmax

// The running maxima (base 2) and the thread's partial sums of the 2 MT
// rows it holds, row 16 mt + g + 8 i in [mt][i]. `update` turns the
// scores of one visited block into p = exp2(s - m) in place and rescales
// O; a row with nothing unmasked so far keeps m at the sentinel and p, l
// at 0, so it writes O = 0 and lse = 0. A row's BLK columns lie in the
// four lanes of its quad (NS n-tiles of 2 columns each), whatever BLK.
template <int BLK>
struct OnlineSoftmax {
  static constexpr int MT = Blk<BLK>::MT, NS = Blk<BLK>::NS;
  float m[MT][2], l[MT][2];

  __device__ __forceinline__ OnlineSoftmax() {
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        m[mt][i] = kNegInf;
        l[mt][i] = 0.f;
      }
  }

  template <int NT>
  __device__ __forceinline__ void update(ScoreAcc<BLK>& s,
                                         float (&o)[MT][NT][4]) {
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        float mx = kNegInf;
#pragma unroll
        for (int nt = 0; nt < NS; ++nt)
          mx = fmaxf(mx, fmaxf(s[mt][nt][2 * i], s[mt][nt][2 * i + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new = fmaxf(m[mt][i], mx);
        const bool dead = m_new <= kNegInf;
        const float corr = ex2(m[mt][i] - m_new);
        m[mt][i] = m_new;
        float sum = 0.f;
#pragma unroll
        for (int nt = 0; nt < NS; ++nt)
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const float p = dead ? 0.f : ex2(s[mt][nt][2 * i + j] - m_new);
            s[mt][nt][2 * i + j] = p;
            sum += p;
          }
        l[mt][i] = l[mt][i] * corr + sum;
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          o[mt][nt][2 * i] *= corr;
          o[mt][nt][2 * i + 1] *= corr;
        }
      }
  }

  // the rows' full sums, over the quad that holds each row
  __device__ __forceinline__ void finish() {
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        l[mt][i] += __shfl_xor_sync(0xffffffffu, l[mt][i], 1);
        l[mt][i] += __shfl_xor_sync(0xffffffffu, l[mt][i], 2);
      }
  }

  // the natural logsumexp of a finished row, 0 where it had no entry
  __device__ __forceinline__ float lse(int mt, int i) const {
    return l[mt][i] > 0.f ? (m[mt][i] + log2f(l[mt][i])) * kLn2 : 0.f;
  }
};

// a (16 MT) x DH fp32 accumulator times `mul[mt][i]` (per row) into a
// bf16 or fp32 tile whose rows lie `ld` elements apart in device memory
template <int MT, int NT, typename T>
__device__ __forceinline__ void store_rows(const float (&acc)[MT][NT][4],
                                           const float (&mul)[MT][2],
                                           T* dst, size_t ld) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, c = lane & 3;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      T* row = dst + (size_t)(mt * 16 + g + 8 * i) * ld + 2 * c;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const float x = acc[mt][nt][2 * i] * mul[mt][i];
        const float y = acc[mt][nt][2 * i + 1] * mul[mt][i];
        if constexpr (sizeof(T) == sizeof(float))
          *reinterpret_cast<float2*>(row + nt * 8) = make_float2(x, y);
        else
          *reinterpret_cast<__nv_bfloat162*>(row + nt * 8) =
              __floats2bfloat162_rn(x, y);
      }
    }
}

// per-row factors of a BLK-row accumulator, all `x`
template <int MT>
struct RowMul {
  float v[MT][2];
  __device__ __forceinline__ explicit RowMul(float x) {
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) v[mt][0] = v[mt][1] = x;
  }
};

}  // namespace biased
