// Hopper (sm_90a) building blocks of the tensor-core kernels
// (flash_attention_{fwd,bwd_dq,bwd_dkv}_sm90.cu,
// cluster_attention_unbiased_{fwd,bwd}_sm90.cu): the mbarrier ring that a
// producer warp fills with TMA copies, the shared-memory matrix
// descriptors and `wgmma` instructions that read those tiles, the online
// softmax, P V and epilogue the two forwards share, the per-stage bodies
// of dQ and of dK/dV the dense and sparse backwards share, and the
// host-side encoding of the TMA tensor maps.
//
// Tiles. A (rows x Dh) bf16 tile of q, k, v or dO is copied by TMA with a
// 128-byte swizzle (Dh 64 and 128) or a 64-byte swizzle (Dh 32): one
// "atom" holds SWE = SWB / 2 columns of every row, SWB bytes a row, eight
// rows a 1024- (or 512-) byte swizzle period. Dh 128 is two atoms, stored
// one after the other (columns 0-63 of all rows, then columns 64-127).
// Any other head dim (a multiple of 8 up to 64: the graph models' 8, 16,
// 24, ...) fits no swizzle span as it is: its tile holds DHP = Dh rounded
// up to 16 columns, in atoms of 16 columns with a 32-byte swizzle (eight
// rows a 256-byte period), and each atom is one TMA box of 16 columns.
// The box of the last atom reaches past Dh, outside the tensor's first
// dimension, and TMA writes zeros there: the pad columns add nothing to
// q.k, and the pad columns of O, dQ, dK and dV that they yield are never
// stored. No operand is padded in device memory.
// One tile serves two kinds of `wgmma` operand:
//   K-major (the reduction runs along Dh, a row's contiguous dimension):
//     the A and B of S = Q K^T; a 16-column step moves the start address
//     32 bytes along the row, or to the next atom; SBO = 8 rows;
//   MN-major (the reduction runs along the rows): the B of O = P V; a
//     16-row step moves the start address 16 rows; SBO = 8 rows, LBO =
//     the distance between two atoms (Dh 128 spans two).
// Out-of-range rows (a ragged tail) are zero-filled by TMA: the maps have
// rank 4, (Dh, heads, S, B), so a tile never reads the next sequence.

#pragma once

#include <cuda.h>  // CUtensorMap and its enums; the driver call is looked
                   // up at run time, so nothing links against libcuda
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace sm90 {

constexpr float kLog2e = 1.4426950408889634f;

// The swizzle of a (rows x DH) bf16 tile: the DHP columns a row holds
// (DH, or DH padded to 16), its span SWB in bytes, the SWE columns of an
// atom, the NATOM atoms a row spans.
template <int DH>
struct Atom {
  static_assert(DH % 8 == 0 && ((DH >= 8 && DH <= 64) || DH == 128),
                "Dh a multiple of 8 up to 64, or 128");
  static constexpr bool PAD = !(DH == 32 || DH == 64 || DH == 128);
  static constexpr int DHP = PAD ? (DH + 15) / 16 * 16 : DH;
  static constexpr int SWB = PAD ? 32 : DH >= 64 ? 128 : 64;
  static constexpr int SWE = SWB / 2;
  static constexpr int NATOM = DHP / SWE;
};

// ------------------------------------------------------------ addresses

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ------------------------------------------------------------- mbarrier

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// arrive once and expect `bytes` of TMA transactions on `bar`
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// wait for the completion of the barrier's phase of parity `parity`. A
// wait that lasts 2^34 cycles (seconds; no stage takes that long) traps,
// so a broken protocol fails the launch instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_u32(bar);
  uint32_t done;
  long long start = 0;
  while (true) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
    if (done) return;
    if (start == 0)
      start = clock64();
    else if (clock64() - start > (1LL << 34))
      __trap();
  }
}

// ------------------------------------------------------------------ TMA

// a box of the rank-4 map at (c0, c1, c2, c3) into shared memory, its
// bytes counted on `bar`
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// ---------------------------------------------------------------- wgmma

// The shared-memory matrix descriptor: start address, leading and stride
// byte offsets (16-byte units) and the swizzle (1 = 128 bytes, 2 = 64,
// 3 = 32).
template <int SWB>
__device__ __forceinline__ uint64_t desc(const void* p, uint32_t lbo,
                                         uint32_t sbo) {
  static_assert(SWB == 128 || SWB == 64 || SWB == 32,
                "128-, 64- or 32-byte swizzle");
  constexpr uint64_t layout = SWB == 128 ? 1 : SWB == 64 ? 2 : 3;
  return (uint64_t)((smem_u32(p) & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (layout << 62);
}

// K-major operand: 16 columns from column `k` of rows starting at `tile`
// (an atom-aligned tile of `rows` rows); the LBO is unused (1)
template <int SWB>
__device__ __forceinline__ uint64_t desc_k(const uint8_t* tile, int rows,
                                           int k) {
  const int byte = k * 2;
  return desc<SWB>(tile + (byte / SWB) * rows * SWB + byte % SWB, 16,
                   8 * SWB);
}

// MN-major operand: 16 rows from row `r` of a tile of `rows` rows, all
// its Dh columns
template <int SWB>
__device__ __forceinline__ uint64_t desc_mn(const uint8_t* tile, int rows,
                                            int r) {
  return desc<SWB>(tile + r * SWB, rows * SWB, 8 * SWB);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keep the compiler from moving accesses of an accumulator across the
// asynchronous instructions that own it
template <int R>
__device__ __forceinline__ void fence_acc(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

template <uint32_t REGS>
__device__ __forceinline__ void regs_dealloc() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(REGS));
}
template <uint32_t REGS>
__device__ __forceinline__ void regs_alloc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(REGS));
}

// two fp32 values as the bf16 pair of an A fragment register (x low)
__device__ __forceinline__ uint32_t pack_bf16(float x, float y) {
  __nv_bfloat162 v = __floats2bfloat162_rn(x, y);
  return *reinterpret_cast<uint32_t*>(&v);
}

// The accumulator of a 64 x N product: thread t of the warpgroup holds
// rows 16 (t / 32) + (t % 32) / 4 + 8 i and columns 8 j + 2 (t % 4) + c
// in d[4 j + 2 i + c] (i, c in {0, 1}). The A fragment of a 64 x 16
// register operand holds the same rows and columns 2 (t % 4) + {0, 1}
// (+8): the accumulator's columns 16 kk .. 16 kk + 15 are, packed in
// pairs, registers {d[8kk], d[8kk+1]}, {d[8kk+2], d[8kk+3]},
// {d[8kk+4], d[8kk+5]}, {d[8kk+6], d[8kk+7]} of the fragment.
template <int R>
__device__ __forceinline__ void to_a_frag(const float (&p)[R],
                                          uint32_t (&a)[R / 8][4]) {
#pragma unroll
  for (int kk = 0; kk < R / 8; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r)
      a[kk][r] = pack_bf16(p[8 * kk + 2 * r], p[8 * kk + 2 * r + 1]);
}

#define ACC8(i)                                                         \
  "+f"(d[(i) + 0]), "+f"(d[(i) + 1]), "+f"(d[(i) + 2]), "+f"(d[(i) + 3]), \
      "+f"(d[(i) + 4]), "+f"(d[(i) + 5]), "+f"(d[(i) + 6]),             \
      "+f"(d[(i) + 7])

// D (64 x 64, fp32) (+)= A (64 x 16) B (16 x 64), A and B K-major in
// shared memory; `accumulate` 0 overwrites D
__device__ __forceinline__ void ss_n64(float (&d)[32], uint64_t da,
                                       uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : ACC8(0), ACC8(8), ACC8(16), ACC8(24)
      : "l"(da), "l"(db), "r"(accumulate));
}

// D (64 x 128, fp32) (+)= A (64 x 16) B (16 x 128), A and B K-major in
// shared memory; `accumulate` 0 overwrites D
__device__ __forceinline__ void ss_n128(float (&d)[64], uint64_t da,
                                       uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : ACC8(0), ACC8(8), ACC8(16), ACC8(24),
        ACC8(32), ACC8(40), ACC8(48), ACC8(56)
      : "l"(da), "l"(db), "r"(accumulate));
}

// D (64 x 16, fp32) += A (64 x 16, bf16 pairs in registers) B (16 x
// 16), B MN-major in shared memory
__device__ __forceinline__ void rs_n16(float (&d)[8],
                                       const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7}, "
      "{%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : ACC8(0)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D (64 x 32, fp32) += A (64 x 16, bf16 pairs in registers) B (16 x
// 32), B MN-major in shared memory
__device__ __forceinline__ void rs_n32(float (&d)[16],
                                       const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : ACC8(0), ACC8(8)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D (64 x 48, fp32) += A (64 x 16, bf16 pairs in registers) B (16 x
// 48), B MN-major in shared memory
__device__ __forceinline__ void rs_n48(float (&d)[24],
                                       const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %29, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n48k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23}, "
      "{%24, %25, %26, %27}, %28, p, 1, 1, 1;\n}\n"
      : ACC8(0), ACC8(8), ACC8(16)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D (64 x 64, fp32) += A (64 x 16, bf16 pairs in registers) B (16 x
// 64), B MN-major in shared memory
__device__ __forceinline__ void rs_n64(float (&d)[32],
                                       const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : ACC8(0), ACC8(8), ACC8(16), ACC8(24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D (64 x 128, fp32) += A (64 x 16, bf16 pairs in registers) B (16 x
// 128), B MN-major in shared memory
__device__ __forceinline__ void rs_n128(float (&d)[64],
                                       const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : ACC8(0), ACC8(8), ACC8(16), ACC8(24),
        ACC8(32), ACC8(40), ACC8(48), ACC8(56)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

#undef ACC8

template <int N>
__device__ __forceinline__ void ss(float (&d)[N / 2], uint64_t da,
                                   uint64_t db, int accumulate) {
  if constexpr (N == 64)
    ss_n64(d, da, db, accumulate);
  else
    ss_n128(d, da, db, accumulate);
}

template <int N>
__device__ __forceinline__ void rs(float (&d)[N / 2], const uint32_t (&a)[4],
                                   uint64_t db) {
  if constexpr (N == 16)
    rs_n16(d, a, db);
  else if constexpr (N == 32)
    rs_n32(d, a, db);
  else if constexpr (N == 48)
    rs_n48(d, a, db);
  else if constexpr (N == 64)
    rs_n64(d, a, db);
  else
    rs_n128(d, a, db);
}

// ------------------------------------------ the forwards' online softmax

// One chunk of BN keys of the online softmax of the bf16 forwards
// (flash_attention_fwd_sm90.cu, cluster_attention_unbiased_fwd_sm90.cu),
// on the accumulator `sc` of a 64 x BN product S = Q K^T. Where `edge`
// holds, the entries for which `masked(kc, i)` holds (key kc of the
// chunk, the thread's row + 8 i) become -inf. The running row maxima `m`
// are base-2 logits (s * c2, c2 = scale * log2 e); `l` holds the
// thread's partial row sums (its quad's share); O is rescaled; and
// P = exp2(s c2 - m) comes out split as P = P_hi + P_lo, bf16 A
// fragments for `pv_split`. A row with nothing unmasked so far shifts by
// 0, so its p and rescale factor are 0.
//
// The split: the port's check holds bf16 O element by element within
// 1e-5 + 2^-7 |O| of the plain version, which multiplies fp32
// probabilities by V. Rounding P once to bf16 would err by about
// 2^-9 sqrt(sum p^2 v^2) / l, ~2.5e-5 over 16384 keys, above the 1e-5
// floor where O cancels near 0. P_hi = bf16(P), P_lo = bf16(P - P_hi):
// two register-operand `wgmma`s, 1.5x the tensor-core work of the
// function, an error near 2^-17.
template <int BN, int DH, typename Masked>
__device__ __forceinline__ void softmax_chunk(
    float (&sc)[BN / 2], float (&o)[DH / 2], float (&m)[2], float (&l)[2],
    float c2, int col, bool edge, Masked masked,
    uint32_t (&phi)[BN / 16][4], uint32_t (&plo)[BN / 16][4]) {
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int j = 0; j < BN / 8; ++j)
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float& v = sc[4 * j + 2 * i + e];
        if (edge && masked(8 * j + col + e, i)) v = -INFINITY;
        mx[i] = fmaxf(mx[i], v);
      }
  float base[2], corr[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
    const float m_new = fmaxf(m[i], mx[i] * c2);
    base[i] = m_new == -INFINITY ? 0.f : m_new;
    corr[i] = exp2f(m[i] - base[i]);
    m[i] = m_new;
    l[i] *= corr[i];
  }
#pragma unroll
  for (int kk = 0; kk < BN / 16; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int i = r & 1;  // registers 1 and 3 hold row + 8
      const float p0 = exp2f(fmaf(sc[8 * kk + 2 * r], c2, -base[i]));
      const float p1 = exp2f(fmaf(sc[8 * kk + 2 * r + 1], c2, -base[i]));
      l[i] += p0 + p1;
      const __nv_bfloat162 hi = __floats2bfloat162_rn(p0, p1);
      const float2 hf = __bfloat1622float2(hi);
      const __nv_bfloat162 lo = __floats2bfloat162_rn(p0 - hf.x, p1 - hf.y);
      phi[kk][r] = *reinterpret_cast<const uint32_t*>(&hi);
      plo[kk][r] = *reinterpret_cast<const uint32_t*>(&lo);
    }
#pragma unroll
  for (int j = 0; j < DH / 8; ++j)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      o[4 * j + 2 * i] *= corr[i];
      o[4 * j + 2 * i + 1] *= corr[i];
    }
}

// O += P_hi V + P_lo V over BN keys: rows r .. r + BN - 1 of the
// MN-major V tile `sv` of `rows` rows
template <int BN, int DH, int SWB>
__device__ __forceinline__ void pv_split(float (&o)[DH / 2],
                                         const uint32_t (&phi)[BN / 16][4],
                                         const uint32_t (&plo)[BN / 16][4],
                                         const uint8_t* sv, int rows, int r) {
  wgmma_fence();
  fence_acc(o);
#pragma unroll
  for (int kk = 0; kk < BN / 16; ++kk) {
    const uint64_t dv = desc_mn<SWB>(sv, rows, r + kk * 16);
    rs<DH>(o, phi[kk], dv);
    rs<DH>(o, plo[kk], dv);
  }
  wgmma_commit();
  wgmma_wait<0>();
  fence_acc(o);
}

// The forwards' epilogue: the quads' row sums, then O / l in bf16 and the
// natural logsumexp m ln 2 + log l of the thread's rows `row` and
// `row` + 8 below S (a row with l = 0, nothing unmasked, writes O = 0
// and lse = 0). `o` holds DP >= DH columns (a padded tile's), of which
// the first DH are stored. `out` (B, S, H, DH), `lse` (B*H, S) or NULL.
template <int DH, int DP = DH>
__device__ __forceinline__ void store_rows(const float (&o)[DP / 2],
                                           const float (&m)[2], float (&l)[2],
                                           __nv_bfloat16* out, float* lse,
                                           int b, int h, int H, int S,
                                           int row, int col) {
  constexpr float kLn2 = 0.6931471805599453f;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = row + 8 * i;
    if (r >= S) continue;
    const float inv = l[i] > 0.f ? 1.f / l[i] : 0.f;
    __nv_bfloat16* orow = out + (((size_t)b * S + r) * H + h) * DH;
#pragma unroll
    for (int j = 0; j < DH / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j + col) =
          __floats2bfloat162_rn(o[4 * j + 2 * i] * inv,
                                o[4 * j + 2 * i + 1] * inv);
    if (lse != nullptr && col == 0)
      lse[((size_t)b * H + h) * S + r] =
          l[i] > 0.f ? m[i] * kLn2 + logf(l[i]) : 0.f;
  }
}

// ------------------------------------------ the backwards' stage bodies

// The bf16 backwards rebuild the scores as the bf16 forwards built them,
// p = exp(s - lse) as exp2(acc c2 - lse log2 e) with c2 = Dh^-0.5 log2 e.
// A stage is kStage rows of the streamed operand (k and v for dQ, q and
// dO for dK/dV) against a consumer warpgroup's 64 resident rows.
constexpr int kStage = 64;

// One stage of the bf16 dQ kernels (flash_attention_bwd_dq_sm90.cu,
// cluster_attention_unbiased_bwd_sm90.cu) for one consumer warpgroup:
// its 64 q rows (`sq`, `sdo`: rows of resident tiles of `q_rows` rows)
// against the stage's kStage keys (`sk`, `sv`: tiles of kStage rows).
// S = Q K^T and dP = dO V^T by `wgmma` m64n64k16 from shared memory
// (K-major, fp32 accumulators); P and dS = P (dP - delta) on the
// accumulators' register layout (row = a q row, column = a key); then
// dQ += dS K by `wgmma` with A = dS from registers in bf16 and K read
// MN-major from the tile S read K-major. Where `edge` holds, the entries
// for which `masked(kc, i)` holds (key kc of the stage, the thread's row
// + 8 i) get p = 0. `lse2` and `dl`: the base-2 lse and delta of the
// thread's two rows.
template <int DH, int SWB, typename Masked>
__device__ __forceinline__ void dq_stage(
    float (&acc)[DH / 2], const uint8_t* sq, const uint8_t* sdo, int q_rows,
    const uint8_t* sk, const uint8_t* sv, const float (&lse2)[2],
    const float (&dl)[2], float c2, int col, bool edge, Masked masked) {
  // S = Q K^T and dP = dO V^T, fp32
  float sc[kStage / 2], dp[kStage / 2];
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < DH / 16; ++kk)
    ss<kStage>(sc, desc_k<SWB>(sq, q_rows, kk * 16),
               desc_k<SWB>(sk, kStage, kk * 16), kk > 0);
#pragma unroll
  for (int kk = 0; kk < DH / 16; ++kk)
    ss<kStage>(dp, desc_k<SWB>(sdo, q_rows, kk * 16),
               desc_k<SWB>(sv, kStage, kk * 16), kk > 0);
  wgmma_commit();
  wgmma_wait<0>();
  fence_acc(sc);
  fence_acc(dp);

  // dS = P (dP - delta) in place of dP
#pragma unroll
  for (int j = 0; j < kStage / 8; ++j)
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int idx = 4 * j + 2 * i + e;
        float p = exp2f(fmaf(sc[idx], c2, -lse2[i]));
        if (edge && masked(8 * j + col + e, i)) p = 0.f;
        dp[idx] = p * (dp[idx] - dl[i]);
      }
  uint32_t da[kStage / 16][4];
  to_a_frag(dp, da);

  // dQ += dS K
  wgmma_fence();
  fence_acc(acc);
#pragma unroll
  for (int kk = 0; kk < kStage / 16; ++kk)
    rs<DH>(acc, da[kk], desc_mn<SWB>(sk, kStage, kk * 16));
  wgmma_commit();
  wgmma_wait<0>();
  fence_acc(acc);
}

// One stage of the bf16 dK/dV kernels (flash_attention_bwd_dkv_sm90.cu,
// cluster_attention_unbiased_bwd_sm90.cu) for one consumer warpgroup:
// its 64 key rows (`sk`, `sv`: rows of resident tiles of `kv_rows` rows)
// against the stage's kStage q rows (`sq`, `sdo`: tiles of kStage rows;
// `slse`, `sdl`: their natural lse and delta). S^T = K Q^T and dP^T =
// V dO^T by `wgmma` m64n64k16 from shared memory (fp32 accumulators);
// P^T and dS^T = P^T (dP^T - delta) on the accumulators' register layout
// (row = a key, column = a q row); then dV += P^T dO and dK += dS^T Q by
// `wgmma` with A from registers in bf16 (q and dO read MN-major from the
// same tiles). Where `edge` holds, the entries for which `masked(qc, i)`
// holds (q row qc of the stage, the thread's key + 8 i) get p = 0.
template <int DH, int SWB, typename Masked>
__device__ __forceinline__ void dkv_stage(
    float (&acc_k)[DH / 2], float (&acc_v)[DH / 2], const uint8_t* sk,
    const uint8_t* sv, int kv_rows, const uint8_t* sq, const uint8_t* sdo,
    const float* slse, const float* sdl, float c2, int col, bool edge,
    Masked masked) {
  // S^T = K Q^T and dP^T = V dO^T, fp32
  float st[kStage / 2], dpt[kStage / 2];
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < DH / 16; ++kk)
    ss<kStage>(st, desc_k<SWB>(sk, kv_rows, kk * 16),
               desc_k<SWB>(sq, kStage, kk * 16), kk > 0);
#pragma unroll
  for (int kk = 0; kk < DH / 16; ++kk)
    ss<kStage>(dpt, desc_k<SWB>(sv, kv_rows, kk * 16),
               desc_k<SWB>(sdo, kStage, kk * 16), kk > 0);
  wgmma_commit();
  wgmma_wait<0>();
  fence_acc(st);
  fence_acc(dpt);

  // P^T and dS^T in place
#pragma unroll
  for (int j = 0; j < kStage / 8; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int qc = 8 * j + col + e;
      const float lse2 = slse[qc] * kLog2e, dl = sdl[qc];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int idx = 4 * j + 2 * i + e;
        float p = exp2f(fmaf(st[idx], c2, -lse2));
        if (edge && masked(qc, i)) p = 0.f;
        st[idx] = p;
        dpt[idx] = p * (dpt[idx] - dl);
      }
    }
  uint32_t pa[kStage / 16][4], da[kStage / 16][4];
  to_a_frag(st, pa);
  to_a_frag(dpt, da);

  // dV += P^T dO, dK += dS^T Q
  wgmma_fence();
  fence_acc(acc_v);
  fence_acc(acc_k);
#pragma unroll
  for (int kk = 0; kk < kStage / 16; ++kk)
    rs<DH>(acc_v, pa[kk], desc_mn<SWB>(sdo, kStage, kk * 16));
#pragma unroll
  for (int kk = 0; kk < kStage / 16; ++kk)
    rs<DH>(acc_k, da[kk], desc_mn<SWB>(sq, kStage, kk * 16));
  wgmma_commit();
  wgmma_wait<0>();
  fence_acc(acc_v);
  fence_acc(acc_k);
}

// The backwards' epilogue: the thread's rows `row` and `row` + 8 below S
// of a 64 x DP fp32 accumulator (DP >= DH, a padded tile's), its first DH
// columns times `scale`, in bf16 into `out` (B, S, H, DH).
template <int DH, int DP = DH>
__device__ __forceinline__ void store_scaled(const float (&acc)[DP / 2],
                                             __nv_bfloat16* out, int b,
                                             int h, int H, int S, int row,
                                             int col, float scale) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = row + 8 * i;
    if (r >= S) continue;
    __nv_bfloat16* orow = out + (((size_t)b * S + r) * H + h) * DH;
#pragma unroll
    for (int j = 0; j < DH / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j + col) =
          __floats2bfloat162_rn(acc[4 * j + 2 * i] * scale,
                                acc[4 * j + 2 * i + 1] * scale);
  }
}

// ------------------------------------------------- tensor maps (host)

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType,
                                  cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver the runtime already loaded
inline EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess || found != cudaDriverEntryPointSuccess)
      return nullptr;
    fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// A (B, S, heads, Dh) bf16 tensor as a rank-4 map whose box is `rows`
// rows of one head and one swizzle atom (SWB bytes) of columns; with a
// 32-byte swizzle a box may reach past Dh, and TMA fills that part with
// zeros.
inline int encode_rows(CUtensorMap* map, const void* base, int B, int S,
                       int heads, int dh, int rows, int swb) {
  EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[4] = {(cuuint64_t)dh, (cuuint64_t)heads,
                              (cuuint64_t)S, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)dh * 2,
                                 (cuuint64_t)heads * dh * 2,
                                 (cuuint64_t)S * heads * dh * 2};
  const cuuint32_t box[4] = {(cuuint32_t)swb / 2, 1, (cuuint32_t)rows, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                  const_cast<void*>(base), dims, strides, box, unit,
                  CU_TENSOR_MAP_INTERLEAVE_NONE,
                  swb == 128  ? CU_TENSOR_MAP_SWIZZLE_128B
                  : swb == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                              : CU_TENSOR_MAP_SWIZZLE_32B,
                  CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                  CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

}  // namespace sm90
