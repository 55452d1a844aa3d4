// Register-tiled fp32 building blocks of the fp32 unbiased cluster-sparse
// attention kernels (cluster_attention_unbiased_{fwd,bwd}.cu) and of the
// fp32 dense flash attention kernels (flash_attention_{fwd,bwd}.cu); bf16
// inputs run on the tensor-core kernels of sm90_tiles.cuh.
//
// A CTA of 256 threads works on 64 x 64 tiles of scores. Thread `tid`
// owns rows `tr + 16 i` and columns `tc + 16 j` (i, j < 4) of a score
// tile, with tr = tid / 16 and tc = tid % 16, so the 16 threads that
// share a row sit in one half-warp and reduce it with shuffles. Of a
// (64 x Dh) output tile it owns the same four rows and DP / 16 columns
// (`Shape<DH>::col`), DP = Dh rounded up to a multiple of 16: runs of
// four at DP 64 and 128, of two at 32, single columns at 16 and 48.
//
// Operand tiles live in shared memory in fp32, row-major, rows padded by
// 4 floats: a row stride of DP + 4 puts the 16 rows a half-warp reads at
// once on distinct groups of four banks, so the float4 reads along Dh in
// `dot_tile` are free of bank conflicts, and the float4 reads of
// `acc_tile` along a score row or an operand row are contiguous. Head
// dims that are no multiple of 16 (Graphormer-Slim's 8, -Large's 24)
// leave columns Dh..DP-1 of a tile unused: the loads never write them,
// the kernels clear them once (`clear_smem`), `dot_tile` stops at Dh and
// the stores skip them.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace unbiased {

constexpr int kThreads = 256;
constexpr int kTile = 64;           // score tile rows and columns
constexpr int kLP = kTile + 4;      // padded row stride of a score tile
constexpr float kNegInf = -1e30f;   // finite sentinel, as the TPU kernels

template <int DH>
struct Shape {
  static_assert(DH % 8 == 0 && ((DH >= 8 && DH <= 64) || DH == 128),
                "Dh a multiple of 8 up to 64, or 128");
  static constexpr int DP = (DH + 15) / 16 * 16;    // padded to 16 columns
  static constexpr int LD = DP + 4;                 // padded operand row
  static constexpr int VW = DP % 64 == 0 ? 4 : DP % 32 == 0 ? 2 : 1;
  static constexpr int NG = DP / (16 * VW);         // runs per thread
  // first column of run g of thread column tc: runs of neighbouring
  // threads are contiguous
  static __device__ __forceinline__ int col(int g, int tc) {
    return g * 16 * VW + tc * VW;
  }
  // a column the stores write (every one but the pad)
  static __device__ __forceinline__ bool live(int c) {
    return DH == DP || c < DH;
  }
};

// zero `n` floats of shared memory (the pad columns of the tiles of a
// head dim that is no multiple of 16, before any load)
__device__ __forceinline__ void clear_smem(float* p, int n) {
  for (int e = threadIdx.x; e < n; e += kThreads) p[e] = 0.f;
  __syncthreads();
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}

// Reductions over the 16 threads of a half-warp (one score row).
__device__ __forceinline__ float row_max(float x) {
  for (int o = 8; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float row_sum(float x) {
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// `rows` rows of Dh elements, `stride` elements apart in device memory
// (q, k, v, dO are (B, S, heads, Dh): one row per position), into a
// padded fp32 tile. 16-byte loads, neighbouring threads on neighbouring
// addresses.
template <int DH, typename T>
__device__ __forceinline__ void load_rows(float* dst, const T* src,
                                          size_t stride, int rows) {
  constexpr int Q = DH / 4;
  for (int e = threadIdx.x; e < rows * Q; e += kThreads) {
    const int r = e / Q, c = (e - r * Q) * 4;
    *reinterpret_cast<float4*>(dst + r * Shape<DH>::LD + c) =
        ld4(src + (size_t)r * stride + c);
  }
}

// As `load_rows`, for a tile at a ragged edge: rows at and past `valid`
// are zero-filled and never read, and every value is multiplied by `mul`
// (the flash kernels' hoisted softmax scale; 1 elsewhere).
template <int DH, typename T>
__device__ __forceinline__ void load_rows_upto(float* dst, const T* src,
                                               size_t stride, int rows,
                                               int valid, float mul) {
  constexpr int Q = DH / 4;
  for (int e = threadIdx.x; e < rows * Q; e += kThreads) {
    const int r = e / Q, c = (e - r * Q) * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r < valid) {
      x = ld4(src + (size_t)r * stride + c);
      x.x *= mul;
      x.y *= mul;
      x.z *= mul;
      x.w *= mul;
    }
    *reinterpret_cast<float4*>(dst + r * Shape<DH>::LD + c) = x;
  }
}

// acc[i][j] += A[ra + 16 i, :] . B[rb + 16 j, :] over Dh, both padded
// (rows x DP) tiles.
template <int DH>
__device__ __forceinline__ void dot_tile(const float* __restrict__ A,
                                         int ra,
                                         const float* __restrict__ B,
                                         int rb, float (&acc)[4][4]) {
  constexpr int LD = Shape<DH>::LD;
#pragma unroll 2
  for (int d = 0; d < DH; d += 4) {
    float4 a[4], b[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      a[i] = *reinterpret_cast<const float4*>(A + (ra + 16 * i) * LD + d);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      b[j] = *reinterpret_cast<const float4*>(B + (rb + 16 * j) * LD + d);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float s = acc[i][j];
        s = fmaf(a[i].x, b[j].x, s);
        s = fmaf(a[i].y, b[j].y, s);
        s = fmaf(a[i].z, b[j].z, s);
        s = fmaf(a[i].w, b[j].w, s);
        acc[i][j] = s;
      }
    }
  }
}

// acc[i][g][e] += sum_c P[rp + 16 i, c] * V[c, col(g, tc) + e]: P a
// (64 x 64) score tile (row stride kLP), V a padded (64 x DP) tile.
template <int DH>
__device__ __forceinline__ void acc_tile(
    const float* __restrict__ P, int rp, const float* __restrict__ V,
    int tc, float (&acc)[4][Shape<DH>::NG][Shape<DH>::VW]) {
  using Sh = Shape<DH>;
  constexpr int LD = Sh::LD, NG = Sh::NG, VW = Sh::VW;
#pragma unroll 2
  for (int c = 0; c < kTile; c += 4) {
    float p[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float4 x =
          *reinterpret_cast<const float4*>(P + (rp + 16 * i) * kLP + c);
      p[i][0] = x.x;
      p[i][1] = x.y;
      p[i][2] = x.z;
      p[i][3] = x.w;
    }
#pragma unroll
    for (int cc = 0; cc < 4; ++cc) {
      float w[NG][VW];
#pragma unroll
      for (int g = 0; g < NG; ++g) {
        const float* src = V + (c + cc) * LD + Sh::col(g, tc);
        if constexpr (VW == 4) {
          const float4 x = *reinterpret_cast<const float4*>(src);
          w[g][0] = x.x;
          w[g][1] = x.y;
          w[g][2] = x.z;
          w[g][3] = x.w;
        } else {
          const float2 x = *reinterpret_cast<const float2*>(src);
          w[g][0] = x.x;
          w[g][1] = x.y;
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int g = 0; g < NG; ++g)
#pragma unroll
          for (int e = 0; e < VW; ++e)
            acc[i][g][e] = fmaf(p[i][cc], w[g][e], acc[i][g][e]);
    }
  }
}

// Write the (64 x Dh) tile `acc * mul` (its live columns) to rows
// `row0 + tr + 16 i` of a (B, S, heads, Dh) tensor whose row `r` starts
// at `base + r * stride`.
template <int DH, typename T>
__device__ __forceinline__ void store_rows(
    T* base, size_t stride, int tr, int tc,
    const float (&acc)[4][Shape<DH>::NG][Shape<DH>::VW], float mul) {
  using Sh = Shape<DH>;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    T* row = base + (size_t)(tr + 16 * i) * stride;
#pragma unroll
    for (int g = 0; g < Sh::NG; ++g)
#pragma unroll
      for (int e = 0; e < Sh::VW; ++e)
        if (Sh::live(Sh::col(g, tc) + e))
          row[Sh::col(g, tc) + e] = from_f32<T>(acc[i][g][e] * mul);
  }
}

// As `store_rows`, writing only the tile rows below `valid` (a ragged
// edge).
template <int DH, typename T>
__device__ __forceinline__ void store_rows_upto(
    T* base, size_t stride, int tr, int tc,
    const float (&acc)[4][Shape<DH>::NG][Shape<DH>::VW], float mul,
    int valid) {
  using Sh = Shape<DH>;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (tr + 16 * i >= valid) continue;
    T* row = base + (size_t)(tr + 16 * i) * stride;
#pragma unroll
    for (int g = 0; g < Sh::NG; ++g)
#pragma unroll
      for (int e = 0; e < Sh::VW; ++e)
        if (Sh::live(Sh::col(g, tc) + e))
          row[Sh::col(g, tc) + e] = from_f32<T>(acc[i][g][e] * mul);
  }
}

}  // namespace unbiased
