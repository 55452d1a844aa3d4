// Mamba2 SSD (state-space duality) chunked scan, forward, for Hopper
// (sm_90a), chunk-parallel: four kernels in the shape of the plain
// version `models/ssm.ssd_chunked`.
//
// Replaces the TPU kernel `_ssd_kernel` in src/repro/kernels/ssd.py
// (oracle: models/ssm.ssd_chunked). The sequence is cut into chunks of Q
// positions; per (batch, head), with da = dt * a and cum its inclusive
// prefix sum within a chunk (total = cum[Q-1]):
//   y[q]   = exp(cum_q) C_q S_prev^T                             (inter)
//          + sum_{t <= q} (C_q . B_t) exp(min(cum_q - cum_t, 0)) dt_t x_t
//   S_next = exp(total) S_prev + sum_t x_t^T (exp(total - cum_t) dt_t B_t)
// where S_prev is the (dh, N) fp32 state before the chunk. The clamp
// `min(., 0)` is the reference's.
//
// What bounds it on the card. At Mamba2-2.7B's shape (S=16384, 80 heads
// of dh 64, N 128, chunk 256, B=1) the function needs ~65 GFLOP against
// ~352 MB in bf16 (x, y, dt, b, c, the final state): 0.105 ms at 3.35
// TB/s, bound by bytes in bf16 and by operations in fp32 (0.97 ms at the
// 67 TFLOP/s CUDA-core rate).
//
// What this design does about it. The serial walk over the chunks is cut
// out of the products, as `ssd_chunked` cuts it:
//   1. `ssd_cb`: C B^T over each chunk's lower triangle of 64 x 64 tiles,
//      once per (batch, chunk) for all the heads (b and c are (B, S, N),
//      shared by the heads), into fp32 scratch (B, nc, Q, Q);
//   2. `ssd_states`: per (batch, chunk, head, 64 state columns) the
//      chunk's state contribution (w B)^T X, w_t = exp(total - cum_t)
//      dt_t, into fp32 scratch (B, nc, H, N, dh), and exp(total);
//   3. `ssd_scan`: per (batch, head), one thread per state element, the
//      short scan over the chunks, writing in place the state before each
//      chunk, and the final state;
//   4. `ssd_y`: per (batch, chunk, 64-row strip, head) y = exp(cum) C
//      S_prev^T + W x with W = (C B^T) o L o dt, read from step 1: the
//      inter- and intra-chunk terms in one accumulator, y written once.
// At Mamba2-2.7B's width steps 2 and 4 launch 10240 and 20480 CTAs, no
// longer 80 on 132 SMs. Every product is a 64 x 64 output tile of 4 warps
// (each 32 x 32) over 64-deep operand tiles staged in shared memory, so
// shared memory does not grow with N or Q: any N, dh <= 64, Q <= 1024.
// bf16 runs the products on the tensor cores (`mma.sync.m16n8k16` from
// `ldmatrix`, biased_tiles.cuh): the tiles are 64 rows of 64 columns and
// carry elementwise work between products (the decay mask, dt, the
// state's weights, the hi/lo split), which the per-warp fragment layout
// addresses directly; at this shape the bf16 bound is bytes, which
// `mma.sync` does not limit. C and B are exact in bf16 (they are the
// inputs); the state's operand w B is split into bf16 hi + lo parts, two
// products, so the state keeps fp32 accuracy (1e-4); y's products round
// W and S_prev to bf16 once. fp32 runs the same tiles on CUDA cores in
// fp32 (TF32 would miss 1e-4).

#include "biased_tiles.cuh"

namespace ssd {
namespace {

using bf16 = __nv_bfloat16;

constexpr int kT = 64;             // tile edge: rows, columns and depth
constexpr int kThreads = 128;      // 4 warps, 2 x 2 over a 64 x 64 tile
constexpr int kMaxDh = 64;
constexpr int kMaxChunk = 1024;
constexpr int kPer = kMaxChunk / kThreads;  // prefix-sum positions a thread

// Leading dimension of a staged 64 x 64 tile: fp32 rows 68 floats (the 8
// rows a fragment reads lie on distinct banks, float2 aligned); bf16 rows
// 72 elements (144 bytes: 16-byte aligned rows for `ldmatrix`, on
// distinct banks).
template <typename T> struct Ld;
template <> struct Ld<float> { static constexpr int v = 68; };
template <> struct Ld<bf16> { static constexpr int v = 72; };
template <typename T> constexpr int kLd = Ld<T>::v;
template <typename T> constexpr int kTile = kT * kLd<T>;
// operand tiles a CTA stages: A (bf16: A_hi, A_lo) and B
template <typename T> constexpr int kTiles =
    sizeof(T) == sizeof(float) ? 2 : 3;
// CTAs an SM the tile kernels' registers must allow: bf16 staging is
// latency-bound, and six CTAs (at most 80 registers) ran 1.09x faster
// than the 96-118 registers ptxas picks alone; fp32 ran 0.96-0.99x, so
// it keeps ptxas's choice (tools/ab_ssd.py)
template <typename T> constexpr int kMinBlocks =
    sizeof(T) == sizeof(float) ? 1 : 6;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ bf16 from_f32<bf16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as torch's cast
}

size_t smem_bytes(int Q, bool half) {
  const size_t tiles = half ? 3 * (size_t)kT * 72 * sizeof(bf16)
                            : 2 * (size_t)kT * 68 * sizeof(float);
  return tiles + (2 * (size_t)Q + 4) * sizeof(float);
}

// Eight consecutive values of row r, columns c8..c8+7, of a row-major
// source tile (rows `ld` elements apart), zero at and past `rows` rows and
// `cols` columns: one 16-byte load (bf16) or two (fp32) where the eight
// are whole and aligned, else one load each.
template <typename S>
__device__ __forceinline__ void load8(float (&v)[8], const S* src, size_t ld,
                                      int r, int c8, int rows, int cols) {
  const S* p = src + (size_t)r * ld + c8;
  const bool vec = r < rows && c8 + 8 <= cols &&
                   ((reinterpret_cast<uintptr_t>(p) |
                     (ld * sizeof(S))) & 15) == 0;
  if (vec) {
    if constexpr (sizeof(S) == sizeof(float)) {
      const float4 a = *reinterpret_cast<const float4*>(p);
      const float4 b = *reinterpret_cast<const float4*>(p + 4);
      v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
      v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
    } else {
      const uint4 u = *reinterpret_cast<const uint4*>(p);
      const bf16* hv = reinterpret_cast<const bf16*>(&u);
#pragma unroll
      for (int j = 0; j < 8; ++j) v[j] = __bfloat162float(hv[j]);
    }
  } else {
#pragma unroll
    for (int j = 0; j < 8; ++j)
      v[j] = r < rows && c8 + j < cols ? to_f32(p[j]) : 0.f;
  }
}

// A 64 x 64 tile into dst (rows kLd<T> apart) in T, eight columns a
// piece: val8(r, c8, v) gives row r, columns c8..c8+7 (consecutive
// threads take consecutive pieces of a row). `transposed` stores element
// (r, c) at dst[c][r]. With `lo` (bf16), the tile is split as hi + lo
// (lo = value - hi, rounded): a product with each carries the value to
// ~2^-16; fp32 has no lo. Each thread reads all its pieces, then stores
// them, so its loads are in flight together.
constexpr int kPieces = kT * kT / 8 / kThreads;  // 4 a thread

template <typename T, bool transposed = false, typename F>
__device__ __forceinline__ void stage(T* dst, F val8, T* lo = nullptr) {
  float v[kPieces][8];
#pragma unroll
  for (int i = 0; i < kPieces; ++i) {
    const int e = threadIdx.x + i * kThreads;
    val8(e >> 3, (e & 7) * 8, v[i]);
  }
#pragma unroll
  for (int i = 0; i < kPieces; ++i) {
    const int e = threadIdx.x + i * kThreads;
    const int r = e >> 3, c8 = (e & 7) * 8;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int at = transposed ? (c8 + j) * kLd<T> + r : r * kLd<T> + c8 + j;
      const T h = from_f32<T>(v[i][j]);
      dst[at] = h;
      if constexpr (sizeof(T) != sizeof(float))
        if (lo != nullptr) lo[at] = from_f32<T>(v[i][j] - to_f32(h));
    }
  }
}

// acc += A B over one 64-deep tile: A row-major [m][k], B as [k][n] (NN)
// or [n][k] (NT). Warp w owns rows 32 (w / 2).. and columns 32 (w % 2)..
// of the 64 x 64 output; acc[mt][nt] in the mma.sync C layout (rows
// 16 mt + g + 8 i, columns 8 nt + 2 c + j in acc[mt][nt][2 i + j]).
template <bool NT>
__device__ __forceinline__ void mma_tile(float (&acc)[2][4][4],
                                         const float* sA, const float* sB) {
  constexpr int LD = kLd<float>;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, c = lane & 3;
  const float* a = sA + ((warp >> 1) * 32 + g) * LD;
  const int n0 = (warp & 1) * 32 + 2 * c;
#pragma unroll 4
  for (int kk = 0; kk < kT; ++kk) {
    float av[2][2];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int i = 0; i < 2; ++i) av[mt][i] = a[(mt * 16 + 8 * i) * LD + kk];
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const int n = n0 + nt * 8;
      const float2 bv =
          NT ? make_float2(sB[n * LD + kk], sB[(n + 1) * LD + kk])
             : *reinterpret_cast<const float2*>(sB + kk * LD + n);
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        acc[mt][nt][0] = fmaf(av[mt][0], bv.x, acc[mt][nt][0]);
        acc[mt][nt][1] = fmaf(av[mt][0], bv.y, acc[mt][nt][1]);
        acc[mt][nt][2] = fmaf(av[mt][1], bv.x, acc[mt][nt][2]);
        acc[mt][nt][3] = fmaf(av[mt][1], bv.y, acc[mt][nt][3]);
      }
    }
  }
}

template <bool NT>
__device__ __forceinline__ void mma_tile(float (&acc)[2][4][4],
                                         const bf16* sA, const bf16* sB) {
  constexpr int LD = kLd<bf16>;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const bf16* a = sA + (warp >> 1) * 32 * LD;
  const int n0 = (warp & 1) * 32;
#pragma unroll
  for (int kk = 0; kk < kT / 16; ++kk) {
    uint32_t af[2][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
      biased::ldsm_x4(af[mt], a + (mt * 16 + (lane & 15)) * LD + kk * 16 +
                                  (lane >> 4) * 8);
#pragma unroll
    for (int np = 0; np < 2; ++np) {  // n-tiles 2 np and 2 np + 1
      uint32_t b[4];
      if constexpr (NT)
        biased::ldsm_x4(b, sB + (n0 + np * 16 + (lane & 7) +
                                 (lane >> 4) * 8) * LD +
                               kk * 16 + ((lane >> 3) & 1) * 8);
      else
        biased::ldsm_x4_t(b, sB + (kk * 16 + (lane & 15)) * LD + n0 +
                                 np * 16 + (lane >> 4) * 8);
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        biased::mma(acc[mt][2 * np], af[mt], b[0], b[1]);
        biased::mma(acc[mt][2 * np + 1], af[mt], b[2], b[3]);
      }
    }
  }
}

__device__ __forceinline__ void zero(float (&acc)[2][4][4]) {
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[mt][nt][r] = 0.f;
}

// f(row, col, value) for each of the thread's accumulator entries
template <typename F>
__device__ __forceinline__ void each_entry(float (&acc)[2][4][4], F f) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int r0 = (warp >> 1) * 32 + (lane >> 2);
  const int c0 = (warp & 1) * 32 + 2 * (lane & 3);
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int r = 0; r < 4; ++r)
        f(r0 + mt * 16 + 8 * (r >> 1), c0 + nt * 8 + (r & 1),
          acc[mt][nt][r]);
}

// Inclusive prefix sums of dt * a over the chunk's first `len` positions
// (dt[t * stride]) into sCum, and dt itself into sDt: each thread sums
// its kPer consecutive positions, then a warp scan and the warps' totals
// in order. The same `len` gives bit-identical sums in every kernel.
__device__ __forceinline__ void chunk_cumsum(const float* dt, size_t stride,
                                             float av, int len, float* sCum,
                                             float* sDt, float* sTmp) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  float loc[kPer];
  float run = 0.f;
#pragma unroll
  for (int e = 0; e < kPer; ++e) {
    const int t = tid * kPer + e;
    const float d = t < len ? dt[(size_t)t * stride] : 0.f;
    if (t < len) sDt[t] = d;
    run += d * av;
    loc[e] = run;
  }
  float x = run;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) sTmp[warp] = x;
  __syncthreads();
  float before = 0.f;
  for (int w = 0; w < warp; ++w) before += sTmp[w];
  before += x - run;
#pragma unroll
  for (int e = 0; e < kPer; ++e) {
    const int t = tid * kPer + e;
    if (t < len) sCum[t] = before + loc[e];
  }
  __syncthreads();
}

// 1. C B^T of one lower-triangle 64 x 64 tile (q-tile qt >= t-tile tt) of
// one (batch, chunk), fp32, into cb (B, nc, Q, Q).
template <typename T>
__global__ void __launch_bounds__(kThreads, kMinBlocks<T>)
ssd_cb(const T* __restrict__ bm, const T* __restrict__ cm,
       float* __restrict__ cb, int S, int N, int Q, int nc) {
  extern __shared__ __align__(16) uint8_t smem[];
  T* sA = reinterpret_cast<T*>(smem);
  T* sB = sA + kTile<T>;
  const int nqt = (Q + kT - 1) / kT, ntri = nqt * (nqt + 1) / 2;
  int tri = blockIdx.x % ntri;
  const int n = (blockIdx.x / ntri) % nc, b = blockIdx.x / (ntri * nc);
  int qt = 0;
  while (tri > qt) tri -= ++qt;
  const int q0 = qt * kT, t0 = tri * kT;
  const size_t row0 = (size_t)b * S + (size_t)n * Q;
  float acc[2][4][4];
  zero(acc);
  for (int s0 = 0; s0 < N; s0 += kT) {
    __syncthreads();  // the previous tiles' readers are done
    stage(sA, [&](int r, int c8, float (&v)[8]) {
      load8(v, cm + (row0 + q0) * N + s0, N, r, c8, Q - q0, N - s0);
    });
    stage(sB, [&](int r, int c8, float (&v)[8]) {
      load8(v, bm + (row0 + t0) * N + s0, N, r, c8, Q - t0, N - s0);
    });
    __syncthreads();
    mma_tile<true>(acc, sA, sB);
  }
  float* out = cb + ((size_t)b * nc + n) * Q * Q;
  each_entry(acc, [&](int r, int c, float v) {
    if (q0 + r < Q && t0 + c < Q) out[(size_t)(q0 + r) * Q + t0 + c] = v;
  });
}

// 2. The state contribution of one (batch, chunk, head), 64 state
// columns: st[s][p] = sum_t w_t B[t][s] x[t][p], w_t = exp(total - cum_t)
// dt_t, fp32 into st (B, nc, H, N, dh); exp(total) into decay (B, nc, H).
template <typename T>
__global__ void __launch_bounds__(kThreads, kMinBlocks<T>)
ssd_states(const T* __restrict__ x, const float* __restrict__ dt,
           const float* __restrict__ a, const T* __restrict__ bm,
           float* __restrict__ st, float* __restrict__ decay, int S, int H,
           int dh, int N, int Q, int nc) {
  extern __shared__ __align__(16) uint8_t smem[];
  T* sA = reinterpret_cast<T*>(smem);
  T* sA2 = sA + kTile<T>;
  T* sB = sA + (kTiles<T> - 1) * kTile<T>;
  float* sCum = reinterpret_cast<float*>(sA + kTiles<T> * kTile<T>);
  float* sW = sCum + Q;
  float* sTmp = sW + Q;
  const int nst = (N + kT - 1) / kT;
  const int s0 = (blockIdx.x % nst) * kT;
  const int h = (blockIdx.x / nst) % H;
  const int n = (blockIdx.x / (nst * H)) % nc;
  const int b = blockIdx.x / (nst * H * nc);
  const size_t row0 = (size_t)b * S + (size_t)n * Q;
  chunk_cumsum(dt + row0 * H + h, H, a[h], Q, sCum, sW, sTmp);
  const float total = sCum[Q - 1];
  for (int t = threadIdx.x; t < Q; t += kThreads)
    sW[t] *= expf(total - sCum[t]);  // dt -> w
  if (s0 == 0 && threadIdx.x == 0)
    decay[((size_t)b * nc + n) * H + h] = expf(total);
  float acc[2][4][4];
  zero(acc);
  for (int t0 = 0; t0 < Q; t0 += kT) {
    __syncthreads();  // w is written; the previous tiles' readers are done
    // A = (w B)^T: rows s, columns t, read along s (rows t of B) and
    // stored transposed, as hi + lo in bf16
    stage<T, true>(sA, [&](int r, int c8, float (&v)[8]) {
      load8(v, bm + (row0 + t0) * N + s0, N, r, c8, Q - t0, N - s0);
      const float w = t0 + r < Q ? sW[t0 + r] : 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) v[j] *= w;
    }, kTiles<T> == 3 ? sA2 : nullptr);
    stage(sB, [&](int r, int c8, float (&v)[8]) {
      load8(v, x + ((row0 + t0) * H + h) * dh, (size_t)H * dh, r, c8,
            Q - t0, dh);
    });
    __syncthreads();
    mma_tile<false>(acc, sA, sB);
    if constexpr (kTiles<T> == 3) mma_tile<false>(acc, sA2, sB);
  }
  float* out = st + (((size_t)b * nc + n) * H + h) * N * dh;
  each_entry(acc, [&](int r, int c, float v) {
    if (s0 + r < N && c < dh) out[(size_t)(s0 + r) * dh + c] = v;
  });
}

// 3. Per (batch, head) and state element, the scan over the chunks: the
// state before chunk n replaces chunk n's contribution in st, and the
// state after the last chunk goes to state (B, H, dh, N).
__global__ void __launch_bounds__(kThreads)
ssd_scan(float* __restrict__ st, const float* __restrict__ decay,
         float* __restrict__ state, int H, int dh, int N, int nc) {
  const int per = N * dh;
  const int nblk = (per + kThreads - 1) / kThreads;
  const int e = (blockIdx.x % nblk) * kThreads + threadIdx.x;
  const int bh = blockIdx.x / nblk, b = bh / H, h = bh % H;
  if (e >= per) return;
  float s = 0.f;
  constexpr int kBatch = 16;  // loads in flight ahead of the chain
  for (int n0 = 0; n0 < nc; n0 += kBatch) {
    float v[kBatch], d[kBatch];
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      const size_t bn = (size_t)b * nc + n0 + j;
      v[j] = n0 + j < nc ? st[(bn * H + h) * per + e] : 0.f;
      d[j] = n0 + j < nc ? decay[bn * H + h] : 0.f;
    }
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      if (n0 + j < nc) {
        st[(((size_t)b * nc + n0 + j) * H + h) * per + e] = s;
        s = d[j] * s + v[j];
      }
    }
  }
  const int si = e / dh, p = e - si * dh;  // st is (N, dh)
  state[((size_t)bh * dh + p) * N + si] = s;
}

// 4. y of one (batch, chunk, 64-row strip, head): exp(cum_q) C_q S_prev^T
// plus sum_{t <= q} W[q][t] x_t, W = (C B^T)[q][t] exp(min(cum_q - cum_t,
// 0)) dt_t, from cb and the scanned st.
template <typename T>
__global__ void __launch_bounds__(kThreads, kMinBlocks<T>)
ssd_y(const T* __restrict__ x, const float* __restrict__ dt,
      const float* __restrict__ a, const T* __restrict__ cm,
      const float* __restrict__ cb, const float* __restrict__ st,
      T* __restrict__ y, int S, int H, int dh, int N, int Q, int nc) {
  extern __shared__ __align__(16) uint8_t smem[];
  T* sA = reinterpret_cast<T*>(smem);
  T* sB = sA + kTile<T>;
  float* sCum = reinterpret_cast<float*>(sA + kTiles<T> * kTile<T>);
  float* sDt = sCum + Q;
  float* sTmp = sDt + Q;
  const int nqs = (Q + kT - 1) / kT;
  const int h = blockIdx.x % H;  // heads fastest: they share C and cb
  const int q0 = ((blockIdx.x / H) % nqs) * kT;
  const int n = (blockIdx.x / (H * nqs)) % nc;
  const int b = blockIdx.x / (H * nqs * nc);
  const size_t row0 = (size_t)b * S + (size_t)n * Q;
  const int len = min(Q, q0 + kT);
  chunk_cumsum(dt + row0 * H + h, H, a[h], len, sCum, sDt, sTmp);
  float acc[2][4][4];
  zero(acc);
  // inter-chunk: C S_prev^T, then each row times exp(cum_q)
  const float* prev = st + (((size_t)b * nc + n) * H + h) * N * dh;
  for (int s0 = 0; s0 < N; s0 += kT) {
    __syncthreads();  // the previous tiles' readers are done
    stage(sA, [&](int r, int c8, float (&v)[8]) {
      load8(v, cm + (row0 + q0) * N + s0, N, r, c8, Q - q0, N - s0);
    });
    stage(sB, [&](int r, int c8, float (&v)[8]) {
      load8(v, prev + (size_t)s0 * dh, dh, r, c8, N - s0, dh);
    });
    __syncthreads();
    mma_tile<false>(acc, sA, sB);
  }
  {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int r0 = q0 + (warp >> 1) * 32 + (lane >> 2);
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int q = r0 + mt * 16 + 8 * i;
        const float ec = q < len ? expf(sCum[q]) : 0.f;
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          acc[mt][nt][2 * i] *= ec;
          acc[mt][nt][2 * i + 1] *= ec;
        }
      }
  }
  // intra-chunk: the t-tiles at or before this strip
  const float* cbc = cb + ((size_t)b * nc + n) * Q * Q;
  for (int t0 = 0; t0 <= q0; t0 += kT) {
    __syncthreads();
    // W: cb is written at t <= q only, so the rest is selected away
    stage(sA, [&](int r, int c8, float (&v)[8]) {
      load8(v, cbc + (size_t)q0 * Q + t0, Q, r, c8, Q - q0, Q - t0);
      const int q = q0 + r;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int t = t0 + c8 + j;
        v[j] = t <= q && q < Q
                   ? v[j] * expf(fminf(sCum[q] - sCum[t], 0.f)) * sDt[t]
                   : 0.f;
      }
    });
    stage(sB, [&](int r, int c8, float (&v)[8]) {
      load8(v, x + ((row0 + t0) * H + h) * dh, (size_t)H * dh, r, c8,
            Q - t0, dh);
    });
    __syncthreads();
    mma_tile<false>(acc, sA, sB);
  }
  each_entry(acc, [&](int r, int c, float v) {
    if (q0 + r < Q && c < dh)
      y[((row0 + q0 + r) * H + h) * dh + c] = from_f32<T>(v);
  });
}

template <typename T>
int launch(const void* x, const void* dt, const void* a, const void* b,
           const void* c, void* y, void* state, void* cb, void* st,
           void* decay, int B, int S, int H, int dh, int N, int Q,
           cudaStream_t stream) {
  const int nc = S / Q, nt = (Q + kT - 1) / kT, nst = (N + kT - 1) / kT;
  const size_t smem = smem_bytes(Q, sizeof(T) != sizeof(float));
  const void* fns[] = {(const void*)ssd_cb<T>, (const void*)ssd_states<T>,
                       (const void*)ssd_y<T>};
  for (const void* fn : fns) {
    const cudaError_t err = cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const T* xt = static_cast<const T*>(x);
  const float* dtf = static_cast<const float*>(dt);
  const float* af = static_cast<const float*>(a);
  const T* bt = static_cast<const T*>(b);
  const T* ct = static_cast<const T*>(c);
  float* cbf = static_cast<float*>(cb);
  float* stf = static_cast<float*>(st);
  float* df = static_cast<float*>(decay);
  ssd_cb<T><<<(unsigned)B * nc * (nt * (nt + 1) / 2), kThreads, smem,
              stream>>>(bt, ct, cbf, S, N, Q, nc);
  ssd_states<T><<<(unsigned)B * nc * H * nst, kThreads, smem, stream>>>(
      xt, dtf, af, bt, stf, df, S, H, dh, N, Q, nc);
  ssd_scan<<<(unsigned)B * H * ((N * dh + kThreads - 1) / kThreads),
             kThreads, 0, stream>>>(stf, df, static_cast<float*>(state), H,
                                    dh, N, nc);
  ssd_y<T><<<(unsigned)B * nc * nt * H, kThreads, smem, stream>>>(
      xt, dtf, af, ct, cbf, stf, static_cast<T*>(y), S, H, dh, N, Q, nc);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace ssd

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (x, b, c and y). x and y (B,S,H,dh);
// dt (B,S,H) and a (H,) fp32; b, c (B,S,N); state (B,H,dh,N) fp32; all
// contiguous. Scratch, fp32: cb (B,S/Q,Q,Q), st (B,S/Q,H,N,dh), decay
// (B,S/Q,H). Takes dh <= 64 and a chunk Q <= 1024 that tiles S. Returns
// the CUDA error code of the launches (0 = launched).
int ssd_fwd(const void* x, const void* dt, const void* a, const void* b,
            const void* c, void* y, void* state, void* cb, void* st,
            void* decay, int dtype, int B, int S, int H, int dh, int N,
            int Q, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dh <= 0 || dh > ssd::kMaxDh || N <= 0 || Q <= 0 ||
      Q > ssd::kMaxChunk || S % Q)
    return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return ssd::launch<float>(x, dt, a, b, c, y, state, cb, st, decay, B, S,
                              H, dh, N, Q, s);
  if (dtype == 1)
    return ssd::launch<__nv_bfloat16>(x, dt, a, b, c, y, state, cb, st,
                                      decay, B, S, H, dh, N, Q, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
