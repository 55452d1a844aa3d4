// Mamba2 SSD (state-space duality) chunked scan, forward, for Hopper
// (sm_90a).
//
// Replaces the TPU kernel `_ssd_kernel` in src/repro/kernels/ssd.py
// (oracle: models/ssm.ssd_chunked). For one (batch, head) the sequence is
// cut into chunks of Q positions and the (dh, N) fp32 state S is carried
// from chunk to chunk. Inside a chunk, with da = dt * a and cum its
// inclusive prefix sum over the chunk (total = cum[Q-1]):
//   y[q]  = exp(cum_q) C_q S_prev^T                             (inter)
//         + sum_{t <= q} (C_q . B_t) exp(min(cum_q - cum_t, 0)) dt_t x_t
//   S_new = exp(total) S_prev + sum_t x_t^T (exp(total - cum_t) dt_t B_t)
// The clamp `min(., 0)` and the order of the terms are the reference's;
// every product is in fp32 from the inputs' values.
//
// What bounds it on the card. At Mamba2-2.7B's shape (S=16384, 80 heads
// of dh 64, N 128, chunk 256, B=1) the function needs ~65 GFLOP against
// ~352 MB in bf16 (x, y, dt, b, c, the final state): 0.105 ms at 3.35
// TB/s, bound by bytes (by operations in fp32).
//
// What this design does about it. One CTA of 256 threads per (batch,
// head) walks the chunks in order, the state in shared memory, as the
// reference's grid (B*H, nc) walks its sequential chunk axis. A chunk's
// 256 x 256 fp32 `(C B^T) * L` tile would need 256 KB, more than a CTA
// may have (227 KB), so the intra-chunk product is strip-mined: per
// 64-row q strip of C, the 64-row t strips of B and of dt * x at or
// before it, one 64 x 64 weight tile at a time. The cumulative sums are a
// block-wide prefix scan, not a triangular matrix product. Each thread
// keeps 4 x 4 blocks of its outputs in registers (rows tr + 16 i,
// columns tc + 16 j), and operand rows are padded to an odd length so the
// 16 threads of a half-warp read distinct banks. Takes dh <= 64 and any N
// whose tiles fit shared memory: (2 Q' + (dh + 128) (N + 1) + 2 * 64 * 65)
// floats with Q' the chunk rounded up to 64, 136,448 bytes at dh 64, N 128,
// Q 512. At 80 heads and B=1 the grid is 80 CTAs on 132 SMs; the C B^T
// product, shared by the heads, is recomputed by each (a later PR's
// work). All arithmetic is fp32 on CUDA cores.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace ssd {
namespace {

constexpr int kThreads = 256;
constexpr int kStrip = 64;            // rows of a strip
constexpr int kXP = kStrip + 1;       // padded row of an x / weight strip
constexpr int kMaxDh = 64;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16
from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as torch's cast
}

size_t smem_floats(int dh, int N, int Q) {
  const int qp = (Q + kStrip - 1) / kStrip * kStrip;
  return (size_t)2 * qp + (size_t)(dh + 2 * kStrip) * (N + 1) +
         2 * kStrip * kXP;
}

// The 64 rows of an (S, N) matrix that start at `src` into a (64, N + 1)
// strip, rows at and past `valid` zero.
template <typename T>
__device__ __forceinline__ void load_strip(float* dst, const T* src,
                                           int N, int valid) {
  for (int e = threadIdx.x; e < kStrip * N; e += kThreads) {
    const int r = e / N, n = e - r * N;
    dst[r * (N + 1) + n] = r < valid ? to_f32(src[(size_t)r * N + n]) : 0.f;
  }
}

// The (64, dh) strip of x whose row t starts at `x + t * xs`, row t
// multiplied by w[t], zero past `valid` rows and past dh columns (to 64).
template <typename T>
__device__ __forceinline__ void load_x(float* dst, const T* x, size_t xs,
                                       int dh, int valid, const float* w) {
  for (int e = threadIdx.x; e < kStrip * kMaxDh; e += kThreads) {
    const int t = e / kMaxDh, p = e - t * kMaxDh;
    dst[t * kXP + p] =
        t < valid && p < dh ? to_f32(x[(size_t)t * xs + p]) * w[t] : 0.f;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
ssd_fwd_kernel(const T* __restrict__ x, const float* __restrict__ dt,
               const float* __restrict__ a, const T* __restrict__ bm,
               const T* __restrict__ cm, T* __restrict__ y,
               float* __restrict__ state, int S, int H, int dh, int N,
               int Q) {
  extern __shared__ float4 smem4[];
  const int qp = (Q + kStrip - 1) / kStrip * kStrip, NP = N + 1;
  float* sCum = reinterpret_cast<float*>(smem4);  // qp: prefix sums
  float* sW8 = sCum + qp;                         // qp: dt, then weights
  float* sS = sW8 + qp;                           // (dh, N+1): the state
  float* sC = sS + dh * NP;                       // (64, N+1): a C strip
  float* sB = sC + kStrip * NP;                   // (64, N+1): a B strip
  float* sX = sB + kStrip * NP;                   // (64, 65): weighted x
  float* sW = sX + kStrip * kXP;                  // (64, 65): (C B^T) * L

  const int tid = threadIdx.x, tr = tid >> 4, tc = tid & 15;
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const float av = a[h];
  const size_t xs = (size_t)H * dh;  // x and y row stride
  for (int e = tid; e < dh * NP; e += kThreads) sS[e] = 0.f;

  for (int c0 = 0; c0 < S; c0 += Q) {
    // ---- dt of the chunk and the inclusive prefix sum of dt * a
    __syncthreads();  // the previous chunk's readers are done
    const int per = (qp + kThreads - 1) / kThreads;  // at most 4 (Q <= 1024)
    float loc[4];
    float run = 0.f;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int t = tid * per + e;
      if (e < per && t < qp) {
        const float d = t < Q ? dt[((size_t)b * S + c0 + t) * H + h] : 0.f;
        sW8[t] = d;
        run += d * av;
      }
      loc[e] = run;
    }
    // Hillis-Steele scan of the 256 thread totals, in sW (free here)
    sW[tid] = run;
    __syncthreads();
    for (int o = 1; o < kThreads; o <<= 1) {
      const float add = tid >= o ? sW[tid - o] : 0.f;
      __syncthreads();
      sW[tid] += add;
      __syncthreads();
    }
    const float before = sW[tid] - run;  // exclusive prefix
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int t = tid * per + e;
      if (e < per && t < qp) sCum[t] = before + loc[e];
    }
    __syncthreads();
    const float total = sCum[Q - 1];

    // ---- y, one 64-row q strip at a time
    for (int q0 = 0; q0 < Q; q0 += kStrip) {
      __syncthreads();  // the previous strip's readers of sC are done
      load_strip(sC, cm + ((size_t)b * S + c0 + q0) * N, N, Q - q0);
      __syncthreads();
      // inter-chunk: acc[i][j] = exp(cum_q) sum_n C[q][n] S[p][n]
      float acc[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
      for (int n = 0; n < N; ++n) {
        float cv[4], sv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) cv[i] = sC[(tr + 16 * i) * NP + n];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int p = tc + 16 * j;
          sv[j] = p < dh ? sS[p * NP + n] : 0.f;
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            acc[i][j] = fmaf(cv[i], sv[j], acc[i][j]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float ec = expf(sCum[q0 + tr + 16 * i]);
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] *= ec;
      }
      // intra-chunk: the t strips at or before this q strip
      for (int t0 = 0; t0 <= q0; t0 += kStrip) {
        __syncthreads();  // the previous t strip's readers are done
        load_strip(sB, bm + ((size_t)b * S + c0 + t0) * N, N, Q - t0);
        load_x(sX, x + ((size_t)b * S + c0 + t0) * xs + (size_t)h * dh, xs,
               dh, Q - t0, sW8 + t0);
        __syncthreads();
        float g[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) g[i][j] = 0.f;
        for (int n = 0; n < N; ++n) {
          float cv[4], bv[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) cv[i] = sC[(tr + 16 * i) * NP + n];
#pragma unroll
          for (int j = 0; j < 4; ++j) bv[j] = sB[(tc + 16 * j) * NP + n];
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) g[i][j] = fmaf(cv[i], bv[j], g[i][j]);
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int qa = q0 + tr + 16 * i;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int ta = t0 + tc + 16 * j;
            sW[(tr + 16 * i) * kXP + tc + 16 * j] =
                ta <= qa && qa < Q
                    ? g[i][j] * expf(fminf(sCum[qa] - sCum[ta], 0.f))
                    : 0.f;
          }
        }
        __syncthreads();
        for (int t = 0; t < kStrip; ++t) {
          float wv[4], xv[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) wv[i] = sW[(tr + 16 * i) * kXP + t];
#pragma unroll
          for (int j = 0; j < 4; ++j) xv[j] = sX[t * kXP + tc + 16 * j];
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j)
              acc[i][j] = fmaf(wv[i], xv[j], acc[i][j]);
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = q0 + tr + 16 * i;
        if (row >= Q) continue;
        T* yrow = y + ((size_t)b * S + c0 + row) * xs + (size_t)h * dh;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int p = tc + 16 * j;
          if (p < dh) yrow[p] = from_f32<T>(acc[i][j]);
        }
      }
    }

    // ---- the state: S = exp(total) S + sum_t x_t^T (w_t B_t), with
    // w_t = exp(total - cum_t) dt_t; 128 state columns a pass
    __syncthreads();  // every strip's readers of sW8 and sS are done
    for (int t = tid; t < Q; t += kThreads)
      sW8[t] *= expf(total - sCum[t]);
    const float et = expf(total);
    for (int n0 = 0; n0 < N; n0 += 128) {
      float u[4][8];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) u[i][j] = 0.f;
      for (int t0 = 0; t0 < Q; t0 += kStrip) {
        __syncthreads();  // sW8 is written; the previous strip is read
        load_strip(sB, bm + ((size_t)b * S + c0 + t0) * N, N, Q - t0);
        load_x(sX, x + ((size_t)b * S + c0 + t0) * xs + (size_t)h * dh, xs,
               dh, Q - t0, sW8 + t0);
        __syncthreads();
        for (int t = 0; t < kStrip; ++t) {
          float xv[4], bv[8];
#pragma unroll
          for (int i = 0; i < 4; ++i) xv[i] = sX[t * kXP + tr + 16 * i];
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const int n = n0 + tc + 16 * j;
            bv[j] = n < N ? sB[t * NP + n] : 0.f;
          }
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 8; ++j) u[i][j] = fmaf(xv[i], bv[j], u[i][j]);
        }
      }
      // each (p, n) belongs to one thread: no barrier before the write
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int p = tr + 16 * i;
        if (p >= dh) continue;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int n = n0 + tc + 16 * j;
          if (n < N) sS[p * NP + n] = et * sS[p * NP + n] + u[i][j];
        }
      }
    }
  }
  __syncthreads();
  float* out = state + (size_t)bh * dh * N;
  for (int e = tid; e < dh * N; e += kThreads) {
    const int p = e / N, n = e - p * N;
    out[e] = sS[p * NP + n];
  }
}

template <typename T>
int launch(const void* x, const void* dt, const void* a, const void* b,
           const void* c, void* y, void* state, int B, int S, int H, int dh,
           int N, int Q, cudaStream_t stream) {
  const size_t smem = smem_floats(dh, N, Q) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_fwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  ssd_fwd_kernel<T><<<(unsigned)B * H, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(a), static_cast<const T*>(b),
      static_cast<const T*>(c), static_cast<T*>(y),
      static_cast<float*>(state), S, H, dh, N, Q);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace ssd

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (x, b, c and y). x and y (B,S,H,dh);
// dt (B,S,H) and a (H,) fp32; b, c (B,S,N); state (B,H,dh,N) fp32; all
// contiguous. Takes dh <= 64, a chunk Q <= 1024 that tiles S, and N whose
// tiles fit shared memory. Returns the CUDA error code of the launch
// (0 = launched).
int ssd_fwd(const void* x, const void* dt, const void* a, const void* b,
            const void* c, void* y, void* state, int dtype, int B, int S,
            int H, int dh, int N, int Q, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dh <= 0 || dh > ssd::kMaxDh || N <= 0 || Q <= 0 || Q > 1024 ||
      S % Q)
    return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return ssd::launch<float>(x, dt, a, b, c, y, state, B, S, H, dh, N, Q,
                              st);
  if (dtype == 1)
    return ssd::launch<__nv_bfloat16>(x, dt, a, b, c, y, state, B, S, H, dh,
                                      N, Q, st);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
