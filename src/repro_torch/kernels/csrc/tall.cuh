// Tall-skinny products shared by stiefel_project.cu and retract.cu.
//
// Operands are node-batched row-major (batch, d, r) fp32 tensors with d >> r
// (Stiefel leaves St(d, r)); the small (r, r) factors are row-major too.
//
//   gram_partial_kernel   P[b, c] = X[b, chunk c]^T G[b, chunk c]   (and, with
//                         TWO, Q[b, c] = G[b, chunk c]^T G[b, chunk c])
//   apply_kernel          out = G - X S              (kApplyProject)
//                         out = X M1 + G M2          (kApplyRetract)
//
// Blocks run in no order, so the reduction over d is split: each block sums
// one chunk of d rows into its own partial (r, r) tile, and a later kernel
// adds the partials in a fixed order (deterministic, no atomics).
//
// Both kernels use 256 threads on a 64 x 64 output tile, 4 x 4 outputs per
// thread, thread (tx, ty) owning rows ty + 16 p and columns tx + 16 q; the
// shared-memory reads are broadcasts or consecutive words (no bank conflicts).
#pragma once

#include "common.cuh"

namespace tall {

constexpr int kTile = 64;     // output tile edge
constexpr int kStep = 16;     // rows of the reduced dimension per stage
constexpr int kThreads = 256;

__host__ __device__ inline int ceil_div(int a, int b) { return (a + b - 1) / b; }

// grid: (tiles * tiles, n_chunks, batch); each block one (64 x 64) tile of
// one chunk's partial Gram.
template <bool TWO>
__global__ void __launch_bounds__(kThreads)
gram_partial_kernel(const float* __restrict__ x, const float* __restrict__ g,
                    float* __restrict__ p, float* __restrict__ q, int d,
                    int r, int chunk) {
  const int tiles = ceil_div(r, kTile);
  const int i0 = (blockIdx.x / tiles) * kTile;
  const int j0 = (blockIdx.x % tiles) * kTile;
  const int c = blockIdx.y, n_chunks = gridDim.y;
  const int b = blockIdx.z;
  const int d_lo = c * chunk, d_hi = min(d, d_lo + chunk);
  const float* xb = x + (size_t)b * d * r;
  const float* gb = g + (size_t)b * d * r;

  __shared__ float sx[kStep][kTile];
  __shared__ float sgi[TWO ? kStep : 1][kTile];
  __shared__ float sgj[kStep][kTile];

  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  float acc[4][4] = {}, acc2[4][4] = {};
  for (int d0 = d_lo; d0 < d_hi; d0 += kStep) {
    for (int e = threadIdx.x; e < kStep * kTile; e += kThreads) {
      const int kk = e / kTile, col = e % kTile, dd = d0 + kk;
      const bool okd = dd < d_hi;
      const int ci = i0 + col, cj = j0 + col;
      sx[kk][col] = (okd && ci < r) ? xb[(size_t)dd * r + ci] : 0.f;
      if constexpr (TWO)
        sgi[kk][col] = (okd && ci < r) ? gb[(size_t)dd * r + ci] : 0.f;
      sgj[kk][col] = (okd && cj < r) ? gb[(size_t)dd * r + cj] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kStep; ++kk) {
      float a[4], a2[4], v[4];
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        a[t] = sx[kk][ty + 16 * t];
        if constexpr (TWO) a2[t] = sgi[kk][ty + 16 * t];
        v[t] = sgj[kk][tx + 16 * t];
      }
#pragma unroll
      for (int s = 0; s < 4; ++s)
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          acc[s][t] = fmaf(a[s], v[t], acc[s][t]);
          if constexpr (TWO) acc2[s][t] = fmaf(a2[s], v[t], acc2[s][t]);
        }
    }
    __syncthreads();
  }
  const size_t off = ((size_t)b * n_chunks + c) * r * r;
#pragma unroll
  for (int s = 0; s < 4; ++s)
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const int i = i0 + ty + 16 * s, j = j0 + tx + 16 * t;
      if (i < r && j < r) {
        p[off + (size_t)i * r + j] = acc[s][t];
        if constexpr (TWO) q[off + (size_t)i * r + j] = acc2[s][t];
      }
    }
}

enum ApplyMode { kApplyProject = 0, kApplyRetract = 1 };

// grid: (ceil(d / 64) * tiles, 1, batch).  m1/m2 are (batch, r, r).
template <int MODE>
__global__ void __launch_bounds__(kThreads)
apply_kernel(const float* __restrict__ x, const float* __restrict__ g,
             const float* __restrict__ m1, const float* __restrict__ m2,
             float* __restrict__ out, int d, int r) {
  constexpr bool kTwo = MODE == kApplyRetract;
  const int tiles = ceil_div(r, kTile);
  const int d0 = (blockIdx.x / tiles) * kTile;
  const int j0 = (blockIdx.x % tiles) * kTile;
  const int b = blockIdx.z;
  const float* xb = x + (size_t)b * d * r;
  const float* gb = g + (size_t)b * d * r;
  const float* m1b = m1 + (size_t)b * r * r;
  const float* m2b = kTwo ? m2 + (size_t)b * r * r : nullptr;

  __shared__ float sa[kTile][kStep];          // x[d0 + row, k0 + kk]
  __shared__ float sa2[kTwo ? kTile : 1][kStep];
  __shared__ float sb[kStep][kTile];          // m1[k0 + kk, j0 + col]
  __shared__ float sb2[kTwo ? kStep : 1][kTile];

  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  float acc[4][4] = {}, acc2[4][4] = {};
  for (int k0 = 0; k0 < r; k0 += kStep) {
    for (int e = threadIdx.x; e < kTile * kStep; e += kThreads) {
      const int row = e / kStep, kk = e % kStep;
      const int dd = d0 + row, k = k0 + kk;
      const bool ok = dd < d && k < r;
      sa[row][kk] = ok ? xb[(size_t)dd * r + k] : 0.f;
      if constexpr (kTwo) sa2[row][kk] = ok ? gb[(size_t)dd * r + k] : 0.f;
      const int kb = k0 + e / kTile, col = j0 + e % kTile;
      const bool okb = kb < r && col < r;
      sb[e / kTile][e % kTile] = okb ? m1b[(size_t)kb * r + col] : 0.f;
      if constexpr (kTwo)
        sb2[e / kTile][e % kTile] = okb ? m2b[(size_t)kb * r + col] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kStep; ++kk) {
      float a[4], a2[4], v[4], v2[4];
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        a[t] = sa[ty + 16 * t][kk];
        v[t] = sb[kk][tx + 16 * t];
        if constexpr (kTwo) {
          a2[t] = sa2[ty + 16 * t][kk];
          v2[t] = sb2[kk][tx + 16 * t];
        }
      }
#pragma unroll
      for (int s = 0; s < 4; ++s)
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          acc[s][t] = fmaf(a[s], v[t], acc[s][t]);
          if constexpr (kTwo) acc2[s][t] = fmaf(a2[s], v2[t], acc2[s][t]);
        }
    }
    __syncthreads();
  }
  float* ob = out + (size_t)b * d * r;
#pragma unroll
  for (int s = 0; s < 4; ++s)
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const int i = d0 + ty + 16 * s, j = j0 + tx + 16 * t;
      if (i < d && j < r) {
        const size_t o = (size_t)i * r + j;
        if constexpr (kTwo)
          ob[o] = acc[s][t] + acc2[s][t];
        else
          ob[o] = gb[o] - acc[s][t];
      }
    }
}

}  // namespace tall
