// Tall-skinny products on the tensor cores, shared by stiefel_project.cu
// (its streaming route) and retract.cu (its stages 1 and 3).
//
// Operands are node-batched row-major (batch, d, r) fp32 tensors with d >> r
// (Stiefel leaves St(d, r)); the (r, r) factors are row-major too.
//
//   gram_kernel<kGramSym>        S = sym(X^T G)               (batch, r, r)
//   gram_kernel<kGramTwo>        B = X^T G,  C = G^T G        (batch, r, r)
//   apply_kernel<kApplyProject>  out = G - X S
//   apply_kernel<kApplyRetract>  out = X M1 + G M2
//
// Every product is 3xTF32 mma.sync.m16n8k8 (tensorcore.cuh): fp32 accuracy
// at 165 TFLOP/s, where the first version's fp32 FMA on CUDA cores ran at
// 31% of 67.  A block is 4 warps on a 64 x 64 output tile, each warp 32 x 32
// (2 x 4 m16n8 fragments, 32 fp32 accumulators a product).  Operands move
// with cp.async (16 bytes where r % 4 == 0 and the base is aligned, 4
// otherwise; the ragged edges zero-filled) into a two-stage ring of 32-row
// stages, the next stage loading while one computes.  Row strides are
// padded so that the fragment loads hit 32 distinct banks.
//
// The Gram sums over d.  Its blocks are grouped into a thread block cluster
// per output tile: CTA `rank` of the cluster sums rows [rank chunk,
// (rank + 1) chunk) of d, writes its partial tile to its own shared memory,
// and after one cluster barrier each CTA adds a band of the tile's rows
// over the cluster's partials (distributed shared memory) in rank order,
// and stores it.  So the reduction is deterministic, needs no atomics, no
// global partials and no second launch.  The cluster size grows (1, 2, 4,
// 8) while the grid is small (kGramBlocks) and the rows last (kGramMinRows).
//
// sym(X^T G) needs the mirrored tile too: S(i, j) = (X_i^T G_j + G_i^T X_j)
// / 2 for column tiles i <= j.  A Sym cluster computes both products of its
// pair (i, j), one on the diagonal, and stores S(i, j) and its mirror
// S(j, i): T (T + 1) / 2 clusters for T column tiles, the flops of the
// whole X^T G and no sym pass.  Two computes every tile (i, j) of B and C.
#pragma once

#include <cooperative_groups.h>

#include "tensorcore.cuh"

namespace tall {

// Internal linkage: every library that includes this header keeps its own
// kernels and its own once-only attribute flags (a static local of an
// inline function with external linkage is one object for the whole
// process, shared by every library loaded into it).
namespace {

namespace cg = cooperative_groups;

constexpr int kTile = 64;       // output tile edge
constexpr int kBK = 32;         // rows of the reduced dimension per stage
constexpr int kThreads = 128;   // 4 warps, 32 x 32 outputs each
constexpr int kLd = kTile + 8;  // (kBK, 64) tiles: lane (g, t) reads (t, g)
constexpr int kLdA = kBK + 4;   // (64, kBK) tiles: lane (g, t) reads (g, t)
constexpr int kMaxCluster = 8;
// Gram clusters grow while the grid has fewer than kGramBlocks blocks (8 for
// each of the 132 SMs) and each CTA keeps kGramMinRows rows of d or more
// (kernel_variants.py: 264 blocks, or 128 rows, were slower)
constexpr int kGramBlocks = 1056;
constexpr int kGramMinRows = 64;

__host__ __device__ inline int ceil_div(int a, int b) { return (a + b - 1) / b; }

inline bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

enum GramMode { kGramSym = 0, kGramTwo = 1 };
enum ApplyMode { kApplyProject = 0, kApplyRetract = 1 };

// Copies a (ROWS x COLS) block of the row-major matrix m (row stride r)
// from rows [r0, r0 + ROWS) and columns [c0, c0 + COLS) into dst (row
// stride LD), zeros outside [0, hi) x [0, r), W floats a copy (4: 16-byte
// copies, 1: 4-byte).  Each thread keeps one column and steps down the
// rows, so the index work is one pointer add a copy.
template <int ROWS, int COLS, int LD, int W>
__device__ __forceinline__ void copy_block(float* dst, const float* m, int r0,
                                           int hi, int c0, int r) {
  constexpr int kCols = COLS / W, kStride = kThreads / kCols;
  static_assert(kThreads % kCols == 0 && ROWS % kStride == 0, "tiling");
  const int c = W * (threadIdx.x % kCols);
  const bool col = c0 + c < r;
  int row = threadIdx.x / kCols;
  const float* src = m + (size_t)(r0 + row) * r + c0 + c;
#pragma unroll
  for (int k = 0; k < ROWS / kStride; ++k) {
    const bool fill = col && r0 + row < hi;
    if (W == 4)
      tcore::cp_async16(dst + row * LD + c, fill ? src : m, fill);
    else
      tcore::cp_async4(dst + row * LD + c, fill ? src : m, fill);
    row += kStride;
    src += (size_t)kStride * r;
  }
}

// copy_block with 16-byte copies where vec (r % 4 == 0, aligned bases).
template <int ROWS, int COLS, int LD>
__device__ __forceinline__ void stage_block(float* dst, const float* m,
                                            int r0, int hi, int c0, int r,
                                            bool vec) {
  if (vec)
    copy_block<ROWS, COLS, LD, 4>(dst, m, r0, hi, c0, r);
  else
    copy_block<ROWS, COLS, LD, 1>(dst, m, r0, hi, c0, r);
}

// Stages rows [r0, r0 + kBK) of columns [c0, c0 + 64) of the row-major
// (rows, r) matrix m into dst (kBK x kLd), zeros outside [0, hi) x [0, r).
__device__ __forceinline__ void stage_rows(float* dst, const float* m, int r0,
                                           int hi, int c0, int r, bool vec) {
  stage_block<kBK, kTile, kLd>(dst, m, r0, hi, c0, r, vec);
}

// The A fragments (split) of the two m16 tiles at rows wm of a product
// whose A is the transpose of a staged (kBK x kLd) tile: A[i][k] = s[k][i].
__device__ __forceinline__ void frag_at(const float* s, int kk, int wm,
                                        uint32_t (*ah)[4], uint32_t (*al)[4]) {
  const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
    const int i = wm + 16 * mt + g;
    tcore::split(s[(kk + t) * kLd + i], ah[mt][0], al[mt][0]);
    tcore::split(s[(kk + t) * kLd + i + 8], ah[mt][1], al[mt][1]);
    tcore::split(s[(kk + t + 4) * kLd + i], ah[mt][2], al[mt][2]);
    tcore::split(s[(kk + t + 4) * kLd + i + 8], ah[mt][3], al[mt][3]);
  }
}

// The B fragments (split) of the four n8 tiles at columns wn of a staged
// (k rows x kLd) tile: B[k][j] = s[k][j].
__device__ __forceinline__ void frag_b(const float* s, int kk, int wn,
                                       uint32_t (*bh)[2], uint32_t (*bl)[2]) {
  const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) {
    const int j = wn + 8 * nt + g;
    tcore::split(s[(kk + t) * kLd + j], bh[nt][0], bl[nt][0]);
    tcore::split(s[(kk + t + 4) * kLd + j], bh[nt][1], bl[nt][1]);
  }
}

// acc += A B as 3xTF32 for the warp's 2 x 4 fragments: each of the three
// passes (lo hi, hi lo, hi hi: small terms first, as mma_3xtf32) runs over
// all eight accumulators before the next, so eight independent products
// are in flight instead of one chain of three.
__device__ __forceinline__ void mma_tile(float (*acc)[4][4], uint32_t (*ah)[4],
                                         uint32_t (*al)[4], uint32_t (*bh)[2],
                                         uint32_t (*bl)[2]) {
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
      tcore::mma_tf32(acc[mt][nt], al[mt], bh[nt][0], bh[nt][1]);
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
      tcore::mma_tf32(acc[mt][nt], ah[mt], bl[nt][0], bl[nt][1]);
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
      tcore::mma_tf32(acc[mt][nt], ah[mt], bh[nt][0], bh[nt][1]);
}

// The warp's accumulators into a (64 x kLd) shared tile.
__device__ __forceinline__ void store_frags(float* red, float (*acc)[4][4],
                                            int wm, int wn) {
  const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      float* p = red + (wm + 16 * mt + g) * kLd + wn + 8 * nt + 2 * t;
      p[0] = acc[mt][nt][0];
      p[1] = acc[mt][nt][1];
      p[8 * kLd] = acc[mt][nt][2];
      p[8 * kLd + 1] = acc[mt][nt][3];
    }
}

// Shared floats of a Gram block: two stages of four (kBK x kLd) tiles (x_i,
// g_j, g_i, x_j), reused for the two (64 x kLd) partial tiles.
constexpr int kGramStage = 4 * kBK * kLd;
constexpr int kGramSmem = 2 * kGramStage * (int)sizeof(float);

// grid: (jobs * cluster, batch), cluster (CS, 1, 1); out1 (and out2 for
// Two) (batch, r, r).  vec: 16-byte copies allowed.
template <int MODE>
__global__ void __launch_bounds__(kThreads)
gram_kernel(const float* __restrict__ x, const float* __restrict__ g,
            float* __restrict__ out1, float* __restrict__ out2, int d, int r,
            int chunk, int vec) {
  extern __shared__ __align__(16) float sm[];
  cg::cluster_group cluster = cg::this_cluster();
  const int cs = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int T = ceil_div(r, kTile);
  int job = blockIdx.x / cs, ti = 0, tj;
  if (MODE == kGramSym) {  // the pairs ti <= tj, row by row
    while (job >= T - ti) job -= T - ti++;
    tj = ti + job;
  } else {
    ti = job / T;
    tj = job % T;
  }
  const bool diag = MODE == kGramSym && ti == tj;
  const bool two = MODE == kGramTwo || !diag;  // a second product
  const int i0 = ti * kTile, j0 = tj * kTile;
  const int b = blockIdx.y;
  const float* xb = x + (size_t)b * d * r;
  const float* gb = g + (size_t)b * d * r;
  const int lo = rank * chunk, hi = min(d, lo + chunk);
  const int steps = hi > lo ? ceil_div(hi - lo, kBK) : 0;

  const int warp = threadIdx.x >> 5;
  const int wm = (warp >> 1) * 32, wn = (warp & 1) * 32;
  float acc1[2][4][4] = {}, acc2[2][4][4] = {};

  auto stage = [&](int s) {
    float* dst = sm + (s & 1) * kGramStage;
    const int r0 = lo + s * kBK;
    stage_rows(dst, xb, r0, hi, i0, r, vec);
    stage_rows(dst + kBK * kLd, gb, r0, hi, j0, r, vec);
    if (two) stage_rows(dst + 2 * kBK * kLd, gb, r0, hi, i0, r, vec);
    if (MODE == kGramSym && two)
      stage_rows(dst + 3 * kBK * kLd, xb, r0, hi, j0, r, vec);
  };
  if (steps > 0) stage(0);
  tcore::cp_async_commit();
  for (int s = 0; s < steps; ++s) {
    if (s + 1 < steps) stage(s + 1);
    tcore::cp_async_commit();
    tcore::cp_async_wait<1>();
    __syncthreads();
    const float* cur = sm + (s & 1) * kGramStage;
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 8) {
      uint32_t ah[2][4], al[2][4], bh[4][2], bl[4][2];
      frag_at(cur, kk, wm, ah, al);                 // x_i^T
      frag_b(cur + kBK * kLd, kk, wn, bh, bl);      // g_j
      mma_tile(acc1, ah, al, bh, bl);
      if (two) {
        frag_at(cur + 2 * kBK * kLd, kk, wm, ah, al);  // g_i^T
        if (MODE == kGramSym)
          frag_b(cur + 3 * kBK * kLd, kk, wn, bh, bl);  // x_j
        mma_tile(acc2, ah, al, bh, bl);
      }
    }
    __syncthreads();
  }
  tcore::cp_async_wait<0>();
  __syncthreads();

  // partial tiles -> shared memory; then each CTA adds a band of rows over
  // the cluster, in rank order
  float* red1 = sm;
  float* red2 = sm + kTile * kLd;
  store_frags(red1, acc1, wm, wn);
  if (two) store_frags(red2, acc2, wm, wn);
  cluster.sync();
  const int band = kTile / cs;
  const size_t off = (size_t)b * r * r;
  for (int e = threadIdx.x; e < band * kTile; e += kThreads) {
    const int il = rank * band + e / kTile, jl = e % kTile;
    const int i = i0 + il, j = j0 + jl;
    if (i >= r || j >= r) continue;
    float v1 = 0.f, v2 = 0.f;
#pragma unroll
    for (int c = 0; c < kMaxCluster; ++c) {
      if (c >= cs) break;
      const float* p = cluster.map_shared_rank(sm, c);
      v1 += p[il * kLd + jl];
      if (diag)
        v2 += p[jl * kLd + il];
      else if (two)
        v2 += p[kTile * kLd + il * kLd + jl];
    }
    if (MODE == kGramSym) {
      const float s = 0.5f * (v1 + v2);
      out1[off + (size_t)i * r + j] = s;
      if (!diag) out1[off + (size_t)j * r + i] = s;
    } else {
      out1[off + (size_t)i * r + j] = v1;
      out2[off + (size_t)i * r + j] = v2;
    }
  }
  cluster.sync();  // no CTA leaves while a peer may still read its tiles
}

// Shared floats of an apply block: two stages of (64 x kLdA) A tiles and
// (kBK x kLd) B tiles, one pair a product.
template <int MODE>
__host__ __device__ constexpr int apply_stage() {
  return (MODE == kApplyRetract ? 2 : 1) * (kTile * kLdA + kBK * kLd);
}

// grid: (ceil(d / 64) * T, batch).  m1, m2: (batch, r, r).
template <int MODE>
__global__ void __launch_bounds__(kThreads)
apply_kernel(const float* __restrict__ x, const float* __restrict__ g,
             const float* __restrict__ m1, const float* __restrict__ m2,
             float* __restrict__ out, int d, int r, int vec) {
  extern __shared__ __align__(16) float sm[];
  constexpr bool kTwo = MODE == kApplyRetract;
  constexpr int kStage = apply_stage<MODE>();
  constexpr int kA = kTile * kLdA;  // floats of an A tile
  const int T = ceil_div(r, kTile);
  const int m0 = (blockIdx.x / T) * kTile, j0 = (blockIdx.x % T) * kTile;
  const int b = blockIdx.y;
  const float* xb = x + (size_t)b * d * r;
  const float* gb = g + (size_t)b * d * r;
  const float* m1b = m1 + (size_t)b * r * r;
  const float* m2b = kTwo ? m2 + (size_t)b * r * r : nullptr;
  const int steps = ceil_div(r, kBK);

  // A tile: rows [m0, m0 + 64) of a, columns [k0, k0 + kBK)
  auto stage_a = [&](float* dst, const float* a, int k0) {
    stage_block<kTile, kBK, kLdA>(dst, a, m0, d, k0, r, vec);
  };
  auto stage = [&](int s) {
    float* dst = sm + (s & 1) * kStage;
    const int k0 = s * kBK;
    stage_a(dst, xb, k0);
    stage_rows(dst + kA, m1b, k0, r, j0, r, vec);
    if (kTwo) {
      stage_a(dst + kA + kBK * kLd, gb, k0);
      stage_rows(dst + 2 * kA + kBK * kLd, m2b, k0, r, j0, r, vec);
    }
  };

  const int warp = threadIdx.x >> 5;
  const int wm = (warp >> 1) * 32, wn = (warp & 1) * 32;
  const int gq = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
  float acc[2][4][4] = {};
  stage(0);
  tcore::cp_async_commit();
  for (int s = 0; s < steps; ++s) {
    if (s + 1 < steps) stage(s + 1);
    tcore::cp_async_commit();
    tcore::cp_async_wait<1>();
    __syncthreads();
    const float* cur = sm + (s & 1) * kStage;
#pragma unroll
    for (int p = 0; p < (kTwo ? 2 : 1); ++p) {
      const float* sa = cur + p * (kA + kBK * kLd);
      const float* sb = sa + kA;
#pragma unroll
      for (int kk = 0; kk < kBK; kk += 8) {
        uint32_t ah[2][4], al[2][4], bh[4][2], bl[4][2];
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          const float* row = sa + (wm + 16 * mt + gq) * kLdA + kk + t;
          tcore::split(row[0], ah[mt][0], al[mt][0]);
          tcore::split(row[8 * kLdA], ah[mt][1], al[mt][1]);
          tcore::split(row[4], ah[mt][2], al[mt][2]);
          tcore::split(row[8 * kLdA + 4], ah[mt][3], al[mt][3]);
        }
        frag_b(sb, kk, wn, bh, bl);
        mma_tile(acc, ah, al, bh, bl);
      }
    }
    __syncthreads();
  }
  tcore::cp_async_wait<0>();

  float* ob = out + (size_t)b * d * r;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int i = m0 + wm + 16 * mt + gq + (q >> 1) * 8;
        const int j = j0 + wn + 8 * nt + 2 * t + (q & 1);
        if (i < d && j < r) {
          const size_t o = (size_t)i * r + j;
          ob[o] = kTwo ? acc[mt][nt][q] : gb[o] - acc[mt][nt][q];
        }
      }
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

// CTAs per Gram cluster: doubled from 1 up to kMaxCluster while the grid
// has fewer than kGramBlocks blocks and each CTA keeps >= kGramMinRows rows.
inline int gram_cluster(int jobs, int batch, int d) {
  int cs = 1;
  while (cs < kMaxCluster && (long long)jobs * batch * cs < kGramBlocks &&
         d >= 2 * cs * kGramMinRows)
    cs *= 2;
  return cs;
}

template <typename Kernel>
inline cudaError_t set_smem(Kernel kernel, int bytes, bool* done) {
  if (*done) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess) *done = true;
  return err;
}

// One Gram launch: S = sym(x^T g) into out1 (Sym), or x^T g into out1 and
// g^T g into out2 (Two); x, g (batch, d, r), outputs (batch, r, r).
template <int MODE>
inline int launch_gram(const float* x, const float* g, float* out1,
                       float* out2, int batch, int d, int r,
                       cudaStream_t st) {
  static bool smem_set = false;
  cudaError_t err = set_smem(gram_kernel<MODE>, kGramSmem, &smem_set);
  if (err != cudaSuccess) return (int)err;
  const int T = ceil_div(r, kTile);
  const int jobs = MODE == kGramSym ? T * (T + 1) / 2 : T * T;
  const int cs = gram_cluster(jobs, batch, d);
  const int chunk = ceil_div(ceil_div(d, cs), kBK) * kBK;
  const int vec = r % 4 == 0 && aligned16(x) && aligned16(g);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(jobs * cs), (unsigned)batch);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = kGramSmem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return (int)cudaLaunchKernelEx(&cfg, gram_kernel<MODE>, x, g, out1, out2, d,
                                 r, chunk, vec);
}

// One apply launch: out = g - x m1 (Project) or x m1 + g m2 (Retract).
template <int MODE>
inline int launch_apply(const float* x, const float* g, const float* m1,
                        const float* m2, float* out, int batch, int d, int r,
                        cudaStream_t st) {
  static bool smem_set = false;
  constexpr int kBytes = 2 * apply_stage<MODE>() * (int)sizeof(float);
  cudaError_t err = set_smem(apply_kernel<MODE>, kBytes, &smem_set);
  if (err != cudaSuccess) return (int)err;
  const int vec = r % 4 == 0 && aligned16(x) && aligned16(g) &&
                  aligned16(m1) && (m2 == nullptr || aligned16(m2));
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(ceil_div(d, kTile) * ceil_div(r, kTile)),
                     (unsigned)batch);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = kBytes;
  cfg.stream = st;
  return (int)cudaLaunchKernelEx(&cfg, apply_kernel<MODE>, x, g, m1, m2, out,
                                 d, r, vec);
}

}  // namespace
}  // namespace tall
